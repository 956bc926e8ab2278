"""Legacy alignment API — thin wrappers over ``core.engine``.

.. deprecated::
    ``WFAligner`` predates :class:`~repro_torch.core.engine.AlignmentEngine`
    and is kept as a compatibility shim, as in the JAX package.  New code
    constructs an ``AlignmentEngine`` directly: it adds the backend
    registry, length-bucketed batching, the specialisation cache and the
    adaptive two-pass overflow recovery that this wrapper only proxies.

``WFAligner.align`` delegates to an engine; ``align_arrays`` stays the raw
array-level dispatch through the backend registry for code that manages
its own bounds.  Like the engine, the shim runs on the card unless it is
given ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import cigar as cigar_mod
from repro_torch.core import wavefront as wf
from repro_torch.core.backends import get_backend
from repro_torch.core.engine import (AlignmentEngine, Seq, encode,
                                     pack_batch, problem_bounds)
from repro_torch.core.penalties import DEFAULT, Penalties

__all__ = ["AlignResult", "WFAligner", "Seq", "encode", "pack_batch",
           "problem_bounds"]


# The char map this deprecated API always emitted ('M' = match only, 'X' =
# mismatch), frozen so legacy callers' output never shifts under them; new
# code uses EngineResult.cigar_strings(mode="extended"|"classic").
_LEGACY_CHARS = {cigar_mod.OP_M: "M", cigar_mod.OP_X: "X",
                 cigar_mod.OP_I: "I", cigar_mod.OP_D: "D"}


@dataclasses.dataclass
class AlignResult:
    scores: np.ndarray                      # [B] int32; -1 = exceeded s_max
    cigars: Optional[List[np.ndarray]]      # per-pair op arrays, or None
    n_steps: int                            # score-loop trips (telemetry)
    s_max: int
    k_max: int

    def cigar_strings(self) -> List[str]:
        if self.cigars is None:
            raise ValueError("align with with_cigar=True")
        return [cigar_mod.run_length_string(c, _LEGACY_CHARS)
                for c in self.cigars]


class WFAligner:
    """Compatibility façade over :class:`AlignmentEngine` (see module doc)."""

    def __init__(self, pen: Penalties = DEFAULT, *, backend: str = "ring",
                 edit_frac: Optional[float] = None,
                 s_max: Optional[int] = None, k_max: Optional[int] = None,
                 with_cigar: bool = False, penalties=None, device=None):
        warnings.warn(
            "WFAligner is deprecated; use repro_torch.core.engine."
            "AlignmentEngine (blocking align()) or AlignmentEngine.stream() "
            "for pipelined submission via repro_torch.core.session."
            "AlignmentSession", DeprecationWarning, stacklevel=2)
        if penalties is not None:
            # the engine-era spelling: accepted with a warning, not refused
            warnings.warn(
                "WFAligner(penalties=...) is the AlignmentEngine spelling; "
                "forwarding it as this aligner's penalty model "
                "(gap-affine triples map to scoring.GapAffine)",
                DeprecationWarning, stacklevel=2)
            pen = penalties
        self._engine = AlignmentEngine(
            pen, backend=backend, edit_frac=edit_frac, s_max=s_max,
            k_max=k_max, output="cigar" if with_cigar else "score",
            device=device)

    @property
    def engine(self) -> AlignmentEngine:
        return self._engine

    # Config lives on the engine (one source of truth): align() and
    # align_arrays() always see the same settings.
    @property
    def pen(self):
        return self._engine.pen

    @property
    def backend(self):
        return self._engine.backend

    @property
    def edit_frac(self):
        return self._engine.edit_frac

    @property
    def with_cigar(self) -> bool:
        return self._engine.default_output == "cigar"

    @property
    def _s_max(self):
        return self._engine._s_max

    @property
    def _k_max(self):
        return self._engine._k_max

    # -- array-level entry point ---------------------------------------------
    def align_arrays(self, pattern, text, plen, tlen, *, s_max: int,
                     k_max: int) -> wf.WFAResult:
        """One backend call on ``[B, L]`` codes and ``[B]`` lengths (numpy
        or tensors), on the engine's device."""
        spec = get_backend(self.backend)
        dev = self._engine.device
        arrays = [torch.as_tensor(a, device=dev).to(torch.int32)
                  for a in (pattern, text, plen, tlen)]
        return spec.fn(*arrays, pen=self.pen, s_max=s_max, k_max=k_max)

    # -- sequence-level entry point ------------------------------------------
    def align(self, patterns: Sequence[Seq],
              texts: Sequence[Seq]) -> AlignResult:
        if len(patterns) != len(texts):
            raise ValueError(f"{len(patterns)} patterns for {len(texts)} "
                             f"texts")
        res = self._engine.align(patterns, texts)
        return AlignResult(res.scores, res.cigars, res.n_steps,
                           res.s_max, res.k_max)

    def align_pair(self, pattern: Seq, text: Seq) -> AlignResult:
        return self.align([pattern], [text])
