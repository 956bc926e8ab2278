"""`AlignmentEngine` — the unified alignment façade, on PyTorch.

The counterpart of ``repro.core.engine``; every policy on the path from a
batch of read pairs to scores lives here:

* **backend registry** (``core.backends``) — ``ring`` / ``kernel`` (and
  plug-ins via ``register_backend``) are looked up by name;
* **length-bucketed batching** — pairs are grouped by the power of two of
  ``max(plen, tlen)``, each bucket with its own static ``(L, s_max,
  k_max)`` problem shape;
* **specialisation cache** — one entry per ``(backend, model, heuristic,
  output, shape, bounds, opts)``; quantized shapes (power-of-two lengths,
  rounded pair counts and ``s_max``) keep repeated traffic on the same few
  keys, and ``n_traces`` counts the first use of a key;
* **adaptive two-pass bounds** — pass 1 runs with the optimistic
  ``edit_frac``-derived ``s_max``; pairs that come back unresolved are
  re-run with the exact worst-case bound;
* **phase accounting** — scatter / kernel / gather bytes and seconds (the
  paper's Fig. 1 *Total vs Kernel* split).  In the blocking ``align()``
  path on a card the three phases are timed by CUDA events.

Execution lives in ``core.session``: ``align()`` is one blocking pass
through an :class:`~repro_torch.core.session.AlignmentSession`, and
``engine.stream()`` opens the same session in pipelined mode.

The engine runs on the card: ``device=None`` means ``"cuda"`` and raises
when no card is present.  ``device="cpu"`` runs the same path on the CPU
(the kernel backend then runs its kernel's plain version).

Quickstart::

    from repro_torch.core.engine import AlignmentEngine

    eng = AlignmentEngine(backend="kernel", edit_frac=0.02)
    res = eng.align(["ACGT...", ...], ["ACGA...", ...])
    res.scores        # [B] exact gap-affine costs (Gotoh-identical)
    eng.align(patterns, texts, output="cigar").cigar_strings()
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import cigar as cigar_mod
from repro_torch.core import scoring
from repro_torch.core.backends import BackendSpec, _accepts_kw, get_backend
from repro_torch.core.penalties import DEFAULT
from repro_torch.core.wavefront import resolve_device
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

Seq = Union[str, bytes, np.ndarray]


# ---------------------------------------------------------------------------
# Encoding / packing.


def encode(seq: Seq) -> np.ndarray:
    if isinstance(seq, str):
        return np.frombuffer(seq.encode("ascii"), dtype=np.uint8).astype(np.int32)
    if isinstance(seq, bytes):
        return np.frombuffer(seq, dtype=np.uint8).astype(np.int32)
    return np.asarray(seq, dtype=np.int32)


def pack_batch(seqs: Sequence[Seq], pad_to: Optional[int] = None,
               multiple: int = 1):
    """-> (codes [B, L] int32, lens [B] int32). Padding value 0 (never read)."""
    enc = [encode(s) for s in seqs]
    lens = np.asarray([len(e) for e in enc], np.int32)
    L = max(1, pad_to if pad_to is not None else int(lens.max(initial=1)))
    L = ((L + multiple - 1) // multiple) * multiple
    out = np.zeros((len(enc), L), np.int32)
    for i, e in enumerate(enc):
        out[i, : len(e)] = e
    return out, lens


def problem_bounds(pen, plens: np.ndarray, tlens: np.ndarray,
                   edit_frac: Optional[float], s_max: Optional[int] = None,
                   k_max: Optional[int] = None) -> Tuple[int, int]:
    """Static (s_max, k_max) for a batch (``pen``: model or legacy triple).

    With ``edit_frac`` (the paper's E): the model's score bound over the
    batch max length.  Without it: the exact worst case, under which every
    pair terminates with a real score.
    """
    pen = scoring.as_model(pen)
    max_len = int(max(plens.max(initial=1), tlens.max(initial=1)))
    max_diff = int(np.abs(tlens - plens).max(initial=0))
    if s_max is None:
        if edit_frac is not None:
            s_max = pen.score_bound(max_len, edit_frac, len_diff=max_diff)
        else:
            s_max = _exact_worst_score(pen, plens, tlens)
    if k_max is None:
        k_max = min(pen.band_bound(s_max), max_len)
    k_max = max(k_max, max_diff, 1)
    return int(s_max), int(k_max)


def _exact_worst_score(pen, plens, tlens) -> int:
    """Batch-vectorized :meth:`scoring.PenaltyModel.worst_score`, maxed
    over the batch — the bound under which every pair terminates."""
    worst = (pen.x * np.minimum(plens, tlens)
             + np.where(plens != tlens,
                        pen.o + pen.e * np.abs(tlens - plens), 0))
    return int(worst.max(initial=0)) + 1


def _next_pow2(n: int) -> int:
    n = max(1, int(n))
    return 1 << (n - 1).bit_length()


def _round_up(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


def _quantize_rows(n: int, multiple: int) -> int:
    """Smallest 'round' pair count >= n — a power of two or 1.5x one —
    then rounded up to ``multiple``."""
    p = _next_pow2(n)
    if p > 1 and 3 * p // 4 >= n:
        p = 3 * p // 4
    return _round_up(p, multiple)


def _fit_width(arr: np.ndarray, width: int) -> np.ndarray:
    """Pad or trim the column axis to ``width`` (padding never read)."""
    if arr.shape[1] == width:
        return arr
    if arr.shape[1] > width:
        return arr[:, :width]
    out = np.zeros((arr.shape[0], width), arr.dtype)
    out[:, : arr.shape[1]] = arr
    return out


def _pad_rows(arr: np.ndarray, to: int) -> np.ndarray:
    if arr.shape[0] == to:
        return arr
    pad = np.zeros((to - arr.shape[0],) + arr.shape[1:], arr.dtype)
    return np.concatenate([arr, pad], axis=0)


# ---------------------------------------------------------------------------
# Stats / results.


@dataclasses.dataclass
class PIMStats:
    """Phase accounting of the paper's host<->device pipeline (Fig. 1)."""
    n_pairs: int
    n_workers: int
    bytes_in: int
    bytes_out: int
    t_scatter: float
    t_kernel: float
    t_gather: float

    @property
    def t_total(self) -> float:
        return self.t_scatter + self.t_kernel + self.t_gather

    def throughput_total(self) -> float:
        return self.n_pairs / max(self.t_total, 1e-12)

    def throughput_kernel(self) -> float:
        return self.n_pairs / max(self.t_kernel, 1e-12)


@dataclasses.dataclass(frozen=True)
class BucketInfo:
    """One executed problem shape: quantized length + static WFA bounds."""
    lmax: int
    s_max: int
    k_max: int
    n_pairs: int
    recovery: bool = False     # True for adaptive second-pass buckets


@dataclasses.dataclass
class EngineStats:
    """Telemetry for one ``align`` call."""
    n_pairs: int = 0
    n_workers: int = 1
    buckets: List[BucketInfo] = dataclasses.field(default_factory=list)
    n_overflow: int = 0        # pairs unresolved after pass 1
    n_recovered: int = 0       # of those, resolved by the exact-bound pass
    cache_hits: int = 0
    cache_misses: int = 0
    n_traces: int = 0          # first uses of a specialisation key
    rows_real: int = 0         # submitted rows actually dispatched in waves
    rows_padded: int = 0       # device rows incl. quantization padding
    bytes_in: int = 0
    bytes_out: int = 0
    t_scatter: float = 0.0
    t_kernel: float = 0.0
    t_gather: float = 0.0
    peak_trace_bytes: int = 0  # largest trace buffer gathered for one wave

    def merge(self, other: "EngineStats", *,
              count_pairs: bool = True) -> "EngineStats":
        """Fold ``other``'s telemetry into this one, in place -> self."""
        if count_pairs:
            self.n_pairs += other.n_pairs
        self.n_workers = max(self.n_workers, other.n_workers)
        self.buckets.extend(other.buckets)
        for f in ("n_overflow", "n_recovered", "cache_hits", "cache_misses",
                  "n_traces", "rows_real", "rows_padded", "bytes_in",
                  "bytes_out", "t_scatter", "t_kernel", "t_gather"):
            setattr(self, f, getattr(self, f) + getattr(other, f))
        self.peak_trace_bytes = max(self.peak_trace_bytes,
                                    other.peak_trace_bytes)
        return self

    @property
    def n_buckets(self) -> int:
        return len([b for b in self.buckets if not b.recovery])

    @property
    def wave_occupancy(self) -> float:
        """Real rows / device rows across every dispatched wave."""
        return (self.rows_real / self.rows_padded if self.rows_padded
                else 1.0)

    @property
    def padding_waste_frac(self) -> float:
        return 1.0 - self.wave_occupancy

    @property
    def pim(self) -> PIMStats:
        return PIMStats(n_pairs=self.n_pairs, n_workers=self.n_workers,
                        bytes_in=self.bytes_in, bytes_out=self.bytes_out,
                        t_scatter=self.t_scatter, t_kernel=self.t_kernel,
                        t_gather=self.t_gather)


@dataclasses.dataclass
class EngineResult:
    scores: np.ndarray                      # [B] int32; -1 = exceeded s_max
    cigars: Optional[List[np.ndarray]]      # per-pair op arrays, or None
    n_steps: int                            # score-loop trips (telemetry)
    s_max: int                              # largest bound used
    k_max: int
    stats: EngineStats = dataclasses.field(default_factory=EngineStats)
    # True when a non-exact wavefront heuristic produced these results
    approximate: bool = False

    def cigar_strings(self, mode: str = "extended") -> List[str]:
        """Run-length CIGAR strings (SAM 1.4 'extended' or 'classic')."""
        if self.cigars is None:
            raise ValueError("no CIGARs: align with output='cigar'")
        return [cigar_mod.cigar_string(c, mode) for c in self.cigars]

    def cigar_identities(self) -> np.ndarray:
        """[B] float fraction of matching columns (NaN if unresolved)."""
        if self.cigars is None:
            raise ValueError("no CIGARs: align with output='cigar'")
        return np.asarray([
            cigar_mod.cigar_identity(c) if s >= 0 else np.nan
            for s, c in zip(self.scores, self.cigars)])


class _Executable:
    """One backend entry point specialised for a fixed problem shape.

    PyTorch runs eagerly, so there is nothing to compile: the cache entry
    binds the backend callable to its static arguments, and ``n_traces``
    counts the first call (the moment a JAX engine would trace).
    """

    def __init__(self, spec: BackendSpec, pen, s_max: int, k_max: int,
                 output: str = "score", heur=None,
                 opts: Tuple[Tuple[str, object], ...] = ()):
        self.s_max = s_max
        self.k_max = k_max
        self.n_traces = 0
        pen = scoring.as_model(pen)
        heur = scoring.as_heuristic(heur)
        fn = spec.variant(output, pen.kind)
        self._dispatch = spec.dispatch
        extra = {}
        opts = dict(opts)
        if opts.get("band_cap") == "auto":
            opts["band_cap"] = (None if heur.exact
                                else heur.band_cap(2 * k_max + 1))
        for kw, val in opts.items():
            if val is not None and _accepts_kw(fn, kw):
                extra[kw] = val
        if not heur.exact:
            if not spec.accepts_heuristic(output):
                raise ValueError(
                    f"backend {spec.name!r} does not accept wavefront "
                    f"heuristics (no 'heur' keyword on its "
                    f"{output}-variant); use heuristic=None or a "
                    f"heuristic-aware backend")
            extra["heur"] = heur

        def _run(*arrays):
            return fn(*arrays, pen=pen, s_max=s_max, k_max=k_max, **extra)

        self.fn = _run

    def call(self, *arrays):
        if self.n_traces == 0:
            self.n_traces = 1
        if self._dispatch is not None:
            return self._dispatch(self.fn, *arrays)
        return self.fn(*arrays)


class AlignmentEngine:
    """Bucketed, cached, overflow-recovering batch aligner.

    Parameters as in ``repro.core.engine.AlignmentEngine`` (``pen``,
    ``backend``, ``edit_frac``, ``s_max``/``k_max``, ``output``,
    ``heuristic``, ``chunk_pairs``, ``bucket_by_length``,
    ``min_bucket_len``, ``adaptive``, ``max_wave_cells``,
    ``backend_opts``), plus ``device``: where the waves run (``None`` =
    ``"cuda"``, which must be present).  One device is one worker.
    ``trace_variant="bidir"`` (BiWFA) is not ported yet.
    """

    def __init__(self, pen=DEFAULT, *, backend: str = "ring",
                 edit_frac: Optional[float] = None,
                 s_max: Optional[int] = None, k_max: Optional[int] = None,
                 output: str = "score", heuristic=None,
                 chunk_pairs: int = 1 << 16, bucket_by_length: bool = True,
                 min_bucket_len: int = 16, adaptive: bool = True,
                 trace_variant: str = "packed",
                 max_wave_cells: int = 1 << 24,
                 backend_opts: Optional[Dict[str, object]] = None,
                 device=None):
        spec = get_backend(backend)
        self.backend_opts = dict(backend_opts or {})
        for kw in sorted(self.backend_opts):
            if not any(_accepts_kw(f, kw) for f in spec.callables()):
                raise ValueError(
                    f"backend {backend!r} accepts no backend_opts key "
                    f"{kw!r} on any of its callables")
        if output not in ("score", "cigar"):
            raise ValueError(f"unknown output mode {output!r}; "
                             "use 'score' or 'cigar'")
        if trace_variant not in ("packed", "bidir"):
            raise ValueError(f"unknown trace variant {trace_variant!r}; "
                             "use 'packed' or 'bidir'")
        if trace_variant == "bidir":
            raise NotImplementedError(
                "trace_variant='bidir' (BiWFA) is not ported yet")
        self.default_output = output
        self.trace_variant = trace_variant
        if output == "cigar" and not spec.supports_cigar:
            raise ValueError(
                f"CIGAR output needs a backend with a trace variant; "
                f"{backend!r} is score-only")
        self.device = resolve_device(device)
        self.pen = scoring.as_model(pen)
        spec.variant("score", self.pen.kind)   # raises if model unsupported
        self.heuristic = scoring.as_heuristic(heuristic)
        self.backend = backend
        self.edit_frac = edit_frac
        self._s_max = s_max
        self._k_max = k_max
        self.chunk_pairs = int(chunk_pairs)
        self.bucket_by_length = bucket_by_length
        self.min_bucket_len = int(min_bucket_len)
        self.adaptive = adaptive
        # long-read bucket ladder: cap rows-per-wave so wide buckets
        # dispatch narrow waves instead of running out of memory
        self.max_wave_cells = int(max_wave_cells)
        self.n_workers = 1
        self._cache: Dict[tuple, _Executable] = {}

    def resolve_output(self, output: Optional[str], pen=None) -> str:
        """Validate a per-call output mode (None -> the engine default)."""
        out = self.default_output if output is None else output
        if out not in ("score", "cigar"):
            raise ValueError(f"unknown output mode {output!r}; "
                             "use 'score' or 'cigar'")
        if out == "cigar":
            kind = (self.pen if pen is None else pen).kind
            get_backend(self.backend).variant("cigar", kind)
        return out

    def resolve_trace_variant(self, trace_variant: Optional[str],
                              output: str = "score") -> str:
        """Validate a per-call trace variant (None -> the engine default);
        only ``"packed"`` is ported."""
        tv = self.trace_variant if trace_variant is None else trace_variant
        if tv not in ("packed", "bidir"):
            raise ValueError(f"unknown trace variant {trace_variant!r}; "
                             "use 'packed' or 'bidir'")
        if tv == "bidir" and output == "cigar":
            raise NotImplementedError(
                "trace_variant='bidir' (BiWFA) is not ported yet")
        return "packed"

    def resolve_penalties(self, pen) -> "scoring.PenaltyModel":
        """Validate a per-call penalty model (None -> the engine default)."""
        model = self.pen if pen is None else scoring.as_model(pen)
        get_backend(self.backend).variant("score", model.kind)
        return model

    def resolve_heuristic(self, heur,
                          output: str = "score") -> "scoring.WavefrontHeuristic":
        """Validate a per-call heuristic (None -> the engine default)."""
        heur = self.heuristic if heur is None else scoring.as_heuristic(heur)
        if not heur.exact:
            spec = get_backend(self.backend)
            if not spec.accepts_heuristic(output):
                raise ValueError(
                    f"backend {self.backend!r} does not accept wavefront "
                    f"heuristics (no 'heur' keyword on its "
                    f"{output}-variant); use heuristic=None or a "
                    f"heuristic-aware backend")
        return heur

    # -- cache introspection -------------------------------------------------

    @property
    def cache_size(self) -> int:
        return len(self._cache)

    def cache_traces(self) -> int:
        """First uses across all cached specialisations."""
        return sum(e.n_traces for e in self._cache.values())

    # -- bounds --------------------------------------------------------------

    def _bounds_for_bucket(self, lmax: int, plen_b: np.ndarray,
                           tlen_b: np.ndarray, exact: bool,
                           pen=None) -> Tuple[int, int]:
        """Static (s_max, k_max) for one bucket.

        Pass-1 bounds depend only on (pen, lmax, edit_frac), never on the
        data; the exact path rounds ``s_max`` up to a multiple of 32 (the
        score loop exits early regardless), so buckets share cache keys.
        """
        pen = self.pen if pen is None else pen
        max_diff = int(np.abs(tlen_b - plen_b).max(initial=0))
        if self._s_max is not None:
            s = int(self._s_max)
        elif not exact and self.edit_frac is not None:
            n_err = int(math.ceil(self.edit_frac * lmax))
            s = int(pen.score_bound(lmax, self.edit_frac, len_diff=n_err))
            max_diff = 0
        else:
            s = _round_up(_exact_worst_score(pen, plen_b, tlen_b), 32)
        k = self._k_max if self._k_max is not None else \
            min(pen.band_bound(s), lmax)
        return int(s), max(int(k), max_diff, 1)

    # -- bucket planning -----------------------------------------------------

    def _plan_buckets(self, plen: np.ndarray, tlen: np.ndarray,
                      idx: np.ndarray) -> List[Tuple[int, np.ndarray]]:
        """-> [(bucket_len, original-row indices)] sorted by length."""
        lmax = np.maximum(plen[idx], tlen[idx])
        if not self.bucket_by_length:
            width = _next_pow2(max(int(lmax.max(initial=1)),
                                   self.min_bucket_len))
            return [(width, idx)]
        widths = np.maximum(lmax, self.min_bucket_len)
        widths = 2 ** np.ceil(np.log2(np.maximum(widths, 1))).astype(np.int64)
        out = []
        for w in np.unique(widths):
            out.append((int(w), idx[widths == w]))
        return out

    # -- execution -----------------------------------------------------------

    def _device_put(self, *arrays):
        """numpy -> tensors on the engine's device: pinned host buffers and
        ``non_blocking`` copies on a card, zero-copy views on the CPU."""
        out = []
        for a in arrays:
            t = torch.from_numpy(np.ascontiguousarray(a))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out.append(t)
        return tuple(out)

    def _executable_for(self, pshape: tuple, tshape: tuple, s_max: int,
                        k_max: int, output: str = "score",
                        pen=None, heur=None) -> Tuple["_Executable", bool]:
        """Cached specialisation for one problem shape -> (exe, hit)."""
        spec = get_backend(self.backend)
        pen = self.pen if pen is None else pen
        heur = self.heuristic if heur is None else heur
        opts = tuple(sorted(self.backend_opts.items()))
        key = (spec, pen, heur, pshape, tshape, s_max, k_max, output, opts)
        exe = self._cache.get(key)
        if exe is not None:
            obs_metrics.counter("engine_cache_hits_total",
                                "specialisation cache hits").inc()
            return exe, True
        obs_metrics.counter("engine_cache_misses_total",
                            "specialisation cache misses").inc()
        if obs_trace.enabled():
            obs_trace.instant("engine.retrace", args={
                "backend": spec.name, "shape": list(pshape),
                "s_max": s_max, "k_max": k_max, "output": output})
        exe = _Executable(spec, pen, s_max, k_max, output, heur, opts)
        self._cache[key] = exe
        return exe, False

    # -- public entry points -------------------------------------------------

    def stream(self, *, max_inflight_waves: int = 2,
               wave_pairs: Optional[int] = None):
        """Open a pipelined :class:`~repro_torch.core.session.
        AlignmentSession` (``wave_pairs`` defaults to ``chunk_pairs``)."""
        from repro_torch.core.session import AlignmentSession
        return AlignmentSession(self, max_inflight_waves=max_inflight_waves,
                                wave_pairs=wave_pairs)

    def align(self, patterns: Sequence[Seq], texts: Sequence[Seq], *,
              output: Optional[str] = None, penalties=None,
              heuristic=None, trace_variant: Optional[str] = None
              ) -> EngineResult:
        """Align python sequences (str/bytes/int arrays), pairwise."""
        assert len(patterns) == len(texts)
        p, plen = pack_batch(patterns)
        t, tlen = pack_batch(texts)
        return self.align_packed(p, plen, t, tlen, output=output,
                                 penalties=penalties, heuristic=heuristic,
                                 trace_variant=trace_variant)

    def align_packed(self, p: np.ndarray, plen: np.ndarray, t: np.ndarray,
                     tlen: np.ndarray, *, output: Optional[str] = None,
                     penalties=None, heuristic=None,
                     trace_variant: Optional[str] = None) -> EngineResult:
        """Align pre-packed ``[B, L]`` codes + ``[B]`` lens: one ``submit``
        and ``drain`` of a session that times each phase."""
        from repro_torch.core.session import AlignmentSession
        sess = AlignmentSession(self, max_inflight_waves=1,
                                _sync_timing=True)
        ticket = sess.submit_packed(p, plen, t, tlen, output=output,
                                    penalties=penalties,
                                    heuristic=heuristic,
                                    trace_variant=trace_variant)
        sess.drain()
        return ticket.result()

    def align_pair(self, pattern: Seq, text: Seq, *,
                   output: Optional[str] = None, penalties=None,
                   heuristic=None, trace_variant: Optional[str] = None
                   ) -> EngineResult:
        return self.align([pattern], [text], output=output,
                          penalties=penalties, heuristic=heuristic,
                          trace_variant=trace_variant)
