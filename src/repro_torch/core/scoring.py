"""Scoring models and wavefront heuristics — the distance-metric seam.

The source paper evaluates one gap-affine setting; its follow-up framework
paper (arXiv:2208.01243) shows the same PIM pipeline pays off across
multiple distance metrics plus a WFA-adaptive band heuristic.  This module
is that seam: a :class:`PenaltyModel` hierarchy selecting the wavefront
*recurrence* and a :class:`WavefrontHeuristic` family selecting the
*pruning* policy.  Both are frozen/hashable dataclasses so they key the
engine's specialisation cache and ride straight into the solvers
(``core.wavefront``) and the CUDA kernel (``kernels.wfa``).

Penalty models (match always costs 0):

* :class:`GapAffine` ``(x, o, e)`` — mismatch ``x``, gap ``o + L*e``.  The
  classic three-matrix M/I/D recurrence (the repo's historic default; a
  plain :class:`~repro.core.penalties.Penalties` normalizes to this).
* :class:`GapLinear` ``(x, e)`` — mismatch ``x``, gap ``L*e``.  With no
  open cost, I/D wavefronts are redundant: gaps chain straight through M,
  so the solvers run a cheaper **one-matrix** recurrence

      M_s[k] = max(M_{s-x}[k] + 1, M_{s-e}[k-1] + 1, M_{s-e}[k+1])

  — one ring buffer instead of three, one packed-backtrace plane instead
  of three, fewer VPU ops per score step.
* :class:`Edit` — Levenshtein distance (``x = e = 1``): the one-matrix
  recurrence with every delta equal to 1, the cheapest variant (window of
  2 wavefronts, score == edit distance).

Wavefront heuristics (the follow-up paper's WFA-adaptive story):

* :class:`NoHeuristic` — exact scores, the default.
* :class:`AdaptiveBand` ``(min_wf_len, max_distance_diff)`` — WFA-adaptive
  (Marco-Sola et al. 2021 §2.5): once a wavefront holds more than
  ``min_wf_len`` live diagonals, prune those whose estimated remaining
  distance to the target cell exceeds the best estimate by more than
  ``max_distance_diff``.  Pruned k-lanes hold the invalid sentinel, so
  they cost no further extension work and their provenance chains die.
* :class:`ZDrop` ``(zdrop)`` — X-drop/Z-drop style: prune diagonals whose
  antidiagonal progress ``h + v`` trails the current front's best by more
  than ``zdrop``.

Heuristic results are **approximate**: scores are an upper bound on (and
with sane parameters on read-like data almost always equal to) the exact
cost, and badly divergent pairs may come back unresolved (``-1``).  Every
result produced under a non-exact heuristic is flagged
``approximate=True`` so downstream consumers can tell.
"""
from __future__ import annotations

import dataclasses
from typing import Union

from repro_torch.core import penalties as penalties_mod
from repro_torch.core.penalties import Penalties

__all__ = [
    "PenaltyModel", "GapAffine", "GapLinear", "Edit",
    "WavefrontHeuristic", "NoHeuristic", "AdaptiveBand", "ZDrop",
    "EXACT", "as_model", "as_heuristic", "parse_penalties",
    "parse_heuristic", "from_reference",
]


# ---------------------------------------------------------------------------
# Penalty models.


@dataclasses.dataclass(frozen=True)
class PenaltyModel:
    """Base class: a scoring scheme the wavefront solvers can compile.

    Subclasses pin the effective ``(x, o, e)`` triple and the recurrence
    ``kind`` — ``"affine"`` (three-matrix M/I/D) or ``"linear"``
    (one-matrix M).  Instances are frozen and hashable: they are jit
    static arguments and executable-cache key components.
    """

    @property
    def kind(self) -> str:
        raise NotImplementedError

    # Effective penalty triple; linear models report o == 0.
    @property
    def x(self) -> int:
        raise NotImplementedError

    @property
    def o(self) -> int:
        return 0

    @property
    def e(self) -> int:
        raise NotImplementedError

    @property
    def window(self) -> int:
        """Ring-buffer depth: wavefront s reads back at most this far."""
        return max(self.x, self.o + self.e) + 1

    def gap_cost(self, length: int) -> int:
        return 0 if length == 0 else self.o + length * self.e

    def unit_cost(self) -> int:
        """Max cost of one isolated edit (mismatch or 1-long gap)."""
        return max(self.x, self.o + self.e)

    def as_penalties(self) -> Penalties:
        """The equivalent ``(x, o, e)`` triple for oracle/rescoring code
        (``gotoh_score*``/``score_cigar`` price any model through it)."""
        return Penalties(x=self.x, o=self.o, e=self.e)

    # The bound formulas are duck-typed on (x, o, e) and canonically live
    # in core.penalties; delegating keeps exactly one copy of the math the
    # engine sizes buffers with.
    def score_bound(self, max_len: int, edit_frac: float,
                    len_diff: int = 0, slack: int = 2) -> int:
        """Upper bound on the score of a pair within ``edit_frac`` edits."""
        return penalties_mod.score_bound(self, max_len, edit_frac,
                                         len_diff=len_diff, slack=slack)

    def band_bound(self, s_max: int) -> int:
        """Max |diagonal| reachable with score <= s_max."""
        return penalties_mod.band_bound(self, s_max)

    def worst_score(self, plen: int, tlen: int) -> int:
        """Exact worst case: all-mismatch diagonal plus one closing gap."""
        return self.x * min(plen, tlen) + self.gap_cost(abs(tlen - plen))


@dataclasses.dataclass(frozen=True)
class GapAffine(PenaltyModel):
    """Gap-affine (Gotoh): mismatch ``x``, gap of length L costs o + L*e."""
    mismatch: int = 4
    gap_open: int = 6
    gap_extend: int = 2

    def __post_init__(self):
        # ValueError, not assert: CLI-reachable (parse_penalties) and must
        # survive python -O (x=0 would read the in-flight ring row)
        if not (self.mismatch > 0 and self.gap_open >= 0
                and self.gap_extend > 0):
            raise ValueError(f"need mismatch > 0, gap_open >= 0, "
                             f"gap_extend > 0: {self}")

    @property
    def kind(self) -> str:
        return "affine"

    @property
    def x(self) -> int:
        return self.mismatch

    @property
    def o(self) -> int:
        return self.gap_open

    @property
    def e(self) -> int:
        return self.gap_extend


@dataclasses.dataclass(frozen=True)
class GapLinear(PenaltyModel):
    """Gap-linear: mismatch ``x``, gap of length L costs L*e (no open)."""
    mismatch: int = 4
    gap_extend: int = 2

    def __post_init__(self):
        if not (self.mismatch > 0 and self.gap_extend > 0):
            raise ValueError(
                f"need mismatch > 0, gap_extend > 0: {self}")

    @property
    def kind(self) -> str:
        return "linear"

    @property
    def x(self) -> int:
        return self.mismatch

    @property
    def e(self) -> int:
        return self.gap_extend


@dataclasses.dataclass(frozen=True)
class Edit(PenaltyModel):
    """Levenshtein distance: every edit costs 1 (x = e = 1, no open)."""

    @property
    def kind(self) -> str:
        return "linear"

    @property
    def x(self) -> int:
        return 1

    @property
    def e(self) -> int:
        return 1


def as_model(pen: Union[PenaltyModel, Penalties, None]) -> PenaltyModel:
    """Normalize to a :class:`PenaltyModel`.

    ``Penalties`` (the historic gap-affine triple) maps to
    :class:`GapAffine`; ``None`` maps to the default gap-affine model.
    """
    if pen is None:
        return GapAffine()
    if isinstance(pen, PenaltyModel):
        return pen
    if isinstance(pen, Penalties):
        return GapAffine(mismatch=pen.x, gap_open=pen.o, gap_extend=pen.e)
    raise TypeError(f"expected PenaltyModel or Penalties, got {pen!r}")


# ---------------------------------------------------------------------------
# Wavefront heuristics.


@dataclasses.dataclass(frozen=True)
class WavefrontHeuristic:
    """Base class for per-score-step wavefront pruning policies."""

    @property
    def exact(self) -> bool:
        """True when results under this heuristic are provably optimal."""
        return False

    def band_cap(self, K: int) -> "int | None":
        """Static compact-band width for a ``K``-diagonal problem, or None.

        A heuristic that keeps its live diagonals inside a bounded span can
        return a cap ``Kc < K``: the solvers then run the whole score loop
        on a ``Kc``-wide *compacting band* that re-centers on the live range
        each step — every per-step vector op shrinks from ``K`` to ``Kc``
        lanes (WFA-adaptive style) instead of masking dead lanes at full
        width.  Lanes that drift outside the compact window are pruned
        exactly as if the heuristic had killed them, so results stay the
        usual heuristic upper bound.  ``None`` (the default) means the
        heuristic gives no useful bound and solvers run full width.
        """
        return None


@dataclasses.dataclass(frozen=True)
class NoHeuristic(WavefrontHeuristic):
    """Keep every diagonal — exact WFA."""

    @property
    def exact(self) -> bool:
        return True


@dataclasses.dataclass(frozen=True)
class AdaptiveBand(WavefrontHeuristic):
    """WFA-adaptive: prune diagonals far from the best remaining-distance
    estimate once the wavefront is longer than ``min_wf_len``."""
    min_wf_len: int = 10
    max_distance_diff: int = 50

    def __post_init__(self):
        if not (self.min_wf_len >= 1 and self.max_distance_diff >= 1):
            raise ValueError(
                f"need min_wf_len >= 1, max_distance_diff >= 1: {self}")

    def band_cap(self, K: int) -> "int | None":
        # live lanes sit within max_distance_diff of the best remaining-
        # distance estimate; adjacent diagonals change the estimate by >= 1
        # each, so the live span is bounded by max_distance_diff lanes on
        # EACH side of the best (two-sided), plus the min_wf_len floor.
        # The +2 margin absorbs the per-step +-1 band growth between
        # re-centerings.
        cap = _round_up(2 * self.max_distance_diff + self.min_wf_len + 2,
                        8) + 1
        return cap if cap < K else None


@dataclasses.dataclass(frozen=True)
class ZDrop(WavefrontHeuristic):
    """Prune diagonals whose antidiagonal progress trails the front's best
    by more than ``zdrop``."""
    zdrop: int = 100

    def __post_init__(self):
        if self.zdrop < 1:
            raise ValueError(f"need zdrop >= 1: {self}")

    def band_cap(self, K: int) -> "int | None":
        # antidiagonal progress h+v drops by >= 1 per diagonal away from
        # the best lane, so live lanes sit within zdrop of it on EITHER
        # side: the live span is two-sided, up to 2*zdrop + 1 lanes
        cap = _round_up(2 * self.zdrop + 2, 8) + 1
        return cap if cap < K else None


def _round_up(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


EXACT = NoHeuristic()


def as_heuristic(h: Union[WavefrontHeuristic, None]) -> WavefrontHeuristic:
    if h is None:
        return EXACT
    if isinstance(h, WavefrontHeuristic):
        return h
    raise TypeError(f"expected WavefrontHeuristic, got {h!r}")


# ---------------------------------------------------------------------------
# CLI spellings (launch/align.py and benchmarks).


def parse_penalties(spec: str) -> PenaltyModel:
    """Parse a CLI penalty spec.

    Accepted forms: ``edit`` | ``linear:x,e`` | ``affine:x,o,e`` | the bare
    triple ``x,o,e`` (historic gap-affine spelling).
    """
    s = spec.strip().lower()
    if s == "edit":
        return Edit()
    if s in ("affine", "gap-affine"):
        return GapAffine()
    if s in ("linear", "gap-linear"):
        return GapLinear()
    if ":" in s:
        head, _, args = s.partition(":")
        nums = [int(v) for v in args.split(",") if v.strip()]
        if head in ("linear", "gap-linear") and len(nums) == 2:
            return GapLinear(mismatch=nums[0], gap_extend=nums[1])
        if head in ("affine", "gap-affine") and len(nums) == 3:
            return GapAffine(*nums)
        raise ValueError(f"bad penalty spec {spec!r}; use 'edit', "
                         "'linear:x,e', 'affine:x,o,e' or 'x,o,e'")
    nums = [int(v) for v in s.split(",") if v.strip()]
    if len(nums) == 3:
        return GapAffine(*nums)
    raise ValueError(f"bad penalty spec {spec!r}; use 'edit', "
                     "'linear:x,e', 'affine:x,o,e' or 'x,o,e'")


def parse_heuristic(spec: str) -> WavefrontHeuristic:
    """Parse a CLI heuristic spec.

    Accepted forms: ``none`` | ``adaptive`` | ``adaptive:min_wf_len,
    max_distance_diff`` | ``zdrop`` | ``zdrop:z``.
    """
    s = spec.strip().lower()
    if s in ("none", "exact", "off"):
        return EXACT
    head, _, args = s.partition(":")
    nums = [int(v) for v in args.split(",") if v.strip()] if args else []
    if head == "adaptive":
        if not nums:
            return AdaptiveBand()
        if len(nums) == 2:
            return AdaptiveBand(min_wf_len=nums[0], max_distance_diff=nums[1])
    elif head == "zdrop":
        if not nums:
            return ZDrop()
        if len(nums) == 1:
            return ZDrop(zdrop=nums[0])
    raise ValueError(f"bad heuristic spec {spec!r}; use 'none', "
                     "'adaptive[:min_wf_len,max_distance_diff]' or "
                     "'zdrop[:z]'")


# ---------------------------------------------------------------------------
# Carrying scoring state across from another implementation.

_BY_NAME = {cls.__name__: cls for cls in (
    GapAffine, GapLinear, Edit, NoHeuristic, AdaptiveBand, ZDrop,
    Penalties)}


def from_reference(obj):
    """This package's penalty model or heuristic equal to ``obj``.

    ``obj`` is a scoring dataclass of another implementation of this API
    (the JAX package's ``GapAffine``, ``ZDrop``, ``Penalties``, ...).  It is
    matched by class name and rebuilt from ``dataclasses.asdict``, so the
    other package is never imported.  ``None`` passes through.
    """
    if obj is None:
        return None
    name = type(obj).__name__
    cls = _BY_NAME.get(name)
    if cls is None or not dataclasses.is_dataclass(obj):
        raise TypeError(f"no counterpart for scoring object {obj!r}")
    return cls(**dataclasses.asdict(obj))
