"""Gap-affine penalties and WFA score / diagonal-band bounds.

Convention (Marco-Sola et al. 2021): match = 0, mismatch = x, a gap of
length L costs o + L*e.  WFA propagates wavefronts in increasing score
order, so every buffer in the batched implementation is statically sized
from an upper bound on the final score (``s_max``) and on the reachable
diagonal range (``k_max``).  The bounds below are what the paper's regime
(reads of length L with edit-distance threshold E) implies.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Penalties:
    x: int = 4   # mismatch
    o: int = 6   # gap open
    e: int = 2   # gap extend

    def __post_init__(self):
        assert self.x > 0 and self.o >= 0 and self.e > 0, self

    @property
    def window(self) -> int:
        """Ring-buffer depth: wavefront s reads s-x, s-e and s-o-e."""
        return max(self.x, self.o + self.e) + 1

    def gap_cost(self, length: int) -> int:
        return 0 if length == 0 else self.o + length * self.e


DEFAULT = Penalties()


def score_bound(pen: Penalties, max_len: int, edit_frac: float,
                len_diff: int = 0, slack: int = 2) -> int:
    """Upper bound on the WFA score for a pair within ``edit_frac`` edits.

    Each of the <= ceil(E*L) edits costs at most max(x, o+e) (an isolated
    mismatch or a 1-long gap; longer gaps amortize cheaper per edit), and a
    length difference of d forces a gap of length >= d.
    """
    n_err = int(math.ceil(edit_frac * max_len))
    per = max(pen.x, pen.o + pen.e)
    return n_err * per + pen.o + abs(len_diff) * pen.e + slack


def band_bound(pen: Penalties, s_max: int) -> int:
    """Max |diagonal| reachable with score <= s_max.

    Moving one diagonal away from k=0 needs at least one gap extension, and
    leaving k=0 at all needs one gap opening:  |k| <= (s_max - o) / e.
    """
    if s_max <= pen.o + pen.e:
        return 1
    return (s_max - pen.o) // pen.e + 1


def problem_dims(pen: Penalties, max_len: int, edit_frac: float,
                 len_diff: int = 0):
    """-> (s_max, k_max, K) static buffer dims for a batch."""
    s_max = score_bound(pen, max_len, edit_frac, len_diff)
    k_max = min(band_bound(pen, s_max), max_len)
    return s_max, k_max, 2 * k_max + 1
