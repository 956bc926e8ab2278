"""The yardstick of the WFA kernels' rooflines: work counted from the
inputs and the reference's optimal scores alone, never from a choice of
the program (its bounds, lane counts, block exits or character width).

Operations.  Gap-affine wavefronts at score ``s`` (diagonal ``k = h - v``,
text position minus pattern position)::

    I_s[k] = max(M_{s-o-e}[k-1], I_{s-e}[k-1]) + 1
    D_s[k] = max(M_{s-o-e}[k+1], D_{s-e}[k+1])
    M_s[k] = max(M_{s-x}[k] + 1, I_s[k], D_s[k]),  then extended

A cell exists where one of its inputs does (``M_0`` holds ``k = 0``
only); cells outside the pair's diagonals ``-plen <= k <= tlen`` are
dropped.  Each existing cell costs at least one operation (a maximum or an
increment: one instruction even where three inputs meet, since the card
has a three-input maximum), and each M cell one compare more, the one that
ends its extension.  A pair is charged every cell of the scores below its
optimum and the one cell that reaches its end.  A correct implementation
of the recurrence computes at least these, so the count is a floor.

Bytes.  Each base once at 2 bits, both lengths once as int32, each score
once as int32 and, for the trace kernel, the CIGAR at 2 bits an operation,
of which an alignment has at least ``max(plen, tlen)``.
"""
from __future__ import annotations

import functools

import numpy as np

# NVIDIA H100 SXM (the data sheet): HBM3 bandwidth; INT32 issue rate of
# 132 SMs x 64 INT32 lanes x 1.98 GHz (boost clock)
PEAKS = {"hbm_bytes_per_s": 3.35e12, "int32_ops_per_s": 132 * 64 * 1.98e9}

M_OPS = 2        # a maximum or increment, and the compare ending the extend
GAP_OPS = 1      # a maximum or increment


@functools.lru_cache(maxsize=8)
def _cell_table(x: int, o: int, e: int, s_hi: int):
    """-> (C [s_hi + 2, 2K + 2], K): ``C[s, K + k + 1]`` is the weighted
    count of cells of the scores below ``s`` on diagonals ``<= k``."""
    K = s_hi // max(e, 1) + 2
    width = 2 * K + 1                     # diagonals -K .. K
    M = np.zeros((s_hi + 1, width), bool)
    I = np.zeros_like(M)
    D = np.zeros_like(M)
    M[0, K] = True
    for s in range(1, s_hi + 1):
        if s - o - e >= 0:
            I[s, 1:] |= M[s - o - e, :-1]
            D[s, :-1] |= M[s - o - e, 1:]
        if s - e >= 0:
            I[s, 1:] |= I[s - e, :-1]
            D[s, :-1] |= D[s - e, 1:]
        if s - x >= 0:
            M[s] |= M[s - x]
        M[s] |= I[s] | D[s]
    w = (M_OPS * M + GAP_OPS * (I.astype(np.int64) + D)).astype(np.int64)
    by_k = np.concatenate([np.zeros((s_hi + 1, 1), np.int64),
                           np.cumsum(w, axis=1)], axis=1)
    C = np.concatenate([np.zeros((1, width + 1), np.int64),
                        np.cumsum(by_k, axis=0)], axis=0)
    return C, K


def wavefront_ops(score: np.ndarray, plen: np.ndarray, tlen: np.ndarray,
                  x: int, o: int, e: int) -> np.ndarray:
    """[N] operations each pair needs at least (see the module doc)."""
    score = np.asarray(score, np.int64)
    if score.size == 0:
        return np.zeros(0, np.int64)
    if np.any(score < 0):
        raise ValueError("work is counted from optimal scores only")
    s_hi = int(score.max())
    C, K = _cell_table(int(x), int(o), int(e), s_hi)
    lo = np.clip(-np.asarray(plen, np.int64), -K, K + 1) + K   # k >= -plen
    hi = np.clip(np.asarray(tlen, np.int64), -K - 1, K) + K + 1
    rows = C[score]
    return rows[np.arange(score.size), hi] - rows[np.arange(score.size), lo] \
        + M_OPS


def wave_bytes(plen: np.ndarray, tlen: np.ndarray, trace: bool) -> int:
    """Bytes a launch over these pairs has to move at least."""
    plen = np.asarray(plen, np.int64)
    tlen = np.asarray(tlen, np.int64)
    n = (plen + tlen) * 2 / 8 + 2 * 4 + 4
    if trace:
        n = n + np.maximum(plen, tlen) * 2 / 8
    return int(np.ceil(n.sum()))


def roofline_pct(n_bytes: float, n_ops: float, seconds: float) -> float:
    """The least time the card could take (the larger of the bytes over
    the memory rate and the operations over the INT32 rate) over the
    measured time, in %."""
    return 100.0 * max(n_bytes / PEAKS["hbm_bytes_per_s"],
                       n_ops / PEAKS["int32_ops_per_s"]) / seconds
