"""Dense gap-affine DP (Needleman-Wunsch-Gotoh), minimizing cost.

This is the independent correctness oracle for the WFA implementation:
WFA is an *exact* algorithm, so its score must equal the Gotoh global
gap-affine cost for every pair — that equality is the paper's own
correctness contract.  Kept in plain numpy (O(n*m)) on purpose: it shares
no code with the wavefront path.

It also plays the role of the "classical CPU DP" in benchmark ablations
(WFA's O(n*s) vs the dense O(n*m) is the reason WFA is the state of the
art that the paper accelerates).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.penalties import Penalties

BIG = 1 << 28


def gotoh_score(pattern, text, pen: Penalties) -> int:
    """Global gap-affine alignment cost (match=0, mismatch=x, gap o+L*e).

    pattern/text: 1-D integer (or byte) arrays / sequences.
    """
    p = np.asarray(pattern)
    t = np.asarray(text)
    n, m = len(p), len(t)
    # H[i,j]: best cost at cell (= WFA's folded M wavefront); I: gap
    # consuming text (insertion); D: gap consuming pattern (deletion).
    # Gaps open from H (so I-after-D chains are allowed, as in WFA where
    # M_s[k] folds I_s/D_s before feeding the next open).
    H = np.full((n + 1, m + 1), BIG, dtype=np.int64)
    I = np.full((n + 1, m + 1), BIG, dtype=np.int64)
    D = np.full((n + 1, m + 1), BIG, dtype=np.int64)
    H[0, 0] = 0
    for j in range(1, m + 1):
        I[0, j] = pen.o + j * pen.e
        H[0, j] = I[0, j]
    for i in range(1, n + 1):
        D[i, 0] = pen.o + i * pen.e
        H[i, 0] = D[i, 0]
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            sub = pen.x if p[i - 1] != t[j - 1] else 0
            I[i, j] = min(H[i, j - 1] + pen.o + pen.e, I[i, j - 1] + pen.e)
            D[i, j] = min(H[i - 1, j] + pen.o + pen.e, D[i - 1, j] + pen.e)
            H[i, j] = min(H[i - 1, j - 1] + sub, I[i, j], D[i, j])
    return int(H[n, m])


def gotoh_score_vec(pattern, text, pen: Penalties) -> int:
    """Anti-diagonal-free vectorized Gotoh (row-wise numpy; faster oracle).

    Row sweep with I computed by running-min trick along the row:
    I[i,j] = min over j' < j of (M[i,j'] + o + (j-j')e, ...) — expressed as
    a prefix scan so each row is O(m) numpy ops instead of a Python loop.
    """
    p = np.asarray(pattern)
    t = np.asarray(text)
    n, m = len(p), len(t)
    j_idx = np.arange(m + 1, dtype=np.int64)
    H_prev = np.full(m + 1, BIG, np.int64)          # row i-1 of H
    D_prev = np.full(m + 1, BIG, np.int64)
    H_prev[0] = 0
    H_prev[1:] = pen.o + j_idx[1:] * pen.e           # row 0 = all-insertion
    for i in range(1, n + 1):
        sub = np.where(p[i - 1] != t, pen.x, 0).astype(np.int64)    # [m]
        M_row = np.full(m + 1, BIG, np.int64)        # diagonal (sub) component
        M_row[1:] = H_prev[:-1] + sub
        D_row = np.minimum(H_prev + pen.o + pen.e, D_prev + pen.e)
        D_row[0] = pen.o + i * pen.e
        # I_row[j] = min over j' < j of  min(M,D)_row[j'] + o + (j-j')*e
        # (open-from-I is dominated by extension, so H can be replaced by
        # min(M, D) inside the scan) — a prefix-min over g[j'] - j'*e.
        g = np.minimum(M_row, D_row) + pen.o - j_idx * pen.e         # [m+1]
        run = np.minimum.accumulate(g)
        I_row = np.full(m + 1, BIG, np.int64)
        I_row[1:] = run[:-1] + j_idx[1:] * pen.e
        H_row = np.minimum(np.minimum(M_row, I_row), D_row)
        H_row[0] = D_row[0]
        H_prev, D_prev = H_row, D_row
    return int(H_prev[m])


def score_cigar(cigar_ops, pattern, text, pen: Penalties):
    """Validate + cost a CIGAR op sequence (0=M,1=X,2=I,3=D; -1 padding).

    Returns (cost, consumed_pattern, consumed_text, ok) where ok checks the
    claimed match/mismatch ops against the actual characters.
    """
    p = np.asarray(pattern)
    t = np.asarray(text)
    i = j = 0
    cost = 0
    ok = True
    prev = -1
    for op in np.asarray(cigar_ops):
        op = int(op)
        if op < 0:
            continue
        if op == 0:      # match
            ok &= i < len(p) and j < len(t) and p[i] == t[j]
            i, j = i + 1, j + 1
        elif op == 1:    # mismatch
            ok &= i < len(p) and j < len(t) and p[i] != t[j]
            cost += pen.x
            i, j = i + 1, j + 1
        elif op == 2:    # insertion (consumes text)
            cost += pen.e + (pen.o if prev != 2 else 0)
            j += 1
        elif op == 3:    # deletion (consumes pattern)
            cost += pen.e + (pen.o if prev != 3 else 0)
            i += 1
        else:
            ok = False
        prev = op
    return cost, i, j, ok
