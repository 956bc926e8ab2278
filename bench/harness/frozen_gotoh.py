"""Frozen copy of the port's dense gap-affine oracle and CIGAR re-scorer.

Copied from ``src/repro_torch/core/gotoh.py`` at commit fd8e385e27c5 (the
file last changed in 4d2b02af10f5): ``gotoh_score_vec`` and
``score_cigar`` unchanged but for their names, with the penalties passed
as plain integers.  The copy stays here so that no change to the program
can move the yardstick; the batched reference in ``reference.py`` is held
against it by the benchmark's tests.

Costs: match 0, mismatch ``x``, a gap of length L ``o + L * e``.  CIGAR
ops: 0 = M (match), 1 = X (mismatch), 2 = I (consumes text), 3 = D
(consumes pattern), -1 padding.
"""
from __future__ import annotations

import numpy as np

BIG = 1 << 28


def gotoh_score(pattern, text, x: int, o: int, e: int) -> int:
    """Global gap-affine cost of one pair, row by row (numpy)."""
    p = np.asarray(pattern)
    t = np.asarray(text)
    n, m = len(p), len(t)
    j_idx = np.arange(m + 1, dtype=np.int64)
    H_prev = np.full(m + 1, BIG, np.int64)          # row i-1 of H
    D_prev = np.full(m + 1, BIG, np.int64)
    H_prev[0] = 0
    H_prev[1:] = o + j_idx[1:] * e                   # row 0 = all-insertion
    for i in range(1, n + 1):
        sub = np.where(p[i - 1] != t, x, 0).astype(np.int64)        # [m]
        M_row = np.full(m + 1, BIG, np.int64)        # diagonal (sub) component
        M_row[1:] = H_prev[:-1] + sub
        D_row = np.minimum(H_prev + o + e, D_prev + e)
        D_row[0] = o + i * e
        # I_row[j] = min over j' < j of  min(M,D)_row[j'] + o + (j-j')*e
        # (open-from-I is dominated by extension, so H can be replaced by
        # min(M, D) inside the scan) -- a prefix-min over g[j'] - j'*e.
        g = np.minimum(M_row, D_row) + o - j_idx * e                 # [m+1]
        run = np.minimum.accumulate(g)
        I_row = np.full(m + 1, BIG, np.int64)
        I_row[1:] = run[:-1] + j_idx[1:] * e
        H_row = np.minimum(np.minimum(M_row, I_row), D_row)
        H_row[0] = D_row[0]
        H_prev, D_prev = H_row, D_row
    return int(H_prev[m])


def score_cigar(cigar_ops, pattern, text, x: int, o: int, e: int):
    """Validate + cost a CIGAR op sequence -> (cost, consumed_pattern,
    consumed_text, ok); ``ok`` checks the claimed match/mismatch ops
    against the actual characters."""
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
            cost += x
            i, j = i + 1, j + 1
        elif op == 2:    # insertion (consumes text)
            cost += e + (o if prev != 2 else 0)
            j += 1
        elif op == 3:    # deletion (consumes pattern)
            cost += e + (o if prev != 3 else 0)
            i += 1
        else:
            ok = False
        prev = op
    return cost, i, j, ok
