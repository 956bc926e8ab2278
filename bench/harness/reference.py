"""The plain reference that decides ``correct``.

* :func:`gotoh_scores` -- the global gap-affine cost of every pair, by the
  row-by-row recurrence of ``frozen_gotoh.gotoh_score`` batched over pairs
  in plain PyTorch (any device; on the card it runs after the window, in
  blocks of pairs).
* :func:`rescore_cigars` -- ``frozen_gotoh.score_cigar`` over many pairs at
  once in numpy: each CIGAR's cost, how much of each sequence it consumes,
  and whether its match / mismatch claims hold.

Nothing here imports the program: it works from the codes and lengths the
benchmark generated and reads the program's CIGARs only to judge them.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

BIG = 1 << 28


def _gotoh_block(P: torch.Tensor, plen: torch.Tensor, T: torch.Tensor,
                 tlen: torch.Tensor, x: int, o: int, e: int,
                 rows_due) -> torch.Tensor:
    """Row by row, each row of every pair at once; ``rows_due``: the rows
    at which some pair ends."""
    B, m = T.shape[0], T.shape[1]
    dev = T.device
    j = torch.arange(m + 1, dtype=torch.int32, device=dev)[None, :]
    open_j = o - j * e                   # g's offset: o - j e
    ext_j = j[:, 1:] * e                 # I's: j e
    H = (o + j * e).expand(B, m + 1).clone()
    H[:, 0] = 0
    D = torch.full((B, m + 1), BIG, dtype=torch.int32, device=dev)
    M = torch.full((B, m + 1), BIG, dtype=torch.int32, device=dev)
    I = torch.full((B, m + 1), BIG, dtype=torch.int32, device=dev)
    ti = tlen.long()[:, None]
    out = torch.where(plen == 0, H.gather(1, ti)[:, 0],
                      torch.full_like(plen, -1))
    for i in range(1, int(plen.max()) + 1):
        sub = (P[:, i - 1:i] != T).to(torch.int32).mul_(x)          # [B, m]
        torch.add(H[:, :-1], sub, out=M[:, 1:])
        D = torch.minimum(H.add_(o + e), D.add_(e))
        D[:, 0] = o + i * e
        g = torch.minimum(M, D).add_(open_j)
        run = torch.cummin(g, dim=1).values
        torch.add(run[:, :-1], ext_j, out=I[:, 1:])
        H = torch.minimum(M, I)
        torch.minimum(H, D, out=H)
        H[:, 0] = D[:, 0]
        if i in rows_due:
            out = torch.where(plen == i, H.gather(1, ti)[:, 0], out)
    return out


def gotoh_scores(P: np.ndarray, plen: np.ndarray, T: np.ndarray,
                 tlen: np.ndarray, x: int, o: int, e: int, *,
                 device="cpu", block_cells: int = 1 << 27) -> np.ndarray:
    """[N] global gap-affine costs of the pairs ``P[i, :plen[i]]``,
    ``T[i, :tlen[i]]`` (int32 codes), in blocks of about ``block_cells``
    DP cells a row."""
    N = int(P.shape[0])
    out = np.empty(N, np.int64)
    if N == 0:
        return out
    n = max(int(plen.max()), 1)
    m = max(int(tlen.max()), 1)
    step = max(1, block_cells // (m + 1))
    for lo in range(0, N, step):
        hi = min(N, lo + step)
        to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        got = _gotoh_block(to(P[lo:hi, :n].astype(np.int32)),
                           to(plen[lo:hi].astype(np.int32)),
                           to(T[lo:hi, :m].astype(np.int32)),
                           to(tlen[lo:hi].astype(np.int32)), x, o, e,
                           set(np.unique(plen[lo:hi]).tolist()))
        out[lo:hi] = got.cpu().numpy()
    return out


def rescore_cigars(cigars: Sequence[np.ndarray], P: np.ndarray,
                   plen: np.ndarray, T: np.ndarray, tlen: np.ndarray,
                   x: int, o: int, e: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """-> (cost, consumed pattern, consumed text, ok), one each per pair,
    as ``frozen_gotoh.score_cigar`` gives them."""
    N = len(cigars)
    lens = np.array([len(c) for c in cigars], np.int64)
    ops = (np.concatenate([np.asarray(c, np.int64).reshape(-1)
                           for c in cigars]) if lens.sum()
           else np.zeros(0, np.int64))
    owner = np.repeat(np.arange(N), lens)
    keep = ops >= 0                      # -1 is padding, skipped
    ops, owner = ops[keep], owner[keep]
    bad_code = np.bincount(owner[ops > 3], minlength=N) > 0
    adv_i = np.isin(ops, (0, 1, 3)).astype(np.int64)
    adv_j = np.isin(ops, (0, 1, 2)).astype(np.int64)
    ci = np.bincount(owner, adv_i, minlength=N).astype(np.int64)
    cj = np.bincount(owner, adv_j, minlength=N).astype(np.int64)
    start = np.concatenate([[0], np.cumsum(np.bincount(owner,
                                                       minlength=N))[:-1]])
    first = np.zeros(ops.size, bool)
    first[start[np.bincount(owner, minlength=N) > 0]] = True
    # position in each sequence before each op
    pi = np.cumsum(adv_i) - adv_i
    pj = np.cumsum(adv_j) - adv_j
    if ops.size:
        base_i = np.concatenate([[0], np.cumsum(adv_i)])[start]
        base_j = np.concatenate([[0], np.cumsum(adv_j)])[start]
        pi = pi - base_i[owner]
        pj = pj - base_j[owner]
    diag = (ops == 0) | (ops == 1)
    inside = (pi < plen[owner]) & (pj < tlen[owner])
    a = P[owner, np.minimum(pi, P.shape[1] - 1)]
    b = T[owner, np.minimum(pj, T.shape[1] - 1)]
    wrong = diag & ~(inside & np.where(ops == 0, a == b, a != b))
    prev = np.concatenate([[-1], ops[:-1]])
    prev[first] = -1
    gap = (ops == 2) | (ops == 3)
    op_cost = (np.where(ops == 1, x, 0) + np.where(gap, e, 0)
               + np.where(gap & (prev != ops), o, 0))
    cost = np.bincount(owner, op_cost, minlength=N).astype(np.int64)
    ok = ~bad_code & (np.bincount(owner[wrong], minlength=N) == 0)
    return cost, ci, cj, ok


def check_pairs(scores: np.ndarray, ref: np.ndarray, cigars: List,
                P, plen, T, tlen, x: int, o: int, e: int) -> dict:
    """Every judged pair against the reference -> counts of wrong answers:
    ``score_mismatch`` (the program's score is not the optimum, or is
    missing) and, with CIGARs, ``cigar_bad`` (one that does not consume
    both sequences, claims a match that is not one, or does not cost the
    optimum)."""
    out = {"score_mismatch": int(np.sum(scores != ref))}
    if cigars is not None:
        cost, ci, cj, ok = rescore_cigars(cigars, P, plen, T, tlen, x, o, e)
        good = ok & (ci == plen) & (cj == tlen) & (cost == ref)
        out["cigar_bad"] = int(np.sum(~good))
    return out
