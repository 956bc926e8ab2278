"""Candidate generation: anchors from the index + colinear chaining.

A read's minimizers are looked up in the :class:`~repro_torch.mapping.index.
MinimizerIndex`; every (read position, reference position) seed hit is an
**anchor**.  Anchors of one (reference, strand) group that lie near a
common diagonal are merged by the classic colinear chaining DP (minimap2
§2.1 shape): anchors are sorted by reference position and scored

    score[i] = max(k, max_j  score[j] + gain(i, j) - gap(i, j))

over a bounded predecessor window, where ``gain`` is the number of new
bases anchor *i* covers (<= k, less when overlapping *j*) and ``gap``
penalizes the diagonal drift ``|dr - dq|``.  The window bound makes the
whole pass O(n log n) in the anchor count (sort dominates); read-scale
anchor lists are tiny, so this is pure numpy/python with no device work.

Strand handling: for reverse-strand anchors the read coordinate is
flipped to the reverse-complemented read (``qpos' = read_len - k -
qpos``), which makes reverse matches colinear in exactly the same
(ref, query) plane — the chain's coordinates then directly describe the
revcomp(read) that the extension stage aligns.

Output: ranked :class:`Chain` candidates (best first) with the
(reference, strand, span) the extension stage needs.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.data.dna import as_ascii
from repro_torch.mapping.index import MinimizerIndex, extract_minimizers

__all__ = ["Anchor", "Chain", "read_anchors", "chain_anchors", "candidates"]


@dataclasses.dataclass(frozen=True)
class Anchor:
    """One seed hit: read k-mer == reference k-mer (strand-adjusted)."""
    ref_id: int
    rpos: int          # k-mer start on the reference (forward strand)
    qpos: int          # k-mer start on the strand-adjusted read
    strand: int        # 0 = read forward, 1 = read reverse-complemented


@dataclasses.dataclass(frozen=True)
class Chain:
    """One ranked candidate locus: a colinear run of anchors."""
    ref_id: int
    strand: int
    score: float       # chaining score (covered bases minus gap penalty)
    n_anchors: int
    qstart: int        # [qstart, qend) on the strand-adjusted read
    qend: int
    rstart: int        # [rstart, rend) on the forward reference
    rend: int

    @property
    def diag(self) -> int:
        """Approximate read-start diagonal: ref position of read base 0."""
        return self.rstart - self.qstart


def read_anchors(index: MinimizerIndex, read) -> Tuple[np.ndarray, np.ndarray,
                                                       np.ndarray, np.ndarray]:
    """-> (ref_id, rpos, qpos, strand) int32 anchor arrays for one read.

    ``qpos`` is already flipped onto the reverse-complemented read for
    strand-1 anchors (see module docstring); seeds over the index's
    occurrence cap contribute nothing.
    """
    read = as_ascii(read)
    seeds, qpos, qstrand = extract_minimizers(read, index.k, index.w)
    empty = (np.empty(0, np.int32),) * 4
    if seeds.size == 0:
        return empty
    start, count = index.lookup(seeds)
    hit = count > 0
    if not hit.any():
        return empty
    # expand (start, count) slices into flat occurrence indices
    reps = count[hit].astype(np.int64)
    occ_idx = np.repeat(start[hit], reps) + _ranges(reps)
    q = np.repeat(qpos[hit], reps).astype(np.int64)
    qs = np.repeat(qstrand[hit], reps)
    strand = (qs ^ index.occ_strand[occ_idx]).astype(np.int32)
    # reverse-strand anchors: read coordinate on the revcomp'd read
    q = np.where(strand == 1, len(read) - index.k - q, q)
    return (index.occ_ref[occ_idx].astype(np.int32),
            index.occ_pos[occ_idx].astype(np.int32),
            q.astype(np.int32), strand)


def _ranges(counts: np.ndarray) -> np.ndarray:
    """[3, 2] -> [0, 1, 2, 0, 1]: per-slice offsets for np.repeat starts."""
    total = int(counts.sum())
    out = np.arange(total, dtype=np.int64)
    ends = np.cumsum(counts) - counts
    return out - np.repeat(ends, counts)


def chain_anchors(ref_id: np.ndarray, rpos: np.ndarray, qpos: np.ndarray,
                  strand: np.ndarray, k: int, *, max_gap: int = 200,
                  max_pred: int = 32, gap_scale: float = 0.5,
                  min_score: float = 0.0,
                  max_chains: int = 16) -> List[Chain]:
    """Colinear chaining DP over anchor arrays -> ranked chains.

    Works per (ref_id, strand) group.  ``max_gap`` bounds both the
    reference and query jump between chained anchors, ``max_pred`` the DP
    predecessor window (the O(n log n) bound), ``gap_scale`` the cost per
    base of diagonal drift.  Returns at most ``max_chains`` chains with
    ``score > min_score``, best first; each anchor belongs to one chain
    (greedy primary-chain extraction in score order).
    """
    n = len(rpos)
    if n == 0:
        return []
    ref_id = np.asarray(ref_id, np.int64)
    rpos = np.asarray(rpos, np.int64)
    qpos = np.asarray(qpos, np.int64)
    strand = np.asarray(strand, np.int64)
    # one sort over (group, ref position, query position); groups are then
    # contiguous runs and the DP below never crosses a group boundary
    group = ref_id * 2 + strand
    order = np.lexsort((qpos, rpos, group))
    g, r, q = group[order], rpos[order], qpos[order]

    # plain python lists in the DP: the anchor lists are tiny and numpy
    # scalar indexing costs ~10x a list index in this loop
    gl, rl, ql = g.tolist(), r.tolist(), q.tolist()
    score = [float(k)] * n
    parent = [-1] * n
    for i in range(n):
        lo = max(0, i - max_pred)
        gi, ri, qi, si = gl[i], rl[i], ql[i], score[i]
        pi = -1
        for j in range(i - 1, lo - 1, -1):
            if gl[j] != gi:
                break
            dr = ri - rl[j]
            dq = qi - ql[j]
            if dr <= 0 or dq <= 0 or dr > max_gap or dq > max_gap:
                continue
            cand = score[j] + min(k, dr, dq) - gap_scale * abs(dr - dq)
            if cand > si:
                si = cand
                pi = j
        score[i] = si
        parent[i] = pi

    score = np.asarray(score)
    chains: List[Chain] = []
    used = np.zeros(n, bool)
    for i in np.argsort(-score, kind="stable"):
        if used[i] or score[i] <= min_score:
            continue
        members = []
        j = int(i)
        while j >= 0 and not used[j]:
            members.append(j)
            used[j] = True
            j = int(parent[j])
        m = np.asarray(members[::-1])
        # a backtrack truncated at an already-used anchor is a branch off
        # an earlier chain: re-base its score to the kept members only
        # (score is a prefix sum along the parent chain), else the stub
        # would inherit the primary's full score and outrank genuine
        # secondary loci
        adj = float(score[i] - score[m[0]]) + k
        if adj <= min_score:
            continue
        oi = order[i]
        chains.append(Chain(
            ref_id=int(ref_id[oi]), strand=int(strand[oi]),
            score=adj, n_anchors=len(m),
            qstart=int(q[m[0]]), qend=int(q[m[-1]]) + k,
            rstart=int(r[m[0]]), rend=int(r[m[-1]]) + k))
        if len(chains) >= max_chains:
            break
    chains.sort(key=lambda c: -c.score)
    return chains


def candidates(index: MinimizerIndex, read, *, top_n: int = 2,
               max_gap: int = 200, min_score: float = 0.0) -> List[Chain]:
    """Ranked candidate loci for one read: anchors + chaining, best first."""
    ref, rpos, qpos, strand = read_anchors(index, read)
    chains = chain_anchors(ref, rpos, qpos, strand, index.k,
                           max_gap=max_gap, min_score=min_score,
                           max_chains=max(top_n * 4, 8))
    return chains[:top_n]
