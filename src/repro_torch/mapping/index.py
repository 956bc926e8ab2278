"""Minimizer k-mer index over reference sequences.

Candidate generation is the stage that decides end-to-end read-mapping
throughput (Ben-Hur et al., arXiv:2411.03832), so the index is built the
way the fast mappers build theirs (minimap2 lineage, Roberts et al. 2004
minimizers):

* **2-bit packed seeds** — k-mers are packed into int64 (2 bits/base, so
  k <= 31).  Bytes outside ACGT (N, IUPAC codes) get the
  :data:`~repro_torch.data.dna.NCODE` sentinel and poison every window that
  covers them: N runs produce *no* seeds rather than false ones.
* **strand canonicalization** — each k-mer is stored as
  ``min(fwd, revcomp)`` plus the bit saying which strand won, so one
  index serves both strands and a read's strand falls out of an XOR at
  query time.
* **minimizers** — of every ``w`` consecutive k-mers, only the one with
  the smallest mixed hash is kept (~2/(w+1) sampling) — the classic
  windowed sampling that guarantees any two sequences sharing a
  ``w + k - 1`` exact stretch share a seed.
* **open-addressed hash buckets** — unique seeds live in a power-of-two
  linear-probe table (load factor <= 0.5) mapping seed -> a slice of one
  position-sorted occurrence array.  Both build and lookup are
  *batch-vectorized*: probing advances all unresolved keys one slot per
  round instead of looping per key.
* **occurrence cap** — seeds occurring more than ``occ_cap`` times in the
  reference are dropped at build time (repeats would otherwise flood
  candidate generation; this is minimap2's top-frequency filter in its
  simplest form).

The index is a plain dataclass of numpy arrays — picklable, built once,
shared read-only across queries (:meth:`MinimizerIndex.save` /
:meth:`MinimizerIndex.load`).  A pickle names its class, here
``repro_torch.mapping.index.MinimizerIndex``: this package loads only
indexes it saved itself, never one pickled by ``repro.mapping`` (loading
that would import the JAX package).  Both packages build the same arrays
from the same references.
"""
from __future__ import annotations

import dataclasses
import pickle
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.data.dna import NCODE, as_ascii, encode_2bit

__all__ = ["MinimizerIndex", "extract_minimizers"]

_EMPTY = np.int64(-1)        # empty hash-table slot


def _mix64(h: np.ndarray) -> np.ndarray:
    """Invertible 64-bit finalizer (splitmix64 flavor) — decorrelates the
    lexicographic k-mer order so minimizer sampling is uniform."""
    h = np.asarray(h, np.uint64).copy()
    h ^= h >> np.uint64(30)
    h *= np.uint64(0xBF58476D1CE4E5B9)
    h ^= h >> np.uint64(27)
    h *= np.uint64(0x94D049BB133111EB)
    h ^= h >> np.uint64(31)
    return h


def _pack_kmers(codes: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """[L] 2-bit codes -> (packed [L-k+1] int64 fwd k-mers, valid mask).

    Vectorized sliding-window matmul: position i packs
    ``codes[i:i+k]`` big-endian (first base in the high bits).  Windows
    touching an NCODE sentinel are invalid.
    """
    L = len(codes)
    n = L - k + 1
    if n <= 0:
        return np.empty(0, np.int64), np.empty(0, bool)
    win = np.lib.stride_tricks.sliding_window_view(codes, k)      # [n, k]
    valid = (win < NCODE).all(axis=1)
    shifts = (2 * np.arange(k - 1, -1, -1)).astype(np.int64)
    # sentinel codes are masked out of the pack so invalid windows still
    # produce an in-range (ignored) value rather than garbage bits
    fwd = ((win.astype(np.int64) & 3) << shifts).sum(axis=1)
    return fwd, valid


def _revcomp_kmers(fwd: np.ndarray, k: int) -> np.ndarray:
    """Packed reverse complements: complement every base (XOR with 11),
    then reverse the base order within the word."""
    v = (~fwd) & ((np.int64(1) << np.int64(2 * k)) - 1)     # complement
    rc = np.zeros_like(v)
    for _ in range(k):
        rc = (rc << 2) | (v & 3)
        v >>= 2
    return rc


def extract_minimizers(seq, k: int, w: int) -> Tuple[np.ndarray, np.ndarray,
                                                     np.ndarray]:
    """-> (seeds int64, positions int32, strands uint8) for one sequence.

    ``seeds`` are canonical packed k-mers (min of forward and reverse
    complement), ``positions`` the k-mer start on the given sequence,
    ``strands`` 1 when the reverse complement was the canonical form.
    Strand-ambiguous k-mers (palindromes: fwd == rc) are dropped, as in
    minimap2 — their strand bit would be meaningless.
    """
    codes = encode_2bit(as_ascii(seq))
    fwd, valid = _pack_kmers(codes, k)
    if fwd.size == 0:
        z = np.empty(0, np.int64)
        return z, np.empty(0, np.int32), np.empty(0, np.uint8)
    rc = _revcomp_kmers(fwd, k)
    strand = (rc < fwd).astype(np.uint8)
    canon = np.where(strand.astype(bool), rc, fwd)
    valid &= fwd != rc                       # drop palindromic k-mers
    # windowed minimizer sampling over the mixed hash; invalid k-mers get
    # the max hash so they can never win a window
    h = _mix64(canon.astype(np.uint64))
    h = np.where(valid, h, np.uint64(0xFFFFFFFFFFFFFFFF))
    if len(h) <= w:
        pick = np.array([int(np.argmin(h))]) if valid.any() else \
            np.empty(0, np.int64)
    else:
        hw = np.lib.stride_tricks.sliding_window_view(h, w)   # [n-w+1, w]
        pick = np.unique(hw.argmin(axis=1) + np.arange(hw.shape[0]))
    if pick.size:
        pick = pick[valid[pick]]             # all-N windows picked nothing
    return (canon[pick].astype(np.int64), pick.astype(np.int32),
            strand[pick])


def _probe_insert(table_key: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """Vectorized linear-probe insert of unique ``keys`` -> slot per key.

    Each round resolves, for every still-unplaced key, whether its current
    slot is free; first-come-first-served collisions within a round are
    broken by ``np.unique``.  Rounds are bounded by the longest probe
    cluster (short at load factor <= 0.5).
    """
    mask = np.int64(len(table_key) - 1)
    slot = (_mix64(keys.astype(np.uint64)).astype(np.int64)) & mask
    out = np.full(len(keys), -1, np.int64)
    pending = np.arange(len(keys))
    while pending.size:
        s = slot[pending]
        free = table_key[s] == _EMPTY
        # one winner per contested free slot this round
        uniq_s, first = np.unique(s[free], return_index=True)
        winners = pending[free][first]
        table_key[slot[winners]] = keys[winners]
        out[winners] = slot[winners]
        placed = np.zeros(len(keys), bool)
        placed[winners] = True
        pending = pending[~placed[pending]]
        slot[pending] = (slot[pending] + 1) & mask
    return out


def _probe_lookup(table_key: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """Vectorized linear-probe lookup -> table slot per query (-1 = miss)."""
    mask = np.int64(len(table_key) - 1)
    slot = (_mix64(queries.astype(np.uint64)).astype(np.int64)) & mask
    out = np.full(len(queries), -1, np.int64)
    pending = np.arange(len(queries))
    while pending.size:
        s = slot[pending]
        got = table_key[s]
        hit = got == queries[pending]
        out[pending[hit]] = s[hit]
        miss = got == _EMPTY
        pending = pending[~(hit | miss)]
        slot[pending] = (slot[pending] + 1) & mask
    return out


def _next_pow2(n: int) -> int:
    n = max(1, int(n))
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass
class MinimizerIndex:
    """Immutable minimizer index over a set of reference sequences.

    Built once with :meth:`build`, shared read-only across queries;
    pickles cleanly (plain numpy arrays + python scalars) for
    ``--save-index`` / ``--index`` reuse.
    """
    k: int
    w: int
    occ_cap: int
    names: List[str]                    # per-reference
    lengths: np.ndarray                 # [n_refs] int64
    seqs: List[np.ndarray]              # ASCII uint8, kept for extension
    table_key: np.ndarray               # [m] int64 open-addressed seeds
    table_start: np.ndarray             # [m] int64 slice into occ arrays
    table_count: np.ndarray             # [m] int32
    occ_ref: np.ndarray                 # [n_occ] int32 reference id
    occ_pos: np.ndarray                 # [n_occ] int32 k-mer start
    occ_strand: np.ndarray              # [n_occ] uint8 canonical-strand bit
    n_seeds_total: int = 0              # pre-cap minimizer count (telemetry)
    n_seeds_capped: int = 0             # occurrences dropped by occ_cap

    @classmethod
    def build(cls, seqs: Sequence, names: Optional[Sequence[str]] = None, *,
              k: int = 15, w: int = 10,
              occ_cap: int = 64) -> "MinimizerIndex":
        """Index reference sequences (str / bytes / ASCII uint8 arrays)."""
        if not (0 < k <= 31):
            raise ValueError(f"need 0 < k <= 31 (2-bit packed int64): {k}")
        if w < 1 or occ_cap < 1:
            raise ValueError(f"need w >= 1, occ_cap >= 1: w={w}, "
                             f"occ_cap={occ_cap}")
        seqs = [as_ascii(s) for s in seqs]
        names = ([f"ref{i}" for i in range(len(seqs))] if names is None
                 else [str(n) for n in names])
        if len(names) != len(seqs):
            raise ValueError(f"{len(names)} names for {len(seqs)} sequences")
        seeds, refs, poss, strands = [], [], [], []
        for rid, s in enumerate(seqs):
            mm, pos, strand = extract_minimizers(s, k, w)
            seeds.append(mm)
            poss.append(pos)
            strands.append(strand)
            refs.append(np.full(len(mm), rid, np.int32))
        seed = np.concatenate(seeds) if seeds else np.empty(0, np.int64)
        ref = np.concatenate(refs) if refs else np.empty(0, np.int32)
        pos = np.concatenate(poss) if poss else np.empty(0, np.int32)
        strand = (np.concatenate(strands) if strands
                  else np.empty(0, np.uint8))
        n_total = int(seed.size)

        # sort occurrences by (seed, ref, pos) -> contiguous buckets
        order = np.lexsort((pos, ref, seed))
        seed, ref, pos, strand = (seed[order], ref[order], pos[order],
                                  strand[order])
        uniq, start, count = np.unique(seed, return_index=True,
                                       return_counts=True)
        # occurrence cap: repetitive seeds are dropped wholesale — from the
        # occurrence arrays too, or repeat-heavy references would pay the
        # memory the cap exists to save (rows unreachable from the table)
        keep = count <= occ_cap
        n_capped = int(count[~keep].sum())
        rows = np.repeat(keep, count)          # occurrences are seed-sorted
        ref, pos, strand = ref[rows], pos[rows], strand[rows]
        uniq, count = uniq[keep], count[keep]
        start = (np.concatenate([[0], np.cumsum(count)[:-1]])
                 if len(count) else np.empty(0)).astype(np.int64)

        m = _next_pow2(2 * max(len(uniq), 1))
        table_key = np.full(m, _EMPTY, np.int64)
        slots = _probe_insert(table_key, uniq)
        table_start = np.zeros(m, np.int64)
        table_count = np.zeros(m, np.int32)
        table_start[slots] = start
        table_count[slots] = count
        return cls(k=k, w=w, occ_cap=occ_cap, names=names,
                   lengths=np.asarray([len(s) for s in seqs], np.int64),
                   seqs=seqs, table_key=table_key, table_start=table_start,
                   table_count=table_count, occ_ref=ref, occ_pos=pos,
                   occ_strand=strand, n_seeds_total=n_total,
                   n_seeds_capped=n_capped)

    # -- queries -------------------------------------------------------------

    @property
    def n_refs(self) -> int:
        return len(self.names)

    @property
    def n_occurrences(self) -> int:
        return int(self.occ_pos.size)

    def lookup(self, seeds: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Canonical seeds -> (start, count) occurrence slices (count 0 =
        absent or capped)."""
        seeds = np.asarray(seeds, np.int64)
        slots = _probe_lookup(self.table_key, seeds)
        hit = slots >= 0
        start = np.zeros(len(seeds), np.int64)
        count = np.zeros(len(seeds), np.int32)
        start[hit] = self.table_start[slots[hit]]
        count[hit] = self.table_count[slots[hit]]
        return start, count

    def nbytes(self) -> int:
        """Index memory (hash table + occurrences; excludes kept seqs)."""
        return (self.table_key.nbytes + self.table_start.nbytes
                + self.table_count.nbytes + self.occ_ref.nbytes
                + self.occ_pos.nbytes + self.occ_strand.nbytes)

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(self, f, protocol=pickle.HIGHEST_PROTOCOL)

    @classmethod
    def load(cls, path: str) -> "MinimizerIndex":
        with open(path, "rb") as f:
            idx = pickle.load(f)
        if not isinstance(idx, cls):
            raise TypeError(f"{path}: not a pickled MinimizerIndex "
                            f"(got {type(idx).__name__})")
        return idx
