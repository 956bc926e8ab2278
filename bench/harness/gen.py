"""The traffic generator: seeded read-pair pools, vectorised.

The edit model is a frozen copy of ``generate_pairs`` in
``src/repro_torch/data/reads.py`` at commit fd8e385e27c5 (the file last
changed in 4d2b02af10f5): a reference read drawn uniformly over ACGT, its
mate mutated with at most ``ceil(E * L)`` edits, each a substitution
(``sub``, to one of the three other bases), a 1-base insertion (``ins``,
before the base) or a 1-base deletion (``del``), codes the ASCII bytes
``ACGT`` as int32, both sides padded with 0 to the pool's longest.

Two departures, both so that one run's set-up stays short and every seed
brings the same amount of work:

* the edits are drawn for all pairs at once with numpy, at distinct
  positions of the reference read (two draws that hit one position keep
  the first), where the original applies them one by one to the mutated
  sequence in a Python loop;
* the edit counts are the same multiset in every block of ``block``
  pairs (a chunk of the traffic) and for every seed: ``0 .. ceil(E * L)``
  spread evenly over the block, shuffled within it by the seed (the
  original draws each uniformly), so every chunk brings about the same
  work, whatever the seed.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8).astype(np.int32)


def max_edits(read_len: int, edit_frac: float) -> int:
    return int(math.ceil(edit_frac * read_len))


def generate_pool(n_pairs: int, read_len: int, edit_frac: float,
                  mix: Dict[str, float], seed: int, block: int = 0
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                             np.ndarray]:
    """-> (patterns [N, L], plen [N], texts [N, Lt], tlen [N], n_edits [N]),
    int32; ``mix`` gives the shares of ``sub``, ``ins`` and ``del``;
    ``block`` (0: the whole pool) must divide ``n_pairs``."""
    shares = np.array([mix["sub"], mix["ins"], mix["del"]], np.float64)
    if n_pairs < 1 or read_len < 1 or np.any(shares < 0) \
            or not math.isclose(shares.sum(), 1.0):
        raise ValueError(f"bad traffic: {n_pairs} pairs of {read_len}, "
                         f"mix {mix}")
    rng = np.random.default_rng(seed)
    N, L = int(n_pairs), int(read_len)
    ref = rng.integers(0, 4, size=(N, L), dtype=np.int8)
    n_err = max_edits(L, edit_frac)
    block = int(block) or N
    if N % block:
        raise ValueError(f"a block of {block} does not divide {N} pairs")
    even = ((np.arange(block) + 0.5) * (n_err + 1) / block).astype(np.int64)
    n_edits = rng.permuted(np.tile(even, (N // block, 1)), axis=1).reshape(-1)
    # one draw per edit: its pair, position, kind, and the base it brings
    pair = np.repeat(np.arange(N, dtype=np.int64), n_edits)
    pos = rng.integers(0, L, size=pair.size)
    kind = np.searchsorted(np.cumsum(shares), rng.random(pair.size),
                           side="right").clip(0, 2).astype(np.int8)
    shift = rng.integers(1, 4, size=pair.size, dtype=np.int8)
    new_base = rng.integers(0, 4, size=pair.size, dtype=np.int8)
    flat = pair * L + pos
    flat, first = np.unique(flat, return_index=True)
    kind, shift, new_base = kind[first], shift[first], new_base[first]
    n_kept = np.bincount(pair[first], minlength=N)

    # the mate, all pairs end to end: substitutions in place, deletions
    # out, each insertion before its base
    mate = ref.reshape(-1).copy()
    sub, ins, dele = (flat[kind == k] for k in (0, 1, 2))
    mate[sub] = (mate[sub] + shift[kind == 0]) % 4
    mate = np.delete(mate, dele)
    mate = np.insert(mate, ins - np.searchsorted(dele, ins),
                     new_base[kind == 1])
    row = flat // L
    tlen = (L + np.bincount(row[kind == 1], minlength=N)
            - np.bincount(row[kind == 2], minlength=N))
    Lt = int(tlen.max())
    T8 = np.full((N, Lt), 4, np.int8)          # 4: padding
    T8[np.arange(Lt)[None, :] < tlen[:, None]] = mate
    lut = np.append(BASES, 0).astype(np.int32)
    T = lut[T8]
    P = lut[ref]
    plen = np.full(N, L, np.int32)
    return P, plen, T, tlen.astype(np.int32), n_kept.astype(np.int32)
