"""DNA alphabet helpers — reverse complement, 2-bit packing, N handling.

The mapping subsystem (``repro.mapping``) works on nucleotides, not on the
engine's opaque integer codes: minimizer seeding needs 2-bit packed k-mers
and strand canonicalization needs reverse complements.  These helpers are
the single home for that alphabet logic, shared by the index, the chainers
and the synthetic ground-truth read sampler.

Conventions:

* Sequences travel as ASCII uint8 arrays (what ``data.io`` parses and
  ``core.engine.encode`` produces for strings); ``str`` in, ``str`` out.
* 2-bit codes: A=0, C=1, G=2, T=3 (case-insensitive).  Any other byte —
  N and the rest of the IUPAC ambiguity codes — maps to :data:`NCODE`
  (4), a sentinel outside the 2-bit range.  A k-mer window containing a
  sentinel can never become a minimizer (the index masks it), so N runs
  simply produce no seeds instead of seeding false matches.
* Reverse complement keeps ambiguity: A<->T, C<->G (either case; output
  upper), everything else becomes ``N`` — never a silent A.
"""
from __future__ import annotations

from typing import Union

import numpy as np

__all__ = ["NCODE", "as_ascii", "encode_2bit", "decode_2bit", "revcomp",
           "comp_2bit", "random_reference"]

NCODE = 4          # sentinel 2-bit code for N / ambiguity bytes

# ASCII byte -> 2-bit code (everything unmapped -> NCODE).
_TO_2BIT = np.full(256, NCODE, np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _TO_2BIT[_b] = _i
    _TO_2BIT[_b + 32] = _i          # lowercase

_FROM_2BIT = np.frombuffer(b"ACGTN", dtype=np.uint8)

# ASCII byte -> complement ASCII byte (unmapped -> 'N').
_COMP = np.full(256, ord("N"), np.uint8)
for _a, _b in zip(b"ACGTacgt", b"TGCATGCA"):
    _COMP[_a] = _b


def as_ascii(seq: Union[str, bytes, np.ndarray]) -> np.ndarray:
    """Normalize str / bytes / integer arrays to an ASCII uint8 array."""
    if isinstance(seq, str):
        return np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    if isinstance(seq, bytes):
        return np.frombuffer(seq, dtype=np.uint8)
    return np.asarray(seq).astype(np.uint8)


def encode_2bit(seq: Union[str, bytes, np.ndarray]) -> np.ndarray:
    """ASCII/str sequence -> [L] uint8 2-bit codes (N etc. -> NCODE)."""
    return _TO_2BIT[as_ascii(seq)]


def decode_2bit(codes: np.ndarray, as_str: bool = True):
    """[L] 2-bit codes -> sequence string (or ASCII array).

    Codes outside {0..3} decode to ``N`` — decode(encode(s)) round-trips
    exactly for upper-case ACGTN sequences.
    """
    codes = np.asarray(codes)
    out = _FROM_2BIT[np.minimum(codes, NCODE)]
    return out.tobytes().decode("ascii") if as_str else out


def comp_2bit(codes: np.ndarray) -> np.ndarray:
    """Complement 2-bit codes (3 - c); the NCODE sentinel stays NCODE."""
    codes = np.asarray(codes)
    return np.where(codes >= NCODE, codes, 3 - codes).astype(codes.dtype)


def revcomp(seq: Union[str, bytes, np.ndarray]):
    """Reverse complement.  str -> str; array/bytes -> ASCII uint8 array."""
    arr = _COMP[as_ascii(seq)][::-1].copy()
    return arr.tobytes().decode("ascii") if isinstance(seq, str) else arr


def random_reference(length: int, seed: int = 0) -> np.ndarray:
    """Uniform-random ACGT reference as an ASCII uint8 array.

    Deterministic per seed — the synthetic genome under the mapping
    ground-truth sampler (``data.reads.sample_from_reference``) and the
    mapping benchmark.
    """
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    return bases[rng.integers(0, 4, size=int(length))]
