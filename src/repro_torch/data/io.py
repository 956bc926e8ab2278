"""FASTA / FASTQ read-pair input — real read files for the aligner.

The synthetic generator (``data.reads``) reproduces the paper's workload;
this module feeds the same pipeline from real sequence files so
``launch/align.py --reads/--refs`` aligns actual data.  Plain and
gzip-compressed files are both accepted (sniffed by magic bytes, so a
``.fastq`` that is secretly gzipped still opens); the format is sniffed
from the first record character (``>`` FASTA, ``@`` FASTQ), not the file
extension.

Parsing is deliberately minimal and strict about *structure* (record
markers, FASTQ 4-line groups, +-line separator) but permissive about
*content* (any ASCII sequence alphabet; the aligner compares integer
codes, so IUPAC ambiguity codes and lowercase just work).  Sequences come
back as raw ASCII-uint8 arrays, the exact dtype ``core.engine.encode``
produces for strings.
"""
from __future__ import annotations

import gzip
import io
import itertools
from typing import IO, Iterator, List, Tuple

import numpy as np

__all__ = ["read_seqs", "iter_seqs", "load_pair_files"]

_GZIP_MAGIC = b"\x1f\x8b"


def _open_text(path: str) -> IO[str]:
    """Open ``path`` as text, transparently gunzipping (magic-byte sniff)."""
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == _GZIP_MAGIC:
        return io.TextIOWrapper(gzip.open(path, "rb"), encoding="ascii")
    return open(path, "r", encoding="ascii")


def iter_seqs(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Yield ``(name, sequence)`` records from a FASTA or FASTQ file.

    ``sequence`` is a 1-D uint8 array of ASCII codes (what
    ``core.engine.encode`` produces for a str).  FASTA sequences may span
    multiple lines; FASTQ records must be the standard 4-line form
    (quality lines are skipped — alignment does not use them).
    """
    with _open_text(path) as f:
        first = f.read(1)
        if first == "":
            return
        if first == ">":
            yield from _iter_fasta(f)
        elif first == "@":
            yield from _iter_fastq(f)
        else:
            raise ValueError(
                f"{path}: not FASTA or FASTQ (first record starts with "
                f"{first!r}, expected '>' or '@')")


def _encode(parts: List[str]) -> np.ndarray:
    seq = "".join(parts)
    return np.frombuffer(seq.encode("ascii"), dtype=np.uint8)


def _name_of(header: str) -> str:
    fields = header.strip().split()
    return fields[0] if fields else ""


def _iter_fasta(f: IO[str]) -> Iterator[Tuple[str, np.ndarray]]:
    # caller consumed the leading '>' of the first header
    name = _name_of(f.readline())
    parts: List[str] = []
    for line in f:
        line = line.strip()
        if not line:
            continue
        if line.startswith(">"):
            yield name, _encode(parts)
            name = _name_of(line[1:])
            parts = []
        else:
            parts.append(line)
    yield name, _encode(parts)


def _iter_fastq(f: IO[str]) -> Iterator[Tuple[str, np.ndarray]]:
    # caller consumed the leading '@' of the first header
    header = f.readline().strip()
    while True:
        seq = f.readline()
        plus = f.readline()
        qual = f.readline()
        if not qual:
            raise ValueError("truncated FASTQ record "
                             f"(header {_name_of(header)!r})")
        if not plus.startswith("+"):
            raise ValueError("malformed FASTQ record: expected '+' line, got "
                             f"{plus.strip()!r}")
        yield _name_of(header), _encode([seq.strip()])
        nxt = f.readline()
        if not nxt:
            return
        if not nxt.startswith("@"):
            raise ValueError("malformed FASTQ record: expected '@' header, "
                             f"got {nxt.strip()!r}")
        header = nxt[1:].strip()


def read_seqs(path: str) -> Tuple[List[str], List[np.ndarray]]:
    """Read a whole FASTA/FASTQ(.gz) file -> (names, uint8 sequences)."""
    names: List[str] = []
    seqs: List[np.ndarray] = []
    for name, seq in iter_seqs(path):
        names.append(name)
        seqs.append(seq)
    return names, seqs


def load_pair_files(reads_path: str, refs_path: str,
                    limit: int = 0) -> Tuple[np.ndarray, np.ndarray,
                                             np.ndarray, np.ndarray]:
    """Load two FASTA/FASTQ(.gz) files as aligner-ready packed pairs.

    Record *i* of ``refs_path`` is the pattern aligned against record *i*
    of ``reads_path`` (the text), matching the synthetic generator's
    (reference, mate) convention.  ``limit`` caps the pair count (0 =
    all) and is applied while streaming, so only the first ``limit``
    records of each file are ever parsed or held in memory.
    -> ``(patterns [N, Lp], plens [N], texts [N, Lt], tlens [N])`` int32,
    zero-padded exactly like ``data.reads.generate_pairs``.
    """
    stop = limit if limit else None
    refs = [s for _, s in itertools.islice(iter_seqs(refs_path), stop)]
    reads = [s for _, s in itertools.islice(iter_seqs(reads_path), stop)]
    if len(refs) != len(reads):
        raise ValueError(
            f"pair files disagree: {len(refs)} records in {refs_path} vs "
            f"{len(reads)} in {reads_path}"
            + (f" (within the first {limit} records)" if limit else ""))
    if not refs:
        raise ValueError(f"no records in {refs_path}")
    Lp = max(len(p) for p in refs)
    Lt = max(len(t) for t in reads)
    n = len(refs)
    P = np.zeros((n, max(Lp, 1)), np.int32)
    T = np.zeros((n, max(Lt, 1)), np.int32)
    plen = np.empty((n,), np.int32)
    tlen = np.empty((n,), np.int32)
    for i, (p, t) in enumerate(zip(refs, reads)):
        P[i, : len(p)] = p
        T[i, : len(t)] = t
        plen[i] = len(p)
        tlen[i] = len(t)
    return P, plen, T, tlen
