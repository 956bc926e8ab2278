"""SAM formatting — the one header/record writer the launchers share.

Produces spec-shaped SAM (v1.6): an ``@HD``/``@SQ``/``@PG`` header built
from the reference set, and 11-column records with

* ``FLAG``  — 0x4 unmapped, 0x10 reverse strand, 0x100 secondary;
* ``POS``   — 1-based leftmost reference position (the mapper's 0-based
  ``pos`` + 1);
* ``MAPQ``  — the mapper's best-vs-second-best gap (see
  :mod:`repro_torch.mapping.extend`), 0 on secondaries/unmapped;
* ``CIGAR`` — classic ``M``/``I``/``D`` by default (what downstream tools
  expect) or SAM-1.4 ``=``/``X`` with ``mode="extended"``, straight from
  the packed-backtrace pipeline's op arrays;
* ``SEQ``   — the read on the *forward reference* orientation (reverse-
  strand mappings store the reverse complement, per the SAM spec);
* tags — ``AS:i`` (negated alignment cost: higher is better), ``NM:i``
  (edit distance: X/I/D op count) and ``cm:i`` (chain score) on mapped
  records.

No pysam anywhere — records are plain tab-joined lines, and the tests
parse them back with the same split discipline.
"""
from __future__ import annotations

from typing import IO, Iterable, List, Optional, Sequence

import numpy as np

from repro_torch.core import cigar as cigar_mod
from repro_torch.data.dna import as_ascii, revcomp

__all__ = ["header_lines", "mapping_record", "unmapped_record", "write_sam"]

FLAG_UNMAPPED = 0x4
FLAG_REVERSE = 0x10
FLAG_SECONDARY = 0x100


def header_lines(names: Sequence[str], lengths: Sequence[int], *,
                 program: str = "repro", version: str = "0.1",
                 cl: Optional[str] = None) -> List[str]:
    """@HD/@SQ/@PG header for a reference set (one @SQ per reference)."""
    out = ["@HD\tVN:1.6\tSO:unknown"]
    for name, ln in zip(names, lengths):
        out.append(f"@SQ\tSN:{name}\tLN:{int(ln)}")
    pg = f"@PG\tID:{program}\tPN:{program}\tVN:{version}"
    if cl:
        pg += f"\tCL:{cl}"
    out.append(pg)
    return out


def _seq_str(read) -> str:
    return as_ascii(read).tobytes().decode("ascii")


def unmapped_record(name: str, read) -> str:
    """FLAG-4 record: no position, no CIGAR, no alignment score."""
    seq = _seq_str(read)
    return "\t".join([name, str(FLAG_UNMAPPED), "*", "0", "0", "*", "*",
                      "0", "0", seq or "*", "*"])


def mapping_record(mapping, read, name: str, ref_name: str, *,
                   mode: str = "classic") -> str:
    """One mapped SAM record from a
    :class:`~repro_torch.mapping.extend.Mapping`.

    ``read`` is the read as sequenced (the mapper's input orientation);
    reverse-strand records store its reverse complement so SEQ is always
    on the forward reference strand.
    """
    if not mapping.mapped:
        return unmapped_record(name, read)
    flag = ((FLAG_REVERSE if mapping.strand else 0)
            | (FLAG_SECONDARY if mapping.secondary else 0))
    seq = as_ascii(read)
    if mapping.strand:
        seq = revcomp(seq)
    ops = mapping.ops
    nm = int(np.isin(ops, (cigar_mod.OP_X, cigar_mod.OP_I,
                           cigar_mod.OP_D)).sum())
    fields = [name, str(flag), ref_name, str(int(mapping.pos) + 1),
              str(int(mapping.mapq)), cigar_mod.cigar_string(ops, mode),
              "*", "0", "0", _seq_str(seq) or "*", "*",
              f"AS:i:{-int(mapping.score)}", f"NM:i:{nm}",
              f"cm:i:{int(mapping.chain_score)}"]
    return "\t".join(fields)


def write_sam(out: IO[str], mappings_per_read: Iterable[Sequence],
              reads: Sequence, read_names: Sequence[str],
              ref_names: Sequence[str], ref_lengths: Sequence[int], *,
              mode: str = "classic", cl: Optional[str] = None) -> int:
    """Write a full SAM stream -> number of alignment records written.

    ``mappings_per_read`` yields per-read ``[primary, *secondaries]``
    lists (any order — records are written as they arrive, matching the
    out-of-order retirement of :meth:`ReadMapper.map_stream`).
    """
    for line in header_lines(ref_names, ref_lengths, cl=cl):
        out.write(line + "\n")
    n = 0
    for maps in mappings_per_read:
        for m in maps:
            rid = m.read_id
            name = str(read_names[rid])
            if m.mapped:
                line = mapping_record(m, reads[rid], name,
                                      ref_names[m.ref_id], mode=mode)
            else:
                line = unmapped_record(name, reads[rid])
            out.write(line + "\n")
            n += 1
    return n
