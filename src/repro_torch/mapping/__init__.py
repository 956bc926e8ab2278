"""Read mapping on the port: minimizer index -> chain -> WFA extension ->
SAM.

The seed-chain-extend pipeline around the engine, the counterpart of
``repro.mapping``:

* :mod:`repro_torch.mapping.index`  — :class:`MinimizerIndex`: 2-bit
  packed, strand-canonical minimizer seeds in an open-addressed hash table
  (numpy, on the host).
* :mod:`repro_torch.mapping.chain`  — per-read candidate generation +
  colinear anchor chaining (numpy, on the host).
* :mod:`repro_torch.mapping.extend` — :class:`ReadMapper`: every candidate
  window is one pair through ``AlignmentEngine.stream()`` in CIGAR mode,
  so on the card each extension wave runs the CUDA trace kernel.
* :mod:`repro_torch.mapping.sam`    — SAM header/record formatting (the
  writer ``launch/align.py`` and ``launch/map_reads.py`` share).
"""
from repro_torch.mapping.chain import (Anchor, Chain, chain_anchors,
                                       read_anchors)
from repro_torch.mapping.extend import Mapping, ReadMapper
from repro_torch.mapping.index import MinimizerIndex
from repro_torch.mapping.sam import header_lines, mapping_record, write_sam

__all__ = ["Anchor", "Chain", "Mapping", "MinimizerIndex", "ReadMapper",
           "chain_anchors", "header_lines", "mapping_record", "read_anchors",
           "write_sam"]
