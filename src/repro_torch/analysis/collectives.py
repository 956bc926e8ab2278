"""Collective bytes on the wire for the roofline, from a trace's records
(the counterpart of the JAX package's ``analysis/hlo.py``, which parses
compiled HLO; the port has no HLO).

A record is one collective as it ran: ``{"kind", "bytes", "group"}``, the
bytes of its result on one rank (for an all-to-all, what that rank hands
it) and the size of its group.  ``launch/lowering.py``'s trace records
every functional collective that DTensor and the model issue on rank 0;
the expert-parallel MoE records its own in ``stats["collectives"]``.  Per
kind, with ``b`` those bytes and ``N`` the group's size:

    all-reduce          2 * b * (N-1)/N        (ring: reduce-scatter+all-gather)
    all-gather          b * (N-1)/N
    reduce-scatter      b * (N-1)              (each rank sends (N-1) shards)
    all-to-all          b * (N-1)/N
    collective-permute  b

Bytes are per participating card on its slowest link, the quantity the
roofline's collective term divides by the link bandwidth.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


def wire_bytes(kind: str, nbytes: float, group: int) -> float:
    """One collective's per-card wire bytes (a group of 1 counts as 2, as
    the JAX package's parser counts it)."""
    N = max(2, int(group))
    kind = kind.replace("_", "-")
    if kind == "all-reduce":
        return 2.0 * nbytes * (N - 1) / N
    if kind in ("all-gather", "all-to-all"):
        return nbytes * (N - 1) / N
    if kind == "reduce-scatter":
        return float(nbytes * (N - 1))
    if kind == "collective-permute":
        return float(nbytes)
    raise ValueError(f"unknown collective kind {kind!r}")


def collective_bytes(records: Iterable[dict]) -> Dict[str, float]:
    """-> {kind: per-card wire bytes} + {"total": ...} (+ "count_<kind>"),
    the dict ``repro.analysis.hlo.collective_bytes`` returns."""
    out: Dict[str, float] = defaultdict(float)
    counts: Dict[str, int] = defaultdict(int)
    for r in records:
        kind = r["kind"].replace("_", "-")
        out[kind] += wire_bytes(kind, r["bytes"], r["group"])
        counts[kind] += 1
    result = dict(out)
    result["total"] = float(sum(out.values()))
    for kind, c in counts.items():
        result[f"count_{kind}"] = c
    return result


def op_histogram(counts: Dict[str, int], top: int = 20) -> Dict[str, int]:
    """The ``top`` most frequent aten ops of a trace (remat / redundancy
    forensics; ``hlo_op_histogram``'s counterpart)."""
    return dict(sorted(counts.items(), key=lambda kv: -kv[1])[:top])
