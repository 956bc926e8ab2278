"""Host spans of the program's tracer (``repro_torch.obs.trace``): the
share of a window that the host spent inside spans of one name."""
from __future__ import annotations

from typing import List, Tuple


def intervals(events: List[dict], name: str) -> List[Tuple[float, float]]:
    return [(float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0.0)))
            for ev in events if ev.get("ph") == "X" and ev["name"] == name]


def covered(iv: List[Tuple[float, float]], a: float, b: float) -> float:
    """Length of the union of ``iv`` inside [a, b]."""
    total, end = 0.0, a
    for s, e in sorted(iv):
        s, e = max(s, end), min(e, b)
        if e > s:
            total += e - s
            end = e
    return total


def share_pct(events: List[dict], name: str, a: float, b: float) -> float:
    """% of [a, b] inside spans named ``name`` (nested ones counted once)."""
    return 100.0 * covered(intervals(events, name), a, b) / (b - a)
