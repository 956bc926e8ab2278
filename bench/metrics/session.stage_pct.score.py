"""``session.stage_pct.score``: % of the window's wall clock that the host
spent inside ``scatter.stage`` spans (``core/session.py``: copying a
wave's packed arrays into pinned host memory before the copy in), in the
score cells; None where the program has no such span."""
from harness import spans


def read(run):
    if run.spans is None:
        return None
    s = run.spans
    if not spans.intervals(s["events"], "scatter.stage"):
        return None
    return spans.share_pct(s["events"], "scatter.stage", s["a"], s["b"])
