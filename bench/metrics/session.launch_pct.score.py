"""``session.launch_pct.score``: % of the window's wall clock that the host
spent inside ``scatter.launch`` spans (``core/session.py``: enqueueing a
wave's copies, the kernel's launch and the copy out), in the score cells;
None where the program has no such span."""
from harness import spans


def read(run):
    if run.spans is None:
        return None
    s = run.spans
    if not spans.intervals(s["events"], "scatter.launch"):
        return None
    return spans.share_pct(s["events"], "scatter.launch", s["a"], s["b"])
