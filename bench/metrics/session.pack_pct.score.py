"""``session.pack_pct.score``: % of the window's wall clock that the host
spent inside ``scatter.pack`` spans (``core/session.py``: gathering a
wave's rows, fitting them to the bucket's width and padding the rows),
in the score cells; None where the program has no such span."""
from harness import spans


def read(run):
    if run.spans is None:
        return None
    s = run.spans
    if not spans.intervals(s["events"], "scatter.pack"):
        return None
    return spans.share_pct(s["events"], "scatter.pack", s["a"], s["b"])
