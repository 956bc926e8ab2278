"""``decode.walk_pct``: % of the window's wall clock that the host spent
inside ``traceback.walk`` spans (``core/cigar.py``: walking every pair's
packed provenance codes back to the origin, the edit chains); None where
the program has no such span."""
from harness import spans


def read(run):
    if run.spans is None:
        return None
    s = run.spans
    if not spans.intervals(s["events"], "traceback.walk"):
        return None
    return spans.share_pct(s["events"], "traceback.walk", s["a"], s["b"])
