"""``decode.replay_pct``: % of the window's wall clock that the host spent
inside ``traceback.replay`` spans (``core/cigar.py``: replaying each edit
chain forward and re-deriving its match runs); None where the program has
no such span."""
from harness import spans


def read(run):
    if run.spans is None:
        return None
    s = run.spans
    if not spans.intervals(s["events"], "traceback.replay"):
        return None
    return spans.share_pct(s["events"], "traceback.replay", s["a"], s["b"])
