"""``session.scatter_pct``: % of the window's wall clock that the host
spent inside the session's ``wave.scatter`` spans (``core/session.py``:
packing a wave, its copy in and its launch)."""
from harness import spans


def read(run):
    if run.spans is None:
        return None
    s = run.spans
    return spans.share_pct(s["events"], "wave.scatter", s["a"], s["b"])
