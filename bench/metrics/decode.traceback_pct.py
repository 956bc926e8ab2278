"""``decode.traceback_pct``: % of the window's wall clock that the host
spent inside ``wave.traceback`` spans (``core/cigar.py`` decoding a
wave's packed trace into CIGARs)."""
from harness import spans


def read(run):
    if run.spans is None:
        return None
    s = run.spans
    return spans.share_pct(s["events"], "wave.traceback", s["a"], s["b"])
