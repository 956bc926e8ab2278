"""``biwfa.stitch_pct``: % of the window's wall clock that the host spent
inside ``bidir.stitch`` spans (``biwfa/recurse.py`` joining the leaves'
CIGARs and re-scoring each finished pair)."""
from harness import spans


def read(run):
    if run.spans is None:
        return None
    s = run.spans
    return spans.share_pct(s["events"], "bidir.stitch", s["a"], s["b"])
