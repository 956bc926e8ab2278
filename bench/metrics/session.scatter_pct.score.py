"""``session.scatter_pct.score``: ``session.scatter_pct`` (the share of the
window inside ``wave.scatter`` spans) in the score cells, which report
another end-to-end metric than the cells ``session.scatter_pct`` lists."""
from harness import spans


def read(run):
    if run.spans is None:
        return None
    s = run.spans
    return spans.share_pct(s["events"], "wave.scatter", s["a"], s["b"])
