"""``device.idle_pct.score``: ``device.idle_pct`` (the share of the
profiled slice in which the card's timeline shows nothing running) in the
score cells, which report another end-to-end metric than the cells
``device.idle_pct`` lists."""


def read(run):
    if run.dev is None or run.dev["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.dev["busy_s"] / run.dev["window_s"])
