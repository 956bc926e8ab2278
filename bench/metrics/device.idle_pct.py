"""``device.idle_pct``: % of the profiled slice in which the card's own
timeline (``torch.profiler``) shows no kernel, copy or fill."""


def read(run):
    if run.dev is None or run.dev["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.dev["busy_s"] / run.dev["window_s"])
