"""``session.pairs_per_s``: pairs whose result reached the host inside the
window over the window's seconds, as the end-to-end ``pairs_per_s``
counts them, read per layer in the cells where that rate spreads too
widely from run to run to hold a bound (the host's speed moves it)."""


def read(run):
    if not run.seconds:
        return None
    return run.window_pairs / run.seconds
