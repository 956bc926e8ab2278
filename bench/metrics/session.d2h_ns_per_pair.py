"""``session.d2h_ns_per_pair``: the card's seconds of the copy out
(``SessionStats.t_dev_copy_out``: CUDA events around each wave's copies
of its score and trace words into pinned host memory) over the pairs the
run's session was handed, in ns a pair; None where the program keeps no
such counter."""


def read(run):
    secs = getattr(run.stats, "t_dev_copy_out", None)
    if secs is None or not run.stats.n_pairs:
        return None
    return 1e9 * secs / run.stats.n_pairs
