"""``kernel.wfa_score_ns_per_pair``: the card's seconds of the score
kernel (``SessionStats.t_dev_kernel``: CUDA events each launch records on
its stream right before and right after the kernel) over the pairs the
run's session was handed, in ns a pair, in the score cells; None where
the program keeps no such counter."""


def read(run):
    secs = getattr(run.stats, "t_dev_kernel", None)
    if secs is None or not run.stats.n_pairs:
        return None
    return 1e9 * secs / run.stats.n_pairs
