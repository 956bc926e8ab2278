"""``engine.h2d_ns_per_pair.score``: the card's seconds of the copy in
(``SessionStats.t_dev_copy_in``: each wave's CUDA events around its
``non_blocking`` copies, recorded once the host has staged them and
allocated their device buffers) over the pairs the run's session was
handed, in ns a pair; None where the program keeps no such counter."""


def read(run):
    secs = getattr(run.stats, "t_dev_copy_in", None)
    if secs is None or not run.stats.n_pairs:
        return None
    return 1e9 * secs / run.stats.n_pairs
