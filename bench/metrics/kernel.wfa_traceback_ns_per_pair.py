"""``kernel.wfa_traceback_ns_per_pair``: the card's seconds of the
traceback kernel (``SessionStats.t_dev_traceback``: CUDA events the launch
records right around it, ``csrc/wfa_traceback.cu``) over the pairs the
run's session was handed, in ns a pair.  None where the program keeps no
such counter or decoded no pair on the card."""


def read(run):
    secs = getattr(run.stats, "t_dev_traceback", None)
    if (secs is None or not getattr(run.stats, "n_tb_card", 0)
            or not run.stats.n_pairs):
        return None
    return 1e9 * secs / run.stats.n_pairs
