"""``kernel.wfa_trace_ns_per_pair``: as ``kernel.wfa_score_ns_per_pair``,
in the cigar cell, where the kernel is the trace kernel (CUDA events
right around each launch: the zero fill of its trace planes and the
host's launch path are outside them).  None where the program keeps no
such counter."""


def read(run):
    secs = getattr(run.stats, "t_dev_kernel", None)
    if secs is None or not run.stats.n_pairs:
        return None
    return 1e9 * secs / run.stats.n_pairs
