"""``wfa_trace_roofline``: as ``wfa_score_roofline``, for the full-width
trace kernel (``wfa_full_kernel<.., true, ..>``), whose bytes add the
CIGAR at 2 bits an operation."""
from harness import align_loop


def read(run):
    return align_loop.kernel_roofline(run, "trace")
