"""``wfa_score_roofline``: % of its roofline that the full-width score
kernel (``kernels/wfa/csrc/wfa.cu``, ``wfa_full_kernel<.., false, ..>``)
reached on the profiled slice's launches of judged chunks, timed by the
profiler; the work is ``harness/work.py``'s, from the inputs and the
reference's scores."""
from harness import align_loop


def read(run):
    return align_loop.kernel_roofline(run, "score")
