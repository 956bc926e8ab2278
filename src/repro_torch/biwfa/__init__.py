"""Bidirectional WFA (BiWFA) traceback — exact CIGARs in O(s) trace memory.

The packed 2-bit backtrace stores O(s^2 / 16) provenance words per pair,
which is fine for short reads but blows past any trace budget on noisy
long reads (ONT/PacBio: L >= 10 kb, s in the thousands).  This package
implements the meet-in-the-middle alternative (Marco-Sola et al.'s BiWFA,
BIMSA's distance-based PIM variant): run a forward and a reverse wavefront
toward each other keeping only O(s)-deep rolling windows, find the
breakpoint where they join, and recurse on the two halves until each
sub-problem is small enough for the packed traceback.

Selected per call / per submit via ``trace_variant="bidir"`` (the same
seam as ``output=`` / ``penalties=`` / ``heuristic=``)::

    eng = AlignmentEngine(backend="kernel")
    res = eng.align(ps, ts, output="cigar", trace_variant="bidir")

The host-side recursion lives in :mod:`repro_torch.biwfa.recurse`; the
batched breakpoint solver is the ``kernel`` backend's CUDA meet kernel
(``repro_torch.kernels.wfa``) or, on other backends,
:func:`repro_torch.core.wavefront.wfa_bidir_meet`.
"""
from repro_torch.biwfa.recurse import BidirDriver, DEFAULT_TRACE_BUDGET

__all__ = ["BidirDriver", "DEFAULT_TRACE_BUDGET"]
