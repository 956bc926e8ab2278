"""Plain ring reference for the WFA kernel.

Delegates to ``core.wavefront.wfa_scores`` — the rolling-window, score-only
formulation the kernel implements, in plain tensor code.  Scores are
integers, so tests assert exact equality.
"""
from __future__ import annotations

from repro_torch.core.wavefront import wfa_scores


def ref_scores(pattern, text, plen, tlen, *, pen, s_max: int, k_max: int,
               heur=None, band_cap=None, device=None):
    """[B] int32 alignment costs (-1 where > s_max) on ``device``."""
    return wfa_scores(pattern, text, plen, tlen, pen=pen, s_max=s_max,
                      k_max=k_max, heur=heur, band_cap=band_cap,
                      device=device).score
