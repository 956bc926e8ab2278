"""Wrappers around the WFA kernels: padding, blocking, unpadding.

``wfa_align`` / ``wfa_align_trace`` drive the WFA kernel (scores, packed
trace); ``wfa_align_cigar`` runs the trace kernel and, behind it on the
card, the traceback kernel that decodes its planes into CIGAR ops;
``wfa_bidir_meet_kernel`` drives the BiWFA meet kernel and also hands it the
per-row reversed sequences, reversed on the device.

The padding contract of the JAX package's ``kernels/wfa/ops.py``: the pair
axis pads to a multiple of ``block_pairs`` with padded pairs of
``plen = tlen = 0`` (they resolve at ``s = 0``), and the diagonal axis is
``k_pad = round_up(2 * k_max + 1, 128)`` lanes, so the packed trace words
have the reference's ``[n_words, B, k_pad]`` layout bit for bit.  Sequence
columns are not padded: the CUDA kernel reads each row only up to its
length.

The inputs (numpy arrays or tensors) go to ``device``: ``None`` means the
card (``"cuda"``), which must exist, and ``"cpu"`` runs the kernel's plain
version.  The engine's backends pass the device of their tensors.

Knobs threaded from ``AlignmentEngine(backend_opts=...)``:

* ``block_pairs`` — pairs per CUDA block (``None``: 8);
* ``gather``, ``ext_stride`` — accepted and ignored: the first selects how
  a TPU fetches characters (it has no per-lane gather), the second only
  changed speed there;
* ``band_cap`` — the compacting band's width, rounded up to 128 lanes as
  the JAX package does (:func:`_band_lanes`); ``None``, or a width that
  reaches ``k_pad``, runs full width.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import scoring
from repro_torch.core.wavefront import BidirMeetResult, _reverse_rows
from repro_torch.device import resolve_device
from repro_torch.kernels.wfa.kernel import (wfa_kernel, wfa_meet_kernel,
                                           wfa_traceback_cuda)

LANE = 128
DEFAULT_BLOCK_PAIRS = 8


def _round_up(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


def resolve_block_pairs(block_pairs: Optional[int]) -> int:
    if block_pairs is None:
        return DEFAULT_BLOCK_PAIRS
    bp = int(block_pairs)
    if bp < 1:
        raise ValueError(f"block_pairs must be >= 1, got {block_pairs}")
    return bp


def _band_lanes(band_cap, k_pad: int) -> Optional[int]:
    """Lane-aligned compact ring width, or None for full width."""
    if band_cap is None:
        return None
    kc = _round_up(max(int(band_cap), 1), LANE)
    return kc if kc < k_pad else None


def _prep(pattern, text, plen, tlen, block_pairs, device=None):
    dev = resolve_device(device)
    i32 = lambda a: torch.as_tensor(a, device=dev).to(torch.int32)
    pattern, text = i32(pattern), i32(text)
    plen, tlen = i32(plen).reshape(-1, 1), i32(tlen).reshape(-1, 1)
    B = pattern.shape[0]
    pad = _round_up(max(B, 1), block_pairs) - B
    rows = lambda t: torch.nn.functional.pad(t, (0, 0, 0, pad))
    return rows(pattern), rows(text), rows(plen), rows(tlen), B


def _run(pattern, text, plen, tlen, *, pen, s_max, k_max, block_pairs, heur,
         band_cap, trace, device, decode=False):
    bp = resolve_block_pairs(block_pairs)
    pattern, text, plen2, tlen2, B = _prep(pattern, text, plen, tlen, bp,
                                           device)
    k_pad = _round_up(2 * int(k_max) + 1, LANE)
    out = wfa_kernel(pattern, text, plen2, tlen2, pen=pen, s_max=int(s_max),
                     k_pad=k_pad, block_pairs=bp, trace=trace,
                     heur=scoring.as_heuristic(heur),
                     band_cap=_band_lanes(band_cap, k_pad))
    if decode:
        held = sum(t.nbytes for t in out[2:])
        out = (out[0],) + wfa_traceback_cuda(out[0], out[2:], pattern, text,
                                             plen2, tlen2, pen=pen,
                                             s_max=int(s_max)) + (held,)
    return B, out


def wfa_align(pattern, text, plen, tlen, *, pen, s_max: int, k_max: int,
              block_pairs: Optional[int] = None, heur=None,
              gather: Optional[str] = None, ext_stride: int = 1,
              band_cap: Optional[int] = None, device=None):
    """Batched WFA scores via the kernel -> [B] int32 costs (-1 where the
    optimal cost exceeds ``s_max``) on ``device``."""
    B, (score, _) = _run(pattern, text, plen, tlen, pen=pen, s_max=s_max,
                         k_max=k_max, block_pairs=block_pairs, heur=heur,
                         band_cap=band_cap, trace=False, device=device)
    return score[:B, 0]


def wfa_align_trace(pattern, text, plen, tlen, *, pen, s_max: int,
                    k_max: int, block_pairs: Optional[int] = None,
                    heur=None, gather: Optional[str] = None,
                    ext_stride: int = 1, band_cap: Optional[int] = None,
                    device=None):
    """Batched WFA scores *plus* the packed backtrace via the kernel
    -> ``(score [B], m_bt, i_bt, d_bt)`` with ``[n_words, B, k_pad]`` int32
    words (diagonal centre ``k_pad // 2``) on ``device``; linear models
    return ``i_bt = d_bt = None``."""
    B, out = _run(pattern, text, plen, tlen, pen=pen, s_max=s_max,
                  k_max=k_max, block_pairs=block_pairs, heur=heur,
                  band_cap=band_cap, trace=True, device=device)
    score, _, *bts = out
    bts = [bt[:, :B, :] for bt in bts] + [None, None]
    return (score[:B, 0], *bts[:3])


def wfa_align_cigar(pattern, text, plen, tlen, *, pen, s_max: int,
                    k_max: int, block_pairs: Optional[int] = None,
                    heur=None, band_cap: Optional[int] = None, device=None):
    """Batched WFA scores *plus* each pair's CIGAR ops, decoded on the card
    -> ``(score [B], ops [B, L] int8, n_ops [B], status [B, 4],
    plane_nbytes)`` on ``device``, which must be a card: the trace kernel's
    planes go straight to the traceback kernel (:func:`~repro_torch.kernels.
    wfa.kernel.wfa_traceback_cuda`, which says what the outputs hold) and
    never leave the card; ``plane_nbytes`` is what they held there."""
    B, (score, ops, n_ops, status, held) = _run(
        pattern, text, plen, tlen, pen=pen, s_max=s_max, k_max=k_max,
        block_pairs=block_pairs, heur=heur, band_cap=band_cap, trace=True,
        device=device, decode=True)
    return score[:B, 0], ops[:B], n_ops[:B, 0], status[:B], held


def wfa_bidir_meet_kernel(pattern, text, plen, tlen, starget, *, pen,
                          s_max: int, k_max: int, heur=None,
                          begin_state: str = "M", end_state: str = "M",
                          block_pairs: Optional[int] = None, device=None):
    """BiWFA meet search via the meet kernel: the signature and
    ``BidirMeetResult`` of ``core.wavefront.wfa_bidir_meet``, selected by
    the ``kernel`` backend for the BiWFA driver's meet waves.  Each block of
    ``block_pairs`` exits as soon as its own pairs have met; ``n_steps`` is
    the largest block's exit step, a 0-d tensor on ``device``."""
    bp = resolve_block_pairs(block_pairs)
    pattern2, text2, plen2, tlen2, B = _prep(pattern, text, plen, tlen, bp,
                                             device)
    st = torch.as_tensor(starget, device=pattern2.device).to(
        torch.int32).reshape(-1, 1)
    starget2 = torch.nn.functional.pad(st, (0, 0, 0,
                                            pattern2.shape[0] - B))
    (score, steps, state, a, b, k, h,
     safe) = wfa_meet_kernel(
        pattern2, text2, _reverse_rows(pattern2, plen2[:, 0]),
        _reverse_rows(text2, tlen2[:, 0]), plen2, tlen2, starget2, pen=pen,
        s_max=int(s_max), k_pad=_round_up(2 * int(k_max) + 1, LANE),
        block_pairs=bp, heur=scoring.as_heuristic(heur),
        begin_state=begin_state, end_state=end_state)
    return BidirMeetResult(score[:B, 0], steps.max(), state[:B, 0],
                           a[:B, 0], b[:B, 0], k[:B, 0], h[:B, 0],
                           safe[:B, 0])
