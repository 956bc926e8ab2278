"""Wrapper around the WFA kernel: padding, blocking, unpadding.

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
* ``band_cap`` — the compacting band is not ported yet; anything but
  ``None`` raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import scoring
from repro_torch.core.wavefront import resolve_device
from repro_torch.kernels.wfa.kernel import wfa_kernel

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
         band_cap, trace, device):
    if band_cap is not None:
        raise NotImplementedError(
            "the kernel's compacting band (band_cap) is not ported yet")
    bp = resolve_block_pairs(block_pairs)
    pattern, text, plen2, tlen2, B = _prep(pattern, text, plen, tlen, bp,
                                           device)
    return B, wfa_kernel(pattern, text, plen2, tlen2, pen=pen,
                         s_max=int(s_max),
                         k_pad=_round_up(2 * int(k_max) + 1, LANE),
                         block_pairs=bp, trace=trace,
                         heur=scoring.as_heuristic(heur))


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
