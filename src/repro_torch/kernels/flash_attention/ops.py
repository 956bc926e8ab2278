"""Wrapper for the flash-attention kernel: padding and defaults (the JAX
package's ``kernels/flash_attention/ops.py``).

Sq and Sk pad up to block multiples with zeros.  Under ``causal`` the pad
keys sit at positions past every real query, so the mask removes them; the
padded query rows are sliced off.  The non-causal path needs ``Sk`` to be a
block multiple and raises otherwise, as the JAX wrapper does.

:func:`flash_attention_ragged` is the model path's non-causal entry (an
encoder's self-attention, a decoder's cross-attention over 1,500 frames):
it pads only the queries and hands the kernel the keys unpadded, which it
takes at any length.  Zero keys would be wrong there: with no mask to
remove them, each adds ``exp(0 - m)`` to a row's denominator.

Inputs (numpy arrays or tensors) go to ``device``: ``None`` means the card
(``"cuda"``), which must exist, and ``"cpu"`` runs the kernel's plain
version.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention.kernel import flash_attention_gqa
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    ref_attention_gqa)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_blocks(q, k, v, *, causal: bool = True, block_q: int = 512,
               block_k: int = 512, pad_keys: bool = True):
    """-> (q, k, v, bq, bk), padded to the blocks the kernel is called with:
    ``bq = min(block_q, round_up(Sq, 128))``, and the same for ``bk``.
    ``pad_keys=False`` (non-causal only) leaves the keys as they are."""
    Sq, Sk = q.shape[1], k.shape[1]
    bq = min(block_q, _round_up(Sq, 128))
    bk = min(block_k, _round_up(Sk, 128))
    Sq_p, Sk_p = _round_up(Sq, bq), _round_up(Sk, bk)
    if not pad_keys:
        if causal:
            raise ValueError("only non-causal attention takes keys unpadded")
        Sk_p = Sk
    elif not causal and Sk_p != Sk:
        raise ValueError("non-causal flash path requires Sk % block_k == 0 "
                         "(pad upstream or pick a dividing block)")
    rows = lambda t, n: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, n))
    if Sq_p != Sq:
        q = rows(q, Sq_p - Sq)
    if Sk_p != Sk:
        k, v = rows(k, Sk_p - Sk), rows(v, Sk_p - Sk)
    return q, k, v, bq, bk


def flash_attention(q, k, v, *, causal: bool = True, block_q: int = 512,
                    block_k: int = 512, device=None):
    """Drop-in blocked attention. q [B,Sq,H,dh]; k/v [B,Sk,KV,dh]."""
    dev = resolve_device(device)
    q, k, v = (torch.as_tensor(t, device=dev) for t in (q, k, v))
    Sq = q.shape[1]
    q, k, v, bq, bk = pad_blocks(q, k, v, causal=causal, block_q=block_q,
                                 block_k=block_k)
    o = flash_attention_gqa(q, k, v, causal=causal, block_q=bq, block_k=bk)
    return o[:, :Sq]


def flash_attention_ragged(q, k, v, *, block_q: int = 512,
                           block_k: int = 512, device=None):
    """Non-causal attention over keys of any length. q [B,Sq,H,dh]; k/v
    [B,Sk,KV,dh]: only the queries pad to a block multiple."""
    dev = resolve_device(device)
    q, k, v = (torch.as_tensor(t, device=dev) for t in (q, k, v))
    Sq = q.shape[1]
    q, k, v, bq, bk = pad_blocks(q, k, v, causal=False, block_q=block_q,
                                 block_k=block_k, pad_keys=False)
    o = flash_attention_gqa(q, k, v, causal=False, block_q=bq, block_k=bk)
    return o[:, :Sq]
