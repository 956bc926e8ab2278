"""Plain oracle for the flash-attention kernel: GQA attention over the
materialised scores with an fp32 softmax (the JAX package's
``kernels/flash_attention/ref.py``)."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def ref_attention_gqa(q, k, v, *, causal: bool = True):
    """q [B,Sq,H,dh]; k/v [B,Sk,KV,dh] -> [B,Sq,H,dh]."""
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float()
    s = s / math.sqrt(dh)
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return o.reshape(B, Sq, H, dh)
