"""Gradient compression (the JAX package's ``optim/compression.py``): bf16
cast and int8 quantisation with error feedback, on nested dicts of tensors.

The compressors are exact transforms of the gradient tree; ``launch/
train.py`` applies them between backward and the optimizer.  Each returns
new tensors and leaves its input as it was.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_map


def compress_bf16(grads):
    return tree_map(lambda g: g.to(torch.bfloat16), grads)


def decompress_bf16(grads):
    return tree_map(lambda g: g.float(), grads)


def _q8(g):
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_int8(grads):
    """-> tree of (int8 values, fp32 scale) pairs."""
    return tree_map(_q8, grads)


def decompress_int8(comp):
    return tree_map(lambda qs: qs[0].float() * qs[1], comp)


def error_feedback_int8(grads, residual):
    """Quantise (grads + residual) -> (dequantised grads, new residual).

    The residual keeps what quantisation dropped, so the accumulated update
    is unbiased (EF-SGD)."""
    def one(g, r):
        g32 = g.float() + r
        q, scale = _q8(g32)
        deq = q.float() * scale
        return deq, g32 - deq

    out = tree_map(one, grads, residual)
    return tree_map(lambda o: o[0], out), tree_map(lambda o: o[1], out)


def init_residual(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)
