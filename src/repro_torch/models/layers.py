"""Transformer building blocks of the dense GQA family: norms, RoPE, GQA
attention and the MLP (the JAX package's ``models/layers.py``).

Parameters are nested dicts of tensors under the JAX package's names, kept
in ``cfg.param_dtype`` and cast to ``cfg.compute_dtype`` at each use;
normalisations and softmax accumulate in fp32.  Prefill and full-sequence
attention go through the flash-attention kernel
(:func:`repro_torch.kernels.flash_attention.flash_attention`), which takes
the place of the JAX package's ``_sdpa`` and its ``q_chunk`` scan; decode
attention over the cache stays on :func:`_sdpa`, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import ModelConfig

NEG_INF = -1e30


def _init(gen: torch.Generator, shape, scale, dtype, device):
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device).to(dtype) * scale


# --------------------------------------------------------------------------
# Norms


def init_rmsnorm(cfg: ModelConfig, d: int, device):
    return {"w": torch.ones((d,), dtype=cfg.pdtype(), device=device)}


def rmsnorm(p, x, eps):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["w"].float()).to(x.dtype)


def head_rmsnorm(w, x, eps):
    """Per-head RMSNorm (qwen3 qk_norm): x [..., dh], w [dh]."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


# --------------------------------------------------------------------------
# RoPE


def rope_cos_sin(pos, dim, theta, dtype):
    """pos [..., ] int -> cos/sin [..., dim//2]: angles in fp32, then cast."""
    half = dim // 2
    exps = -torch.arange(half, dtype=torch.float32, device=pos.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=pos.device), exps)
    ang = pos.float()[..., None] * freqs
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x, cos, sin):
    """x [B,S,H,dh]; cos/sin [B,S,dh//2] (broadcast over heads); the
    half-split rotation."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# --------------------------------------------------------------------------
# GQA attention


def init_gqa(cfg: ModelConfig, gen: torch.Generator, device):
    D, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    s = 1.0 / math.sqrt(D)
    pd = cfg.pdtype()
    p = {
        "wq": _init(gen, (D, H, dh), s, pd, device),
        "wk": _init(gen, (D, KV, dh), s, pd, device),
        "wv": _init(gen, (D, KV, dh), s, pd, device),
        "wo": _init(gen, (H, dh, D), 1.0 / math.sqrt(H * dh), pd, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((dh,), dtype=pd, device=device)
        p["k_norm"] = torch.ones((dh,), dtype=pd, device=device)
    return p


def _proj(h, w, c):
    """h [B,S,D] x w [D, heads, dh] -> [B,S,heads,dh] in dtype ``c``."""
    D, n, dh = w.shape
    return (h @ w.to(c).reshape(D, n * dh)).reshape(*h.shape[:-1], n, dh)


def _qkv(p, h, cfg: ModelConfig, rope):
    c = cfg.cdtype()
    q = _proj(h, p["wq"], c)
    k = _proj(h, p["wk"], c)
    v = _proj(h, p["wv"], c)
    if cfg.qk_norm:
        q = head_rmsnorm(p["q_norm"], q, cfg.rms_eps)
        k = head_rmsnorm(p["k_norm"], k, cfg.rms_eps)
    if rope is not None:  # whisper: absolute sinusoidal positions, no RoPE
        cos, sin = rope
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def _out(out, wo, c):
    """out [B,S,H,dh] x wo [H, dh, D] -> [B,S,D]."""
    B, S, H, dh = out.shape
    return out.reshape(B, S, H * dh) @ wo.to(c).reshape(H * dh, -1)


def _sdpa(q, k, v, mask, cfg: ModelConfig):
    """q [B,Sq,H,dh], k/v [B,Sk,KV,dh], mask broadcastable to [B,1,1,Sq,Sk]."""
    B, Sq, H, dh = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k) / math.sqrt(dh)
    scores = torch.where(mask, scores.float(), NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return out.reshape(B, Sq, H, dh)


def _rope(cfg: ModelConfig, pos):
    if cfg.rope_theta == 0:
        return None
    return rope_cos_sin(pos, cfg.d_head, cfg.rope_theta, cfg.cdtype())


def gqa_forward(p, h, cfg: ModelConfig, pos, *, causal=True,
                return_kv=False):
    """Full-sequence attention (prefill / forward). h [B,S,D], pos [B,S]
    (``arange(S)`` per row: the kernel's causal mask starts at position 0).
    """
    c = cfg.cdtype()
    q, k, v = _qkv(p, h, cfg, _rope(cfg, pos))
    out = flash_attention(q, k, v, causal=causal, device=q.device)
    y = _out(out, p["wo"], c)
    if return_kv:
        cd = getattr(torch, cfg.cache_dtype)
        return y, (k.to(cd), v.to(cd))
    return y


def gqa_decode(p, h, cfg: ModelConfig, cache_k, cache_v, cache_len: int):
    """One-token decode. h [B,1,D]; cache_[kv] [B,Smax,KV,dh]; cache_len an
    int.  Writes the new K/V into row ``cache_len`` of the caches in place
    (the JAX package returns updated copies) -> (y, cache_k, cache_v)."""
    c = cfg.cdtype()
    B = h.shape[0]
    pos = torch.full((B, 1), cache_len, dtype=torch.int32, device=h.device)
    q, k, v = _qkv(p, h, cfg, _rope(cfg, pos))
    cache_k[:, cache_len:cache_len + 1] = k.to(cache_k.dtype)
    cache_v[:, cache_len:cache_len + 1] = v.to(cache_v.dtype)
    Smax = cache_k.shape[1]
    valid = (torch.arange(Smax, device=h.device)
             <= cache_len)[None, None, None, None, :]
    out = _sdpa(q, cache_k.to(c), cache_v.to(c), valid, cfg)
    return _out(out, p["wo"], c), cache_k, cache_v


# --------------------------------------------------------------------------
# MLPs


def init_mlp(cfg: ModelConfig, gen: torch.Generator, device,
             d_ff: Optional[int] = None):
    D = cfg.d_model
    Fd = d_ff or cfg.d_ff
    s_in, s_out = 1.0 / math.sqrt(D), 1.0 / math.sqrt(Fd)
    pd = cfg.pdtype()
    if cfg.mlp_gated:
        return {"w1": _init(gen, (D, Fd), s_in, pd, device),
                "w3": _init(gen, (D, Fd), s_in, pd, device),
                "w2": _init(gen, (Fd, D), s_out, pd, device)}
    return {"w_in": _init(gen, (D, Fd), s_in, pd, device),
            "w_out": _init(gen, (Fd, D), s_out, pd, device)}


def mlp_forward(p, x, cfg: ModelConfig):
    c = cfg.cdtype()
    if "w1" in p:
        g = x @ p["w1"].to(c)
        u = x @ p["w3"].to(c)
        return (F.silu(g) * u) @ p["w2"].to(c)
    h = F.gelu(x @ p["w_in"].to(c), approximate="tanh")
    return h @ p["w_out"].to(c)
