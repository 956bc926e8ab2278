"""Transformer building blocks: norms, RoPE and M-RoPE, GQA, cross- and MLA
attention and the MLP (the JAX package's ``models/layers.py``).

Parameters are nested dicts of tensors under the JAX package's names, kept
in ``cfg.param_dtype`` and cast to ``cfg.compute_dtype`` at each use;
normalisations and softmax accumulate in fp32.  Prefill and full-sequence
attention go through the flash-attention kernel
(:func:`repro_torch.kernels.flash_attention.flash_attention`), which takes
the place of the JAX package's ``_sdpa`` and its ``q_chunk`` scan: under
autograd through :class:`FlashAttention`, whose backward recomputes that
scan; decode attention over the cache stays on :func:`_sdpa`, as in the
JAX package.  MLA (deepseek-v2) runs as plain products and softmax in
prefill, training and decode alike, as in the JAX package.

Two choices differ from the JAX package in how, not in what, they compute:

- An encoder's self-attention and a decoder's cross-attention over the
  encoder's keys (whisper) run through the flash kernel, non-causal, where
  the JAX package runs ``_sdpa`` over an all-true mask: the same function.
  A cross-attention decode step (one query) stays on :func:`_sdpa`.
- The public wrapper ``kernels.flash_attention.flash_attention`` keeps the
  JAX wrapper's ``ValueError`` for non-causal keys that are not a block
  multiple; :class:`FlashAttention` instead sends non-causal attention to
  ``flash_attention_ragged``, which pads only the queries and passes the
  kernel the real key length (1,500 frames for whisper), since zero keys
  with no mask would each add ``exp(0 - m)`` to the denominator.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import ann, constrain
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ops import flash_attention_ragged
from repro_torch.models.common import ModelConfig

NEG_INF = -1e30


def _init(gen: Optional[torch.Generator], shape, scale, dtype, device):
    """N(0, scale^2) in ``dtype``; ``gen`` None on the meta device."""
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device).to(dtype) * scale


# --------------------------------------------------------------------------
# Norms


def init_rmsnorm(cfg: ModelConfig, d: int, device):
    return {"w": ann(torch.ones((d,), dtype=cfg.pdtype(), device=device),
                     None)}


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
# RoPE / M-RoPE


def _freqs(half, theta, device):
    exps = -torch.arange(half, dtype=torch.float32, device=device) / half
    return torch.pow(torch.tensor(theta, dtype=torch.float32, device=device),
                     exps)


def rope_cos_sin(pos, dim, theta, dtype):
    """pos [..., ] int -> cos/sin [..., dim//2]: angles in fp32, then cast."""
    ang = pos.float()[..., None] * _freqs(dim // 2, theta, pos.device)
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def mrope_cos_sin(pos3, dim, theta, sections, dtype):
    """M-RoPE (qwen2-vl): pos3 [..., 3] int -> cos/sin [..., dim//2].  The
    frequency slots fall into (temporal, height, width) sections of
    ``sections`` slots; slot i takes its position from its section."""
    half = dim // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} must sum to "
                         f"dim // 2 = {half}")
    sec_id = torch.repeat_interleave(
        torch.arange(3, device=pos3.device),
        torch.tensor(list(sections), device=pos3.device), output_size=half)
    ang = pos3.float()[..., sec_id] * _freqs(half, theta, pos3.device)
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
        "wq": ann(_init(gen, (D, H, dh), s, pd, device), None, "heads",
                  None),
        "wk": ann(_init(gen, (D, KV, dh), s, pd, device), None, "heads",
                  None),
        "wv": ann(_init(gen, (D, KV, dh), s, pd, device), None, "heads",
                  None),
        "wo": ann(_init(gen, (H, dh, D), 1.0 / math.sqrt(H * dh), pd,
                        device), "heads", None, None),
    }
    if cfg.qk_norm:
        p["q_norm"] = ann(torch.ones((dh,), dtype=pd, device=device), None)
        p["k_norm"] = ann(torch.ones((dh,), dtype=pd, device=device), None)
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


def sdpa_chunked(q, k, v, cfg: ModelConfig, *, causal=True):
    """The JAX package's full-sequence attention (``gqa_forward``,
    ``cross_attn_forward``): one :func:`_sdpa` over the queries, or one per
    block of ``cfg.q_chunk`` queries when there are more; positions from 0.
    Keys may outnumber queries (cross-attention) when not ``causal``."""
    S, Sk = q.shape[1], k.shape[1]
    pos = torch.arange(S, device=q.device)
    chunk = cfg.q_chunk if S > cfg.q_chunk else S
    if S % chunk:
        raise ValueError(f"S {S} is not a multiple of q_chunk {chunk}")
    outs = []
    for i in range(0, S, chunk):
        if causal:
            mask = pos[i:i + chunk, None] >= pos[None, :]
        else:
            mask = torch.ones((chunk, Sk), dtype=torch.bool,
                              device=q.device)
        outs.append(_sdpa(q[:, i:i + chunk], k, v, mask, cfg))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


class FlashAttention(torch.autograd.Function):
    """Full-sequence attention with the flash-attention kernel on the
    forward and a gradient: ``FlashAttention.apply(q, k, v, cfg, causal)``.

    The forward is :func:`flash_attention` whole (padding to block
    multiples, the kernel, the slice back), or for non-causal attention
    ``flash_attention_ragged`` (queries padded, keys as they are): on the
    card the hand-written CUDA body, on the CPU its plain version.  It
    saves the unpadded
    ``q, k, v``.  The backward recomputes the attention through the plain
    differentiable path, :func:`sdpa_chunked` (the JAX package's ``_sdpa``
    and its ``q_chunk`` scan, with the same causal mask from position 0),
    and returns ``dq, dk, dv`` of the unpadded inputs.  The JAX package
    trains through that same path and has no backward kernel to port; a
    hand-written backward is a later speed item."""

    @staticmethod
    def forward(ctx, q, k, v, cfg: ModelConfig, causal: bool = True):
        ctx.save_for_backward(q, k, v)
        ctx.cfg, ctx.causal = cfg, causal
        if causal:
            return flash_attention(q, k, v, causal=True, device=q.device)
        return flash_attention_ragged(q, k, v, device=q.device)

    @staticmethod
    def backward(ctx, do):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            o = sdpa_chunked(q, k, v, ctx.cfg, causal=ctx.causal)
            dq, dk, dv = torch.autograd.grad(o, (q, k, v), do)
        return dq, dk, dv, None, None


def _rope(cfg: ModelConfig, pos, mrope_pos=None):
    """None without RoPE (whisper); M-RoPE from ``mrope_pos`` [B,S,3] when
    the config has it and it is given, else RoPE from ``pos``."""
    if cfg.rope_theta == 0:
        return None
    if cfg.mrope and mrope_pos is not None:
        return mrope_cos_sin(mrope_pos, cfg.d_head, cfg.rope_theta,
                             cfg.mrope_sections, cfg.cdtype())
    return rope_cos_sin(pos, cfg.d_head, cfg.rope_theta, cfg.cdtype())


def gqa_forward(p, h, cfg: ModelConfig, pos, *, causal=True, mrope_pos=None,
                return_kv=False):
    """Full-sequence attention (training / prefill). h [B,S,D], pos [B,S]
    (``arange(S)`` per row: the kernel's causal mask starts at position 0,
    as the JAX package's mask does, also under M-RoPE), ``mrope_pos``
    [B,S,3] the M-RoPE positions or None, through :class:`FlashAttention`
    (with grad off it records no graph).
    """
    c = cfg.cdtype()
    q, k, v = _qkv(p, h, cfg, _rope(cfg, pos, mrope_pos))
    out = FlashAttention.apply(q, k, v, cfg, causal)
    y = _out(out, p["wo"], c)
    if return_kv:
        cd = getattr(torch, cfg.cache_dtype)
        return y, (k.to(cd), v.to(cd))
    return y


def _write_row(cache, new, pos: int):
    """``cache[:, pos] = new[:, 0]`` in place -> ``cache`` (the dry-run's
    trace swaps in ``launch.traced_ops.write_row``, which returns a new
    tensor: callers take the result)."""
    cache[:, pos:pos + 1] = new.to(cache.dtype)
    return cache


def gqa_decode(p, h, cfg: ModelConfig, cache_k, cache_v, cache_len: int, *,
               mrope_pos=None):
    """One-token decode. h [B,1,D]; cache_[kv] [B,Smax,KV,dh]; cache_len an
    int; ``mrope_pos`` [B,1,3] the new token's M-RoPE positions or None.
    Writes the new K/V into row ``cache_len`` of the caches in place (the
    JAX package returns updated copies) -> (y, cache_k, cache_v)."""
    c = cfg.cdtype()
    B = h.shape[0]
    pos = torch.full((B, 1), cache_len, dtype=torch.int32, device=h.device)
    q, k, v = _qkv(p, h, cfg, _rope(cfg, pos, mrope_pos))
    cache_k = _write_row(cache_k, k, cache_len)
    cache_v = _write_row(cache_v, v, cache_len)
    cache_k = constrain(cache_k, "batch", "kv_seq", None, None)
    cache_v = constrain(cache_v, "batch", "kv_seq", None, None)
    Smax = cache_k.shape[1]
    valid = (torch.arange(Smax, device=h.device)
             <= cache_len)[None, None, None, None, :]
    out = _sdpa(q, cache_k.to(c), cache_v.to(c), valid, cfg)
    return _out(out, p["wo"], c), cache_k, cache_v


def cross_attn_forward(p, h, cfg: ModelConfig, enc_k, enc_v, *,
                       decode=False):
    """Decoder cross-attention over the encoder's K/V, no mask. h [B,S,D];
    enc_k / enc_v [B,T,KV,dh].  Through :class:`FlashAttention`
    (non-causal, the keys unpadded), or for a ``decode`` step's one query
    through :func:`_sdpa`, as :func:`gqa_decode` runs."""
    c = cfg.cdtype()
    q = _proj(h, p["wq"], c)
    ek, ev = enc_k.to(c), enc_v.to(c)
    if decode:
        mask = torch.ones((1, 1, 1, h.shape[1], ek.shape[1]),
                          dtype=torch.bool, device=h.device)
        out = _sdpa(q, ek, ev, mask, cfg)
    else:
        out = FlashAttention.apply(q, ek, ev, cfg, False)
    return _out(out, p["wo"], c)


def encode_kv(p, enc_h, cfg: ModelConfig):
    """The encoder states' cross-attention K/V. enc_h [B,T,D] ->
    [B,T,KV,dh] each, in the compute dtype."""
    c = cfg.cdtype()
    return _proj(enc_h, p["wk"], c), _proj(enc_h, p["wv"], c)


# --------------------------------------------------------------------------
# MLA attention (deepseek-v2): the compressed latent is the KV cache.  Its
# query/key dim (nope + rope) differs from its value dim and one rope key
# serves every head, so it runs as plain products and softmax, as in the
# JAX package, not through the flash kernel.


def init_mla(cfg: ModelConfig, gen: torch.Generator, device):
    D, H = cfg.d_model, cfg.n_heads
    r, rd, nd, vd = (cfg.kv_lora_rank, cfg.qk_rope_dim, cfg.qk_nope_dim,
                     cfg.v_head_dim)
    s = 1.0 / math.sqrt(D)
    pd = cfg.pdtype()
    return {"wq": ann(_init(gen, (D, H, nd + rd), s, pd, device), None,
                      "heads", None),
            "w_dkv": ann(_init(gen, (D, r), s, pd, device), None, None),
            "w_kr": ann(_init(gen, (D, rd), s, pd, device), None, None),
            "kv_norm": ann(torch.ones((r,), dtype=pd, device=device), None),
            "w_uk": ann(_init(gen, (r, H, nd), 1.0 / math.sqrt(r), pd,
                              device), None, "heads", None),
            "w_uv": ann(_init(gen, (r, H, vd), 1.0 / math.sqrt(r), pd,
                              device), None, "heads", None),
            "wo": ann(_init(gen, (H, vd, D), 1.0 / math.sqrt(H * vd), pd,
                            device), "heads", None, None)}


def _mla_latent(p, h, cfg: ModelConfig, pos):
    """h [B,S,D] -> (c_kv [B,S,r] after ``kv_norm``, k_rope [B,S,rd])."""
    c = cfg.cdtype()
    c_kv = rmsnorm({"w": p["kv_norm"]}, h @ p["w_dkv"].to(c), cfg.rms_eps)
    k_rope = h @ p["w_kr"].to(c)
    cos, sin = rope_cos_sin(pos, cfg.qk_rope_dim, cfg.rope_theta, c)
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]
    return c_kv, k_rope


def _mla_q(p, h, cfg: ModelConfig, pos):
    """h [B,S,D] -> (q_nope [B,S,H,nd], q_rope [B,S,H,rd])."""
    c = cfg.cdtype()
    nd, rd = cfg.qk_nope_dim, cfg.qk_rope_dim
    q = _proj(h, p["wq"], c)
    cos, sin = rope_cos_sin(pos, rd, cfg.rope_theta, c)
    return q[..., :nd], apply_rope(q[..., nd:], cos, sin)


def mla_forward(p, h, cfg: ModelConfig, pos, *, q_chunk: int = 0,
                return_kv=False):
    """Full-sequence MLA (the naive, paper-formula path). h [B,S,D],
    pos [B,S]; queries in blocks of ``q_chunk`` (default ``cfg.q_chunk``)
    when S is longer.  ``return_kv`` also gives ``(c_kv, k_rope)`` in
    ``cfg.cache_dtype``, the cache."""
    c = cfg.cdtype()
    B, S, _ = h.shape
    q_chunk = q_chunk or cfg.q_chunk
    scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    c_kv, k_rope = _mla_latent(p, h, cfg, pos)
    q_nope, q_rope = _mla_q(p, h, cfg, pos)
    k_nope = _proj(c_kv, p["w_uk"], c)
    v = _proj(c_kv, p["w_uv"], c)

    def scores_fn(qn, qr, qpos):
        # per-head nope part + the rope key shared by every head
        sc = torch.einsum("bqhk,bshk->bhqs", qn, k_nope)
        sc = sc + torch.einsum("bqhk,bsk->bhqs", qr, k_rope)
        sc = sc * scale
        mask = qpos[:, None, :, None] >= pos[:, None, None, :]
        sc = torch.where(mask, sc.float(), NEG_INF)
        w = torch.softmax(sc, dim=-1).to(c)
        return torch.einsum("bhqs,bshk->bqhk", w, v)

    if S <= q_chunk:
        out = scores_fn(q_nope, q_rope, pos)
    else:
        if S % q_chunk:
            raise ValueError(f"S {S} is not a multiple of q_chunk {q_chunk}")
        out = torch.cat([scores_fn(q_nope[:, i:i + q_chunk],
                                   q_rope[:, i:i + q_chunk],
                                   pos[:, i:i + q_chunk])
                         for i in range(0, S, q_chunk)], dim=1)

    y = _out(out, p["wo"], c)
    if return_kv:
        cd = getattr(torch, cfg.cache_dtype)
        return y, (c_kv.to(cd), k_rope.to(cd))
    return y


def mla_decode(p, h, cfg: ModelConfig, cache_ckv, cache_kr, cache_len: int):
    """One-token MLA decode. h [B,1,D]; cache_ckv [B,Smax,r], cache_kr
    [B,Smax,rd]; cache_len an int.  Writes the new latent and rope key into
    row ``cache_len`` of the caches in place -> (y, cache_ckv, cache_kr).

    ``cfg.mla_absorb`` False: the naive path, k_nope and v re-expanded from
    the latent cache (the published formulas).  True: the absorbed path,
    ``w_uk`` folded into the query and ``w_uv`` into the output, so
    attention runs in the latent space."""
    c = cfg.cdtype()
    B = h.shape[0]
    pos = torch.full((B, 1), cache_len, dtype=torch.int32, device=h.device)
    scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    c_kv_new, k_rope_new = _mla_latent(p, h, cfg, pos)
    q_nope, q_rope = _mla_q(p, h, cfg, pos)
    cache_ckv = _write_row(cache_ckv, c_kv_new, cache_len)
    cache_kr = _write_row(cache_kr, k_rope_new, cache_len)
    cache_ckv = constrain(cache_ckv, "batch", "kv_seq", None)
    cache_kr = constrain(cache_kr, "batch", "kv_seq", None)
    Smax = cache_ckv.shape[1]
    valid = (torch.arange(Smax, device=h.device)
             <= cache_len)[None, None, None, :]
    ckv = cache_ckv.to(c)
    kr = cache_kr.to(c)

    if cfg.mla_absorb:
        qa = torch.einsum("bqhk,rhk->bqhr", q_nope, p["w_uk"].to(c))
        sc = torch.einsum("bqhr,bsr->bhqs", qa, ckv)
        sc = sc + torch.einsum("bqhk,bsk->bhqs", q_rope, kr)
        sc = torch.where(valid, sc.float() * scale, NEG_INF)
        w = torch.softmax(sc, dim=-1).to(c)
        ol = torch.einsum("bhqs,bsr->bqhr", w, ckv)
        out = torch.einsum("bqhr,rhk->bqhk", ol, p["w_uv"].to(c))
    else:
        k_nope = _proj(ckv, p["w_uk"], c)
        v = _proj(ckv, p["w_uv"], c)
        sc = torch.einsum("bqhk,bshk->bhqs", q_nope, k_nope)
        sc = sc + torch.einsum("bqhk,bsk->bhqs", q_rope, kr)
        sc = torch.where(valid, sc.float() * scale, NEG_INF)
        w = torch.softmax(sc, dim=-1).to(c)
        out = torch.einsum("bhqs,bshk->bqhk", w, v)

    return _out(out, p["wo"], c), cache_ckv, cache_kr


# --------------------------------------------------------------------------
# MLPs


def init_mlp(cfg: ModelConfig, gen: torch.Generator, device,
             d_ff: Optional[int] = None):
    D = cfg.d_model
    Fd = d_ff or cfg.d_ff
    s_in, s_out = 1.0 / math.sqrt(D), 1.0 / math.sqrt(Fd)
    pd = cfg.pdtype()
    if cfg.mlp_gated:
        return {"w1": ann(_init(gen, (D, Fd), s_in, pd, device), None,
                          "ff"),
                "w3": ann(_init(gen, (D, Fd), s_in, pd, device), None,
                          "ff"),
                "w2": ann(_init(gen, (Fd, D), s_out, pd, device), "ff",
                          None)}
    return {"w_in": ann(_init(gen, (D, Fd), s_in, pd, device), None, "ff"),
            "w_out": ann(_init(gen, (Fd, D), s_out, pd, device), "ff",
                         None)}


def mlp_forward(p, x, cfg: ModelConfig):
    c = cfg.cdtype()
    if "w1" in p:
        g = x @ p["w1"].to(c)
        u = x @ p["w3"].to(c)
        return (F.silu(g) * u) @ p["w2"].to(c)
    h = F.gelu(x @ p["w_in"].to(c), approximate="tanh")
    return h @ p["w_out"].to(c)
