"""Whisper-style encoder-decoder backbone (the JAX package's
``models/encdec.py``).

The conv / mel frontend is a stub, as in the JAX package: the caller gives
frame embeddings ``frames`` [B, enc_frames, d_model].  Positions are
absolute sinusoidal (``rope_theta`` 0 turns RoPE off inside attention).

Attention: the encoder's self-attention (non-causal over ``enc_frames``,
1,500 for whisper-base), the decoder's self-attention (causal) and its
cross-attention over the encoder's K/V (non-causal) all run through the
flash kernel (``layers.FlashAttention``), where the JAX package runs
``_sdpa``: the same function.  The non-causal ones hand the kernel the
keys unpadded (``ops.flash_attention_ragged``); the public flash wrapper
keeps the JAX wrapper's ``ValueError`` for them.  A decode step's
attention, self and cross, runs ``_sdpa``, as in the JAX package.

Parameters are a nested dict of tensors under the JAX package's names,
with ``enc_layers`` and ``layers`` lists of per-layer dicts (the JAX package
stacks them; ``transformer.params_from_reference`` unstacks both).  Blocks
run under ``cfg.remat_policy`` (``transformer.remat``).  :func:`serve_step`
writes into the cache in place.  :func:`cache_logical_axes` names the
caches' axes for the sharding rules (``distributed/sharding.py``), and the
activations take the JAX package's ``constrain`` calls.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import ann, constrain
from repro_torch.models import layers as L
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import cross_entropy, generator, remat


def _check(cfg: ModelConfig) -> None:
    if cfg.family != "encdec":
        raise ValueError(f"{cfg.name} is a {cfg.family} model, not enc-dec")


def _sinusoid(pos, d):
    """pos [...] -> [..., d] sinusoidal embedding (whisper's layout: the
    sines, then the cosines), in fp32."""
    half = d // 2
    step = torch.log(torch.tensor(10000.0)) / max(1, half - 1)
    inv = torch.exp(-torch.arange(half, dtype=torch.float32) * step)
    ang = pos.float()[..., None] * inv.to(pos.device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _init_enc_block(cfg: ModelConfig, gen, device):
    return {"ln1": L.init_rmsnorm(cfg, cfg.d_model, device),
            "ln2": L.init_rmsnorm(cfg, cfg.d_model, device),
            "attn": L.init_gqa(cfg, gen, device),
            "mlp": L.init_mlp(cfg, gen, device)}


def _init_dec_block(cfg: ModelConfig, gen, device):
    return {"ln1": L.init_rmsnorm(cfg, cfg.d_model, device),
            "lnx": L.init_rmsnorm(cfg, cfg.d_model, device),
            "ln2": L.init_rmsnorm(cfg, cfg.d_model, device),
            "attn": L.init_gqa(cfg, gen, device),
            "xattn": L.init_gqa(cfg, gen, device),
            "mlp": L.init_mlp(cfg, gen, device)}


def init_params(cfg: ModelConfig, gen=0, device=None) -> Dict[str, Any]:
    """Random parameters with the JAX package's init scales, in
    ``cfg.param_dtype``, on ``device`` (``None``: the card; ``"meta"``
    allocates nothing); ``gen`` a ``torch.Generator`` on that device or an
    int seed for one.  Leaves carry the JAX package's logical axes."""
    _check(cfg)
    dev = resolve_device(device)
    gen = generator(gen, dev)
    V, D = cfg.vocab_padded, cfg.d_model
    return {
        "embed": {"w": ann(L._init(gen, (V, D), 0.02, cfg.pdtype(), dev),
                           "vocab", None)},
        "enc_layers": [_init_enc_block(cfg, gen, dev)
                       for _ in range(cfg.enc_layers)],
        "enc_norm": L.init_rmsnorm(cfg, D, dev),
        "layers": [_init_dec_block(cfg, gen, dev)
                   for _ in range(cfg.n_layers)],
        "final_norm": L.init_rmsnorm(cfg, D, dev),
    }


def _positions(B, S, device):
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(
        B, S)


def _enc_block(cfg: ModelConfig, blk, h, pos):
    a = L.rmsnorm(blk["ln1"], h, cfg.rms_eps)
    h = h + L.gqa_forward(blk["attn"], a, cfg, pos, causal=False)
    m = L.rmsnorm(blk["ln2"], h, cfg.rms_eps)
    return h + L.mlp_forward(blk["mlp"], m, cfg)


def encode(params, cfg: ModelConfig, frames):
    """frames [B, T, D] (the stubbed frontend's output) -> the encoder's
    states [B, T, D] in the compute dtype."""
    c = cfg.cdtype()
    B, T, _ = frames.shape
    pos = _positions(B, T, frames.device)
    h = frames.to(c) + _sinusoid(pos, cfg.d_model).to(c)
    h = constrain(h, "batch", None, None)
    for blk in params["enc_layers"]:
        h = remat(cfg, _enc_block, cfg, blk, h, pos)
        h = constrain(h, "batch", None, None)
    return L.rmsnorm(params["enc_norm"], h, cfg.rms_eps)


def _dec_block(cfg: ModelConfig, blk, h, pos, enc_h, return_cache=False):
    """One decoder block over the full sequence -> h, and with
    ``return_cache`` also its caches (k, v, cross k, cross v) in
    ``cfg.cache_dtype``."""
    a = L.rmsnorm(blk["ln1"], h, cfg.rms_eps)
    y = L.gqa_forward(blk["attn"], a, cfg, pos, causal=True,
                      return_kv=return_cache)
    if return_cache:
        y, (k, v) = y
    h = h + y
    x = L.rmsnorm(blk["lnx"], h, cfg.rms_eps)
    ek, ev = L.encode_kv(blk["xattn"], enc_h, cfg)
    h = h + L.cross_attn_forward(blk["xattn"], x, cfg, ek, ev)
    m = L.rmsnorm(blk["ln2"], h, cfg.rms_eps)
    h = h + L.mlp_forward(blk["mlp"], m, cfg)
    if return_cache:
        cd = getattr(torch, cfg.cache_dtype)
        return h, (k, v, ek.to(cd), ev.to(cd))
    return h


def _embed(params, cfg: ModelConfig, tokens, pos):
    c = cfg.cdtype()
    h = F.embedding(tokens, params["embed"]["w"]).to(c)
    return h + _sinusoid(pos, cfg.d_model).to(c)


def _logits(params, cfg: ModelConfig, h):
    return h @ params["embed"]["w"].to(cfg.cdtype()).T


def forward(params, cfg: ModelConfig, tokens, frames):
    """Teacher-forced decoder. tokens [B,S], frames [B,T,D] -> (logits
    [B,S,Vp] in the compute dtype, aux 0 fp32)."""
    _check(cfg)
    enc_h = encode(params, cfg, frames)
    B, S = tokens.shape
    pos = _positions(B, S, tokens.device)
    h = constrain(_embed(params, cfg, tokens, pos), "batch", None, None)
    for blk in params["layers"]:
        h = remat(cfg, _dec_block, cfg, blk, h, pos, enc_h)
        h = constrain(h, "batch", None, None)
    h = L.rmsnorm(params["final_norm"], h, cfg.rms_eps)
    return (_logits(params, cfg, h),
            torch.zeros((), dtype=torch.float32, device=h.device))


def loss_fn(params, cfg: ModelConfig, batch):
    """Mean next-token cross-entropy of the decoder over ``targets >= 0``;
    ``batch`` holds ``tokens``, ``targets`` and ``frames``."""
    logits, _ = forward(params, cfg, batch["tokens"], batch["frames"])
    return cross_entropy(logits, batch["targets"])


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None):
    """Zero caches in ``cfg.cache_dtype``: the decoder's K/V ``k``, ``v``
    [L, batch, max_seq, KV, dh] and the cross-attention's ``ck``, ``cv``
    [L, batch, enc_frames, KV, dh]."""
    _check(cfg)
    dev = resolve_device(device)
    cd = getattr(torch, cfg.cache_dtype)
    shape = lambda S: (cfg.n_layers, batch, S, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape(max_seq), dtype=cd, device=dev),
            "v": torch.zeros(shape(max_seq), dtype=cd, device=dev),
            "ck": torch.zeros(shape(cfg.enc_frames), dtype=cd, device=dev),
            "cv": torch.zeros(shape(cfg.enc_frames), dtype=cd, device=dev)}


def cache_logical_axes(cfg: ModelConfig):
    """The logical axes of :func:`init_cache`'s tensors."""
    ax = (None, "batch", "kv_seq", None, None)
    return {"k": ax, "v": ax, "ck": ax, "cv": ax}


def prefill(params, cfg: ModelConfig, tokens, frames):
    """Encode, then a teacher-forced decoder pass -> (next-token logits
    [B,Vp] fp32 at position S - 1, the caches: ``k``, ``v`` S rows long,
    ``ck``, ``cv`` enc_frames rows, in the cache dtype)."""
    _check(cfg)
    enc_h = encode(params, cfg, frames)
    B, S = tokens.shape
    pos = _positions(B, S, tokens.device)
    h = constrain(_embed(params, cfg, tokens, pos), "batch", None, None)
    entries = []
    for blk in params["layers"]:
        h, e = _dec_block(cfg, blk, h, pos, enc_h, return_cache=True)
        h = constrain(h, "batch", None, None)
        entries.append(e)
    h = L.rmsnorm(params["final_norm"], h[:, -1:], cfg.rms_eps)
    cache = {n: torch.stack([e[j] for e in entries])
             for j, n in enumerate(("k", "v", "ck", "cv"))}
    return _logits(params, cfg, h)[:, 0].float(), cache


def serve_step(params, cfg: ModelConfig, cache, token, cache_len: int):
    """token [B] int; cache_len an int -> (logits [B,Vp] fp32, cache), the
    new K/V written into row ``cache_len`` of ``k`` / ``v`` in place; the
    cross caches are read only."""
    _check(cfg)
    cache_len = int(cache_len)
    B = token.shape[0]
    pos = torch.full((B, 1), cache_len, dtype=torch.int32,
                     device=token.device)
    h = constrain(_embed(params, cfg, token[:, None], pos), "batch", None,
                  None)
    for i, blk in enumerate(params["layers"]):
        a = L.rmsnorm(blk["ln1"], h, cfg.rms_eps)
        y, _, _ = L.gqa_decode(blk["attn"], a, cfg, cache["k"][i],
                               cache["v"][i], cache_len)
        h = h + y
        x = L.rmsnorm(blk["lnx"], h, cfg.rms_eps)
        h = h + L.cross_attn_forward(blk["xattn"], x, cfg, cache["ck"][i],
                                     cache["cv"][i], decode=True)
        m = L.rmsnorm(blk["ln2"], h, cfg.rms_eps)
        h = h + L.mlp_forward(blk["mlp"], m, cfg)
    h = L.rmsnorm(params["final_norm"], h, cfg.rms_eps)
    return _logits(params, cfg, h)[:, 0].float(), cache
