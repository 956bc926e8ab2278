"""Decoder-only LM of the dense family (the JAX package's
``models/transformer.py``): init, forward, prefill, the KV cache and the
one-token decode step.

Parameters are a nested dict of tensors under the JAX package's names, with
``layers`` a list of per-layer dicts (the JAX package stacks them on a
leading axis for its ``lax.scan``; :func:`params_from_reference` unstacks).
PyTorch runs the layers in a Python loop.  The KV cache is updated in place
by :func:`serve_step` (the JAX package returns a new cache), which keeps one
copy of it on the card.

Other families (MoE, MLA, SSM, hybrid, enc-dec, VLM) raise
``NotImplementedError``: ROADMAP §1 item 9 ports them.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.common import ModelConfig


def _dense_only(cfg: ModelConfig) -> None:
    if (cfg.family != "dense" or cfg.attn_kind != "gqa" or cfg.is_moe
            or cfg.mrope):
        raise NotImplementedError(
            f"{cfg.name}: the port runs the dense GQA family only; "
            f"{cfg.family}/{cfg.attn_kind} models wait for ROADMAP §1 "
            f"item 9 (LM substrate)")


# --------------------------------------------------------------------------
# Init


def _init_block(cfg: ModelConfig, gen: torch.Generator, device):
    return {"ln1": L.init_rmsnorm(cfg, cfg.d_model, device),
            "ln2": L.init_rmsnorm(cfg, cfg.d_model, device),
            "attn": L.init_gqa(cfg, gen, device),
            "mlp": L.init_mlp(cfg, gen, device)}


def init_params(cfg: ModelConfig, gen=0, device=None) -> Dict[str, Any]:
    """Random parameters with the JAX package's init scales (embeddings
    N(0, 0.02), projections N(0, 1/fan_in), norms 1), in
    ``cfg.param_dtype``, on ``device`` (``None``: the card).  ``gen`` is a
    ``torch.Generator`` on that device or an int seed for one; the numbers
    differ from ``jax.random``'s for the same seed."""
    _dense_only(cfg)
    dev = resolve_device(device)
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(gen))
    V, D = cfg.vocab_padded, cfg.d_model
    pd = cfg.pdtype()
    params: Dict[str, Any] = {
        "embed": {"w": L._init(gen, (V, D), 0.02, pd, dev)},
        "final_norm": L.init_rmsnorm(cfg, D, dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = {"w": L._init(gen, (D, V), 0.02, pd, dev)}
    params["layers"] = [_init_block(cfg, gen, dev)
                        for _ in range(cfg.n_layers)]
    return params


def params_from_reference(tree, device=None) -> Dict[str, Any]:
    """The JAX package's parameter tree (numpy or JAX arrays, as
    ``init_train_state(...)[0]["params"]`` gives it, ``layers`` stacked on
    a leading axis) -> the port's parameters on ``device`` (``None``: the
    card)."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return torch.as_tensor(np.array(x), device=dev)

    def layer(tree, i):
        return {k: layer(v, i) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}

    out = {k: conv(v) for k, v in tree.items() if k != "layers"}
    stacked = conv(tree["layers"])
    n = stacked["ln1"]["w"].shape[0]
    out["layers"] = [layer(stacked, i) for i in range(n)]
    return out


# --------------------------------------------------------------------------
# Full-sequence path


def _block_fwd(cfg: ModelConfig, blk, h, pos, *, return_kv=False):
    a = L.rmsnorm(blk["ln1"], h, cfg.rms_eps)
    y = L.gqa_forward(blk["attn"], a, cfg, pos, return_kv=return_kv)
    if return_kv:
        y, kv = y
    h = h + y
    m = L.rmsnorm(blk["ln2"], h, cfg.rms_eps)
    h = h + L.mlp_forward(blk["mlp"], m, cfg)
    return (h, kv) if return_kv else h


def _logits(params, cfg: ModelConfig, h):
    c = cfg.cdtype()
    if cfg.tie_embeddings:
        return h @ params["embed"]["w"].to(c).T
    return h @ params["unembed"]["w"].to(c)


def _embed(params, cfg: ModelConfig, tokens):
    return params["embed"]["w"][tokens].to(cfg.cdtype())


def _positions(tokens):
    B, S = tokens.shape
    return torch.arange(S, dtype=torch.int32,
                        device=tokens.device)[None].expand(B, S)


def forward(params, cfg: ModelConfig, tokens):
    """Full forward. tokens [B,S] -> (logits [B,S,Vp] in the compute dtype,
    MoE aux loss 0)."""
    _dense_only(cfg)
    pos = _positions(tokens)
    h = _embed(params, cfg, tokens)
    for blk in params["layers"]:
        h = _block_fwd(cfg, blk, h, pos)
    h = L.rmsnorm(params["final_norm"], h, cfg.rms_eps)
    return (_logits(params, cfg, h),
            torch.zeros((), dtype=torch.float32, device=h.device))


# --------------------------------------------------------------------------
# KV cache, decode and prefill


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None):
    """Zero K/V caches [L, batch, max_seq, KV, dh] in ``cfg.cache_dtype``."""
    _dense_only(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.d_head)
    cd = getattr(torch, cfg.cache_dtype)
    return {"k": torch.zeros(shape, dtype=cd, device=dev),
            "v": torch.zeros(shape, dtype=cd, device=dev)}


def _block_decode(cfg: ModelConfig, blk, h, ck, cv, cache_len: int):
    a = L.rmsnorm(blk["ln1"], h, cfg.rms_eps)
    y, _, _ = L.gqa_decode(blk["attn"], a, cfg, ck, cv, cache_len)
    h = h + y
    m = L.rmsnorm(blk["ln2"], h, cfg.rms_eps)
    return h + L.mlp_forward(blk["mlp"], m, cfg)


def serve_step(params, cfg: ModelConfig, cache, token, cache_len: int):
    """token [B] int; cache_len an int -> (logits [B,Vp] fp32, cache), the
    new K/V written into row ``cache_len`` of ``cache`` in place."""
    _dense_only(cfg)
    h = _embed(params, cfg, token[:, None])
    for i, blk in enumerate(params["layers"]):
        h = _block_decode(cfg, blk, h, cache["k"][i], cache["v"][i],
                          int(cache_len))
    h = L.rmsnorm(params["final_norm"], h, cfg.rms_eps)
    return _logits(params, cfg, h)[:, 0].float(), cache


def prefill(params, cfg: ModelConfig, tokens):
    """tokens [B,S] -> (next-token logits [B,Vp] fp32, cache filled to S).

    The logits are those of the last position, S - 1, for every row: a
    shorter prompt padded at the end gets the logits of a pad position, as
    in the JAX package."""
    _dense_only(cfg)
    pos = _positions(tokens)
    h = _embed(params, cfg, tokens)
    ks, vs = [], []
    for blk in params["layers"]:
        h, (k, v) = _block_fwd(cfg, blk, h, pos, return_kv=True)
        ks.append(k)
        vs.append(v)
    h = L.rmsnorm(params["final_norm"], h, cfg.rms_eps)
    logits = _logits(params, cfg, h[:, -1:, :])
    return logits[:, 0].float(), {"k": torch.stack(ks), "v": torch.stack(vs)}
