"""Decoder-only LM of the dense family (the JAX package's
``models/transformer.py``): init, forward, the loss and the train step,
prefill, the KV cache and the one-token decode step.

Parameters are a nested dict of tensors under the JAX package's names, with
``layers`` a list of per-layer dicts (the JAX package stacks them on a
leading axis for its ``lax.scan``; :func:`params_from_reference` unstacks).
PyTorch runs the layers in a Python loop.  The KV cache is updated in place
by :func:`serve_step` (the JAX package returns a new cache), which keeps one
copy of it on the card.

Training: with grad enabled each block runs under ``torch.utils.
checkpoint`` by ``cfg.remat_policy`` (the JAX package's ``jax.checkpoint``
policies) and its attention through ``layers.FlashAttention``;
:func:`make_train_step` differentiates :func:`loss_fn` and applies AdamW,
updating the state's tensors in place.

Other families (MoE, MLA, SSM, hybrid, enc-dec, VLM) raise
``NotImplementedError``: they wait in ROADMAP §1's queue.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.common import ModelConfig
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.tree import tree_leaves, tree_unflatten


def _dense_only(cfg: ModelConfig) -> None:
    if (cfg.family != "dense" or cfg.attn_kind != "gqa" or cfg.is_moe
            or cfg.mrope):
        raise NotImplementedError(
            f"{cfg.name}: the port runs the dense GQA family only; "
            f"{cfg.family}/{cfg.attn_kind} models wait in ROADMAP §1's "
            f"queue (MoE, MLA, SSM, hybrid, enc-dec, VLM)")


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


def _save_dots(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep the outputs of the products without batch
    dimensions (the projections, ``aten.mm``; the JAX package's
    ``dots_with_no_batch_dims_saveable``), recompute the rest (attention
    with its kernel launch, norms, RoPE, the activation)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _block_remat(cfg: ModelConfig, blk, h, pos):
    """One block under ``cfg.remat_policy``: ``"everything"`` keeps every
    activation; ``"nothing"`` recomputes the whole block in the backward;
    ``"dots"`` recomputes all but the projections.  Blocks draw no random
    numbers, so no RNG state is kept."""
    if cfg.remat_policy == "everything" or not torch.is_grad_enabled():
        return _block_fwd(cfg, blk, h, pos)
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    elif cfg.remat_policy != "nothing":
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
    return checkpoint(_block_fwd, cfg, blk, h, pos, use_reentrant=False,
                      preserve_rng_state=False, **kw)


def _logits(params, cfg: ModelConfig, h):
    c = cfg.cdtype()
    if cfg.tie_embeddings:
        return h @ params["embed"]["w"].to(c).T
    return h @ params["unembed"]["w"].to(c)


def _embed(params, cfg: ModelConfig, tokens):
    # F.embedding: PyTorch does not list its CUDA backward among the
    # nondeterministic operations, and the restart drill needs the same
    # bits from the same inputs
    return F.embedding(tokens, params["embed"]["w"]).to(cfg.cdtype())


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
        h = _block_remat(cfg, blk, h, pos)
    h = L.rmsnorm(params["final_norm"], h, cfg.rms_eps)
    return (_logits(params, cfg, h),
            torch.zeros((), dtype=torch.float32, device=h.device))


# --------------------------------------------------------------------------
# Loss / train step


def loss_fn(params, cfg: ModelConfig, batch):
    """Mean next-token cross-entropy over ``targets >= 0``, from fp32
    logits (log-sum-exp less the gold logit), as the JAX package's."""
    logits, _ = forward(params, cfg, batch["tokens"])
    logits = logits.float()
    targets = batch["targets"]
    mask = (targets >= 0).float()
    tgt = targets.clamp_min(0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tgt[..., None])[..., 0]
    nll = (logz - gold) * mask
    return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, n_micro: int,
                    grad_transform=None, loss=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` holds ``tokens`` and ``targets`` [B, S] (numpy or tensors);
    with ``n_micro`` > 1 it splits into that many microbatches along B,
    whose fp32 gradients are summed and divided by ``n_micro``.  The state's
    parameters and moments are updated in place; ``metrics`` holds
    ``loss``, ``grad_norm`` and ``lr`` as 0-d tensors on the state's
    device."""
    loss = loss or loss_fn

    def value_and_grad(params, mb):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        l = loss(tree_unflatten(params, leaves), cfg, mb)
        grads = torch.autograd.grad(l, leaves, materialize_grads=True)
        return l.detach(), [g.float() for g in grads]

    def train_step(state, batch):
        params = state["params"]
        dev = state["step"].device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if n_micro == 1:
            loss_, grads = value_and_grad(params, batch)
        else:
            B = next(iter(batch.values())).shape[0]
            size = B // n_micro
            loss_, grads = 0.0, None
            for i in range(n_micro):
                mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                l, g = value_and_grad(params, mb)
                loss_ = loss_ + l
                grads = g if grads is None else [
                    a.add_(b) for a, b in zip(grads, g)]
            grads = [g / n_micro for g in grads]
            loss_ = loss_ / n_micro
        params, opt, om = adamw_update(
            opt_cfg, params, tree_unflatten(params, grads), state["opt"],
            state["step"], grad_transform=grad_transform)
        new_state = {"params": params, "opt": opt, "step": state["step"] + 1}
        return new_state, {"loss": loss_, **om}

    return train_step


def init_train_state(cfg: ModelConfig, gen=0, device=None, init=None):
    """-> (state, None): ``{"params", "opt": {"m", "v"}, "step"}`` on
    ``device`` (``None``: the card), parameters from ``init`` (default
    :func:`init_params`), fp32 moments at 0, step an int32 0-d tensor.  The
    second item stands for the JAX package's logical axes, which come with
    the sharding rules (not ported yet)."""
    dev = resolve_device(device)
    params = (init or init_params)(cfg, gen, dev)
    return train_state(params), None


def train_state(params):
    """A fresh training state around ``params``."""
    dev = tree_leaves(params)[0].device
    return {"params": params, "opt": adamw_init(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


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
