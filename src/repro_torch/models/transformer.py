"""Decoder-only LM of the dense, MoE, SSM, hybrid and VLM families, with
GQA or MLA attention (the JAX package's ``models/transformer.py``): init,
forward, the loss and the train step, prefill, the KV / state cache and the
one-token decode step.  The enc-dec family (whisper) is
``models/encdec.py``, which shares the train step and the remat here.

Parameters are a nested dict of tensors under the JAX package's names, with
``layers`` a list of per-layer dicts (the JAX package stacks them on a
leading axis for its ``lax.scan``; :func:`params_from_reference` unstacks).
An MoE model's leading dense layers (``cfg.first_k_dense``) are the list
``head_layers``, with an MLP of ``cfg.dense_layer_ff``; the layers of
``layers`` hold ``moe`` in its place.  An SSM or hybrid layer is ``{"norm",
"ssm"}`` (a Mamba2 block, ``models/ssm.py``); a hybrid (zamba2) also holds
one ``shared_attn`` block (GQA attention and an MLP, not stacked) that runs
after every ``cfg.hybrid_attn_every``-th layer, the segments of
:func:`_hybrid_segments`.  PyTorch runs the layers in a Python loop, head
layers first.  The KV and state caches are updated in place by
:func:`serve_step` (the JAX package returns a new cache), which keeps one
copy of them on the card.  A VLM (qwen2-vl) takes ``patch_embeds`` [B, P,
D], which overwrite the first P positions' token embeddings, and
``mrope_pos`` [B, S, 3], its M-RoPE positions (``serve_step``: [B, 1, 3]);
without them it runs on text with plain RoPE, as in the JAX package.

Training: with grad enabled each block runs under ``torch.utils.
checkpoint`` by ``cfg.remat_policy`` (the JAX package's ``jax.checkpoint``
policies) and its attention through ``layers.FlashAttention``;
:func:`make_train_step` differentiates :func:`loss_fn` and applies AdamW,
updating the state's tensors in place.
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
from repro_torch.distributed.sharding import (ann, annotated, constrain,
                                              stack_axes)
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.common import ModelConfig
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.tree import tree_leaves, tree_unflatten


FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")
# the parameter lists the JAX package stacks on a leading layer axis
STACKS = ("layers", "enc_layers")


def _ported(cfg: ModelConfig) -> None:
    """Raise for a configuration this module does not run (enc-dec runs in
    ``models/encdec.py``)."""
    if cfg.family not in FAMILIES or cfg.attn_kind not in ("gqa", "mla"):
        raise NotImplementedError(
            f"{cfg.name}: models/transformer.py runs the "
            f"{', '.join(FAMILIES)} families (GQA or MLA attention), not "
            f"{cfg.family}/{cfg.attn_kind}")


def _is_ssm(cfg: ModelConfig) -> bool:
    return cfg.family in ("ssm", "hybrid")


# --------------------------------------------------------------------------
# Init


def _init_block(cfg: ModelConfig, gen: torch.Generator, device,
                layer_idx: int):
    if _is_ssm(cfg):
        return {"norm": L.init_rmsnorm(cfg, cfg.d_model, device),
                "ssm": SSM.init_ssm(cfg, gen, device)}
    blk = {"ln1": L.init_rmsnorm(cfg, cfg.d_model, device),
           "ln2": L.init_rmsnorm(cfg, cfg.d_model, device)}
    if cfg.attn_kind == "mla":
        blk["attn"] = L.init_mla(cfg, gen, device)
    else:
        blk["attn"] = L.init_gqa(cfg, gen, device)
    if cfg.is_moe and layer_idx >= cfg.first_k_dense:
        blk["moe"] = MOE.init_moe(cfg, gen, device)
    else:
        ff = (cfg.dense_layer_ff if (cfg.is_moe and cfg.dense_layer_ff)
              else cfg.d_ff)
        blk["mlp"] = L.init_mlp(cfg, gen, device, d_ff=ff)
    return blk


def init_params(cfg: ModelConfig, gen=0, device=None) -> Dict[str, Any]:
    """Random parameters with the JAX package's init scales (embeddings
    N(0, 0.02), projections N(0, 1/fan_in), norms 1), in
    ``cfg.param_dtype``, on ``device`` (``None``: the card; ``"meta"``
    allocates nothing).  ``gen`` is a ``torch.Generator`` on that device or
    an int seed for one; the numbers differ from ``jax.random``'s for the
    same seed.  Every leaf carries the JAX package's logical axes
    (``sharding.ann``; :func:`init_train_state` returns them)."""
    _ported(cfg)
    dev = resolve_device(device)
    gen = generator(gen, dev)
    V, D = cfg.vocab_padded, cfg.d_model
    pd = cfg.pdtype()
    params: Dict[str, Any] = {
        "embed": {"w": ann(L._init(gen, (V, D), 0.02, pd, dev), "vocab",
                           None)},
        "final_norm": L.init_rmsnorm(cfg, D, dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = {"w": ann(L._init(gen, (D, V), 0.02, pd, dev),
                                      None, "vocab")}
    first = cfg.first_k_dense if cfg.is_moe else 0
    if first:
        params["head_layers"] = [_init_block(cfg, gen, dev, i)
                                 for i in range(first)]
    params["layers"] = [_init_block(cfg, gen, dev, i)
                        for i in range(first, cfg.n_layers)]
    if cfg.family == "hybrid" and cfg.hybrid_attn_every:
        params["shared_attn"] = {
            "ln1": L.init_rmsnorm(cfg, D, dev),
            "ln2": L.init_rmsnorm(cfg, D, dev),
            "attn": L.init_gqa(cfg, gen, dev),
            "mlp": L.init_mlp(cfg, gen, dev)}
    return params


def generator(gen, dev: torch.device):
    """``gen`` as init draws from it: a ``torch.Generator`` as it is, an int
    seed as a generator on ``dev``, None on the meta device."""
    if dev.type == "meta":
        return None
    if isinstance(gen, torch.Generator):
        return gen
    return torch.Generator(device=dev).manual_seed(int(gen))


def n_shared_apps(cfg: ModelConfig) -> int:
    """How many times a hybrid's shared block runs (0 for other
    families)."""
    if cfg.family != "hybrid" or not cfg.hybrid_attn_every:
        return 0
    return cfg.n_layers // cfg.hybrid_attn_every


def _hybrid_segments(cfg: ModelConfig):
    """[(start, end, apply_shared_after)] covering all stacked layers: runs
    of ``hybrid_attn_every`` layers, each followed by the shared block, and
    a shorter tail without it."""
    every, n = cfg.hybrid_attn_every, cfg.n_layers
    segs = []
    a = 0
    while a < n:
        b = min(a + every, n)
        segs.append((a, b, b - a == every))
        a = b
    return segs


def _run_order(cfg: ModelConfig, params):
    """The stacked layers in the order they run -> [(the layer's row of
    the per-layer caches, or None for a hybrid's shared block, which runs
    after each full segment of :func:`_hybrid_segments`; the block)].  The
    shared block has a dense GQA block's leaves, so the dense block code
    runs it."""
    if not (cfg.family == "hybrid" and "shared_attn" in params):
        return list(enumerate(params["layers"]))
    order = []
    for a, b, shared in _hybrid_segments(cfg):
        order += [(i, params["layers"][i]) for i in range(a, b)]
        if shared:
            order.append((None, params["shared_attn"]))
    return order


def params_from_reference(tree, device=None) -> Dict[str, Any]:
    """The JAX package's parameter tree (numpy or JAX arrays, as
    ``init_train_state(...)[0]["params"]`` gives it, ``layers`` and an
    enc-dec model's ``enc_layers`` stacked on a leading axis,
    ``head_layers`` a list of unstacked layers, a hybrid's ``shared_attn``
    unstacked) -> the port's parameters on ``device`` (``None``: the
    card), each stack a list of layers."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return torch.as_tensor(np.array(x), device=dev)

    def layer(tree, i):
        return {k: layer(v, i) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}

    out = {k: conv(v) for k, v in tree.items() if k not in STACKS}
    for name in STACKS:
        if name in tree:
            stacked = conv(tree[name])
            n = tree_leaves(stacked)[0].shape[0]
            out[name] = [layer(stacked, i) for i in range(n)]
    return out


# --------------------------------------------------------------------------
# Full-sequence path


def _block_fwd(cfg: ModelConfig, blk, h, pos, mrope_pos=None, *,
               return_cache=False):
    """One block, full sequence -> (h, MoE aux loss; 0 for a dense or SSM
    block), and with ``return_cache`` the layer's cache entries: ``(k, v)``
    for GQA, ``(c_kv, k_rope)`` for MLA, the fp32 SSM state and the conv
    tail for an SSM block.  A hybrid's shared block runs here as a dense
    GQA block.  ``mrope_pos``: a VLM's M-RoPE positions, or None."""
    zero = lambda: torch.zeros((), dtype=torch.float32, device=h.device)
    if "ssm" in blk:
        a = L.rmsnorm(blk["norm"], h, cfg.rms_eps)
        y = SSM.ssm_forward(blk["ssm"], a, cfg, return_state=return_cache)
        if return_cache:
            return h + y[0], zero(), y[1]
        return h + y, zero()
    a = L.rmsnorm(blk["ln1"], h, cfg.rms_eps)
    if cfg.attn_kind == "mla":
        y = L.mla_forward(blk["attn"], a, cfg, pos, return_kv=return_cache)
    else:
        y = L.gqa_forward(blk["attn"], a, cfg, pos, mrope_pos=mrope_pos,
                          return_kv=return_cache)
    if return_cache:
        y, kv = y
    h = h + y
    m = L.rmsnorm(blk["ln2"], h, cfg.rms_eps)
    if "moe" in blk:
        y, aux = MOE.moe_forward(blk["moe"], m, cfg)
    else:
        y, aux = L.mlp_forward(blk["mlp"], m, cfg), zero()
    h = h + y
    return (h, aux, kv) if return_cache else (h, aux)


def _save_dots(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep the outputs of the products without batch
    dimensions (the projections and the MoE router, ``aten.mm``; the JAX
    package's ``dots_with_no_batch_dims_saveable``), recompute the rest
    (attention with its kernel launch, the batched expert, MLA score and
    SSD products, norms, RoPE, the activation)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)``, one block, under ``cfg.remat_policy``:
    ``"everything"`` keeps every activation; ``"nothing"`` recomputes the
    whole block in the backward; ``"dots"`` recomputes all but the
    projections.  Blocks draw no random numbers, so no RNG state is
    kept."""
    if cfg.remat_policy == "everything" or not torch.is_grad_enabled():
        return fn(*args)
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    elif cfg.remat_policy != "nothing":
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, **kw)


def _logits(params, cfg: ModelConfig, h):
    c = cfg.cdtype()
    if cfg.tie_embeddings:
        return h @ params["embed"]["w"].to(c).T
    return h @ params["unembed"]["w"].to(c)


def _embed(params, cfg: ModelConfig, tokens, patch_embeds=None):
    """Token embeddings in the compute dtype; a VLM's ``patch_embeds`` [B,
    P, D] take the place of the first P positions'."""
    # F.embedding: PyTorch does not list its CUDA backward among the
    # nondeterministic operations, and the restart drill needs the same
    # bits from the same inputs
    h = F.embedding(tokens, params["embed"]["w"]).to(cfg.cdtype())
    if cfg.family == "vlm" and patch_embeds is not None:
        P = patch_embeds.shape[1]
        h = torch.cat([patch_embeds.to(h), h[:, P:]], dim=1)
    return h


def _hc(cfg: ModelConfig, h):
    """Between-layer activation constraint; the seq axis shards under
    sequence parallelism (``cfg.seq_shard``)."""
    return constrain(h, "batch", "seq" if cfg.seq_shard else None, None)


def _positions(tokens):
    B, S = tokens.shape
    return torch.arange(S, dtype=torch.int32,
                        device=tokens.device)[None].expand(B, S)


def forward(params, cfg: ModelConfig, tokens, *, patch_embeds=None,
            mrope_pos=None):
    """Full forward. tokens [B,S] -> (logits [B,S,Vp] in the compute dtype,
    the MoE aux loss summed over the layers, fp32).  Head layers run first
    and outside remat, as in the JAX package; a hybrid's shared block runs
    after each full segment, under the same remat policy.  A VLM's
    ``patch_embeds`` and ``mrope_pos`` as in :func:`_embed` and
    ``layers.gqa_forward``."""
    _ported(cfg)
    pos = _positions(tokens)
    h = _hc(cfg, _embed(params, cfg, tokens, patch_embeds))
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    for blk in params.get("head_layers", []):
        h, aux = _block_fwd(cfg, blk, h, pos, mrope_pos)
        aux_total = aux_total + aux
    for _, blk in _run_order(cfg, params):
        h, aux = remat(cfg, _block_fwd, cfg, blk, h, pos, mrope_pos)
        h = _hc(cfg, h)
        aux_total = aux_total + aux
    h = L.rmsnorm(params["final_norm"], h, cfg.rms_eps)
    return _logits(params, cfg, h), aux_total


# --------------------------------------------------------------------------
# Loss / train step


def cross_entropy(logits, targets):
    """Mean next-token cross-entropy over ``targets >= 0``, from fp32
    logits (log-sum-exp less the gold logit)."""
    logits = logits.float()
    mask = (targets >= 0).float()
    tgt = targets.clamp_min(0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tgt[..., None])[..., 0]
    nll = (logz - gold) * mask
    return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)


def loss_fn(params, cfg: ModelConfig, batch):
    """:func:`cross_entropy`, plus ``router_aux_coef`` x the aux loss /
    n_layers for MoE, as the JAX package's; a VLM batch may hold
    ``patch_embeds`` and ``mrope_pos``."""
    logits, aux = forward(params, cfg, batch["tokens"],
                          patch_embeds=batch.get("patch_embeds"),
                          mrope_pos=batch.get("mrope_pos"))
    loss = cross_entropy(logits, batch["targets"])
    if cfg.is_moe:
        loss = loss + cfg.router_aux_coef * aux / max(1, cfg.n_layers)
    return loss


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, n_micro: int,
                    grad_transform=None, loss=None, param_view=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` holds ``tokens`` and ``targets`` [B, S] (numpy or tensors),
    and what else the family's loss reads (``frames``, ``patch_embeds``,
    ``mrope_pos``);
    with ``n_micro`` > 1 it splits into that many microbatches along B,
    whose fp32 gradients are summed in place and divided by ``n_micro``
    (one summed set and one microbatch's are held at a time).  The state's
    parameters and moments are updated in place; ``metrics`` holds
    ``loss``, ``grad_norm`` and ``lr`` as 0-d tensors on the state's
    device.  ``param_view``, where given, maps the parameter tree inside
    the differentiated function (the dry-run's ZeRO all-gather, whose
    backward reduce-scatters the gradients)."""
    loss = loss or loss_fn
    view = param_view or (lambda p: p)

    def value_and_grad(params, mb):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        l = loss(view(tree_unflatten(params, leaves)), cfg, mb)
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
                del g       # one microbatch's gradients at a time
            for g in grads:
                g.div_(n_micro)
            loss_ = loss_ / n_micro
        params, opt, om = adamw_update(
            opt_cfg, params, tree_unflatten(params, grads), state["opt"],
            state["step"], grad_transform=grad_transform)
        new_state = {"params": params, "opt": opt, "step": state["step"] + 1}
        return new_state, {"loss": loss_, **om}

    return train_step


def init_train_state(cfg: ModelConfig, gen=0, device=None, init=None):
    """-> (state, its logical axes): ``{"params", "opt": {"m", "v"},
    "step"}`` on ``device`` (``None``: the card; ``"meta"``: no
    allocation), parameters from ``init`` (default :func:`init_params`),
    fp32 moments at 0, step an int32 0-d tensor.  The axes tree is the JAX
    package's: the moments take the parameters' axes, and a list of
    stacked layers (``layers``, ``enc_layers``) is one dict of axes with a
    leading None (``sharding.stack_axes``)."""
    dev = resolve_device(device)
    params, axes = annotated(init or init_params, cfg, gen, dev)
    axes = {k: stack_axes(v) if k in STACKS else v for k, v in axes.items()}
    state_axes = {"params": axes, "opt": {"m": axes, "v": axes}, "step": ()}
    return train_state(params), state_axes


def train_state(params):
    """A fresh training state around ``params``."""
    dev = tree_leaves(params)[0].device
    return {"params": params, "opt": adamw_init(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


# --------------------------------------------------------------------------
# KV cache, decode and prefill


def _cache_names(cfg: ModelConfig):
    """The per-layer caches: the SSM state and the conv tail for SSM and
    hybrid layers, the latent and the rope key for MLA, else K and V."""
    if _is_ssm(cfg):
        return ("ssm", "conv")
    return ("ckv", "kr") if cfg.attn_kind == "mla" else ("k", "v")


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None):
    """Zero caches, one row per layer (head layers first): K/V [L, batch,
    max_seq, KV, dh] for GQA; for MLA the latent ``ckv`` [L, batch,
    max_seq, r] and the rope key ``kr`` [L, batch, max_seq, rd]; for SSM
    and hybrid layers the fp32 state ``ssm`` [L, batch, H, P, N] and the
    conv tail ``conv`` [L, batch, W-1, xbc], and for a hybrid also the
    shared block's ``attn_k`` / ``attn_v`` [n_apps, batch, max_seq, KV,
    dh], one row per application; all but ``ssm`` in ``cfg.cache_dtype``."""
    _ported(cfg)
    dev = resolve_device(device)
    cd = getattr(torch, cfg.cache_dtype)
    L_, B = cfg.n_layers, batch
    if _is_ssm(cfg):
        xbc = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
        cache = {"ssm": torch.zeros((L_, B, cfg.ssm_heads, cfg.ssm_head_dim,
                                     cfg.ssm_state), dtype=torch.float32,
                                    device=dev),
                 "conv": torch.zeros((L_, B, cfg.ssm_conv - 1, xbc),
                                     dtype=cd, device=dev)}
        if cfg.family == "hybrid":
            for n in ("attn_k", "attn_v"):
                cache[n] = torch.zeros((n_shared_apps(cfg), B, max_seq,
                                        cfg.n_kv_heads, cfg.d_head),
                                       dtype=cd, device=dev)
        return cache
    if cfg.attn_kind == "mla":
        shapes = ((L_, B, max_seq, cfg.kv_lora_rank),
                  (L_, B, max_seq, cfg.qk_rope_dim))
    else:
        shapes = ((L_, B, max_seq, cfg.n_kv_heads, cfg.d_head),) * 2
    return {n: torch.zeros(s, dtype=cd, device=dev)
            for n, s in zip(_cache_names(cfg), shapes)}


def cache_logical_axes(cfg: ModelConfig):
    """The logical axes of :func:`init_cache`'s tensors."""
    if _is_ssm(cfg):
        axes = {"ssm": (None, "batch", "heads", None, None),
                "conv": (None, "batch", None, "ff")}
        if cfg.family == "hybrid":
            axes["attn_k"] = axes["attn_v"] = (None, "batch", "kv_seq", None,
                                               None)
        return axes
    if cfg.attn_kind == "mla":
        return {"ckv": (None, "batch", "kv_seq", None),
                "kr": (None, "batch", "kv_seq", None)}
    return {"k": (None, "batch", "kv_seq", None, None),
            "v": (None, "batch", "kv_seq", None, None)}


def _block_decode(cfg: ModelConfig, blk, h, c0, c1, cache_len: int,
                  mrope_pos=None):
    """One block, one token; ``c0, c1`` the layer's cache rows (K and V,
    the latent and the rope key, or the SSM state and the conv tail),
    written in place; ``mrope_pos`` a VLM's [B, 1, 3] or None."""
    if "ssm" in blk:
        a = L.rmsnorm(blk["norm"], h, cfg.rms_eps)
        y, (state, conv) = SSM.ssm_decode(blk["ssm"], a, cfg, c0, c1)
        c0.copy_(state)
        c1.copy_(conv)
        return h + y
    a = L.rmsnorm(blk["ln1"], h, cfg.rms_eps)
    if cfg.attn_kind == "mla":
        y, _, _ = L.mla_decode(blk["attn"], a, cfg, c0, c1, cache_len)
    else:
        y, _, _ = L.gqa_decode(blk["attn"], a, cfg, c0, c1, cache_len,
                               mrope_pos=mrope_pos)
    h = h + y
    m = L.rmsnorm(blk["ln2"], h, cfg.rms_eps)
    if "moe" in blk:
        return h + MOE.moe_forward(blk["moe"], m, cfg)[0]
    return h + L.mlp_forward(blk["mlp"], m, cfg)


def serve_step(params, cfg: ModelConfig, cache, token, cache_len: int, *,
               mrope_pos=None):
    """token [B] int; cache_len an int -> (logits [B,Vp] fp32, cache), the
    new cache entries written into ``cache`` in place: row ``cache_len``
    of K/V (and of a hybrid's ``attn_k`` / ``attn_v``), the whole SSM state
    and conv tail.  Head layers take cache rows 0 .. n_head - 1, the
    stacked layers the rest; MoE routes the B tokens of the step; a VLM's
    ``mrope_pos`` [B, 1, 3] are the new token's M-RoPE positions (None:
    plain RoPE at ``cache_len``; the JAX package's shared block of a
    hybrid never takes them)."""
    _ported(cfg)
    cache_len = int(cache_len)
    h = constrain(_embed(params, cfg, token[:, None]), "batch", None, None)
    n0, n1 = _cache_names(cfg)
    head = params.get("head_layers", [])
    for i, blk in enumerate(head):
        h = _block_decode(cfg, blk, h, cache[n0][i], cache[n1][i], cache_len,
                          mrope_pos)
    app = 0
    for row, blk in _run_order(cfg, params):
        if row is None:         # a hybrid's shared block: its own K/V rows
            c0, c1 = cache["attn_k"][app], cache["attn_v"][app]
            app += 1
        else:
            c0, c1 = cache[n0][len(head) + row], cache[n1][len(head) + row]
        h = _block_decode(cfg, blk, h, c0, c1, cache_len, mrope_pos)
    h = L.rmsnorm(params["final_norm"], h, cfg.rms_eps)
    return _logits(params, cfg, h)[:, 0].float(), cache


def prefill(params, cfg: ModelConfig, tokens, *, patch_embeds=None,
            mrope_pos=None):
    """tokens [B,S] -> (next-token logits [B,Vp] fp32, cache filled to S);
    a VLM's ``patch_embeds`` and ``mrope_pos`` as in :func:`forward`.

    The logits are those of the last position, S - 1, for every row: a
    shorter prompt padded at the end gets the logits of a pad position (and
    an SSM state that has taken the pad tokens in), as in the JAX package.
    Head layers first; the cache as :func:`init_cache` lays it out, S rows
    long, the SSM state and conv tail those after position S - 1."""
    _ported(cfg)
    pos = _positions(tokens)
    h = _hc(cfg, _embed(params, cfg, tokens, patch_embeds))
    entries, shared_kv = [], []
    for blk in params.get("head_layers", []):
        h, _, e = _block_fwd(cfg, blk, h, pos, mrope_pos, return_cache=True)
        entries.append(e)
    for row, blk in _run_order(cfg, params):
        h, _, e = _block_fwd(cfg, blk, h, pos, mrope_pos, return_cache=True)
        h = _hc(cfg, h)
        (shared_kv if row is None else entries).append(e)
    h = L.rmsnorm(params["final_norm"], h, cfg.rms_eps)
    logits = _logits(params, cfg, h[:, -1:, :])
    cache = {n: torch.stack([e[j] for e in entries])
             for j, n in enumerate(_cache_names(cfg))}
    if shared_kv:
        cache["attn_k"] = torch.stack([kv[0] for kv in shared_kv])
        cache["attn_v"] = torch.stack([kv[1] for kv in shared_kv])
    return logits[:, 0].float(), cache
