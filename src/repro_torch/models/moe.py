"""Mixture-of-Experts: top-k router and capacity-buffer dispatch (the JAX
package's ``models/moe.py``).

Tokens are scattered into a per-expert buffer ``[E, C, D]`` (slot
positions from a running count per expert over the token-major ``[T*K]``
order), the experts run as batched products over that buffer, and the
outputs are gathered back with the router weights.  Slots past the
capacity ``C`` are dropped: they add zero, as in the JAX package.

Routing, slot positions and drops stay on the device: no host sync and no
shape that depends on the data (``C`` depends only on the token count).
The expert products are ``torch.bmm`` over ``[E, C, .]``, as the JAX
package computes them outside any kernel; the ``"dots"`` remat policy
(``transformer._save_dots``) saves ``aten.mm`` only, so the router product
is kept and the expert products are recomputed, as under JAX's
``dots_with_no_batch_dims_saveable``.

The expert-parallel dispatch (the JAX package's ``moe_forward_ep``, an
``all_to_all`` over a mesh ``model`` axis) waits for the port's sharding
rules (ROADMAP §1, item 7): without a mesh the JAX package takes the
capacity path, and so does the port, ``cfg.moe_ep`` or not.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import _init, init_mlp, mlp_forward


def init_moe(cfg: ModelConfig, gen: torch.Generator, device):
    D, E, Fd = cfg.d_model, cfg.n_experts, cfg.d_expert
    s_in, s_out = 1.0 / math.sqrt(D), 1.0 / math.sqrt(Fd)
    pd = cfg.pdtype()
    p = {"router": _init(gen, (D, E), s_in, pd, device),
         "w1": _init(gen, (E, D, Fd), s_in, pd, device),
         "w3": _init(gen, (E, D, Fd), s_in, pd, device),
         "w2": _init(gen, (E, Fd, D), s_out, pd, device)}
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(cfg, gen, device,
                               d_ff=cfg.n_shared_experts * cfg.d_expert)
    return p


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(math.ceil(cfg.capacity_factor * cfg.top_k * n_tokens
                      / cfg.n_experts))
    return max(8, ((c + 7) // 8) * 8)


def top_k(probs, k: int):
    """``lax.top_k`` over the last axis -> (values, indices): descending,
    ties to the lower index (a stable sort; ``torch.topk`` orders ties
    otherwise)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(router, xt, cfg: ModelConfig):
    """The router: xt [T, D] -> (probs [T, E] fp32, gate_w [T, K]
    renormalised over the chosen experts, gate_e [T, K]).  Logits are the
    compute-dtype product cast to fp32, as in the JAX package."""
    logits = (xt @ router.to(cfg.cdtype())).float()
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_e = top_k(probs, cfg.top_k)
    return probs, gate_w / torch.sum(gate_w, dim=-1, keepdim=True), gate_e


def moe_forward(p, x, cfg: ModelConfig, stats=None):
    """x [B, S, D] -> (y [B, S, D], aux loss fp32 0-d).

    ``stats``, a dict, gathers per call: ``dropped`` (slots past capacity,
    a 0-d device tensor: reading it syncs), ``slots`` (T * K) and
    ``capacity`` (C), each appended to a list under its key."""
    return _moe_forward_pjit(p, x, cfg, stats)


def _moe_forward_pjit(p, x, cfg: ModelConfig, stats=None):
    """The capacity dispatch over all experts (the JAX package's
    baseline)."""
    c = cfg.cdtype()
    B, S, D = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.top_k
    xt = x.reshape(T, D)

    probs, gate_w, gate_e = route(p["router"], xt, cfg)

    # Load-balancing auxiliary loss (Switch/GShard form).
    me = torch.mean(probs, dim=0)                             # [E]
    ce = torch.mean(torch.sum(_one_hot(gate_e, E).float(), dim=1), dim=0)
    aux = E * torch.sum(me * ce)

    C = capacity(cfg, T)
    buf, flat_idx, keep, wf = _dispatch_local(xt, gate_e, gate_w, E, C, D, c)
    g = torch.bmm(buf, p["w1"].to(c))
    u = torch.bmm(buf, p["w3"].to(c))
    out = torch.bmm(F.silu(g) * u, p["w2"].to(c))

    out_flat = out.reshape(E * C, D)
    picked = torch.where(keep[:, None],
                         out_flat[torch.clamp(flat_idx, max=E * C - 1)], 0.0)
    y = torch.sum((picked * wf[:, None]).reshape(T, K, D), dim=1)

    if "shared" in p:
        y = y + mlp_forward(p["shared"], xt, cfg)
    if stats is not None:
        for key, v in (("dropped", torch.sum(~keep)), ("slots", T * K),
                       ("capacity", C)):
            stats.setdefault(key, []).append(v)
    return y.reshape(B, S, D), aux.float()


def _one_hot(idx, n: int):
    """idx [...] -> bool [..., n]; a compare, so no sync (``F.one_hot``
    may check the indices on the host)."""
    return idx[..., None] == torch.arange(n, device=idx.device)


def _dispatch_local(xt, gate_e, gate_w, E, C, D, c):
    """Scatter the tokens into an [E, C, D] buffer -> (buf, flat_idx, keep,
    wf) for the matching combine.  A slot's position is the count of
    earlier slots (token-major over [T*K]) routed to its expert; slots at
    positions >= C go to the drop row E * C, which is cut off."""
    T = xt.shape[0]
    K = gate_e.shape[1]
    ef = gate_e.reshape(-1)                                   # [T*K]
    wf = gate_w.reshape(-1).to(c)
    # the running count per expert, scanned along T*K as the inner axis of
    # an [E, T*K] array (a scan over the outer axis of [T*K, E] takes 80%
    # of deepseek's MoE layer on the H100); a slot's position is its own
    # expert's count less one
    onehot = _one_hot(ef, E).t().contiguous().int()           # [E, T*K]
    pos = torch.cumsum(onehot, dim=1).gather(0, ef[None])[0] - 1
    keep = pos < C
    tok = torch.arange(T, device=xt.device).repeat_interleave(K)
    flat_idx = torch.where(keep, ef * C + torch.clamp(pos, max=C - 1), E * C)
    buf = torch.zeros((E * C + 1, D), dtype=c, device=xt.device)
    buf = buf.index_add(0, flat_idx, xt[tok].to(c))
    return buf[:-1].reshape(E, C, D), flat_idx, keep, wf
