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

Expert parallelism (:func:`moe_forward_ep`, the JAX package's
``shard_map`` + ``all_to_all`` dispatch) runs when ``cfg.moe_ep`` is set,
an ambient mesh (``sharding.use_mesh``) has a ``model`` axis above 1 and
the experts split over it, as the JAX package chooses it.  Its body,
:func:`_ep_body`, is written once as a generator that yields at each
collective; :func:`_ep_over_mesh` runs it over a port ``Mesh`` (the shards
in turn, the collectives as copies between the shards' tensors) and
:func:`_ep_dtensor` over the local shards of DTensors (the dry-run's
trace), the collectives functional ones.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (P, _mesh, ann, constrain,
                                              placements)
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import _init, init_mlp, mlp_forward


def init_moe(cfg: ModelConfig, gen: torch.Generator, device):
    D, E, Fd = cfg.d_model, cfg.n_experts, cfg.d_expert
    s_in, s_out = 1.0 / math.sqrt(D), 1.0 / math.sqrt(Fd)
    pd = cfg.pdtype()
    p = {"router": ann(_init(gen, (D, E), s_in, pd, device), None, None),
         "w1": ann(_init(gen, (E, D, Fd), s_in, pd, device), "expert", None,
                   None),
         "w3": ann(_init(gen, (E, D, Fd), s_in, pd, device), "expert", None,
                   None),
         "w2": ann(_init(gen, (E, Fd, D), s_out, pd, device), "expert", None,
                   None)}
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
    ``capacity`` (C, per shard under expert parallelism), each appended to
    a list under its key; the expert-parallel path also appends one record
    per shard and collective to ``collectives`` (:func:`_record`)."""
    if cfg.moe_ep:
        mesh = _mesh()
        if mesh is not None and "model" in mesh.axis_names \
                and mesh.shape["model"] > 1 \
                and cfg.n_experts % mesh.shape["model"] == 0:
            return moe_forward_ep(p, x, cfg, mesh, stats)
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
    buf = constrain(buf, "expert", None, None)
    g = torch.bmm(buf, p["w1"].to(c))
    u = torch.bmm(buf, p["w3"].to(c))
    out = torch.bmm(F.silu(g) * u, p["w2"].to(c))
    out = constrain(out, "expert", None, None)

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


# --------------------------------------------------------------------------
# Expert parallelism


def _record(stats, kind: str, t, group: int, shard: int):
    """Append a collective's record to ``stats["collectives"]``: its kind,
    the bytes of the tensor one shard hands it and the group's size."""
    if stats is not None:
        stats.setdefault("collectives", []).append(
            {"kind": kind, "bytes": t.numel() * t.element_size(),
             "group": group, "shard": shard})


def _ep_body(xs, ps, cfg: ModelConfig, m_idx: int, MP: int, stats=None):
    """One (token shard, expert shard) of the expert-parallel layer, a
    generator: it yields ``(kind, tensor)`` at each collective over the
    ``model`` axis (``"all_to_all"``: dim 0 splits into MP chunks, chunk j
    goes to shard j and the result stacks what each shard sent; ``"all_
    gather"``: concatenated along dim 0; ``"mean"``: over every shard of
    the mesh) and is sent the result; it returns ``(y [Bl, Sl, D], aux,
    dropped slots, C)``.

    The shard's tokens are replicated along ``model``: each expert shard
    routes its own 1/MP slice of them, builds a capacity buffer over all E
    experts, sends each expert shard its E/MP experts' slots, runs its own
    experts over every contributor's slots, sends the outputs back to
    their token owners for the weighted combine, and gathers the token
    block again.  Wire cost: 2 x the routed slots, where the capacity path
    under SPMD all-reduces the whole [E*C, D] buffer."""
    c = cfg.cdtype()
    Bl, Sl, D = xs.shape
    E = cfg.n_experts
    E_loc = E // MP
    T = Bl * Sl
    if T % MP:
        raise ValueError(f"{T} local tokens do not split over {MP} expert "
                         f"shards")
    T_m = T // MP
    xt_m = xs.reshape(T, D)[m_idx * T_m:(m_idx + 1) * T_m]

    probs, gate_w, gate_e = route(ps["router"], xt_m, cfg)
    me = yield "mean", torch.mean(probs, dim=0)
    ce = yield "mean", torch.mean(
        torch.sum(_one_hot(gate_e, E).float(), dim=1), dim=0)
    aux = E * torch.sum(me * ce)

    C = capacity(cfg, T_m)
    buf, flat_idx, keep, wf = _dispatch_local(xt_m, gate_e, gate_w, E, C, D,
                                              c)
    # [E, C, D] -> [MP, E_loc, C, D]: chunk j holds expert shard j's slots;
    # what comes back is indexed by the contributing token shard
    buf = buf.reshape(MP, E_loc, C, D)
    _record(stats, "all_to_all", buf, MP, m_idx)
    buf = yield "all_to_all", buf
    xe = buf.transpose(0, 1).reshape(E_loc, MP * C, D)
    g = torch.bmm(xe, ps["w1"].to(c))
    u = torch.bmm(xe, ps["w3"].to(c))
    out = torch.bmm(F.silu(g) * u, ps["w2"].to(c))
    out = out.reshape(E_loc, MP, C, D).transpose(0, 1).contiguous()
    # return the slots to their token owners: expert-major [E, C, D] again
    _record(stats, "all_to_all", out, MP, m_idx)
    out = yield "all_to_all", out
    out_flat = out.reshape(E * C, D)
    picked = torch.where(keep[:, None],
                         out_flat[torch.clamp(flat_idx, max=E * C - 1)], 0.0)
    y_m = torch.sum((picked * wf[:, None]).reshape(T_m, cfg.top_k, D), dim=1)
    if "shared" in ps:
        y_m = y_m + mlp_forward(ps["shared"], xt_m, cfg)
    _record(stats, "all_gather", y_m, MP, m_idx)
    y = yield "all_gather", y_m
    return y.reshape(Bl, Sl, D), aux.float(), torch.sum(~keep), C


def moe_forward_ep(p, x, cfg: ModelConfig, mesh, stats=None):
    """Expert-parallel MoE over ``mesh``'s token axes ("pod", "data") x
    its ``model`` axis -> (y [B, S, D], aux), the capacity path's result
    where no slot drops (capacity is per shard here, so drops differ).  A
    DTensor ``x`` runs :func:`_ep_dtensor`, a plain one
    :func:`_ep_over_mesh`."""
    from torch.distributed.tensor import DTensor
    run = _ep_dtensor if isinstance(x, DTensor) else _ep_over_mesh
    y, aux, dropped, C = run(p, x, cfg, mesh, stats)
    if stats is not None:
        B, S, _ = x.shape
        for key, v in (("dropped", dropped), ("slots", B * S * cfg.top_k),
                       ("capacity", C)):
            stats.setdefault(key, []).append(v)
    return y, aux


def _shard_params(p, m_idx: int, MP: int, dev):
    """Expert shard ``m_idx``'s parameters on ``dev``: its E/MP experts,
    the router and a shared expert whole."""
    ps = {"router": p["router"].to(dev)}
    for k in ("w1", "w3", "w2"):
        n = p[k].shape[0] // MP
        ps[k] = p[k][m_idx * n:(m_idx + 1) * n].to(dev)
    if "shared" in p:
        ps["shared"] = {k: v.to(dev) for k, v in p["shared"].items()}
    return ps


def _ep_over_mesh(p, x, cfg: ModelConfig, mesh, stats):
    """Every shard of a port ``Mesh`` (axes among "pod", "data", "model";
    devices may repeat, as ``shardmap``'s do) runs :func:`_ep_body` in
    turn, each to its next collective; the collectives move tensors
    between the shards (copies between cards where there are several).
    The batch splits over the token axes; y returns on ``x``'s device."""
    extra = set(mesh.axis_names) - {"pod", "data", "model"}
    if extra:
        raise ValueError(f"expert parallelism runs over pod/data/model mesh "
                         f"axes, not {sorted(extra)}")
    MP = mesh.shape["model"]
    n = mesh.size
    n_tok = n // MP
    B = x.shape[0]
    if B % n_tok:
        raise ValueError(f"batch {B} does not split over {n_tok} token "
                         f"shards")
    Bl = B // n_tok
    # row-major coordinates -> (token shard, expert shard) of each device
    shards = []
    for f, dev in enumerate(mesh.devices):
        coords, rem = {}, f
        for name, size in reversed(list(zip(mesh.axis_names,
                                            mesh.axis_sizes))):
            coords[name] = rem % size
            rem //= size
        i = 0
        for name in ("pod", "data"):
            if name in coords:
                i = i * mesh.shape[name] + coords[name]
        shards.append((i, coords["model"], dev))
    gens, msgs = [], []
    for i, m, dev in shards:
        g = _ep_body(x[i * Bl:(i + 1) * Bl].to(dev),
                     _shard_params(p, m, MP, dev), cfg, m, MP, stats)
        gens.append(g)
        msgs.append(next(g))
    where = {(i, m): f for f, (i, m, _) in enumerate(shards)}
    results = [None] * n
    while any(r is None for r in results):
        kind = msgs[0][0]
        sent = [t for _, t in msgs]
        if kind == "mean":
            total = sum(t.to(sent[0].device) for t in sent) / n
            got = [total.to(dev) for _, _, dev in shards]
        elif kind == "all_to_all":
            got = [torch.stack([sent[where[(i, j)]][m].to(dev)
                                for j in range(MP)])
                   for i, m, dev in shards]
        else:
            got = [torch.cat([sent[where[(i, j)]].to(dev)
                              for j in range(MP)])
                   for i, m, dev in shards]
        for f, g in enumerate(gens):
            try:
                msgs[f] = g.send(got[f])
            except StopIteration as done:
                results[f] = done.value
    y = torch.cat([results[where[(i, 0)]][0].to(x.device)
                   for i in range(n_tok)])
    dropped = sum(r[2].to(x.device) for r in results)
    return y, results[0][1].to(x.device), dropped, results[0][3]


def _ep_dtensor(p, x, cfg: ModelConfig, mesh, stats):
    """:func:`_ep_body` on this rank's local shards of DTensors
    (``local_map``: the inputs are redistributed to the body's layout
    first, as ``shard_map``'s in_specs do), its collectives functional
    ones over the DTensor mesh's ``model`` dim ("mean": an all-gather and
    a mean, so the aux loss keeps its gradient)."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor.experimental import local_map

    # the same function under its newer name where torch has it
    gather = getattr(funcol, "all_gather_single_autograd",
                     funcol.all_gather_tensor_autograd)
    dmesh = x.device_mesh
    MP = mesh.shape["model"]
    dims = {name: d for d, name in enumerate(mesh.axis_names)}
    tok = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    x_pl = placements(mesh, P(tok if len(tok) > 1 else (tok[0] if tok
                                                         else None),
                              None, None))
    rep = placements(mesh, P())
    experts = placements(mesh, P("model", None, None))
    names = ["router", "w1", "w3", "w2"]
    in_pl = [x_pl, rep, experts, experts, experts]
    args = [x] + [p[k] for k in names]
    shared = sorted(p.get("shared", {}))
    for k in shared:
        args.append(p["shared"][k])
        in_pl.append(rep)

    def collective(kind, t):
        if kind == "all_to_all":
            return funcol.all_to_all_single_autograd(
                t, None, None, (dmesh, dims["model"]))
        if kind == "all_gather":
            return gather(t, 0, (dmesh, dims["model"]))
        for name in mesh.axis_names:
            if mesh.shape[name] > 1:
                t = gather(t[None], 0, (dmesh, dims[name])).mean(dim=0)
        return t

    rest = []

    def body(xl, *ws):
        ps = dict(zip(names, ws[:4]))
        if shared:
            ps["shared"] = dict(zip(shared, ws[4:]))
        gen = _ep_body(xl, ps, cfg, dmesh.get_local_rank("model"), MP, stats)
        msg = next(gen)
        while True:
            try:
                msg = gen.send(collective(*msg))
            except StopIteration as done:
                y, aux, *tail = done.value
                rest.extend(tail)            # dropped slots, C: local
                return y, aux

    y, aux = local_map(body, out_placements=(x_pl, rep),
                       in_placements=tuple(in_pl), device_mesh=dmesh,
                       redistribute_inputs=True)(*args)
    return (y, aux, *rest)
