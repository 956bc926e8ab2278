"""The dry-run's versions of a few model functions, which
:func:`repro_torch.launch.lowering.trace_cell` swaps in while it traces
(:func:`overrides`) and puts back when it is done.

On the trace's DTensors (meta or fake local shards, sharded as SPMD shards
them) each does what the JAX package's SPMD partitioning does, where the
port's own function cannot run or DTensor would move whole tensors:

* attention (the flash kernel's wrapper and ``layers._sdpa``) runs the
  kernel's plain math over materialised scores per rank on its local
  shards (:func:`traced_attention`; a CUDA kernel, called through ctypes,
  cannot run on a meta tensor);
* a decode step writes its cache row by a masked select over every row
  (:func:`write_row`), as SPMD updates a sharded dim;
* the loss reduces over the sharded vocab (:func:`cross_entropy`);
* the lock-step WFA loop tests for termination over every shard
  (:func:`lockstep_scores`, which ``build_wfa_cell`` calls itself).

Outside a trace the model runs its own functions; nothing here is reached.
"""
from __future__ import annotations

import contextlib
import math

import torch

NEG_INF = -1e30


@contextlib.contextmanager
def overrides():
    """Install this module's functions in the model's modules, and restore
    the originals on exit."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import encdec, layers, transformer
    swaps = [(ops, "flash_attention_gqa", flash_attention_gqa),
             (layers, "_sdpa", sdpa),
             (layers, "_write_row", write_row),
             (transformer, "cross_entropy", cross_entropy),
             (encdec, "cross_entropy", cross_entropy)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def flash_attention_gqa(q, k, v, *, causal: bool = True, block_q: int = 512,
                        block_k: int = 512):
    """``kernel.flash_attention_gqa`` in the trace: its FLOPs in a few ops
    over materialised scores, where the tile loop would trace thousands."""
    mask = None
    if causal:
        mask = (torch.arange(q.shape[1], device=q.device)[:, None]
                >= torch.arange(k.shape[1], device=k.device)[None, :])
    return traced_attention(q, k, v, mask)


def sdpa(q, k, v, mask, cfg):
    """``layers._sdpa`` in the trace: the same math without splitting the
    (sharded) head dim."""
    return traced_attention(q, k, v, mask.reshape(mask.shape[-2],
                                                  mask.shape[-1]))


def ref_attention_heads(q, k, v, mask=None):
    """``ref.ref_attention_gqa``'s math with K/V repeated over each group's
    heads, so no reshape splits the head dim: a head dim sharded over a
    mesh axis larger than the KV heads splits into (KV, G) in no DTensor
    layout.  q [B,Sq,H,dh]; k/v [B,Sk,KV,dh]; ``mask`` None or
    broadcastable to [B, H, Sq, Sk] -> [B,Sq,H,dh]."""
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    if G > 1:
        k, v = (t[:, :, :, None].expand(B, Sk, KV, G, dh).reshape(
            B, Sk, H, dh) for t in (k, v))
    s = torch.einsum("bqhd,bshd->bhqs", q, k).float() / math.sqrt(dh)
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshd->bqhd", w, v)


def traced_attention(q, k, v, mask=None):
    """:func:`ref_attention_heads`, on DTensors per rank over its local
    shards (``local_map``, as the JAX package's SPMD partitions it: no
    collective where batch or heads shard).  A mesh dim that shards q's
    batch, seq or head dim keeps it and gives K/V the matching batch or
    head shards (replicated under a seq shard); one that shards the keys'
    seq dim and not the queries' (a decode step over a ``kv_seq``-sharded
    cache) gathers the queries and runs the softmax across the key shards:
    two all-reduces of row statistics and one of the output.
    q [B,Sq,H,dh], k/v [B,Sk,KV,dh], ``mask`` None or of Sq x Sk elements
    (batch- and head-independent)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(q, DTensor):
        return ref_attention_heads(q, k, v, mask)
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if H != KV:
        k, v = (t[:, :, :, None].expand(B, Sk, KV, H // KV, dh).reshape(
            B, Sk, H, dh) for t in (k, v))
    mesh = q.device_mesh
    if mask is None:
        mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    mask = mask.reshape(Sq, Sk)
    if not isinstance(mask, DTensor):
        mask = DTensor.from_local(mask, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)
    q_pl, kv_pl, m_pl, split = [], [], [], []
    for i in range(mesh.ndim):
        qp, kp = q.placements[i], k.placements[i]
        q_seq = isinstance(qp, Shard) and qp.dim == 1
        if isinstance(kp, Shard) and kp.dim == 1 and not q_seq:
            q_pl.append(Replicate())
            kv_pl.append(kp)
            m_pl.append(Shard(1))
            split.append(i)
        elif isinstance(qp, Shard) and qp.dim in (0, 1, 2):
            q_pl.append(qp)
            kv_pl.append(Replicate() if q_seq else qp)
            m_pl.append(Shard(0) if q_seq else Replicate())
        else:
            q_pl.append(Replicate())
            kv_pl.append(Replicate())
            m_pl.append(Replicate())

    def local(ql, kl, vl, ml):
        if not split:
            return ref_attention_heads(ql, kl, vl, ml)
        # the softmax across the key shards
        s = torch.einsum("bqhd,bshd->bhqs", ql, kl).float() / math.sqrt(dh)
        s = torch.where(ml, s, NEG_INF)
        groups = [(mesh, i) for i in split]
        m = s.amax(dim=-1, keepdim=True)
        for g in groups:
            m = funcol.all_reduce(m, "max", g)
        p = torch.exp(s - m)
        denom = p.sum(dim=-1)
        o = torch.einsum("bhqs,bshd->bqhd", p.to(ql.dtype), vl).float()
        for g in groups:
            denom = funcol.all_reduce(denom, "sum", g)
            o = funcol.all_reduce(o, "sum", g)
        return (o / denom.permute(0, 2, 1)[..., None]).to(ql.dtype)

    return local_map(local, out_placements=(tuple(q_pl),),
                     in_placements=(tuple(q_pl), tuple(kv_pl), tuple(kv_pl),
                                    tuple(m_pl)),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v,
                                                                 mask)


def write_row(cache, new, pos: int):
    """``layers._write_row`` in the trace: ``cache`` with row ``pos`` of its
    (sharded) sequence dim replaced by ``new[:, 0]``, by a masked select
    over every row, as SPMD updates a sharded dim.  The caller's tensor
    keeps its (meta) values."""
    hit = torch.arange(cache.shape[1], device=new.device) == pos
    hit = hit.reshape((1, -1) + (1,) * (cache.dim() - 2))
    return torch.where(hit, new.to(cache.dtype), cache)


def cross_entropy(logits, targets):
    """``transformer.cross_entropy`` in the trace, the vocab dim sharded:
    the log-sum-exp as max and sum reductions, and the gold logit as a
    select against the target over vocab ids laid out as the logits are,
    which DTensor keeps sharded forward and backward (it gathers whole
    logits for ``logsumexp``, and a gather's backward scatters into zeros
    it makes whole on every rank)."""
    logits = logits.float()
    mask = (targets >= 0).float()
    tgt = targets.clamp_min(0).long()
    m = logits.amax(dim=-1, keepdim=True).detach()
    logz = m[..., 0] + torch.log(torch.exp(logits - m).sum(dim=-1))
    ids = torch.zeros_like(logits, dtype=torch.int32) + torch.arange(
        logits.shape[-1], dtype=torch.int32, device=logits.device)
    hit = ids == tgt[..., None]
    gold = torch.where(hit, logits, 0.0).sum(dim=-1)
    nll = (logz - gold) * mask
    return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)


def lockstep_scores(pattern, text, plen, tlen, *, pen, s_max, k_max,
                    heur=None, device=None):
    """``wavefront.wfa_scores`` over pair-sharded DTensors, as SPMD runs it
    from one global loop: each rank solves its local rows, and every rank
    steps on while a pair of any shard is unscored, so the loop's test is a
    reduction over every shard each step (a max all-reduce).  The greedy
    extension stays local.  -> the result with ``score`` a DTensor of the
    inputs' placements."""
    from torch.distributed.tensor import DTensor, Partial

    from repro_torch.core.wavefront import _solve
    mesh, pl = pattern.device_mesh, pattern.placements

    def left(score):
        here = (score < 0).any().reshape(1).to(torch.int32)
        anywhere = DTensor.from_local(here, mesh,
                                      [Partial("max")] * mesh.ndim)
        return bool(anywhere.full_tensor()[0])

    res = _solve(*(t.to_local() for t in (pattern, text, plen, tlen)), pen,
                 s_max, k_max, heur, None, packed=False, device=device,
                 left=left)
    return res._replace(score=DTensor.from_local(res.score, mesh, pl))
