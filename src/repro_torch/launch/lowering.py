"""Cell construction and tracing for the dry-run (the JAX package's
``launch/lowering.py``): for every (arch x input shape x mesh) cell, the
function, its abstract arguments and their shardings, and one traced run.

``train_*`` traces the train step, ``prefill_*`` prefill, ``decode_*`` /
``long_*`` ``serve_step`` (one new token against a ``seq_len``-deep
cache).  The ``wfa-paper`` workload traces the batched aligner with the
pair axis sharded over every mesh axis.

Where the JAX package lowers ``jax.jit(fn)`` onto placeholder devices and
reads XLA's cost and memory analyses, :func:`trace_cell` places the
arguments as DTensors on a fake process group of the mesh's size
(``distributed.fake_mesh``) and runs ``fn`` once on local shards on the
meta device: no data, rank 0's local shapes.  A dispatch mode
(:class:`TraceCounter`) sees every aten op on rank 0's local shards and
counts

* FLOPs, by ``torch.utils.flop_counter``'s formulas (products and
  convolutions; elementwise work is not counted, as XLA's ``flops`` does
  not weigh it either);
* bytes, the inputs and output of each op that moves data (views move
  none): an unfused count, every intermediate written and read back, where
  XLA's fusions keep some in registers;
* the collectives DTensor and the model issue, with their bytes and group
  sizes (``analysis/collectives.py`` turns them into wire bytes);

and the peak of rank 0's live local storages, the arguments included
(each storage counted from the op that made it until a sweep finds it
freed; DTensor's global-shape propagation tensors, fake ones, are left
out).  A torch trace runs every layer, so its counts need no depth
extrapolation.

On these tensors the model takes the plain versions of its kernels (a
CUDA kernel, called through ctypes, cannot run on a meta tensor):
attention the flash kernel's plain math over materialised scores, per
rank over its local shards, whose FLOPs equal the kernel's and whose bytes
are the unfused ones.  The ``wfa-paper`` cells run real data instead: the
ring solver decides when it stops from the scores, so rank 0's shard of a
seeded batch runs on the CPU.

The counts are DTensor's partitioning of the step, not XLA's.  Where
DTensor's own choices would move whole tensors that SPMD keeps in place,
the trace does what SPMD does: a partial sum is reduced at once
(:func:`_settle`; a weight gradient stays partial for the ZeRO gather's
backward to reduce-scatter); ZeRO-sharded weights are gathered to their
logical layout inside the differentiated step (``build_lm_cell``); and
while it traces, :func:`trace_cell` swaps in ``traced_ops``' attention per
rank, masked-select cache write and vocab-sharded loss
(``traced_ops.overrides``).  An op DTensor cannot shard at all is run on
inputs replicated along one mesh dim after another and counted in
``replicated_ops``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import Counter
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.collectives import (collective_bytes, op_histogram,
                                              wire_bytes)
from repro_torch.core.engine import problem_bounds
from repro_torch.distributed.fake_mesh import fake_device_mesh
from repro_torch.distributed.sharding import (P, Sharding, placements,
                                              sharding_for, stack_layers,
                                              tree_shardings,
                                              unstack_shardings, use_mesh,
                                              zero_shardings)
from repro_torch.launch import traced_ops
from repro_torch.launch.mesh import data_shards, mesh_devices
from repro_torch.models.common import ModelConfig, ShapeSpec, num_microbatches
from repro_torch.models.registry import (abstract_train_state,
                                         batch_logical_axes, batch_specs,
                                         decode_logical_axes, decode_specs,
                                         get_model_fns)
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.tree import tree_map


@dataclasses.dataclass
class Cell:
    """``args`` / ``in_shardings``: the abstract (``device="meta"``)
    arguments and their shardings in the JAX package's layout (stacked
    layers), which the per-device byte count reads; ``run_args`` /
    ``run_shardings``: the same in the port's layout, which ``fn`` takes
    and the trace places.  ``local_args``, where set, makes rank 0's real
    local shards (``run_args``' layout) for a trace on data."""
    name: str
    fn: Callable
    args: Tuple[Any, ...]
    in_shardings: Tuple[Any, ...]
    run_args: Tuple[Any, ...]
    run_shardings: Tuple[Any, ...]
    meta: Dict[str, Any]
    local_args: Optional[Callable] = None


def _batch_shardings(mesh, specs, axes):
    return {k: sharding_for(mesh, v.shape, tuple(axes[k]))
            for k, v in specs.items()}


def _no_grad(fn):
    def run(*args):
        with torch.no_grad():
            return fn(*args)
    return run


def build_lm_cell(cfg: ModelConfig, shape: ShapeSpec, mesh,
                  opt_cfg: Optional[AdamWConfig] = None,
                  mode: str = "memory", zero: bool = True) -> Cell:
    """``mode``: ``"memory"``, the production step (microbatched); or
    ``"roofline"``, the same math in one batch with unchunked attention
    (the JAX package's accounting lowering).  A torch trace counts either
    exactly; the two differ in the peak they show."""
    assert mode in ("memory", "roofline"), mode
    if mode == "roofline":
        cfg = cfg.replace(unroll_layers=True, q_chunk=shape.seq_len,
                          microbatch_tokens=1 << 40)
    fns = get_model_fns(cfg)
    state, state_axes = abstract_train_state(cfg)
    stacked = stack_layers(state, state_axes)
    params_sh = tree_shardings(mesh, stacked["params"], state_axes["params"])
    run_params_sh = unstack_shardings(params_sh, state["params"])
    name = f"{cfg.name}:{shape.name}"

    if shape.kind == "train":
        n_micro = num_microbatches(cfg, shape, data_shards(mesh))
        # ZeRO 2-D state sharding; `zero=False` is the recorded baseline.
        # The step gathers each weight to its logical (tensor-parallel)
        # layout where the loss uses it; the gradient comes back through
        # the gather's backward, a reduce-scatter to the ZeRO layout.
        tp = tree_map(lambda s: placements(mesh, s.spec), run_params_sh)
        gather = lambda params: tree_map(
            lambda p, pl: p.redistribute(p.device_mesh, pl), params, tp)
        step = fns.make_train_step(cfg, opt_cfg or AdamWConfig(), n_micro,
                                   param_view=gather if zero else None)
        b = batch_specs(cfg, shape)
        b_sh = _batch_shardings(mesh, b, batch_logical_axes(cfg, shape))
        state_sh = (zero_shardings(mesh, stacked, state_axes) if zero
                    else tree_shardings(mesh, stacked, state_axes))
        return Cell(name=name, fn=step, args=(stacked, b),
                    in_shardings=(state_sh, b_sh), run_args=(state, b),
                    run_shardings=(unstack_shardings(state_sh, state), b_sh),
                    meta={"kind": "train", "n_micro": n_micro, "mode": mode})

    if shape.kind == "prefill":
        b = batch_specs(cfg, shape)
        b_sh = _batch_shardings(mesh, b, batch_logical_axes(cfg, shape))
        if cfg.family == "encdec":
            keys = ("tokens", "frames")
            fn = lambda params, tokens, frames: fns.prefill(
                params, cfg, tokens, frames)
        elif cfg.family == "vlm":
            keys = ("tokens", "patch_embeds", "mrope_pos")
            fn = lambda params, tokens, pe, mp: fns.prefill(
                params, cfg, tokens, patch_embeds=pe, mrope_pos=mp)
        else:
            keys = ("tokens",)
            fn = lambda params, tokens: fns.prefill(params, cfg, tokens)
        rest = tuple(b[k] for k in keys)
        rest_sh = tuple(b_sh[k] for k in keys)
        return Cell(name=name, fn=_no_grad(fn),
                    args=(stacked["params"],) + rest,
                    in_shardings=(params_sh,) + rest_sh,
                    run_args=(state["params"],) + rest,
                    run_shardings=(run_params_sh,) + rest_sh,
                    meta={"kind": "prefill", "mode": mode})

    # decode: one token at the last row of the cache
    d = decode_specs(cfg, shape)
    d_axes = decode_logical_axes(cfg)
    cache_sh = _batch_shardings(mesh, d["cache"], d_axes["cache"])
    tok_sh = sharding_for(mesh, d["token"].shape, ("batch",))
    len_sh = Sharding(mesh, P())
    pos = shape.seq_len - 1
    if cfg.family == "vlm":
        mp_sh = sharding_for(mesh, d["mrope_pos"].shape,
                             ("batch", None, None))
        fn = lambda params, cache, token, cache_len, mp: fns.serve_step(
            params, cfg, cache, token, pos, mrope_pos=mp)
        rest = (d["cache"], d["token"], d["cache_len"], d["mrope_pos"])
        rest_sh = (cache_sh, tok_sh, len_sh, mp_sh)
    else:
        fn = lambda params, cache, token, cache_len: fns.serve_step(
            params, cfg, cache, token, pos)
        rest = (d["cache"], d["token"], d["cache_len"])
        rest_sh = (cache_sh, tok_sh, len_sh)
    return Cell(name=name, fn=_no_grad(fn),
                args=(stacked["params"],) + rest,
                in_shardings=(params_sh,) + rest_sh,
                run_args=(state["params"],) + rest,
                run_shardings=(run_params_sh,) + rest_sh,
                meta={"kind": "decode", "mode": mode})


def build_wfa_cell(workload, mesh, *, edit_frac: Optional[float] = None,
                   pairs_per_device: Optional[int] = None,
                   variant: str = "pjit", seed: int = 0) -> Cell:
    """The paper's own workload: batched WFA, pair axis over all mesh axes.

    ``variant="pjit"`` is ``wfa_scores`` on pair-sharded DTensors
    (``traced_ops.lockstep_scores``): every
    shard's loop ends when no pair of any shard is left, a small all-reduce
    a step (the lock-step baseline); ``"shard_map"`` is
    ``wfa_scores_shardmap``, each shard to its own termination, with no
    collective.  The trace runs rank 0's shard of a batch made from
    ``seed`` (``data.reads.generate_shard``)."""
    from repro_torch.core.wavefront import wfa_scores_shardmap
    from repro_torch.data.reads import ReadPairSpec, generate_shard
    from repro_torch.launch.mesh import make_mesh

    ef = edit_frac if edit_frac is not None else workload.edit_frac
    ppd = pairs_per_device or workload.pairs_per_device
    n_dev = mesh_devices(mesh)
    B = ppd * n_dev
    L = workload.read_len
    Lpad = ((L + 127) // 128) * 128
    fake = np.full((1,), L, np.int32)
    s_max, k_max = problem_bounds(workload.pen, fake, fake, ef)

    if variant == "shard_map":
        one = make_mesh((1,), ("pairs",), devices=["cpu"])

        def fn(pattern, text, plen, tlen):
            # shard_map's per-device program: this shard alone
            local = [t.to_local() for t in (pattern, text, plen, tlen)]
            return wfa_scores_shardmap(*local, pen=workload.pen,
                                       s_max=s_max, k_max=k_max, mesh=one)
    else:
        def fn(pattern, text, plen, tlen):
            return traced_ops.lockstep_scores(
                pattern, text, plen, tlen, pen=workload.pen, s_max=s_max,
                k_max=k_max, device="cpu").score

    def local_args():
        spec = ReadPairSpec(n_pairs=B, read_len=L, edit_frac=ef, seed=seed)
        pat, plen, txt, tlen = generate_shard(spec, 0, n_dev)
        pad = lambda a: np.pad(a, ((0, 0), (0, Lpad - a.shape[1])))
        return tuple(torch.from_numpy(np.ascontiguousarray(a))
                     for a in (pad(pat), pad(txt), plen, tlen))

    pair = Sharding(mesh, P(tuple(mesh.axis_names)))
    seq = torch.empty((B, Lpad), dtype=torch.int32, device="meta")
    lens = torch.empty((B,), dtype=torch.int32, device="meta")
    args = (seq, seq, lens, lens)
    return Cell(name=f"wfa-paper:E{int(ef * 100)}:{variant}", fn=fn,
                args=args, in_shardings=(pair,) * 4, run_args=args,
                run_shardings=(pair,) * 4,
                meta={"kind": "align", "pairs": B, "s_max": s_max,
                      "k_max": k_max, "edit_frac": ef, "variant": variant},
                local_args=local_args)


# ---------------------------------------------------------------------------
# The trace


# the live-storage count frees what died every SWEEP ops: the peak may
# hold up to SWEEP ops' worth of freed temporaries
SWEEP = 8

_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute",
}


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


class TraceCounter(TorchDispatchMode):
    """Counts the aten ops that run on plain (local) tensors: FLOPs, bytes
    in and out, an op histogram and the functional collectives with their
    result bytes and group sizes.  An op on DTensors is handed back
    (``NotImplemented``) so that DTensor runs it as local ops and
    collectives, which come through here, as ``CommDebugMode`` does."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.flop_registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.ops: Counter = Counter()
        self.collectives: list = []
        self.replicated: Counter = Counter()
        self.keep: frozenset = frozenset()
        self.live: dict = {}
        self.current = self.peak = 0
        self._ops_since_sweep = 0
        self._handing_back = False
        self._op = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch._subclasses.fake_tensor import FakeTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            if self._handing_back:
                self._handing_back = False
                return NotImplemented
            return self._dtensor_op(func, args, kwargs)
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types) or any(
                isinstance(t, FakeTensor) for t in _tensors(out)):
            # DTensor's shape propagation on global fake tensors: no work
            return out
        packet = func._overloadpacket
        name = packet.__name__
        self.ops[name] += 1
        ns = func.namespace
        if ns.startswith("_c10d_functional") or ns in ("c10d", "_dtensor"):
            kind = _COLLECTIVES.get(name)
            if kind is not None:
                self.collectives.append(
                    {"kind": kind, "bytes": _nbytes(out),
                     "group": _group_size(args), "op": self._op})
            return out
        if packet in self.flop_registry:
            self.flops += int(self.flop_registry[packet](
                *args, **kwargs, out_val=out))
        if not func.is_view:
            self.bytes += _nbytes(args) + _nbytes(list(kwargs.values())) \
                + _nbytes(out)
        self.hold(_tensors(out))
        return out

    def hold(self, tensors):
        """Count the storages of ``tensors`` live from now until they are
        freed (checked every SWEEP ops) toward ``peak``."""
        from torch.multiprocessing.reductions import StorageWeakRef
        for t in tensors:
            ref = StorageWeakRef(t.untyped_storage())
            if ref.cdata not in self.live:
                self.live[ref.cdata] = (ref, t.untyped_storage().nbytes())
                self.current += self.live[ref.cdata][1]
        self._ops_since_sweep += 1
        if self._ops_since_sweep >= SWEEP:
            self._ops_since_sweep = 0
            for key, (ref, n) in list(self.live.items()):
                if ref.expired():
                    del self.live[key]
                    self.current -= n
        self.peak = max(self.peak, self.current)

    def _dtensor_op(self, func, args, kwargs):
        """Run a DTensor op with this mode pushed again, so that its local
        ops and collectives come back here (each collective records the
        op that issued it).  Where DTensor has no sharding for it (a view
        that splits a sharded dim unevenly, say), the inputs' mesh dims are
        replicated one at a time from the last until it runs, and the op is
        counted in ``replicated``: the trace finishes, at the cost of the
        all-gathers that takes."""
        outer, self._op = self._op, func._overloadpacket.__name__
        try:
            return self._run_dtensor_op(func, args, kwargs)
        finally:
            self._op = outer

    def _run_dtensor_op(self, func, args, kwargs):
        from torch.distributed.tensor import DTensor, Replicate

        def run(a, kw):
            with self:
                self._handing_back = True
                try:
                    return _settle(func(*a, **kw), self.keep)
                finally:
                    self._handing_back = False

        def rep(a, dim):
            if isinstance(a, DTensor) and not a.placements[dim].is_replicate():
                pl = list(a.placements)
                pl[dim] = Replicate()
                with self:
                    return a.redistribute(a.device_mesh, pl)
            if isinstance(a, (list, tuple)):
                return type(a)(rep(x, dim) for x in a)
            return a

        try:
            return run(args, kwargs)
        except (RuntimeError, NotImplementedError):
            if func._schema.is_mutable:
                raise
            ndim = next(a for a in _tensors(list(args) + list(kwargs.values()))
                        if isinstance(a, DTensor)).device_mesh.ndim
        self.replicated[func._overloadpacket.__name__] += 1
        for dim in reversed(range(ndim)):
            args = rep(args, dim)
            kwargs = {k: rep(v, dim) for k, v in kwargs.items()}
            try:
                return run(args, kwargs)
            except (RuntimeError, NotImplementedError):
                if dim == 0:
                    raise


def _settle(out, keep=frozenset()):
    """Reduce a partial result at once (an all-reduce), as SPMD reduces a
    product over a sharded contraction dim; DTensor would keep it partial
    as long as it can and then move whole weights to it.  A result of an
    argument's shape (``keep``: a weight gradient) stays partial: the ZeRO
    gather's backward reduce-scatters it into the weight's layout.  A
    masked partial (an index into a vocab-sharded dim: the embedding) is
    reduced too, as DTensor cannot carry its mask through later views."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not isinstance(out, DTensor):
        return out
    pl = out.placements
    if not any(isinstance(p, Partial) and (hasattr(p, "mask_buffer")
                                           or tuple(out.shape) not in keep)
               for p in pl):
        return out
    return out.redistribute(out.device_mesh, [
        Replicate() if isinstance(p, Partial) else p for p in pl])


def _by_op(records, top: int = 8) -> Dict[str, float]:
    """Wire bytes per (kind, issuing DTensor op; "-" for a redistribute the
    model or the ZeRO gather asked for), the ``top`` largest."""
    out: Counter = Counter()
    for r in records:
        out[f"{r['kind']}:{r['op'] or '-'}"] += wire_bytes(
            r["kind"], r["bytes"], r["group"])
    return dict(out.most_common(top))


def _group_size(args) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in reversed(args):
        if isinstance(a, str):
            return _resolve_process_group(a).size()
    raise ValueError("a collective without a group name")


def _contiguous_stride(shape):
    stride, acc = [], 1
    for s in reversed(shape):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def _place(meta, sharding: Sharding, mesh, dmesh, local=None):
    """A DTensor of ``meta``'s global shape with ``sharding``, its local
    shard ``local`` or an empty one (fake under ``FakeTensorMode``)."""
    from torch.distributed.tensor import DTensor
    shape = tuple(meta.shape)
    if local is None:
        local = torch.empty(sharding.shard_shape(shape), dtype=meta.dtype,
                            device="meta")
    return DTensor.from_local(local, dmesh, placements(mesh, sharding.spec),
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def trace_cell(cell: Cell, mesh) -> dict:
    """Run ``cell.fn`` once on DTensors over a fake group of the mesh's size
    -> per-device ``flops_per_device``, ``bytes_per_device``, the
    ``collectives`` (wire bytes per kind, ``collective_bytes``),
    ``collective_records`` (their count), ``collectives_by_op``,
    ``op_histogram``, ``replicated_ops``, ``peak_bytes_per_device``
    (the live local storages at their most, the arguments included), the
    arguments' own
    ``traced_arg_bytes_per_device`` and ``trace_s``."""
    from torch.distributed.tensor.experimental import implicit_replication

    t0 = time.time()
    counter = TraceCounter()
    real = cell.local_args is not None
    with fake_device_mesh(mesh, "cpu" if real else "cuda") as dmesh, \
            use_mesh(mesh), \
            implicit_replication(), \
            traced_ops.overrides():
        locals_ = list(cell.local_args()) if real else None
        leaves = []

        def place(m, s):
            t = _place(m, s, mesh, dmesh,
                       locals_.pop(0) if real else None)
            leaves.append(t)
            return t

        args = tuple(tree_map(place, a, s)
                     for a, s in zip(cell.run_args, cell.run_shardings))
        counter.keep = frozenset(tuple(t.shape) for t in leaves)
        counter.hold([t.to_local() for t in leaves])
        with counter:
            cell.fn(*args)
    arg_bytes = sum(t.to_local().numel() * t.to_local().element_size()
                    for t in leaves)
    return {"flops_per_device": float(counter.flops),
            "bytes_per_device": float(counter.bytes),
            "collectives": collective_bytes(counter.collectives),
            "collective_records": len(counter.collectives),
            "collectives_by_op": _by_op(counter.collectives),
            "op_histogram": op_histogram(counter.ops),
            "replicated_ops": dict(counter.replicated),
            "peak_bytes_per_device": int(counter.peak),
            "traced_arg_bytes_per_device": int(arg_bytes),
            "trace_s": round(time.time() - t0, 2)}
