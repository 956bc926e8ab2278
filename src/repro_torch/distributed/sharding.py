"""Logical-axis sharding: one place that decides how every tensor shards
(the JAX package's ``distributed/sharding.py``).

The model code annotates tensors with *logical* axis names ("batch",
"heads", "ff", "expert", "kv_seq", ...).  This module maps logical names
onto mesh axes (("pod",) "data", "model") and degrades gracefully: an axis
whose size does not divide the mesh-axis product is left unsharded
(whisper's 8 heads, MQA's single KV head, batch-1 long-context decode).

Meshes are the port's :class:`repro_torch.launch.mesh.Mesh`.  A spec is a
:class:`PartitionSpec`, a tuple with one entry per tensor dim: ``None``, a
mesh-axis name, or a tuple of names (major first).  :class:`Sharding`
pairs a mesh with a spec and gives ``shard_shape``, as ``NamedSharding``
does.  :func:`placements` maps a spec onto DTensor placements, one per mesh
dim, for the dry-run's DTensor trace (``launch/lowering.py``).

Parameters are annotated where they are made: ``ann(t, *axes)`` returns
``t`` itself, so every ``init_*`` keeps returning tensors, and records the
axes when :func:`annotated` runs the init (it stands for the JAX package's
``split_annotations``: ``annotated(init, ...) -> (params, axes)``).  The
port keeps a model's stacked layers as a list of per-layer dicts; its axes
tree holds them as the JAX package does, one dict whose axes carry a
leading ``None`` for the stack (:func:`stack_axes`), and
:func:`stack_layers` gives the matching ``device="meta"`` view of a state,
so that specs and per-device bytes are computed on the JAX package's shapes
(ZeRO may shard the stack dim of a small per-layer leaf).
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Sequence

import torch

from repro_torch.tree import tree_map

# Logical axis -> preferred mesh axes (in order; combined into one spec entry).
RULES: dict = {
    "batch": ("pod", "data"),
    "vocab": ("model",),
    "heads": ("model",),
    "ff": ("model",),
    "expert": ("model",),
    "kv_seq": ("model",),     # KV-cache sequence axis (decode)
    "seq": ("model",),        # activation seq axis (sequence parallelism)
    "seq_data": ("data",),    # sequence sharding over the data axis
    "embed": (),              # d_model stays replicated across 'model'
    None: (),
}

_state = threading.local()


class PartitionSpec(tuple):
    """One entry per tensor dim: None, an axis name or a tuple of names;
    equal to the JAX ``PartitionSpec`` with the same entries (compare
    ``tuple(spec)``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "P" + super().__repr__()


P = PartitionSpec


def _entry_axes(entry):
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


class Sharding:
    """A mesh and a spec (the port's ``NamedSharding``)."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh, self.spec = mesh, PartitionSpec(*spec)

    def shard_shape(self, shape: Sequence[int]):
        """The per-device shape of a tensor of global ``shape``."""
        out = list(shape)
        for d, entry in enumerate(self.spec):
            n = math.prod(mesh_axis_size(self.mesh, a)
                          for a in _entry_axes(entry))
            if out[d] % n:
                raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                                 f"over {entry} ({n})")
            out[d] //= n
        return tuple(out)

    def __eq__(self, other):
        return (isinstance(other, Sharding) and self.spec == other.spec
                and self.mesh == other.mesh)

    def __repr__(self):
        return f"Sharding({dict(self.mesh.shape)}, {self.spec!r})"


def _mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the ambient mesh of :func:`constrain` and of the MoE
    dispatch choice in this thread."""
    prev = _mesh()
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.mesh = prev


def mesh_axis_size(mesh, name: str) -> int:
    return mesh.shape.get(name, 1)


def spec_entry(mesh, dim_size: int, logical: Optional[str]):
    """Mesh axes for one tensor dim; drops axes that don't divide dim_size."""
    axes = [a for a in RULES.get(logical, ()) if a in mesh.axis_names]
    # Greedily keep the longest prefix whose product divides dim_size.
    kept: list = []
    prod = 1
    for a in axes:
        n = mesh_axis_size(mesh, a)
        if n > 1 and dim_size % (prod * n) == 0:
            kept.append(a)
            prod *= n
    if not kept:
        return None
    return tuple(kept) if len(kept) > 1 else kept[0]


def spec_for(mesh, shape: Sequence[int],
             logical: Sequence[Optional[str]]) -> PartitionSpec:
    assert len(shape) == len(logical), (shape, logical)
    return P(*[spec_entry(mesh, s, l) for s, l in zip(shape, logical)])


def sharding_for(mesh, shape: Sequence[int],
                 logical: Sequence[Optional[str]]) -> Sharding:
    return Sharding(mesh, spec_for(mesh, shape, logical))


def placements(mesh, spec: PartitionSpec):
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(d)`` where tensor dim ``d``'s entry names the mesh axis, else
    ``Replicate()``.  An entry of several axes, ``("pod", "data")``,
    shards its dim on each of them; DTensor splits in mesh-dim order, so
    the first axis is the major one, as in the JAX package."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.axis_names:
        dims = [d for d, e in enumerate(spec) if name in _entry_axes(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def constrain(x, *logical: Optional[str]):
    """The sharding constraint against the ambient mesh: a no-op outside
    one, on a one-device mesh and on a plain tensor; a DTensor is
    redistributed to the spec of ``logical`` (the collectives that takes
    are what the dry-run counts)."""
    mesh = _mesh()
    if mesh is None or mesh.size == 1:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = spec_for(mesh, x.shape, logical)
    return x.redistribute(x.device_mesh, placements(mesh, spec))


# ---------------------------------------------------------------------------
# Param trees: leaves annotated at init with logical axes.


def ann(t, *axes):
    """Annotate a freshly made parameter with logical axes -> ``t``; the
    axes are recorded while :func:`annotated` runs the init."""
    assert len(axes) == t.ndim, (tuple(t.shape), axes)
    rec = getattr(_state, "annotations", None)
    if rec is not None:
        rec[id(t)] = (t, tuple(axes))
    return t


def annotated(init, *args, **kwargs):
    """Run ``init(*args, **kwargs)`` -> (its tree, the logical-axes tree):
    each leaf's axes as :func:`ann` gave them.  An unannotated leaf
    raises."""
    prev = getattr(_state, "annotations", None)
    _state.annotations = rec = {}
    try:
        tree = init(*args, **kwargs)
    finally:
        _state.annotations = prev

    def axes_of(t):
        if id(t) not in rec or rec[id(t)][0] is not t:
            raise ValueError(f"a leaf of shape {tuple(t.shape)} has no "
                             f"ann() axes")
        return rec[id(t)][1]

    return tree, tree_map(axes_of, tree)


def stack_axes(per_layer):
    """A list of per-layer axes trees -> one tree whose axes take a leading
    None for the stack (the JAX package's ``_stack`` of annotations)."""
    first = per_layer[0]
    for other in per_layer[1:]:
        if other != first:
            raise ValueError("stacked layers annotate their leaves "
                             "differently")
    return tree_map(lambda ax: (None,) + ax, first)


def _is_axes(x):
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def stack_layers(tree, axes_tree):
    """``tree`` (the port's layout: stacked layers as lists) -> a
    ``device="meta"`` tree in ``axes_tree``'s layout: where the axes hold
    one dict for a list of layers, each leaf becomes ``[n_layers, ...]``."""
    if isinstance(axes_tree, dict):
        if isinstance(tree, list):
            return tree_map(
                lambda *xs: torch.empty((len(xs),) + tuple(xs[0].shape),
                                        dtype=xs[0].dtype, device="meta"),
                *tree)
        return {k: stack_layers(tree[k], axes_tree[k]) for k in axes_tree}
    if isinstance(axes_tree, list):
        return [stack_layers(t, a) for t, a in zip(tree, axes_tree)]
    return torch.empty(tuple(tree.shape), dtype=tree.dtype, device="meta")


def _map_axes(fn, params, axes_tree):
    """``fn(leaf, axes)`` over ``params`` and its axes tree (same layout);
    axes tuples are leaves."""
    if _is_axes(axes_tree):
        return fn(params, axes_tree)
    if isinstance(axes_tree, dict):
        return {k: _map_axes(fn, params[k], axes_tree[k]) for k in axes_tree}
    return [_map_axes(fn, p, a) for p, a in zip(params, axes_tree)]


def _pad_axes(p, ax):
    ax = tuple(ax)
    if len(ax) < p.ndim:  # stacked-layer leading dims added after init
        ax = (None,) * (p.ndim - len(ax)) + ax
    return ax


def tree_shardings(mesh, params, axes_tree):
    """A :class:`Sharding` tree for ``params`` from its logical-axes tree
    (``params`` in the axes' layout: see :func:`stack_layers`)."""
    return _map_axes(lambda p, ax: sharding_for(mesh, p.shape,
                                                _pad_axes(p, ax)),
                     params, axes_tree)


def tree_specs(mesh, params, axes_tree):
    return tree_map(lambda s: s.spec, tree_shardings(mesh, params, axes_tree))


def zero_shardings(mesh, params, axes_tree, *, data_axis: str = "data",
                   min_size: int = 1 << 16):
    """ZeRO-style 2-D parameter sharding: after the logical ('model') rules,
    shard the largest still-unsharded dim of every big tensor over the
    ``data`` axis.  Params, grads and optimizer moments then occupy
    1/(data*model) of their global size per device; the step gathers the
    weights and reduce-scatters the gradients this implies (the ZeRO-3
    pattern).  Sharding stays *within* a pod: the pod axis is untouched, so
    cross-pod links only carry the data-parallel gradient reduction.
    """
    if data_axis not in mesh.axis_names or mesh_axis_size(mesh,
                                                          data_axis) == 1:
        return tree_shardings(mesh, params, axes_tree)
    n = mesh_axis_size(mesh, data_axis)

    def one(p, ax):
        ax = _pad_axes(p, ax)
        spec = [spec_entry(mesh, s, l) for s, l in zip(p.shape, ax)]
        if math.prod(int(s) for s in p.shape) >= min_size:
            # biggest unsharded dim divisible by the data-axis size
            cands = [(s, i) for i, (s, e) in enumerate(zip(p.shape, spec))
                     if e is None and s % n == 0]
            if cands:
                _, i = max(cands)
                spec[i] = data_axis
        return Sharding(mesh, P(*spec))

    return _map_axes(one, params, axes_tree)


def unstack_shardings(shardings, tree):
    """Shardings in the axes' layout (:func:`stack_layers`) -> shardings in
    ``tree``'s layout: each layer of a stacked list takes its stack's spec
    without the leading entry (:func:`_layer_sharding`)."""
    if isinstance(shardings, Sharding):
        return shardings
    if isinstance(shardings, dict):
        if isinstance(tree, list):
            layer = tree_map(_layer_sharding, shardings, tree[0])
            return [layer for _ in tree]
        return {k: unstack_shardings(shardings[k], tree[k])
                for k in shardings}
    return [unstack_shardings(s, t) for s, t in zip(shardings, tree)]


def _layer_sharding(s: Sharding, leaf) -> Sharding:
    """A stack's sharding for one layer's ``leaf``: the spec without the
    stack dim's entry.  Axes on that entry (ZeRO's data shard of a small
    per-layer leaf) move, as the major axes, onto the largest dim of the
    leaf they divide, so that every layer holds its stack's share per
    device; where none divides they are dropped (the layer is then held
    whole along them)."""
    moved, spec = _entry_axes(s.spec[0]), list(s.spec[1:])
    if moved:
        def ways(axes):
            return math.prod(mesh_axis_size(s.mesh, a) for a in axes)
        n = ways(moved)
        cands = [(size, i) for i, (size, e) in enumerate(zip(leaf.shape,
                                                              spec))
                 if size % (ways(_entry_axes(e)) * n) == 0]
        if cands:
            _, i = max(cands)
            spec[i] = moved + _entry_axes(spec[i])
    return Sharding(s.mesh, P(*spec))
