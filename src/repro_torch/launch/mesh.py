"""Device meshes for the port: a JAX-free ``Mesh`` and its constructors.

The counterpart of the JAX package's ``launch/mesh.py``.  A mesh lists
``torch.device`` entries in row-major order over named axes; the
``shardmap`` backend splits the pair axis into one contiguous slice per
entry, as ``P(axis_names)`` does under ``shard_map``.  An entry may name
the same device more than once: that is the only way to get more than one
shard on the CPU, or on a machine with one card.

Functions, never module-level constants, so importing this module queries
no device.  ``make_production_mesh`` is the dry-run's 16 x 16 (or 2 x 16 x
16) mesh of ``torch.device("meta")`` entries: it plans, it runs nothing
(``distributed.fake_mesh`` gives it a DTensor ``DeviceMesh``).
"""
from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.device import resolve_device

__all__ = ["Mesh", "data_shards", "make_host_mesh", "make_mesh",
           "make_production_mesh", "mesh_devices"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices over named axes; ``devices`` is row-major over
    ``axis_names`` (``len(devices) == prod(axis_sizes)``)."""
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.axis_sizes)} axis sizes")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")
        if len(self.devices) != math.prod(self.axis_sizes):
            raise ValueError(f"a mesh of shape {self.axis_sizes} needs "
                             f"{math.prod(self.axis_sizes)} devices, not "
                             f"{len(self.devices)}")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order (as ``jax.sharding.Mesh``)."""
        return OrderedDict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``shape`` over ``axes``.  ``devices`` (any spelling
    ``torch.device`` takes; repeats allowed) default to every visible
    card, whose count must then equal the mesh's size."""
    shape = tuple(int(n) for n in shape)
    if devices is None:
        resolve_device(None)            # raises without a card
        n = torch.cuda.device_count()
        if n != math.prod(shape):
            raise ValueError(f"a mesh of shape {shape} needs "
                             f"{math.prod(shape)} cards; {n} are visible "
                             f"(pass devices= to repeat one)")
        devices = [torch.device("cuda", i) for i in range(n)]
    return Mesh(tuple(resolve_device(d) for d in devices), tuple(axes), shape)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16 x 16 = 256 cards over ("data", "model"); multi-pod 2 x 16 x 16 =
    512 over ("pod", "data", "model"); every entry the meta device."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh((torch.device("meta"),) * math.prod(shape), axes, shape)


def make_host_mesh(model_parallel: Optional[int] = None,
                   device=None) -> Mesh:
    """Whatever this host has, as a ``("data", "model")`` mesh: every
    visible card for ``device`` None or ``"cuda"``, else one shard on
    ``device`` (``"cpu"`` for the CPU)."""
    if device is None or torch.device(device) == torch.device("cuda"):
        resolve_device(None)            # raises without a card
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [resolve_device(device)]
    n, mp = len(devices), model_parallel or 1
    if n % mp:
        raise ValueError(f"{n} devices do not split into model-parallel "
                         f"groups of {mp}")
    return make_mesh((n // mp, mp), ("data", "model"), devices=devices)


def mesh_devices(mesh: Mesh) -> int:
    return mesh.size


def data_shards(mesh: Mesh) -> int:
    n = 1
    for ax in ("pod", "data"):
        if ax in mesh.axis_names:
            n *= mesh.shape[ax]
    return n
