"""A DTensor ``DeviceMesh`` for a port ``Mesh`` over a "fake" process
group: the dry-run's stand-in for the JAX package's placeholder host
devices.

The fake group (``torch.testing``'s ``FakeStore`` and the "fake" backend)
has ``mesh.size`` ranks and this process is rank 0; its collectives return
at once and move nothing, so a trace on it sees rank 0's shapes and every
collective's arguments, not its data.  A process holds one default group:
:func:`fake_device_mesh` makes it and always destroys it on exit.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def fake_device_mesh(mesh, device_type: str = "cpu"):
    """-> the ``DeviceMesh`` of ``mesh``'s shape and axis names over a fake
    group of ``mesh.size`` ranks, for the ``with`` body.  ``device_type``
    names the devices DTensor plans for: with "cuda" it moves a shard
    between dims by an all-to-all, with "cpu" by an all-gather and a chunk
    (Gloo has no all-to-all); local shards on the meta device never reach
    a device of either type."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a default process group exists already; the "
                           "fake mesh needs its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh.size)
    try:
        yield init_device_mesh(device_type, tuple(mesh.axis_sizes),
                               mesh_dim_names=tuple(mesh.axis_names))
    finally:
        dist.destroy_process_group()
