"""Distribution: the logical-axis sharding rules (``sharding``), the
dry-run's DTensor mesh over a fake process group (``fake_mesh``) and fault
tolerance (``fault``, the JAX package's ``distributed/fault.py``, copied).
The JAX package's ``compat.py`` (version shims of the JAX mesh API) has no
counterpart in PyTorch."""
from repro_torch.distributed import fault  # noqa: F401
from repro_torch.distributed import sharding  # noqa: F401
