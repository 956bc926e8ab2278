"""Fault tolerance (the JAX package's ``distributed/fault.py``, copied).
The sharding rules (``distributed/sharding.py``) are not ported yet."""
from repro_torch.distributed import fault  # noqa: F401
