"""Atomic, keep-k, async checkpoints of nested dicts of tensors (the JAX
package's ``checkpoint/``; same on-disk layout)."""
from repro_torch.checkpoint.manager import (AsyncCheckpointer,  # noqa: F401
                                            all_steps, latest_step, restore,
                                            save)
