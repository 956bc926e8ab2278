"""AdamW and gradient compression on nested dicts of tensors (the JAX
package's ``optim/``)."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_init,  # noqa: F401
                                     adamw_update, global_norm)
from repro_torch.optim import compression  # noqa: F401
