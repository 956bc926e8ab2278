"""Forward GQA flash attention: ``ops`` (padding wrapper), ``kernel`` (the
CUDA launcher and its plain version), ``build`` (nvcc + ctypes), ``ref``
(the materialised-scores oracle)."""
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: F401
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    ref_attention_gqa)
