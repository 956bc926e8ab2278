"""The batched WFA kernel: ``ops`` (padding wrapper), ``kernel`` (the CUDA
launcher and its plain version), ``build`` (nvcc + ctypes), ``ref``."""
from repro_torch.kernels.wfa.ops import (wfa_align,  # noqa: F401
                                         wfa_align_trace)
from repro_torch.kernels.wfa.ref import ref_scores  # noqa: F401
