"""PyTorch/CUDA port of the batched WFA aligner (``repro``).

The same engine, session and solvers as the JAX package, on tensors with an
explicit ``device``; the WFA kernel is hand-written CUDA C++ for Hopper
(``repro_torch.kernels.wfa``).  Importing this package imports no
submodule: ``from repro_torch.core import AlignmentEngine``.
"""
