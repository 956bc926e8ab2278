"""Build and load the CUDA flash-attention kernels through the port's build
helper (:mod:`repro_torch.kernels.build`), cached under ``build/`` beside
this file: ``csrc/flash_attention.cu`` (the entry points, the ``mma.sync``
and fp32-pipe bodies) and ``csrc/flash_wgmma.cu`` (the wgmma body), one
nvcc each.

    python -m repro_torch.kernels.flash_attention.build   # build, print ptxas
"""
from __future__ import annotations

import ctypes
import os

from repro_torch.kernels.build import Library


def _declare(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = ([P] * 4 + [I] * 8
                                           + [ctypes.c_float, I, I, I, P])
    lib.flash_attention_launch.restype = I
    lib.flash_attention_max_group.argtypes = [I, I]
    lib.flash_attention_max_group.restype = I
    lib.flash_attention_error_string.argtypes = [I]
    lib.flash_attention_error_string.restype = ctypes.c_char_p


LIB = Library("flash_attention", os.path.dirname(os.path.abspath(__file__)),
              ("flash_attention.cu", "flash_wgmma.cu"), _declare)
SOURCES = LIB.sources
BUILD_INFO = LIB.info
load = LIB.load


if __name__ == "__main__":
    load()
    print(f"built {BUILD_INFO['path']} in {BUILD_INFO['seconds']:.1f}s "
          f"({BUILD_INFO['cpu_seconds']:.1f}s of compiler CPU)")
    print(BUILD_INFO["log"])
