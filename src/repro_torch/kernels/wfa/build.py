"""Build and load the CUDA WFA kernels (``csrc/wfa.cu``, ``csrc/wfa_meet.cu``).

One shared library through the port's build helper
(:mod:`repro_torch.kernels.build`: one ``nvcc`` per source, started
together, loaded with ``ctypes``), cached under ``build/`` beside this file.

    python -m repro_torch.kernels.wfa.build      # build now, print ptxas
"""
from __future__ import annotations

import ctypes
import os

from repro_torch.kernels.build import FLAGS, Library  # noqa: F401


def _declare(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.wfa_launch.argtypes = [P] * 10 + [I] * 17 + [P]
    lib.wfa_launch.restype = I
    lib.wfa_scratch_ints.argtypes = [I] * 10
    lib.wfa_scratch_ints.restype = ctypes.c_longlong
    lib.wfa_full_shape.argtypes = [I] * 12 + [P]
    lib.wfa_full_shape.restype = I
    lib.wfa_band_launch.argtypes = [P] * 10 + [I] * 16 + [P]
    lib.wfa_band_launch.restype = I
    lib.wfa_band_scratch_ints.argtypes = [I] * 8
    lib.wfa_band_scratch_ints.restype = ctypes.c_longlong
    lib.wfa_error_string.argtypes = [I]
    lib.wfa_error_string.restype = ctypes.c_char_p
    lib.wfa_meet_launch.argtypes = [P] * 17 + [I] * 17 + [P]
    lib.wfa_meet_launch.restype = I
    lib.wfa_meet_scratch_ints.argtypes = [I] * 8
    lib.wfa_meet_scratch_ints.restype = ctypes.c_longlong


LIB = Library("wfa", os.path.dirname(os.path.abspath(__file__)),
              ("wfa.cu", "wfa_meet.cu"), _declare)
SOURCES = LIB.sources
# path, wall seconds, compiler CPU seconds and ptxas log of the library
BUILD_INFO = LIB.info
build = LIB.build
load = LIB.load


if __name__ == "__main__":
    load()
    print(f"built {BUILD_INFO['path']} in {BUILD_INFO['seconds']:.1f}s "
          f"({BUILD_INFO['cpu_seconds']:.1f}s of compiler CPU)")
    print(BUILD_INFO["log"])
