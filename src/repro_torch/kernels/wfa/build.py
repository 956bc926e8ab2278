"""Build and load the CUDA WFA kernel (``csrc/wfa.cu``).

The source is compiled by ``nvcc`` into a shared library with a plain C
interface, at first use, and loaded with ``ctypes`` (no PyTorch headers, so
the build takes seconds).  The library is cached under ``build/`` beside
this file (``REPRO_TORCH_BUILD_DIR`` overrides), keyed by a hash of the
source and the flags, so an edited source is rebuilt.

    python -m repro_torch.kernels.wfa.build      # build now, print ptxas
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCE = os.path.join(CSRC, "wfa.cu")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
BUILD_INFO: dict = {}     # path, seconds, ptxas log of the loaded library


def build_dir() -> str:
    return os.environ.get("REPRO_TORCH_BUILD_DIR") or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA WFA kernel is built on a "
                       "machine with the CUDA toolkit (PATH or CUDA_HOME)")


def build() -> str:
    """Compile the source unless a library of this source+flags exists;
    -> path of the shared library."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(FLAGS).encode()
                                ).hexdigest()[:16]
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"libwfa_{digest}.so")
    if os.path.exists(lib):
        BUILD_INFO.update(path=lib, seconds=0.0, log="(cached)")
        return lib
    tmp = f"{lib}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    BUILD_INFO.update(path=lib, seconds=time.perf_counter() - t0,
                      log=proc.stdout + proc.stderr)
    return lib


def load() -> ctypes.CDLL:
    """The loaded library (built on first call), with typed entry points."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            P, I = ctypes.c_void_p, ctypes.c_int
            lib.wfa_launch.argtypes = [P] * 10 + [I] * 15 + [P]
            lib.wfa_launch.restype = I
            lib.wfa_scratch_ints.argtypes = [I] * 5
            lib.wfa_scratch_ints.restype = ctypes.c_longlong
            lib.wfa_error_string.argtypes = [I]
            lib.wfa_error_string.restype = ctypes.c_char_p
            lib.wfa_max_trace_cells.argtypes = []
            lib.wfa_max_trace_cells.restype = I
            _lib = lib
        return _lib


if __name__ == "__main__":
    load()
    print(f"built {BUILD_INFO['path']} in {BUILD_INFO['seconds']:.1f}s")
    print(BUILD_INFO["log"])
