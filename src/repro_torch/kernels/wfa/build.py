"""Build and load the CUDA WFA kernels (``csrc/wfa.cu``, ``csrc/wfa_meet.cu``).

Each source is compiled by its own ``nvcc`` process, all started together,
and the objects are linked into one shared library with a plain C
interface, at first use, and loaded with ``ctypes`` (no PyTorch headers, so
the build takes seconds).  The library is cached under ``build/`` beside
this file (``REPRO_TORCH_BUILD_DIR`` overrides), keyed by a hash of every
source and the flags, so an edited source is rebuilt.

    python -m repro_torch.kernels.wfa.build      # build now, print ptxas
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import resource
import shutil
import subprocess
import threading
import time
from typing import Optional

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCES = tuple(os.path.join(CSRC, f) for f in ("wfa.cu", "wfa_meet.cu"))
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# path, wall seconds, compiler CPU seconds (what one nvcc after another
# would take at least) and ptxas log of the loaded library
BUILD_INFO: dict = {}


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
    """Compile the sources unless a library of these sources+flags exists;
    -> path of the shared library."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"libwfa_{digest}.so")
    if os.path.exists(lib):
        BUILD_INFO.update(path=lib, seconds=0.0, cpu_seconds=0.0,
                          log="(cached)")
        return lib
    tag = f"{digest}.{os.getpid()}"
    t0 = time.perf_counter()
    cpu0 = _children_cpu()
    objs = [os.path.join(out_dir, f"{os.path.basename(src)}.{tag}.o")
            for src in SOURCES]
    procs = [subprocess.Popen([nvcc(), *FLAGS, "-c", "-o", obj, src],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for src, obj in zip(SOURCES, objs)]
    logs = [p.communicate()[0] for p in procs]
    for src, p, log in zip(SOURCES, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {os.path.basename(src)} "
                               f"({p.returncode}):\n{log}")
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run([nvcc(), "-shared", "-o", tmp, *objs],
                          capture_output=True, text=True)
    for obj in objs:
        os.remove(obj)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    BUILD_INFO.update(path=lib, seconds=time.perf_counter() - t0,
                      cpu_seconds=_children_cpu() - cpu0,
                      log="".join(logs) + proc.stdout + proc.stderr)
    return lib


def _children_cpu() -> float:
    ru = resource.getrusage(resource.RUSAGE_CHILDREN)
    return ru.ru_utime + ru.ru_stime


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
            lib.wfa_band_launch.argtypes = [P] * 10 + [I] * 16 + [P]
            lib.wfa_band_launch.restype = I
            lib.wfa_band_scratch_ints.argtypes = [I] * 5
            lib.wfa_band_scratch_ints.restype = ctypes.c_longlong
            lib.wfa_error_string.argtypes = [I]
            lib.wfa_error_string.restype = ctypes.c_char_p
            lib.wfa_max_trace_cells.argtypes = []
            lib.wfa_max_trace_cells.restype = I
            lib.wfa_meet_launch.argtypes = [P] * 16 + [I] * 16 + [P]
            lib.wfa_meet_launch.restype = I
            lib.wfa_meet_scratch_ints.argtypes = [I] * 5
            lib.wfa_meet_scratch_ints.restype = ctypes.c_longlong
            _lib = lib
        return _lib


if __name__ == "__main__":
    load()
    print(f"built {BUILD_INFO['path']} in {BUILD_INFO['seconds']:.1f}s "
          f"({BUILD_INFO['cpu_seconds']:.1f}s of compiler CPU)")
    print(BUILD_INFO["log"])
