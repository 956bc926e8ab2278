"""Build and load the port's CUDA kernels: ``nvcc`` + ``ctypes``.

Each kernel package names its sources and C entry points in a
:class:`Library`.  A library is built at first use: one ``nvcc`` process
per source, all started together (:func:`build_all` starts those of several
libraries together too), the objects linked into one shared library with a
plain C interface and loaded with ``ctypes``.  No PyTorch headers are
compiled, so a build takes seconds.  The library is cached under ``build/``
beside its package (``REPRO_TORCH_BUILD_DIR`` overrides), keyed by a hash
of every source and the flags, so an edited source is rebuilt.
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
from typing import Callable, Optional, Sequence

FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built on "
                       "a machine with the CUDA toolkit (PATH or CUDA_HOME)")


def _children_cpu() -> float:
    ru = resource.getrusage(resource.RUSAGE_CHILDREN)
    return ru.ru_utime + ru.ru_stime


class Library:
    """One shared library built from ``sources`` (``.cu`` files of one
    package); ``declare(lib)`` sets the ctypes types of its entry points.

    ``info`` holds, once built or loaded: ``path``, ``seconds`` (wall clock
    of the build it took part in), ``cpu_seconds`` (compiler CPU of that
    build: what one nvcc after another would take at least) and ``log``
    (the ptxas report), or ``seconds`` 0 and ``log`` "(cached)".
    """

    def __init__(self, name: str, package_dir: str, sources: Sequence[str],
                 declare: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.package_dir = package_dir
        self.sources = tuple(os.path.join(package_dir, "csrc", s)
                             for s in sources)
        self._declare = declare
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self.info: dict = {}

    def build_dir(self) -> str:
        return (os.environ.get("REPRO_TORCH_BUILD_DIR")
                or os.path.join(self.package_dir, "build"))

    def path(self) -> str:
        h = hashlib.sha256(" ".join(FLAGS).encode())
        for src in self.sources:
            with open(src, "rb") as f:
                h.update(f.read())
        return os.path.join(self.build_dir(),
                            f"lib{self.name}_{h.hexdigest()[:16]}.so")

    def build(self) -> str:
        """Compile unless a library of these sources and flags exists;
        -> its path."""
        return build_all([self])[0]

    def load(self) -> ctypes.CDLL:
        """The loaded library (built on first call), entry points typed."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(self.build())
                self._declare(lib)
                self._lib = lib
            return self._lib


def build_all(libs: Sequence[Library]) -> list:
    """Build every library of ``libs`` not yet built, one nvcc per source
    of all of them started together; -> their paths."""
    paths = [lib.path() for lib in libs]
    todo = []
    for lib, path in zip(libs, paths):
        if os.path.exists(path):
            if lib.info.get("path") != path:     # built by another process
                lib.info.update(path=path, seconds=0.0, cpu_seconds=0.0,
                                log="(cached)")
        else:
            os.makedirs(lib.build_dir(), exist_ok=True)
            todo.append((lib, path))
    if not todo:
        return paths
    t0 = time.perf_counter()
    cpu0 = _children_cpu()
    jobs = []                    # (lib, source, object, process)
    for lib, path in todo:
        tag = f"{os.path.basename(path)}.{os.getpid()}"
        for src in lib.sources:
            obj = os.path.join(lib.build_dir(),
                               f"{os.path.basename(src)}.{tag}.o")
            jobs.append((lib, src, obj, subprocess.Popen(
                [nvcc(), *FLAGS, "-c", "-o", obj, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs = [p.communicate()[0] for *_, p in jobs]
    failed = [(src, p.returncode, log)
              for (_, src, _, p), log in zip(jobs, logs) if p.returncode]
    if failed:
        for _, _, obj, _ in jobs:
            if os.path.exists(obj):
                os.remove(obj)
        src, rc, log = failed[0]
        raise RuntimeError(f"nvcc failed on {os.path.basename(src)} "
                           f"({rc}):\n{log}")
    for lib, path in todo:
        objs = [obj for owner, _, obj, _ in jobs if owner is lib]
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.run([nvcc(), "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        for obj in objs:
            os.remove(obj)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link of {lib.name} failed "
                               f"({proc.returncode}):\n{proc.stdout}\n"
                               f"{proc.stderr}")
        os.replace(tmp, path)
        lib.info.update(
            path=path, log="".join(log for (owner, *_), log in zip(jobs, logs)
                                   if owner is lib) + proc.stdout + proc.stderr)
    seconds, cpu = time.perf_counter() - t0, _children_cpu() - cpu0
    for lib, _ in todo:
        lib.info.update(seconds=seconds, cpu_seconds=cpu)
    return paths
