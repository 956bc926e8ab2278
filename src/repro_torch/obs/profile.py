"""`torch.profiler` bridge: device-level traces lined up with our spans.

:func:`profile` wraps a block in ``torch.profiler.profile`` (the
``--profile DIR`` flag on the launchers), recording host and, where a card
is present, CUDA activity, and writes a Chrome trace into ``DIR``
(viewable in Perfetto).  :func:`annotation` opens a named
``torch.profiler.record_function`` range **only while a profile is
active**, so the instrumented hot path (session dispatch, kernel wait)
carries the same stage names in the device trace as in
:mod:`repro_torch.obs.trace`'s host-side timeline.

When no profile is active, :func:`annotation` returns a shared no-op
context manager (no allocation), mirroring the disabled-mode contract of
the tracer.
"""
from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch

__all__ = ["active", "annotation", "profile"]

# Set only while a profile() block is running; annotation() gates on it so
# steady-state code pays one branch when not profiling.
_active = False

_NULL_CTX = contextlib.nullcontext()


def active() -> bool:
    return _active


@contextlib.contextmanager
def profile(outdir: Optional[str]) -> Iterator[None]:
    """Profile the block and write ``outdir/trace.json`` (``None`` →
    no-op, so callers can pass an optional CLI flag straight through)."""
    global _active
    if not outdir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    _active = True
    try:
        with torch.profiler.profile(activities=acts) as prof:
            yield
    finally:
        _active = False
    os.makedirs(outdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(outdir, "trace.json"))


def annotation(name: str):
    """A named ``record_function`` range when a profile is active, else a
    shared no-op context manager."""
    if not _active:
        return _NULL_CTX
    return torch.profiler.record_function(name)
