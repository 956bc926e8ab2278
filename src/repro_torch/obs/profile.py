"""`torch.profiler` bridge: device-level traces lined up with our spans.

:func:`profile` wraps a block in ``torch.profiler.profile`` (the
``--profile DIR`` flag on the launchers), recording host and, where a card
is present, CUDA activity, and writes a Chrome trace into ``DIR``
(viewable in Perfetto).  While the block runs, every span of
:mod:`repro_torch.obs.trace` (``wave.scatter``, ``scatter.pack``,
``traceback.walk``, ...) also opens a ``torch.profiler.record_function``
of its name, whether or not the tracer itself is on, so the profiler's
trace alone carries the program's spans as user annotations on the
profiler's own clock.

Outside a profile the spans stay as they are: with the tracer off too,
``trace.span`` still returns the shared no-op span.
"""
from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch

from repro_torch.obs import trace as obs_trace

__all__ = ["active", "profile"]


def active() -> bool:
    """Whether a :func:`profile` block is running (its mirror of the
    spans is installed)."""
    return obs_trace._mirror is not None


@contextlib.contextmanager
def profile(outdir: Optional[str]) -> Iterator[None]:
    """Profile the block and write ``outdir/trace.json`` (``None`` →
    no-op, so callers can pass an optional CLI flag straight through)."""
    if not outdir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        prev = obs_trace._set_mirror(torch.profiler.record_function)
        try:
            yield
        finally:
            obs_trace._set_mirror(prev)
    os.makedirs(outdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(outdir, "trace.json"))
