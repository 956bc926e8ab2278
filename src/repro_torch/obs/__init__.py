"""`repro_torch.obs` — tracing, metrics and profiling for the port.

* :mod:`repro_torch.obs.trace` — thread-safe span/instant/counter tracer
  emitting Chrome trace-event JSON (open in https://ui.perfetto.dev); a
  process-global switch makes every entry point one branch when off.
* :mod:`repro_torch.obs.metrics` — counters, gauges and log-bucketed
  latency histograms with Prometheus text exposition.
* :mod:`repro_torch.obs.profile` — the ``torch.profiler`` bridge.
* :mod:`repro_torch.obs.record` — the always-on flight recorder.

Quickstart::

    from repro_torch import obs

    with obs.capture_trace("t.json"):        # enable -> run -> save
        engine.align(patterns, texts)
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional

from repro_torch.obs import metrics, profile, record, trace

__all__ = ["capture_trace", "metrics", "profile", "record", "trace"]


@contextlib.contextmanager
def capture_trace(path: Optional[str]) -> Iterator[None]:
    """Enable tracing for a ``with`` block and save the Chrome-trace JSON
    to ``path`` on exit (``None`` → no-op).

    Nesting-safe: if tracing was already on when the block was entered, it
    stays on at exit."""
    if not path:
        yield
        return
    was_on = trace.enabled()
    trace.enable()
    try:
        yield
    finally:
        trace.save(path)
        if not was_on:
            trace.disable()
