"""Thread-safe Chrome trace-event tracer (Perfetto-viewable).

One process-global tracer collects *events* — spans (complete ``"X"``
duration events), instants, counter samples and flow start/step/end
markers — and :func:`save` writes the standard Chrome trace-event JSON
(``{"traceEvents": [...]}``), which https://ui.perfetto.dev and
``chrome://tracing`` open directly.

Design constraints (this layer stays compiled into the hot path):

* **near-zero overhead when disabled** — every public entry point checks
  one module-global boolean and returns immediately; :func:`span` returns
  the shared :data:`NULL` no-op span (no allocation), so instrumented code
  pays a function call and a branch, nothing else.
  ``benchmarks/obs_overhead.py --check`` gates this (≤2% projected).
* **thread-safe** — events are appended under one lock; timestamps come
  from a single ``time.perf_counter`` origin so spans from any number of
  threads land on one consistent timeline (per-thread lanes via ``tid``).
* **flow IDs** — :func:`new_flow` allocates process-unique IDs;
  ``Span.flow_start/flow_step/flow_end`` emit flow events *inside* the
  span (same thread + a timestamp within the slice), which is how
  Perfetto binds the arrows: a ticket's flow connects its submit span to
  every wave dispatch/kernel/retire span it rode, across threads.

Usage::

    from repro_torch.obs import trace

    trace.enable()
    with trace.span("wave.kernel", args={"rows": 256}) as sp:
        sp.flow_step(fid)          # arrow through this span
        ...
    trace.counter("inflight", 2)
    trace.save("t.json")           # open in ui.perfetto.dev
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, Iterator, List, Optional

__all__ = ["NULL", "Span", "counter", "disable", "enable", "enabled",
           "events", "instant", "isolated", "new_flow", "reset", "save",
           "span"]

_PID = os.getpid()
_T0 = time.perf_counter()

# THE switch: one module-global read gates every emission path.
_on = False

# Secondary sink: the flight recorder (repro.obs.record).  When installed
# it receives every emitted event even while the full tracer is off, so a
# bounded ring of recent history exists to dump on failure.  ``None``
# keeps the disabled fast path a single extra global read.
_rec = None


def _set_recorder(rec) -> None:
    """Install/remove the flight-recorder sink (``repro.obs.record``
    owns this — instrumented code never calls it)."""
    global _rec
    _rec = rec

_lock = threading.Lock()
_events: List[dict] = []
_flow_ids = itertools.count(1)     # itertools.count is GIL-atomic

# Flow events must share one (name, cat) per id chain for the viewers to
# join the arrows; everything in this process is one logical stream.
_FLOW_NAME = "flow"
_FLOW_CAT = "flow"


def _now_us() -> float:
    return (time.perf_counter() - _T0) * 1e6


def _emit(ev: dict) -> None:
    if _on:
        with _lock:
            _events.append(ev)
    r = _rec
    if r is not None:
        r.record(ev)


# ---------------------------------------------------------------------------
# Switch / lifecycle.


def enable() -> None:
    """Turn the process-global tracer on (events start accumulating)."""
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    """The single-branch check instrumented code uses for arg-building
    it wants to skip entirely when tracing is off."""
    return _on


def reset() -> None:
    """Drop every buffered event (the switch state is unchanged)."""
    with _lock:
        _events.clear()


def events() -> List[dict]:
    """A snapshot copy of the buffered events."""
    with _lock:
        return list(_events)


def save(path: str) -> str:
    """Write the buffered events as Chrome trace-event JSON → ``path``."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    meta = [{"name": "process_name", "ph": "M", "pid": _PID, "tid": 0,
             "args": {"name": "repro"}}]
    with _lock:
        payload = {"traceEvents": meta + list(_events),
                   "displayTimeUnit": "ms"}
    with open(path, "w") as f:
        json.dump(payload, f)
        f.write("\n")
    return path


def new_flow() -> int:
    """Allocate a process-unique flow ID (thread-safe)."""
    return next(_flow_ids)


# ---------------------------------------------------------------------------
# Spans.


class Span:
    """One duration event, emitted as a complete ``"X"`` record at exit.

    Created via :func:`span` (never directly) — when tracing is off that
    returns the shared no-op :data:`NULL` instead, so every method here
    can assume the tracer is live.
    """

    __slots__ = ("name", "cat", "args", "_ts", "_tid")

    def __init__(self, name: str, cat: str, args: Optional[dict]):
        self.name = name
        self.cat = cat
        self.args = dict(args) if args else {}
        self._tid = threading.get_ident()
        self._ts = _now_us()

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        _emit({"name": self.name, "cat": self.cat, "ph": "X",
               "ts": self._ts, "dur": _now_us() - self._ts,
               "pid": _PID, "tid": self._tid, "args": self.args})

    def set(self, **kw) -> "Span":
        """Attach args discovered mid-span."""
        self.args.update(kw)
        return self

    # -- flows: arrows binding this span into a cross-thread chain ----------

    def _flow(self, ph: str, fid: int) -> None:
        ev = {"name": _FLOW_NAME, "cat": _FLOW_CAT, "ph": ph, "id": int(fid),
              "ts": _now_us(), "pid": _PID, "tid": self._tid}
        if ph == "f":
            ev["bp"] = "e"        # bind the arrowhead to the enclosing slice
        _emit(ev)

    def flow_start(self, fid: int) -> None:
        self._flow("s", fid)

    def flow_step(self, fid: int) -> None:
        self._flow("t", fid)

    def flow_end(self, fid: int) -> None:
        self._flow("f", fid)


class _NullSpan:
    """The shared disabled-mode span: every operation is a no-op.

    A singleton, so disabled-mode ``span()`` allocates nothing — the
    identity ``span(...) is NULL`` is what the no-allocation test pins.
    """

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        return None

    def set(self, **kw) -> "_NullSpan":
        return self

    def flow_start(self, fid: int) -> None:
        pass

    def flow_step(self, fid: int) -> None:
        pass

    def flow_end(self, fid: int) -> None:
        pass


NULL = _NullSpan()


def span(name: str, cat: str = "repro",
         args: Optional[dict] = None) -> "Span | _NullSpan":
    """Open a span (use as a context manager).  Disabled → :data:`NULL`.

    When the flight recorder is active the real span is created even
    with the tracer off, so the ring sees recent history; the fully-off
    path (no tracer, no recorder) still allocates nothing.
    """
    if not _on and _rec is None:
        return NULL
    return Span(name, cat, args)


def instant(name: str, cat: str = "repro",
            args: Optional[dict] = None) -> None:
    """Mark a point in time (thread-scoped instant event)."""
    if not _on and _rec is None:
        return
    _emit({"name": name, "cat": cat, "ph": "i", "s": "t",
           "ts": _now_us(), "pid": _PID, "tid": threading.get_ident(),
           "args": dict(args) if args else {}})


def counter(name: str, value: float, cat: str = "repro") -> None:
    """Sample a counter track (rendered as a stacked chart in Perfetto)."""
    if not _on and _rec is None:
        return
    _emit({"name": name, "cat": cat, "ph": "C",
           "ts": _now_us(), "pid": _PID, "tid": 0,
           "args": {"value": value}})


@contextlib.contextmanager
def isolated() -> Iterator[None]:
    """Run a block against a private event buffer, then restore.

    Self-measuring code (``benchmarks/obs_overhead.py``) toggles the
    tracer and emits hundreds of thousands of throwaway spans; under an
    outer live capture (``benchmarks.run --trace-out``) that would wipe
    or flood the shared timeline.  Inside this block the outer events
    and switch state are stashed and the buffer starts empty; on exit
    both are restored and everything emitted inside is dropped.
    """
    global _on
    with _lock:
        stash = list(_events)
        _events.clear()
    was_on = _on
    try:
        yield
    finally:
        _on = was_on
        with _lock:
            _events.clear()
            _events.extend(stash)
