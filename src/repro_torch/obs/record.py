"""Always-on flight recorder: a bounded ring of recent trace events.

Full tracing (``obs.trace.enable()``) is something you turn on for a
run you *planned* to inspect.  The failures worth inspecting — a shed
under load, an ``as_completed`` timeout, a ticket failure, a BiWFA
fallback — happen on runs where it was off.  The flight recorder keeps
the last N span/instant/counter events in a ``collections.deque`` ring
even while the tracer is off, and :func:`dump` writes them as a
Perfetto-viewable Chrome trace (plus a metrics snapshot) the moment
something goes wrong.

Cost model: ``trace._emit`` gains one global read on the fully-off
path; with the recorder active each span pays one dict build and one
GIL-atomic ``deque.append`` (no lock).  ``benchmarks/obs_overhead.py
--check`` holds this inside the same ≤2% disabled-overhead budget as
the bare instrumentation points.

Lifecycle: the recorder is **off by default** (so ``obs.trace``'s
zero-allocation disabled contract holds for plain library use).
Long-running components acquire it refcounted — ``ServeLoop.start()``
calls :func:`acquire`, ``stop()`` calls :func:`release` — and
:func:`enable` turns it on explicitly (e.g. from a launcher flag).
:func:`dump` is a no-op when inactive, so hook sites never guard.

Usage::

    from repro_torch.obs import record as obs_record

    obs_record.enable(capacity=8192)
    ...
    obs_record.dump("shed", {"request": rid})   # -> results/flightrec/...
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Deque, Optional

from . import metrics as obs_metrics
from . import trace as obs_trace

__all__ = ["FlightRecorder", "acquire", "active", "disable", "dump",
           "enable", "get", "release"]

# Where post-mortems land; tests point this at a tmp dir via the env var.
ENV_DIR = "REPRO_FLIGHTREC_DIR"
DEFAULT_DIR = os.path.join("results", "flightrec")
DEFAULT_CAPACITY = 8192
# Repeated failures (a shed storm, a fallback-heavy workload) must not
# turn the recorder into a disk-filling loop: one dump per reason per
# interval.
DEFAULT_MIN_INTERVAL_S = 30.0


class FlightRecorder:
    """Bounded ring of trace events + post-mortem dump writer."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 out_dir: Optional[str] = None,
                 min_interval_s: float = DEFAULT_MIN_INTERVAL_S):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self.out_dir = out_dir or os.environ.get(ENV_DIR, DEFAULT_DIR)
        self.min_interval_s = float(min_interval_s)
        # deque.append with maxlen is GIL-atomic: the hot recording path
        # takes no lock.  The dump path snapshots via list(ring), which
        # is likewise safe against concurrent appends.
        self._ring: Deque[dict] = collections.deque(maxlen=self.capacity)
        self._dump_lock = threading.Lock()
        self._last_dump: dict = {}          # reason -> monotonic ts
        self.n_dumps = 0

    def record(self, ev: dict) -> None:
        """Sink for ``trace._emit`` — called for every emitted event."""
        self._ring.append(ev)

    def __len__(self) -> int:
        return len(self._ring)

    def events(self) -> list:
        return list(self._ring)

    def clear(self) -> None:
        self._ring.clear()

    def dump(self, reason: str, args: Optional[dict] = None,
             path: Optional[str] = None) -> Optional[str]:
        """Write the ring as a Chrome trace post-mortem.

        Returns the written path, or ``None`` when rate-limited.  Safe
        from any thread; never raises on I/O failure (a broken disk
        must not take down the serve loop it is diagnosing).
        """
        now = time.monotonic()
        with self._dump_lock:
            last = self._last_dump.get(reason)
            if last is not None and (now - last) < self.min_interval_s:
                return None
            self._last_dump[reason] = now
            ring = list(self._ring)
            self.n_dumps += 1
        if path is None:
            stamp = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
            fname = f"flightrec_{reason}_{stamp}_{os.getpid()}.json"
            path = os.path.join(self.out_dir, fname)
        marker = {"name": f"flightrec.dump:{reason}", "cat": "flightrec",
                  "ph": "i", "s": "g", "ts": obs_trace._now_us(),
                  "pid": os.getpid(), "tid": threading.get_ident(),
                  "args": dict(args) if args else {}}
        meta = [{"name": "process_name", "ph": "M", "pid": os.getpid(),
                 "tid": 0, "args": {"name": "repro-flightrec"}}]
        payload = {
            "traceEvents": meta + ring + [marker],
            "displayTimeUnit": "ms",
            "flightrec": {"reason": reason,
                          "args": dict(args) if args else {},
                          "n_events": len(ring),
                          "capacity": self.capacity,
                          "ts_unix": time.time()},
            "metrics": obs_metrics.snapshot(),
        }
        try:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(path, "w") as f:
                json.dump(payload, f)
                f.write("\n")
        except OSError:
            return None
        obs_metrics.counter("flightrec_dumps_total",
                            "flight-recorder post-mortems written").inc()
        return path


# ---------------------------------------------------------------------------
# Module-level lifecycle: one process-global recorder, refcounted.

_lock = threading.Lock()
_active: Optional[FlightRecorder] = None
_acquires = 0
_explicit = False


def enable(capacity: int = DEFAULT_CAPACITY, out_dir: Optional[str] = None,
           min_interval_s: float = DEFAULT_MIN_INTERVAL_S) -> FlightRecorder:
    """Explicitly install a recorder (survives component release())."""
    global _active, _explicit
    with _lock:
        _active = FlightRecorder(capacity=capacity, out_dir=out_dir,
                                 min_interval_s=min_interval_s)
        _explicit = True
        obs_trace._set_recorder(_active)
        return _active


def disable() -> None:
    """Remove the recorder unconditionally (drops any refcounts)."""
    global _active, _acquires, _explicit
    with _lock:
        _active = None
        _acquires = 0
        _explicit = False
        obs_trace._set_recorder(None)


def acquire(**kw) -> FlightRecorder:
    """Refcounted activation for long-running components.

    ``ServeLoop.start()`` acquires; ``stop()`` releases.  The first
    acquire installs a default recorder; an explicitly :func:`enable`-d
    one is reused and outlives all releases.
    """
    global _active, _acquires
    with _lock:
        if _active is None:
            _active = FlightRecorder(**kw)
            obs_trace._set_recorder(_active)
        _acquires += 1
        return _active


def release() -> None:
    global _active, _acquires
    with _lock:
        if _acquires > 0:
            _acquires -= 1
        if _acquires == 0 and not _explicit and _active is not None:
            _active = None
            obs_trace._set_recorder(None)


def active() -> Optional[FlightRecorder]:
    return _active


def get() -> Optional[FlightRecorder]:
    return _active


def dump(reason: str, args: Optional[dict] = None) -> Optional[str]:
    """Dump the current ring if a recorder is active; no-op otherwise.

    This is the form hook sites use — no guard needed at the call site.
    """
    rec = _active
    if rec is None:
        return None
    return rec.dump(reason, args)
