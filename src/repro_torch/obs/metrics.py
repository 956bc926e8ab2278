"""Bounded-memory metrics: counters, gauges, log-bucketed histograms.

The registry is the service-health complement of :mod:`repro.obs.trace`'s
timeline: cheap monotonic counters (cache hits, shed requests), gauges
(queue depth, in-flight waves) and **log-bucketed histograms** whose
p50/p95/p99 come from a fixed array of geometric buckets — *not* from an
ever-growing stored sample list, so a week-long server reports the same
percentiles in the same few hundred bytes as a unit test does.

Quantile error is bounded by the bucket ratio: :meth:`Histogram.quantile`
returns the upper edge of the bucket holding the target rank, so the
exact sample satisfies ``q_exact <= quantile(q) < q_exact * factor``
(default factor ``2**0.25`` ≈ +19%) — "within one bucket", which the
test suite pins.

Exposition:

* :func:`render_prometheus` — Prometheus text format (``_bucket``/
  ``_sum``/``_count`` series per histogram plus derived ``_p50/_p95/_p99``
  gauges); :func:`start_http_server` serves it at ``/metrics``.
* :func:`snapshot` / :func:`write_jsonl` — one JSON document per call,
  appended as a line, for offline trending next to ``BENCH_*.json``.

All operations are thread-safe and O(1) (quantiles O(n_buckets)).
"""
from __future__ import annotations

import json
import math
import os
import re
import threading
import time
from typing import Dict, List, Optional

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
           "counter", "gauge", "histogram", "render_prometheus",
           "snapshot", "start_http_server", "write_jsonl"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _sanitize(name: str) -> str:
    return _NAME_RE.sub("_", name)


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "help", "_v", "_lock")

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._v = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> float:
        return self._v

    def expose(self) -> List[str]:
        return [f"{self.name} {self._v:g}"]

    def to_dict(self) -> dict:
        return {"kind": "counter", "value": self._v}


class Gauge:
    """Point-in-time value (set / inc / dec)."""

    __slots__ = ("name", "help", "_v", "_lock")

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._v = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._v -= n

    @property
    def value(self) -> float:
        return self._v

    def expose(self) -> List[str]:
        return [f"{self.name} {self._v:g}"]

    def to_dict(self) -> dict:
        return {"kind": "gauge", "value": self._v}


class Histogram:
    """Log-bucketed histogram with bounded memory.

    ``n_buckets`` geometric buckets span ``(0, lo * factor**(n-1)]``:
    bucket 0 holds samples ``<= lo``, bucket ``i`` holds
    ``(lo * factor**(i-1), lo * factor**i]``, and the last bucket also
    absorbs anything larger (so no sample is ever dropped — the top edge
    just saturates).  Defaults size the latency use case: ``lo=1e-5`` s,
    ``factor=2**0.25``, 96 buckets → ~10 µs to ~170 s at ≤19% bucket
    width.  ``sum``/``count``/``max`` are exact.
    """

    __slots__ = ("name", "help", "lo", "factor", "_log_factor", "_counts",
                 "_sum", "_max", "_count", "_lock")

    kind = "histogram"

    def __init__(self, name: str, help: str = "", *, lo: float = 1e-5,
                 factor: float = 2 ** 0.25, n_buckets: int = 96):
        if lo <= 0 or factor <= 1 or n_buckets < 2:
            raise ValueError("need lo > 0, factor > 1, n_buckets >= 2")
        self.name = name
        self.help = help
        self.lo = float(lo)
        self.factor = float(factor)
        self._log_factor = math.log(self.factor)
        self._counts = [0] * int(n_buckets)
        self._sum = 0.0
        self._max = 0.0
        self._count = 0
        self._lock = threading.Lock()

    # -- recording -----------------------------------------------------------

    def _index(self, v: float) -> int:
        if v <= self.lo:
            return 0
        i = int(math.ceil(math.log(v / self.lo) / self._log_factor - 1e-12))
        return min(i, len(self._counts) - 1)

    def observe(self, v: float) -> None:
        v = float(v)
        i = self._index(v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if v > self._max:
                self._max = v

    # -- reading -------------------------------------------------------------

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def max(self) -> float:
        return self._max

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else float("nan")

    @property
    def n_buckets(self) -> int:
        return len(self._counts)

    def bucket_edge(self, i: int) -> float:
        """Upper edge of bucket ``i``."""
        return self.lo * self.factor ** i

    def counts(self) -> List[int]:
        with self._lock:
            return list(self._counts)

    def quantile(self, q: float) -> float:
        """Upper edge of the bucket holding the rank-``q`` sample
        (``q`` in [0, 1]); NaN when empty.  Within one bucket of exact:
        ``exact <= quantile(q) < exact * factor``."""
        with self._lock:
            total = self._count
            if total == 0:
                return float("nan")
            target = max(1, math.ceil(q * total))
            acc = 0
            for i, c in enumerate(self._counts):
                acc += c
                if acc >= target:
                    # never report past the observed max (the top bucket's
                    # edge can be far above a saturated sample)
                    return min(self.bucket_edge(i), self._max)
        return self._max

    def nbytes(self) -> int:
        """Approximate resident size of the bucket storage — constant for
        the histogram's lifetime (the bounded-memory contract)."""
        return len(self._counts) * 8

    # -- exposition ----------------------------------------------------------

    def expose(self) -> List[str]:
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        out, acc = [], 0
        for i, c in enumerate(counts):
            acc += c
            out.append(f'{self.name}_bucket{{le="{self.bucket_edge(i):g}"}}'
                       f" {acc}")
        out.append(f'{self.name}_bucket{{le="+Inf"}} {total}')
        out.append(f"{self.name}_sum {s:g}")
        out.append(f"{self.name}_count {total}")
        for q, tag in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
            v = self.quantile(q)
            out.append(f"{self.name}_{tag} {v:g}")
        return out

    def to_dict(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            total, s, mx = self._count, self._sum, self._max
        return {"kind": "histogram", "lo": self.lo, "factor": self.factor,
                "counts": counts, "sum": s, "count": total, "max": mx,
                "p50": self.quantile(0.5), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}


class Registry:
    """Name → metric map with get-or-create accessors.

    One process-global :data:`REGISTRY` backs the module-level helpers;
    tests build private registries.  Re-requesting a name returns the
    existing metric (type-checked), so modules can declare their metrics
    at call sites without import-order coupling.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get_or_create(self, cls, name: str, help: str, **kw):
        name = _sanitize(name)
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kw)
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "", **kw) -> Histogram:
        return self._get_or_create(Histogram, name, help, **kw)

    def attach(self, metric) -> None:
        """Register (or replace) an externally-constructed metric under
        its own name — e.g. a :class:`~repro.serve.loop.ServeLoop`'s
        per-instance latency histogram, where the *newest* server is the
        one a scrape should see."""
        with self._lock:
            self._metrics[_sanitize(metric.name)] = metric

    def get(self, name: str):
        return self._metrics.get(_sanitize(name))

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()

    # -- exposition ----------------------------------------------------------

    def render_prometheus(self) -> str:
        """The full registry in Prometheus text exposition format."""
        with self._lock:
            metrics = list(self._metrics.values())
        lines = []
        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(m.expose())
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> dict:
        with self._lock:
            metrics = dict(self._metrics)
        return {"ts_unix": time.time(),
                "metrics": {n: m.to_dict() for n, m in metrics.items()}}

    def write_jsonl(self, path: str) -> str:
        """Append one snapshot as a JSON line → ``path``."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "a") as f:
            json.dump(self.snapshot(), f)
            f.write("\n")
        return path


REGISTRY = Registry()

# Module-level helpers over the process-global registry — what the
# instrumented subsystems call.
counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram
render_prometheus = REGISTRY.render_prometheus
snapshot = REGISTRY.snapshot
write_jsonl = REGISTRY.write_jsonl


def start_http_server(port: int = 9100, registry: Optional[Registry] = None):
    """Serve ``registry`` (default: the global one) at ``/metrics`` on a
    daemon thread → the ``http.server`` instance (``.shutdown()`` stops
    it).  Zero dependencies: the standard Prometheus scrape endpoint for
    an always-on aligner service."""
    import http.server

    reg = REGISTRY if registry is None else registry

    class _Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):                            # noqa: N802 (stdlib API)
            if self.path.rstrip("/") not in ("", "/metrics"):
                self.send_response(404)
                self.end_headers()
                return
            body = reg.render_prometheus().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):                   # silence per-scrape logs
            pass

    srv = http.server.ThreadingHTTPServer(("", int(port)), _Handler)
    th = threading.Thread(target=srv.serve_forever, daemon=True,
                          name="obs-metrics-http")
    th.start()
    return srv
