"""Trace analysis: phase accounting, critical paths, pipeline bubbles.

This is the *consumption* side of ``repro_torch.obs``, a copy of the JAX
package's ``obs/analyze.py``: a typed loader for the Chrome-trace JSON that
``obs.trace.save`` (and the flight recorder) writes, plus the analyses the
paper's evaluation is built on.  The port's session emits the same span,
counter and flow vocabulary, so its captures read as they are:

* **Phase accounting** — per-wave span time grouped into the paper's
  Fig. 1 split.  Our spans map onto it as
  ``wave.scatter`` → CPU→DPU *transfer*, ``wave.kernel`` → *kernel*,
  ``wave.gather``/``wave.traceback`` → DPU→CPU *retrieve* (+ host
  post-processing).  :func:`phase_accounting` reproduces that
  breakdown from any capture.
* **Critical paths** — the session's flow arrows connect one ticket's
  submit span to every wave it rode, across threads.
  :func:`critical_paths` rebinds each flow point to its enclosing span
  and reports per-segment busy/wait time, i.e. where a request's
  latency actually went.
* **Pipeline analysis** — :func:`pipeline_analysis` reconstructs busy
  intervals from the ``inflight_waves`` counter track (waves in flight
  as the host sees them, not the card's own busy time), reports idle
  **bubbles** between waves, time-weighted mean inflight depth, and how
  much host-side packing/gather overlapped waves in flight.
* **Diffing** — :func:`diff_phase_tables` / :func:`diff_rows` attribute
  a regression between two captures (trace JSON or ``BENCH_*.json``
  snapshots) to the (suite, phase) that moved.

Stdlib-only and side-effect-free: importing or running the analyzer
never touches the process-global tracer.
"""
from __future__ import annotations

import bisect
import json
import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["Bubble", "CounterPoint", "FlowPath", "InstantPoint",
           "PathSegment", "PhaseDelta", "PhaseStat", "PhaseTable",
           "PipelineReport", "RowDelta", "SpanEvent", "Trace",
           "critical_paths", "diff_phase_tables", "diff_rows",
           "phase_accounting", "pipeline_analysis", "slow_waves",
           "PAPER_PHASE", "SPAN_PHASE"]

# Span name → phase bucket.  The wave lifecycle spans are the
# accounting unit; everything else (session.submit, serve.*) shows up
# in critical paths but not the phase table.
SPAN_PHASE: Dict[str, str] = {
    "wave.scatter": "scatter",
    "wave.kernel": "kernel",
    "wave.gather": "gather",
    "wave.traceback": "traceback",
}

# Phase bucket → the paper's Fig. 1 terminology (CPU-DPU transfer /
# DPU kernel / DPU-CPU retrieval).  Traceback is host post-processing
# folded into the retrieve side, as in the framework paper's accounting.
PAPER_PHASE: Dict[str, str] = {
    "scatter": "transfer (CPU->DPU)",
    "kernel": "kernel (DPU)",
    "gather": "retrieve (DPU->CPU)",
    "traceback": "retrieve/host traceback",
}

PHASE_ORDER = ("scatter", "kernel", "gather", "traceback")


# ---------------------------------------------------------------------------
# Typed events + loader.


@dataclass(frozen=True)
class SpanEvent:
    name: str
    cat: str
    ts: float              # microseconds, trace origin
    dur: float
    tid: int
    args: dict = field(default_factory=dict)

    @property
    def end(self) -> float:
        return self.ts + self.dur


@dataclass(frozen=True)
class FlowPoint:
    id: int
    ph: str                # "s" | "t" | "f"
    ts: float
    tid: int


@dataclass(frozen=True)
class CounterPoint:
    name: str
    ts: float
    value: float


@dataclass(frozen=True)
class InstantPoint:
    name: str
    ts: float
    tid: int
    args: dict = field(default_factory=dict)


class Trace:
    """Typed view over one Chrome-trace capture.

    Spans are kept per-tid sorted by start time so enclosing-span
    lookups are ``O(log n + depth)``; flow points are grouped by id in
    timeline order.
    """

    def __init__(self, spans: Sequence[SpanEvent],
                 flows: Sequence[FlowPoint],
                 counters: Sequence[CounterPoint],
                 instants: Sequence[InstantPoint]):
        self.spans = sorted(spans, key=lambda s: s.ts)
        self.flows = sorted(flows, key=lambda p: p.ts)
        self.counters = sorted(counters, key=lambda c: c.ts)
        self.instants = sorted(instants, key=lambda i: i.ts)
        self._by_tid: Dict[int, List[SpanEvent]] = {}
        for s in self.spans:
            self._by_tid.setdefault(s.tid, []).append(s)
        self._tid_starts: Dict[int, List[float]] = {
            tid: [s.ts for s in spans_] for tid, spans_ in self._by_tid.items()}

    # -- construction --------------------------------------------------------

    @classmethod
    def from_events(cls, events: Iterable[dict]) -> "Trace":
        spans: List[SpanEvent] = []
        flows: List[FlowPoint] = []
        counters: List[CounterPoint] = []
        instants: List[InstantPoint] = []
        for ev in events:
            ph = ev.get("ph")
            if ph == "X":
                spans.append(SpanEvent(name=str(ev.get("name", "")),
                                       cat=str(ev.get("cat", "")),
                                       ts=float(ev.get("ts", 0.0)),
                                       dur=float(ev.get("dur", 0.0)),
                                       tid=int(ev.get("tid", 0)),
                                       args=dict(ev.get("args") or {})))
            elif ph in ("s", "t", "f"):
                flows.append(FlowPoint(id=int(ev.get("id", 0)), ph=ph,
                                       ts=float(ev.get("ts", 0.0)),
                                       tid=int(ev.get("tid", 0))))
            elif ph == "C":
                args = ev.get("args") or {}
                counters.append(CounterPoint(name=str(ev.get("name", "")),
                                             ts=float(ev.get("ts", 0.0)),
                                             value=float(
                                                 args.get("value", 0.0))))
            elif ph == "i":
                instants.append(InstantPoint(name=str(ev.get("name", "")),
                                             ts=float(ev.get("ts", 0.0)),
                                             tid=int(ev.get("tid", 0)),
                                             args=dict(ev.get("args") or {})))
            # "M" metadata and anything else: ignored.
        return cls(spans, flows, counters, instants)

    @classmethod
    def from_file(cls, path: str) -> "Trace":
        with open(path) as f:
            doc = json.load(f)
        if isinstance(doc, dict):
            events = doc.get("traceEvents", [])
        else:
            events = doc
        return cls.from_events(events)

    # -- queries -------------------------------------------------------------

    def wall_us(self) -> float:
        """First event start → last span end (0 for an empty trace)."""
        ts = [s.ts for s in self.spans] + [p.ts for p in self.flows] \
            + [c.ts for c in self.counters] + [i.ts for i in self.instants]
        if not ts:
            return 0.0
        ends = [s.end for s in self.spans] or ts
        return max(max(ends), max(ts)) - min(ts)

    def spans_named(self, name: str) -> List[SpanEvent]:
        return [s for s in self.spans if s.name == name]

    def enclosing_span(self, tid: int, ts: float) -> Optional[SpanEvent]:
        """The innermost span on ``tid`` containing ``ts``.

        Spans on one tid nest (same-thread context managers), so the
        latest-starting span that contains ``ts`` is the innermost.
        Scans backwards from the bisect point, bounded — pathological
        traces degrade to a miss, not a hang.
        """
        starts = self._tid_starts.get(tid)
        if not starts:
            return None
        spans = self._by_tid[tid]
        i = bisect.bisect_right(starts, ts) - 1
        lo = max(0, i - 256)
        for j in range(i, lo - 1, -1):
            s = spans[j]
            if s.ts <= ts <= s.end:
                return s
        return None


# ---------------------------------------------------------------------------
# Phase accounting.


@dataclass
class PhaseStat:
    phase: str
    total_us: float = 0.0
    count: int = 0
    max_us: float = 0.0

    @property
    def mean_us(self) -> float:
        return self.total_us / self.count if self.count else 0.0


@dataclass
class PhaseTable:
    stats: Dict[str, PhaseStat]
    wall_us: float

    @property
    def accounted_us(self) -> float:
        return sum(s.total_us for s in self.stats.values())

    def get(self, phase: str) -> PhaseStat:
        return self.stats.get(phase, PhaseStat(phase))

    def total_s(self, phase: str) -> float:
        return self.get(phase).total_us / 1e6

    def share(self, phase: str) -> float:
        acc = self.accounted_us
        return self.get(phase).total_us / acc if acc else 0.0

    def as_rows(self, prefix: str = "phase") -> List[tuple]:
        """``(name, value, derived)`` rows in the BENCH snapshot format —
        phase totals in seconds plus each phase's share of accounted
        time, so snapshot diffs can attribute a move to a phase."""
        rows: List[tuple] = []
        for ph in PHASE_ORDER:
            if ph not in self.stats:
                continue
            st = self.stats[ph]
            paper = PAPER_PHASE.get(ph, ph)
            rows.append((f"{prefix}/{ph}_s", st.total_us / 1e6,
                         f"{paper}: {st.count} spans, mean "
                         f"{st.mean_us:.0f} us, max {st.max_us:.0f} us"))
            rows.append((f"{prefix}/{ph}_share", self.share(ph),
                         f"{paper} share of accounted span time"))
        return rows

    def is_empty(self) -> bool:
        return not any(s.count for s in self.stats.values())


def phase_accounting(trace: Trace,
                     span_phase: Optional[Dict[str, str]] = None
                     ) -> PhaseTable:
    """Group wave-lifecycle span time into the paper's phase split."""
    mapping = SPAN_PHASE if span_phase is None else span_phase
    stats: Dict[str, PhaseStat] = {}
    for s in trace.spans:
        ph = mapping.get(s.name)
        if ph is None:
            continue
        st = stats.setdefault(ph, PhaseStat(ph))
        st.total_us += s.dur
        st.count += 1
        st.max_us = max(st.max_us, s.dur)
    return PhaseTable(stats=stats, wall_us=trace.wall_us())


def slow_waves(trace: Trace, k: int = 8,
               name: str = "wave.kernel") -> List[SpanEvent]:
    """The ``k`` longest spans of one wave phase, worst first."""
    return sorted(trace.spans_named(name),
                  key=lambda s: s.dur, reverse=True)[:max(0, k)]


# ---------------------------------------------------------------------------
# Critical paths from flow arrows.


@dataclass(frozen=True)
class PathSegment:
    name: str
    tid: int
    ts: float
    dur_us: float
    wait_us: float         # gap since previous segment's span ended
    args: dict = field(default_factory=dict)


@dataclass(frozen=True)
class FlowPath:
    id: int
    segments: Tuple[PathSegment, ...]

    @property
    def latency_us(self) -> float:
        if not self.segments:
            return 0.0
        first = self.segments[0]
        last = self.segments[-1]
        return (last.ts + last.dur_us) - first.ts

    @property
    def busy_us(self) -> float:
        return sum(s.dur_us for s in self.segments)

    @property
    def wait_us(self) -> float:
        return sum(s.wait_us for s in self.segments)


def critical_paths(trace: Trace) -> List[FlowPath]:
    """Rebuild each flow id's span chain: the request's critical path.

    Every flow point (start/step/end) is bound to the innermost span
    enclosing it on its own thread — the same binding rule Perfetto
    uses to draw the arrows.  Consecutive points landing in the same
    span dedupe to one segment; ``wait_us`` is the scheduling gap
    between one segment's span ending and the next one starting.
    """
    by_id: Dict[int, List[FlowPoint]] = {}
    for p in trace.flows:
        by_id.setdefault(p.id, []).append(p)
    paths: List[FlowPath] = []
    for fid in sorted(by_id):
        segs: List[PathSegment] = []
        prev_span: Optional[SpanEvent] = None
        for p in sorted(by_id[fid], key=lambda q: q.ts):
            s = trace.enclosing_span(p.tid, p.ts)
            if s is None or s is prev_span:
                continue
            wait = 0.0
            if prev_span is not None:
                wait = max(0.0, s.ts - prev_span.end)
            segs.append(PathSegment(name=s.name, tid=s.tid, ts=s.ts,
                                    dur_us=s.dur, wait_us=wait,
                                    args=dict(s.args)))
            prev_span = s
        if segs:
            paths.append(FlowPath(id=fid, segments=tuple(segs)))
    return paths


# ---------------------------------------------------------------------------
# Pipeline bubbles / occupancy.


@dataclass(frozen=True)
class Bubble:
    ts: float
    dur_us: float


@dataclass
class PipelineReport:
    span_us: float          # first busy start -> last busy end
    busy_us: float          # time with >=1 wave in flight
    bubbles: List[Bubble]
    mean_inflight: float    # time-weighted over the busy+idle span
    host_busy_us: float     # union of scatter/gather/traceback spans
    host_overlap_us: float  # host work overlapping device-busy time

    @property
    def bubble_us(self) -> float:
        return sum(b.dur_us for b in self.bubbles)

    @property
    def occupancy(self) -> float:
        return self.busy_us / self.span_us if self.span_us else 0.0

    @property
    def host_overlap_frac(self) -> float:
        return (self.host_overlap_us / self.host_busy_us
                if self.host_busy_us else 0.0)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    if not intervals:
        return []
    intervals = sorted(intervals)
    out = [intervals[0]]
    for lo, hi in intervals[1:]:
        if lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def _intersect_len(a: List[Tuple[float, float]],
                   b: List[Tuple[float, float]]) -> float:
    total = 0.0
    i = j = 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def pipeline_analysis(trace: Trace,
                      counter: str = "inflight_waves") -> PipelineReport:
    """Reconstruct device occupancy from the inflight-waves counter.

    The counter samples form a step function; intervals where it is
    positive are device-busy, zero-valued gaps between them are
    pipeline **bubbles** (the host failed to keep a wave in flight).
    Falls back to the union of ``wave.kernel`` spans when the counter
    track is absent (e.g. a flight-recorder ring that rolled past it).
    """
    samples = [c for c in trace.counters if c.name == counter]
    busy: List[Tuple[float, float]] = []
    mean_inflight = 0.0
    if len(samples) >= 2:
        area = 0.0
        open_ts: Optional[float] = None
        for prev, cur in zip(samples, samples[1:]):
            dt = cur.ts - prev.ts
            area += prev.value * dt
            if prev.value > 0 and open_ts is None:
                open_ts = prev.ts
            elif prev.value <= 0 and open_ts is not None:
                busy.append((open_ts, prev.ts))
                open_ts = None
        last = samples[-1]
        if last.value > 0 and open_ts is None:
            open_ts = last.ts
        if open_ts is not None:
            end = max(last.ts, open_ts)
            if end > open_ts:
                busy.append((open_ts, end))
            elif not busy:
                busy.append((open_ts, open_ts))
        total_dt = samples[-1].ts - samples[0].ts
        mean_inflight = area / total_dt if total_dt > 0 else 0.0
    else:
        busy = _union([(s.ts, s.end) for s in trace.spans_named(
            "wave.kernel")])
        if busy:
            span = busy[-1][1] - busy[0][0]
            busy_total = sum(hi - lo for lo, hi in busy)
            mean_inflight = busy_total / span if span > 0 else 0.0
    busy = _union(busy)
    bubbles: List[Bubble] = []
    for (_, hi), (lo2, _) in zip(busy, busy[1:]):
        if lo2 > hi:
            bubbles.append(Bubble(ts=hi, dur_us=lo2 - hi))
    span_us = busy[-1][1] - busy[0][0] if busy else 0.0
    busy_us = sum(hi - lo for lo, hi in busy)
    host = _union([(s.ts, s.end) for s in trace.spans
                   if s.name in ("wave.scatter", "wave.gather",
                                 "wave.traceback")])
    host_busy_us = sum(hi - lo for lo, hi in host)
    host_overlap_us = _intersect_len(host, busy)
    return PipelineReport(span_us=span_us, busy_us=busy_us, bubbles=bubbles,
                          mean_inflight=mean_inflight,
                          host_busy_us=host_busy_us,
                          host_overlap_us=host_overlap_us)


# ---------------------------------------------------------------------------
# Diffing: trace-vs-trace and snapshot-vs-snapshot.


@dataclass(frozen=True)
class PhaseDelta:
    phase: str
    a_us: float
    b_us: float

    @property
    def ratio(self) -> float:
        if self.a_us == 0:
            return math.inf if self.b_us > 0 else 1.0
        return self.b_us / self.a_us


def diff_phase_tables(a: PhaseTable, b: PhaseTable) -> List[PhaseDelta]:
    """Per-phase deltas between two captures, biggest mover first."""
    phases = sorted(set(a.stats) | set(b.stats),
                    key=lambda p: PHASE_ORDER.index(p)
                    if p in PHASE_ORDER else len(PHASE_ORDER))
    deltas = [PhaseDelta(p, a.get(p).total_us, b.get(p).total_us)
              for p in phases]
    return sorted(deltas, key=_delta_magnitude, reverse=True)


@dataclass(frozen=True)
class RowDelta:
    name: str              # full row name, e.g. "serving/p99_ms"
    suite: str             # "serving"
    phase: str             # "p99_ms"
    a: float
    b: float

    @property
    def ratio(self) -> float:
        if self.a == 0:
            return math.inf if self.b > 0 else 1.0
        return self.b / self.a


def _delta_magnitude(d) -> float:
    r = d.ratio
    if r == math.inf:
        return math.inf
    if r <= 0:
        return math.inf
    return abs(math.log(r))


def diff_rows(rows_a: Dict[str, float],
              rows_b: Dict[str, float]) -> List[RowDelta]:
    """Attribute a snapshot regression to the (suite, phase) that moved.

    ``rows_*`` are BENCH-snapshot name→value maps (``suite/metric``).
    Only names present in both are compared; the result is sorted by
    relative movement (``|log ratio|``) so the first entry names the
    biggest mover.
    """
    deltas: List[RowDelta] = []
    for name in sorted(set(rows_a) & set(rows_b)):
        a, b = rows_a[name], rows_b[name]
        suite, _, phase = name.partition("/")
        deltas.append(RowDelta(name=name, suite=suite, phase=phase,
                               a=float(a), b=float(b)))
    return sorted(deltas, key=_delta_magnitude, reverse=True)
