"""The card's own timeline, read from a ``torch.profiler`` Chrome trace.

Device events are the kernels, copies and fills the profiler recorded
(categories ``kernel``, ``gpu_memcpy``, ``gpu_memset``); their timestamps
are on the host's clock as the profiler aligned them, in microseconds.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class DeviceTrace:
    """One profiled slice: device events, launches and annotations."""

    def __init__(self, events: List[dict]):
        self.device: List[dict] = []
        self.launch_ts: Dict[int, float] = {}     # correlation -> host us
        self.annotations: List[dict] = []
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = str(ev.get("cat", "")).lower()
            if cat in DEVICE_CATS:
                self.device.append(ev)
            elif cat in LAUNCH_CATS:
                corr = (ev.get("args") or {}).get("correlation")
                if corr is not None and "Launch" in ev.get("name", ""):
                    self.launch_ts[int(corr)] = float(ev["ts"])
            elif cat == "user_annotation":
                self.annotations.append(ev)

    @classmethod
    def load(cls, path: str) -> "DeviceTrace":
        with open(path) as f:
            return cls(json.load(f).get("traceEvents", []))

    def annotation(self, name: str) -> Optional[Tuple[float, float]]:
        """(start, end) in us of the first annotation named ``name``."""
        for ev in self.annotations:
            if ev["name"] == name:
                return float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])
        return None

    def busy_intervals(self, a: float, b: float) -> np.ndarray:
        """[n, 2] merged device-busy intervals clipped to [a, b] (us)."""
        iv = sorted((max(float(ev["ts"]), a),
                     min(float(ev["ts"]) + float(ev["dur"]), b))
                    for ev in self.device)
        out: List[List[float]] = []
        for s, e in iv:
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return np.asarray(out, np.float64).reshape(-1, 2)

    def idle_gaps(self, a: float, b: float) -> np.ndarray:
        """[n, 2] stretches of [a, b] with no device event (us)."""
        busy = self.busy_intervals(a, b)
        edges = np.concatenate([[a], busy.reshape(-1), [b]]).reshape(-1, 2)
        return edges[edges[:, 1] > edges[:, 0]]

    def op_seconds(self, a: float, b: float) -> List[Tuple[str, float]]:
        """Device seconds by event name (shortened) inside [a, b], longest
        first."""
        tot: Dict[str, float] = {}
        for ev in self.device:
            s = max(float(ev["ts"]), a)
            e = min(float(ev["ts"]) + float(ev["dur"]), b)
            if e > s:
                n = short_name(ev["name"])
                tot[n] = tot.get(n, 0.0) + (e - s) / 1e6
        return sorted(tot.items(), key=lambda kv: -kv[1])

    def kernels(self, a: float, b: float) -> List[dict]:
        """Kernel events wholly inside [a, b], in start order, each with
        the host time of its launch (``launch_ts``, None when the trace
        has no launch event for it)."""
        out = []
        for ev in self.device:
            if str(ev.get("cat", "")).lower() != "kernel":
                continue
            s, d = float(ev["ts"]), float(ev["dur"])
            if s >= a and s + d <= b:
                corr = (ev.get("args") or {}).get("correlation")
                out.append({"name": ev["name"], "ts": s, "dur": d,
                            "launch_ts": self.launch_ts.get(int(corr))
                            if corr is not None else None})
        return sorted(out, key=lambda k: k["ts"])


def short_name(name: str, width: int = 100) -> str:
    """A device event's name without its argument list and namespaces."""
    for junk in ("void ", "(anonymous namespace)::", "at::native::"):
        name = name.replace(junk, "")
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i and name[i - 1] != " ":
            name = name[:i]
            break
    return name[:width]


def label_times(times: np.ndarray, spans: List[Tuple[float, float, str]]
                ) -> List[Optional[str]]:
    """The innermost span around each time (spans of one thread nest);
    ``None`` where the host was in none."""
    order = np.argsort(times)
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    labels: List[Optional[str]] = [None] * len(times)
    stack: List[Tuple[float, float, str]] = []
    si = 0
    for idx in order:
        t = times[idx]
        while si < len(spans) and spans[si][0] <= t:
            sp = spans[si]
            si += 1
            while stack and stack[-1][1] <= sp[0]:
                stack.pop()
            stack.append(sp)
        while stack and stack[-1][1] < t:
            stack.pop()
        labels[idx] = stack[-1][2] if stack else None
    return labels
