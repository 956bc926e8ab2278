"""Open-loop replay: offered load that does not wait for the server.

A closed-loop driver (submit, wait, submit) measures the server at
exactly its own pace and hides queueing entirely; the serving literature's
standard harness is **open-loop**: arrivals fire on a fixed schedule (here
a Poisson process scaled to the offered load) whether or not earlier
requests have completed, so queueing delay, shedding and tail latency
become visible.  ``replay_trace`` is that harness, which
``launch/serve_align.py`` drives.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.loop import ServeLoop, ServerStats
from repro_torch.serve.request import AlignFuture, AlignResult, ShedError

__all__ = ["ReplayReport", "replay_trace"]

Payload = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


@dataclasses.dataclass
class ReplayReport:
    """What one open-loop replay observed."""
    n_requests: int
    n_ok: int
    n_shed: int
    n_failed: int                     # non-shed exceptions (should be 0)
    latencies: np.ndarray             # seconds, completed requests only
    pairs_done: int
    t_offered: float                  # last scheduled arrival - first
    t_sustained: float                # first arrival -> last completion
    lag_max: float                    # worst driver-side schedule slip
    results: List[Optional[AlignResult]]    # per request; None if shed
    stats: ServerStats                # server snapshot at drain

    @property
    def sustained_pairs_per_s(self) -> float:
        return self.pairs_done / max(self.t_sustained, 1e-12)

    def percentile_ms(self, q: float) -> float:
        return (float(np.percentile(self.latencies, q)) * 1e3
                if self.latencies.size else float("nan"))


def replay_trace(server: ServeLoop, payloads: Sequence[Payload],
                 arrivals: np.ndarray, *, penalties=None, heuristic=None,
                 output: Optional[str] = None,
                 deadline: Optional[float] = None) -> ReplayReport:
    """Submit ``payloads[i]`` at time ``t0 + arrivals[i]``, then drain.

    Open loop: the schedule is absolute (no drift when a submit runs
    long); ``lag_max`` reports how far the driver itself fell behind its
    schedule, so an overloaded *driver* is distinguishable from an
    overloaded *server*.  Waits on every future at the end — each must
    resolve exactly once (ok / shed / failure), which the report tallies.
    """
    assert len(payloads) == len(arrivals)
    futures: List[AlignFuture] = []
    t0 = time.monotonic()
    lag_max = 0.0
    for (p, plen, t, tlen), at in zip(payloads, arrivals):
        due = t0 + float(at)
        now = time.monotonic()
        if due > now:
            time.sleep(due - now)
        else:
            lag_max = max(lag_max, now - due)
        futures.append(server.submit_packed(
            p, plen, t, tlen, penalties=penalties, heuristic=heuristic,
            output=output, deadline=deadline))

    results: List[Optional[AlignResult]] = []
    latencies: List[float] = []
    n_ok = n_shed = n_failed = pairs_done = 0
    t_last_done = t0
    for fut in futures:
        try:
            res = fut.result(timeout=600.0)
            results.append(res)
            latencies.append(res.latency)
            pairs_done += len(res.scores)
            n_ok += 1
            t_last_done = max(t_last_done,
                              fut.request.t_arrival + res.latency)
        except ShedError:
            results.append(None)
            n_shed += 1
        except Exception:
            results.append(None)
            n_failed += 1
    stats = server.stats()
    return ReplayReport(
        n_requests=len(futures), n_ok=n_ok, n_shed=n_shed,
        n_failed=n_failed, latencies=np.asarray(latencies, float),
        pairs_done=pairs_done,
        t_offered=float(arrivals[-1] - arrivals[0]) if len(arrivals) else 0.0,
        t_sustained=max(t_last_done - t0, 1e-12), lag_max=lag_max,
        results=results, stats=stats)
