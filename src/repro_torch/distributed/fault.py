"""Fault tolerance: straggler detection, failure drills, elastic remesh
(the JAX package's ``distributed/fault.py``, copied: pure Python).

At 1000+ nodes the failure model is: (a) slow workers (stragglers), (b) dead
workers, (c) whole-pod loss.  The framework's contract:

* training state is periodically checkpointed (``repro_torch.checkpoint``)
  with *logical* shapes, so a restart may land on a different healthy-device
  count (``plan_elastic_mesh``) and simply moves the state there;
* the data pipeline is keyed by (seed, step, shard)
  (``repro_torch.data.tokens``), so a restarted or reassigned worker
  regenerates exactly its shard — stragglers can be fenced and their shards
  reassigned without divergence;
* ``StragglerMonitor`` implements the detection policy (median-factor rule,
  the standard backup-task trigger from MapReduce onward).

Node death is *simulated* (``FailureInjector`` raises at a chosen step);
the restart drill in ``tests/test_torch_train.py`` and ``launch/train.py
--simulate-failure`` exercises the full kill -> restore ->
bit-identical-continuation path.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class StragglerMonitor:
    """Tracks per-worker step durations; flags workers slower than
    ``factor`` x the healthy median over a sliding window."""
    n_workers: int
    factor: float = 2.0
    window: int = 8

    def __post_init__(self):
        self._hist: Dict[int, List[float]] = {w: [] for w in range(self.n_workers)}

    def record(self, worker: int, duration: float) -> None:
        h = self._hist[worker]
        h.append(duration)
        if len(h) > self.window:
            h.pop(0)

    def _avg(self, w: int) -> Optional[float]:
        h = self._hist[w]
        return sum(h) / len(h) if h else None

    def stragglers(self) -> List[int]:
        avgs = {w: a for w in range(self.n_workers)
                if (a := self._avg(w)) is not None}
        if len(avgs) < 2:
            return []
        med = sorted(avgs.values())[len(avgs) // 2]
        return [w for w, a in avgs.items() if a > self.factor * med]

    def reassignment(self, shards_per_worker: int = 1) -> Dict[int, List[int]]:
        """Shard indices of stragglers -> healthy workers (round-robin)."""
        bad = set(self.stragglers())
        healthy = [w for w in range(self.n_workers) if w not in bad]
        if not healthy or not bad:
            return {}
        plan: Dict[int, List[int]] = {w: [] for w in healthy}
        i = 0
        for w in sorted(bad):
            for s in range(shards_per_worker):
                plan[healthy[i % len(healthy)]].append(w * shards_per_worker + s)
                i += 1
        return {w: s for w, s in plan.items() if s}


class FailureInjector:
    """Deterministic failure for restart drills: raises at a chosen step."""

    class SimulatedFailure(RuntimeError):
        pass

    def __init__(self, fail_at_step: Optional[int] = None):
        self.fail_at_step = fail_at_step

    def check(self, step: int) -> None:
        if self.fail_at_step is not None and step == self.fail_at_step:
            raise self.SimulatedFailure(f"simulated node failure at step {step}")


def plan_elastic_mesh(n_devices: int, *, model_parallel: int = 16,
                      pods: int = 1) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Largest (pod, data, model) grid fitting ``n_devices`` healthy chips.

    Model parallelism is fixed by memory (a shard must hold 1/MP of the
    params), so elasticity comes from the data axis: we keep MP and shrink
    DP to the largest value with pods*DP*MP <= n_devices.  DP is rounded
    down to a power of two so global batch stays divisible.
    """
    per_pod = n_devices // pods
    dp = per_pod // model_parallel
    if dp < 1:
        raise ValueError(f"{n_devices} devices cannot fit model_parallel="
                         f"{model_parallel} x pods={pods}")
    dp = 1 << int(math.floor(math.log2(dp)))
    if pods > 1:
        return (pods, dp, model_parallel), ("pod", "data", "model")
    return (dp, model_parallel), ("data", "model")


@dataclasses.dataclass
class HeartbeatRegistry:
    """Liveness bookkeeping: workers ping; silence beyond ``timeout_s`` marks
    them dead.  The launcher consults ``dead()`` between steps and triggers
    checkpoint-restore with a re-planned mesh when membership changes."""
    n_workers: int
    timeout_s: float = 60.0

    def __post_init__(self):
        now = time.monotonic()
        self._last: Dict[int, float] = {w: now for w in range(self.n_workers)}

    def ping(self, worker: int, at: Optional[float] = None) -> None:
        self._last[worker] = time.monotonic() if at is None else at

    def dead(self, now: Optional[float] = None) -> List[int]:
        now = time.monotonic() if now is None else now
        return [w for w, t in self._last.items() if now - t > self.timeout_s]

    def healthy_count(self, now: Optional[float] = None) -> int:
        return self.n_workers - len(self.dead(now))
