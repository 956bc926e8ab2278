"""Request/response types of the always-on alignment service.

One :class:`AlignRequest` is one caller-sized unit of work — a handful of
(pattern, text) pairs plus the per-request seams the engine already
exposes per submit (penalty model, wavefront heuristic, output mode) and
an optional latency deadline.  The service answers through an
:class:`AlignFuture` (a ``concurrent.futures.Future``): accepted requests
resolve with an :class:`AlignResult`, shed requests resolve with a typed
:class:`ShedError`.  Every future resolves exactly once — the stdlib
future raises ``InvalidStateError`` on a double resolution, which is the
service's lost/duplicated-request tripwire.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import itertools
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.engine import Seq, pack_batch

__all__ = ["AlignFuture", "AlignRequest", "AlignResult", "ShedError"]

_ids = itertools.count()


class ShedError(RuntimeError):
    """Typed admission-control rejection.

    Raised *through the request's future* (``future.result()`` re-raises
    it), never silently: a shed request is answered, just not served.
    ``reason`` is ``"queue full"`` (bounded queue at capacity) or
    ``"server stopped"`` (submitted after shutdown began).
    """

    def __init__(self, reason: str, *, queue_depth: int = 0,
                 max_depth: int = 0):
        super().__init__(
            f"request shed: {reason} "
            f"(queue depth {queue_depth}/{max_depth})")
        self.reason = reason
        self.queue_depth = queue_depth
        self.max_depth = max_depth


@dataclasses.dataclass
class AlignResult:
    """What an accepted request's future resolves with."""
    scores: np.ndarray                      # [n_pairs] int32
    cigars: Optional[List[np.ndarray]]      # per-pair op arrays (cigar mode)
    latency: float                          # seconds, arrival -> delivery
    n_waves: int                            # device waves this request rode


class AlignFuture(concurrent.futures.Future):
    """`concurrent.futures.Future` + a back-pointer to its request."""

    def __init__(self, request: "AlignRequest"):
        super().__init__()
        self.request = request


class AlignRequest:
    """One service request: packed pairs + per-request engine seams.

    ``deadline`` is a *relative* latency budget in seconds: the wave
    former will not hold this request's forming group open past
    ``arrival + min(form_deadline, deadline)``.  ``None`` means the
    server-wide forming deadline alone applies.

    The mutable delivery state (``_scores`` buffer, ``_remaining`` row
    count, per-wave cigar scatter) is owned by the serve loop; callers
    only touch the future.
    """

    def __init__(self, p: np.ndarray, plen: np.ndarray, t: np.ndarray,
                 tlen: np.ndarray, *, penalties=None, heuristic=None,
                 output: Optional[str] = None,
                 deadline: Optional[float] = None):
        self.p = np.asarray(p)
        self.t = np.asarray(t)
        self.plen = np.asarray(plen, np.int32)
        self.tlen = np.asarray(tlen, np.int32)
        if self.p.shape[0] != self.t.shape[0]:
            raise ValueError("patterns and texts disagree on pair count")
        self.n_pairs = int(self.p.shape[0])
        self.penalties = penalties
        self.heuristic = heuristic
        self.output = output
        self.deadline = None if deadline is None else float(deadline)
        self.request_id = next(_ids)
        self.future = AlignFuture(self)
        # -- delivery state (serve-loop owned) --------------------------------
        self.t_arrival: float = 0.0          # stamped at admission
        self.flow_id: int = 0                # trace flow (0 = tracing off)
        self.pen = None                      # resolved at admission
        self.heur = None
        self.out: str = "score"
        self._scores = np.full((self.n_pairs,), -1, np.int32)
        self._cigars: Optional[List[Optional[np.ndarray]]] = None
        self._remaining = self.n_pairs
        self._n_waves = 0

    @classmethod
    def from_seqs(cls, patterns: Sequence[Seq], texts: Sequence[Seq],
                  **kw) -> "AlignRequest":
        """Pack python sequences on the caller's thread (keeps host-side
        encoding off the serve loop)."""
        if len(patterns) != len(texts):
            raise ValueError("patterns and texts disagree on pair count")
        p, plen = pack_batch(patterns)
        t, tlen = pack_batch(texts)
        return cls(p, plen, t, tlen, **kw)

    @property
    def max_len(self) -> int:
        """Longest sequence in the request — the bucket-affinity key."""
        return int(max(self.plen.max(initial=1), self.tlen.max(initial=1)))

    # -- serve-loop delivery hooks -------------------------------------------

    def _deliver_rows(self, rows: slice, scores: np.ndarray,
                      cigars: Optional[List[np.ndarray]]) -> bool:
        """Scatter one wave's slice of results; True when complete."""
        self._scores[rows] = scores
        if cigars is not None:
            if self._cigars is None:
                self._cigars = [None] * self.n_pairs
            self._cigars[rows] = cigars
        self._remaining -= len(scores)
        self._n_waves += 1
        return self._remaining == 0

    def _resolve(self, now: float) -> float:
        """Complete the future -> the request's arrival->delivery latency."""
        latency = now - self.t_arrival
        self.future.set_result(AlignResult(
            scores=self._scores, cigars=self._cigars, latency=latency,
            n_waves=self._n_waves))
        return latency
