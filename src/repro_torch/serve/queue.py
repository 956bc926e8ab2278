"""Bounded admission queue — the service's load-shedding front door.

A server that queues without bound converts overload into unbounded
latency; the paper-scale regime (millions of independent small requests)
instead sheds at admission: when ``max_depth`` requests are already
waiting, ``offer()`` refuses and the caller's future resolves with a
typed :class:`~repro_torch.serve.request.ShedError` immediately.  Accepted
requests are handed to the serve loop in arrival order via ``drain()``;
``wait()`` is the loop's parking spot between arrivals (condition-based,
so an arrival wakes the loop instead of a poll finding it later).
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Deque, List, Optional

from repro_torch.serve.request import AlignRequest, ShedError

__all__ = ["RequestQueue"]


class RequestQueue:
    """Thread-safe bounded FIFO of :class:`AlignRequest` with shedding."""

    def __init__(self, max_depth: int = 1024):
        if max_depth < 1:
            raise ValueError("max_depth must be >= 1")
        self.max_depth = int(max_depth)
        self._items: Deque[AlignRequest] = collections.deque()
        self._cond = threading.Condition()
        self._closed = False
        self.n_offered = 0
        self.n_shed = 0

    def __len__(self) -> int:
        return len(self._items)

    @property
    def closed(self) -> bool:
        return self._closed

    def offer(self, req: AlignRequest) -> bool:
        """Admit ``req`` (stamping its arrival time) or shed it.

        Returns True on admission.  On shed, the request's future is
        resolved here with :class:`ShedError` — exactly-once answering is
        the queue's contract, not the caller's cleanup problem.
        """
        with self._cond:
            self.n_offered += 1
            if self._closed:
                self.n_shed += 1
                req.future.set_exception(ShedError(
                    "server stopped", queue_depth=len(self._items),
                    max_depth=self.max_depth))
                return False
            if len(self._items) >= self.max_depth:
                self.n_shed += 1
                req.future.set_exception(ShedError(
                    "queue full", queue_depth=len(self._items),
                    max_depth=self.max_depth))
                return False
            req.t_arrival = time.monotonic()
            self._items.append(req)
            self._cond.notify()
            return True

    def drain(self, max_items: Optional[int] = None) -> List[AlignRequest]:
        """Pop up to ``max_items`` requests (all, when None). Non-blocking."""
        with self._cond:
            n = len(self._items) if max_items is None \
                else min(max_items, len(self._items))
            return [self._items.popleft() for _ in range(n)]

    def wait(self, timeout: float) -> bool:
        """Park until an arrival (or ``timeout`` seconds); True if items
        are waiting."""
        with self._cond:
            if not self._items:
                self._cond.wait(timeout)
            return bool(self._items)

    def close(self) -> None:
        """Refuse (shed) all future offers; queued items still drain."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
