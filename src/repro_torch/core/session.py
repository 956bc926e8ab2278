"""Streaming alignment sessions — async submission, pipelined dispatch,
out-of-order gather.

The counterpart of ``repro.core.session`` on PyTorch:

* ``submit(patterns, texts) -> Ticket`` returns immediately.  Pairs are
  bucketed and cut into *waves* (``wave_pairs``); each wave is packed on
  the host, copied from pinned buffers with ``non_blocking`` copies and
  launched on the current CUDA stream, so the card runs wave *N* while the
  host packs wave *N+1*.  The wave's results are copied back into pinned
  host buffers behind the kernel, and a CUDA event marks when they land.
* at most ``max_inflight_waves`` waves are in flight — **backpressure**.
* waves retire **out of order** across buckets and submissions;
  ``as_completed()`` yields tickets in completion order, ``results()`` in
  submission order, ``drain()`` flushes everything; ``poll()`` retires
  only waves whose event has completed (``torch.cuda.Event.query``).
* pairs that overflow the optimistic ``edit_frac`` bound are **recycled
  into a recovery queue** and re-run with exact worst-case bounds when a
  full recovery wave accumulates or at drain.
* each submit carries its own **output mode**; CIGAR tracebacks run on
  the host at retirement (``core.cigar`` on the gathered numpy words).
  ``trace_variant="bidir"`` hands a CIGAR ticket to the BiWFA driver
  (``repro_torch.biwfa``), which resubmits its sub-problems through the
  same session as internal tickets.

The sync ``engine.align()`` is one blocking pass through this class
(``max_inflight_waves=1`` + per-phase timing: on a card, CUDA events
around the host-to-device copy, the kernel and the device-to-host copy).

Quickstart::

    eng = AlignmentEngine(backend="kernel", edit_frac=0.02)
    with eng.stream(max_inflight_waves=2) as sess:
        tickets = [sess.submit(ps, ts) for ps, ts in chunks]
        for t in sess.as_completed():        # completion order
            consume(t.result().scores)
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Deque, Iterator, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import cigar as cigar_mod
from repro_torch.core.engine import (AlignmentEngine, BucketInfo, EngineResult,
                                     EngineStats, Seq, _fit_width, _pad_rows,
                                     _quantize_rows, _round_up, pack_batch)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import profile as obs_profile
from repro_torch.obs import record as obs_record
from repro_torch.obs import trace as obs_trace

__all__ = ["AlignmentSession", "SessionStats", "Ticket", "run_streamed"]

@dataclasses.dataclass
class SessionStats(EngineStats):
    """Aggregate telemetry across every submit of one session."""
    n_submits: int = 0
    n_waves: int = 0
    max_inflight: int = 0      # configured backpressure bound
    peak_inflight: int = 0     # highest observed in-flight wave count


class Ticket:
    """Handle for one ``submit()`` call.

    Fills in as its waves retire; ``done()`` is non-blocking, ``result()``
    drives the session until this ticket is complete and returns its
    :class:`EngineResult` (scores in submission row order).
    """

    def __init__(self, session: "AlignmentSession", index: int, n_pairs: int,
                 output: str = "score", pen=None, heur=None, meta=None,
                 trace_variant: str = "packed", states=("M", "M"),
                 s_cap=None, internal: bool = False, on_done=None):
        eng = session.engine
        self.index = index
        self.n_pairs = n_pairs
        self.output = output
        self.meta = meta                 # opaque caller payload
        self.pen = eng.pen if pen is None else pen
        self.heur = eng.heuristic if heur is None else heur
        self.trace_variant = trace_variant   # "packed" | "bidir"
        # boundary states of BiWFA recursion children: "I"/"D" pins the
        # alignment's start/end inside an open gap run
        self.states = tuple(states)
        # per-submit score ceiling (BiWFA children run at their known
        # cost); capped tickets are single-pass: an unresolved row means
        # "over the cap", so there is no recovery re-run
        self._s_cap = s_cap
        # internal tickets (BiWFA sub-problems) never surface through
        # poll()/as_completed()/results(); on_done fires at finalization
        self.internal = internal
        self._on_done = on_done
        # trace-flow IDs riding this ticket (see repro_torch.obs.trace);
        # _own_flows marks IDs this ticket allocated and ends at finalize
        self.flows: tuple = ()
        self._own_flows = False
        self.stats = EngineStats(n_pairs=n_pairs, n_workers=eng.n_workers)
        self._session = session
        self._scores = np.full((n_pairs,), -1, np.int32)
        self._cigars: Optional[dict] = {} if output == "cigar" else None
        # breakpoints of "bidir_meet" rows: (state, a, b, k, h, safe) per
        # pair, -1 until the wave retires
        self._meet = (np.full((n_pairs, 6), -1, np.int32)
                      if output == "bidir_meet" else None)
        self._starget = None             # [n] known costs for meet waves
        self._p = self._t = self._plen = self._tlen = None
        self._outstanding = n_pairs      # rows without a final score yet
        self._recovery_rows: List[np.ndarray] = []   # overflow awaiting re-run
        self._steps = 0
        self._s_hi = 0
        self._k_hi = 0
        self._done = False
        self._result: Optional[EngineResult] = None

    def done(self) -> bool:
        return self._done

    def result(self) -> EngineResult:
        if not self._done:
            self._session._wait_for(self)
        return self._result


class _Transfer:
    """One wave's device results on their way to the host.

    A result on other devices than the engine's (a ``shardmap`` wave over
    several cards) is first gathered onto the engine's device.  On a card:
    an event after the kernel, ``non_blocking`` copies of the score (and
    trace words) into pinned host tensors, and an event after the copies,
    all on the engine device's current stream.  A backend that runs on
    streams of its own orders that stream after them before it returns
    (``wavefront.wfa_shards``), so the events cover every shard.  On the
    CPU the results already are host tensors.
    """

    def __init__(self, res, device: torch.device):
        self.res = res
        # the score and every other tensor field: trace words, meet
        # breakpoints, a kernel's on-device step count
        fields = {}
        for f in res._fields:
            t = getattr(res, f)
            if isinstance(t, torch.Tensor):
                fields[f] = t.to(device)
            elif f == "score":   # whatever it is, it fails at the gather
                fields[f] = t
        self.kernel_done = self.copied = None
        if device.type == "cuda":
            stream = torch.cuda.current_stream(device)
            self.kernel_done = torch.cuda.Event(enable_timing=True)
            self.kernel_done.record(stream)
            self.host = {}
            for f, src in fields.items():
                dst = torch.empty(src.shape, dtype=src.dtype,
                                  pin_memory=True)
                dst.copy_(src, non_blocking=True)
                self.host[f] = dst
            self.copied = torch.cuda.Event(enable_timing=True)
            self.copied.record(stream)
        else:
            self.host = fields

    def ready(self) -> bool:
        return self.copied is None or self.copied.query()

    def wait_kernel(self) -> None:
        if self.kernel_done is not None:
            self.kernel_done.synchronize()

    def fetch(self):
        """-> the wave's result with numpy arrays (blocks)."""
        if self.copied is not None:
            self.copied.synchronize()
        return self.res._replace(**{f: t.numpy()
                                    for f, t in self.host.items()})


@dataclasses.dataclass
class _Wave:
    """One dispatched rectangular chunk whose device result is in flight."""
    ticket: Ticket
    rows: np.ndarray            # ticket-local row indices (un-padded count)
    xfer: _Transfer
    plc: np.ndarray             # padded lens kept for CIGAR traceback
    tlc: np.ndarray
    k_max: int
    recovery: bool
    pc: Optional[np.ndarray] = None   # padded codes, kept only for CIGAR
    tc: Optional[np.ndarray] = None
    t_gather: Optional[float] = None  # sync mode: device-to-host seconds


class AlignmentSession:
    """Pipelined submit/drain front-end over one :class:`AlignmentEngine`.

    Created via :meth:`AlignmentEngine.stream` (or directly); shares the
    engine's specialisation cache.  Every public entry point serializes on
    one internal re-entrant lock held per pipeline step, so several
    threads may feed and drain one session.

    ``_sync_timing`` is the engine-internal blocking mode used by
    ``align()``: each wave blocks per phase so scatter/kernel/gather stay
    separable (the streaming default attributes host dispatch time to
    scatter and wait time at retirement to kernel and gather).
    """

    def __init__(self, engine: AlignmentEngine, *,
                 max_inflight_waves: int = 2,
                 wave_pairs: Optional[int] = None,
                 _sync_timing: bool = False):
        if max_inflight_waves < 1:
            raise ValueError("max_inflight_waves must be >= 1")
        self.engine = engine
        self.max_inflight = int(max_inflight_waves)
        self.wave_pairs = int(wave_pairs if wave_pairs is not None
                              else engine.chunk_pairs)
        if self.wave_pairs < 1:
            raise ValueError("wave_pairs must be >= 1")
        self._sync = bool(_sync_timing)
        self._cuda = engine.device.type == "cuda"
        self.stats = SessionStats(n_workers=engine.n_workers,
                                  max_inflight=self.max_inflight)
        self._tickets: List[Ticket] = []
        self._inflight: Deque[_Wave] = collections.deque()
        self._completed: Deque[Ticket] = collections.deque()
        self._error: Optional[BaseException] = None
        self._closed = False
        self._lock = threading.RLock()

    # -- lifecycle -----------------------------------------------------------

    def __enter__(self) -> "AlignmentSession":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            self.close()
        else:
            self._abandon_inflight()
            self._closed = True
        return False

    def close(self) -> None:
        """Drain outstanding work and refuse further submissions."""
        if not self._closed:
            try:
                self.drain()
            finally:
                self._closed = True

    @property
    def n_inflight(self) -> int:
        return len(self._inflight)

    @property
    def tickets(self) -> List[Ticket]:
        return list(self._tickets)

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("session is closed")
        if self._error is not None:
            raise RuntimeError(
                "session failed; no further submissions") from self._error

    # -- submission ----------------------------------------------------------

    def submit(self, patterns: Sequence[Seq], texts: Sequence[Seq], *,
               output: Optional[str] = None, penalties=None,
               heuristic=None, meta=None,
               trace_variant: Optional[str] = None) -> Ticket:
        """Enqueue one batch of python sequences; returns immediately."""
        assert len(patterns) == len(texts)
        p, plen = pack_batch(patterns)
        t, tlen = pack_batch(texts)
        return self.submit_packed(p, plen, t, tlen, output=output,
                                  penalties=penalties, heuristic=heuristic,
                                  meta=meta, trace_variant=trace_variant)

    def submit_packed(self, p: np.ndarray, plen: np.ndarray, t: np.ndarray,
                      tlen: np.ndarray, *, output: Optional[str] = None,
                      penalties=None, heuristic=None, meta=None,
                      trace_variant: Optional[str] = None,
                      _s_cap=None, _states=("M", "M"), _starget=None,
                      _internal: bool = False, _on_done=None,
                      _flows=None) -> Ticket:
        """Enqueue pre-packed [B, L] codes + [B] lens; returns immediately.

        The underscore keywords are the BiWFA driver's internal seam
        (``repro_torch.biwfa.recurse``): sub-problems resubmit through the
        same session so they batch with live traffic.  ``_starget`` (known
        per-pair costs) flips the ticket to the engine-level
        ``"bidir_meet"`` output, a breakpoint wave.  ``_flows`` hands the
        ticket trace-flow IDs owned by its parent to step through.
        """
        with self._lock:
            self._check_open()
            n = int(p.shape[0])
            # resolve everything before the Ticket exists: a rejected submit
            # must leave the session clean
            pen = self.engine.resolve_penalties(penalties)
            if _starget is not None:
                out = "bidir_meet"
            else:
                out = self.engine.resolve_output(output, pen)
            heur = self.engine.resolve_heuristic(heuristic, out)
            tv = self.engine.resolve_trace_variant(trace_variant, out)
            ticket = Ticket(self, len(self._tickets), n, out, pen=pen,
                            heur=heur, meta=meta, trace_variant=tv,
                            states=_states, s_cap=_s_cap,
                            internal=_internal, on_done=_on_done)
            self._tickets.append(ticket)
            if _flows is not None:
                ticket.flows = tuple(_flows)
            elif obs_trace.enabled():
                ticket.flows = (obs_trace.new_flow(),)
                ticket._own_flows = True
            if not _internal:
                self.stats.n_submits += 1
                self.stats.n_pairs += n
            with obs_trace.span(
                    "session.submit", cat="session",
                    args={"ticket": ticket.index, "pairs": n, "output": out}
                    if obs_trace.enabled() else None) as sp:
                for fid in ticket.flows:
                    (sp.flow_start if ticket._own_flows
                     else sp.flow_step)(fid)
                if n == 0:
                    self._finalize(ticket)
                    return ticket
                ticket._p = np.asarray(p)
                ticket._t = np.asarray(t)
                ticket._plen = np.asarray(plen, np.int32)
                ticket._tlen = np.asarray(tlen, np.int32)
                if _starget is not None:
                    ticket._starget = np.asarray(_starget, np.int32)
                if tv == "bidir" and out == "cigar" and not _internal:
                    # meet-in-the-middle traceback: a host-side driver owns
                    # this ticket; it resolves scores first, then splits each
                    # pair through meet waves and internal sub-tickets
                    from repro_torch.biwfa.recurse import BidirDriver
                    BidirDriver(self, ticket).start()
                    return ticket
                eng = self.engine
                # capped tickets (BiWFA children) are single-pass: the cap
                # is already an exact bound
                optimistic = (eng.edit_frac is not None
                              and eng._s_max is None and _s_cap is None)
                self._enqueue_pass(ticket, np.arange(n),
                                   exact=not optimistic, recovery=False)
                return ticket

    def _enqueue_pass(self, ticket: Ticket, idx: np.ndarray, *, exact: bool,
                      recovery: bool) -> None:
        """Bucket ``idx`` rows of ``ticket`` and dispatch them as waves."""
        eng = self.engine
        for width, bidx in eng._plan_buckets(ticket._plen, ticket._tlen, idx):
            s_max, k_max = eng._bounds_for_bucket(
                width, ticket._plen[bidx], ticket._tlen[bidx], exact,
                pen=ticket.pen, s_cap=ticket._s_cap)
            ticket._s_hi = max(ticket._s_hi, s_max)
            ticket._k_hi = max(ticket._k_hi, k_max)
            info = BucketInfo(width, s_max, k_max, len(bidx),
                              recovery=recovery)
            ticket.stats.buckets.append(info)
            self.stats.buckets.append(info)
            step = min(self.wave_pairs,
                       max(eng.max_wave_cells // max(width, 1),
                           eng.n_workers, 1))
            for lo in range(0, len(bidx), step):
                self._dispatch(ticket, bidx[lo:lo + step], width,
                               s_max, k_max, recovery)

    def _mark(self):
        """A point on the device timeline (a CUDA event on the engine
        device's current stream) or the host clock."""
        if self._cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self.engine.device))
            return ev
        return time.perf_counter()

    def _seconds(self, a, b) -> float:
        if self._cuda:
            b.synchronize()
            return a.elapsed_time(b) / 1e3
        return b - a

    def _dispatch(self, ticket: Ticket, rows: np.ndarray, width: int,
                  s_max: int, k_max: int, recovery: bool) -> None:
        """Pack one wave and launch it without waiting for the result."""
        # Backpressure first: retiring *before* packing keeps the remaining
        # in-flight kernels running under this wave's host-side work.
        while len(self._inflight) >= self.max_inflight:
            self._retire_one()
        eng = self.engine
        with obs_trace.span(
                "wave.scatter", cat="wave",
                args={"ticket": ticket.index, "rows": len(rows),
                      "width": width, "s_max": s_max,
                      "recovery": recovery}
                if obs_trace.enabled() else None) as sp:
            for fid in ticket.flows:
                sp.flow_step(fid)
            t0 = time.perf_counter()
            nb = min(_quantize_rows(len(rows), eng.n_workers),
                     _round_up(self.wave_pairs, eng.n_workers))
            pc = _pad_rows(_fit_width(ticket._p[rows], width), nb)
            tc = _pad_rows(_fit_width(ticket._t[rows], width), nb)
            plc = _pad_rows(ticket._plen[rows], nb)
            tlc = _pad_rows(ticket._tlen[rows], nb)
            arrays = [pc, tc, plc, tlc]
            if ticket.output == "bidir_meet":
                # meet waves carry each pair's known cost as a 5th input
                arrays.append(_pad_rows(ticket._starget[rows], nb))
            exe, hit = eng._executable_for(pc.shape, tc.shape, s_max, k_max,
                                           ticket.output, pen=ticket.pen,
                                           heur=ticket.heur,
                                           states=ticket.states)
            for st in (ticket.stats, self.stats):
                if hit:
                    st.cache_hits += 1
                else:
                    st.cache_misses += 1
                st.bytes_in += pc.nbytes + tc.nbytes + plc.nbytes + tlc.nbytes
                st.rows_real += len(rows)
                st.rows_padded += nb
            pre = exe.n_traces
            t_gather = None
            try:
                with obs_profile.annotation("wfa.kernel.dispatch"):
                    t_host = time.perf_counter() - t0
                    e0 = self._mark()
                    dev = eng._device_put(*arrays)
                    e1 = self._mark()
                    res = exe.call(*dev)
                    xfer = _Transfer(res, eng.device)
                if self._sync:
                    # per-phase split: host packing + copy in, the kernel,
                    # and the copy out (events bracket each on a card)
                    e2 = xfer.kernel_done or time.perf_counter()
                    e3 = xfer.copied or time.perf_counter()
                    t_scat = t_host + self._seconds(e0, e1)
                    t_kern = self._seconds(e1, e2)
                    t_gather = self._seconds(e2, e3)
                    for st in (ticket.stats, self.stats):
                        st.t_scatter += t_scat
                        st.t_kernel += t_kern
                    if obs_trace.enabled():
                        sp.set(output=ticket.output, t_kernel=t_kern,
                               t_copy_out=t_gather)
                else:
                    # async: pack + enqueue cost only; the copy and kernel
                    # are both still in flight behind this wave
                    for st in (ticket.stats, self.stats):
                        st.t_scatter += time.perf_counter() - t0
            except Exception as e:
                self._error = e
                self._abandon_inflight()
                raise
            n_tr = exe.n_traces - pre
            for st in (ticket.stats, self.stats):
                st.n_traces += n_tr
            keep = ticket.output == "cigar"
            self._inflight.append(_Wave(ticket, rows, xfer, plc, tlc, k_max,
                                        recovery,
                                        pc=pc if keep else None,
                                        tc=tc if keep else None,
                                        t_gather=t_gather))
        self.stats.n_waves += 1
        self.stats.peak_inflight = max(self.stats.peak_inflight,
                                       len(self._inflight))
        self._sample_inflight()
        if self._sync:
            self._retire_one()

    # -- retirement ----------------------------------------------------------

    def _sample_inflight(self) -> None:
        """Record the in-flight wave count on the gauge + counter track."""
        n = len(self._inflight)
        obs_metrics.gauge("session_inflight_waves",
                          "waves dispatched but not yet retired").set(n)
        obs_trace.counter("inflight_waves", n, cat="session")

    def _retire_one(self) -> None:
        """Gather the oldest in-flight wave and scatter its results."""
        wave = self._inflight.popleft()
        ticket = wave.ticket
        self._sample_inflight()
        _on = obs_trace.enabled()
        _args = ({"ticket": ticket.index, "rows": len(wave.rows),
                  "recovery": wave.recovery} if _on else None)
        t0 = time.perf_counter()
        with obs_trace.span("wave.kernel", cat="wave", args=_args) as sp:
            for fid in ticket.flows:
                sp.flow_step(fid)
            try:
                with obs_profile.annotation("wfa.kernel.wait"):
                    wave.xfer.wait_kernel()
            except Exception as e:
                self._error = e
                self._abandon_inflight()
                raise
        t1 = time.perf_counter()
        with obs_trace.span("wave.gather", cat="wave", args=_args) as sp:
            for fid in ticket.flows:
                sp.flow_step(fid)
            try:
                res = wave.xfer.fetch()
            except Exception as e:
                self._error = e
                self._abandon_inflight()
                raise
            full = res.score
            out = full[: len(wave.rows)]
            t2 = time.perf_counter()
            for st in (ticket.stats, self.stats):
                if self._sync:   # sync mode billed the kernel at dispatch
                    st.t_gather += wave.t_gather
                else:
                    st.t_kernel += t1 - t0
                    st.t_gather += t2 - t1
                st.bytes_out += full.nbytes
            ticket._scores[wave.rows] = out
            ticket._steps += int(res.n_steps)
            if ticket._meet is not None:
                nr = len(wave.rows)
                ticket._meet[wave.rows] = np.stack(
                    [res.meet_state[:nr], res.meet_a[:nr], res.meet_b[:nr],
                     res.meet_k[:nr], res.meet_h[:nr], res.meet_safe[:nr]],
                    axis=1).astype(np.int32)
                n_unmet = int((out < 0).sum())
                for st in (ticket.stats, self.stats):
                    st.n_meet_unmet += n_unmet
        if ticket._cigars is not None:
            with obs_trace.span("wave.traceback", cat="wave",
                                args=_args) as tsp:
                for fid in ticket.flows:
                    tsp.flow_step(fid)
                t3 = time.perf_counter()
                ops = cigar_mod.traceback_result(
                    res, ticket.pen, pattern=wave.pc, text=wave.tc,
                    plen=wave.plc, tlen=wave.tlc, k_max=wave.k_max,
                    begin_state=ticket.states[0],
                    end_state=ticket.states[1])
                dt = time.perf_counter() - t3
                nbytes = cigar_mod.trace_nbytes(res)
                for st in (ticket.stats, self.stats):
                    st.t_gather += dt
                    st.bytes_out += nbytes
                    st.peak_trace_bytes = max(st.peak_trace_bytes, nbytes)
                for j, orig in enumerate(wave.rows):
                    ticket._cigars[int(orig)] = ops[j]

        eng = self.engine
        optimistic = (eng.edit_frac is not None and eng._s_max is None
                      and ticket._s_cap is None)
        settled = len(wave.rows)     # rows this wave resolved for good
        if wave.recovery:
            n_rec = int((out >= 0).sum())
            for st in (ticket.stats, self.stats):
                st.n_recovered += n_rec
        elif optimistic:
            overflow = wave.rows[out < 0]
            if len(overflow):
                for st in (ticket.stats, self.stats):
                    st.n_overflow += len(overflow)
                obs_metrics.counter("session_overflow_pairs_total",
                                    "pairs past the optimistic bound, "
                                    "queued for exact re-run"
                                    ).inc(len(overflow))
                if obs_trace.enabled():
                    obs_trace.instant("session.overflow", cat="session",
                                      args={"ticket": ticket.index,
                                            "rows": len(overflow)})
                if eng.adaptive:
                    ticket._recovery_rows.append(overflow)
                    settled -= len(overflow)
        ticket._outstanding -= settled
        self._maybe_finish(ticket)
        if (ticket._recovery_rows and
                sum(len(r) for r in ticket._recovery_rows)
                >= self.wave_pairs):
            self._flush_recovery(ticket)    # a full recovery wave is ready

    def _abandon_inflight(self) -> None:
        """Settle and drop every in-flight wave after the session failed.

        The first error poisons the session; the remaining dispatched waves
        are synchronized (their errors swallowed — the first one is the one
        reported) so no device work outlives the session.
        """
        obs_record.dump("session_failure",
                        {"error": repr(self._error) if self._error else None,
                         "inflight_waves": len(self._inflight)})
        with self._lock:
            inflight, self._inflight = list(self._inflight), \
                collections.deque()
        for wave in inflight:
            try:
                wave.xfer.fetch()
            except Exception:
                pass

    def _maybe_finish(self, ticket: Ticket) -> None:
        if not ticket._done and ticket._outstanding == 0:
            self._finalize(ticket)

    def _finalize(self, ticket: Ticket) -> None:
        cig = None
        if ticket._cigars is not None:
            cig = [ticket._cigars[i] for i in range(ticket.n_pairs)]
        ticket._result = EngineResult(ticket._scores, cig, ticket._steps,
                                      ticket._s_hi, ticket._k_hi,
                                      ticket.stats,
                                      approximate=not ticket.heur.exact)
        ticket._p = ticket._t = ticket._plen = ticket._tlen = None
        ticket._done = True
        if ticket._own_flows and ticket.flows:
            with obs_trace.span("session.ticket_done", cat="session",
                                args={"ticket": ticket.index}
                                if obs_trace.enabled() else None) as sp:
                for fid in ticket.flows:
                    sp.flow_end(fid)
        if ticket.internal:
            # BiWFA sub-problem: hand the result to the driver (which may
            # re-enter submit_packed: the lock is re-entrant)
            if ticket._on_done is not None:
                ticket._on_done(ticket)
        else:
            self._completed.append(ticket)

    def _flush_recovery(self, ticket: Optional[Ticket] = None) -> None:
        """Re-run queued overflow pairs with exact worst-case bounds."""
        for t in ([ticket] if ticket is not None else list(self._tickets)):
            if t._recovery_rows:
                rows = np.concatenate(t._recovery_rows)
                t._recovery_rows = []
                if obs_trace.enabled():
                    obs_trace.instant("session.recovery_flush",
                                      cat="session",
                                      args={"ticket": t.index,
                                            "rows": len(rows)})
                self._enqueue_pass(t, rows, exact=True, recovery=True)

    # -- gather --------------------------------------------------------------

    def _raise_if_failed(self) -> None:
        if self._error is not None:
            raise RuntimeError("session failed") from self._error

    def _step(self, ticket: Optional[Ticket] = None) -> None:
        """Make one unit of progress (retire a wave or launch recovery)."""
        self._raise_if_failed()
        if self._inflight:
            self._retire_one()
        elif ticket is not None and ticket._recovery_rows:
            self._flush_recovery(ticket)
        elif any(t._recovery_rows for t in self._tickets):
            self._flush_recovery()
        else:
            raise RuntimeError("session stalled: incomplete tickets with "
                               "no in-flight waves")        # pragma: no cover

    def _wait_for(self, ticket: Ticket) -> None:
        """Drive the pipeline until ``ticket`` is complete."""
        while not ticket._done:
            with self._lock:
                if not ticket._done:
                    self._step(ticket)

    @staticmethod
    def _wave_ready(wave: _Wave) -> bool:
        """True when the wave's results can be gathered without blocking
        (its copy-out event has completed; always on the CPU)."""
        return wave.xfer.ready()

    def _inflight_diagnostics(self) -> str:
        """One-line pipeline state for TimeoutError messages."""
        with self._lock:
            waves = [f"ticket {w.ticket.index}:{len(w.rows)} rows"
                     + (" (recovery)" if w.recovery else "")
                     for w in self._inflight]
            n_open = sum(1 for t in self._tickets if not t._done)
            n_rec = sum(len(r) for t in self._tickets
                        for r in t._recovery_rows)
        return (f"{len(waves)} wave(s) in flight [{'; '.join(waves)}], "
                f"{n_open} ticket(s) incomplete, "
                f"{n_rec} recovery row(s) queued")

    def _step_timed(self, deadline: float) -> None:
        """Make one unit of progress before ``deadline`` or raise
        ``TimeoutError`` (with pipeline diagnostics)."""
        while True:
            with self._lock:
                self._raise_if_failed()
                if self._completed or all(t._done for t in self._tickets):
                    return
                if self._inflight:
                    if self._wave_ready(self._inflight[0]):
                        self._retire_one()
                        return
                elif any(t._recovery_rows for t in self._tickets):
                    self._flush_recovery()
                    return
                else:
                    raise RuntimeError(
                        "session stalled: incomplete tickets with no "
                        "in-flight waves")          # pragma: no cover
            now = time.monotonic()
            if now >= deadline:
                diag = self._inflight_diagnostics()
                obs_record.dump("as_completed_timeout", {"detail": diag})
                raise TimeoutError("as_completed timed out: " + diag)
            time.sleep(min(1e-3, deadline - now))

    def poll(self, *, flush_recovery: bool = True) -> List[Ticket]:
        """Non-blocking progress probe -> tickets that newly completed.

        Retires every in-flight wave whose results have landed, never
        blocking on a running kernel; with ``flush_recovery`` an otherwise
        empty pipeline re-dispatches queued overflow rows at once.
        """
        with self._lock:
            self._raise_if_failed()
            while self._inflight and self._wave_ready(self._inflight[0]):
                self._retire_one()
            if flush_recovery and not self._inflight:
                self._flush_recovery()
                while self._inflight and self._wave_ready(self._inflight[0]):
                    self._retire_one()
            out = list(self._completed)
            self._completed.clear()
            return out

    def as_completed(self, timeout: Optional[float] = None) -> Iterator[Ticket]:
        """Yield tickets as they finish — out of order.  ``timeout`` bounds
        the total wait (``TimeoutError`` with in-flight diagnostics)."""
        deadline = (None if timeout is None
                    else time.monotonic() + float(timeout))
        while True:
            while True:
                with self._lock:
                    ticket = (self._completed.popleft()
                              if self._completed else None)
                if ticket is None:
                    break
                yield ticket
            with self._lock:
                if self._completed:
                    continue
                if all(t._done for t in self._tickets):
                    return
                if deadline is None:
                    self._step()
                    continue
            self._step_timed(deadline)

    def results(self) -> Iterator[EngineResult]:
        """Yield each submit's :class:`EngineResult` in submission order
        (internal BiWFA sub-tickets excluded)."""
        i = 0
        while i < len(self._tickets):
            if not self._tickets[i].internal:
                yield self._tickets[i].result()
            i += 1

    def drain(self) -> SessionStats:
        """Block until every submitted pair (incl. recovery) has a result;
        raises if the session has failed."""
        while True:
            with self._lock:
                self._raise_if_failed()
                if not (self._inflight
                        or any(t._recovery_rows for t in self._tickets)):
                    return self.stats
                self._step()


def run_streamed(engine: AlignmentEngine, p: np.ndarray, plen: np.ndarray,
                 t: np.ndarray, tlen: np.ndarray, *, submit_pairs: int,
                 max_inflight_waves: int = 4,
                 output: Optional[str] = None, penalties=None,
                 heuristic=None, trace_variant: Optional[str] = None):
    """Stream one packed batch through a fresh session in ``submit_pairs``
    chunks with out-of-order gather
    -> (scores, cigars-or-None, SessionStats, wall_seconds)."""
    n = int(p.shape[0])
    out_mode = engine.resolve_output(output,
                                     engine.resolve_penalties(penalties))
    scores = np.empty((n,), np.int32)
    cigars: Optional[List[np.ndarray]] = \
        [None] * n if out_mode == "cigar" else None
    t0 = time.perf_counter()
    with engine.stream(max_inflight_waves=max_inflight_waves) as sess:
        offset = {}
        for lo in range(0, n, submit_pairs):
            hi = min(n, lo + submit_pairs)
            ticket = sess.submit_packed(p[lo:hi], plen[lo:hi],
                                        t[lo:hi], tlen[lo:hi],
                                        output=out_mode,
                                        penalties=penalties,
                                        heuristic=heuristic,
                                        trace_variant=trace_variant)
            offset[ticket.index] = lo
        for ticket in sess.as_completed():
            lo = offset[ticket.index]
            res = ticket.result()
            scores[lo:lo + ticket.n_pairs] = res.scores
            if cigars is not None:
                cigars[lo:lo + ticket.n_pairs] = res.cigars
        stats = sess.stats
    return scores, cigars, stats, time.perf_counter() - t0
