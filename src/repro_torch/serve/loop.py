"""The serve loop: worker threads feeding one shared AlignmentSession.

This is the always-on layer over the streaming engine: callers (any
thread) ``submit()`` independent :class:`AlignRequest`s; the bounded
:class:`RequestQueue` admits or sheds them; worker threads drain
admissions into the :class:`WaveFormer`, dispatch flush-ready waves into
one shared :class:`~repro_torch.core.session.AlignmentSession` (whose
per-bucket specialisation cache means a warm replay creates no new
specialisation), and deliver out-of-order wave retirements back to
per-request futures via the session's non-blocking ``poll()``.
Per-request penalty model, heuristic and output mode ride the engine's
existing per-submit seams — a mixed traffic stream adds one cached kernel
specialisation per (seams, bucket) key and then no more.

The split: the *device* is kept busy by kernels launched on the current
CUDA stream behind the session's backpressure bound; the *threads* only
run host-side work (packing, wave forming, traceback, delivery), which
overlaps the in-flight kernels.  The session serialises every pipeline
step on its re-entrant lock, so two workers never launch or retire at
once; each wave's inputs are copied from freshly pinned host buffers
(PyTorch's caching host allocator reuses a pinned block only once the
copy recorded on it has finished) and its results land in pinned buffers
of its own.

:class:`ServerStats` is the observable contract: queue depth, wave
occupancy / padding waste, shed count, and p50/p95/p99 request latency.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence

from repro_torch.core.engine import AlignmentEngine, Seq
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import record as obs_record
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.queue import RequestQueue
from repro_torch.serve.request import AlignFuture, AlignRequest
from repro_torch.serve.waves import FormedWave, WaveFormer

__all__ = ["ServeLoop", "ServerStats"]


@dataclasses.dataclass(frozen=True)
class ServerStats:
    """One consistent snapshot of the service (``ServeLoop.stats()``).

    Latency percentiles come from the loop's bounded
    :class:`repro_torch.obs.metrics.Histogram` (log-bucketed, so each is within
    one bucket — ≤19% — of exact, in constant memory no matter how long
    the service runs); ``latency_mean``/``latency_max`` stay exact.  The
    same histogram backs the Prometheus ``serve_request_latency_seconds``
    series, so a scrape and this snapshot always agree.
    """
    uptime: float
    queue_depth: int             # admitted, not yet wave-formed
    pending_pairs: int           # forming (accumulated, not dispatched)
    inflight_waves: int
    n_offered: int
    n_accepted: int
    n_shed: int
    n_completed: int
    n_outstanding: int           # accepted, future not yet resolved
    n_pairs_done: int
    n_waves: int                 # device waves dispatched (incl. recovery)
    waves_full: int              # flush reasons (wave-forming telemetry)
    waves_deadline: int
    waves_drain: int
    wave_occupancy: float        # request rows / device rows dispatched
    padding_waste_frac: float
    # first uses of cached kernel specialisations since start (the
    # session's n_traces; 0 = warm): each is one new (backend, model,
    # heuristic, output, shape, bounds) key
    n_retraces: int
    cache_hits: int
    cache_misses: int
    latency_p50: float           # seconds, arrival -> future resolution
    latency_p95: float
    latency_p99: float
    latency_mean: float
    latency_max: float
    n_latency_samples: int

    @property
    def completed_pairs_per_s(self) -> float:
        return self.n_pairs_done / max(self.uptime, 1e-12)


class ServeLoop:
    """Always-on alignment service over one :class:`AlignmentEngine`.

    Parameters
    ----------
    engine : the (ideally pre-warmed) engine; its specialisation cache
        is what keeps a warm replay free of new specialisations.
    wave_pairs : rows per formed wave (the flush-when-full threshold and
        the device batch shape when ``pad_waves``).
    form_deadline : seconds a forming wave may wait for company before a
        deadline flush (the latency end of the deadline-vs-throughput
        dial; per-request ``deadline=`` can only shorten it).
    max_queue_depth : admission bound — arrivals beyond it are shed with
        a typed :class:`~repro_torch.serve.request.ShedError`.
    max_inflight_waves : session backpressure (device memory bound).
    n_threads : worker threads sharing the session (host-side work
        overlaps in-flight kernels; 1 is enough at CPU smoke scale).
    pad_waves : pad partial (deadline/drain) flushes to ``wave_pairs``
        rows in-bucket so every wave hits one cached specialisation.
    poll_interval : worker nap between polls when nothing progressed.
    """

    def __init__(self, engine: AlignmentEngine, *, wave_pairs: int = 256,
                 form_deadline: float = 0.02, max_queue_depth: int = 1024,
                 max_inflight_waves: int = 2, n_threads: int = 1,
                 pad_waves: bool = True, poll_interval: float = 1e-3,
                 min_bucket_len: Optional[int] = None):
        if n_threads < 1:
            raise ValueError("n_threads must be >= 1")
        self.engine = engine
        self.wave_pairs = int(wave_pairs)
        self.n_threads = int(n_threads)
        self.max_inflight_waves = int(max_inflight_waves)
        self.poll_interval = float(poll_interval)
        self._queue = RequestQueue(max_queue_depth)
        self._former = WaveFormer(
            wave_pairs, form_deadline, pad_to_full=pad_waves,
            min_bucket_len=(engine.min_bucket_len if min_bucket_len is None
                            else min_bucket_len))
        self._mutex = threading.RLock()
        self._session = None
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        self._started = False
        self._error: Optional[BaseException] = None
        self._live: set = set()          # accepted, future unresolved
        # bounded latency distribution (not a stored sample list) —
        # per-loop so concurrent/warm loops don't pollute each other;
        # attached to the global registry at start() so a Prometheus
        # scrape sees the live server's series
        self._latency_hist = obs_metrics.Histogram(
            "serve_request_latency_seconds",
            "arrival -> future-resolution latency")
        self._t_start = 0.0
        self._n_accepted = 0
        self._n_completed = 0
        self._n_pairs_done = 0
        self._pairs_real = 0             # request rows dispatched
        self._wave_reasons: Dict[str, int] = {"full": 0, "deadline": 0,
                                              "drain": 0}

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ServeLoop":
        if self._started:
            raise RuntimeError("server already started")
        self._started = True
        self._t_start = time.monotonic()
        obs_metrics.REGISTRY.attach(self._latency_hist)
        # Flight recorder: a live server always keeps the post-mortem
        # ring warm, so a shed/timeout/failure can dump recent history
        # even when full tracing is off.  Released in stop().
        obs_record.acquire()
        self._rec_held = True
        self._session = self.engine.stream(
            max_inflight_waves=self.max_inflight_waves,
            wave_pairs=self.wave_pairs)
        for i in range(self.n_threads):
            th = threading.Thread(target=self._run, daemon=True,
                                  name=f"serve-align-{i}")
            th.start()
            self._threads.append(th)
        return self

    def stop(self) -> ServerStats:
        """Stop admissions, drain everything in flight, join workers.

        Every accepted request's future is resolved before this returns
        (with a result, or with the loop's failure if one occurred).
        """
        try:
            self._stop.set()
            self._queue.close()
            for th in self._threads:
                th.join()
            self._threads = []
            if self._error is not None:
                raise RuntimeError("serve loop failed") from self._error
            if self._session is not None:
                self._session.close()
            return self.stats()
        finally:
            if getattr(self, "_rec_held", False):
                self._rec_held = False
                obs_record.release()

    def __enter__(self) -> "ServeLoop":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.stop()
        return False

    # -- submission (any thread) ---------------------------------------------

    def submit(self, patterns: Sequence[Seq], texts: Sequence[Seq], *,
               penalties=None, heuristic=None, output: Optional[str] = None,
               deadline: Optional[float] = None) -> AlignFuture:
        """Pack on the caller's thread, then admit. Returns the future."""
        return self.submit_request(AlignRequest.from_seqs(
            patterns, texts, penalties=penalties, heuristic=heuristic,
            output=output, deadline=deadline))

    def submit_packed(self, p, plen, t, tlen, *, penalties=None,
                      heuristic=None, output: Optional[str] = None,
                      deadline: Optional[float] = None) -> AlignFuture:
        return self.submit_request(AlignRequest(
            p, plen, t, tlen, penalties=penalties, heuristic=heuristic,
            output=output, deadline=deadline))

    def submit_request(self, req: AlignRequest) -> AlignFuture:
        """Admission control: resolve the request's seams, then offer it
        to the bounded queue.  The returned future resolves exactly once —
        with an :class:`AlignResult`, the resolution error, or a
        :class:`~repro_torch.serve.request.ShedError`."""
        if not self._started:
            raise RuntimeError("server not started")
        try:
            # fail fast (typed, on the future) before the queue ever sees
            # an un-servable request — same checks a session submit runs
            req.pen = self.engine.resolve_penalties(req.penalties)
            req.out = self.engine.resolve_output(req.output, req.pen)
            req.heur = self.engine.resolve_heuristic(req.heuristic, req.out)
        except Exception as e:
            req.future.set_exception(e)
            return req.future
        if req.n_pairs == 0:
            req.t_arrival = time.monotonic()
            with self._mutex:
                self._n_accepted += 1
                self._n_completed += 1
                self._latency_hist.observe(req._resolve(req.t_arrival))
            return req.future
        with obs_trace.span("serve.admit", cat="serve",
                            args={"request": req.request_id,
                                  "pairs": req.n_pairs}
                            if obs_trace.enabled() else None) as sp:
            if obs_trace.enabled():
                # the request's flow: the arrow Perfetto draws from this
                # admit through form/dispatch/kernel/retire to delivery
                req.flow_id = obs_trace.new_flow()
                sp.flow_start(req.flow_id)
            with self._mutex:
                self._live.add(req)
                self._n_accepted += 1
            if not self._queue.offer(req):   # shed: future already resolved
                with self._mutex:
                    self._live.discard(req)
                    self._n_accepted -= 1
                obs_metrics.counter("serve_shed_total",
                                    "requests rejected by admission "
                                    "control").inc()
                if obs_trace.enabled():
                    obs_trace.instant("serve.shed", cat="serve",
                                      args={"request": req.request_id})
                obs_record.dump("shed",
                                {"request": req.request_id,
                                 "n_pairs": req.n_pairs,
                                 "queue_depth": len(self._queue)})
        return req.future

    # -- observability -------------------------------------------------------

    def stats(self) -> ServerStats:
        with self._mutex:
            lat = self._latency_hist
            sess = self._session.stats if self._session is not None else None
            return ServerStats(
                uptime=(time.monotonic() - self._t_start
                        if self._started else 0.0),
                queue_depth=len(self._queue),
                pending_pairs=self._former.n_pending,
                inflight_waves=(self._session.n_inflight
                                if self._session is not None else 0),
                n_offered=self._queue.n_offered,
                n_accepted=self._n_accepted,
                n_shed=self._queue.n_shed,
                n_completed=self._n_completed,
                n_outstanding=len(self._live),
                n_pairs_done=self._n_pairs_done,
                n_waves=sess.n_waves if sess else 0,
                waves_full=self._wave_reasons["full"],
                waves_deadline=self._wave_reasons["deadline"],
                waves_drain=self._wave_reasons["drain"],
                wave_occupancy=(self._pairs_real / sess.rows_padded
                                if sess and sess.rows_padded else 1.0),
                padding_waste_frac=(1.0 - self._pairs_real / sess.rows_padded
                                    if sess and sess.rows_padded else 0.0),
                n_retraces=sess.n_traces if sess else 0,
                cache_hits=sess.cache_hits if sess else 0,
                cache_misses=sess.cache_misses if sess else 0,
                latency_p50=lat.quantile(0.5), latency_p95=lat.quantile(0.95),
                latency_p99=lat.quantile(0.99),
                latency_mean=lat.mean,
                latency_max=lat.max if lat.count else float("nan"),
                n_latency_samples=lat.count)

    # -- worker loop ---------------------------------------------------------

    def _idle(self) -> bool:
        with self._mutex:
            return (len(self._queue) == 0 and self._former.n_pending == 0
                    and not self._live)

    def _run(self) -> None:
        try:
            while True:
                progressed = self._serve_step(time.monotonic())
                if self._stop.is_set() and self._idle():
                    return
                if not progressed:
                    timeout = self.poll_interval
                    with self._mutex:
                        nd = self._former.next_deadline()
                    if nd is not None:
                        timeout = min(timeout, nd - time.monotonic())
                    self._queue.wait(max(timeout, 1e-4))
        except BaseException as e:         # noqa: BLE001 - fail the service
            self._fail(e)

    def _serve_step(self, now: float) -> bool:
        """One scheduling round: admit -> form -> dispatch -> deliver."""
        progressed = False
        arrivals = self._queue.drain()
        obs_metrics.gauge("serve_queue_depth",
                          "admitted requests not yet wave-formed"
                          ).set(len(self._queue))
        obs_trace.counter("queue_depth", len(self._queue), cat="serve")
        if arrivals:
            progressed = True
            with self._mutex:
                for req in arrivals:
                    self._former.add(req, now)
        with self._mutex:
            waves = (self._former.flush_all() if self._stop.is_set()
                     else self._former.take_ready(now))
        if waves:
            with obs_trace.span("serve.form", cat="serve",
                                args={"waves": len(waves)}
                                if obs_trace.enabled() else None) as sp:
                for wave in waves:
                    for sl in wave.slices:
                        if sl.request.flow_id:
                            sp.flow_step(sl.request.flow_id)
        for wave in waves:
            progressed = True
            self._dispatch(wave)
        for ticket in self._session.poll():
            progressed = True
            self._deliver(ticket)
        return progressed

    def _dispatch(self, wave: FormedWave) -> None:
        pen, heur, out, _bucket = wave.key
        flows = tuple(sl.request.flow_id for sl in wave.slices
                      if sl.request.flow_id)
        with obs_trace.span("serve.dispatch", cat="serve",
                            args={"rows": int(wave.p.shape[0]),
                                  "real": wave.n_real,
                                  "reason": wave.reason}
                            if obs_trace.enabled() else None) as sp:
            for fid in flows:
                sp.flow_step(fid)
            ticket = self._session.submit_packed(
                wave.p, wave.plen, wave.t, wave.tlen, output=out,
                penalties=pen, heuristic=heur, meta=wave,
                _flows=flows)
        del ticket
        with self._mutex:
            self._pairs_real += wave.n_real
            self._wave_reasons[wave.reason] += 1

    def _deliver(self, ticket) -> None:
        wave: FormedWave = ticket.meta
        res = ticket.result()                # completed: no blocking
        now = time.monotonic()
        with obs_trace.span("serve.deliver", cat="serve",
                            args={"slices": len(wave.slices)}
                            if obs_trace.enabled() else None) as sp, \
                self._mutex:
            for sl in wave.slices:
                scores = res.scores[sl.row_lo: sl.row_lo + sl.n]
                cigars = (res.cigars[sl.row_lo: sl.row_lo + sl.n]
                          if res.cigars is not None else None)
                done = sl.request._deliver_rows(
                    slice(sl.req_lo, sl.req_lo + sl.n), scores, cigars)
                if done:
                    if sl.request.flow_id:
                        sp.flow_end(sl.request.flow_id)
                    self._latency_hist.observe(sl.request._resolve(now))
                    self._live.discard(sl.request)
                    self._n_completed += 1
                    self._n_pairs_done += sl.request.n_pairs

    def _fail(self, e: BaseException) -> None:
        """Poison the service: every unresolved accepted future gets the
        failure (exactly-once answering holds even on the error path)."""
        obs_record.dump("serve_failure", {"error": repr(e)})
        with self._mutex:
            if self._error is None:
                self._error = e
            live = list(self._live)
            self._live.clear()
        self._stop.set()
        self._queue.close()
        for req in self._queue.drain():
            live.append(req)
        for req in live:
            try:
                req.future.set_exception(e)
            except Exception:                # already resolved: keep first
                pass
