"""Always-on alignment service launcher (in-process open-loop driver), on
the card.

Not the LM-serving launcher — ``launch/serve.py`` serves models
(prefill/decode over a KV cache); *this* launcher runs the **alignment**
service: ``repro_torch.serve.ServeLoop`` worker threads feeding one shared
streaming session with continuous batching, admission control and
out-of-order delivery.  The driver is in-process and open-loop (a
deterministic Poisson arrival trace replayed at a configured offered load
— no network dependency); wrap ``ServeLoop.submit()`` in your transport of
choice to serve real traffic.  On ``--backend kernel`` every wave runs the
CUDA score kernel (the trace kernel with ``--output cigar``).

Examples::

    # moderate load, calibrated to 75% of the card's batch-mode pairs/s
    PYTHONPATH=src python -m repro_torch.launch.serve_align \\
        --backend kernel --requests 512

    # on the CPU, explicit rate, per-request seams, latency budget and a
    # tight queue
    PYTHONPATH=src python -m repro_torch.launch.serve_align --device cpu \\
        --requests 64 --rate 500 --penalties edit \\
        --heuristic adaptive:10,50 --output cigar --deadline-ms 200 \\
        --queue-depth 64
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import numpy as np

from repro_torch import obs
from repro_torch.core import scoring
from repro_torch.core.backends import available_backends
from repro_torch.core.engine import AlignmentEngine
from repro_torch.data.reads import ArrivalSpec, generate_trace
from repro_torch.serve import ServeLoop, replay_trace


def main(argv=None, summary: Optional[dict] = None) -> int:
    """Run the launcher; -> exit code.  ``summary`` (optional dict) is
    filled with the engine, the trace's payloads, the replay's
    :class:`~repro_torch.serve.ReplayReport` and the new specialisations
    counted during it."""
    ap = argparse.ArgumentParser(
        description="open-loop driver for the always-on alignment service")
    ap.add_argument("--requests", type=int, default=512)
    ap.add_argument("--pairs-per-request", type=int, default=8)
    ap.add_argument("--read-len", type=int, default=100)
    ap.add_argument("--edit-frac", type=float, default=0.02)
    ap.add_argument("--backend", choices=available_backends(),
                    default="ring")
    ap.add_argument("--device", default="cuda",
                    help="torch device the waves run on (default cuda)")
    ap.add_argument("--rate", type=float, default=None,
                    help="offered load in requests/s (default: --load x "
                         "measured batch-mode throughput)")
    ap.add_argument("--load", type=float, default=0.75,
                    help="offered load as a fraction of batch-mode "
                         "pairs/s when --rate is not given")
    ap.add_argument("--wave-pairs", type=int, default=256,
                    help="rows per formed wave (flush-when-full bound)")
    ap.add_argument("--form-deadline-ms", type=float, default=25.0,
                    help="max ms a forming wave waits for company")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request latency budget (shortens forming)")
    ap.add_argument("--queue-depth", type=int, default=4096,
                    help="admission bound; arrivals beyond it are shed")
    ap.add_argument("--threads", type=int, default=1,
                    help="serve-loop worker threads")
    ap.add_argument("--output", default="score",
                    choices=["score", "cigar"])
    ap.add_argument("--penalties", default=None,
                    help="edit | linear:x,e | affine:x,o,e | x,o,e")
    ap.add_argument("--heuristic", default=None,
                    help="adaptive[:min_len,max_diff] | zdrop:z | none")
    ap.add_argument("--seed", type=int, default=13)
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="capture the measured replay as Chrome trace-event"
                         " JSON (open in ui.perfetto.dev)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="wrap the measured replay in torch.profiler; "
                         "writes DIR/trace.json")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="append one obs.metrics JSONL snapshot after the "
                         "replay")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="N",
                    help="serve the live Prometheus /metrics endpoint on "
                         "this port for the duration of the run")
    args = ap.parse_args(argv)

    msrv = None
    if args.metrics_port is not None:
        msrv = obs.metrics.start_http_server(args.metrics_port)
        print(f"[serve_align] metrics endpoint -> "
              f"http://localhost:{args.metrics_port}/metrics",
              file=sys.stderr)
    try:
        return _run(args, {} if summary is None else summary)
    finally:
        if msrv is not None:
            msrv.shutdown()


def batch_pairs_per_s(eng: AlignmentEngine, payloads, *, penalties=None,
                      heuristic=None, output: Optional[str] = None
                      ) -> float:
    """Batch-mode pairs/s of all the trace's pairs on ``eng``: one call to
    warm up, then one timed call.  ``--load`` is a fraction of this rate,
    taken in the engine's default output (scores) whatever ``--output``
    is."""
    P, plen, T, tlen = (np.concatenate(a) for a in zip(*payloads))
    for _ in range(2):           # the second call is the one timed
        t0 = time.perf_counter()
        eng.align_packed(P, plen, T, tlen, output=output,
                         penalties=penalties, heuristic=heuristic)
    return len(plen) / (time.perf_counter() - t0)


def _run(args, summary: dict) -> int:
    pen = (scoring.parse_penalties(args.penalties)
           if args.penalties else None)
    heur = (scoring.parse_heuristic(args.heuristic)
            if args.heuristic else None)
    eng = AlignmentEngine(backend=args.backend, edit_frac=args.edit_frac,
                          device=args.device)

    spec = ArrivalSpec(n_requests=args.requests,
                       pairs_per_request=args.pairs_per_request,
                       read_len=args.read_len, edit_frac=args.edit_frac,
                       seed=args.seed)
    payloads, unit_arrivals = generate_trace(spec)

    rate = args.rate
    if rate is None:
        batch_pps = batch_pairs_per_s(eng, payloads, penalties=pen,
                                      heuristic=heur)
        rate = args.load * batch_pps / args.pairs_per_request
        print(f"[serve_align] batch mode on {eng.device}: "
              f"{batch_pps:,.0f} pairs/s -> offered {rate:,.0f} req/s "
              f"({args.load:.0%} load)", file=sys.stderr)
        summary["batch_pairs_per_s"] = batch_pps

    # warm the serving wave shape so the replay is steady-state
    n_warm = min(args.requests,
                 max(2 * args.wave_pairs // args.pairs_per_request, 2))
    with ServeLoop(eng, wave_pairs=args.wave_pairs,
                   form_deadline=args.form_deadline_ms / 1e3,
                   max_queue_depth=args.queue_depth,
                   n_threads=args.threads) as warm:
        replay_trace(warm, payloads[:n_warm], np.zeros(n_warm),
                     penalties=pen, heuristic=heur, output=args.output)
    traces0 = eng.cache_traces()

    with obs.capture_trace(args.trace_out), \
            obs.profile.profile(args.profile), \
            ServeLoop(eng, wave_pairs=args.wave_pairs,
                      form_deadline=args.form_deadline_ms / 1e3,
                      max_queue_depth=args.queue_depth,
                      n_threads=args.threads) as server:
        report = replay_trace(
            server, payloads, unit_arrivals / rate, penalties=pen,
            heuristic=heur, output=args.output,
            deadline=(None if args.deadline_ms is None
                      else args.deadline_ms / 1e3))
    st = report.stats
    if args.trace_out:
        print(f"[serve_align] trace -> {args.trace_out}", file=sys.stderr)
    if args.metrics_out:
        obs.metrics.write_jsonl(args.metrics_out)
        print(f"[serve_align] metrics -> {args.metrics_out}",
              file=sys.stderr)

    print(f"[serve_align] {report.n_ok}/{report.n_requests} served, "
          f"{report.n_shed} shed, {report.n_failed} failed "
          f"(driver lag max {report.lag_max * 1e3:.1f} ms)")
    print(f"[serve_align] sustained {report.sustained_pairs_per_s:,.0f} "
          f"pairs/s over {report.t_sustained:.2f}s")
    print(f"[serve_align] latency p50 {report.percentile_ms(50):.1f} ms | "
          f"p95 {report.percentile_ms(95):.1f} ms | "
          f"p99 {report.percentile_ms(99):.1f} ms "
          f"({report.latencies.size} completions)")
    print(f"[serve_align] waves: {st.n_waves} dispatched "
          f"({st.waves_full} full / {st.waves_deadline} deadline / "
          f"{st.waves_drain} drain), occupancy {st.wave_occupancy:.2f}, "
          f"padding waste {st.padding_waste_frac:.2f}")
    fresh = eng.cache_traces() - traces0
    print(f"[serve_align] specialisation cache: {st.cache_hits} hits, "
          f"{st.cache_misses} misses, {fresh} new specialisations during "
          f"the replay")
    summary.update(engine=eng, payloads=payloads, report=report,
                   rate=rate, fresh_specialisations=fresh)
    return 0 if report.n_failed == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
