"""CLI over ``repro_torch.obs.analyze``: phase tables, slow waves, diffs.

The port's counterpart of the JAX package's ``launch/obs_report.py``, with
the same modes, printed text and exit codes.  It reads the Chrome-trace
JSON that ``--trace-out`` / the flight recorder write, or ``BENCH_*.json``
snapshots (rows of ``{"name", "us_per_call"}``), and prints the
paper-style accounting:

* phase table — scatter/kernel/gather/traceback totals mapped onto the
  paper's Fig. 1 transfer/kernel/retrieve split
* pipeline report — occupancy, bubbles (idle gaps between waves),
  host/wave overlap fraction; "busy" is waves in flight as the host sees
  them (the ``inflight_waves`` counter), not the card's own busy time
* top-k slowest kernel waves with their args
* per-request latency breakdown from flow critical paths
* ``--diff A B`` — A/B attribution: which (suite, phase) moved

Examples::

    python -m repro_torch.launch.align --backend kernel --pairs 65536 \\
        --chunk-pairs 4096 --mode stream --trace-out t.json
    python -m repro_torch.launch.obs_report t.json --assert-phases
    python -m repro_torch.launch.obs_report t.json --top-k 16
    python -m repro_torch.launch.obs_report --diff a.json b.json
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from typing import Dict, List, Optional

from repro_torch.obs import analyze

__all__ = ["main"]


def _fmt_us(us: float) -> str:
    if us >= 1e6:
        return f"{us / 1e6:.3f}s"
    if us >= 1e3:
        return f"{us / 1e3:.2f}ms"
    return f"{us:.0f}us"


def _print_phase_table(pt: analyze.PhaseTable) -> None:
    print("phase table (paper Fig. 1 split)")
    print(f"  {'phase':<10} {'paper phase':<26} {'total':>10} "
          f"{'count':>6} {'mean':>10} {'max':>10} {'share':>7}")
    for ph in analyze.PHASE_ORDER:
        if ph not in pt.stats:
            continue
        st = pt.stats[ph]
        paper = analyze.PAPER_PHASE.get(ph, "")
        print(f"  {ph:<10} {paper:<26} {_fmt_us(st.total_us):>10} "
              f"{st.count:>6} {_fmt_us(st.mean_us):>10} "
              f"{_fmt_us(st.max_us):>10} {pt.share(ph):>6.1%}")
    print(f"  accounted {_fmt_us(pt.accounted_us)} over "
          f"{_fmt_us(pt.wall_us)} wall")


def _print_pipeline(rep: analyze.PipelineReport) -> None:
    print("pipeline")
    print(f"  device busy {_fmt_us(rep.busy_us)} / span "
          f"{_fmt_us(rep.span_us)} (occupancy {rep.occupancy:.1%}, "
          f"mean inflight {rep.mean_inflight:.2f})")
    print(f"  bubbles: {len(rep.bubbles)} totalling "
          f"{_fmt_us(rep.bubble_us)}")
    for b in sorted(rep.bubbles, key=lambda b: b.dur_us, reverse=True)[:5]:
        print(f"    at {_fmt_us(b.ts)}: idle {_fmt_us(b.dur_us)}")
    print(f"  host packing/gather {_fmt_us(rep.host_busy_us)}, "
          f"{rep.host_overlap_frac:.1%} overlapped with device")


def _print_slow_waves(trace: analyze.Trace, k: int) -> None:
    waves = analyze.slow_waves(trace, k=k)
    if not waves:
        return
    print(f"top-{len(waves)} slow kernel waves")
    for s in waves:
        extra = " ".join(f"{k_}={v}" for k_, v in sorted(s.args.items()))
        print(f"  {_fmt_us(s.dur):>10} at {_fmt_us(s.ts)}  {extra}")


def _print_flows(trace: analyze.Trace) -> None:
    paths = analyze.critical_paths(trace)
    if not paths:
        return
    lats = sorted(p.latency_us for p in paths)

    def q(p: float) -> float:
        i = min(len(lats) - 1, int(p * len(lats)))
        return lats[i]

    print(f"request critical paths ({len(paths)} flows)")
    print(f"  latency p50 {_fmt_us(q(0.50))}  p95 {_fmt_us(q(0.95))}  "
          f"max {_fmt_us(lats[-1])}")
    seg_dur: Dict[str, List[float]] = {}
    seg_wait: Dict[str, List[float]] = {}
    for p in paths:
        for s in p.segments:
            seg_dur.setdefault(s.name, []).append(s.dur_us)
            seg_wait.setdefault(s.name, []).append(s.wait_us)
    for name in sorted(seg_dur):
        print(f"  {name:<22} mean {_fmt_us(statistics.fmean(seg_dur[name])):>9}"
              f"  wait {_fmt_us(statistics.fmean(seg_wait[name])):>9}"
              f"  n={len(seg_dur[name])}")


def _load_rows(path: str) -> Optional[Dict[str, float]]:
    """BENCH snapshot → name→value map, or None if not a snapshot."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "rows" not in doc:
        return None
    return {r["name"]: float(r["us_per_call"]) for r in doc["rows"]}


def _report_one(path: str, top_k: int, assert_phases: bool) -> int:
    trace = analyze.Trace.from_file(path)
    pt = analyze.phase_accounting(trace)
    print(f"== {path} ==")
    _print_phase_table(pt)
    _print_pipeline(analyze.pipeline_analysis(trace))
    _print_slow_waves(trace, top_k)
    _print_flows(trace)
    if assert_phases and pt.is_empty():
        print("ERROR: empty phase table (no wave.* spans in trace)",
              file=sys.stderr)
        return 1
    return 0


def _diff(path_a: str, path_b: str) -> int:
    rows_a, rows_b = _load_rows(path_a), _load_rows(path_b)
    print(f"== diff {path_a} -> {path_b} ==")
    if rows_a is not None and rows_b is not None:
        deltas = analyze.diff_rows(rows_a, rows_b)
        if not deltas:
            print("no common rows")
            return 1
        print(f"  {'row':<34} {'a':>12} {'b':>12} {'ratio':>8}")
        for d in deltas[:20]:
            print(f"  {d.name:<34} {d.a:>12.4g} {d.b:>12.4g} "
                  f"{d.ratio:>8.3f}")
        worst = deltas[0]
        print(f"biggest mover: suite={worst.suite} phase={worst.phase} "
              f"({worst.a:.4g} -> {worst.b:.4g}, {worst.ratio:.3f}x)")
        return 0
    if rows_a is None and rows_b is None:
        ta = analyze.Trace.from_file(path_a)
        tb = analyze.Trace.from_file(path_b)
        deltas = analyze.diff_phase_tables(analyze.phase_accounting(ta),
                                           analyze.phase_accounting(tb))
        if not deltas:
            print("no phases in either trace")
            return 1
        print(f"  {'phase':<12} {'a':>12} {'b':>12} {'ratio':>8}")
        for d in deltas:
            print(f"  {d.phase:<12} {_fmt_us(d.a_us):>12} "
                  f"{_fmt_us(d.b_us):>12} {d.ratio:>8.3f}")
        worst = deltas[0]
        print(f"biggest mover: phase={worst.phase} "
              f"({_fmt_us(worst.a_us)} -> {_fmt_us(worst.b_us)}, "
              f"{worst.ratio:.3f}x)")
        return 0
    print("ERROR: --diff needs two traces or two BENCH snapshots, "
          "not one of each", file=sys.stderr)
    return 2


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="obs_report",
        description="Analyze repro trace captures / bench snapshots.")
    ap.add_argument("paths", nargs="+",
                    help="trace JSON (or two BENCH_*.json with --diff)")
    ap.add_argument("--diff", action="store_true",
                    help="A/B attribution between exactly two captures")
    ap.add_argument("--top-k", type=int, default=8,
                    help="slow waves to list (default 8)")
    ap.add_argument("--assert-phases", action="store_true",
                    help="exit 1 if the phase table is empty (CI smoke)")
    args = ap.parse_args(argv)

    if args.diff:
        if len(args.paths) != 2:
            ap.error("--diff takes exactly two paths")
        return _diff(args.paths[0], args.paths[1])
    rc = 0
    for p in args.paths:
        rc = max(rc, _report_one(p, args.top_k, args.assert_phases))
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
