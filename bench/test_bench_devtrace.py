"""The reading of a profiler trace, on a small trace made up here: busy
time and idle gaps of the slice, each kernel's launch found by its
correlation, names shortened, gaps labelled by the innermost span, and
the span shares."""
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from harness import align_loop, devtrace, spans  # noqa: E402

KERNEL = ("void (anonymous namespace)::wfa_full_kernel<true, false, 0>"
          "((anonymous namespace)::FullParams)")
TRACE_KERNEL = KERNEL.replace("true, false", "true, true")


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


EVENTS = [
    _x("user_annotation", "bench.slice", 100.0, 900.0),
    _x("user_annotation", "bench.clock", 90.0, 1.0),
    _x("user_annotation", "bench.submit#7", 110.0, 50.0),
    _x("cuda_runtime", "cudaLaunchKernel", 150.0, 2.0, correlation=41),
    _x("kernel", KERNEL, 200.0, 100.0, correlation=41),
    _x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 250.0, 100.0),
    _x("cuda_runtime", "cudaLaunchKernel", 500.0, 2.0, correlation=42),
    _x("kernel", TRACE_KERNEL, 600.0, 50.0, correlation=42),
    _x("kernel", KERNEL, 980.0, 40.0, correlation=43),   # past the slice
    _x("cpu_op", "aten::copy_", 120.0, 5.0),
    {"ph": "i", "name": "instant", "ts": 3.0},
]


def test_busy_gaps_and_ops(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    dt = devtrace.DeviceTrace.load(str(path))
    a, b = dt.annotation("bench.slice")
    assert (a, b) == (100.0, 1000.0)
    busy = dt.busy_intervals(a, b)
    assert busy.tolist() == [[200.0, 350.0], [600.0, 650.0], [980.0, 1000.0]]
    gaps = dt.idle_gaps(a, b)
    assert gaps.tolist() == [[100.0, 200.0], [350.0, 600.0], [650.0, 980.0]]
    ops = dict(dt.op_seconds(a, b))
    assert ops["wfa_full_kernel<true, false, 0>"] == (100.0 + 20.0) / 1e6
    assert ops["Memcpy HtoD (Pinned -> Device)"] == 100.0 / 1e6
    ks = dt.kernels(a, b)
    assert [k["launch_ts"] for k in ks] == [150.0, 500.0]
    assert [align_loop.kernel_kind(k["name"]) for k in ks] == ["score",
                                                              "trace"]
    assert align_loop.kernel_kind("Memcpy HtoD (Pinned -> Device)") is None


def test_gap_labels_take_the_innermost_span():
    sp = [(0.0, 100.0, "session.submit"), (10.0, 60.0, "wave.scatter"),
          (100.0, 200.0, "wave.kernel"), (150.0, 160.0, "wave.gather")]
    times = np.array([55.0, 5.0, 155.0, 120.0, 300.0, 60.0])
    assert devtrace.label_times(times, sp) == [
        "wave.scatter", "session.submit", "wave.gather", "wave.kernel", None,
        "wave.scatter"]


def test_span_share_counts_nested_spans_once():
    ev = [{"ph": "X", "name": "wave.scatter", "ts": 10.0, "dur": 30.0},
          {"ph": "X", "name": "wave.scatter", "ts": 20.0, "dur": 30.0},
          {"ph": "X", "name": "wave.scatter", "ts": 90.0, "dur": 30.0},
          {"ph": "X", "name": "wave.kernel", "ts": 0.0, "dur": 100.0},
          {"ph": "C", "name": "wave.scatter", "ts": 0.0}]
    assert spans.share_pct(ev, "wave.scatter", 0.0, 100.0) == 50.0


def test_every_reader_reads_a_run_or_returns_none():
    """Each file under metrics/, listed or kept for a later cell, reads a
    made-up run: a number where it finds its input, None where not."""
    from types import SimpleNamespace
    from harness import spec
    ev = [{"ph": "X", "name": n, "ts": t, "dur": 10.0}
          for n, t in (("wave.scatter", 0.0), ("wave.traceback", 20.0),
                       ("bidir.stitch", 40.0))]
    full = SimpleNamespace(
        spans={"events": ev, "a": 0.0, "b": 100.0},
        stats=SimpleNamespace(bytes_in=400), bases_in=100,
        dev={"busy_s": 1.0, "window_s": 4.0}, launches=[], ref_scores={},
        seconds=20.0, window_pairs=1000)
    empty = SimpleNamespace(spans=None, stats=None, bases_in=0, dev=None,
                            launches=[], ref_scores={}, seconds=0.0,
                            window_pairs=0)
    names = sorted(f[:-3] for f in os.listdir(os.path.join(HERE, "metrics"))
                   if f.endswith(".py"))
    got = {n: spec.reader(n)(full) for n in names}
    assert got["session.scatter_pct"] == 10.0
    assert got["decode.traceback_pct"] == 10.0
    assert got["biwfa.stitch_pct"] == 10.0
    assert got["engine.h2d_bytes_per_base"] == 4.0
    assert got["device.idle_pct"] == 75.0
    assert got["session.scatter_pct.score"] == 10.0
    assert got["device.idle_pct.score"] == 75.0
    assert got["session.pairs_per_s"] == 50.0
    assert got["wfa_score_roofline"] is None      # no launch was timed
    assert all(spec.reader(n)(empty) is None for n in names)
