"""The port's trace analysis (``repro_torch.obs.analyze``) and its CLI
(``repro_torch.launch.obs_report``) against the JAX package's.

The same Chrome-trace events go through both ``analyze`` modules and every
returned dataclass must be equal field for field; ``obs_report`` must print
the same text and return the same exit code for the same files; and a
capture of the port's engine must hold the same ``wave.*`` spans as one of
the JAX engine on the same seeded batch (``kernel`` backend: its plain
version and the Pallas kernel in interpret mode)."""
import dataclasses
import json

import numpy as np
import pytest

pytest.importorskip("torch")

from conftest import random_pairs  # noqa: E402
from repro.core.engine import AlignmentEngine as JEngine  # noqa: E402
from repro.core.session import run_streamed as j_run_streamed  # noqa: E402
from repro.launch import obs_report as j_report  # noqa: E402
from repro.obs import analyze as j_an  # noqa: E402
from repro.obs import trace as j_trace  # noqa: E402
from repro_torch.core.engine import AlignmentEngine  # noqa: E402
from repro_torch.core.engine import pack_batch  # noqa: E402
from repro_torch.core.session import run_streamed  # noqa: E402
from repro_torch.launch import obs_report as t_report  # noqa: E402
from repro_torch.obs import analyze as t_an  # noqa: E402
from repro_torch.obs import trace as t_trace  # noqa: E402


# -------------------------------------------------- event constructors ----
# The synthetic trace of the JAX package's analyze tests: two waves with
# exact durations, one 20.5 ms bubble between them, and one cross-thread
# flow (submit on tid 2 -> kernel/gather on tid 1).  Times in us.


def _x(name, ts, dur, tid=1, args=None):
    return {"name": name, "cat": "wave", "ph": "X", "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args or {}}


def _c(name, ts, value):
    return {"name": name, "cat": "repro", "ph": "C", "ts": ts, "pid": 1,
            "tid": 0, "args": {"value": value}}


def _f(ph, fid, ts, tid):
    ev = {"name": "flow", "cat": "flow", "ph": ph, "id": fid, "ts": ts,
          "pid": 1, "tid": tid}
    if ph == "f":
        ev["bp"] = "e"
    return ev


def _i(name, ts, tid=1, args=None):
    return {"name": name, "cat": "session", "ph": "i", "ts": ts, "s": "t",
            "pid": 1, "tid": tid, "args": args or {}}


SYNTHETIC = [
    _x("session.submit", 0, 1_000, tid=2),
    _x("wave.scatter", 0, 10_000, args={"wave": 0}),
    _x("wave.kernel", 10_000, 20_000, args={"wave": 0, "rows": 256}),
    _x("wave.gather", 30_000, 5_000, args={"wave": 0}),
    _x("wave.traceback", 35_000, 2_000, args={"wave": 0}),
    _x("wave.scatter", 60_000, 4_000, args={"wave": 1}),
    _x("wave.kernel", 64_000, 6_000, args={"wave": 1, "rows": 64}),
    _x("wave.gather", 70_000, 1_000, args={"wave": 1}),
    _c("inflight_waves", 500, 1),
    _c("inflight_waves", 40_000, 0),
    _c("inflight_waves", 60_500, 1),
    _c("inflight_waves", 71_000, 0),
    _f("s", 7, 500, tid=2),
    _f("t", 7, 11_000, tid=1),
    _f("f", 7, 30_500, tid=1),
]


def _slowed(events, name, factor):
    return [dict(e, dur=e["dur"] * factor)
            if e["ph"] == "X" and e["name"] == name else e for e in events]


def _random_events(seed, n_waves=24, n_threads=3):
    """A seeded capture-like trace: waves on several threads, nested
    spans, an inflight counter with gaps, flows through the waves and
    instants, at non-integer microseconds."""
    rng = np.random.default_rng(seed)
    ev, t, inflight = [], 0.0, 0
    for w in range(n_waves):
        tid = int(rng.integers(1, n_threads + 1))
        t += float(rng.uniform(0, 3_000))
        fid = int(rng.integers(1, 6))
        sub = float(rng.uniform(50, 400))
        ev.append(_x("session.submit", t, sub, tid=tid + 10))
        ev.append(_f("s" if w < 5 else "t", fid, t + sub / 2, tid + 10))
        for ph in ("scatter", "kernel", "gather", "traceback"):
            if ph == "traceback" and rng.random() < 0.5:
                continue
            d = float(rng.uniform(10, 5_000))
            args = {"ticket": w // 3, "rows": int(rng.integers(1, 512)),
                    "recovery": bool(rng.random() < 0.2)}
            if ph == "scatter":
                args.update(width=64, s_max=int(rng.integers(8, 40)))
            ev.append(_x(f"wave.{ph}", t, d, tid=tid, args=args))
            if rng.random() < 0.4:     # a nested child span
                ev.append(_x("engine.inner", t + d / 4, d / 3, tid=tid))
            ev.append(_f("t", fid, t + d / 2, tid))
            if ph == "scatter":      # in flight from mid-scatter on
                inflight += 1
                ev.append(_c("inflight_waves", t + d / 2, inflight))
            if ph == "kernel":
                inflight -= 1
                ev.append(_c("inflight_waves", t + d, inflight))
            t += d + float(rng.uniform(0, 50))
        if rng.random() < 0.3:
            ev.append(_i("session.overflow", t, tid, {"rows": 3}))
    ev.append(_f("f", 1, t, 1))
    ev.append({"name": "thread_name", "ph": "M", "pid": 1, "tid": 1,
               "args": {"name": "main"}})
    return ev


TRACES = {
    "synthetic": SYNTHETIC,
    "no-counter": [e for e in SYNTHETIC if e["ph"] != "C"],
    "slow-gather": _slowed(SYNTHETIC, "wave.gather", 4),
    "empty": [],
    "random-1": _random_events(1),
    "random-2": _random_events(2, n_waves=60, n_threads=5),
}


# --------------------------------------------------- dataclass equality ----


def _plain(x):
    """A dataclass (or list of them) as plain data, with its computed
    properties, so results of the two modules compare field for field."""
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        out = {"__type__": type(x).__name__}
        for f in dataclasses.fields(x):
            out[f.name] = _plain(getattr(x, f.name))
        for name in dir(type(x)):
            if isinstance(getattr(type(x), name), property):
                out[name] = _plain(getattr(x, name))
        return out
    return x


def _trace_view(tr):
    return _plain([tr.spans, tr.flows, tr.counters, tr.instants,
                   tr.wall_us()])


@pytest.mark.parametrize("name", sorted(TRACES))
def test_analyses_match_reference(name):
    events = TRACES[name]
    jt, tt = j_an.Trace.from_events(events), t_an.Trace.from_events(events)
    assert _trace_view(jt) == _trace_view(tt)
    jp, tp = j_an.phase_accounting(jt), t_an.phase_accounting(tt)
    assert _plain(jp) == _plain(tp)
    assert jp.as_rows() == tp.as_rows()
    assert [jp.share(p) for p in j_an.PHASE_ORDER] == \
        [tp.share(p) for p in t_an.PHASE_ORDER]
    assert jp.is_empty() == tp.is_empty()
    for k in (0, 1, 3, 100):
        assert _plain(j_an.slow_waves(jt, k=k)) == \
            _plain(t_an.slow_waves(tt, k=k))
    assert _plain(j_an.slow_waves(jt, name="wave.gather")) == \
        _plain(t_an.slow_waves(tt, name="wave.gather"))
    assert _plain(j_an.critical_paths(jt)) == \
        _plain(t_an.critical_paths(tt))
    assert _plain(j_an.pipeline_analysis(jt)) == \
        _plain(t_an.pipeline_analysis(tt))
    for ts in sorted({s.ts for s in jt.spans})[:20]:
        for tid in {s.tid for s in jt.spans}:
            assert _plain(jt.enclosing_span(tid, ts + 1)) == \
                _plain(tt.enclosing_span(tid, ts + 1))
    other = TRACES["slow-gather"]
    assert _plain(j_an.diff_phase_tables(
        jp, j_an.phase_accounting(j_an.Trace.from_events(other)))) == \
        _plain(t_an.diff_phase_tables(
            tp, t_an.phase_accounting(t_an.Trace.from_events(other))))


def test_diff_rows_and_module_surface_match_reference():
    a = {"serving/p99_ms": 10.0, "serving/pairs_per_s": 1000.0,
         "obs/on_ratio": 0.97, "phase/kernel_s": 1.0, "zero/x": 0.0,
         "only_a/y": 2.0}
    b = dict(a, **{"phase/kernel_s": 3.0, "serving/p99_ms": 10.5,
                   "zero/x": 1.0, "obs/on_ratio": -1.0, "only_b/z": 5.0})
    del b["only_a/y"]
    assert _plain(j_an.diff_rows(a, b)) == _plain(t_an.diff_rows(a, b))
    assert j_an.__all__ == t_an.__all__
    assert (j_an.SPAN_PHASE, j_an.PAPER_PHASE, j_an.PHASE_ORDER) == \
        (t_an.SPAN_PHASE, t_an.PAPER_PHASE, t_an.PHASE_ORDER)


# ------------------------------------------------------------------ CLI ----


def _snapshot(path, rows):
    path.write_text(json.dumps({"rows": [
        {"name": n, "us_per_call": v, "derived": ""} for n, v in rows]}))


def _files(tmp_path):
    """The inputs of the CLI cases: traces (one as a bare event list) and
    hand-built BENCH snapshots."""
    out = {}
    for name, events in TRACES.items():
        p = tmp_path / f"{name}.json"
        p.write_text(json.dumps({"traceEvents": events,
                                 "displayTimeUnit": "ms"}))
        out[name] = str(p)
    bare = tmp_path / "bare.json"
    bare.write_text(json.dumps(SYNTHETIC))
    out["bare"] = str(bare)
    _snapshot(tmp_path / "BENCH_a.json",
              [("serving/p99_ms", 10.0), ("phase/kernel_s", 1.0),
               ("fig1/pairs_per_s", 1e6)])
    _snapshot(tmp_path / "BENCH_b.json",
              [("serving/p99_ms", 10.5), ("phase/kernel_s", 3.0),
               ("fig1/pairs_per_s", 9e5), ("new/row", 1.0)])
    _snapshot(tmp_path / "BENCH_c.json", [("other/row", 1.0)])
    for k in "abc":
        out[f"bench_{k}"] = str(tmp_path / f"BENCH_{k}.json")
    return out


CLI_CASES = {
    "trace": ["synthetic"],
    "trace-assert": ["synthetic", "--assert-phases"],
    "trace-top-k": ["random-2", "--top-k", "3"],
    "two-traces": ["random-1", "no-counter", "bare"],
    "empty": ["empty"],
    "empty-assert": ["empty", "--assert-phases"],
    "empty-and-trace-assert": ["synthetic", "empty", "--assert-phases"],
    "diff-traces": ["--diff", "synthetic", "slow-gather"],
    "diff-random": ["--diff", "random-1", "random-2"],
    "diff-empty-traces": ["--diff", "empty", "empty"],
    "diff-snapshots": ["--diff", "bench_a", "bench_b"],
    "diff-no-common-rows": ["--diff", "bench_a", "bench_c"],
    "diff-mixed": ["--diff", "bench_a", "synthetic"],
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_obs_report_matches_reference(case, tmp_path, capsys):
    files = _files(tmp_path)
    argv = [files.get(a, a) for a in CLI_CASES[case]]
    rc_j = j_report.main(argv)
    out_j = capsys.readouterr()
    rc_t = t_report.main(argv)
    out_t = capsys.readouterr()
    assert rc_t == rc_j
    assert out_t.out == out_j.out
    assert out_t.err == out_j.err
    assert out_t.out or out_t.err


def test_obs_report_expected_exit_codes(tmp_path):
    """What the CI smoke relies on: an empty phase table fails only under
    --assert-phases; a mixed diff is a usage error."""
    files = _files(tmp_path)
    assert t_report.main([files["synthetic"], "--assert-phases"]) == 0
    assert t_report.main([files["empty"]]) == 0
    assert t_report.main([files["empty"], "--assert-phases"]) == 1
    assert t_report.main(["--diff", files["bench_a"], files["bench_b"]]) == 0
    assert t_report.main(["--diff", files["bench_a"],
                          files["synthetic"]]) == 2
    with pytest.raises(SystemExit):
        t_report.main(["--diff", files["synthetic"]])


# ------------------------------------------------- live engine captures ----


def _capture(tracer, fn):
    """Run ``fn`` with one package's tracer on -> its wave spans and the
    events; the tracer is reset and left as it was."""
    was_on = tracer.enabled()
    tracer.reset()
    tracer.enable()
    try:
        fn()
        events = tracer.events()
    finally:
        (tracer.enable if was_on else tracer.disable)()
        tracer.reset()
    return events


def _wave_view(events):
    """Each wave.* span in time order with the args that describe its
    wave (rows, width, s_max, recovery, ticket)."""
    keep = ("ticket", "rows", "width", "s_max", "recovery")
    spans = sorted((e for e in events if e.get("ph") == "X"
                    and e["name"].startswith("wave.")),
                   key=lambda e: e["ts"])
    return [(e["name"], {k: e["args"][k] for k in keep if k in e["args"]})
            for e in spans]


@pytest.mark.parametrize("output", ["score", "cigar"])
def test_engine_captures_hold_the_same_waves(output):
    """A streamed run over two length buckets with overflow recovery, and
    a blocking run: same wave spans, same counts per phase, same
    args; both captures read by the port's analyze."""
    pats, txts = random_pairs(np.random.default_rng(11), 20, lo=20, hi=60,
                              drift=6)
    P, plen = pack_batch(pats)
    T, tlen = pack_batch(txts)
    kw = dict(backend="kernel", edit_frac=0.02, chunk_pairs=8)
    jeng = JEngine(**kw)
    teng = AlignmentEngine(device="cpu", **kw)

    def run(eng, streamed):
        return lambda: (eng.align(pats, txts, output=output),
                        streamed(eng, P, plen, T, tlen, submit_pairs=8,
                                 output=output))

    jev = _capture(j_trace, run(jeng, j_run_streamed))
    tev = _capture(t_trace, run(teng, run_streamed))
    want, got = _wave_view(jev), _wave_view(tev)
    assert got == want
    names = [n for n, _ in want]
    assert names.count("wave.kernel") >= 6 and \
        ("wave.traceback" in names) == (output == "cigar")
    jt = j_an.Trace.from_events(jev)
    tt = t_an.Trace.from_events(tev)
    jp, tp = j_an.phase_accounting(jt), t_an.phase_accounting(tt)
    assert {p: s.count for p, s in jp.stats.items()} == \
        {p: s.count for p, s in tp.stats.items()}
    assert len(t_an.critical_paths(tt)) == len(j_an.critical_paths(jt))
    counters = lambda tr: [c.value for c in tr.counters
                           if c.name == "inflight_waves"]
    assert counters(tt) == counters(jt)
    rep = t_an.pipeline_analysis(tt)
    assert rep.busy_us > 0 and rep.mean_inflight > 0
