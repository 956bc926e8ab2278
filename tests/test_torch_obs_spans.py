"""The parts of ``wave.scatter`` and ``wave.traceback``, each wave's device
seconds, and the program's spans in the profiler's trace, on the CPU.

``wave.scatter`` holds ``scatter.pack``, ``scatter.stage`` and
``scatter.launch`` in that order; ``wave.traceback`` holds
``traceback.walk`` and ``traceback.replay``; the session's ``t_dev_*``
fields (host seconds of the same steps on the CPU) fold through
``EngineStats.merge``; under ``obs.profile.profile`` the spans become the
trace's user annotations, and with no profile ``record_function`` is never
entered.  No JAX: the reference holds none of these.
"""
import gc
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import gotoh  # noqa: E402
from repro_torch.core import scoring  # noqa: E402
from repro_torch.core import wavefront as wf  # noqa: E402
from repro_torch.core.cigar import (TracebackError,  # noqa: E402
                                    traceback_packed_batch,
                                    traceback_packed_linear_one,
                                    traceback_packed_one)
from repro_torch.core.engine import (AlignmentEngine, EngineStats,  # noqa: E402
                                     pack_batch, problem_bounds)
from repro_torch.core.session import run_streamed  # noqa: E402
from repro_torch.data.reads import ReadPairSpec, generate_pairs  # noqa: E402
from repro_torch.device import kernel_marks, launch_marks  # noqa: E402
from repro_torch.obs import profile as obs_profile  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402

SCATTER_PARTS = ("scatter.pack", "scatter.stage", "scatter.launch")
TRACEBACK_PARTS = ("traceback.walk", "traceback.replay")
DEV_FIELDS = ("t_dev_copy_in", "t_dev_kernel", "t_dev_copy_out")


@pytest.fixture
def tracer():
    """The port's tracer on and empty for one test, then off and empty."""
    obs_trace.reset()
    obs_trace.enable()
    try:
        yield obs_trace
    finally:
        obs_trace.disable()
        obs_trace.reset()


def _engine(**kw):
    return AlignmentEngine(scoring.GapAffine(4, 6, 2), backend="kernel",
                           edit_frac=0.04, chunk_pairs=64, device="cpu", **kw)


def _batch(n=192, seed=5):
    return generate_pairs(ReadPairSpec(n_pairs=n, read_len=100,
                                       edit_frac=0.04, seed=seed))


def _run(eng, mode, output):
    """One pass of the batch, streamed or blocking -> its stats."""
    P, plen, T, tlen = _batch()
    if mode == "stream":
        return run_streamed(eng, P, plen, T, tlen, submit_pairs=64,
                            max_inflight_waves=2, output=output)[2]
    return eng.align_packed(P, plen, T, tlen, output=output).stats


def _spans(events, name):
    return [e for e in events if e.get("ph") == "X" and e["name"] == name]


def _inside(outer, parts_events):
    """Spans of ``parts_events`` on ``outer``'s thread within its extent,
    in time order."""
    lo, hi = outer["ts"], outer["ts"] + outer["dur"]
    return sorted((e for e in parts_events if e["tid"] == outer["tid"]
                   and lo <= e["ts"] and e["ts"] + e["dur"] <= hi),
                  key=lambda e: e["ts"])


def _check_parts(events, outer_name, parts):
    """Every outer span holds its parts once each, in order, without
    overlap; every part lies in an outer span -> (parts' time, outer
    time) summed over the waves."""
    outers = _spans(events, outer_name)
    part_evs = [e for e in events if e.get("ph") == "X"
                and e["name"] in parts]
    assert outers and len(part_evs) == len(parts) * len(outers)
    covered = total = 0.0
    for o in outers:
        inner = _inside(o, part_evs)
        assert [e["name"] for e in inner] == list(parts)
        for a, b in zip(inner, inner[1:]):
            assert a["ts"] + a["dur"] <= b["ts"]
        covered += sum(e["dur"] for e in inner)
        total += o["dur"]
    return covered, total


@pytest.mark.parametrize("mode", ["stream", "blocking"])
def test_scatter_and_traceback_parts_nest_in_order(tracer, mode):
    st = _run(_engine(), mode, "cigar")
    ev = tracer.events()
    covered, total = _check_parts(ev, "wave.scatter", SCATTER_PARTS)
    assert covered >= 0.9 * total, (covered, total)
    covered, total = _check_parts(ev, "wave.traceback", TRACEBACK_PARTS)
    assert covered >= 0.9 * total, (covered, total)
    # the stage span counts the bytes it pinned: the session's bytes in
    assert sum(e["args"]["bytes"] for e in _spans(ev, "scatter.stage")) \
        == st.bytes_in
    pairs = sum(e["args"]["pairs"] for e in _spans(ev, "traceback.walk"))
    assert pairs == st.rows_padded
    for e in _spans(ev, "traceback.walk") + _spans(ev, "traceback.replay"):
        assert e["args"]["edits"] >= 0
    # no new span takes the wave.* prefix: one of each a wave
    names = {e["name"] for e in ev if e.get("ph") == "X"
             and e["name"].startswith("wave.")}
    assert names == {"wave.scatter", "wave.kernel", "wave.gather",
                     "wave.traceback"}


@pytest.mark.parametrize("mode", ["stream", "blocking"])
def test_device_fields_are_positive_and_ride_the_gather_span(tracer, mode):
    st = _run(_engine(), mode, "score")
    for f in DEV_FIELDS:
        assert getattr(st, f) > 0, f
    gathers = _spans(tracer.events(), "wave.gather")
    assert gathers
    for f in DEV_FIELDS:
        assert sum(g["args"][f] for g in gathers) == pytest.approx(
            getattr(st, f), rel=1e-9)


def test_failed_executable_lookup_leaves_the_session_usable(monkeypatch):
    """As the JAX package's session: a lookup that raises before the copy
    in propagates without failing the session."""
    eng = _engine()
    P, plen, T, tlen = _batch(n=64)
    want = eng.align_packed(P, plen, T, tlen).scores
    real, failed = eng._executable_for, []

    def lookup(*a, **kw):
        if not failed:
            failed.append(True)
            raise RuntimeError("lookup failed")
        return real(*a, **kw)

    monkeypatch.setattr(eng, "_executable_for", lookup)
    sess = eng.stream(max_inflight_waves=2)
    with pytest.raises(RuntimeError, match="lookup failed"):
        sess.submit_packed(P, plen, T, tlen)
    assert sess._error is None and sess.n_inflight == 0
    np.testing.assert_array_equal(
        sess.submit_packed(P, plen, T, tlen).result().scores, want)


def test_kernel_marks_collect_only_inside_their_block():
    assert launch_marks(None) == (None, None)
    with kernel_marks() as outer:
        with kernel_marks() as inner:
            assert inner == [] and inner is not outer
        assert outer == []
    assert launch_marks(None) == (None, None)


def test_device_fields_fold_through_merge():
    a = EngineStats(t_dev_copy_in=1.0, t_dev_kernel=2.0, t_dev_copy_out=3.0)
    b = EngineStats(t_dev_copy_in=0.5, t_dev_kernel=0.25,
                    t_dev_copy_out=0.125)
    a.merge(b, count_pairs=False)
    assert (a.t_dev_copy_in, a.t_dev_kernel, a.t_dev_copy_out) == \
        (1.5, 2.25, 3.125)
    # BiWFA children fold in: the parent's result carries their seconds
    eng = AlignmentEngine(scoring.GapAffine(4, 6, 2), backend="kernel",
                          edit_frac=0.05, device="cpu", trace_budget=1500)
    P, plen, T, tlen = generate_pairs(ReadPairSpec(
        n_pairs=4, read_len=240, edit_frac=0.05, seed=2))
    res = eng.align_packed(P, plen, T, tlen, output="cigar",
                           trace_variant="bidir")
    for f in DEV_FIELDS:
        assert getattr(res.stats, f) > 0, f


# -- traceback: walk all, then replay all -------------------------------------


def _edited_pairs(n=24, L=80, seed=3):
    """Pairs with a mismatch, a deletion of 3 and an insertion of 2 at
    seeded places (gap opens and gap extensions), and one untouched."""
    rng = np.random.default_rng(seed)
    pats, txts = [], []
    for i in range(n):
        p = "".join(rng.choice(list("ACGT"), L))
        if i == 0:
            pats.append(p)
            txts.append(p)
            continue
        x, d, s = sorted(rng.choice(np.arange(5, L - 8), 3, replace=False))
        sub = "A" if p[x] != "A" else "C"
        t = p[:x] + sub + p[x + 1:d] + p[d + 3:s] + "GT" + p[s:]
        pats.append(p)
        txts.append(t)
    P, plen = pack_batch(pats)
    T, tlen = pack_batch(txts)
    return P, plen, T, tlen


def _packed(pen):
    P, plen, T, tlen = _edited_pairs()
    s_max, k_max = problem_bounds(pen, plen, tlen, None)
    res = wf.wfa_scores_packed(P, T, plen, tlen, pen=pen, s_max=s_max,
                               k_max=k_max, device="cpu")
    return res, P, plen, T, tlen


def _np(res):
    return {f: (None if getattr(res, f) is None
                else np.asarray(getattr(res, f)))
            for f in ("score", "m_bt", "i_bt", "d_bt")}


@pytest.mark.parametrize("pen", [scoring.GapAffine(4, 6, 2),
                                 scoring.Edit()], ids=["affine", "edit"])
def test_packed_batch_equals_one_pair_at_a_time(pen):
    res, P, plen, T, tlen = _packed(pen)
    a = _np(res)
    score = a["score"].reshape(-1)
    batch = traceback_packed_batch(res, pen, P, T, plen, tlen)
    for b in range(len(score)):
        if pen.kind == "linear":
            one = traceback_packed_linear_one(
                a["m_bt"][:, b], pen, int(score[b]), P[b], T[b],
                int(plen[b]), int(tlen[b]), pair=b)
        else:
            one = traceback_packed_one(
                a["m_bt"][:, b], a["i_bt"][:, b], a["d_bt"][:, b], pen,
                int(score[b]), P[b], T[b], int(plen[b]), int(tlen[b]),
                pair=b)
        np.testing.assert_array_equal(batch[b], one, err_msg=f"pair {b}")
        cost, _, _, ok = gotoh.score_cigar(
            batch[b], P[b, :plen[b]], T[b, :tlen[b]], pen.as_penalties())
        assert ok and cost == score[b], b
    runs = ["".join("MXID"[o] for o in ops) for ops in batch]
    assert any("X" in r for r in runs)
    assert any("DDD" in r for r in runs) and any("II" in r for r in runs)


def test_packed_batch_leaves_the_collector_idle():
    """A wave's chains wait between its walk and its replay as ints in one
    list: a 4,096-pair wave allocates no objects that outlive their pair,
    so the cyclic garbage collector never runs inside the batch (tuples
    held a wave long set it off about 14 times a wave, each pass over
    every object the process holds)."""
    pen = scoring.GapAffine(4, 6, 2)
    P, plen, T, tlen = generate_pairs(ReadPairSpec(
        n_pairs=4096, read_len=100, edit_frac=0.02, seed=4))
    s_max, k_max = problem_bounds(pen, plen, tlen, 0.02)
    res = wf.wfa_scores_packed(P, T, plen, tlen, pen=pen, s_max=s_max,
                               k_max=k_max, device="cpu")
    passes = []
    hook = lambda phase, info: passes.append(phase)
    gc.collect()
    gc.callbacks.append(hook)
    try:
        out = traceback_packed_batch(res, pen, P, T, plen, tlen)
    finally:
        gc.callbacks.remove(hook)
    assert passes == [] and len(out) == 4096


@pytest.mark.parametrize("fault", ["walk", "replay"])
def test_planted_bad_pair_raises_naming_it(fault):
    pen = scoring.GapAffine(4, 6, 2)
    res, P, plen, T, tlen = _packed(pen)
    bad = 7
    if fault == "walk":      # the end cell's M code: no valid provenance
        m_bt = res.m_bt.clone()
        m_bt[:, bad] = 0
        res = res._replace(m_bt=m_bt)
    else:                    # text altered after the trace: replay drifts
        T = T.copy()
        T[bad, :tlen[bad] // 2] = np.where(T[bad, :tlen[bad] // 2] == 65,
                                           67, 65)
    with pytest.raises(TracebackError) as err:
        traceback_packed_batch(res, pen, P, T, plen, tlen)
    assert err.value.pair == bad and f"pair={bad}" in str(err.value)


# -- spans in the profiler's trace -------------------------------------------


def _user_annotations(path):
    with open(os.path.join(path, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"]


def test_profile_alone_carries_the_spans(tmp_path, monkeypatch):
    """The tracer off: a profile alone writes the spans as annotations,
    each opened after its span's own timestamp was taken."""
    monkeypatch.setattr(obs_trace, "_on", False)
    monkeypatch.setattr(obs_trace, "_rec", None)
    eng = _engine()
    _run(eng, "stream", "cigar")          # warm, outside the profile
    with obs_profile.profile(str(tmp_path)):
        assert obs_profile.active()
        _run(eng, "stream", "cigar")
    assert not obs_profile.active() and obs_trace._mirror is None
    names = {e["name"] for e in _user_annotations(tmp_path)}
    assert {"wave.scatter", "scatter.pack", "scatter.stage",
            "scatter.launch", "wave.kernel", "wave.gather",
            "wave.traceback", "traceback.walk",
            "traceback.replay"} <= names
    assert not names & {"wfa.kernel.dispatch", "wfa.kernel.wait"}
    assert not hasattr(obs_profile, "annotation")


def test_no_profile_never_enters_record_function(tracer, monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def spy(name, *a, **kw):
        entered.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    _run(_engine(), "stream", "cigar")
    assert tracer.events() and entered == []


def test_everything_off_spans_are_null(monkeypatch):
    monkeypatch.setattr(obs_trace, "_on", False)
    monkeypatch.setattr(obs_trace, "_rec", None)
    assert obs_trace._mirror is None
    assert obs_trace.span("scatter.pack") is obs_trace.NULL
    assert obs_trace.span("traceback.walk", cat="wave",
                          args={"pairs": 1}) is obs_trace.NULL
