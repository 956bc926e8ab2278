"""The port's alignment service (``repro_torch.serve``) against the JAX
one: wave forming under a fixed clock, admission and shedding, per-request
scores and CIGARs through ``ServeLoop`` (one and two worker threads), the
failure contract, warm replays without new specialisations, and the
``serve_align`` launcher on the CPU."""
import dataclasses
import itertools

import numpy as np
import pytest

pytest.importorskip("torch")

from conftest import gotoh_oracle, random_pairs  # noqa: E402
from repro.core.engine import AlignmentEngine as JEngine  # noqa: E402
from repro.core.scoring import Edit as JEdit  # noqa: E402
from repro.core.scoring import ZDrop as JZDrop  # noqa: E402
from repro.data.reads import ArrivalSpec as JArrivalSpec  # noqa: E402
from repro.data.reads import generate_trace as j_generate_trace  # noqa: E402
from repro.serve import AlignRequest as JRequest  # noqa: E402
from repro.serve import RequestQueue as JQueue  # noqa: E402
from repro.serve import ServeLoop as JServeLoop  # noqa: E402
from repro.serve import ShedError as JShedError  # noqa: E402
from repro.serve import WaveFormer as JWaveFormer  # noqa: E402
from repro.serve import replay_trace as j_replay  # noqa: E402
from repro_torch.core import backends as t_backends  # noqa: E402
from repro_torch.core.engine import AlignmentEngine  # noqa: E402
from repro_torch.core.gotoh import score_cigar  # noqa: E402
from repro_torch.core.penalties import DEFAULT  # noqa: E402
from repro_torch.core.scoring import Edit, ZDrop  # noqa: E402
from repro_torch.data.reads import ArrivalSpec, generate_trace  # noqa: E402
from repro_torch.launch import serve_align  # noqa: E402
from repro_torch.serve import (AlignRequest, RequestQueue,  # noqa: E402
                               ServeLoop, ShedError, WaveFormer,
                               replay_trace)


def _requests(seed, sizes, lo=10, hi=120):
    """The same packed requests for both packages."""
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        pats, txts = random_pairs(rng, n, lo=lo, hi=hi)
        out.append((pats, txts))
    return out


def _wave_view(wave, index):
    """A formed wave with request objects replaced by their index."""
    return (wave.key[2:], wave.reason, wave.n_real, wave.p.tolist(),
            wave.plen.tolist(), wave.t.tolist(), wave.tlen.tolist(),
            [(index[id(sl.request)], sl.req_lo, sl.row_lo, sl.n)
             for sl in wave.slices])


def test_waveformer_equal_under_a_fixed_clock():
    """Mixed buckets and seams, a request split over waves, per-request
    deadlines, full, deadline and drain flushes: the same waves in the same
    order, clock values passed in."""
    sizes = [3, 7, 1, 12, 2, 5, 4, 9]
    reqs = _requests(2, sizes)
    jf = JWaveFormer(wave_pairs=8, form_deadline=0.5, min_bucket_len=16)
    tf = WaveFormer(wave_pairs=8, form_deadline=0.5, min_bucket_len=16)
    views = []
    for former, cls in ((jf, JRequest), (tf, AlignRequest)):
        index, got = {}, []
        for i, (pats, txts) in enumerate(reqs):
            req = cls.from_seqs(pats, txts,
                                deadline=0.2 if i % 3 == 0 else None)
            req.pen, req.heur = "model", None
            req.out = "cigar" if i % 4 == 3 else "score"
            index[id(req)] = i
            former.add(req, now=10.0 + 0.1 * i)
            got += [_wave_view(w, index) for w in former.take_ready(
                now=10.0 + 0.1 * i)]
            got.append(("pending", former.n_pending,
                        former.next_deadline()))
        for now in (10.75, 11.0, 12.0):
            got += [_wave_view(w, index) for w in former.take_ready(now)]
        last = cls.from_seqs(*reqs[4])      # still forming at shutdown
        last.pen, last.heur, last.out = "model", None, "score"
        index[id(last)] = len(reqs)
        former.add(last, now=12.5)
        got += [_wave_view(w, index) for w in former.flush_all()]
        got.append(("formed", former.n_formed, former.n_pending))
        views.append(got)
    assert views[0] == views[1]
    reasons = {v[1] for v in views[1] if len(v) == 8}
    assert reasons == {"full", "deadline", "drain"}


def test_queue_admission_and_shedding_equal():
    reqs = _requests(3, [1] * 7)
    logs = []
    for qcls, rcls, err in ((JQueue, JRequest, JShedError),
                            (RequestQueue, AlignRequest, ShedError)):
        q = qcls(max_depth=3)
        made = [rcls.from_seqs(*r) for r in reqs]
        log = [q.offer(r) for r in made[:4]]
        drained = q.drain(max_items=2)
        log += [[made.index(r) for r in drained]]
        log += [q.offer(r) for r in made[4:6]]
        q.close()
        log += [q.offer(made[6]), len(q), q.n_offered, q.n_shed,
                [made.index(r) for r in q.drain()]]
        for r in made:
            if r.future.done() and r.future.exception() is not None:
                e = r.future.exception()
                assert isinstance(e, err)
                log.append((made.index(r), e.reason, e.queue_depth,
                            e.max_depth, str(e)))
        logs.append(log)
    assert logs[0] == logs[1]
    with pytest.raises(ValueError):
        RequestQueue(max_depth=0)


def _serve(loop_cls, eng, payloads, seams, threads=1, wave_pairs=16):
    """Submit every request (all at once), drain, -> per-request results."""
    with loop_cls(eng, wave_pairs=wave_pairs, form_deadline=0.005,
                  n_threads=threads) as server:
        futs = [server.submit(p, t, **kw)
                for (p, t), kw in zip(payloads, seams)]
        res = [f.result(timeout=120) for f in futs]
    return res, server.stats()


@pytest.mark.parametrize("backend,threads", [("ring", 1), ("kernel", 1),
                                             ("kernel", 2)])
def test_serve_loop_results_equal(backend, threads):
    """Scores and CIGARs per request equal the JAX loop's, under mixed
    seams (affine / Edit / ZDrop, score / cigar) and a split request."""
    payloads = _requests(5, [4, 3, 20, 1, 6, 2, 5, 8], lo=20, hi=70)
    jseams, tseams = [], []
    for i in range(len(payloads)):
        out = "cigar" if i % 2 else "score"
        j_kw, t_kw = {"output": out}, {"output": out}
        if i % 3 == 1:
            j_kw["penalties"], t_kw["penalties"] = JEdit(), Edit()
        if i % 4 == 2:
            j_kw["heuristic"], t_kw["heuristic"] = JZDrop(8), ZDrop(8)
        jseams.append(j_kw)
        tseams.append(t_kw)
    want, jst = _serve(JServeLoop, JEngine(backend=backend, edit_frac=0.05),
                       payloads, jseams)
    got, tst = _serve(ServeLoop, AlignmentEngine(backend=backend,
                                                 edit_frac=0.05,
                                                 device="cpu"),
                      payloads, tseams, threads=threads)
    for w, g in zip(want, got, strict=True):
        np.testing.assert_array_equal(w.scores, g.scores)
        assert (w.cigars is None) == (g.cigars is None)
        if g.cigars is not None:
            assert [c.tolist() for c in w.cigars] == \
                [c.tolist() for c in g.cigars]
    assert got[2].n_waves >= 2                 # 20 rows over 16-row waves
    assert (tst.n_completed, tst.n_outstanding, tst.n_shed) == \
        (jst.n_completed, 0, 0)
    np.testing.assert_array_equal(got[0].scores, gotoh_oracle(*payloads[0]))
    for (p, t), res, kw in zip(payloads, got, tseams):
        pen = kw.get("penalties", None)
        pen = DEFAULT if pen is None else pen.as_penalties()
        for i, ops in enumerate(res.cigars or ()):
            cost, _, _, ok = score_cigar(
                ops, np.frombuffer(p[i].encode(), np.uint8),
                np.frombuffer(t[i].encode(), np.uint8), pen)
            assert ok and cost == res.scores[i]


def test_replay_equal_and_warm_replay_adds_no_specialisation():
    """An open-loop replay of the same trace in both packages: every
    request answered once with equal scores; a second, warm replay on the
    port's engine creates no new specialisation (n_retraces 0)."""
    spec = dict(n_requests=24, pairs_per_request=4, read_len=60, seed=3)
    jp, jarr = j_generate_trace(JArrivalSpec(**spec))
    tp, tarr = generate_trace(ArrivalSpec(**spec))
    np.testing.assert_array_equal(jarr, tarr)
    with JServeLoop(JEngine(backend="ring", edit_frac=0.02), wave_pairs=32,
                    form_deadline=0.01) as server:
        want = j_replay(server, jp, jarr * 1e-3)
    eng = AlignmentEngine(backend="kernel", edit_frac=0.02, device="cpu")
    reports = []
    for _ in range(2):
        with ServeLoop(eng, wave_pairs=32, form_deadline=0.01) as server:
            traces0 = eng.cache_traces()
            reports.append(replay_trace(server, tp, tarr * 1e-3))
        fresh = eng.cache_traces() - traces0
    got = reports[-1]
    assert (got.n_ok, got.n_shed, got.n_failed) == (want.n_ok, 0, 0) == \
        (24, 0, 0)
    for w, g in zip(want.results, got.results, strict=True):
        np.testing.assert_array_equal(w.scores, g.scores)
    assert reports[0].stats.n_retraces > 0
    assert got.stats.n_retraces == 0 and fresh == 0
    assert got.stats.cache_misses == 0


_calls = itertools.count()


def _failing(after):
    """A backend whose solver raises from its ``after``-th call on."""
    state = {"n": 0}

    def fn(pattern, text, plen, tlen, *, pen, s_max, k_max):
        state["n"] += 1
        if state["n"] > after:
            raise RuntimeError("injected backend failure")
        from repro_torch.core import wavefront as wf
        return wf.wfa_scores(pattern, text, plen, tlen, pen=pen,
                             s_max=s_max, k_max=k_max, device=pattern.device)
    return fn


@pytest.mark.parametrize("after", [0, 2])
def test_backend_failure_fails_pending_futures_and_poisons_the_loop(after):
    name = f"failing-{next(_calls)}"
    t_backends.register_backend(name, _failing(after))
    try:
        eng = AlignmentEngine(backend=name, edit_frac=0.05, device="cpu")
        payloads = _requests(7, [4] * 8, lo=20, hi=40)
        server = ServeLoop(eng, wave_pairs=4, form_deadline=0.005).start()
        futs = [server.submit(p, t) for p, t in payloads]
        outcomes = []
        for f in futs:
            try:
                outcomes.append(len(f.result(timeout=60).scores))
            except RuntimeError as e:
                assert "injected backend failure" in str(e)
                outcomes.append("failed")
        assert outcomes.count("failed") >= len(futs) - after
        assert outcomes[after:] == ["failed"] * (len(futs) - after)
        with pytest.raises(RuntimeError, match="serve loop failed"):
            server.stop()
        late = server.submit(*payloads[0])
        with pytest.raises(ShedError, match="server stopped"):
            late.result(timeout=0)
        assert server.stats().n_outstanding == 0
    finally:
        t_backends.unregister_backend(name)


@pytest.mark.parametrize("output,threads", [("score", 2), ("cigar", 1)])
def test_serve_align_launcher_cpu(output, threads):
    """The launcher on the CPU: calibrated load, every request served, no
    new specialisation in the measured replay, scores equal to batch mode
    on the same engine and CIGARs that re-score to them."""
    summary = {}
    rc = serve_align.main(["--device", "cpu", "--backend", "kernel",
                           "--requests", "24", "--pairs-per-request", "4",
                           "--read-len", "60", "--wave-pairs", "32",
                           "--threads", str(threads), "--output", output],
                          summary)
    assert rc == 0
    rep = summary["report"]
    assert (rep.n_ok, rep.n_shed, rep.n_failed) == (24, 0, 0)
    assert summary["fresh_specialisations"] == 0
    P, plen, T, tlen = (np.concatenate(a) for a in zip(*summary["payloads"]))
    batch = summary["engine"].align_packed(P, plen, T, tlen)
    got = np.concatenate([r.scores for r in rep.results])
    np.testing.assert_array_equal(got, batch.scores)
    if output == "cigar":
        cig = [c for r in rep.results for c in r.cigars]
        for i, ops in enumerate(cig):
            cost, _, _, ok = score_cigar(ops, P[i, :plen[i]], T[i, :tlen[i]],
                                         DEFAULT)
            assert ok and cost == got[i]


def test_server_stats_fields_equal():
    """ServerStats carries the reference's fields (n_retraces now counts
    first uses of cached specialisations)."""
    from repro.serve import ServerStats as JStats
    from repro_torch.serve import ServerStats
    assert [f.name for f in dataclasses.fields(JStats)] == \
        [f.name for f in dataclasses.fields(ServerStats)]
