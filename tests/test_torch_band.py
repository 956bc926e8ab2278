"""The port's compacting band (``band_cap``) equals the JAX package's.

* the ring solvers' band (``core.wavefront._scores_band``, one window per
  pair) against ``repro.core.wavefront`` with ``band_cap``: scores, step
  counts and packed trace words, with boundary states;
* the kernel's plain version on the band (one window per block) against
  ``wfa_pallas(interpret=True, band_cap=)``: scores, per-block steps and
  trace words, with padded rows, and with windows too narrow for the live
  span (truncation); a settled pair keeps getting codes until its block
  exits (the per-block semantics the CUDA kernel must keep);
* band against full width, for both, when the live span fits;
* the engine with ``backend_opts={"band_cap": "auto"}`` on ``ring`` and
  ``kernel``, and BiWFA under ``AdaptiveBand`` plus the band, against the
  JAX engine;
* ``band_cap >= K`` runs full width, as in the JAX package.

The CUDA band kernel is held against its plain version on the card in
``test_torch_wfa_gpu.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import scoring as j_scoring  # noqa: E402
from repro.core import wavefront as j_wf  # noqa: E402
from repro.core.engine import AlignmentEngine as JEngine  # noqa: E402
from repro.core.engine import problem_bounds  # noqa: E402
from repro.data.reads import ReadPairSpec, generate_pairs  # noqa: E402
from repro.kernels.wfa import ops as j_ops  # noqa: E402
from repro.kernels.wfa.kernel import wfa_pallas  # noqa: E402
from repro_torch.core import cigar as t_cigar  # noqa: E402
from repro_torch.core import gotoh as t_gotoh  # noqa: E402
from repro_torch.core import scoring as t_scoring  # noqa: E402
from repro_torch.core import wavefront as t_wf  # noqa: E402
from repro_torch.core.engine import AlignmentEngine  # noqa: E402
from repro_torch.kernels.wfa import kernel as t_kernel  # noqa: E402
from repro_torch.kernels.wfa import ops as t_ops  # noqa: E402
from test_biwfa import _divergent_pairs  # noqa: E402

MODELS = [j_scoring.GapAffine(), j_scoring.GapLinear(), j_scoring.Edit()]
HEURS = [j_scoring.AdaptiveBand(4, 10), j_scoring.ZDrop(12)]
_mid = lambda p: type(p).__name__
_hid = lambda h: type(h).__name__
_t = t_scoring.from_reference


def _pairs(n, L, E, seed):
    """Seeded pairs at exact worst-case bounds: the heuristic, not s_max,
    limits the fronts (the bounds of ``tests/test_kernel_fused.py``)."""
    P, plen, T, tlen = generate_pairs(ReadPairSpec(
        n_pairs=n, read_len=L, edit_frac=E, seed=seed))
    s_max, k_max = problem_bounds(j_scoring.GapAffine(), plen, tlen, None)
    return P, plen, T, tlen, s_max, k_max


def _ragged(seed=9, n=10, drift=30):
    """Pairs whose target diagonals sit far from k = 0 (tlen != plen); every
    other pair shares a prefix, the rest are unrelated."""
    rng = np.random.default_rng(seed)
    plen = rng.integers(20, 90, size=n).astype(np.int32)
    tlen = np.clip(plen + rng.integers(-drift, drift + 1, size=n), 4,
                   None).astype(np.int32)
    P = rng.integers(65, 69, size=(n, int(plen.max()))).astype(np.int32)
    T = rng.integers(65, 69, size=(n, int(tlen.max()))).astype(np.int32)
    for i in range(0, n, 2):
        m = min(plen[i], tlen[i])
        T[i, :m] = P[i, :m]
    s_max, k_max = problem_bounds(j_scoring.GapAffine(), plen, tlen, None)
    return P, plen, T, tlen, s_max, k_max


def _same_result(jres, tres):
    np.testing.assert_array_equal(np.asarray(jres.score), tres.score.numpy())
    assert int(jres.n_steps) == tres.n_steps
    for f in ("m_bt", "i_bt", "d_bt"):
        a, b = getattr(jres, f), getattr(tres, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=f)


def _ring_both(pen, heur, batch, packed, states=("M", "M"), band_cap=None):
    P, plen, T, tlen, s_max, k_max = batch
    kw = dict(s_max=s_max, k_max=k_max, band_cap=band_cap)
    if packed:
        kw.update(begin_state=states[0], end_state=states[1])
        return (j_wf.wfa_scores_packed(P, T, plen, tlen, pen=pen, heur=heur,
                                       **kw),
                t_wf.wfa_scores_packed(P, T, plen, tlen, pen=_t(pen),
                                       heur=_t(heur), device="cpu", **kw))
    return (j_wf.wfa_scores(P, T, plen, tlen, pen=pen, heur=heur, **kw),
            t_wf.wfa_scores(P, T, plen, tlen, pen=_t(pen), heur=_t(heur),
                            device="cpu", **kw))


# -- (a) the ring solvers' band against the JAX package ---------------------

_RING_CASES = [(pen, heur, packed, states)
               for pen in MODELS for heur in HEURS
               for packed in (False, True)
               for states in ((("M", "M"), ("I", "D"), ("D", "M"))
                              if packed and pen.kind == "affine"
                              else (("M", "M"),))]


@pytest.mark.parametrize(
    "pen,heur,packed,states", _RING_CASES,
    ids=[f"{_mid(p)}-{_hid(h)}-{'packed' if k else 'score'}-{''.join(s)}"
         for p, h, k, s in _RING_CASES])
def test_ring_band_matches_reference(pen, heur, packed, states):
    batch = _pairs(12, 72, 0.08, 23)
    cap = heur.band_cap(2 * batch[5] + 1)
    assert t_wf._band_width(cap, 2 * batch[5] + 1) == cap   # band engaged
    _same_result(*_ring_both(pen, heur, batch, packed, states, cap))


@pytest.mark.parametrize("cap", [9, 20])
def test_ring_band_truncating_window_matches_reference(cap):
    """Windows narrower than the live span of ragged pairs: the truncation
    prunes, per pair, exactly as the JAX package's does."""
    batch = _ragged()
    for packed in (False, True):
        _same_result(*_ring_both(j_scoring.GapAffine(),
                                 j_scoring.AdaptiveBand(4, 10), batch,
                                 packed, band_cap=cap))


# -- (b) the kernel's plain version on the band against wfa_pallas ----------


def _kernel_both(pen, heur, batch, band_cap, bp, trace):
    """(JAX outputs, port outputs) of the kernel on a band of ``band_cap``
    lanes, each padded by its own package's wrapper."""
    P, plen, T, tlen, s_max, k_max = batch
    k_pad = j_ops._round_up(2 * k_max + 1, j_ops.LANE)
    jp = j_ops._prep(P, T, plen, tlen, bp)
    want = wfa_pallas(*jp[:4], pen=pen, s_max=s_max, k_pad=k_pad,
                      block_pairs=bp, interpret=True, trace=trace,
                      heur=j_scoring.as_heuristic(heur), band_cap=band_cap)
    tp = t_ops._prep(P, T, plen, tlen, bp, device="cpu")
    got = t_kernel.wfa_plain(*tp[:4], pen=_t(pen), s_max=s_max, k_pad=k_pad,
                             block_pairs=bp, trace=trace, heur=_t(heur),
                             band_cap=band_cap)
    return [np.asarray(a) for a in want], [t.numpy() for t in got]


def _assert_same(want, got):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("heur", HEURS, ids=_hid)
@pytest.mark.parametrize("pen", MODELS, ids=_mid)
def test_kernel_band_matches_pallas(pen, heur):
    """13 pairs at block_pairs 4 (3 padded rows): the lane-aligned cap of
    128 against k_pad 256, score and trace."""
    batch = _pairs(13, 72, 0.08, 24)
    k_pad = j_ops._round_up(2 * batch[5] + 1, j_ops.LANE)
    cap = t_ops._band_lanes(heur.band_cap(2 * batch[5] + 1), k_pad)
    assert cap == j_ops._band_lanes(heur.band_cap(2 * batch[5] + 1), k_pad)
    assert cap is not None and cap < k_pad
    for trace in (False, True):
        want, got = _kernel_both(pen, heur, batch, cap, 4, trace)
        _assert_same(want, got)
        assert (got[0][13:] == 0).all()      # padded rows resolve at s=0


@pytest.mark.parametrize("cap", [16, 40])
@pytest.mark.parametrize("pen", [j_scoring.GapAffine(), j_scoring.Edit()],
                         ids=_mid)
def test_kernel_band_truncating_window_matches_pallas(pen, cap):
    """Per-block windows narrower than the blocks' live span, on ragged
    pairs: some pairs end unresolved (-1), the same ones as on the TPU
    kernel."""
    batch = _ragged()
    for heur in HEURS:
        for trace in (False, True):
            want, got = _kernel_both(pen, heur, batch, cap, 4, trace)
            _assert_same(want, got)
    if cap == 16:
        assert (got[0][:10] == -1).any()


def test_kernel_band_trace_words_follow_the_block():
    """The window and the exit are per block: a pair settled before its
    block exits keeps getting codes until the block's exit step, in
    ``wfa_pallas`` and in the port alike (kernel.py's ``pack_code`` ORs
    codes for every row of a live block), so a kernel that stopped each
    pair at its own score step would change the trace words."""
    batch = _ragged()
    want, got = _kernel_both(j_scoring.GapAffine(),
                             j_scoring.AdaptiveBand(4, 10), batch, 40, 4,
                             True)
    _assert_same(want, got)
    score, steps, m_bt = got[0][:, 0], got[1][:, 0], got[2]
    late = []
    for i in range(len(batch[1])):
        after = range(int(score[i]) + 1, int(steps[i]))
        if score[i] >= 0 and any(
                ((m_bt[t // 16, i] >> (2 * (t % 16))) & 3).any()
                for t in after):
            late.append(i)
    assert late, "no pair got codes after its own score step"


# -- (c) band against full width when the live span fits --------------------


def _ring_cigars(batch, pen, heur, band_cap=None):
    P, plen, T, tlen, s_max, k_max = batch
    res = t_wf.wfa_scores_packed(P, T, plen, tlen, pen=pen, s_max=s_max,
                                 k_max=k_max, heur=heur, band_cap=band_cap,
                                 device="cpu")
    return res.score.numpy(), t_cigar.traceback_packed_batch(
        res, pen, P, T, plen, tlen)


@pytest.mark.parametrize("pen", [j_scoring.GapAffine(), j_scoring.Edit()],
                         ids=_mid)
@pytest.mark.parametrize("heur", HEURS, ids=_hid)
def test_ring_band_equals_full_width(heur, pen):
    """The heuristic's own cap bounds its live span, so the band is a pure
    re-indexing: same scores, same CIGARs (test_band_compaction_jnp_
    identical of the JAX package)."""
    batch = _pairs(12, 72, 0.08, 23)
    tpen, theur = _t(pen), _t(heur)
    cap = theur.band_cap(2 * batch[5] + 1)
    full_s, full_c = _ring_cigars(batch, tpen, theur)
    band_s, band_c = _ring_cigars(batch, tpen, theur, band_cap=cap)
    np.testing.assert_array_equal(full_s, band_s)
    for i, (a, b) in enumerate(zip(full_c, band_c)):
        np.testing.assert_array_equal(a, b, err_msg=f"pair {i}")


@pytest.mark.parametrize("heur", HEURS, ids=_hid)
def test_kernel_band_equals_full_width(heur):
    """The kernel's plain version, full width against the lane-aligned band:
    same scores, same CIGARs (test_band_compaction_kernel_identical)."""
    P, plen, T, tlen, s_max, k_max = _pairs(12, 72, 0.08, 24)
    pen, theur = t_scoring.GapAffine(), _t(heur)

    def cigars(band_cap):
        score, m_bt, i_bt, d_bt = t_ops.wfa_align_trace(
            P, T, plen, tlen, pen=pen, s_max=s_max, k_max=k_max, heur=theur,
            band_cap=band_cap, device="cpu")
        res = t_wf.WFAResult(score, None, None, None, s_max, m_bt, i_bt,
                             d_bt)
        return score.numpy(), t_cigar.traceback_packed_batch(
            res, pen, P, T, plen, tlen)

    full_s, full_c = cigars(None)
    band_s, band_c = cigars(theur.band_cap(2 * k_max + 1))
    np.testing.assert_array_equal(full_s, band_s)
    for i, (a, b) in enumerate(zip(full_c, band_c)):
        np.testing.assert_array_equal(a, b, err_msg=f"pair {i}")


def test_band_scores_offset_correctness():
    """Score-only band on ragged lengths: the per-pair offset tracks fronts
    centred far from k = 0 (the JAX package's test of the same name)."""
    P, plen, T, tlen, s_max, k_max = _ragged(drift=15)
    heur = t_scoring.ZDrop(40)
    kw = dict(pen=t_scoring.GapAffine(), s_max=s_max, k_max=k_max,
              heur=heur, device="cpu")
    full = t_wf.wfa_scores(P, T, plen, tlen, **kw).score
    band = t_wf.wfa_scores(P, T, plen, tlen,
                           band_cap=heur.band_cap(2 * k_max + 1), **kw).score
    np.testing.assert_array_equal(full.numpy(), band.numpy())
    kern = t_ops.wfa_align(P, T, plen, tlen,
                           band_cap=heur.band_cap(2 * k_max + 1), **kw)
    np.testing.assert_array_equal(full.numpy(), kern.numpy())


# -- (d) the engine with band_cap="auto" against the JAX engine -------------


def _strs(X, lens):
    return ["".join(chr(c) for c in X[i, :lens[i]]) for i in range(len(lens))]


def _engine_pairs():
    P, plen, T, tlen = generate_pairs(ReadPairSpec(
        n_pairs=12, read_len=160, edit_frac=0.08, seed=29))
    return _strs(P, plen), _strs(T, tlen)


def _stats_view(st):
    return ([(b.lmax, b.s_max, b.k_max, b.n_pairs, b.recovery)
             for b in st.buckets],
            st.n_overflow, st.n_recovered, st.rows_real, st.rows_padded,
            st.cache_hits, st.cache_misses, st.n_traces, st.bytes_in)


def _spy_band(monkeypatch):
    """Record the compact widths the ring band and the kernel's plain
    version run at (each entry: (Kc, full width))."""
    seen = []
    band, plain = t_wf._scores_band, t_kernel.wfa_plain

    def ring_spy(pattern, text, plen, tlen, model, heur, s_max, k_max, Kc,
                 *a):
        seen.append((Kc, 2 * k_max + 1))
        return band(pattern, text, plen, tlen, model, heur, s_max, k_max,
                    Kc, *a)

    def plain_spy(*a, **kw):
        seen.append((kw.get("band_cap"), kw["k_pad"]))
        return plain(*a, **kw)

    monkeypatch.setattr(t_wf, "_scores_band", ring_spy)
    monkeypatch.setattr(t_kernel, "wfa_plain", plain_spy)
    return seen


@pytest.mark.parametrize("heur", [j_scoring.AdaptiveBand(4, 10),
                                  j_scoring.ZDrop(12)], ids=_hid)
@pytest.mark.parametrize("backend", ["ring", "kernel"])
def test_engine_band_auto_matches_reference(backend, heur, monkeypatch):
    """12 pairs of 160 bp at 8%: scores, CIGAR strings, ``approximate`` and
    the counters equal the JAX engine's, and the band engaged."""
    pats, txts = _engine_pairs()
    pen = j_scoring.GapAffine()
    kw = dict(backend=backend, edit_frac=0.08,
              backend_opts={"band_cap": "auto"})
    jeng = JEngine(pen, heuristic=heur, **kw)
    teng = AlignmentEngine(_t(pen), heuristic=_t(heur), device="cpu", **kw)
    seen = _spy_band(monkeypatch)
    for output in ("score", "cigar"):
        want = jeng.align(pats, txts, output=output)
        got = teng.align(pats, txts, output=output)
        np.testing.assert_array_equal(want.scores, got.scores)
        assert want.approximate and got.approximate
        assert _stats_view(want.stats) == _stats_view(got.stats)
        assert (want.n_steps, want.s_max, want.k_max) == \
            (got.n_steps, got.s_max, got.k_max)
        if output == "cigar":
            assert want.cigar_strings() == got.cigar_strings()
            for i, (p, t) in enumerate(zip(pats, txts)):
                cost, ci, cj, ok = t_gotoh.score_cigar(
                    got.cigars[i], np.frombuffer(p.encode(), np.uint8),
                    np.frombuffer(t.encode(), np.uint8), _t(pen))
                assert ok and cost == got.scores[i], i
    assert seen and all(kc is not None and kc < full for kc, full in seen)


def test_engine_band_auto_exact_is_full_width(monkeypatch):
    """Exact alignment has no pruning radius: "auto" stays full width and
    equals the engine without it."""
    pats, txts = _engine_pairs()
    seen = _spy_band(monkeypatch)
    for backend in ("ring", "kernel"):
        plain = AlignmentEngine(backend=backend, device="cpu").align(
            pats, txts)
        auto = AlignmentEngine(backend=backend, device="cpu",
                               backend_opts={"band_cap": "auto"}).align(
            pats, txts)
        np.testing.assert_array_equal(plain.scores, auto.scores)
    assert all(kc is None for kc, _ in seen)


# -- (e) BiWFA under AdaptiveBand plus the band -----------------------------


@pytest.mark.parametrize("backend", ["ring", "kernel"])
def test_bidir_band_matches_reference(backend, monkeypatch):
    """6 pairs of 240 bp at 5%, trace budget 1,500: meet waves (which take
    no band) and banded packed leaves; scores, CIGAR strings, fallbacks,
    unmet meets and counters equal the JAX engine's."""
    ps, ts = _divergent_pairs(np.random.default_rng(0), 6, 240, 0.05)
    pen, heur = j_scoring.GapAffine(4, 6, 2), j_scoring.AdaptiveBand(4, 10)
    kw = dict(backend=backend, trace_budget=1500,
              backend_opts={"band_cap": "auto"})
    want = JEngine(pen, heuristic=heur, **kw).align(
        ps, ts, output="cigar", trace_variant="bidir")
    seen = _spy_band(monkeypatch)
    got = AlignmentEngine(_t(pen), heuristic=_t(heur), device="cpu",
                          **kw).align(ps, ts, output="cigar",
                                      trace_variant="bidir")
    np.testing.assert_array_equal(want.scores, got.scores)
    assert want.cigar_strings() == got.cigar_strings()
    for f in ("n_bidir_fallback", "n_meet_unmet", "peak_trace_bytes",
              "rows_real", "rows_padded", "cache_hits", "cache_misses"):
        assert getattr(want.stats, f) == getattr(got.stats, f), f
    # the root score pass runs on the band; narrow leaves may not (a cap
    # that rounds up to k_pad lanes runs full width, as in JAX)
    assert any(kc is not None and kc < full for kc, full in seen)
    for i, (p, t) in enumerate(zip(ps, ts)):
        cost, ci, cj, ok = t_gotoh.score_cigar(got.cigars[i], p, t, _t(pen))
        assert ok and ci == len(p) and cj == len(t) and \
            cost == got.scores[i], i


# -- (f) band_cap >= K runs full width --------------------------------------


def test_band_cap_at_least_k_runs_full_width(monkeypatch):
    batch = _pairs(6, 60, 0.08, 3)
    P, plen, T, tlen, s_max, k_max = batch
    K = 2 * k_max + 1
    k_pad = j_ops._round_up(K, j_ops.LANE)
    pen, heur = j_scoring.GapAffine(), j_scoring.AdaptiveBand(4, 10)
    assert t_wf._band_width(K, K) is None and t_wf._band_width(3, K) == 9
    assert t_ops._band_lanes(K, k_pad) is None
    assert t_ops._band_lanes(k_pad - 1, k_pad) is None
    seen = _spy_band(monkeypatch)
    for packed in (False, True):
        full = _ring_both(pen, heur, batch, packed)
        for cap in (K, K + 50):
            wide = _ring_both(pen, heur, batch, packed, band_cap=cap)
            _same_result(full[0], wide[1])
            _same_result(wide[0], wide[1])
    kw = dict(pen=t_scoring.GapAffine(), s_max=s_max, k_max=k_max,
              heur=_t(heur), device="cpu")
    full = t_ops.wfa_align_trace(P, T, plen, tlen, **kw)
    wide = t_ops.wfa_align_trace(P, T, plen, tlen, band_cap=K, **kw)
    for a, b in zip(full, wide):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    jw = j_ops.wfa_align_trace(P, T, plen, tlen, pen=pen, s_max=s_max,
                               k_max=k_max, heur=heur, interpret=True,
                               band_cap=K)
    _assert_same([np.asarray(a) for a in jw], [t.numpy() for t in wide])
    assert all(kc is None or kc >= full_w for kc, full_w in seen)


def test_band_counts_no_launch_on_cpu():
    """On CPU tensors the wrapper runs the plain version: no launch is
    counted, band or not."""
    P, plen, T, tlen, s_max, k_max = _pairs(4, 60, 0.08, 5)
    before = dict(t_kernel.LAUNCHES)
    t_ops.wfa_align(P, T, plen, tlen, pen=t_scoring.GapAffine(),
                    s_max=s_max, k_max=k_max, heur=t_scoring.ZDrop(12),
                    band_cap=33, device="cpu")
    assert t_kernel.LAUNCHES == before
    assert {"score_band", "trace_band"} <= set(t_kernel.LAUNCHES)
