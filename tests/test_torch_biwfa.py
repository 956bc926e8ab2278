"""The port's BiWFA traceback (``trace_variant="bidir"``) equals the JAX
package's.

``AlignmentEngine(device="cpu")`` is held against the JAX engine on the same
indel-heavy pairs with a trace budget that forces meet-and-recurse: scores,
CIGAR strings, ``n_bidir_fallback`` and ``n_meet_unmet`` equal.  The
``ring`` backend runs the shared meet solver; the ``kernel`` backend runs
the meet kernel's plain version, held against the Pallas meet kernel in
interpret mode.  Every bidir CIGAR also re-scores exactly to the packed
path's score and consumes both sequences (splits inside gap runs, empty and
one-sided pairs, a streamed session mixing packed and bidir tickets)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.engine import AlignmentEngine as JEngine  # noqa: E402
from repro.core.scoring import Edit, GapAffine, GapLinear  # noqa: E402
from repro_torch.core import gotoh as t_gotoh  # noqa: E402
from repro_torch.core import scoring as t_scoring  # noqa: E402
from repro_torch.core.engine import AlignmentEngine  # noqa: E402
from repro_torch.kernels.wfa import kernel as t_kernel  # noqa: E402
from test_biwfa import ALPHA, _divergent_pairs  # noqa: E402


def _as_codes(s):
    return np.frombuffer(s.encode(), np.uint8) if isinstance(s, str) else s


def _assert_bidir_exact(eng, pen, ps, ts):
    """bidir scores == packed scores; every bidir CIGAR re-scores to that
    cost and consumes both sequences."""
    ref = eng.align(ps, ts, output="cigar")
    res = eng.align(ps, ts, output="cigar", trace_variant="bidir")
    np.testing.assert_array_equal(res.scores, ref.scores)
    for i, (p, t) in enumerate(zip(ps, ts)):
        p, t = _as_codes(p), _as_codes(t)
        cost, ci, cj, ok = t_gotoh.score_cigar(res.cigars[i], p, t, pen)
        assert ok and ci == len(p) and cj == len(t), (i, ci, cj)
        assert cost == res.scores[i], (i, cost, res.scores[i])
    return res


@pytest.mark.parametrize("pen,backend", [
    (GapAffine(4, 6, 2), "ring"), (GapLinear(4, 2), "ring"),
    (Edit(), "ring"), (GapAffine(4, 6, 2), "kernel")],
    ids=["affine-ring", "linear-ring", "edit-ring", "affine-kernel"])
def test_bidir_matches_reference(pen, backend):
    """6 pairs of 240 bp at 5% divergence, trace_budget 1500: two rounds of
    meet waves, then packed leaves."""
    ps, ts = _divergent_pairs(np.random.default_rng(0), 6, 240, 0.05)
    kw = dict(backend=backend, trace_budget=1500)
    want = JEngine(pen, **kw).align(ps, ts, output="cigar",
                                    trace_variant="bidir")
    tpen = t_scoring.from_reference(pen)
    eng = AlignmentEngine(tpen, device="cpu", **kw)
    got = eng.align(ps, ts, output="cigar", trace_variant="bidir")
    np.testing.assert_array_equal(want.scores, got.scores)
    assert want.cigar_strings() == got.cigar_strings()
    for f in ("n_bidir_fallback", "n_meet_unmet", "peak_trace_bytes",
              "rows_real", "rows_padded", "cache_hits", "cache_misses"):
        assert getattr(want.stats, f) == getattr(got.stats, f), f
    assert got.stats.n_bidir_fallback == 0 and got.stats.n_meet_unmet == 0
    _assert_bidir_exact(eng, tpen, ps, ts)


def test_split_inside_gap_run():
    """A long deletion and a long insertion dead-centre: the meet lands in
    the gap run, and the I/D joint state charges the open once.  On the
    kernel backend the stateful leaves take the ring trace path."""
    rng = np.random.default_rng(0)
    pen = t_scoring.GapAffine(4, 6, 2)
    p = rng.choice(ALPHA, size=300).astype(np.uint8)
    t = np.concatenate([p[:140], p[200:]])
    p2 = np.concatenate([p[:150], rng.choice(ALPHA, size=70).astype(np.uint8),
                         p[150:]])
    eng = AlignmentEngine(pen, backend="kernel", trace_budget=900,
                          device="cpu")
    res = _assert_bidir_exact(eng, pen, [p, p2], [t, p])
    assert res.stats.n_bidir_fallback == 0
    stateful = [k for k in eng._cache if k[8] != ("M", "M")]
    assert stateful and {k[0].name for k in stateful} <= {"kernel", "ring"}


@pytest.mark.parametrize("backend", ["ring", "kernel"])
def test_bidir_empty_and_one_sided(backend):
    pen = t_scoring.GapAffine(4, 6, 2)
    ps = ["", "ACGTACGTAC", "", "ACGT", "GATTACAGATTACA"]
    ts = ["", "", "TTTTTTTT", "ACGT", "GATTACAGATTACA"]
    eng = AlignmentEngine(pen, backend=backend, trace_budget=40,
                          device="cpu")
    _assert_bidir_exact(eng, pen, ps, ts)


def test_bidir_streamed_submit():
    """Packed and bidir tickets interleaved in one session, retired out of
    order; internal sub-tickets never surface."""
    pen = t_scoring.GapAffine(4, 6, 2)
    ps, ts = _divergent_pairs(np.random.default_rng(1), 10, 150, 0.10)
    eng = AlignmentEngine(pen, backend="kernel", trace_budget=1200,
                          device="cpu")
    with eng.stream(max_inflight_waves=2) as sess:
        tk_b = sess.submit(ps[:5], ts[:5], output="cigar",
                           trace_variant="bidir")
        tk_p = sess.submit(ps[5:], ts[5:], output="cigar")
        done = {t.index: t for t in sess.as_completed(timeout=120)}
        assert len(list(sess.results())) == 2
    assert set(done) == {tk_b.index, tk_p.index}
    assert sess.stats.n_submits == 2
    res_b, res_p = tk_b.result(), tk_p.result()
    ref_b = eng.align(ps[:5], ts[:5], output="cigar")
    np.testing.assert_array_equal(res_b.scores, ref_b.scores)
    np.testing.assert_array_equal(
        res_p.scores, eng.align(ps[5:], ts[5:], output="cigar").scores)
    for i in range(5):
        cost, ci, cj, ok = t_gotoh.score_cigar(res_b.cigars[i], ps[i], ts[i],
                                               pen)
        assert ok and cost == res_b.scores[i]
        assert ci == len(ps[i]) and cj == len(ts[i])


def test_bidir_counts_no_launch_on_cpu():
    """On the CPU the kernel backend's meet waves run the plain version:
    no kernel launch is counted."""
    ps, ts = _divergent_pairs(np.random.default_rng(2), 3, 200, 0.05)
    before = dict(t_kernel.LAUNCHES)
    AlignmentEngine(t_scoring.GapAffine(), backend="kernel", trace_budget=800,
                    device="cpu").align(ps, ts, output="cigar",
                                        trace_variant="bidir")
    assert t_kernel.LAUNCHES == before
