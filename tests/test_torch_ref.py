"""The port's full-history solver (``wfa_forward``) and the ``ref`` backend
equal the JAX package's exactly: scores, step counts and the M/I/D offset
histories, then the engine's scores, CIGAR strings and counters."""
import numpy as np
import pytest

pytest.importorskip("torch")

from conftest import gotoh_oracle, random_pairs  # noqa: E402
from repro.core import scoring as j_scoring  # noqa: E402
from repro.core import wavefront as j_wf  # noqa: E402
from repro.core.engine import AlignmentEngine as JEngine  # noqa: E402
from repro.data.reads import ReadPairSpec, generate_pairs  # noqa: E402
from repro_torch.core import scoring as t_scoring  # noqa: E402
from repro_torch.core import wavefront as t_wf  # noqa: E402
from repro_torch.core.engine import AlignmentEngine  # noqa: E402
from repro_torch.launch import align as t_align  # noqa: E402

MODELS = [j_scoring.GapAffine(), j_scoring.GapLinear(), j_scoring.Edit()]
HEURS = [None, j_scoring.AdaptiveBand(10, 4), j_scoring.ZDrop(8)]


def _batch(seed, n, L, E, width=64):
    P, plen, T, tlen = generate_pairs(ReadPairSpec(
        n_pairs=n, read_len=L, edit_frac=E, seed=seed))
    fit = lambda a: np.pad(a, ((0, 0), (0, width - a.shape[1])))
    return fit(P), plen, fit(T), tlen


def _forward_both(pen, heur, P, plen, T, tlen, keep_history=True, **kw):
    jres = j_wf.wfa_forward(P, T, plen, tlen, pen=pen, heur=heur,
                            keep_history=keep_history, **kw)
    tres = t_wf.wfa_forward(P, T, plen, tlen,
                            pen=t_scoring.from_reference(pen),
                            heur=t_scoring.from_reference(heur),
                            keep_history=keep_history, device="cpu", **kw)
    np.testing.assert_array_equal(np.asarray(jres.score), tres.score.numpy())
    assert int(jres.n_steps) == tres.n_steps
    for f in ("m_hist", "i_hist", "d_hist"):
        a, b = getattr(jres, f), getattr(tres, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    return tres


@pytest.mark.parametrize("keep_history", [True, False],
                         ids=["history", "score"])
@pytest.mark.parametrize("heur", HEURS, ids=str)
@pytest.mark.parametrize("pen", MODELS, ids=lambda p: type(p).__name__)
def test_wfa_forward_matches_reference(pen, heur, keep_history):
    """2% and 15% divergence under one optimistic bound (the divergent pairs
    overflow to -1); the histories bit-equal, NEG past the last step."""
    s_max = pen.score_bound(48, 0.06)
    for E in (0.02, 0.15):
        P, plen, T, tlen = _batch(5, 10, 48, E)
        res = _forward_both(pen, heur, P, plen, T, tlen,
                            keep_history=keep_history, s_max=s_max,
                            k_max=16)
        if keep_history:
            assert res.m_hist.shape == (s_max + 1, 10, 33)
            assert (res.i_hist is None) == (pen.kind != "affine")
        else:
            assert res.m_hist is None


@pytest.mark.parametrize("states", [("I", "M"), ("M", "D"), ("D", "I"),
                                    ("I", "I")], ids="".join)
@pytest.mark.parametrize("heur", [None, j_scoring.ZDrop(8)], ids=str)
def test_wfa_forward_boundary_states(states, heur):
    P, plen, T, tlen = _batch(9, 8, 40, 0.05)
    _forward_both(j_scoring.GapAffine(4, 6, 2), heur, P, plen, T, tlen,
                  s_max=96, k_max=20, begin_state=states[0],
                  end_state=states[1])


def test_wfa_forward_refuses_states_on_linear_models():
    P, plen, T, tlen = _batch(9, 2, 20, 0.05, width=32)
    with pytest.raises(ValueError, match="no I/D states"):
        t_wf.wfa_forward(P, T, plen, tlen, pen=t_scoring.Edit(), s_max=8,
                         k_max=4, begin_state="I", device="cpu")


def _stats_view(st):
    return ([(b.lmax, b.s_max, b.k_max, b.n_pairs, b.recovery)
             for b in st.buckets],
            st.n_overflow, st.n_recovered, st.rows_real, st.rows_padded,
            st.cache_hits, st.cache_misses, st.n_traces, st.bytes_in)


@pytest.mark.parametrize("pen,heur", [
    (j_scoring.GapAffine(), None),
    (j_scoring.GapLinear(), j_scoring.AdaptiveBand(10, 4)),
    (j_scoring.Edit(), j_scoring.ZDrop(8)),
], ids=["affine-exact", "linear-adaptive", "edit-zdrop"])
def test_engine_ref_backend_matches_reference(pen, heur):
    """Two length buckets and the exact-bound recovery pass: scores, CIGAR
    strings (both spellings) and counters equal the JAX ref engine's."""
    pats, txts = random_pairs(np.random.default_rng(4), 14, lo=20, hi=60,
                              drift=6)
    kw = dict(backend="ref", edit_frac=0.02, chunk_pairs=8)
    jeng = JEngine(pen, heuristic=heur, **kw)
    teng = AlignmentEngine(t_scoring.from_reference(pen),
                           heuristic=t_scoring.from_reference(heur),
                           device="cpu", **kw)
    for output in ("score", "cigar"):
        want = jeng.align(pats, txts, output=output)
        got = teng.align(pats, txts, output=output)
        np.testing.assert_array_equal(want.scores, got.scores)
        assert _stats_view(want.stats) == _stats_view(got.stats)
        assert (want.n_steps, want.s_max, want.k_max, want.approximate) == \
            (got.n_steps, got.s_max, got.k_max, got.approximate)
        if output == "cigar":
            assert want.cigar_strings() == got.cigar_strings()
            assert want.cigar_strings("classic") == \
                got.cigar_strings("classic")
    assert want.stats.n_overflow > 0


def test_ref_backend_equals_ring_and_gotoh():
    """The full-history CIGARs against the packed ones of the ring backend
    on the same engine settings, and the scores against Gotoh."""
    pats, txts = random_pairs(np.random.default_rng(6), 12, lo=20, hi=70)
    ref = AlignmentEngine(backend="ref", edit_frac=0.05, device="cpu")
    ring = AlignmentEngine(backend="ring", edit_frac=0.05, device="cpu")
    a = ref.align(pats, txts, output="cigar")
    b = ring.align(pats, txts, output="cigar")
    np.testing.assert_array_equal(a.scores, gotoh_oracle(pats, txts))
    np.testing.assert_array_equal(a.scores, b.scores)
    assert a.cigar_strings() == b.cigar_strings()


def test_ref_backend_bidir_leaves_take_states():
    """The BiWFA driver's stateful leaves run on the ref trace variant
    itself (it takes boundary states); CIGARs equal the JAX ref engine's."""
    P, plen, T, tlen = generate_pairs(ReadPairSpec(
        n_pairs=3, read_len=240, edit_frac=0.05, seed=2))
    kw = dict(backend="ref", edit_frac=0.05, trace_budget=1500)
    want = JEngine(**kw).align_packed(P, plen, T, tlen, output="cigar",
                                      trace_variant="bidir")
    got = AlignmentEngine(device="cpu", **kw).align_packed(
        P, plen, T, tlen, output="cigar", trace_variant="bidir")
    np.testing.assert_array_equal(want.scores, got.scores)
    assert want.cigar_strings() == got.cigar_strings()
    assert got.stats.n_bidir_fallback == want.stats.n_bidir_fallback


@pytest.mark.parametrize("output", ["score", "cigar"])
def test_launcher_ref_backend(output):
    summary = {}
    rc = t_align.main(["--backend", "ref", "--device", "cpu", "--pairs",
                       "24", "--read-len", "60", "--chunk-pairs", "16",
                       "--mode", "both", "--output", output, "--verify",
                       "24"], summary)
    assert rc == 0 and summary["verified"] == 24
