"""The port's ring solvers (``repro_torch.core.wavefront``) equal the JAX
package's exactly: scores, step counts and packed trace words, across
penalty models x heuristics x divergence."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import scoring as j_scoring  # noqa: E402
from repro.core import wavefront as j_wf  # noqa: E402
from repro.core.engine import problem_bounds  # noqa: E402
from repro.data.reads import ReadPairSpec, generate_pairs  # noqa: E402
from repro_torch.core import scoring as t_scoring  # noqa: E402
from repro_torch.core import wavefront as t_wf  # noqa: E402

MODELS = [j_scoring.GapAffine(), j_scoring.GapLinear(), j_scoring.Edit()]
HEURS = [None, j_scoring.AdaptiveBand(10, 4), j_scoring.ZDrop(8)]


def _batch(seed, n, L, E, width=64):
    """Seeded pairs padded to a fixed width (one compiled shape per model)."""
    P, plen, T, tlen = generate_pairs(ReadPairSpec(
        n_pairs=n, read_len=L, edit_frac=E, seed=seed))
    fit = lambda a: np.pad(a, ((0, 0), (0, width - a.shape[1])))
    return fit(P), plen, fit(T), tlen


def _same(jres, tres):
    np.testing.assert_array_equal(np.asarray(jres.score), tres.score.numpy())
    assert int(jres.n_steps) == tres.n_steps
    for f in ("m_bt", "i_bt", "d_bt"):
        a, b = getattr(jres, f), getattr(tres, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _check_both(pen, heur, P, plen, T, tlen, s_max, k_max):
    kw = dict(s_max=s_max, k_max=k_max)
    tp = t_scoring.from_reference(pen)
    th = t_scoring.from_reference(heur)
    _same(j_wf.wfa_scores(P, T, plen, tlen, pen=pen, heur=heur, **kw),
          t_wf.wfa_scores(P, T, plen, tlen, pen=tp, heur=th, device="cpu",
                          **kw))
    _same(j_wf.wfa_scores_packed(P, T, plen, tlen, pen=pen, heur=heur, **kw),
          t_wf.wfa_scores_packed(P, T, plen, tlen, pen=tp, heur=th,
                                 device="cpu", **kw))


@pytest.mark.parametrize("heur", HEURS, ids=str)
@pytest.mark.parametrize("pen", MODELS, ids=lambda p: type(p).__name__)
def test_ring_solvers_match_reference(pen, heur):
    """2%, 10% and 25% divergence under one optimistic bound: the most
    divergent pairs overflow to -1."""
    s_max = pen.score_bound(48, 0.06)
    for E in (0.02, 0.1, 0.25):
        P, plen, T, tlen = _batch(7, 12, 48, E)
        _check_both(pen, heur, P, plen, T, tlen, s_max, 16)


@pytest.mark.parametrize("states", [("I", "M"), ("M", "D"), ("D", "I")])
def test_packed_boundary_states_match_reference(states):
    P, plen, T, tlen = _batch(3, 6, 40, 0.1)
    pen = j_scoring.GapAffine()
    s_max, k_max = problem_bounds(pen, plen, tlen, None)
    kw = dict(s_max=s_max, k_max=k_max, begin_state=states[0],
              end_state=states[1])
    _same(j_wf.wfa_scores_packed(P, T, plen, tlen, pen=pen, **kw),
          t_wf.wfa_scores_packed(P, T, plen, tlen,
                                 pen=t_scoring.GapAffine(), device="cpu",
                                 **kw))


def test_keep_mask_matches_reference():
    rng = np.random.default_rng(1)
    M = rng.integers(-3, 40, size=(5, 21)).astype(np.int32)
    M[rng.random(M.shape) < 0.3] = j_wf.NEG
    plen = rng.integers(30, 45, size=(5, 1)).astype(np.int32)
    tlen = rng.integers(30, 45, size=(5, 1)).astype(np.int32)
    ks = (np.arange(21, dtype=np.int32) - 10)[None, :]
    import torch
    for heur in HEURS[1:] + [j_scoring.AdaptiveBand(2, 1)]:
        want = np.asarray(j_wf.keep_mask(heur, M, plen, tlen, ks))
        got = t_wf.keep_mask(t_scoring.from_reference(heur),
                             *(torch.from_numpy(a)
                               for a in (M, plen, tlen, ks)))
        np.testing.assert_array_equal(want, got.numpy())
    assert t_wf.keep_mask(t_scoring.EXACT, None, None, None, None) is None


@pytest.mark.parametrize("fn", ["wfa_scores", "wfa_scores_packed"])
def test_solvers_default_to_the_card(fn, monkeypatch):
    """Without ``device`` the solvers run on the card, and raise when there
    is none rather than run on the host."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    P, plen, T, tlen = _batch(0, 2, 20, 0.05)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(t_wf, fn)(P, T, plen, tlen, pen=t_scoring.GapAffine(),
                          s_max=20, k_max=8)
