"""The premises of the per-pair meet kernel, on the CPU.

* ``kernel.meet_band``, the lanes the meet recurrence can reach at each
  step, bounds the JAX package's full-history fronts
  (``repro.core.wavefront.wfa_forward(keep_history=True)``): every lane
  outside the rule is ``NEG`` at every step, for M, I and D, forward and
  reverse (the reverse front as a forward run on the reversed rows, its
  begin state the meet's end state), over penalty models, boundary states
  and heuristics;
* no pair of ``wfa_meet_plain`` meets outside the steps at which its meet
  test can hold a lane (``kernel.meet_test_steps``), and a pair's own exit
  step is its meet step + 1;
* ``kernel.block_steps`` of the per-pair exit steps is the plain version's
  per-block ``steps``, with padded rows, a block of padding only and
  unmet pairs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import scoring as j_scoring  # noqa: E402
from repro.core import wavefront as j_wf  # noqa: E402
from repro.core.engine import problem_bounds  # noqa: E402
from repro.data.reads import ReadPairSpec, generate_pairs  # noqa: E402
from repro_torch.core import scoring as t_scoring  # noqa: E402
from repro_torch.core import wavefront as t_wf  # noqa: E402
from repro_torch.kernels.wfa import kernel as t_kernel  # noqa: E402
from repro_torch.kernels.wfa import ops as t_ops  # noqa: E402

NEG = t_wf.NEG
_A, _L, _E = j_scoring.GapAffine(), j_scoring.GapLinear(), j_scoring.Edit()
BAND_CASES = [
    (_A, ("M", "M"), None), (_A, ("I", "D"), None), (_A, ("D", "I"), None),
    (_A, ("M", "M"), j_scoring.AdaptiveBand(10, 4)),
    (_A, ("D", "M"), j_scoring.AdaptiveBand(10, 4)),
    (_A, ("M", "M"), j_scoring.ZDrop(8)),
    (_L, ("M", "M"), None), (_L, ("M", "M"), j_scoring.ZDrop(8)),
    (_E, ("M", "M"), None), (_E, ("M", "M"), j_scoring.AdaptiveBand(10, 4)),
]
_id = lambda c: (f"{type(c[0]).__name__}-{''.join(c[1])}-"
                 f"{type(c[2]).__name__ if c[2] else 'exact'}")
# the meet cases of test_torch_kernel_meet.py
MEET_CASES = [
    (_A, ("M", "M"), None), (_A, ("I", "D"), None), (_E, ("M", "M"), None),
    (_A, ("D", "M"), j_scoring.AdaptiveBand(10, 4)),
    (_L, ("M", "M"), j_scoring.ZDrop(8)),
]


def _pairs(n=10, L=56, E=0.08, seed=27):
    P, plen, T, tlen = generate_pairs(
        ReadPairSpec(n_pairs=n, read_len=L, edit_frac=E, seed=seed))
    s_max, k_max = problem_bounds(j_scoring.GapAffine(), plen, tlen, None)
    return P, plen, T, tlen, s_max, k_max


def _outside(hist, band):
    """Lanes of a ``[S, B, K]`` history outside ``band`` ([S, 2]) that are
    not NEG."""
    K = hist.shape[-1]
    j = np.arange(K)[None, :]
    out = (j < band[:, :1]) | (j > band[:, 1:])            # [S, K]
    return int(((hist != NEG) & out[:, None, :]).sum())


@pytest.mark.parametrize("case", BAND_CASES, ids=_id)
def test_meet_band_bounds_full_history(case):
    pen, (begin, end), heur = case
    P, plen, T, tlen, s_max, k_max = _pairs()
    K = 2 * k_max + 1
    band = t_kernel.meet_band(t_scoring.from_reference(pen), s_max, K,
                              begin, end)
    assert band.shape == (s_max + 1, 2, 3, 2)
    fronts = ((P, T, begin, end),
              (np.asarray(j_wf._reverse_rows(P, plen)),
               np.asarray(j_wf._reverse_rows(T, tlen)), end, begin))
    for f, (p, t, b, e) in enumerate(fronts):
        res = j_wf.wfa_forward(p, t, plen, tlen, pen=pen, s_max=s_max,
                               k_max=k_max, keep_history=True, heur=heur,
                               begin_state=b, end_state=e)
        hists = [res.m_hist, res.i_hist, res.d_hist]
        for ring, hist in enumerate(hists):
            if hist is None:            # linear models: M only, no I/D band
                assert (band[:, f, ring, 0] > band[:, f, ring, 1]).all()
                continue
            hist = np.asarray(hist)
            assert _outside(hist, band[:, f, ring]) == 0, (f, ring)
        # the rule is not vacuous: M is reached at an edge of the rule at
        # each of the first steps that hold a lane (the run stops once every
        # pair has reached its end), and the range is narrower than the
        # lanes early on
        m = np.asarray(res.m_hist)
        lo, hi = band[:, f, 0, 0], band[:, f, 0, 1]
        assert hi[4] - lo[4] + 1 < K
        reached = [bool((m[s, :, lo[s]] != NEG).any()
                        or (m[s, :, hi[s]] != NEG).any())
                   for s in range(min(8, int(np.max(res.score))) + 1)
                   if lo[s] <= hi[s]]
        assert reached and all(reached)


def test_meet_band_closed_form():
    """GapAffine(4,6,2) from M: M reaches lane kc +- d first at s = 6 + 2d
    (the gap opens at o + e = 8, each step of e = 2 extends it), odd steps
    hold no lane, and I / D hold the upper / lower edge."""
    band = t_kernel.meet_band(t_scoring.GapAffine(4, 6, 2), 200, 256)
    kc = 128
    for s in range(0, 201):
        lo, hi = band[s, 0, 0]
        if s % 2 or s in (2, 6):
            assert lo > hi
        elif s < 8:
            assert (lo, hi) == (kc, kc)
        else:
            d = (s - 6) // 2
            assert (lo, hi) == (kc - d, kc + d), s
            assert band[s, 0, 1, 1] == kc + d and band[s, 0, 2, 0] == kc - d
    assert (band[:, 0] == band[:, 1]).all()     # both fronts seed M only


def _meet_inputs(P, plen, T, tlen, st, bp, extra_rows=0):
    pp, tt, pl, tl, B = t_ops._prep(P, T, plen, tlen, bp, device="cpu")
    st2 = torch.zeros((pp.shape[0], 1), dtype=torch.int32)
    st2[:B, 0] = torch.as_tensor(st, dtype=torch.int32)
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, extra_rows))
    pp, tt, pl, tl, st2 = (pad(t) for t in (pp, tt, pl, tl, st2))
    return (pp, tt, t_wf._reverse_rows(pp, pl[:, 0]),
            t_wf._reverse_rows(tt, tl[:, 0]), pl, tl, st2), B


def _costs(P, plen, T, tlen, pen, heur, states, s_max, k_max):
    return t_wf.wfa_scores_packed(
        P, T, plen, tlen, pen=t_scoring.from_reference(pen), s_max=s_max,
        k_max=k_max, heur=t_scoring.from_reference(heur),
        begin_state=states[0], end_state=states[1],
        device="cpu").score.numpy()


@pytest.mark.parametrize("case", MEET_CASES, ids=_id)
def test_meet_only_in_testable_steps(case):
    pen, states, heur = case
    P, plen, T, tlen, s_max, k_max = _pairs()
    st = _costs(P, plen, T, tlen, pen, heur, states, s_max, k_max)
    args, B = _meet_inputs(P, plen, T, tlen, st, 1)
    tp = t_scoring.from_reference(pen)
    k_pad = t_ops._round_up(2 * k_max + 1, t_ops.LANE)
    out = t_kernel.wfa_meet_plain(
        *args, pen=tp, s_max=s_max, k_pad=k_pad, block_pairs=1,
        heur=t_scoring.from_reference(heur), begin_state=states[0],
        end_state=states[1])
    score, steps, a, b = (out[i][:, 0] for i in (0, 1, 3, 4))
    met = score >= 0
    assert int(met.sum()) >= 5
    first, stop = t_kernel.meet_test_steps(args[6][:, 0], tp, states[1])
    at = torch.maximum(a, b).to(torch.int64)
    assert bool(((at >= first) & (at < stop))[met].all())
    assert bool((steps[met] == at[met] + 1).all())
    assert bool((steps[~met] == s_max + 1).all())


def test_block_steps_matches_plain():
    """Padded rows (10 pairs in blocks of 4), a block of padding only (4
    more rows), pairs that do not meet within a small s_max and a pair of
    cost 0 (no split to find)."""
    P, plen, T, tlen, s_max, k_max = _pairs()
    pen = j_scoring.GapAffine()
    st = _costs(P, plen, T, tlen, pen, None, ("M", "M"), s_max, k_max)
    st[3] = 0
    small = int(np.median(st)) // 2 + 2
    tp = t_scoring.from_reference(pen)
    k_pad = t_ops._round_up(2 * k_max + 1, t_ops.LANE)
    for cap in (s_max, small):
        args, B = _meet_inputs(P, plen, T, tlen, st, 4, extra_rows=4)
        kw = dict(pen=tp, s_max=cap, k_pad=k_pad)
        per_pair = t_kernel.wfa_meet_plain(*args, block_pairs=1, **kw)
        blocked = t_kernel.wfa_meet_plain(*args, block_pairs=4, **kw)
        got = t_kernel.block_steps(per_pair[1], 4)
        np.testing.assert_array_equal(got.numpy(), blocked[1].numpy())
        for a, b in zip(per_pair[:1] + per_pair[2:],
                        blocked[:1] + blocked[2:]):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        assert got[-4:].tolist() == [[1]] * 4
        assert per_pair[1][B:].tolist() == [[1]] * (got.shape[0] - B)
        assert per_pair[1][3, 0] == cap + 1 and per_pair[0][3, 0] == -1
        if cap == small:
            assert 0 < int((per_pair[0][:B] >= 0).sum()) < B - 1
