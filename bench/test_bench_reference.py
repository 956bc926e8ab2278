"""The yardstick on the CPU: the batched reference against its frozen
numpy copy and against the port's plain CPU path, the vectorised CIGAR
re-scorer against the frozen loop, the work count against a brute-force
count of wavefront cells, and the pool generator's edit model."""
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from harness import frozen_gotoh, gen, reference, work  # noqa: E402

MIX = {"sub": 0.6, "ins": 0.2, "del": 0.2}
X, O, E = 4, 6, 2


def _pairs(n, L, frac, seed):
    P, plen, T, tlen, kept = gen.generate_pool(n, L, frac, MIX, seed)
    return P, plen, T, tlen, kept


@pytest.mark.parametrize("L,frac", [(20, 0.2), (100, 0.04), (37, 0.1)])
def test_reference_equals_frozen_gotoh(L, frac):
    P, plen, T, tlen, _ = _pairs(64, L, frac, L)
    got = reference.gotoh_scores(P, plen, T, tlen, X, O, E, block_cells=500)
    want = [frozen_gotoh.gotoh_score(P[i, :plen[i]], T[i, :tlen[i]], X, O, E)
            for i in range(64)]
    assert got.tolist() == want


def test_reference_on_unequal_lengths_and_empties():
    rng = np.random.default_rng(0)
    n = 40
    plen = rng.integers(0, 30, n).astype(np.int32)
    tlen = rng.integers(0, 30, n).astype(np.int32)
    P = rng.integers(65, 69, (n, 30)).astype(np.int32)
    T = rng.integers(65, 69, (n, 30)).astype(np.int32)
    got = reference.gotoh_scores(P, plen, T, tlen, X, O, E)
    want = [frozen_gotoh.gotoh_score(P[i, :plen[i]], T[i, :tlen[i]], X, O, E)
            for i in range(n)]
    assert got.tolist() == want


def test_reference_and_rescorer_against_the_port_on_cpu():
    """A few hundred tiny pairs: the port's plain CPU path gives the
    reference's scores, and CIGARs that the re-scorer passes."""
    from repro_torch.core import scoring
    from repro_torch.core.engine import AlignmentEngine
    P, plen, T, tlen, _ = _pairs(300, 24, 0.15, 9)
    eng = AlignmentEngine(scoring.GapAffine(X, O, E), backend="kernel",
                          edit_frac=0.15, device="cpu")
    res = eng.align_packed(P, plen, T, tlen, output="cigar")
    ref = reference.gotoh_scores(P, plen, T, tlen, X, O, E)
    assert np.array_equal(res.scores, ref)
    bad = reference.check_pairs(res.scores, ref, res.cigars, P, plen, T,
                                tlen, X, O, E)
    assert bad == {"score_mismatch": 0, "cigar_bad": 0}
    # one changed op is caught
    cig = [c.copy() for c in res.cigars]
    j = int(np.flatnonzero(cig[5] == 0)[0])
    cig[5][j] = 1
    assert reference.check_pairs(res.scores, ref, cig, P, plen, T, tlen,
                                 X, O, E)["cigar_bad"] == 1


def test_rescorer_equals_the_frozen_loop():
    rng = np.random.default_rng(3)
    P, plen, T, tlen, _ = _pairs(200, 16, 0.2, 4)
    cigars = []
    for i in range(200):                 # random op strings, valid or not
        n = int(rng.integers(0, 40))
        c = rng.integers(-1, 5, n).astype(np.int32)
        cigars.append(c)
    got = reference.rescore_cigars(cigars, P, plen, T, tlen, X, O, E)
    for i in range(200):
        want = frozen_gotoh.score_cigar(cigars[i], P[i, :plen[i]],
                                        T[i, :tlen[i]], X, O, E)
        assert (got[0][i], got[1][i], got[2][i], bool(got[3][i])) == want, i


def _brute_ops(score, plen, tlen):
    """Cells of the gap-affine wavefronts as sets, score by score."""
    Ms, Is, Ds = {0: {0}}, {}, {}
    total = 0
    for s in range(score + 1):
        if s:
            I = ({k + 1 for k in Ms.get(s - O - E, ())}
                 | {k + 1 for k in Is.get(s - E, ())})
            D = ({k - 1 for k in Ms.get(s - O - E, ())}
                 | {k - 1 for k in Ds.get(s - E, ())})
            M = set(Ms.get(s - X, ())) | I | D
            Ms[s], Is[s], Ds[s] = M, I, D
        if s == score:
            break
        inside = lambda ks: sum(1 for k in ks if -plen <= k <= tlen)
        total += (work.M_OPS * inside(Ms.get(s, ()))
                  + work.GAP_OPS * (inside(Is.get(s, ()))
                                    + inside(Ds.get(s, ()))))
    return total + work.M_OPS


def test_work_count_equals_brute_force():
    rng = np.random.default_rng(5)
    score = rng.integers(0, 60, 300)
    plen = rng.integers(0, 25, 300)
    tlen = rng.integers(0, 25, 300)
    got = work.wavefront_ops(score, plen, tlen, X, O, E)
    want = [_brute_ops(int(s), int(p), int(t))
            for s, p, t in zip(score, plen, tlen)]
    assert got.tolist() == want


def test_work_bytes_and_roofline():
    plen = np.array([100, 98])
    tlen = np.array([101, 100])
    assert work.wave_bytes(plen, tlen, False) == int(
        np.ceil((399 / 4) + 2 * 12))
    assert work.wave_bytes(plen, tlen, True) == int(
        np.ceil((399 / 4) + 2 * 12 + (101 + 100) / 4))
    assert abs(work.roofline_pct(3.35e9, 0, 0.002) - 50.0) < 1e-9
    ops = work.PEAKS["int32_ops_per_s"] * 0.001
    assert abs(work.roofline_pct(1.0, ops, 0.004) - 25.0) < 1e-9


@pytest.mark.parametrize("L,frac", [(100, 0.02), (100, 0.04), (1000, 0.03)])
def test_generator_edits_stay_within_the_bound(L, frac):
    P, plen, T, tlen, kept = _pairs(512, L, frac, 11)
    n_err = gen.max_edits(L, frac)
    assert kept.max() <= n_err
    assert np.all(np.abs(tlen - plen) <= kept)
    assert set(np.unique(P)) <= {65, 67, 71, 84}
    for i in range(512):
        assert set(np.unique(T[i, :tlen[i]])) <= {65, 67, 71, 84}
        assert not T[i, tlen[i]:].any()
    # unit-cost distance at most the edits (the reference at x 1, o 0, e 1)
    dist = reference.gotoh_scores(P[:64], plen[:64], T[:64], tlen[:64],
                                  1, 0, 1)
    assert np.all(dist <= kept[:64])


def test_generator_is_seeded_with_one_edit_multiset():
    gen_ = lambda seed: gen.generate_pool(1024, 1000, 0.03, MIX, seed,
                                          block=64)
    a, b, c = gen_(2 ** 31 + 17), gen_(2 ** 31 + 17), gen_(5)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    assert not np.array_equal(a[0], c[0])
    # every block of 64 draws the same edit counts, 0 .. 30 spread evenly;
    # draws that hit one position keep the first, so the counts kept are
    # nearly, not exactly, the same
    for kept in (a[4], c[4]):
        per_block = np.sort(kept.reshape(16, 64), axis=1)
        want = ((np.arange(64) + 0.5) * 31 / 64).astype(int)
        assert np.all(per_block <= want[None, :] + 0)
        assert (want[None, :] - per_block).sum() <= 0.02 * 16 * want.sum()
    with pytest.raises(ValueError):
        gen.generate_pool(100, 10, 0.1, MIX, 1, block=64)
