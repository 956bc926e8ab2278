"""The port's host-side foundations equal the JAX package's: scoring models
and heuristics, the Gotoh oracle, the read-pair generators, DNA helpers and
CIGAR formatting."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import gotoh as j_gotoh  # noqa: E402
from repro.core import scoring as j_scoring  # noqa: E402
from repro.data import dna as j_dna  # noqa: E402
from repro.data import reads as j_reads  # noqa: E402
from repro_torch.core import gotoh as t_gotoh  # noqa: E402
from repro_torch.core import scoring as t_scoring  # noqa: E402
from repro_torch.data import dna as t_dna  # noqa: E402
from repro_torch.data import reads as t_reads  # noqa: E402

SPECS = ["edit", "linear", "affine", "linear:3,2", "affine:5,3,1", "4,6,2"]
HEURS = ["none", "adaptive", "adaptive:5,3", "zdrop", "zdrop:7"]


@pytest.mark.parametrize("spec", SPECS)
def test_penalty_models_agree(spec):
    a = j_scoring.parse_penalties(spec)
    b = t_scoring.parse_penalties(spec)
    assert type(a).__name__ == type(b).__name__
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert (a.kind, a.x, a.o, a.e, a.window) == (b.kind, b.x, b.o, b.e,
                                                 b.window)
    for L, E, d in ((100, 0.02, 0), (128, 0.04, 3), (250, 0.1, 7)):
        assert a.score_bound(L, E, len_diff=d) == b.score_bound(
            L, E, len_diff=d)
        s = a.score_bound(L, E)
        assert a.band_bound(s) == b.band_bound(s)
        assert a.worst_score(L, L - d) == b.worst_score(L, L - d)
    assert t_scoring.from_reference(a) == b


@pytest.mark.parametrize("spec", HEURS)
def test_heuristics_agree(spec):
    a = j_scoring.parse_heuristic(spec)
    b = t_scoring.parse_heuristic(spec)
    assert t_scoring.from_reference(a) == b
    assert a.exact == b.exact
    for K in (35, 129, 257, 769):
        assert a.band_cap(K) == b.band_cap(K)


def test_from_reference_legacy_triple_and_none():
    from repro.core.penalties import Penalties
    got = t_scoring.from_reference(Penalties(3, 5, 1))
    assert t_scoring.as_model(got) == t_scoring.GapAffine(3, 5, 1)
    assert t_scoring.from_reference(None) is None
    with pytest.raises(TypeError):
        t_scoring.from_reference(object())


@pytest.mark.parametrize("spec", ["edit", "linear", "affine"])
def test_gotoh_oracle_agrees(spec):
    rng = np.random.default_rng(5)
    pj = j_scoring.parse_penalties(spec).as_penalties()
    pt = t_scoring.parse_penalties(spec).as_penalties()
    for _ in range(12):
        p = rng.integers(65, 69, size=int(rng.integers(0, 40)))
        t = rng.integers(65, 69, size=int(rng.integers(0, 40)))
        assert j_gotoh.gotoh_score_vec(p, t, pj) == \
            t_gotoh.gotoh_score_vec(p, t, pt)
        assert j_gotoh.gotoh_score(p, t, pj) == t_gotoh.gotoh_score(p, t, pt)


@pytest.mark.parametrize("seed,n,L,E", [(0, 16, 100, 0.02),
                                        (3, 9, 60, 0.1),
                                        (11, 5, 250, 0.04)])
def test_generate_pairs_identical(seed, n, L, E):
    a = j_reads.generate_pairs(j_reads.ReadPairSpec(
        n_pairs=n, read_len=L, edit_frac=E, seed=seed))
    b = t_reads.generate_pairs(t_reads.ReadPairSpec(
        n_pairs=n, read_len=L, edit_frac=E, seed=seed))
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_generate_pairs_empty_batch():
    P, plen, T, tlen = t_reads.generate_pairs(t_reads.ReadPairSpec(
        n_pairs=0))
    assert P.shape == (0, 0) and T.shape == (0, 0)
    assert plen.shape == (0,) and tlen.shape == (0,)


def test_sample_from_reference_identical():
    ref = j_dna.random_reference(2000, seed=4)
    np.testing.assert_array_equal(ref, t_dna.random_reference(2000, seed=4))
    a = j_reads.sample_from_reference(ref, 6, read_len=80, seed=2)
    b = t_reads.sample_from_reference(ref, 6, read_len=80, seed=2)
    for x, y in zip(a, b):
        for fx, fy in zip(dataclasses.astuple(x), dataclasses.astuple(y)):
            np.testing.assert_array_equal(fx, fy)


def test_dna_helpers_agree():
    s = "ACGTNacgtnGATTACA"
    assert j_dna.revcomp(s) == t_dna.revcomp(s)
    np.testing.assert_array_equal(j_dna.encode_2bit(s), t_dna.encode_2bit(s))
    codes = j_dna.encode_2bit("ACGTTGCA")
    assert j_dna.decode_2bit(codes) == t_dna.decode_2bit(codes)
