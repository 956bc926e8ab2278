"""The port's WFA kernel path equals the JAX package's Pallas kernel.

On CPU tensors the port's wrapper runs the kernel's plain version; it is
held bit for bit against ``repro.kernels.wfa`` under ``interpret=True``:
scores, per-block ``steps`` and packed trace words, at the same
``block_pairs``, across penalty models x heuristics x outputs, with padded
pairs, ragged lengths and pairs over ``s_max`` (-1).  The CUDA kernel itself
is held against the plain version on the card (``gpu`` marker)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import scoring as j_scoring  # noqa: E402
from repro.data.reads import ReadPairSpec, generate_pairs  # noqa: E402
from repro.kernels.wfa import ops as j_ops  # noqa: E402
from repro.kernels.wfa.kernel import wfa_pallas  # noqa: E402
from repro_torch.core import scoring as t_scoring  # noqa: E402
from repro_torch.kernels.wfa import kernel as t_kernel  # noqa: E402
from repro_torch.kernels.wfa import ops as t_ops  # noqa: E402

MODELS = [j_scoring.GapAffine(), j_scoring.GapLinear(), j_scoring.Edit()]
HEURS = [None, j_scoring.AdaptiveBand(10, 4), j_scoring.ZDrop(8)]


def _batch(n=13, L=40, E=0.12, seed=4):
    return generate_pairs(ReadPairSpec(n_pairs=n, read_len=L, edit_frac=E,
                                       seed=seed))


def _both(P, plen, T, tlen, pen, heur, s_max, k_max, bp, trace):
    """(JAX outputs, port outputs) of the kernel itself on the same pairs,
    each padded by its own package's wrapper."""
    jp = j_ops._prep(P, T, plen, tlen, bp)
    k_pad = j_ops._round_up(2 * k_max + 1, j_ops.LANE)
    want = wfa_pallas(*jp[:4], pen=pen, s_max=s_max, k_pad=k_pad,
                      block_pairs=bp, interpret=True, trace=trace,
                      heur=j_scoring.as_heuristic(heur))
    tp = t_ops._prep(P, T, plen, tlen, bp, device="cpu")
    got = t_kernel.wfa_kernel(*tp[:4], pen=t_scoring.from_reference(pen),
                              s_max=s_max, k_pad=k_pad, block_pairs=bp,
                              trace=trace,
                              heur=t_scoring.from_reference(heur))
    return [np.asarray(a) for a in want], [t.numpy() for t in got]


def _assert_same(want, got):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("heur", HEURS, ids=str)
@pytest.mark.parametrize("pen", MODELS, ids=lambda p: type(p).__name__)
def test_kernel_matches_pallas(pen, heur):
    """13 ragged pairs (3 padded rows at block_pairs 8); the optimistic
    bound leaves the most divergent pairs at -1."""
    P, plen, T, tlen = _batch()
    s_max = pen.score_bound(40, 0.02)
    k_max = 12
    scores = None
    for trace in (False, True):
        want, got = _both(P, plen, T, tlen, pen, heur, s_max, k_max, 8,
                          trace)
        _assert_same(want, got)
        scores = got[0]
    assert (scores[:13] == -1).any() and (scores[:13] >= 0).any()
    assert (scores[13:] == 0).all()          # padded pairs resolve at s=0


def test_ops_wrappers_match_reference():
    P, plen, T, tlen = _batch(n=11, seed=9)
    pen = j_scoring.GapAffine()
    kw = dict(s_max=40, k_max=14, block_pairs=4)
    want = j_ops.wfa_align_trace(P, T, plen, tlen, pen=pen, interpret=True,
                                 heur=j_scoring.ZDrop(6), **kw)
    got = t_ops.wfa_align_trace(P, T, plen, tlen,
                                pen=t_scoring.GapAffine(),
                                heur=t_scoring.ZDrop(6), device="cpu", **kw)
    _assert_same([np.asarray(a) for a in want], [t.numpy() for t in got])
    want = j_ops.wfa_align(P, T, plen, tlen, pen=pen, interpret=True, **kw)
    got = t_ops.wfa_align(P, T, plen, tlen, pen=t_scoring.GapAffine(),
                          device="cpu", **kw)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    lin = t_ops.wfa_align_trace(P, T, plen, tlen, pen=t_scoring.Edit(),
                                s_max=12, k_max=6, device="cpu")
    assert lin[2] is None and lin[3] is None


@pytest.mark.parametrize("bp", [1, 4])
def test_block_pairs_and_exact_bucket(bp):
    """Other block sizes, and an exact-bound bucket (k_pad 384)."""
    P, plen, T, tlen = _batch(n=6, L=60, E=0.05, seed=2)
    pen = j_scoring.GapAffine()
    want, got = _both(P, plen, T, tlen, pen, None, 240, 130, bp, True)
    assert got[2].shape[-1] == 384
    _assert_same(want, got)


def test_empty_and_tiny_pairs():
    P = np.zeros((4, 4), np.int32)
    T = np.zeros((4, 4), np.int32)
    P[1, 0], T[2, 0], P[3, 0] = 65, 66, 67
    plen = np.array([0, 1, 0, 1], np.int32)
    tlen = np.array([0, 1, 1, 0], np.int32)
    want, got = _both(P, plen, T, tlen, j_scoring.GapAffine(), None, 12, 2,
                      8, True)
    _assert_same(want, got)


def test_band_cap_not_ported():
    P, plen, T, tlen = _batch(n=2)
    with pytest.raises(NotImplementedError, match="band_cap"):
        t_ops.wfa_align(P, T, plen, tlen, pen=t_scoring.GapAffine(),
                        s_max=20, k_max=8, band_cap=128, device="cpu")


@pytest.mark.parametrize("fn", ["wfa_align", "wfa_align_trace"])
def test_ops_default_to_the_card(fn, monkeypatch):
    """Without ``device`` the wrappers run on the card, and raise when there
    is none rather than run the plain version on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    P, plen, T, tlen = _batch(n=2)
    before = dict(t_kernel.LAUNCHES)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(t_ops, fn)(P, T, plen, tlen, pen=t_scoring.GapAffine(),
                           s_max=20, k_max=8)
    assert t_kernel.LAUNCHES == before


class _OnCard:
    """Stands in for a CUDA tensor: only its device is looked at."""
    device = torch.device("cuda")


def test_wrapper_dispatch_by_device(monkeypatch):
    calls = []
    monkeypatch.setattr(t_kernel, "wfa_cuda",
                        lambda *a, **k: calls.append("cuda"))
    monkeypatch.setattr(t_kernel, "wfa_plain",
                        lambda *a, **k: calls.append("plain"))
    kw = dict(pen=t_scoring.Edit(), s_max=4, k_pad=128, block_pairs=1)
    t_kernel.wfa_kernel(_OnCard(), None, None, None, **kw)
    t_kernel.wfa_kernel(torch.zeros((1, 4), dtype=torch.int32), None, None,
                        None, **kw)
    assert calls == ["cuda", "plain"]


def test_cuda_launcher_refuses_cpu_tensors():
    z = torch.zeros((8, 4), dtype=torch.int32)
    lens = torch.zeros((8, 1), dtype=torch.int32)
    before = dict(t_kernel.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_kernel.wfa_cuda(z, z, lens, lens, pen=t_scoring.Edit(), s_max=4,
                          k_pad=128, block_pairs=8)
    assert t_kernel.LAUNCHES == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_kernel_matches_plain(cuda_device):
    """Every model x heuristic x output, at pass-1 and exact-bucket bounds
    (rings in shared memory and in global scratch)."""
    P, plen, T, tlen = _batch(n=64, L=100, E=0.04, seed=1)
    args = t_ops._prep(P, T, plen, tlen, 8, device=cuda_device)[:4]
    for pen in (t_scoring.GapAffine(), t_scoring.GapLinear(),
                t_scoring.Edit()):
        for heur in (None, t_scoring.AdaptiveBand(10, 4),
                     t_scoring.ZDrop(8)):
            for trace in (False, True):
                for s_max, k_pad in ((38, 128), (416, 384)):
                    kw = dict(pen=pen, s_max=s_max, k_pad=k_pad,
                              block_pairs=8, trace=trace, heur=heur)
                    before = dict(t_kernel.LAUNCHES)
                    got = t_kernel.wfa_cuda(*args, **kw)
                    torch.cuda.synchronize()
                    want = t_kernel.wfa_plain(*args, **kw)
                    _assert_same([t.cpu().numpy() for t in want],
                                 [t.cpu().numpy() for t in got])
                    key = "trace" if trace else "score"
                    assert t_kernel.LAUNCHES[key] == before[key] + 1
