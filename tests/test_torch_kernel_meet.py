"""The port's BiWFA meet search equals the JAX package's.

On CPU tensors the meet kernel's wrapper runs its plain version; it is held
field for field against ``repro.kernels.wfa``'s Pallas meet kernel under
``interpret=True`` (score, state, a, b, k, h, safe and the per-row
``steps``), and the port's shared solver ``wfa_bidir_meet`` against the JAX
``core.wavefront.wfa_bidir_meet`` (with ``n_steps``).  Exact equality: every
field is an integer.  The CUDA kernel itself is held against the plain
version on the card in ``test_torch_wfa_gpu.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import scoring as j_scoring  # noqa: E402
from repro.core import wavefront as j_wf  # noqa: E402
from repro.core.engine import problem_bounds  # noqa: E402
from repro.data.reads import ReadPairSpec, generate_pairs  # noqa: E402
from repro.kernels.wfa import ops as j_ops  # noqa: E402
from repro.kernels.wfa.kernel import wfa_meet_pallas  # noqa: E402
from repro_torch.core import scoring as t_scoring  # noqa: E402
from repro_torch.core import wavefront as t_wf  # noqa: E402
from repro_torch.kernels.wfa import kernel as t_kernel  # noqa: E402
from repro_torch.kernels.wfa import ops as t_ops  # noqa: E402

FIELDS = ("score", "meet_state", "meet_a", "meet_b", "meet_k", "meet_h",
          "meet_safe")
CASES = [
    (j_scoring.GapAffine(), ("M", "M"), None),
    (j_scoring.GapAffine(), ("I", "D"), None),
    (j_scoring.Edit(), ("M", "M"), None),
    (j_scoring.GapAffine(), ("D", "M"), j_scoring.AdaptiveBand(10, 4)),
    (j_scoring.GapLinear(), ("M", "M"), j_scoring.ZDrop(8)),
]
CASE_IDS = ["affine-MM", "affine-ID", "edit-MM", "affine-DM-adaptive",
            "linear-MM-zdrop"]


def _pairs(n=10, L=56, E=0.08, seed=27):
    P, plen, T, tlen = generate_pairs(
        ReadPairSpec(n_pairs=n, read_len=L, edit_frac=E, seed=seed))
    s_max, k_max = problem_bounds(j_scoring.GapAffine(), plen, tlen, None)
    return P, plen, T, tlen, s_max, k_max


def _starget(P, plen, T, tlen, pen, heur, states, s_max, k_max):
    """Each pair's cost under the boundary states (the port's packed ring
    solver, itself held against the reference in test_torch_wavefront)."""
    return t_wf.wfa_scores_packed(
        P, T, plen, tlen, pen=t_scoring.from_reference(pen), s_max=s_max,
        k_max=k_max, heur=t_scoring.from_reference(heur),
        begin_state=states[0], end_state=states[1],
        device="cpu").score.numpy()


def _assert_fields(want, got):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                      getattr(got, f).numpy(), err_msg=f)


@pytest.mark.parametrize("pen,states,heur", CASES, ids=CASE_IDS)
def test_meet_matches_reference(pen, states, heur):
    """(a) kernel path vs the Pallas meet kernel (interpret mode), every
    field and per-row steps; (b) shared solver vs the JAX solver, every
    field and n_steps.  10 ragged pairs: 2 padded rows at block_pairs 4."""
    P, plen, T, tlen, s_max, k_max = _pairs()
    st = _starget(P, plen, T, tlen, pen, heur, states, s_max, k_max)
    kw = dict(s_max=s_max, k_max=k_max, begin_state=states[0],
              end_state=states[1])
    tp, th = t_scoring.from_reference(pen), t_scoring.from_reference(heur)

    want = j_ops.wfa_bidir_meet_kernel(P, T, plen, tlen, st, pen=pen,
                                       heur=heur, block_pairs=4,
                                       interpret=True, **kw)
    got = t_ops.wfa_bidir_meet_kernel(P, T, plen, tlen, st, pen=tp, heur=th,
                                      block_pairs=4, device="cpu", **kw)
    _assert_fields(want, got)
    assert int(want.n_steps) == int(got.n_steps)
    assert (got.score.numpy() >= 0).any()

    # per-row steps (and every other output) of the kernels themselves
    jp = j_ops._prep(P, T, plen, tlen, 4)
    k_pad = j_ops._round_up(2 * k_max + 1, j_ops.LANE)
    st2 = np.zeros((jp[0].shape[0], 1), np.int32)
    st2[:len(st), 0] = st
    raw = wfa_meet_pallas(
        jp[0], jp[1], j_wf._reverse_rows(jp[0], jp[2][:, 0]),
        j_wf._reverse_rows(jp[1], jp[3][:, 0]), jp[2], jp[3], st2, pen=pen,
        s_max=s_max, k_pad=k_pad, block_pairs=4, interpret=True,
        heur=j_scoring.as_heuristic(heur), begin_state=states[0],
        end_state=states[1])
    tpp, ttt, tpl, ttl, _ = t_ops._prep(P, T, plen, tlen, 4, device="cpu")
    mine = t_kernel.wfa_meet_kernel(
        tpp, ttt, t_wf._reverse_rows(tpp, tpl[:, 0]),
        t_wf._reverse_rows(ttt, ttl[:, 0]), tpl, ttl, torch.from_numpy(st2),
        pen=tp, s_max=s_max, k_pad=k_pad, block_pairs=4, heur=th,
        begin_state=states[0], end_state=states[1])
    assert len(raw) == len(mine) == 8
    for a, b in zip(raw, mine):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert (mine[1][-2:] == mine[1][-4]).all()     # padded rows: block steps

    ref = j_wf.wfa_bidir_meet(P, T, plen, tlen, st, pen=pen, heur=heur, **kw)
    mine = t_wf.wfa_bidir_meet(P, T, plen, tlen, st, pen=tp, heur=th,
                               device="cpu", **kw)
    _assert_fields(ref, mine)
    assert int(ref.n_steps) == int(mine.n_steps)


def test_meet_block_invariance():
    """(c) every field but the step count is independent of the blocking."""
    P, plen, T, tlen, s_max, k_max = _pairs(n=10, L=48, seed=28)
    pen = t_scoring.GapAffine()
    st = _starget(P, plen, T, tlen, j_scoring.GapAffine(), None, ("M", "M"),
                  s_max, k_max)
    a, b = (t_ops.wfa_bidir_meet_kernel(P, T, plen, tlen, st, pen=pen,
                                        s_max=s_max, k_max=k_max,
                                        block_pairs=bp, device="cpu")
            for bp in (4, 16))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f).numpy(),
                                      getattr(b, f).numpy(), err_msg=f)
    assert (a.score.numpy() >= 0).sum() >= 5


def test_reverse_rows():
    codes = torch.tensor([[1, 2, 3, 9], [4, 5, 6, 7], [8, 0, 0, 0]],
                         dtype=torch.int32)
    lens = torch.tensor([3, 4, 0], dtype=torch.int32)
    want = j_wf._reverse_rows(codes.numpy(), lens.numpy())
    got = t_wf._reverse_rows(codes, lens)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert got.tolist() == [[3, 2, 1, 0], [7, 6, 5, 4], [0, 0, 0, 0]]


def test_meet_launcher_refuses_cpu_tensors():
    z = torch.zeros((8, 4), dtype=torch.int32)
    lens = torch.zeros((8, 1), dtype=torch.int32)
    before = dict(t_kernel.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_kernel.wfa_meet_cuda(z, z, z, z, lens, lens, lens,
                               pen=t_scoring.Edit(), s_max=4, k_pad=128,
                               block_pairs=8)
    assert t_kernel.LAUNCHES == before


def test_meet_defaults_to_the_card(monkeypatch):
    """Without ``device`` the meet entry points run on the card, and raise
    when there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    P, plen, T, tlen, s_max, k_max = _pairs(n=2)
    st = np.full(2, 10, np.int32)
    for fn in (t_ops.wfa_bidir_meet_kernel, t_wf.wfa_bidir_meet):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(P, T, plen, tlen, st, pen=t_scoring.GapAffine(), s_max=20,
               k_max=8)
