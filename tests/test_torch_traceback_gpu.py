"""The CUDA traceback kernel equals its plain version on the card.

It imports no JAX, so it runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -s -m gpu tests/test_torch_traceback_gpu.py

Without a card it skips.  ``csrc/wfa_traceback.cu`` decodes the trace
kernel's planes where they lie; ``core.cigar.decode_packed_plain`` (the
host's own walk and replay, held against ``traceback_packed_batch`` on the
CPU in ``test_torch_cigar_decode.py``) builds the same ops, counts and
status rows from a copy of the planes.  Each case holds the three outputs
bit for bit: the 100 bp wave of 4,096 pairs, the recovery shape (k_pad
384), 1 kb at E 5% and 64 x 10 kb, linear and edit models, AdaptiveBand,
the compacting band, pairs settled at s = 0, rows padded to the block, and
planes with planted bad codes and hand-made traces that reach every error.
Then a streamed ``output="cigar"`` session on the card: every CIGAR
re-scored against Gotoh, every pair decoded on the card.  With ``-s`` it
prints the traceback kernel's device time (the events its launch records
right around it) beside the trace kernel's and the plain version's, and
the bytes the host no longer copies.
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import cigar  # noqa: E402
from repro_torch.core import scoring  # noqa: E402
from repro_torch.core import wavefront as wf  # noqa: E402
from repro_torch.core.engine import AlignmentEngine, problem_bounds  # noqa: E402
from repro_torch.core.gotoh import score_cigar  # noqa: E402
from repro_torch.core.session import run_streamed  # noqa: E402
from repro_torch.data.reads import ReadPairSpec, generate_pairs  # noqa: E402
from repro_torch.device import kernel_marks  # noqa: E402
from repro_torch.kernels.wfa import kernel as t_kernel  # noqa: E402
from repro_torch.kernels.wfa import ops as t_ops  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from test_torch_cigar_decode import SYNTH, synthetic_wave  # noqa: E402

AFFINE = scoring.GapAffine(4, 6, 2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _decode_check(args, score, bts, pen, s_max):
    """The CUDA decode of ``bts`` against ``decode_packed_plain`` of a copy
    -> its status rows (numpy)."""
    pattern, text, pl, tl = args
    before = t_kernel.LAUNCHES["traceback"]
    ops, n_ops, status = t_kernel.wfa_traceback_cuda(
        score, bts, pattern, text, pl, tl, pen=pen, s_max=s_max)
    torch.cuda.synchronize()
    assert t_kernel.LAUNCHES["traceback"] == before + 1
    res = wf.WFAResult(score.cpu(), None, None, None, s_max,
                       *(b.cpu() for b in bts))
    want = cigar.decode_packed_plain(res, pen, pattern.cpu().numpy(),
                                     text.cpu().numpy(), pl.cpu().numpy(),
                                     tl.cpu().numpy())
    got = (ops.cpu().numpy(), n_ops.cpu().numpy()[:, 0],
           status.cpu().numpy())
    for name, w, g in zip(("ops", "n_ops", "status"), want, got):
        assert w.dtype == g.dtype and w.shape == g.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    return got[2]


def _trace(device, P, plen, T, tlen, pen, s_max, k_max, heur=None,
           band_cap=None):
    """The trace kernel on rows padded to blocks of 8 -> (args, score,
    planes, pairs before the padding)."""
    args = t_ops._prep(P, T, plen, tlen, 8, device=device)
    k_pad = t_ops._round_up(2 * int(k_max) + 1, t_ops.LANE)
    score, _, *bts = t_kernel.wfa_cuda(
        *args[:4], pen=pen, s_max=int(s_max), k_pad=k_pad, block_pairs=8,
        trace=True, heur=heur,
        band_cap=t_ops._band_lanes(band_cap, k_pad))
    return args[:4], score, bts, args[4]


def _pairs(n, L, E, seed, settle=()):
    P, plen, T, tlen = generate_pairs(ReadPairSpec(
        n_pairs=n, read_len=L, edit_frac=E, seed=seed))
    w = max(P.shape[1], T.shape[1])
    P = np.pad(P, ((0, 0), (0, w - P.shape[1])))
    T = np.pad(T, ((0, 0), (0, w - T.shape[1])))
    for i in settle:                                   # cost 0
        T[i], tlen[i] = P[i], plen[i]
    return P, plen, T, tlen


# case -> (pairs, length, E, model, heuristic, band_cap, bounds' E or
# (s_max, k_max)); pairs not a multiple of 8 leave padded rows
CASES = {
    "wave-100bp": (4096, 100, 0.02, "affine", None, None, 0.02),
    "recovery": (4096, 100, 0.06, "affine", None, None, (416, 191)),
    "1kb": (250, 1000, 0.05, "affine", None, None, 0.05),
    "10kb": (64, 10_000, 0.03, "affine", None, None, 0.03),
    "linear": (1001, 100, 0.04, "linear", None, None, 0.02),
    "edit": (1001, 100, 0.04, "edit", None, None, 0.02),
    "adaptive": (1001, 100, 0.06, "affine", "adaptive", None, 0.06),
    "edit-adaptive": (1001, 100, 0.06, "edit", "adaptive", None, 0.06),
    "band": (64, 1000, 0.05, "affine", "adaptive", 128, 0.05),
}
PENS = {"affine": AFFINE, "linear": scoring.GapLinear(4, 2),
        "edit": scoring.Edit()}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_cuda_decode_equals_plain(cuda_device, case):
    n, L, E, model, heur, band, bounds = CASES[case]
    pen = PENS[model]
    heur = scoring.AdaptiveBand(10, 4) if heur else None
    P, plen, T, tlen = _pairs(n, L, E, seed=21, settle=(0, 5, n - 1))
    if isinstance(bounds, tuple):
        s_max, k_max = bounds
    else:
        s_max, k_max = problem_bounds(pen, plen, tlen, bounds)
    args, score, bts, B = _trace(cuda_device, P, plen, T, tlen, pen, s_max,
                                 k_max, heur=heur, band_cap=band)
    status = _decode_check(args, score, bts, pen, int(s_max))
    assert not status.any()
    sc = score[:, 0].cpu()
    assert sc[[0, 5, n - 1]].tolist() == [0, 0, 0]
    assert int((sc >= 0).sum()) > n // 2
    if case == "wave-100bp":
        assert args[0].shape[0] == B == 4096
    elif n % 8:
        assert args[0].shape[0] > B              # padded rows decoded too


@pytest.mark.gpu
def test_cuda_decode_unresolved_pairs(cuda_device):
    """A bound of three mismatches, below most pairs' costs at E 6%: the
    pairs past it get no ops."""
    P, plen, T, tlen = _pairs(1001, 100, 0.06, seed=4)
    s_max, k_max = 12, 16
    args, score, bts, _ = _trace(cuda_device, P, plen, T, tlen, AFFINE,
                                 s_max, k_max)
    assert bool((score < 0).any())
    _decode_check(args, score, bts, AFFINE, int(s_max))


@pytest.mark.gpu
def test_cuda_decode_planted_bad_codes(cuda_device):
    """Codes cleared and text altered after the trace: the status rows
    name the host walk's errors at its coordinates, pair by pair."""
    P, plen, T, tlen = _pairs(256, 100, 0.04, seed=9)
    s_max, k_max = problem_bounds(AFFINE, plen, tlen, 0.04)
    args, score, bts, _ = _trace(cuda_device, P, plen, T, tlen, AFFINE,
                                 s_max, k_max)
    bts = [b.clone() for b in bts]
    text = args[1].clone()
    sc = score[:, 0].cpu().numpy()
    edited = [b for b in range(256) if sc[b] > 0]
    for b in edited[0:40:4]:
        bts[0][:, b] = 0                           # the M codes
    for b in edited[1:40:4]:
        bts[1][:, b] = 0                           # the gap codes
        bts[2][:, b] = 0
    for b in edited[2:40:4]:                       # text after the trace
        text[b, :20] = torch.where(text[b, :20] == 65, 67, 65)
    for b in edited[3:40:4]:                       # one word flipped
        bts[0][0, b] ^= -1
    status = _decode_check((args[0], text, args[2], args[3]), score, bts,
                           AFFINE, int(s_max))
    codes = status[:, 0]
    assert (codes[edited[0:40:4]] > 0).all()
    seen = set(codes[codes > 0].tolist())
    assert 2 in seen and seen & {5, 6}, seen


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(SYNTH))
def test_cuda_decode_hand_made_traces(cuda_device, name):
    """The traces of ``test_torch_cigar_decode.SYNTH``, which reach every
    error the data does not, give the host's status codes on the card."""
    res, P, plen, T, tlen, pen = synthetic_wave(name)
    on = lambda a: torch.as_tensor(a).to(cuda_device)
    args = (on(P), on(T), on(plen).reshape(-1, 1), on(tlen).reshape(-1, 1))
    bts = [on(getattr(res, f)).contiguous() for f in ("m_bt", "i_bt", "d_bt")
           if getattr(res, f) is not None]
    status = _decode_check(args, on(res.score).reshape(-1, 1), bts, pen, 16)
    assert status[:, 0].tolist() == [0, SYNTH[name][-1]]


def _kernel_ms(fn, kind, reps=20):
    """Median device ms of the ``kind`` kernel that ``fn`` launches, by the
    events the launch records right around it (``device.kernel_marks``)."""
    fn()
    with kernel_marks(kind) as marks:
        for _ in range(reps):
            fn()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in marks]))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["wave-100bp", "10kb"])
def test_cuda_decode_time(cuda_device, case):
    """The traceback kernel's time beside the trace kernel's and the plain
    version's, and the bytes a wave copies to the host either way."""
    n, L, E, model, _, _, bounds = CASES[case]
    P, plen, T, tlen = _pairs(n, L, E, seed=21)
    s_max, k_max = problem_bounds(AFFINE, plen, tlen, bounds)
    args, score, bts, _ = _trace(cuda_device, P, plen, T, tlen, AFFINE,
                                 s_max, k_max)
    k_pad = bts[0].shape[-1]
    tb = _kernel_ms(lambda: t_kernel.wfa_traceback_cuda(
        score, bts, *args, pen=AFFINE, s_max=int(s_max)), "traceback")
    tr = _kernel_ms(lambda: t_kernel.wfa_cuda(
        *args, pen=AFFINE, s_max=int(s_max), k_pad=k_pad, block_pairs=8,
        trace=True), "kernel")
    res = wf.WFAResult(score.cpu(), None, None, None, int(s_max),
                       *(b.cpu() for b in bts))
    host = [a.cpu().numpy() for a in args]
    t0 = time.perf_counter()
    cigar.decode_packed_plain(res, AFFINE, *host)
    plain_ms = 1e3 * (time.perf_counter() - t0)
    planes = sum(b.nbytes for b in bts)
    ops = args[0].shape[0] * (args[0].shape[1] + args[1].shape[1]) \
        + 5 * 4 * args[0].shape[0]
    print(f"\n[traceback {case}] {torch.cuda.get_device_name(0)}: "
          f"{n} pairs, traceback kernel {tb:.4f} ms "
          f"({1e6 * tb / n:.2f} ns a pair), trace kernel {tr:.4f} ms, "
          f"plain decode {plain_ms:.1f} ms; bytes to the host: planes "
          f"{planes:,}, ops {ops:,}")
    assert tb > 0 and planes > ops


@pytest.mark.gpu
@pytest.mark.parametrize("E, bound", [(0.02, 0.02), (0.08, 0.01)])
def test_streamed_cigar_session_decodes_on_the_card(cuda_device, E, bound):
    """16,384 pairs in chunks of 4,096, 4 outstanding, as the cigar cell
    sends them (pairs at E 8% under a bound for E 1% overflow and come back
    through the recovery pass): every CIGAR re-scores to its pair's cost
    against Gotoh, every pair is decoded on the card, once, no wave is
    walked on the host, and the traceback kernel's events are read."""
    P, plen, T, tlen = generate_pairs(ReadPairSpec(
        n_pairs=16384, read_len=100, edit_frac=E, seed=17))
    eng = AlignmentEngine(AFFINE, backend="kernel", edit_frac=bound,
                          chunk_pairs=4096, backend_opts={"block_pairs": 8},
                          device=cuda_device)
    before = t_kernel.LAUNCHES["traceback"]
    obs_trace.reset()
    obs_trace.enable()
    try:
        scores, cigars, st, _ = run_streamed(
            eng, P, plen, T, tlen, submit_pairs=4096, max_inflight_waves=4,
            output="cigar")
        names = {e["name"] for e in obs_trace.events()}
    finally:
        obs_trace.disable()
        obs_trace.reset()
    if E > bound:
        assert st.n_overflow > 0 and st.n_recovered == st.n_overflow
    else:
        assert st.n_overflow == 0
    assert (st.n_tb_card, st.n_tb_host) == (16384, 0)
    assert t_kernel.LAUNCHES["traceback"] - before == st.n_waves
    assert st.t_dev_traceback > 0
    # the trace memory a wave held is its planes (three int32 [NW, B,
    # k_pad] planes of 4,096 rows or more), not the ops that came back
    assert st.peak_trace_bytes >= 3 * 4 * 4096 * 128
    assert st.peak_trace_bytes > st.bytes_out / st.n_waves
    assert "wave.traceback" in names
    assert not names & {"traceback.walk", "traceback.replay"}
    pen = AFFINE.as_penalties()
    for i, ops in enumerate(cigars):
        cost, _, _, ok = score_cigar(ops, P[i, :plen[i]], T[i, :tlen[i]],
                                     pen)
        assert ok and cost == scores[i] >= 0, i
