"""The CUDA WFA kernels equal their plain versions on the card.

It imports no JAX, so it also runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_wfa_gpu.py

Without a card it skips.  Three kernels of ``csrc/wfa.cu`` and
``csrc/wfa_meet.cu``: the full-width score and trace kernel (with its edge
cases: a pair settled at s = 0 in a block that runs long, padded rows and a
block of padding, the recovery shape, a block of 10 kb pairs, traces of more
than 16,384 cells a block, codes outside [0, 255], heuristics that prune
holes inside a live span, characters too wide for shared memory), the meet
search and the compacting band (with its edge cases: windows narrower than
the live span and not a multiple of 32 lanes, windows that move inside a
trace word, pairs settled at s = 0 and padded rows, a block of 10 kb pairs,
characters too wide for shared memory, codes past a byte).  Inputs come from the port's seeded read generator;
every output is an integer, so each is held exactly equal to the plain
version's (the plain versions are held against the JAX package on the CPU in
``test_torch_kernel_wfa.py``, ``test_torch_kernel_meet.py`` and
``test_torch_band.py``).
"""
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import scoring as t_scoring  # noqa: E402
from repro_torch.core.engine import problem_bounds  # noqa: E402
from repro_torch.core import wavefront as t_wf  # noqa: E402
from repro_torch.data.reads import ReadPairSpec, generate_pairs  # noqa: E402
from repro_torch.kernels.wfa import kernel as t_kernel  # noqa: E402
from repro_torch.kernels.wfa import ops as t_ops  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _assert_same(want, got):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain(cuda_device):
    """Every model x heuristic x output, at pass-1 and exact-bucket bounds
    (rings in shared memory and in global scratch)."""
    P, plen, T, tlen = generate_pairs(ReadPairSpec(
        n_pairs=64, read_len=100, edit_frac=0.04, seed=1))
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
                    _assert_same(want, got)
                    key = "trace" if trace else "score"
                    assert t_kernel.LAUNCHES[key] == before[key] + 1


def _kernel_check(args, **kw):
    """CUDA kernel (full width, or the band with ``band_cap``) vs plain on
    the same inputs, one counted launch -> the kernel's outputs."""
    key = (("trace" if kw.get("trace") else "score")
           + ("_band" if kw.get("band_cap") else ""))
    before = t_kernel.LAUNCHES[key]
    got = t_kernel.wfa_cuda(*args, **kw)
    torch.cuda.synchronize()
    want = t_kernel.wfa_plain(*args, **kw)
    _assert_same(want, got)
    assert t_kernel.LAUNCHES[key] == before + 1
    return got


def _settled_rows(device):
    """13 pairs of 200 bp, pairs 0 and 9 identical (cost 0) and pair 5
    empty, padded to 16 rows, then a block of 8 rows of padding only."""
    P, plen, T, tlen = generate_pairs(ReadPairSpec(
        n_pairs=13, read_len=200, edit_frac=0.05, seed=5))
    w = max(P.shape[1], T.shape[1])
    P = np.pad(P, ((0, 0), (0, w - P.shape[1])))
    T = np.pad(T, ((0, 0), (0, w - T.shape[1])))
    for i in (0, 9):                                       # cost 0
        T[i], tlen[i] = P[i], plen[i]
    plen[5] = tlen[5] = 0                                  # empty pair
    pp, tt, pl, tl, B = t_ops._prep(P, T, plen, tlen, 8, device=device)
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 8))
    return (pad(pp), pad(tt), pad(pl), pad(tl)), B


@pytest.mark.gpu
def test_cuda_full_settled_pair_in_a_long_block(cuda_device):
    """Pairs settled at s = 0 (identical, and empty) in blocks whose other
    pairs run long: their score is 0 and the block's steps its last pair's
    exit.  Under trace a pair settled early keeps getting codes until its
    block exits, while the score variant stops its warps.  Padded rows
    settle at s = 0 too, and the block of padding only exits at s = 1."""
    args, B = _settled_rows(cuda_device)
    for pen in (t_scoring.GapAffine(), t_scoring.Edit()):
        for heur in (None, t_scoring.ZDrop(8), t_scoring.AdaptiveBand(10, 4)):
            for trace in (False, True):
                got = _kernel_check(args, pen=pen, s_max=80, k_pad=256,
                                  block_pairs=8, trace=trace, heur=heur)
                score, steps = got[0][:, 0].cpu(), got[1][:, 0].cpu()
                assert score[[0, 5, 9]].tolist() == [0, 0, 0]
                assert bool((score[B:] == 0).all())
                assert steps[16:].tolist() == [1] * 8
                assert int(steps[0]) > 1
                if trace and heur is None and pen.kind == "affine":
                    # a pair of block 0 settled at least a word before the
                    # block exits has codes in the block's last word
                    last = (int(steps[0]) - 1) // 16
                    early = [b for b in range(8) if 0 < int(score[b]) and
                             int(score[b]) // 16 < last]
                    assert early
                    assert any(bool(got[2][last, b].any()) for b in early)
                    assert not bool(got[2][:, 16:].any())


@pytest.mark.gpu
def test_cuda_full_recovery_shape(cuda_device):
    """The recovery pass's shape (s_max 416, k_pad 384: every lane of
    k_pad live, rings in shared memory, codes ORed into the planes, 1,024
    threads a block) on 100 bp pairs at E = 6%, every model and
    heuristic."""
    P, plen, T, tlen = generate_pairs(ReadPairSpec(
        n_pairs=32, read_len=100, edit_frac=0.06, seed=11))
    args = t_ops._prep(P, T, plen, tlen, 8, device=cuda_device)[:4]
    assert t_kernel.full_lanes(t_scoring.GapAffine(), 416, 384) == (0, 383)
    for pen in (t_scoring.GapAffine(), t_scoring.GapLinear(),
                t_scoring.Edit()):
        for heur in (None, t_scoring.AdaptiveBand(10, 4), t_scoring.ZDrop(8)):
            for trace in (False, True):
                _kernel_check(args, pen=pen, s_max=416, k_pad=384,
                            block_pairs=8, trace=trace, heur=heur)


@pytest.mark.gpu
def test_cuda_full_block_of_10kb_pairs(cuda_device):
    """One block of 8 pairs of 10 kb at E = 3%, exact, at the BiWFA path's
    pass-1 bounds (s_max 4,928, k_pad 4,992: rings in global scratch, the
    characters in shared memory), score and packed trace (8 x 4,992 =
    39,936 cells a block, codes ORed into the planes)."""
    from repro_torch.core.engine import AlignmentEngine, _fit_width
    P, plen, T, tlen = generate_pairs(ReadPairSpec(
        n_pairs=8, read_len=10000, edit_frac=0.03, seed=0))
    pen = t_scoring.GapAffine(4, 6, 2)
    eng = AlignmentEngine(pen, backend="kernel", edit_frac=0.03,
                          device=cuda_device)
    s_max, k_max = eng._bounds_for_bucket(16384, plen, tlen, False)
    k_pad = t_ops._round_up(2 * k_max + 1, t_ops.LANE)
    assert (s_max, k_pad) == (4928, 4992)
    w = max(P.shape[1], T.shape[1])
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
    args = (to(_fit_width(P, w)), to(_fit_width(T, w)), to(plen[:, None]),
            to(tlen[:, None]))
    for trace in (False, True):
        got = _kernel_check(args, pen=pen, s_max=s_max, k_pad=k_pad,
                          block_pairs=8, trace=trace)
        assert bool((got[0] > 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("block_pairs", [8, 40])
def test_cuda_full_trace_past_16384_cells(cuda_device, block_pairs):
    """Packed traces of block_pairs * k_pad well past 16,384 cells, which a
    body keeping 16 trace words a thread in registers cannot hold: short
    pairs at k_pad 4,096, every model; 40 pairs a block, more than the 32
    warps of a CTA."""
    P, plen, T, tlen = generate_pairs(ReadPairSpec(
        n_pairs=80, read_len=150, edit_frac=0.06, seed=3))
    args = t_ops._prep(P, T, plen, tlen, block_pairs,
                       device=cuda_device)[:4]
    assert block_pairs * 4096 > 16384
    for pen in (t_scoring.GapAffine(), t_scoring.GapLinear(),
                t_scoring.Edit()):
        for heur in (None, t_scoring.AdaptiveBand(10, 4)):
            _kernel_check(args, pen=pen, s_max=3000, k_pad=4096,
                        block_pairs=block_pairs, trace=True, heur=heur)


@pytest.mark.gpu
@pytest.mark.parametrize("bad", [-1, 300, 70000])
def test_cuda_full_codes_outside_a_byte(cuda_device, bad):
    """A code outside [0, 255] gives exact results: the block that holds it
    compares int32 characters (one pair gets the code in both sequences,
    another a code 256 apart from its partner's, which bytes would call
    equal); no launch is refused."""
    P, plen, T, tlen = generate_pairs(ReadPairSpec(
        n_pairs=16, read_len=80, edit_frac=0.05, seed=2))
    pp, tt, pl, tl, _ = t_ops._prep(P, T, plen, tlen, 8, device=cuda_device)
    pp, tt = pp.clone(), tt.clone()
    pp[3, 1] = tt[3, 1] = bad
    pp[10, 5], tt[10, 5] = bad + 256, bad
    for pen in (t_scoring.GapAffine(), t_scoring.Edit()):
        for trace in (False, True):
            _kernel_check((pp, tt, pl, tl), pen=pen, s_max=60, k_pad=128,
                        block_pairs=8, trace=trace)


@pytest.mark.gpu
def test_cuda_full_pruning_holes(cuda_device):
    """ZDrop(8) and AdaptiveBand(10, 4) prune lanes inside a row's live
    span (tests/test_torch_full_lanes.py shows such holes on these pairs in
    the JAX package's histories): the next steps read those lanes as NEG."""
    P, plen, T, tlen = generate_pairs(ReadPairSpec(
        n_pairs=16, read_len=120, edit_frac=0.1, seed=27))
    args = t_ops._prep(P, T, plen, tlen, 8, device=cuda_device)[:4]
    s_max, k_max = problem_bounds(t_scoring.GapAffine(), plen, tlen, None)
    k_pad = t_ops._round_up(2 * k_max + 1, t_ops.LANE)
    for pen in (t_scoring.GapAffine(), t_scoring.GapLinear(),
                t_scoring.Edit()):
        for heur in (t_scoring.ZDrop(8), t_scoring.AdaptiveBand(10, 4)):
            for trace in (False, True):
                _kernel_check(args, pen=pen, s_max=s_max, k_pad=k_pad,
                            block_pairs=8, trace=trace, heur=heur)


@pytest.mark.gpu
def test_cuda_full_wide_rows(cuda_device):
    """Short pairs in rows of 30,000 columns: the byte characters of a
    block pass the shared memory a CTA may hold and go to global scratch
    (the rings stay in shared memory); wfa_full_shape says where each
    array lives."""
    from repro_torch.kernels.wfa import build
    P, plen, T, tlen = generate_pairs(ReadPairSpec(
        n_pairs=16, read_len=100, edit_frac=0.05, seed=3))
    pp, tt, pl, tl, B = t_ops._prep(P, T, plen, tlen, 8, device=cuda_device)
    W = 30000
    cols = lambda t: torch.nn.functional.pad(t, (0, W - t.shape[1]))
    args = (cols(pp), cols(tt), pl, tl)
    pen = t_scoring.GapAffine()
    lanes = t_kernel.full_lanes(pen, 60, 256)
    shape = (ctypes.c_int * 5)()
    assert build.load().wfa_full_shape(16, 8, 256, *lanes, pen.window,
                                       pen.e, 1, 1, 0, W, W, shape) == 0
    threads, smem, per_sm, rings, seq = list(shape)
    assert (threads, rings, seq) == (256, 1, 0) and per_sm >= 1
    for heur in (t_scoring.AdaptiveBand(10, 4), None):
        for trace in (False, True):
            _kernel_check(args, pen=pen, s_max=60, k_pad=256, block_pairs=8,
                        trace=trace, heur=heur)


@pytest.mark.gpu
def test_cuda_band_kernel_matches_plain(cuda_device):
    """Every model x heuristic x output on the band (128, 256 and 512
    lanes), ragged pairs of 400 bp."""
    P, plen, T, tlen = generate_pairs(ReadPairSpec(
        n_pairs=32, read_len=400, edit_frac=0.05, seed=1))
    args = t_ops._prep(P, T, plen, tlen, 8, device=cuda_device)[:4]
    for pen in (t_scoring.GapAffine(), t_scoring.GapLinear(),
                t_scoring.Edit()):
        for heur, cap in ((t_scoring.AdaptiveBand(), 128),
                          (t_scoring.ZDrop(), 256), (None, 512)):
            for trace in (False, True):
                kw = dict(pen=pen, s_max=900, k_pad=1024, block_pairs=8,
                          trace=trace, heur=heur, band_cap=cap)
                key = "trace_band" if trace else "score_band"
                before = t_kernel.LAUNCHES[key]
                got = t_kernel.wfa_cuda(*args, **kw)
                torch.cuda.synchronize()
                want = t_kernel.wfa_plain(*args, **kw)
                _assert_same(want, got)
                assert t_kernel.LAUNCHES[key] == before + 1


def _ragged(seed=9, n=10, drift=30):
    """Pairs whose target diagonals sit far from k = 0 (tlen != plen); every
    other pair shares a prefix, the rest are unrelated.  Exact worst-case
    bounds, so the window, not s_max, limits the fronts."""
    rng = np.random.default_rng(seed)
    plen = rng.integers(20, 90, size=n).astype(np.int32)
    tlen = np.clip(plen + rng.integers(-drift, drift + 1, size=n), 4,
                   None).astype(np.int32)
    P = rng.integers(65, 69, size=(n, int(plen.max()))).astype(np.int32)
    T = rng.integers(65, 69, size=(n, int(tlen.max()))).astype(np.int32)
    for i in range(0, n, 2):
        m = min(plen[i], tlen[i])
        T[i, :m] = P[i, :m]
    s_max, k_max = problem_bounds(t_scoring.GapAffine(), plen, tlen, None)
    return P, plen, T, tlen, s_max, t_ops._round_up(2 * k_max + 1,
                                                     t_ops.LANE)


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [16, 40])
def test_cuda_band_truncating_window(cuda_device, cap):
    """Per-block windows narrower than the blocks' live span, and not a
    multiple of 32 lanes: some pairs end unresolved (-1), the same ones as
    in the plain version (tests/test_torch_band.py holds that against the
    JAX package on the CPU)."""
    P, plen, T, tlen, s_max, k_pad = _ragged()
    args = t_ops._prep(P, T, plen, tlen, 4, device=cuda_device)[:4]
    for pen in (t_scoring.GapAffine(), t_scoring.Edit()):
        for heur in (t_scoring.AdaptiveBand(4, 10), t_scoring.ZDrop(12)):
            for trace in (False, True):
                got = _kernel_check(args, pen=pen, s_max=s_max, k_pad=k_pad,
                                  block_pairs=4, trace=trace, heur=heur,
                                  band_cap=cap)
    if cap == 16:
        assert bool((got[0][:10] == -1).any())


def _word_spans(plane, block_pairs):
    """Per (word, block): the lanes between the lowest and the highest
    nonzero code word of the block, 0 where it has none."""
    nz = (plane != 0).view(plane.shape[0], -1, block_pairs,
                           plane.shape[2]).any(dim=2)
    lanes = torch.arange(plane.shape[2], device=plane.device)
    hi = torch.where(nz, lanes, -1).amax(dim=2)
    lo = torch.where(nz, lanes, plane.shape[2]).amin(dim=2)
    return (hi - lo + 1).clamp(min=0)


@pytest.mark.gpu
@pytest.mark.parametrize("stage", ["design", "one-window"])
def test_cuda_band_window_moves_inside_a_word(cuda_device, stage):
    """The window moves inside a 16-step trace word (some word's codes
    span more lanes than the band): the kernel stages each word on chip by
    absolute lane, so those words must come out whole.  "one-window"
    builds wfa.cu with a stage only as wide as the 16-lane band, so every
    move inside a word writes the staged part to the planes early and the
    rest of the word ORs onto it."""
    P, plen, T, tlen, s_max, k_pad = _ragged()
    args = t_ops._prep(P, T, plen, tlen, 4, device=cuda_device)[:4]
    cap = 16
    lib = None
    if stage == "one-window":
        from repro_torch.kernels import variants
        from repro_torch.kernels.wfa import build
        lib = variants.edited_library(
            build.LIB, "stage_one_window", "wfa.cu",
            [("  while (l.SW < 2 * KCP) l.SW *= 2;",
              "  while (l.SW < kc) l.SW *= 2;")])
        lib.load()
    for pen in (t_scoring.GapAffine(), t_scoring.GapLinear(),
                t_scoring.Edit()):
        for heur in (t_scoring.AdaptiveBand(4, 10), None):
            kw = dict(pen=pen, s_max=s_max, k_pad=k_pad, block_pairs=4,
                      trace=True, heur=heur, band_cap=cap)
            if lib is None:
                got = _kernel_check(args, **kw)
            else:
                with variants.loaded_from(build, lib):
                    got = _kernel_check(args, **kw)
            assert int(_word_spans(got[2], 4).max()) > cap


@pytest.mark.gpu
def test_cuda_band_settled_and_padded_rows(cuda_device):
    """Pairs settled at s = 0 (identical and empty), a block's padded rows
    and a block of padding only: every block still steps in lockstep until
    its last pair settles, and the padded block exits at s = 1."""
    P, plen, T, tlen = generate_pairs(ReadPairSpec(
        n_pairs=13, read_len=200, edit_frac=0.05, seed=5))
    w = max(P.shape[1], T.shape[1])
    P = np.pad(P, ((0, 0), (0, w - P.shape[1])))
    T = np.pad(T, ((0, 0), (0, w - T.shape[1])))
    for i in (0, 9):                                       # cost 0
        T[i], tlen[i] = P[i], plen[i]
    plen[5] = tlen[5] = 0                                  # empty pair
    pp, tt, pl, tl, B = t_ops._prep(P, T, plen, tlen, 8, device=cuda_device)
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 8))
    args = (pad(pp), pad(tt), pad(pl), pad(tl))      # 24 rows: block 2 empty
    for pen in (t_scoring.GapAffine(), t_scoring.Edit()):
        for heur, cap in ((t_scoring.AdaptiveBand(), 128),
                          (t_scoring.ZDrop(8), 40), (None, 96)):
            for trace in (False, True):
                got = _kernel_check(args, pen=pen, s_max=300, k_pad=256,
                                  block_pairs=8, trace=trace, heur=heur,
                                  band_cap=cap)
                score, steps = got[0][:, 0].cpu(), got[1][:, 0].cpu()
                assert score[[0, 5, 9]].tolist() == [0, 0, 0]
                assert bool((score[B:] == 0).all())
                assert steps[16:].tolist() == [1] * 8
                assert int(steps[0]) > 1


@pytest.mark.gpu
def test_cuda_band_block_of_10kb_pairs(cuda_device):
    """One block of 8 pairs of 10 kb at E = 3% on the banded path's bounds
    (GapAffine(4,6,2), AdaptiveBand(), pass 1 of the 16,384 bucket: 128 of
    4,992 lanes, the shape of block 0 of chip_smoke.py's band phase)."""
    from repro_torch.core.engine import AlignmentEngine, _fit_width
    P, plen, T, tlen = generate_pairs(ReadPairSpec(
        n_pairs=8, read_len=10000, edit_frac=0.03, seed=0))
    pen, heur = t_scoring.GapAffine(4, 6, 2), t_scoring.AdaptiveBand()
    eng = AlignmentEngine(pen, backend="kernel", edit_frac=0.03,
                          device=cuda_device)
    s_max, k_max = eng._bounds_for_bucket(16384, plen, tlen, False)
    k_pad = t_ops._round_up(2 * k_max + 1, t_ops.LANE)
    cap = t_ops._band_lanes(heur.band_cap(2 * k_max + 1), k_pad)
    assert cap == 128 and k_pad == 4992
    w = max(P.shape[1], T.shape[1])
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
    args = (to(_fit_width(P, w)), to(_fit_width(T, w)), to(plen[:, None]),
            to(tlen[:, None]))
    for trace in (False, True):
        got = _kernel_check(args, pen=pen, s_max=s_max, k_pad=k_pad,
                          block_pairs=8, trace=trace, heur=heur,
                          band_cap=cap)
        assert bool((got[0] > 0).all())


@pytest.mark.gpu
def test_cuda_band_wide_rows(cuda_device):
    """Short pairs in rows of 30,000 columns: the byte characters of a
    block (8 x 2 x 30,008 bytes) pass the shared memory a CTA may hold, so
    the launch puts them in global scratch, after the rings (which always
    live there)."""
    from repro_torch.kernels.wfa import build
    P, plen, T, tlen = generate_pairs(ReadPairSpec(
        n_pairs=16, read_len=100, edit_frac=0.05, seed=3))
    pp, tt, pl, tl, B = t_ops._prep(P, T, plen, tlen, 8, device=cuda_device)
    W = 30000
    cols = lambda t: torch.nn.functional.pad(t, (0, W - t.shape[1]))
    args = (cols(pp), cols(tt), pl, tl)
    window = t_scoring.GapAffine().window
    n = lambda L, trace: build.load().wfa_band_scratch_ints(
        16, 8, 128, window, 1, trace, L, L)
    rings = 2 * 3 * window * 8 * 128                # ints, both blocks
    for trace in (0, 1):
        assert n(128, trace) == rings
        assert n(W, trace) == rings + 2 * 8 * 2 * (W + 8) // 4
    for heur in (t_scoring.AdaptiveBand(), None):
        for trace in (False, True):
            _kernel_check(args, pen=t_scoring.GapAffine(), s_max=200,
                        k_pad=256, block_pairs=8, trace=trace, heur=heur,
                        band_cap=128)


@pytest.mark.gpu
def test_cuda_band_kernel_refuses_codes_past_a_byte(cuda_device):
    """The band kernel compares characters as bytes, so a code outside [0,
    255] raises before any launch."""
    P, plen, T, tlen = generate_pairs(ReadPairSpec(
        n_pairs=8, read_len=50, edit_frac=0.04, seed=2))
    pp, tt, pl, tl, _ = t_ops._prep(P, T, plen, tlen, 8, device=cuda_device)
    for bad in (256, -1):
        pp2 = pp.clone()
        pp2[3, 1] = bad
        before = t_kernel.LAUNCHES["score_band"]
        with pytest.raises(ValueError, match="as bytes"):
            t_kernel.wfa_cuda(pp2, tt, pl, tl, pen=t_scoring.GapAffine(),
                              s_max=40, k_pad=256, block_pairs=8,
                              heur=t_scoring.AdaptiveBand(), band_cap=128)
        assert t_kernel.LAUNCHES["score_band"] == before


# -- the meet search ---------------------------------------------------------


def _meet_args(pp, tt, pl, tl, st):
    """The seven inputs of the meet kernel from padded rows and costs."""
    return (pp, tt, t_wf._reverse_rows(pp, pl[:, 0]),
            t_wf._reverse_rows(tt, tl[:, 0]), pl, tl,
            st.to(torch.int32).reshape(-1, 1))


def _costs(pp, tt, pl, tl, pen, heur, states, s_max, k_max):
    """Each pair's cost under the boundary states (the packed ring solver)."""
    return t_wf.wfa_scores_packed(
        pp, tt, pl[:, 0], tl[:, 0], pen=pen, s_max=s_max, k_max=k_max,
        heur=heur, begin_state=states[0], end_state=states[1],
        device=pp.device).score


def _meet_s_max(pen, st):
    """The BiWFA recursion's score cap for a meet wave of costs ``st``."""
    o = pen.o if pen.kind == "affine" else 0
    top = int(st.max()) if st.numel() else 0
    return t_ops._round_up((max(top, 0) + o) // 2
                           + t_wf.meet_window(pen) + 2, 32)


def _meet_check(args, **kw):
    """Kernel vs plain on the same inputs, one counted launch -> outputs."""
    before = t_kernel.LAUNCHES["meet"]
    got = t_kernel.wfa_meet_cuda(*args, **kw)
    torch.cuda.synchronize()
    want = t_kernel.wfa_meet_plain(*args, **kw)
    _assert_same(want, got)
    assert t_kernel.LAUNCHES["meet"] == before + 1
    return got


@pytest.mark.gpu
def test_cuda_meet_kernel_matches_plain(cuda_device):
    """Models x heuristics x boundary states, all eight outputs."""
    P, plen, T, tlen = generate_pairs(ReadPairSpec(
        n_pairs=64, read_len=100, edit_frac=0.04, seed=1))
    pp, tt, pl, tl, _ = t_ops._prep(P, T, plen, tlen, 8, device=cuda_device)
    for pen in (t_scoring.GapAffine(), t_scoring.GapLinear(),
                t_scoring.Edit()):
        states_list = ([("M", "M"), ("I", "D"), ("D", "M")]
                       if pen.kind == "affine" else [("M", "M")])
        for heur in (None, t_scoring.AdaptiveBand(10, 4),
                     t_scoring.ZDrop(8)):
            for states in states_list:
                st = _costs(pp, tt, pl, tl, pen, heur, states, 160, 60)
                _meet_check(_meet_args(pp, tt, pl, tl, st), pen=pen,
                            s_max=64, k_pad=128, block_pairs=8, heur=heur,
                            begin_state=states[0], end_state=states[1])


def _mixed_pairs():
    """24 pairs, each block holding all three cost classes: 60 bp at
    E = 1%, 100 bp at E = 4% and 300 bp at E = 10%."""
    parts = [generate_pairs(ReadPairSpec(n_pairs=8, read_len=L, edit_frac=E,
                                         seed=seed))
             for L, E, seed in ((60, 0.01, 3), (100, 0.04, 4),
                                (300, 0.10, 5))]
    n = sum(p[0].shape[0] for p in parts)
    Lp = max(p[0].shape[1] for p in parts)
    Lt = max(p[2].shape[1] for p in parts)
    P = np.zeros((n, Lp), np.int32)
    T = np.zeros((n, Lt), np.int32)
    plen, tlen = np.zeros(n, np.int32), np.zeros(n, np.int32)
    for c, (p, pl, t, tl) in enumerate(parts):
        rows = np.arange(c, n, len(parts))      # interleave the classes
        P[rows, :p.shape[1]], T[rows, :t.shape[1]] = p, t
        plen[rows], tlen[rows] = pl, tl
    return P, plen, T, tlen


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["1kb-E5", "ragged-batch", "mixed-cost",
                                  "unmet", "wide-rows"])
def test_cuda_meet_kernel_edge_cases(cuda_device, case):
    """Where a per-pair meet kernel could part from the block-wide plain
    version: 1 kb pairs at E = 5% (a wide band, a long meet window), a
    batch of 13 pairs in blocks of 8 (padded rows and a block of padding
    only), pairs of very different cost in one block (per-pair exits), an
    s_max that leaves pairs unmet, and short pairs in rows too wide for
    shared memory (the kernel's characters then live in global scratch)."""
    pen = t_scoring.GapAffine()
    heurs = [None]
    if case == "1kb-E5":
        P, plen, T, tlen = generate_pairs(ReadPairSpec(
            n_pairs=16, read_len=1000, edit_frac=0.05, seed=7))
        k_max, s_cap = 200, 800
        heurs = [None, t_scoring.AdaptiveBand(10, 4), t_scoring.ZDrop(8)]
    elif case == "mixed-cost":
        P, plen, T, tlen = _mixed_pairs()
        k_max, s_cap = 120, 600
    else:
        P, plen, T, tlen = generate_pairs(ReadPairSpec(
            n_pairs=13 if case == "ragged-batch" else 32, read_len=100,
            edit_frac=0.08, seed=11))
        k_max, s_cap = 60, 240
    pp, tt, pl, tl, B = t_ops._prep(P, T, plen, tlen, 8, device=cuda_device)
    if case == "ragged-batch":                  # 16 rows -> 24: block 2 empty
        pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 8))
        pp, tt, pl, tl = pad(pp), pad(tt), pad(pl), pad(tl)
    k_pad = t_ops._round_up(2 * k_max + 1, t_ops.LANE)
    if case == "wide-rows":
        # four rows of 60,000 bytes pass the 227 KB of shared memory a CTA
        # may hold, so the launch puts them in global scratch: the scratch
        # it asks for grows by one pair's bytes (2 x 2 x (60,000 + 4))
        W = 60000
        cols = lambda t: torch.nn.functional.pad(t, (0, W - t.shape[1]))
        pp, tt = cols(pp), cols(tt)
        from repro_torch.kernels.wfa import build
        n = lambda L: build.load().wfa_meet_scratch_ints(
            1, L, L, k_pad, t_wf.meet_window(pen), pen.window, pen.e + 1, 1)
        assert n(W) - n(128) == (2 * 2 * (W + 4)) // 4
    for heur in heurs:
        st = _costs(pp, tt, pl, tl, pen, heur, ("M", "M"), s_cap, k_max)
        assert bool((st[:B] >= 0).all()), "a pair's cost is past s_cap"
        s_max = _meet_s_max(pen, st)
        if case == "unmet":                     # about half the pairs fit
            s_max = int(st.median()) // 2 + 2
        got = _meet_check(_meet_args(pp, tt, pl, tl, st), pen=pen,
                          s_max=s_max, k_pad=k_pad, block_pairs=8, heur=heur)
        met = got[0][:B, 0] >= 0
        steps = got[1][:, 0].cpu()
        if case == "unmet":
            assert 0 < int(met.sum()) < B
            assert s_max + 1 in steps.tolist()
        elif heur is None:                      # a cost of 0 has no split
            assert bool((met == (st[:B] > 0)).all())
        else:
            assert int(met.sum()) >= B // 2
        if case == "ragged-batch":
            assert steps[16:].tolist() == [1] * 8
            assert bool((got[0][B:, 0] == -1).all())


@pytest.mark.gpu
def test_cuda_meet_kernel_refuses_codes_past_a_byte(cuda_device):
    """The kernel compares characters as bytes, so a code outside [0, 255]
    raises before any launch."""
    P, plen, T, tlen = generate_pairs(ReadPairSpec(
        n_pairs=8, read_len=50, edit_frac=0.04, seed=2))
    pp, tt, pl, tl, _ = t_ops._prep(P, T, plen, tlen, 8, device=cuda_device)
    st = torch.full((8,), 12, dtype=torch.int32, device=cuda_device)
    for bad in (256, -1):
        tt2 = tt.clone()
        tt2[3, 1] = bad
        before = t_kernel.LAUNCHES["meet"]
        with pytest.raises(ValueError, match="as bytes"):
            t_kernel.wfa_meet_cuda(*_meet_args(pp, tt2, pl, tl, st),
                                   pen=t_scoring.GapAffine(), s_max=40,
                                   k_pad=128, block_pairs=8)
        assert t_kernel.LAUNCHES["meet"] == before
