"""The decoded encoding of a packed trace, on the CPU.

On a card the ``kernel`` backend's trace variant decodes its planes there
(``csrc/wfa_traceback.cu``) and returns ``ops`` / ``n_ops`` / ``status``
instead; ``core.cigar.decode_packed_plain`` builds the same arrays on the
host, so these tests hold that encoding, through ``traceback_result``, to
the host walk (``traceback_packed_batch``) on the same planes: every model
and heuristic, unresolved pairs and padded rows, each planted fault with
its message and coordinates.  Also the per-pair arrays' memory, the
session's ``n_tb_card`` / ``n_tb_host`` counters, and the CUDA wrapper's
refusal of CPU tensors.  No JAX: the reference holds none of these.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import cigar  # noqa: E402
from repro_torch.core import gotoh  # noqa: E402
from repro_torch.core import scoring  # noqa: E402
from repro_torch.core import wavefront as wf  # noqa: E402
from repro_torch.core.engine import (AlignmentEngine, EngineStats,  # noqa: E402
                                     pack_batch, problem_bounds)
from repro_torch.core.session import run_streamed  # noqa: E402
from repro_torch.data.reads import ReadPairSpec, generate_pairs  # noqa: E402
from repro_torch.kernels.wfa import kernel as t_kernel  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402

PENS = {"affine": scoring.GapAffine(4, 6, 2),
        "linear": scoring.GapLinear(4, 2), "edit": scoring.Edit()}
HEURS = {"exact": None, "adaptive": scoring.AdaptiveBand(10, 4),
         "zdrop": scoring.ZDrop(8)}
N_PAD = 6                        # padded rows after the pairs


def _wave(pen, heur, n=160, seed=11):
    """A packed trace of pairs at E 6% under a score bound that about a
    third of them exceed (they stay unresolved), and ``N_PAD`` padded rows
    (codes 0, lengths 0) after them, as the session pads a wave."""
    P, plen, T, tlen = generate_pairs(ReadPairSpec(
        n_pairs=n, read_len=100, edit_frac=0.06, seed=seed))
    pad = lambda a: np.concatenate([a, np.zeros((N_PAD,) + a.shape[1:],
                                                a.dtype)])
    P, plen, T, tlen = pad(P), pad(plen), pad(T), pad(tlen)
    s_max, k_max = problem_bounds(pen, plen, tlen, 0.06)
    full = wf.wfa_scores(P, T, plen, tlen, pen=pen, s_max=s_max,
                         k_max=k_max, device="cpu")
    s_max = int(np.percentile(np.asarray(full.score)[:n], 65))
    res = wf.wfa_scores_packed(P, T, plen, tlen, pen=pen, s_max=s_max,
                               k_max=k_max, heur=heur, device="cpu")
    return res, P, plen, T, tlen, k_max


def _decoded(res, pen, P, plen, T, tlen):
    """``res`` as the card returns it: the planes decoded, not carried."""
    ops, n_ops, status = cigar.decode_packed_plain(res, pen, P, T, plen,
                                                   tlen)
    return res._replace(m_bt=None, i_bt=None, d_bt=None, ops=ops,
                        n_ops=n_ops, status=status)


def _result(res, pen, P, plen, T, tlen, k_max=0):
    return cigar.traceback_result(res, pen, pattern=P, text=T, plen=plen,
                                  tlen=tlen, k_max=k_max)


@pytest.mark.parametrize("heur", list(HEURS))
@pytest.mark.parametrize("model", list(PENS))
def test_decoded_ops_equal_the_host_walk(model, heur):
    pen = PENS[model]
    res, P, plen, T, tlen, k_max = _wave(pen, HEURS[heur])
    want = cigar.traceback_packed_batch(res, pen, P, T, plen, tlen)
    dec = _decoded(res, pen, P, plen, T, tlen)
    got = _result(dec, pen, P, plen, T, tlen, k_max)
    score = np.asarray(res.score)
    assert (score < 0).any() and (score >= 0).sum() > len(score) // 2
    assert len(got) == len(want) == len(score)
    for b, (w, g) in enumerate(zip(want, got)):
        assert g.dtype == np.int8 and g.shape == w.shape, b
        np.testing.assert_array_equal(g, w, err_msg=f"pair {b}")
    # the encoding itself: -1 past each row's ops, none where unresolved
    assert dec.ops.shape == (len(score), P.shape[1] + T.shape[1])
    n = dec.n_ops
    assert (n[score < 0] == 0).all() and (n[-N_PAD:] == 0).all()
    cols = np.arange(dec.ops.shape[1])[None, :]
    assert (dec.ops[cols >= n[:, None]] == -1).all()
    assert (dec.ops[cols < n[:, None]] >= 0).all()
    assert not dec.status.any()


def _edited_pairs(n=24, L=80, seed=3):
    """Pairs with a mismatch, a deletion of 3 and an insertion of 2 at
    seeded places, and one untouched."""
    rng = np.random.default_rng(seed)
    pats, txts = [], []
    for i in range(n):
        p = "".join(rng.choice(list("ACGT"), L))
        if i == 0:
            pats.append(p)
            txts.append(p)
            continue
        x, d, s = sorted(rng.choice(np.arange(5, L - 8), 3, replace=False))
        sub = "A" if p[x] != "A" else "C"
        t = p[:x] + sub + p[x + 1:d] + p[d + 3:s] + "GT" + p[s:]
        pats.append(p)
        txts.append(t)
    P, plen = pack_batch(pats)
    T, tlen = pack_batch(txts)
    return P, plen, T, tlen


def _plant(fault, pen):
    """A wave with ``fault`` planted -> (res, P, plen, T, tlen)."""
    P, plen, T, tlen = _edited_pairs()
    s_max, k_max = problem_bounds(pen, plen, tlen, None)
    res = wf.wfa_scores_packed(P, T, plen, tlen, pen=pen, s_max=s_max,
                               k_max=k_max, device="cpu")
    planes = {f: getattr(res, f).clone() for f in ("m_bt", "i_bt", "d_bt")
              if getattr(res, f) is not None}
    T = T.copy()
    score = res.score.clone()
    for b, kind in fault:
        if kind == "m_code":     # the end cell's M code: no provenance
            planes["m_bt"][:, b] = 0
        elif kind == "gap_code":  # the gap cells under the M codes
            planes["i_bt"][:, b] = 0
            planes["d_bt"][:, b] = 0
        elif kind == "text":     # text altered after the trace
            half = T[b, :tlen[b] // 2]
            T[b, :tlen[b] // 2] = np.where(half == 65, 67, 65)
        elif kind == "origin":   # a score that walks off the origin
            score[b] -= 1
        elif kind == "short":    # the replay stops short of the end
            T[b, tlen[b] - 4:tlen[b]] = 88
            tlen = tlen.copy()
            tlen[b] -= 2
    return res._replace(score=score, **planes), P, plen, T, tlen


FAULTS = {
    "m_code": [(7, "m_code")],
    "gap_code": [(5, "gap_code")],
    "text": [(7, "text")],
    "origin": [(9, "origin")],
    "short": [(4, "short")],
    # the walk runs over every pair before any replay: pair 11's walk
    # fault is raised before pair 3's replay fault, as on the host
    "walk_first": [(3, "text"), (11, "m_code")],
    "linear": [(6, "m_code")],
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_fault_raises_as_the_host_walk(fault):
    pen = PENS["edit" if fault == "linear" else "affine"]
    res, P, plen, T, tlen = _plant(FAULTS[fault], pen)
    with pytest.raises(cigar.TracebackError) as host:
        cigar.traceback_packed_batch(res, pen, P, T, plen, tlen)
    dec = _decoded(res, pen, P, plen, T, tlen)
    assert dec.status[:, 0].any()
    with pytest.raises(cigar.TracebackError) as card:
        _result(dec, pen, P, plen, T, tlen)
    a, b = host.value, card.value
    assert str(b) == str(a)
    assert (b.pair, b.s, b.k, b.h, b.v) == (a.pair, a.s, a.k, a.h, a.v)
    assert b.pair == FAULTS[fault][-1][0]
    # the status row names one error of the host's list
    codes = dec.status[:, 0]
    assert set(codes[codes > 0]) <= set(range(1, len(cigar.TB_ERRORS)))


# Hand-made traces of one pair each (characters all "A"), for the errors
# that altered data does not reach: (model, plen, tlen, score, codes set as
# (plane, s, k, code), the status code they give).  The rest of the planes
# are 0.
SYNTH = {
    "origin": ("edit", 3, 2, 0, [], 1),
    "i_seed": ("affine", 4, 4, 2, [(0, 2, 0, 2), (1, 2, 0, 2)], 3),
    "d_seed": ("affine", 4, 4, 2, [(0, 2, 0, 3), (2, 2, 0, 2)], 4),
    "d_code": ("affine", 4, 4, 8, [(0, 8, 0, 3)], 6),
    "x_past": ("edit", 1, 2, 2, [(0, 2, 1, 1), (0, 1, 1, 2)], 8),
    "i_past": ("edit", 1, 1, 2, [(0, 2, 0, 3), (0, 1, 1, 2)], 9),
    "d_past": ("edit", 1, 1, 2, [(0, 2, 0, 2), (0, 1, -1, 3)], 10),
}
SYNTH_K, SYNTH_WORDS, SYNTH_L = 32, 2, 4


def synthetic_wave(name):
    """A wave of two pairs, a sound one (plen = tlen = 2, score 0) and
    ``SYNTH[name]``'s -> (res, P, plen, T, tlen, pen) as numpy arrays."""
    model, pl, tl, score, codes, _ = SYNTH[name]
    pen = PENS[model]
    planes = np.zeros((3 if model == "affine" else 1, SYNTH_WORDS, 2,
                       SYNTH_K), np.int64)
    for plane, s, k, c in codes:
        planes[plane, s // 16, 1, k + SYNTH_K // 2] |= c << (2 * (s % 16))
    planes = planes.astype(np.uint32).view(np.int32)
    P = np.full((2, SYNTH_L), 65, np.int32)
    T = np.full((2, SYNTH_L), 65, np.int32)
    res = wf.WFAResult(np.array([0, score], np.int32), None, None, None, 16,
                       *planes)
    return (res, P, np.array([2, pl], np.int32), T,
            np.array([2, tl], np.int32), pen)


@pytest.mark.parametrize("name", list(SYNTH))
def test_hand_made_trace_raises_as_the_host_walk(name):
    res, P, plen, T, tlen, pen = synthetic_wave(name)
    with pytest.raises(cigar.TracebackError) as host:
        cigar.traceback_packed_batch(res, pen, P, T, plen, tlen)
    dec = _decoded(res, pen, P, plen, T, tlen)
    assert dec.status[:, 0].tolist() == [0, SYNTH[name][-1]]
    assert dec.n_ops.tolist() == [2, 0] and dec.ops[0, :2].tolist() == [0, 0]
    with pytest.raises(cigar.TracebackError) as card:
        _result(dec, pen, P, plen, T, tlen)
    a, b = host.value, card.value
    assert str(b) == str(a) and b.pair == 1
    assert (b.pair, b.s, b.k, b.h, b.v) == (a.pair, a.s, a.k, a.h, a.v)


def test_faults_cover_every_reachable_code():
    """The planted faults and the hand-made traces reach every status code
    but the guard's (7), which no trace reaches: every edit lowers s by at
    least min(x, e), and none is read at s <= 0."""
    seen = set()
    for fault, plan in FAULTS.items():
        pen = PENS["edit" if fault == "linear" else "affine"]
        res, P, plen, T, tlen = _plant(plan, pen)
        st = cigar.decode_packed_plain(res, pen, P, T, plen, tlen)[2]
        seen |= set(st[:, 0][st[:, 0] > 0].tolist())
    for name in SYNTH:
        res, P, plen, T, tlen, pen = synthetic_wave(name)
        st = cigar.decode_packed_plain(res, pen, P, T, plen, tlen)[2]
        seen |= set(st[:, 0][st[:, 0] > 0].tolist())
    assert seen == set(range(1, len(cigar.TB_ERRORS))) - {7}, seen


def test_per_pair_arrays_share_no_memory_with_the_wave():
    pen = PENS["affine"]
    res, P, plen, T, tlen, k_max = _wave(pen, None)
    dec = _decoded(res, pen, P, plen, T, tlen)
    got = _result(dec, pen, P, plen, T, tlen, k_max)
    for g in got:
        assert not np.shares_memory(g, dec.ops)
        assert g.base is None or g.base is not dec.ops
    # the bytes held: the ops and no padded row
    bases = {id(g.base) for g in got if g.size}
    assert len(bases) == 1
    flat = next(g.base for g in got if g.size)
    assert flat.nbytes == int(dec.n_ops.sum())


def test_decoded_result_counts_the_planes_it_held():
    """A result decoded on the card holds its planes' bytes as the wave's
    trace memory (``peak_trace_bytes``), and its ops as what came back
    (``bytes_out``); a packed result holds and brings back its planes."""
    pen = PENS["affine"]
    res, P, plen, T, tlen, _ = _wave(pen, None, n=24)
    # as the session holds it: numpy arrays, copied back
    res = res._replace(**{f: np.asarray(getattr(res, f))
                          for f in ("score", "m_bt", "i_bt", "d_bt")})
    planes = sum(t.nbytes for t in (res.m_bt, res.i_bt, res.d_bt))
    dec = _decoded(res, pen, P, plen, T, tlen)._replace(plane_nbytes=planes)
    assert cigar.trace_held_nbytes(res) == cigar.trace_nbytes(res) == planes
    assert cigar.trace_held_nbytes(dec) == planes
    assert cigar.trace_nbytes(dec) == sum(
        t.nbytes for t in (dec.ops, dec.n_ops, dec.status))


def test_decoded_ops_refuse_boundary_states():
    pen = PENS["affine"]
    res, P, plen, T, tlen, k_max = _wave(pen, None, n=8)
    dec = _decoded(res, pen, P, plen, T, tlen)
    with pytest.raises(ValueError, match="boundary states"):
        cigar.traceback_result(dec, pen, pattern=P, text=T, plen=plen,
                               tlen=tlen, k_max=k_max, begin_state="I")


def _engine(edit_frac=0.04):
    return AlignmentEngine(scoring.GapAffine(4, 6, 2), backend="kernel",
                           edit_frac=edit_frac, chunk_pairs=64, device="cpu")


@pytest.mark.parametrize("traffic", ["clean", "overflow"])
def test_decode_counters_add_up_to_the_cigar_pairs(traffic):
    """On the CPU every CIGAR pair is decoded on the host, once, however
    many waves it took (an overflowing pair is counted at its recovery
    wave); the wave.traceback spans carry the same counts."""
    E, bound = (0.02, 0.04) if traffic == "clean" else (0.08, 0.01)
    P, plen, T, tlen = generate_pairs(ReadPairSpec(
        n_pairs=192, read_len=100, edit_frac=E, seed=5))
    obs_trace.reset()
    obs_trace.enable()
    try:
        st = run_streamed(_engine(edit_frac=bound), P, plen, T, tlen,
                          submit_pairs=64,
                          max_inflight_waves=2, output="cigar")[2]
        ev = obs_trace.events()
    finally:
        obs_trace.disable()
        obs_trace.reset()
    if traffic == "overflow":
        assert st.n_overflow > 0 and st.n_recovered == st.n_overflow
    else:
        assert st.n_overflow == 0
    assert (st.n_tb_card, st.n_tb_host) == (0, 192)
    spans = [e for e in ev if e.get("ph") == "X"
             and e["name"] == "wave.traceback"]
    assert sum(e["args"]["n_tb_host"] for e in spans) == 192
    assert sum(e["args"]["n_tb_card"] for e in spans) == 0
    assert st.t_dev_traceback == 0.0
    # a score run decodes nothing
    st = run_streamed(_engine(), P, plen, T, tlen, submit_pairs=64,
                      max_inflight_waves=2, output="score")[2]
    assert (st.n_tb_card, st.n_tb_host) == (0, 0)


@pytest.mark.parametrize("n", [300, 64])
def test_cigars_of_padded_and_split_waves_land_on_their_rows(n):
    """A wave padded past its rows (300 pairs in a wave of 384) and rows
    split over buckets of two widths: one CIGAR a pair, each re-scoring to
    its pair's cost."""
    rng = np.random.default_rng(n)
    lens = rng.choice([20, 40], size=n)
    pats = ["".join(rng.choice(list("ACGT"), L)) for L in lens]
    txts = [p[:5] + "T" + p[6:] for p in pats]
    res = _engine(edit_frac=0.1).align(pats, txts, output="cigar")
    assert len(res.cigars) == n and len(res.stats.buckets) >= 2
    P, plen = pack_batch(pats)
    T, tlen = pack_batch(txts)
    for i, ops in enumerate(res.cigars):
        cost, _, _, ok = gotoh.score_cigar(ops, P[i, :plen[i]],
                                           T[i, :tlen[i]],
                                           PENS["affine"].as_penalties())
        assert ok and cost == res.scores[i], i


def test_decode_counters_fold_through_merge():
    a = EngineStats(n_tb_card=4096, n_tb_host=3, t_dev_traceback=1e-4)
    b = EngineStats(n_tb_card=1024, n_tb_host=5, t_dev_traceback=2e-4)
    a.merge(b, count_pairs=False)
    assert (a.n_tb_card, a.n_tb_host) == (5120, 8)
    assert a.t_dev_traceback == pytest.approx(3e-4)


def test_cuda_decode_refuses_cpu_tensors():
    """The CUDA wrapper launches or raises: CPU tensors decode on the host
    (``traceback_packed_batch``), never through a fallback here."""
    pen = PENS["affine"]
    P, plen, T, tlen = _edited_pairs(n=8)
    i32 = lambda a: torch.as_tensor(a).to(torch.int32)
    P2, T2 = i32(P), i32(T)
    pl, tl = i32(plen).reshape(-1, 1), i32(tlen).reshape(-1, 1)
    score, _, *bts = t_kernel.wfa_plain(P2, T2, pl, tl, pen=pen, s_max=40,
                                        k_pad=128, block_pairs=8, trace=True)
    before = dict(t_kernel.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        t_kernel.wfa_traceback_cuda(score, bts, P2, T2, pl, tl, pen=pen,
                                    s_max=40)
    with pytest.raises(ValueError, match="planes"):
        t_kernel.wfa_traceback_cuda(score, bts[:1], P2, T2, pl, tl,
                                    pen=pen, s_max=40)
    assert t_kernel.LAUNCHES == before
