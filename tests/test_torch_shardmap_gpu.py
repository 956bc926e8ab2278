"""The ``shardmap`` backend and the trace analysis on the card.

It imports no JAX, so it also runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_shardmap_gpu.py

Without a card it skips.  ``shardmap`` on one shard of the card and on two
shards that share it (one host thread and one CUDA stream each) gives the
``kernel`` backend's scores and CIGARs, and its per-shard results equal
the ring solver on each slice; a traced ``kernel`` run reads back through
the port's ``analyze`` with one ``wave.kernel`` span a wave.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.core import wavefront as wf  # noqa: E402
from repro_torch.core.engine import AlignmentEngine  # noqa: E402
from repro_torch.core.gotoh import score_cigar  # noqa: E402
from repro_torch.core.penalties import DEFAULT  # noqa: E402
from repro_torch.core.scoring import GapAffine  # noqa: E402
from repro_torch.core.session import run_streamed  # noqa: E402
from repro_torch.data.reads import ReadPairSpec, generate_pairs  # noqa: E402
from repro_torch.kernels.wfa import kernel as K  # noqa: E402
from repro_torch.launch import obs_report  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_mesh  # noqa: E402
from repro_torch.obs import analyze  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _pairs(n, seed, E=0.04):
    return generate_pairs(ReadPairSpec(n_pairs=n, read_len=100,
                                       edit_frac=E, seed=seed))


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [1, 2])
def test_shardmap_equals_kernel_on_the_card(cuda_device, shards):
    P, plen, T, tlen = _pairs(3001, 1, E=0.06)
    mesh = (make_host_mesh() if shards == 1 else
            make_mesh((2,), ("pairs",), devices=[cuda_device] * 2))
    sm = AlignmentEngine(backend="shardmap", edit_frac=0.02, mesh=mesh,
                         chunk_pairs=1024)
    assert sm.n_workers == shards and sm.device.type == "cuda"
    kern = AlignmentEngine(backend="kernel", edit_frac=0.02,
                           device=cuda_device, chunk_pairs=1024)
    for output in ("score", "cigar"):
        got = sm.align_packed(P, plen, T, tlen, output=output)
        want = kern.align_packed(P, plen, T, tlen, output=output)
        np.testing.assert_array_equal(got.scores, want.scores)
        assert got.stats.rows_padded % shards == 0
        assert got.stats.n_overflow == want.stats.n_overflow > 0
        if output == "cigar":
            pen = DEFAULT
            for i in range(0, 3001, 97):
                cost, _, _, ok = score_cigar(got.cigars[i], P[i, :plen[i]],
                                             T[i, :tlen[i]], pen)
                assert ok and cost == got.scores[i]
    streamed, _, st, _ = run_streamed(sm, P, plen, T, tlen,
                                      submit_pairs=700)
    np.testing.assert_array_equal(streamed, want.scores)
    assert st.t_kernel > 0


@pytest.mark.gpu
def test_two_shards_on_one_card_equal_the_ring_per_slice(cuda_device):
    P, plen, T, tlen = _pairs(512, 2, E=0.08)
    mesh = make_mesh((2,), ("pairs",), devices=[cuda_device] * 2)
    kw = dict(pen=GapAffine(4, 6, 2), s_max=40, k_max=16)
    dev = [torch.as_tensor(a, device=cuda_device) for a in (P, T, plen, tlen)]
    shards = wf.wfa_shards(*dev, mesh=mesh, **kw)
    trace = wf.wfa_trace_shardmap(*dev, mesh=mesh, **kw)
    for i, res in enumerate(shards):
        sl = slice(i * 256, (i + 1) * 256)
        want = wf.wfa_scores(P[sl], T[sl], plen[sl], tlen[sl],
                             device=cuda_device, **kw)
        want_bt = wf.wfa_scores_packed(P[sl], T[sl], plen[sl], tlen[sl],
                                       device=cuda_device, **kw)
        assert torch.equal(res.score, want.score)
        assert res.n_steps == want.n_steps
        for plane, w in zip(trace[1:], want_bt[5:]):
            assert torch.equal(plane[:, sl], w)
        assert torch.equal(trace[0][sl], want_bt.score)


@pytest.mark.gpu
def test_traced_kernel_run_reads_back(cuda_device, tmp_path):
    P, plen, T, tlen = _pairs(8192, 3, E=0.02)
    eng = AlignmentEngine(backend="kernel", edit_frac=0.02,
                          device=cuda_device, chunk_pairs=1024)
    run_streamed(eng, P, plen, T, tlen, submit_pairs=1024)     # warm
    path = tmp_path / "t.json"
    K.reset_launches()
    obs_trace.reset()
    try:
        with obs.capture_trace(str(path)):
            scores, _, st, _ = run_streamed(eng, P, plen, T, tlen,
                                            submit_pairs=1024)
    finally:
        obs_trace.reset()
    assert K.LAUNCHES["score"] >= st.n_waves > 0
    tr = analyze.Trace.from_file(str(path))
    pt = analyze.phase_accounting(tr)
    assert pt.get("kernel").count == st.n_waves
    assert pt.get("scatter").count == st.n_waves
    rep = analyze.pipeline_analysis(tr)
    assert rep.busy_us > 0 and rep.mean_inflight > 0
    assert obs_report.main([str(path), "--assert-phases"]) == 0
    json.loads(path.read_text())


@pytest.mark.gpu
def test_blocking_spans_hold_the_kernel_event_times(cuda_device, tmp_path):
    """A blocking run times each kernel by CUDA events into its wave's
    ``wave.scatter`` span, which waits for it on the host clock."""
    P, plen, T, tlen = _pairs(8192, 4, E=0.02)
    eng = AlignmentEngine(backend="kernel", edit_frac=0.02,
                          device=cuda_device, chunk_pairs=1024)
    eng.align_packed(P, plen, T, tlen)                          # warm
    path = tmp_path / "t.json"
    obs_trace.reset()
    try:
        with obs.capture_trace(str(path)):
            st = eng.align_packed(P, plen, T, tlen).stats
    finally:
        obs_trace.reset()
    spans = [s for s in analyze.Trace.from_file(str(path)).spans
             if s.name == "wave.scatter"]
    assert len(spans) >= 8
    for s in spans:
        assert 0 < s.args["t_kernel"] * 1e6 <= s.dur + 2
    assert sum(s.args["t_kernel"] for s in spans) == pytest.approx(
        st.t_kernel, rel=1e-9)
