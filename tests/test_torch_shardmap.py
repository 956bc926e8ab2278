"""The port's ``shardmap`` backend and device mesh against the JAX package.

Under ``shard_map`` each shard runs the ring solver on its own contiguous
slice of the pair axis to its own termination, so the reference for shard
*i* of *n* is the JAX ``wfa_scores`` / ``wfa_scores_packed`` on rows
``[i*B/n, (i+1)*B/n)``: scores, steps and packed words must equal it bit
for bit.  The engine on a one-device mesh is held against the JAX engine
in this process; a four-shard engine against a JAX engine on four CPU
devices in a subprocess (JAX here sees one)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import random_pairs  # noqa: E402
from repro.core import scoring as j_scoring  # noqa: E402
from repro.core import wavefront as j_wf  # noqa: E402
from repro.core.engine import AlignmentEngine as JEngine  # noqa: E402
from repro.data.reads import ReadPairSpec, generate_pairs  # noqa: E402
from repro.launch.mesh import make_host_mesh as j_host_mesh  # noqa: E402
from repro_torch.core import scoring as t_scoring  # noqa: E402
from repro_torch.core import wavefront as t_wf  # noqa: E402
from repro_torch.core.engine import (AlignmentEngine,  # noqa: E402
                                     pair_sharding)
from repro_torch.launch import align as t_align  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
MODELS = [j_scoring.GapAffine(), j_scoring.GapLinear(), j_scoring.Edit()]
HEURS = [None, j_scoring.AdaptiveBand(10, 4), j_scoring.ZDrop(8)]


def _cpu_mesh(n, shape=None, axes=("pairs",)):
    return t_mesh.make_mesh(shape or (n,), axes, devices=["cpu"] * n)


def _pairs(n, E, seed):
    P, plen, T, tlen = generate_pairs(ReadPairSpec(
        n_pairs=n, read_len=48, edit_frac=E, seed=seed))
    fit = lambda a: np.pad(a, ((0, 0), (0, 64 - a.shape[1])))
    return fit(P), plen, fit(T), tlen


def _batch(n_shards):
    """8 pairs of 48 bp per shard, every slice the same shape (one JAX
    compile per solver): shard 0 holds 4 pairs at E = 2% and 4 at 25%
    (which overflow), shard 1 8 at 2%, shards 2-3 8 at 10% and 25%; so
    shards stop at different steps."""
    groups = [[_pairs(4, 0.02, 5), _pairs(4, 0.25, 6)], [_pairs(8, 0.02, 7)],
              [_pairs(8, 0.1, 8)], [_pairs(8, 0.25, 9)]][:n_shards]
    parts = [p for g in groups for p in g]
    return tuple(np.concatenate([p[j] for p in parts]) for j in range(4))


@pytest.mark.parametrize("heur", HEURS, ids=str)
@pytest.mark.parametrize("pen", MODELS, ids=lambda p: type(p).__name__)
def test_shards_match_reference_per_slice(pen, heur):
    s_max, k_max = pen.score_bound(48, 0.06), 16
    for band_cap, n in [(b, n) for b in (None, 12) for n in (1, 2, 4)]:
        P, plen, T, tlen = _batch(n)
        kw = dict(s_max=s_max, k_max=k_max, band_cap=band_cap)
        tkw = dict(kw, pen=t_scoring.from_reference(pen),
                   heur=t_scoring.from_reference(heur))
        mesh = _cpu_mesh(n)
        got = t_wf.wfa_shards(P, T, plen, tlen, mesh=mesh, **tkw)
        got_bt = t_wf.wfa_shards(P, T, plen, tlen, mesh=mesh, packed=True,
                                 **tkw)
        score = t_wf.wfa_scores_shardmap(P, T, plen, tlen, mesh=mesh, **tkw)
        tr = t_wf.wfa_trace_shardmap(P, T, plen, tlen, mesh=mesh, **tkw)
        steps = []
        for i in range(n):
            sl = slice(i * 8, (i + 1) * 8)
            want = j_wf.wfa_scores(P[sl], T[sl], plen[sl], tlen[sl], pen=pen,
                                   heur=heur, **kw)
            want_bt = j_wf.wfa_scores_packed(P[sl], T[sl], plen[sl],
                                             tlen[sl], pen=pen, heur=heur,
                                             **kw)
            for w, g in ((want, got[i]), (want_bt, got_bt[i])):
                np.testing.assert_array_equal(np.asarray(w.score),
                                              g.score.numpy())
                assert int(w.n_steps) == g.n_steps
            np.testing.assert_array_equal(np.asarray(want.score),
                                          score[sl].numpy())
            np.testing.assert_array_equal(np.asarray(want_bt.score),
                                          tr[0][sl].numpy())
            for f, plane in zip(("m_bt", "i_bt", "d_bt"), tr[1:]):
                w = getattr(want_bt, f)
                assert (w is None) == (plane is None), f
                if w is not None:
                    assert plane.shape == (w.shape[0], 8 * n, w.shape[2])
                    np.testing.assert_array_equal(np.asarray(w),
                                                  plane[:, sl].numpy())
            steps.append(got[i].n_steps)
        if n > 1 and heur is None and band_cap is None:
            # the clean shard stops early: per-shard termination
            assert steps[1] < steps[0], steps


def test_shard_devices_follow_partition_order():
    devs = [torch.device("cuda", i) for i in range(6)]
    mesh = t_mesh.Mesh(tuple(devs), ("data", "model"), (3, 2))
    assert t_wf.shard_devices(mesh) == devs
    assert pair_sharding(None) is None and pair_sharding(mesh) == devs
    with pytest.raises(ValueError, match="split evenly"):
        t_wf.wfa_scores_shardmap(*[np.zeros((5, 8), np.int32)] * 2,
                                 np.zeros(5, np.int32),
                                 np.zeros(5, np.int32),
                                 pen=t_scoring.GapAffine(), s_max=4,
                                 k_max=2, mesh=_cpu_mesh(2))


def test_mesh_constructors():
    m = t_mesh.make_host_mesh(device="cpu")
    assert (m.size, dict(m.shape), m.axis_names) == \
        (1, {"data": 1, "model": 1}, ("data", "model"))
    assert t_mesh.mesh_devices(m) == 1 and t_mesh.data_shards(m) == 1
    m4 = t_mesh.make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    assert t_mesh.mesh_devices(m4) == 4 and t_mesh.data_shards(m4) == 2
    pod = t_mesh.make_mesh((2, 3, 1), ("pod", "data", "model"),
                           devices=["cpu"] * 6)
    assert t_mesh.data_shards(pod) == 6
    with pytest.raises(ValueError, match="needs 4 devices"):
        t_mesh.make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="axis names"):
        t_mesh.make_mesh((2,), ("data", "model"), devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="model-parallel"):
        t_mesh.make_host_mesh(model_parallel=2, device="cpu")


def test_mesh_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_mesh.make_host_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_mesh.make_mesh((1,), ("pairs",))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_mesh.make_mesh((1,), ("pairs",), devices=["cuda:0"])


def test_shardmap_needs_a_device_mesh():
    with pytest.raises(ValueError, match="needs a device mesh"):
        AlignmentEngine(backend="shardmap", device="cpu")
    with pytest.raises(ValueError, match="needs a device mesh"):
        JEngine(backend="shardmap")
    eng = AlignmentEngine(backend="shardmap", mesh=_cpu_mesh(2))
    assert (eng.device.type, eng.n_workers) == ("cpu", 2)
    # a backend that needs no mesh runs on the mesh's first device
    ring = AlignmentEngine(backend="ring", mesh=_cpu_mesh(3))
    assert (ring.device.type, ring.n_workers) == ("cpu", 3)


def _stats_view(st):
    return ([(b.lmax, b.s_max, b.k_max, b.n_pairs, b.recovery)
             for b in st.buckets], st.n_workers, st.n_overflow,
            st.n_recovered, st.rows_real, st.rows_padded, st.cache_hits,
            st.cache_misses, st.bytes_in, st.bytes_out)


@pytest.mark.parametrize("pen,heur,opts", [
    (j_scoring.GapAffine(), None, {}),
    (j_scoring.Edit(), j_scoring.ZDrop(8), {}),
    (j_scoring.GapLinear(), j_scoring.AdaptiveBand(10, 4),
     {"band_cap": "auto"}),
], ids=["affine", "edit-zdrop", "linear-adaptive-band"])
def test_engine_matches_reference_on_one_device(pen, heur, opts):
    """Several length buckets, with the recovery pass where a pair
    overflows; score and CIGAR output."""
    pats, txts = random_pairs(np.random.default_rng(4), 18, lo=20, hi=70,
                              drift=6)
    kw = dict(backend="shardmap", edit_frac=0.02, chunk_pairs=8,
              backend_opts=opts)
    jeng = JEngine(pen, heuristic=heur, mesh=j_host_mesh(), **kw)
    teng = AlignmentEngine(t_scoring.from_reference(pen),
                           heuristic=t_scoring.from_reference(heur),
                           mesh=t_mesh.make_host_mesh(device="cpu"), **kw)
    for output in ("score", "cigar"):
        want = jeng.align(pats, txts, output=output)
        got = teng.align(pats, txts, output=output)
        np.testing.assert_array_equal(want.scores, got.scores)
        assert _stats_view(want.stats) == _stats_view(got.stats)
        assert (want.n_steps, want.s_max, want.k_max, want.approximate) == \
            (got.n_steps, got.s_max, got.k_max, got.approximate)
        if output == "cigar":
            assert want.cigar_strings() == got.cigar_strings()


_JAX_FOUR = r"""
import json, sys
import numpy as np
import jax
from repro.core.engine import AlignmentEngine
from repro.launch.mesh import make_host_mesh
assert jax.device_count() == 4, jax.devices()
case = json.loads(sys.argv[1])
eng = AlignmentEngine(backend="shardmap", edit_frac=0.02, chunk_pairs=8,
                      mesh=make_host_mesh())
out = {}
for output in ("score", "cigar"):
    r = eng.align(case["pats"], case["txts"], output=output)
    st = r.stats
    out[output] = {
        "scores": r.scores.tolist(),
        "cigars": r.cigar_strings() if output == "cigar" else None,
        "stats": [[[b.lmax, b.s_max, b.k_max, b.n_pairs, b.recovery]
                   for b in st.buckets], st.n_workers, st.n_overflow,
                  st.n_recovered, st.rows_real, st.rows_padded,
                  st.cache_hits, st.cache_misses, st.bytes_in,
                  st.bytes_out],
        "steps": [r.n_steps, r.s_max, r.k_max]}
np.savez(sys.argv[2], result=json.dumps(out))
"""


def test_engine_four_shards_matches_four_device_reference(tmp_path):
    """Rows pad to a multiple of four shards and every wave splits four
    ways: the same counters, scores and CIGARs as the JAX engine on a
    four-device mesh (a subprocess: this one's JAX sees one device)."""
    pats, txts = random_pairs(np.random.default_rng(9), 21, lo=20, hi=70,
                              drift=6)
    path = tmp_path / "jax_four.npz"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run(
        [sys.executable, "-c", _JAX_FOUR,
         json.dumps({"pats": pats, "txts": txts}), str(path)],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    want = json.loads(str(np.load(path)["result"]))
    mesh = t_mesh.make_mesh((4, 1), ("data", "model"), devices=["cpu"] * 4)
    eng = AlignmentEngine(backend="shardmap", edit_frac=0.02, chunk_pairs=8,
                          mesh=mesh)
    for output in ("score", "cigar"):
        r = eng.align(pats, txts, output=output)
        st = r.stats
        got = [[[b.lmax, b.s_max, b.k_max, b.n_pairs, b.recovery]
                for b in st.buckets], st.n_workers, st.n_overflow,
               st.n_recovered, st.rows_real, st.rows_padded, st.cache_hits,
               st.cache_misses, st.bytes_in, st.bytes_out]
        w = want[output]
        assert r.scores.tolist() == w["scores"]
        assert got == w["stats"]
        assert [r.n_steps, r.s_max, r.k_max] == w["steps"]
        assert st.n_workers == 4 and st.rows_padded % 4 == 0
        assert st.n_overflow > 0
        if output == "cigar":
            assert r.cigar_strings() == w["cigars"]


@pytest.mark.parametrize("output", ["score", "cigar"])
def test_launcher_shardmap_on_cpu(output, capsys):
    summary = {}
    rc = t_align.main(["--device", "cpu", "--backend", "shardmap",
                       "--pairs", "24", "--read-len", "40", "--chunk-pairs",
                       "8", "--mode", "both", "--output", output,
                       "--verify", "24"], summary)
    assert rc == 0 and summary["verified"] == 24
    out = capsys.readouterr().out
    assert "backend=shardmap" in out and "workers=1" in out
    ring = {}
    assert t_align.main(["--device", "cpu", "--backend", "ring", "--pairs",
                         "24", "--read-len", "40", "--chunk-pairs", "8",
                         "--mode", "sync"], ring) == 0
    np.testing.assert_array_equal(summary["scores"], ring["scores"])
