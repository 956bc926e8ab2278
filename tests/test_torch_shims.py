"""The port's deprecated shims (``WFAligner``, ``PIMBatchAligner``) and its
examples, against the JAX package's.

Both shims warn with ``DeprecationWarning`` when built, accept the
engine-era ``penalties=`` spelling with a second warning instead of
raising, and return what the JAX shims return: ``AlignResult`` with the
frozen legacy CIGAR chars, ``align_arrays``' raw backend result, and
``(scores, PIMStats)``.  The examples run with ``--device cpu``."""
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import random_pairs  # noqa: E402
from repro.core import scoring as j_scoring  # noqa: E402
from repro.core.aligner import WFAligner as JAligner  # noqa: E402
from repro.core.pim import PIMBatchAligner as JPIM  # noqa: E402
from repro.launch.mesh import make_host_mesh as j_host_mesh  # noqa: E402
from repro_torch.core import scoring as t_scoring  # noqa: E402
from repro_torch.core.aligner import WFAligner, _LEGACY_CHARS  # noqa: E402
from repro_torch.core.engine import AlignmentEngine, pack_batch  # noqa: E402
from repro_torch.core.pim import PIMBatchAligner  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_mesh  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")


def _warned(fn):
    """-> (fn's result, the categories of the warnings it raised)."""
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        out = fn()
    return out, [w.category for w in got]


def _result_view(r):
    return (np.asarray(r.scores).tolist(), r.n_steps, r.s_max, r.k_max)


@pytest.mark.parametrize("backend", ["ring", "kernel"])
@pytest.mark.parametrize("with_cigar", [False, True])
def test_wfaligner_matches_reference(backend, with_cigar):
    pats, txts = random_pairs(np.random.default_rng(5), 12, lo=10, hi=50,
                              drift=5)
    jal, jw = _warned(lambda: JAligner(backend=backend, edit_frac=0.02,
                                       with_cigar=with_cigar))
    tal, tw = _warned(lambda: WFAligner(backend=backend, edit_frac=0.02,
                                        with_cigar=with_cigar,
                                        device="cpu"))
    assert jw == tw == [DeprecationWarning]
    assert (tal.backend, tal.edit_frac, tal.with_cigar, tal._s_max,
            tal._k_max) == (jal.backend, jal.edit_frac, jal.with_cigar,
                            jal._s_max, jal._k_max)
    assert tal.pen == t_scoring.from_reference(jal.pen)
    want, got = jal.align(pats, txts), tal.align(pats, txts)
    assert _result_view(want) == _result_view(got)
    pair_w, pair_g = jal.align_pair(pats[0], txts[0]), \
        tal.align_pair(pats[0], txts[0])
    assert _result_view(pair_w) == _result_view(pair_g)
    if with_cigar:
        assert want.cigar_strings() == got.cigar_strings()
        assert all(set(c) <= set("0123456789MXID")
                   for c in got.cigar_strings())
        assert pair_w.cigar_strings() == pair_g.cigar_strings()
    else:
        assert got.cigars is None
        for r in (want, got):
            with pytest.raises(ValueError, match="with_cigar=True"):
                r.cigar_strings()


def test_legacy_cigar_chars_are_frozen():
    from repro.core.aligner import _LEGACY_CHARS as J_CHARS
    assert _LEGACY_CHARS == J_CHARS
    assert sorted(_LEGACY_CHARS.values()) == ["D", "I", "M", "X"]


def test_wfaligner_penalties_kwarg_warns_and_forwards():
    pats, txts = random_pairs(np.random.default_rng(6), 6, lo=10, hi=40)
    jal, jw = _warned(lambda: JAligner(penalties=j_scoring.Edit()))
    tal, tw = _warned(lambda: WFAligner(penalties=t_scoring.Edit(),
                                        device="cpu"))
    assert jw == tw == [DeprecationWarning, DeprecationWarning]
    assert tal.pen == t_scoring.Edit()
    assert _result_view(jal.align(pats, txts)) == \
        _result_view(tal.align(pats, txts))


@pytest.mark.parametrize("backend", ["ring", "kernel"])
def test_align_arrays_matches_reference(backend):
    pats, txts = random_pairs(np.random.default_rng(7), 8, lo=20, hi=40)
    P, plen = pack_batch(pats)
    T, tlen = pack_batch(txts)
    jal, _ = _warned(lambda: JAligner(backend=backend))
    tal, _ = _warned(lambda: WFAligner(backend=backend, device="cpu"))
    want = jal.align_arrays(P, T, plen, tlen, s_max=40, k_max=12)
    got = tal.align_arrays(P, T, plen, tlen, s_max=40, k_max=12)
    np.testing.assert_array_equal(np.asarray(want.score), got.score.numpy())
    assert int(want.n_steps) == int(got.n_steps)
    with pytest.raises(ValueError, match="patterns"):
        tal.align(pats, txts[:-1])


@pytest.mark.parametrize("mesh", [False, True], ids=["no-mesh", "mesh"])
def test_pim_batch_aligner_matches_reference(mesh):
    """``run`` and ``run_arrays`` through a blocking session in waves of
    ``chunk_pairs``: the same scores and counted phase statistics."""
    pats, txts = random_pairs(np.random.default_rng(8), 20, lo=20, hi=60,
                              drift=5)
    jal, _ = _warned(lambda: JAligner(backend="kernel", edit_frac=0.02))
    tal, _ = _warned(lambda: WFAligner(backend="kernel", edit_frac=0.02,
                                       device="cpu"))
    jpim, jw = _warned(lambda: JPIM(jal, mesh=j_host_mesh() if mesh
                                    else None, chunk_pairs=8))
    tpim, tw = _warned(lambda: PIMBatchAligner(
        tal, mesh=make_host_mesh(device="cpu") if mesh else None,
        chunk_pairs=8))
    assert jw == tw == [DeprecationWarning]
    assert tpim.n_workers == jpim.n_workers == 1
    assert (tpim.engine is tal.engine) == (jpim.engine is jal.engine) \
        == (not mesh)
    P, plen = pack_batch(pats)
    T, tlen = pack_batch(txts)
    for run in (lambda a: a.run(pats, txts),
                lambda a: a.run_arrays(P, plen, T, tlen)):
        (ws, wst), (gs, gst) = run(jpim), run(tpim)
        np.testing.assert_array_equal(ws, gs)
        assert (wst.n_pairs, wst.n_workers, wst.bytes_in, wst.bytes_out) \
            == (gst.n_pairs, gst.n_workers, gst.bytes_in, gst.bytes_out)
    want = AlignmentEngine(backend="kernel", edit_frac=0.02,
                           device="cpu").align(pats, txts).scores
    np.testing.assert_array_equal(gs, want)


def test_pim_batch_aligner_on_a_multi_shard_mesh():
    """Two cpu shards: the executor's own engine pads waves to two workers
    and keeps the scores; ``penalties=`` warns and forwards."""
    pats, txts = random_pairs(np.random.default_rng(9), 9, lo=20, hi=60,
                              drift=5)
    tal, _ = _warned(lambda: WFAligner(device="cpu"))
    mesh = make_mesh((2,), ("pairs",), devices=["cpu", "cpu"])
    pim, w = _warned(lambda: PIMBatchAligner(tal, mesh=mesh, chunk_pairs=4,
                                             penalties=t_scoring.Edit()))
    assert w == [DeprecationWarning, DeprecationWarning]
    assert pim.n_workers == 2 and pim.engine.pen == t_scoring.Edit()
    scores, st = pim.run(pats, txts)
    assert st.n_workers == 2 and st.n_pairs == 9
    want = AlignmentEngine(t_scoring.Edit(), device="cpu").align(pats, txts)
    np.testing.assert_array_equal(scores, want.scores)
    jal, _ = _warned(JAligner)
    _, jw = _warned(lambda: JPIM(jal, penalties=j_scoring.Edit()))
    assert jw == w


def _run_module(*argv, timeout=300):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run([sys.executable, "-m", *argv], env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("example,args,expect", [
    ("quickstart", [], "shardmap on 1 shard(s)"),
    ("align_reads", ["--pairs", "32", "--read-len", "60", "--chunk-pairs",
                     "16", "--backend", "kernel", "--output", "cigar",
                     "--verify", "32"], "verified 32 scores + CIGARs"),
    ("serve_lm", ["--requests", "2", "--batch", "2", "--max-new", "4"],
     "[serve] wave 0"),
], ids=["quickstart", "align_reads", "serve_lm"])
def test_example_runs_on_cpu(example, args, expect):
    out = _run_module(f"repro_torch.examples.{example}", "--device", "cpu",
                      *args)
    assert out.returncode == 0, out.stderr[-3000:]
    assert expect in out.stdout


def test_new_modules_import_neither_jax_nor_reference():
    code = (
        "import sys, warnings\n"
        "warnings.simplefilter('ignore', DeprecationWarning)\n"
        "from repro_torch.obs import analyze\n"
        "from repro_torch.launch import obs_report, mesh\n"
        "from repro_torch.core import (WFAligner, PIMBatchAligner, "
        "pair_sharding, AlignResult)\n"
        "from repro_torch.core.wavefront import wfa_scores_shardmap, "
        "wfa_trace_shardmap\n"
        "import repro_torch.examples\n"
        "m = mesh.make_mesh((2,), ('pairs',), devices=['cpu', 'cpu'])\n"
        "al = WFAligner(backend='ring', "
        "device='cpu')\n"
        "s, st = PIMBatchAligner(al, mesh=m).run(['ACGTACGTAA'], "
        "['ACGAACGTA'])\n"
        "assert s[0] >= 0 and st.n_workers == 2, (s, st)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("clean")
