"""The port's engine, session, registry and launcher.

``AlignmentEngine(device="cpu", backend="kernel")`` is held against the JAX
engine on the same seeded batch: scores, CIGAR strings and the bucket /
overflow / recovery / row counters.  The session keeps the failure
contract, the package never imports JAX or the JAX package, and the engine
refuses to run without a card unless the CPU is asked for."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import random_pairs  # noqa: E402
from repro.core import scoring as j_scoring  # noqa: E402
from repro.core.engine import AlignmentEngine as JEngine  # noqa: E402
from repro_torch.core import backends as t_backends  # noqa: E402
from repro_torch.core import scoring as t_scoring  # noqa: E402
from repro_torch.core import wavefront as t_wf  # noqa: E402
from repro_torch.core.engine import AlignmentEngine  # noqa: E402
from repro_torch.launch import align as t_align  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")


def _stats_view(st):
    return ([(b.lmax, b.s_max, b.k_max, b.n_pairs, b.recovery)
             for b in st.buckets],
            st.n_overflow, st.n_recovered, st.rows_real, st.rows_padded,
            st.cache_hits, st.cache_misses, st.n_traces, st.bytes_in)


@pytest.mark.parametrize("pen,heur", [
    (j_scoring.GapAffine(), None),
    (j_scoring.Edit(), j_scoring.ZDrop(8)),
], ids=["affine-exact", "edit-zdrop"])
def test_engine_kernel_backend_matches_reference(pen, heur):
    """16 pairs over two length buckets; the 2% bound overflows some of
    them into the exact-bound recovery pass."""
    pats, txts = random_pairs(np.random.default_rng(3), 16, lo=20, hi=60,
                              drift=6)
    kw = dict(backend="kernel", edit_frac=0.02, chunk_pairs=8)
    jeng = JEngine(pen, heuristic=heur, **kw)
    teng = AlignmentEngine(t_scoring.from_reference(pen),
                           heuristic=t_scoring.from_reference(heur),
                           device="cpu", **kw)
    for output in ("score", "cigar"):
        want = jeng.align(pats, txts, output=output)
        got = teng.align(pats, txts, output=output)
        np.testing.assert_array_equal(want.scores, got.scores)
        assert _stats_view(want.stats) == _stats_view(got.stats)
        assert want.stats.n_overflow > 0
        assert (want.n_steps, want.s_max, want.k_max, want.approximate) == \
            (got.n_steps, got.s_max, got.k_max, got.approximate)
        if output == "cigar":
            assert want.cigar_strings() == got.cigar_strings()
            assert want.cigar_strings("classic") == \
                got.cigar_strings("classic")


def test_streamed_session_matches_sync():
    pats, txts = random_pairs(np.random.default_rng(8), 12, lo=10, hi=50,
                              drift=5)
    eng = AlignmentEngine(backend="kernel", edit_frac=0.02, chunk_pairs=4,
                          device="cpu")
    sync = eng.align(pats, txts, output="cigar")
    with eng.stream(max_inflight_waves=2) as sess:
        tickets = [sess.submit(pats[i:i + 4], txts[i:i + 4], output="cigar")
                   for i in range(0, 12, 4)]
        seen = [t.index for t in sess.as_completed(timeout=60)]
        assert sorted(seen) == [0, 1, 2]
        assert sess.poll() == []
    scores = np.concatenate([t.result().scores for t in tickets])
    np.testing.assert_array_equal(scores, sync.scores)
    cig = sum((t.result().cigar_strings() for t in tickets), [])
    assert cig == sync.cigar_strings()
    assert eng.cache_traces() == eng.cache_size


def test_registry_and_backend_opts():
    assert t_backends.available_backends() == ["kernel", "ref", "ring",
                                               "shardmap"]
    for name in ("kernel", "ref", "ring", "shardmap"):
        spec = t_backends.get_backend(name)
        assert spec.supports_cigar and spec.accepts_heuristic("cigar")
        assert spec.models == ("affine", "linear")
        assert spec.needs_mesh == (name == "shardmap")
    assert t_backends.get_backend("ring").accepts_states()
    assert t_backends.get_backend("ref").accepts_states()
    # the CUDA trace kernel takes no boundary states (stateful BiWFA leaves
    # go to ring); the kernel backend ships the meet kernel
    kspec = t_backends.get_backend("kernel")
    assert not kspec.accepts_states() and kspec.meet_variant is not None
    assert t_backends.get_backend("ring").meet_variant is None
    AlignmentEngine(backend="kernel", device="cpu",
                    backend_opts={"block_pairs": 4, "gather": "index",
                                  "ext_stride": 2})
    with pytest.raises(ValueError, match="backend_opts"):
        AlignmentEngine(backend="kernel", device="cpu",
                        backend_opts={"nope": 1})
    with pytest.raises(KeyError, match="unknown alignment backend"):
        AlignmentEngine(backend="nope", device="cpu")
    with pytest.raises(ValueError, match="needs a device mesh"):
        AlignmentEngine(backend="shardmap", device="cpu")


def test_block_pairs_option_keeps_scores():
    pats, txts = random_pairs(np.random.default_rng(2), 10, lo=20, hi=40)
    base = AlignmentEngine(backend="ring", edit_frac=0.05, device="cpu")
    alt = AlignmentEngine(backend="kernel", edit_frac=0.05, device="cpu",
                          backend_opts={"block_pairs": 3})
    np.testing.assert_array_equal(base.align(pats, txts).scores,
                                  alt.align(pats, txts).scores)


def test_no_card_means_no_engine(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AlignmentEngine()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AlignmentEngine(backend="kernel", device="cuda")
    assert AlignmentEngine(device="cpu").device.type == "cpu"


def test_bidir_not_ported():
    """The bidir trace variant is accepted per engine and per call, and an
    unknown one is refused (the BiWFA path itself: test_torch_biwfa)."""
    eng = AlignmentEngine(device="cpu", trace_variant="bidir")
    assert eng.align(["ACGT"], ["ACGA"], output="cigar").cigar_strings() \
        == ["3=1X"]
    eng = AlignmentEngine(device="cpu", edit_frac=0.05)
    res = eng.align(["ACGT"], ["ACGA"], output="cigar", trace_variant="bidir")
    assert res.scores[0] == 4 and res.cigar_strings() == ["3=1X"]
    with pytest.raises(ValueError, match="trace variant"):
        eng.align(["ACGT"], ["ACGA"], output="cigar", trace_variant="full")
    # score output ignores the trace variant, as in the reference
    assert eng.align(["ACGT"], ["ACGA"], trace_variant="bidir").scores[0] == 4


def test_backend_failure_at_dispatch_poisons_session():
    @t_backends.register_backend("boom")
    def _boom(pattern, text, plen, tlen, *, pen, s_max, k_max):
        raise RuntimeError("injected backend failure")

    try:
        pats, txts = random_pairs(np.random.default_rng(0), 4, lo=20, hi=40)
        sess = AlignmentEngine(backend="boom", edit_frac=0.05,
                               device="cpu").stream(max_inflight_waves=2)
        with pytest.raises(RuntimeError, match="injected"):
            sess.submit(pats, txts)
        with pytest.raises(RuntimeError, match="session failed"):
            sess.drain()
        with pytest.raises(RuntimeError, match="session failed"):
            sess.submit(pats, txts)
    finally:
        t_backends.unregister_backend("boom")


class _Poisoned:
    """A device result whose copy to the host fails (an asynchronous
    fault that surfaces only when the wave is gathered)."""

    def numpy(self):
        raise RuntimeError("injected device fault")


def test_backend_failure_at_gather_poisons_session():
    @t_backends.register_backend("late-boom")
    def _late(pattern, text, plen, tlen, *, pen, s_max, k_max):
        res = t_wf.wfa_scores(pattern, text, plen, tlen, pen=pen,
                              s_max=s_max, k_max=k_max,
                              device=pattern.device)
        return res._replace(score=_Poisoned())

    try:
        pats, txts = random_pairs(np.random.default_rng(0), 4, lo=20, hi=40)
        sess = AlignmentEngine(backend="late-boom", edit_frac=0.05,
                               device="cpu").stream(max_inflight_waves=2)
        sess.submit(pats, txts)      # dispatch succeeds; the fault is later
        with pytest.raises(Exception):
            sess.drain()
        with pytest.raises(RuntimeError, match="session failed"):
            sess.submit(pats, txts)
    finally:
        t_backends.unregister_backend("late-boom")


def test_launcher_runs_on_cpu(capsys):
    summary = {}
    rc = t_align.main(["--device", "cpu", "--backend", "kernel", "--pairs",
                       "24", "--read-len", "40", "--chunk-pairs", "8",
                       "--mode", "both", "--output", "cigar", "--verify",
                       "24"], summary)
    assert rc == 0
    assert summary["verified"] == 24 and len(summary["cigars"]) == 24
    assert {"sync", "stream"} <= set(summary)
    assert "verified 24 scores + CIGARs" in capsys.readouterr().out


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import sys\n"
        "import repro_torch\n"
        "from repro_torch.core import AlignmentEngine\n"
        "from repro_torch.launch import align\n"
        "from repro_torch.kernels.wfa import build, kernel, ops, ref\n"
        "from repro_torch import obs, configs, data, biwfa\n"
        "r = AlignmentEngine(backend='kernel', edit_frac=0.05, "
        "device='cpu').align(['ACGTACGTAA'], ['ACGAACGTA'], output='cigar')\n"
        "assert r.scores[0] >= 0, r.scores\n"
        "b = AlignmentEngine(backend='kernel', trace_budget=8, "
        "device='cpu').align(['ACGTACGTAAGGATTACA' * 4], "
        "['ACGAACGTAGGATTTACA' * 4], output='cigar', trace_variant='bidir')\n"
        "assert b.scores[0] > 0, b.scores\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("clean")
