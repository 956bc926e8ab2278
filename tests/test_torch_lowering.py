"""The port's dry-run machinery (``launch/lowering.py``, ``launch/dryrun.py``)
at test scale: a 4 x 4 fake mesh traces the JAX test's four smoke cells and
the aligner's two variants (``tests/test_dryrun_lowering.py``'s checks), the
per-rank count of one sharded product, the quadratic depth fit, and the
argument bytes per device against the JAX package's shard shapes.

``repro.launch.dryrun`` and ``repro.launch.hillclimb`` set XLA_FLAGS when
imported, so this file reads the JAX cells through ``repro.launch.lowering``
on an ``AbstractMesh`` (no devices) and sums their shard bytes itself.
"""
import dataclasses

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.launch import lowering as JL  # noqa: E402
from repro.models.common import SHAPES as J_SHAPES  # noqa: E402
from repro.models.common import ShapeSpec as JShape  # noqa: E402
from repro_torch.configs import get_config as t_get  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.configs import wfa_paper  # noqa: E402
from repro_torch.distributed.sharding import P, Sharding  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import lowering as TL  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_production_mesh  # noqa: E402
from repro_torch.models.common import SHAPES, ShapeSpec  # noqa: E402
from repro_torch.models.registry import get_model_fns  # noqa: E402
from repro_torch.tree import key_paths  # noqa: E402

SMOKE = [("qwen3-0.6b", ("t", 64, 8, "train")),
         ("deepseek-v2-lite-16b", ("t", 64, 8, "train")),
         ("mamba2-780m", ("d", 128, 8, "decode")),
         ("whisper-base", ("p", 64, 8, "prefill"))]


def _mesh4():
    return Mesh((torch.device("meta"),) * 16, ("data", "model"), (4, 4))


def _jax_arg_bytes(cell):
    total = 0
    for arg, sh in zip(cell.args, cell.in_shardings):
        leaves = jax.tree.leaves(arg)
        shs = jax.tree.leaves(sh, is_leaf=lambda x: hasattr(x, "shard_shape"))
        for s, h in zip(leaves, shs):
            total += int(np.prod(h.shard_shape(s.shape))) * s.dtype.itemsize
    return total


@pytest.fixture(scope="module")
def smoke_records():
    mesh = _mesh4()
    out = {}
    for arch, spec in SMOKE:
        cell = TL.build_lm_cell(t_smoke(arch), ShapeSpec(*spec), mesh,
                                mode="roofline")
        out[arch] = cell, DR.measure(cell, mesh)
    return out


@pytest.mark.parametrize("arch,spec", SMOKE)
def test_smoke_cells_trace(smoke_records, arch, spec):
    cell, rec = smoke_records[arch]
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["peak_bytes_per_device"] >= rec["traced_arg_bytes_per_device"]
    jcell = JL.build_lm_cell(j_smoke(arch), JShape(*spec),
                             AbstractMesh((4, 4), ("data", "model")),
                             mode="roofline")
    assert rec["analytic_arg_bytes_per_device"] == _jax_arg_bytes(jcell)
    if arch == "qwen3-0.6b":
        assert rec["collectives"]["total"] > 0      # model-parallel cells talk


@pytest.mark.parametrize("arch", ["qwen3-32b", "mamba2-780m", "zamba2-7b",
                                  "deepseek-v2-lite-16b", "whisper-base",
                                  "qwen2-vl-7b"])
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_production_arg_bytes_equal_jax(arch, shape):
    """Per-device argument bytes on 16 x 16 from the shard shapes, the
    ZeRO state of a train cell included, equal the JAX package's, and so
    do those of the per-layer layout the trace places (mamba2's small
    leaves, ZeRO-sharded on the stack dim, move that shard onto a dim of
    each layer)."""
    tcell = TL.build_lm_cell(t_get(arch), SHAPES[shape],
                             make_production_mesh())
    jcell = JL.build_lm_cell(j_get(arch), J_SHAPES[shape],
                             AbstractMesh((16, 16), ("data", "model")))
    assert DR.analytic_device_bytes(tcell) == _jax_arg_bytes(jcell)
    run = dataclasses.replace(tcell, args=tcell.run_args,
                              in_shardings=tcell.run_shardings)
    assert DR.analytic_device_bytes(run) == _jax_arg_bytes(jcell)
    assert tcell.meta["kind"] == jcell.meta["kind"]
    assert tcell.meta.get("n_micro") == jcell.meta.get("n_micro")


def test_wfa_cells():
    mesh = _mesh4()
    coll = {}
    for variant in ("pjit", "shard_map"):
        cell = TL.build_wfa_cell(wfa_paper, mesh, pairs_per_device=8,
                                 variant=variant)
        rec = DR.measure(cell, mesh)
        coll[variant] = rec["collectives"]["total"]
        assert rec["analytic_arg_bytes_per_device"] == 8 * (2 * 128 + 2) * 4
    # the lock-step exit all-reduces a flag each step; shard_map is free
    assert 0 < coll["pjit"] < 1e5
    assert coll["shard_map"] == 0.0


def test_sharded_product_counts_rank_zero():
    """[64,1024] @ [1024,4096], (Shard(0), Replicate()) x (Replicate(),
    Shard(1)) on 16 x 16: rank 0 multiplies [4,1024] by [1024,256]."""
    mesh = make_production_mesh()
    a = torch.empty((64, 1024), device="meta")
    b = torch.empty((1024, 4096), device="meta")
    sa, sb = Sharding(mesh, P("data", None)), Sharding(mesh, P(None, "model"))
    cell = TL.Cell(name="mm", fn=lambda x, y: x @ y, args=(a, b),
                   in_shardings=(sa, sb), run_args=(a, b),
                   run_shardings=(sa, sb), meta={"kind": "mm"})
    rec = TL.trace_cell(cell, mesh)
    assert rec["flops_per_device"] == 2 * 4 * 1024 * 256 == 2_097_152
    assert rec["collectives"]["total"] == 0


def test_quadratic_depth_fit_matches_full_depth():
    mesh = make_production_mesh()
    cfg = t_get("qwen3-0.6b")
    shape = SHAPES["train_4k"]
    depths = DR.roofline_depths(cfg)
    flops = [DR.measure(TL.build_lm_cell(cfg.replace(n_layers=L), shape,
                                         mesh, mode="roofline"),
                        mesh)["flops_per_device"] for L in depths]
    fit = DR._fit_quadratic(depths, flops, cfg.n_layers)
    full = DR.measure(TL.build_lm_cell(cfg, shape, mesh, mode="roofline"),
                      mesh)["flops_per_device"]
    assert abs(fit - full) <= 0.005 * full


def test_meta_state_bytes_equal_real_state():
    """On a 1 x 1 mesh the cell's argument bytes are the real state's."""
    cfg = t_smoke("qwen3-0.6b")
    mesh = Mesh((torch.device("meta"),), ("data", "model"), (1, 1))
    cell = TL.build_lm_cell(cfg, ShapeSpec("t", 32, 2, "train"), mesh)
    state, _ = get_model_fns(cfg).init_train_state(cfg, 0, "cpu")
    real = sum(t.numel() * t.element_size() for _, t in key_paths(state))
    assert DR.analytic_device_bytes(cell) == real + 2 * 2 * 32 * 4


def test_run_cell_records(monkeypatch, tmp_path):
    rec = DR.run_cell("qwen3-0.6b", "long_500k", False, skip_reason="why")
    assert rec["status"] == "skipped" and rec["reason"] == "why"
    rec = DR.run_cell("no-such-arch", "train_4k", False)
    assert rec["status"] == "error" and "KeyError" in rec["error"]
    assert [c[:2] for c in DR.applicable_cells(
        ["qwen3-0.6b", "wfa-paper"], None, [False], ["memory"])] == \
        [("qwen3-0.6b", s) for s in SHAPES] + \
        [("wfa-paper", "fig1_e2"), ("wfa-paper", "fig1_e4")]

    def boom(*a, **k):
        raise RuntimeError("planted")
    monkeypatch.setattr(DR, "build_wfa_cell", boom)
    out = tmp_path / "cells.jsonl"
    assert DR.main(["--arch", "wfa-paper", "--shape", "fig1_e2", "--mesh",
                    "single", "--out", str(out)]) == 1
    assert DR.load_done(str(out)) == {
        ("wfa-paper", "fig1_e2", "pod1-16x16", "memory"): "error"}


def test_expert_parallel_cell():
    """``moe_ep`` on the fake mesh takes the DTensor EP path: each MoE
    layer's two all-to-alls move rank 0's [MP, E_loc, C, D] buffer, and
    the experts' products shrink to the routed slots."""
    from repro_torch.models.moe import capacity
    mesh = _mesh4()
    cfg = t_smoke("phi3.5-moe-42b-a6.6b").replace(n_layers=2)
    shape = ShapeSpec("p", 64, 8, "prefill")
    recs = {ep: DR.measure(TL.build_lm_cell(cfg.replace(moe_ep=ep), shape,
                                            mesh), mesh) for ep in (0, 1)}
    MP, E = 4, cfg.n_experts
    C = capacity(cfg, 8 // 4 * 64 // MP)
    buf = MP * (E // MP) * C * cfg.d_model * 2          # bf16
    assert recs[1]["collectives_by_op"]["all-to-all:-"] == pytest.approx(
        2 * cfg.n_layers * buf * (MP - 1) / MP)
    assert 0 < recs[1]["flops_per_device"] < recs[0]["flops_per_device"]


def test_trace_overrides_are_installed_only_while_tracing():
    """``traced_ops.overrides`` swaps the trace's attention, cache write and
    loss into the model's modules and puts the originals back; a DTensor
    that reaches the CUDA kernel outside a trace is refused, never handed
    to the plain math."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.distributed.fake_mesh import fake_device_mesh
    from repro_torch.kernels.flash_attention import kernel, ops
    from repro_torch.launch import traced_ops
    from repro_torch.models import encdec, layers, transformer
    names = [(ops, "flash_attention_gqa"), (layers, "_sdpa"),
             (layers, "_write_row"), (transformer, "cross_entropy"),
             (encdec, "cross_entropy")]
    before = [getattr(m, n) for m, n in names]
    with traced_ops.overrides():
        assert [getattr(m, n) for m, n in names] == [
            traced_ops.flash_attention_gqa, traced_ops.sdpa,
            traced_ops.write_row, traced_ops.cross_entropy,
            traced_ops.cross_entropy]
    assert [getattr(m, n) for m, n in names] == before
    assert ops.flash_attention_gqa is kernel.flash_attention_gqa

    mesh = Mesh((torch.device("cpu"),) * 4, ("data", "model"), (2, 2))
    with fake_device_mesh(mesh, "cpu") as dmesh:
        q = DTensor.from_local(torch.zeros((1, 128, 2, 64)), dmesh,
                               [Replicate(), Replicate()], run_check=False)
        with pytest.raises(TypeError, match="plain tensors"):
            kernel.flash_attention_cuda(q, q, q, block_q=128, block_k=128)
