"""The port's dry-run analysis (``analysis/{collectives,roofline,report}``)
against the JAX package's ``analysis/{hlo,roofline}``.

Collective records equivalent to ``tests/test_analysis.py``'s HLO give the
JAX parser's wire bytes per kind; ``attn_s2_traffic`` equals the JAX
package's for every arch x shape; ``terms()`` on the port's H100 figures
is the JAX package's on the v5e's scaled by the ratio of the constants.
"""
import ast
import json
import os

import pytest

pytest.importorskip("torch")

from repro.analysis import hlo as J_HLO  # noqa: E402
from repro.analysis import roofline as J_ROOF  # noqa: E402
from repro.configs import ARCH_NAMES  # noqa: E402
from repro.models.common import SHAPES  # noqa: E402
from repro_torch.analysis import collectives as COLL  # noqa: E402
from repro_torch.analysis import report as REPORT  # noqa: E402
from repro_torch.analysis import roofline as ROOF  # noqa: E402

HLO = """
  %all-reduce.1 = f32[1024]{0} all-reduce(%x), replica_groups=[1,8]<=[8], to_apply=%add
  %all-gather.2 = bf16[16,128]{1,0} all-gather(%y), replica_groups={{0,1,2,3}}, dimensions={0}
  %reduce-scatter.3 = f32[64]{0} reduce-scatter(%z), replica_groups=[2,4]<=[8], dimensions={0}
  %collective-permute.4 = s32[256]{0} collective-permute(%w), source_target_pairs={{0,1}}
  %all-to-all.6 = f32[32,8]{1,0} all-to-all(%v), replica_groups={{0,1}}, dimensions={0}
  %add.5 = f32[4]{0} add(%a, %b)
"""
RECORDS = [
    {"kind": "all-reduce", "bytes": 1024 * 4, "group": 8},
    {"kind": "all-gather", "bytes": 16 * 128 * 2, "group": 4},
    {"kind": "reduce-scatter", "bytes": 64 * 4, "group": 4},
    {"kind": "collective-permute", "bytes": 256 * 4, "group": 8},
    {"kind": "all_to_all", "bytes": 32 * 8 * 4, "group": 2},
]


def test_collective_bytes_equal_the_hlo_parser():
    want = J_HLO.collective_bytes(HLO, n_devices=8)
    got = COLL.collective_bytes(RECORDS)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12), k


def test_collective_bytes_edges():
    assert COLL.collective_bytes([]) == {"total": 0.0}
    # a group of one counts as two, as the HLO parser's max(2, N)
    assert COLL.wire_bytes("all-reduce", 100, 1) == pytest.approx(100.0)
    with pytest.raises(ValueError):
        COLL.wire_bytes("gossip", 1, 2)


def test_op_histogram():
    h = COLL.op_histogram({"mm": 3, "add": 5, "view": 1}, top=2)
    assert list(h) == ["add", "mm"]


@pytest.mark.parametrize("arch", ARCH_NAMES + ["nonexistent-arch"])
def test_attn_s2_traffic_equal(arch):
    for shape in SHAPES:
        for n in (256, 512):
            assert ROOF.attn_s2_traffic(arch, shape, n) == \
                J_ROOF.attn_s2_traffic(arch, shape, n)


def _rec(arch="qwen3-0.6b", shape="train_4k", **kw):
    rec = {"status": "ok", "arch": arch, "shape": shape, "n_devices": 256,
           "flops_per_device": 3.1e14, "bytes_per_device": 7.7e12,
           "collectives": {"total": 2.9e10}, "model_flops": 4.4e16,
           "meta_kind": "train"}
    rec.update(kw)
    return rec


@pytest.mark.parametrize("arch,shape", [("qwen3-0.6b", "train_4k"),
                                        ("qwen3-32b", "prefill_32k"),
                                        ("mamba2-780m", "decode_32k")])
def test_terms_scale_from_the_jax_constants(arch, shape):
    rec = _rec(arch, shape)
    j, t = J_ROOF.terms(rec), ROOF.terms(rec)
    scale = {"compute_s": J_ROOF.PEAK_FLOPS / ROOF.PEAK_FLOPS,
             "memory_s": J_ROOF.HBM_BW / ROOF.HBM_BW,
             "memory_flash_s": J_ROOF.HBM_BW / ROOF.HBM_BW,
             "collective_s": J_ROOF.ICI_BW / ROOF.LINK_BW}
    for k, f in scale.items():
        assert t[k] == pytest.approx(j[k] * f, rel=1e-12), k
    assert t["model_over_hlo"] == j["model_over_hlo"]
    assert t["bound_s"] == max(t["compute_s"], t["memory_flash_s"],
                               t["collective_s"])
    assert ROOF.terms({"status": "error"}) is None


def test_h100_constants_and_dominant_term():
    assert (ROOF.PEAK_FLOPS, ROOF.HBM_BW, ROOF.LINK_BW) == \
        (989e12, 3.35e12, 450e9)
    rec = _rec("nonexistent-arch", flops_per_device=989e12,   # 1 s compute
               bytes_per_device=3.35e12 * 2,                  # 2 s memory
               collectives={"total": 450e9 * 0.5},            # 0.5 s
               model_flops=989e12 * 256)
    t = ROOF.terms(rec)
    assert t["dominant"] == "memory" and t["mfu_bound"] == pytest.approx(0.5)


def test_fmt_and_tables(tmp_path):
    assert ROOF.fmt_seconds(0) == "0"
    assert ROOF.fmt_seconds(5e-7).endswith("µs")
    assert ROOF.fmt_seconds(5e-2).endswith("ms")
    recs = {
        ("qwen3-0.6b", "train_4k", "pod1-16x16", "roofline"):
            _rec(mesh_shape=[16, 16]),
        ("qwen3-0.6b", "train_4k", "pod1-16x16", "memory"):
            _rec(mesh_shape=[16, 16], mem_argument_size_in_bytes=70e9,
                 mem_temp_size_in_bytes=20e9),
        ("granite-8b", "train_4k", "pod1-16x16", "roofline"):
            {"status": "error", "arch": "granite-8b", "shape": "train_4k"},
        ("whisper-base", "long_500k", "pod1-16x16", "roofline"):
            {"status": "skipped", "reason": "quadratic attention"},
    }
    md = ROOF.markdown(recs)
    rows = md.splitlines()[2:]
    assert "ERROR" in rows[0] and "skipped" in rows[2]
    assert "| ≥" in rows[1]               # 16-card groups cross hosts
    fit = ROOF.fit_table(recs)
    assert "90.00GB | **NO** |" in fit and "fits 80GB?" in fit
    assert " ~" not in md + fit
    for p in ("roofline", "memory"):
        recs[("qwen3-0.6b", "train_4k", "pod1-16x16", p)].update(
            traced_arg_bytes_per_device=2, analytic_arg_bytes_per_device=1)
    assert "| qwen3-0.6b | train_4k ~ |" in ROOF.markdown(recs)
    assert "| qwen3-0.6b | train_4k ~ |" in ROOF.fit_table(recs)
    for p in ("roofline", "memory"):
        recs[("qwen3-0.6b", "train_4k", "pod1-16x16", p)].update(
            traced_arg_bytes_per_device=1)

    path = tmp_path / "cells.jsonl"
    path.write_text("".join(json.dumps({**r, "arch": k[0], "shape": k[1],
                                        "mesh": k[2], "pass": k[3]}) + "\n"
                            for k, r in recs.items()) + "not json\n")
    assert set(ROOF.load(str(path))) == set(recs)
    doc = tmp_path / "doc.md"
    doc.write_text("a\n<!-- ROOFLINE_TABLE -->\nold\n<!-- /ROOFLINE_TABLE -->"
                   "\nb\n<!-- PERF_TABLE -->\nc\n")
    REPORT.patch(str(doc), cells=str(path),
                 experiments=str(tmp_path / "none.jsonl"))
    text = doc.read_text()
    assert "old" not in text and text.startswith("a\n") and "\nb\n" in text
    assert "| qwen3-0.6b | train_4k |" in text
    assert text.count("<!-- /PERF_TABLE -->") == 1 and "(pending)" in text


def test_report_rows_name_the_registry():
    """Every experiment a report row names is one hillclimb runs."""
    from repro_torch.launch.hillclimb import EXPERIMENTS
    for _, key in REPORT.PERF_ROWS + REPORT.MEM_ROWS:
        assert key in EXPERIMENTS, key


def test_hillclimb_names_equal_the_jax_registry():
    """``hillclimb --list`` prints the JAX package's 33 names in order (read
    from its source: importing it sets XLA_FLAGS)."""
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    tree = ast.parse(open(os.path.join(src, "repro", "launch",
                                       "hillclimb.py")).read())
    want = next(n for n in ast.walk(tree) if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", "") == "EXPERIMENTS")
    want = [k.value for k in want.value.keys]
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.hillclimb", "--list"],
        env=dict(os.environ, PYTHONPATH=src), capture_output=True,
        text=True, timeout=120, check=True).stdout.split()
    assert len(want) == 33 and out == want
