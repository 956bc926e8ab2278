"""Runs of the harness on the CPU at small sizes, past its look for a card:
a sound run is correct and loads no JAX; the control (the program's own
pruning heuristic switched on, which breaks the exactness the
configuration states) and each fault planted under the timed path come
out not correct."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from harness import core, spec  # noqa: E402

SMALL = {
    "wfa-100bp.score": {"pool_pairs": 2048, "chunk_pairs": 256,
                        "judge_chunks": 4},
    "wfa-10kb.score": {"read_len": 300, "pool_pairs": 256, "chunk_pairs": 32,
                       "judge_chunks": 2},
    "wfa-100bp.cigar": {"pool_pairs": 2048, "chunk_pairs": 256,
                        "judge_chunks": 4},
    "wfa-10kb.bidir": {"read_len": 300, "pool_pairs": 64, "chunk_pairs": 8,
                       "judge_chunks": 2},
}
# BiWFA splits only past its trace budget: a small one makes 300 bp pairs
# recurse through meet waves as 10 kb pairs do
SMALL_CONFIG = {"wfa-10kb.bidir": {"trace_budget": 2048}}


def small_cell(name, config=None, **over):
    data = spec.load()
    if name in {w["name"] for w in data["workloads"]}:
        cell = spec.cell(data, name)
    else:       # a traffic kept for a later cell: its files, no entry yet
        cell = {"workload": json.load(open(os.path.join(
                    HERE, "workloads", f"{name}.json"))),
                "config": json.load(open(os.path.join(
                    HERE, "configs", f"{name.split('.')[0]}.json")))}
    cell["workload"].update(SMALL[name], **over)
    cell["config"].update(SMALL_CONFIG.get(name, {}), **(config or {}))
    return cell


def run_small(name, seconds=1.0, trace=False, **kw):
    return core.run_cell(name, 2 ** 31 + 5, seconds, trace, device="cpu",
                         cell=small_cell(name, **kw))


REHEARSE = """
import json, sys
sys.path.insert(0, {here!r})
sys.path.insert(0, {src!r})
from harness import core, spec
import test_bench_rehearsal as t
out = {{}}
for name, trace in {cells!r}:
    out[name] = core.run_cell(name, 4000000007, 1.0, trace, device="cpu",
                              cell=t.small_cell(name))
out["forbidden"] = core.forbidden_modules()
print(json.dumps(out))
"""


def test_rehearsal_is_correct_and_loads_no_jax():
    """In a fresh interpreter (the tests' own processes hold JAX): two cells
    driven whole, one traced; no module named jax, jaxlib, flax or repro,
    compared by whole top-level name, is loaded after the window."""
    src = os.path.join(os.path.dirname(HERE), "src")
    code = REHEARSE.format(here=HERE, src=src,
                           cells=[("wfa-100bp.score", False),
                                  ("wfa-100bp.cigar", True)])
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=240, cwd=HERE)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out.pop("forbidden") == []
    for name, res in out.items():
        assert res["correct"], (name, res["checks"])
        assert res["failed"] == 0 and res["attempted"] > 0
    assert set(out["wfa-100bp.score"]["metrics"]) == {
        m["name"] for m in spec.end_to_end(spec.load(), "wfa-100bp.score")}
    traced = out["wfa-100bp.cigar"]["metrics"]
    assert {"session.scatter_pct", "decode.traceback_pct"} <= set(traced)
    assert list(out["wfa-100bp.cigar"])[-1] == "checks"


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    monkeypatch.delitem(sys.modules, "repro", raising=False)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    before = core.forbidden_modules()
    assert "repro_torch_like" not in before
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro" in core.forbidden_modules()


@pytest.mark.parametrize("name", ["wfa-10kb.score", "wfa-10kb.bidir"])
def test_long_read_cells_rehearse(name):
    res = run_small(name, seconds=1.0)
    assert res["correct"], res["checks"]
    assert res["checks"]["pairs_judged"]["value"] >= 16


def test_control_is_not_correct():
    """The control: the program with its adaptive band switched on, tight
    enough to prune an optimal path; at E 10% it does so in every chunk
    of 256 pairs of 100 bp (5-9 a chunk), however few chunks the window
    finishes."""
    res = run_small("wfa-100bp.score", edit_frac=0.1,
                    config={"heuristic": "adaptive:1,1"})
    assert not res["correct"]
    assert res["checks"]["score_mismatch"]["value"] > 0


def _plain_with(fault):
    """The kernel's plain version, broken after set-up's first launch."""
    from repro_torch.kernels.wfa import kernel
    plain = kernel.wfa_plain
    calls = []

    def broken(*args, **kw):
        out = plain(*args, **kw)
        calls.append(1)
        if len(calls) == 1:
            return out
        return (fault(out[0]),) + tuple(out[1:])
    return kernel, broken


def _alter_one(score):
    s = score.clone()
    s[0, 0] += 2
    return s


def _drop_half(score):
    s = score.clone()
    s[s.shape[0] // 2:] = 0
    return s


@pytest.mark.parametrize("fault", [_alter_one, _drop_half],
                         ids=["answer_altered", "half_left_out"])
@pytest.mark.parametrize("name", ["wfa-100bp.score", "wfa-100bp.cigar"])
def test_planted_kernel_fault_is_not_correct(monkeypatch, name, fault):
    kernel, broken = _plain_with(fault)
    monkeypatch.setattr(kernel, "wfa_plain", broken)
    res = run_small(name)
    assert not res["correct"]


def test_altered_cigar_is_not_correct(monkeypatch):
    from repro_torch.core import cigar
    decode = cigar.traceback_result

    def broken(*args, **kw):
        ops = decode(*args, **kw)
        ops[0] = np.concatenate([ops[0], [2]]).astype(ops[0].dtype)
        return ops
    monkeypatch.setattr(cigar, "traceback_result", broken)
    res = run_small("wfa-100bp.cigar")
    assert not res["correct"]
    assert res["checks"]["cigar_bad"]["value"] > 0


def test_allocator_keeps_large_blocks_in_the_heap():
    """The measured process serves large blocks from glibc's heap (in a
    fresh interpreter: the setting lasts for the process)."""
    code = ("import sys; sys.path.insert(0, %r); from harness import core; "
            "print(core.tune_allocator())" % HERE)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "True"
