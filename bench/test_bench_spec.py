"""The benchmark's files: ``BENCHMARK.json`` against the rules of names
and files, every configuration, cell and metric file found by name, and a
cell added as files alone listed by the harness."""
import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from harness import spec  # noqa: E402

SPEC = spec.load()
CELLS = [w["name"] for w in SPEC["workloads"]]
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_paths():
    assert set(SPEC) == KEYS
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert SPEC["paths"] == ["bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024


def test_names_units_and_files():
    assert spec.problems(SPEC) == []


def test_setup_metric_and_bounds():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_parse(name):
    cell = spec.cell(SPEC, name)
    wl, cfg = cell["workload"], cell["config"]
    assert wl["why"] == cell["entry"]["why"]
    assert wl["pool_pairs"] % wl["chunk_pairs"] == 0
    assert cfg["reduced"] == cell["config_entry"]["reduced"]
    assert cfg["name"] == cell["config_entry"]["name"]
    assert cell["entry"]["chips"] == 1
    e2e = {m["name"] for m in spec.end_to_end(SPEC, name)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.per_layer(SPEC, name)


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_metric_reader_loads(metric):
    assert callable(spec.reader(metric))


def test_no_reads_outside_bench():
    """The harness reads no file of the JAX package's benchmarks or
    snapshots, and names no path outside the checkout."""
    for dirpath, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py") and not f.startswith("test_"):
                text = open(os.path.join(dirpath, f)).read()
                for word in ("results/perf", "benchmarks/", "/tmp/",
                             "/dev/shm"):
                    assert word not in text, (f, word)


def test_a_cell_added_as_files_is_listed(tmp_path):
    """A later cell comes as a workload file and an entry: the harness
    finds it by name, with its metrics, and edits nothing."""
    root = tmp_path / "co"
    shutil.copytree(os.path.join(spec.ROOT, "bench"), root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    data = json.loads(json.dumps(SPEC))
    base = spec.cell(SPEC, "wfa-100bp.score")["workload"]
    extra = dict(base, edit_frac=0.04,
                 why="100 bp pairs at E 4%: about four times the cells")
    (root / "bench" / "workloads" / "wfa-100bp.e4.json").write_text(
        json.dumps(extra))
    data["workloads"].append({"name": "wfa-100bp.e4", "config": "wfa-100bp",
                              "traffic": "score-e4", "chips": 1,
                              "why": extra["why"]})
    for m in data["end_to_end"] + data["per_layer"]:
        if "wfa-100bp.score" in m.get("workloads", ()):
            m["workloads"].append("wfa-100bp.e4")
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    got = spec.load(str(root))
    assert spec.problems(got, str(root)) == []
    cell = spec.cell(got, "wfa-100bp.e4", str(root))
    assert cell["workload"]["edit_frac"] == 0.04
    assert [m["name"] for m in spec.per_layer(got, "wfa-100bp.e4")] == \
        [m["name"] for m in spec.per_layer(SPEC, "wfa-100bp.score")]


def test_a_metric_moves_what_its_cells_report():
    """A per-layer metric listing a cell that does not report the
    end-to-end metric it moves is refused."""
    data = json.loads(json.dumps(SPEC))
    m = next(m for m in data["per_layer"]
             if "wfa-100bp.score" in m["workloads"])
    m["moves"] = next(e["name"] for e in data["end_to_end"]
                      if "wfa-100bp.score" not in e.get("workloads",
                                                        ["wfa-100bp.score"]))
    assert any("does not report" in p for p in spec.problems(data))


def test_the_command_refuses_without_a_card():
    """On a machine without CUDA the command exits non-zero and prints no
    result (this sandbox has none)."""
    import subprocess
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal cannot show here")
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload",
         "wfa-100bp.score", "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=spec.ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr
