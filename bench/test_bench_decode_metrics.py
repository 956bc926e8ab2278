"""The metrics of where a CIGAR wave's packed trace is decoded:
``decode.card_pct`` (the session's ``n_tb_card`` / ``n_tb_host``) and
``kernel.wfa_traceback_ns_per_pair`` (its ``t_dev_traceback``).  A traced
run of the cigar cell on the CPU at a small size, in a fresh interpreter
(the tests' own processes hold JAX), decodes every pair on the host: the
first reads 0 and the second, with no traceback kernel to time, is left
out.  The readers against the counters a card's run and a program without
them would leave."""
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from harness import spec  # noqa: E402

RUN = """
import json, sys
sys.path.insert(0, {here!r})
sys.path.insert(0, {src!r})
from harness import core
import test_bench_rehearsal as t
name = "wfa-100bp.cigar"
print(json.dumps(core.run_cell(name, 3000000019, 1.0, True, device="cpu",
                               cell=t.small_cell(name))))
"""


def test_cpu_cigar_run_decodes_on_the_host():
    src = os.path.join(os.path.dirname(HERE), "src")
    proc = subprocess.run([sys.executable, "-c",
                           RUN.format(here=HERE, src=src)],
                          capture_output=True, text=True, timeout=240,
                          cwd=HERE)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    got = res["metrics"]
    assert got["decode.card_pct"] == {"value": 0.0, "unit": "%"}
    assert "kernel.wfa_traceback_ns_per_pair" not in got
    entries = {e["name"]: e for e in spec.load()["per_layer"]}
    for m in ("decode.card_pct", "kernel.wfa_traceback_ns_per_pair"):
        assert entries[m]["workloads"] == ["wfa-100bp.cigar"]
        assert entries[m]["moves"] == "pairs_per_s"


def _run(**stats):
    return SimpleNamespace(stats=SimpleNamespace(**stats))


@pytest.mark.parametrize("stats, want", [
    ({"n_pairs": 4096, "n_tb_card": 4096, "n_tb_host": 0}, 100.0),
    ({"n_pairs": 4096, "n_tb_card": 1024, "n_tb_host": 3072}, 25.0),
    ({"n_pairs": 4096, "n_tb_card": 0, "n_tb_host": 4096}, 0.0),
    ({"n_pairs": 0, "n_tb_card": 0, "n_tb_host": 0}, None),
    ({"n_pairs": 4096}, None),          # a program without the counters
])
def test_decode_card_pct_reads_the_counters(stats, want):
    assert spec.reader("decode.card_pct")(_run(**stats)) == want


@pytest.mark.parametrize("stats, want", [
    ({"n_pairs": 4096, "n_tb_card": 4096, "t_dev_traceback": 4.096e-5},
     10.0),
    ({"n_pairs": 4096, "n_tb_card": 0, "t_dev_traceback": 0.0}, None),
    ({"n_pairs": 4096, "t_dev_kernel": 1e-3}, None),   # without the counter
])
def test_traceback_ns_per_pair_reads_the_events(stats, want):
    got = spec.reader("kernel.wfa_traceback_ns_per_pair")(_run(**stats))
    assert got == (None if want is None else pytest.approx(want))
