"""The per-layer metrics that read the parts of ``wave.scatter`` and
``wave.traceback`` and each wave's device seconds: traced runs of a score
cell and the cigar cell on the CPU at small sizes, in a fresh interpreter
(the tests' own processes hold JAX), report every one of them."""
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from harness import spec  # noqa: E402

SPAN_SCORE = ("session.pack_pct.score", "session.stage_pct.score",
              "session.launch_pct.score")
SPAN_CIGAR = ("decode.walk_pct", "decode.replay_pct")
COUNTERS = {"wfa-100bp.score": ("engine.h2d_ns_per_pair.score",
                                "kernel.wfa_score_ns_per_pair"),
            "wfa-100bp.cigar": ("kernel.wfa_trace_ns_per_pair",
                                "session.d2h_ns_per_pair")}

RUN = """
import json, sys
sys.path.insert(0, {here!r})
sys.path.insert(0, {src!r})
from harness import core
import test_bench_rehearsal as t
out = {{name: core.run_cell(name, 3000000019, 1.0, True, device="cpu",
                           cell=t.small_cell(name))
        for name in ("wfa-100bp.score", "wfa-100bp.cigar")}}
print(json.dumps(out))
"""


def test_traced_cells_report_the_layer_parts():
    src = os.path.join(os.path.dirname(HERE), "src")
    proc = subprocess.run([sys.executable, "-c",
                           RUN.format(here=HERE, src=src)],
                          capture_output=True, text=True, timeout=240,
                          cwd=HERE)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    data = spec.load()
    for name, res in out.items():
        assert res["correct"], (name, res["checks"])
        got = res["metrics"]
        names = SPAN_SCORE if name.endswith(".score") else SPAN_CIGAR
        for m in names + COUNTERS[name]:
            assert m in got, (name, m)
            assert name in {e["name"]: e for e in data["per_layer"]}[m][
                "workloads"]
        for m in names:
            assert 0.0 <= got[m]["value"] <= 100.0, (m, got[m])
        for m in COUNTERS[name]:
            assert got[m]["value"] > 0 and got[m]["unit"] == "ns/pair", m
    # the parts nest inside their span
    for name, parts, whole in (
            ("wfa-100bp.score", SPAN_SCORE, "session.scatter_pct.score"),
            ("wfa-100bp.cigar", SPAN_CIGAR, "decode.traceback_pct")):
        got = out[name]["metrics"]
        assert sum(got[m]["value"] for m in parts) <= \
            got[whole]["value"] + 0.5, (name, got)
