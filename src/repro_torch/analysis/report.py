"""Render the dry-run's tables (the JAX package's ``analysis/report.py``):
the roofline and 80 GB fit tables from ``results/torch_dryrun/cells.jsonl``
and the experiments table from ``results/torch_perf/experiments.jsonl``.

    PYTHONPATH=src python -m repro_torch.analysis.report [FILE.md]

With a markdown file, replaces what stands between its
``<!-- ROOFLINE_TABLE -->`` / ``<!-- /ROOFLINE_TABLE -->`` and
``<!-- PERF_TABLE -->`` / ``<!-- /PERF_TABLE -->`` markers (a marker alone
gets its table and a closing marker); the text around them is untouched.
Without one, prints the tables.
"""
from __future__ import annotations

import json
import os
import re
import sys

from repro_torch.analysis.roofline import (HBM_BW, LINK_BW, PEAK_FLOPS,
                                           fit_table, load, markdown)

CELLS = "results/torch_dryrun/cells.jsonl"
EXPERIMENTS = "results/torch_perf/experiments.jsonl"

PERF_ROWS = [
    # (label, experiment key)
    ("cell 1 — wfa-paper E2% · pjit baseline (lock-step)", "wfa_pjit_baseline"),
    ("cell 1 — wfa-paper E2% · shard_map (per-shard term.)", "wfa_shardmap"),
    ("cell 1 — multi-pod · pjit", "wfa_pjit_multipod"),
    ("cell 1 — multi-pod · shard_map", "wfa_shardmap_multipod"),
    ("cell 2 — zamba2 train · fused xBC (baseline)", "zamba2_train_fusedproj"),
    ("cell 2 — zamba2 train · split x/B/C (refuted lever)", "zamba2_train_splitproj"),
    ("cell 2 — zamba2 train · split + seq-parallel", "zamba2_train_seqshard"),
    ("cell 3 — deepseek train · pjit scatter (baseline)", "deepseek_train_baseline"),
    ("cell 3 — deepseek train · EP (shard_map+all_to_all)", "deepseek_train_ep"),
    ("extra — phi3.5-moe train · EP dispatch", "phi35_train_ep"),
    ("extra — qwen3-32b prefill · baseline", "qwen3_32b_prefill_baseline"),
    ("extra — qwen3-32b prefill · seq-parallel", "qwen3_32b_prefill_seqshard"),
    ("extra — granite-8b train · baseline", "granite8b_train_baseline"),
    ("extra — granite-8b train · seq-parallel", "granite8b_train_seqshard"),
    ("extra — qwen3-32b train · seq-parallel", "qwen3_32b_train_seqshard"),
    ("extra — deepseek decode · naive MLA", "deepseek_decode_baseline"),
    ("extra — deepseek decode · absorbed MLA", "deepseek_decode_absorb"),
]

MEM_ROWS = [
    ("qwen3-32b train · TP-only state (baseline)", "qwen3_32b_train_nozero_mem"),
    ("qwen3-32b train · ZeRO 2-D state", "qwen3_32b_train_zero_mem"),
    ("qwen3-32b train · ZeRO + remat nothing", "qwen3_32b_train_remat_nothing_mem"),
    ("qwen3-32b train · ZeRO + 2k-token microbatch", "qwen3_32b_train_micro2k_mem"),
    ("granite-8b train · ZeRO + seq-parallel", "granite8b_train_seqshard_mem"),
    ("qwen3-32b train · ZeRO + remat-nothing + seq-par", "qwen3_32b_train_fit_combo_mem"),
    ("granite-34b train · ZeRO + remat-nothing + seq-par", "granite34b_train_fit_combo_mem"),
    ("qwen2-vl-7b train · ZeRO + remat-nothing + seq-par", "qwen2vl_train_fit_combo_mem"),
    ("zamba2-7b train · ZeRO + remat-nothing + seq-par", "zamba2_train_fit_combo_mem"),
    ("zamba2-7b train · ZeRO + seq-par + chunk64", "zamba2_train_fit_dots_mem"),
    ("phi3.5-moe train (2-pod) · ZeRO + EP + remat + seq-par", "phi35_train_fit_combo_mem"),
]


def perf_table(path: str = EXPERIMENTS) -> str:
    recs = {}
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                r = json.loads(line)
                if r.get("status") == "ok":
                    recs[r["experiment"]] = r
    out = ["| experiment | compute | memory | collective | MFU bound |",
           "|---|---|---|---|---|"]
    for label, key in PERF_ROWS:
        r = recs.get(key)
        if r is None:
            out.append(f"| {label} | — | — | — | (pending) |")
            continue
        tc = r["flops_per_device"] / PEAK_FLOPS
        tm = r["bytes_per_device"] / HBM_BW
        tx = r["collectives"]["total"] / LINK_BW
        mf = r.get("model_flops") or 0.0
        mfu = (mf / r["n_devices"] / PEAK_FLOPS / max(tc, tm, tx)) if mf else 0
        f = lambda x: (f"{x*1e6:.1f}µs" if x < 1e-3 else
                       f"{x*1e3:.2f}ms" if x < 1 else f"{x:.2f}s")
        out.append(f"| {label} | {f(tc)} | {f(tm)} | {f(tx)} | "
                   f"{mfu:.1%} |" if mf else
                   f"| {label} | {f(tc)} | {f(tm)} | {f(tx)} | n/a |")

    out += ["", "Memory-fit iterations (per-device, memory pass):", "",
            "| experiment | args | temps | net | fits 80GB? |",
            "|---|---|---|---|---|"]
    for label, key in MEM_ROWS:
        r = recs.get(key)
        if r is None:
            out.append(f"| {label} | — | — | — | (pending) |")
            continue
        a = r.get("mem_argument_size_in_bytes", 0)
        t = r.get("mem_temp_size_in_bytes", 0)
        net = a + t - r.get("mem_alias_size_in_bytes", 0) \
            + r.get("mem_output_size_in_bytes", 0)
        ok = "YES" if net < 80e9 else "**NO**"
        out.append(f"| {label} | {a/1e9:.2f}GB | {t/1e9:.2f}GB "
                   f"| {net/1e9:.2f}GB | {ok} |")
    return "\n".join(out)


def roofline_tables(path: str = CELLS) -> str:
    recs = load(path) if os.path.exists(path) else {}
    return (markdown(recs) + "\n\n**Per-device memory fit (memory pass):**"
            "\n\n" + fit_table(recs))


def patch(md_path: str, cells: str = CELLS,
          experiments: str = EXPERIMENTS) -> None:
    with open(md_path) as f:
        text = f.read()
    for tag, table in (("ROOFLINE_TABLE", roofline_tables(cells)),
                       ("PERF_TABLE", perf_table(experiments))):
        text = re.sub(rf"<!-- {tag} -->(?:.*?<!-- /{tag} -->)?",
                      lambda _: f"<!-- {tag} -->\n{table}\n<!-- /{tag} -->",
                      text, flags=re.S)
    with open(md_path, "w") as f:
        f.write(text)
    print(f"patched {md_path}")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv:
        patch(argv[0])
    else:
        print(roofline_tables())
        print()
        print(perf_table())
    return 0


if __name__ == "__main__":
    sys.exit(main())
