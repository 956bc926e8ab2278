"""Perf hillclimbing (the JAX package's ``launch/hillclimb.py``).

Each experiment is a dry-run cell and a named change (config overrides or
a cell variant): it is traced on the fake production mesh
(``launch/lowering.py``), measured with the dry-run's roofline quantities
and appended to ``results/torch_perf/experiments.jsonl``, so every
hypothesis -> change -> before -> after cycle is on the record.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --exp wfa_shardmap
    PYTHONPATH=src python -m repro_torch.launch.hillclimb --list

The roofline measurements trace three shallow depths and evaluate the
quadratic through them at the production depth
(``dryrun.roofline_depths``), as the JAX package does; ``mode="memory"``
traces the production step whole.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

from repro_torch.configs import get_config, wfa_paper
from repro_torch.launch.dryrun import _fit_quadratic, measure, roofline_depths
from repro_torch.launch.lowering import build_lm_cell, build_wfa_cell
from repro_torch.launch.mesh import make_production_mesh, mesh_devices
from repro_torch.models.common import SHAPES, model_flops

RESULTS = "results/torch_perf/experiments.jsonl"


def measure_lm(arch: str, shape_name: str, overrides: dict, *,
               multi_pod: bool = False, zero: bool = True,
               mode: str = "roofline") -> dict:
    """Roofline measurement (quadratic depth extrapolation) of an LM cell
    with config overrides applied; ``mode="memory"`` traces it whole."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_dev = mesh_devices(mesh)
    cfg = get_config(arch).replace(**overrides)
    shape = SHAPES[shape_name]
    rec = {"model_flops": model_flops(cfg, shape), "n_devices": n_dev}
    depths = roofline_depths(cfg)
    if mode == "memory" or cfg.n_layers <= depths[-1]:
        cell = build_lm_cell(cfg, shape, mesh, mode=mode, zero=zero)
        rec.update(measure(cell, mesh))
        return rec
    points = []
    for L in depths:
        cell = build_lm_cell(cfg.replace(n_layers=L), shape, mesh,
                             mode="roofline", zero=zero)
        m = measure(cell, mesh)
        m["n_layers"] = L
        points.append(m)
    Lf = cfg.n_layers
    rec["flops_per_device"] = _fit_quadratic(
        depths, [p["flops_per_device"] for p in points], Lf)
    rec["bytes_per_device"] = _fit_quadratic(
        depths, [p["bytes_per_device"] for p in points], Lf)
    keys = set()
    for p in points:
        keys |= set(p["collectives"])
    rec["collectives"] = {
        k: max(0.0, _fit_quadratic(depths,
                                   [p["collectives"].get(k, 0.0)
                                    for p in points], Lf))
        for k in keys}
    rec["trace_s"] = round(sum(p["trace_s"] for p in points), 2)
    return rec


def measure_wfa(variant: str, *, edit_frac: float = 0.02,
                multi_pod: bool = False) -> dict:
    mesh = make_production_mesh(multi_pod=multi_pod)
    cell = build_wfa_cell(wfa_paper, mesh, edit_frac=edit_frac,
                          variant=variant)
    rec = {"n_devices": mesh_devices(mesh), "model_flops": 0.0}
    rec.update(measure(cell, mesh))
    return rec


# ---------------------------------------------------------------------------
# Experiment registry: name -> callable() -> record dict (the JAX package's
# names and overrides, so each row compares with its counterpart)

EXPERIMENTS = {
    # -- cell 1: the paper's own technique (wfa-paper : fig1_e2) ----------
    "wfa_pjit_baseline": lambda: measure_wfa("pjit"),
    "wfa_shardmap": lambda: measure_wfa("shard_map"),
    "wfa_pjit_multipod": lambda: measure_wfa("pjit", multi_pod=True),
    "wfa_shardmap_multipod": lambda: measure_wfa("shard_map", multi_pod=True),

    # -- cell 2: most collective-bound LM cell ----------------------------
    "qwen3_32b_prefill_baseline": lambda: measure_lm(
        "qwen3-32b", "prefill_32k", {}),
    "qwen3_32b_prefill_seqshard": lambda: measure_lm(
        "qwen3-32b", "prefill_32k", {"seq_shard": True}),
    "granite8b_train_baseline": lambda: measure_lm(
        "granite-8b", "train_4k", {}),
    "granite8b_train_seqshard": lambda: measure_lm(
        "granite-8b", "train_4k", {"seq_shard": True}),

    # -- ZeRO 2-D state sharding: the fit fix, costed both ways -----------
    "qwen3_32b_train_zero_mem": lambda: measure_lm(
        "qwen3-32b", "train_4k", {}, mode="memory", zero=True),
    "qwen3_32b_train_nozero_mem": lambda: measure_lm(
        "qwen3-32b", "train_4k", {}, mode="memory", zero=False),
    "qwen3_32b_train_zero_roofline": lambda: measure_lm(
        "qwen3-32b", "train_4k", {}, zero=True),
    "qwen3_32b_train_nozero_roofline": lambda: measure_lm(
        "qwen3-32b", "train_4k", {}, zero=False),

    # -- cell 2 (most collective-bound): zamba2 split vs fused xBC proj ---
    "zamba2_train_fusedproj": lambda: measure_lm(
        "zamba2-7b", "train_4k", {"ssm_split_proj": False}),
    "zamba2_train_splitproj": lambda: measure_lm(
        "zamba2-7b", "train_4k", {"ssm_split_proj": True}),
    "zamba2_train_seqshard": lambda: measure_lm(
        "zamba2-7b", "train_4k", {"seq_shard": True}),

    # -- follow-ups: memory-fit iterations on the flagship train cell ------
    "qwen3_32b_train_remat_nothing_mem": lambda: measure_lm(
        "qwen3-32b", "train_4k", {"remat_policy": "nothing"}, mode="memory"),
    "qwen3_32b_train_micro2k_mem": lambda: measure_lm(
        "qwen3-32b", "train_4k", {"microbatch_tokens": 2048}, mode="memory"),
    "qwen3_32b_train_seqshard": lambda: measure_lm(
        "qwen3-32b", "train_4k", {"seq_shard": True}),
    "granite8b_train_seqshard_mem": lambda: measure_lm(
        "granite-8b", "train_4k", {"seq_shard": True}, mode="memory"),
    "qwen3_32b_train_fit_combo_mem": lambda: measure_lm(
        "qwen3-32b", "train_4k",
        {"remat_policy": "nothing", "seq_shard": True}, mode="memory"),
    "granite34b_train_fit_combo_mem": lambda: measure_lm(
        "granite-34b", "train_4k",
        {"remat_policy": "nothing", "seq_shard": True}, mode="memory"),
    "qwen2vl_train_fit_combo_mem": lambda: measure_lm(
        "qwen2-vl-7b", "train_4k",
        {"remat_policy": "nothing", "seq_shard": True}, mode="memory"),
    "zamba2_train_fit_combo_mem": lambda: measure_lm(
        "zamba2-7b", "train_4k",
        {"remat_policy": "nothing", "seq_shard": True}, mode="memory"),
    "zamba2_train_fit_dots_mem": lambda: measure_lm(
        "zamba2-7b", "train_4k",
        {"seq_shard": True, "ssm_chunk": 64}, mode="memory"),
    "phi35_train_fit_combo_mem": lambda: measure_lm(
        "phi3.5-moe-42b-a6.6b", "train_4k",
        {"remat_policy": "nothing", "seq_shard": True, "moe_ep": True},
        mode="memory", multi_pod=True),

    # -- cell 3: worst-fraction cell (filled from the roofline table) -----
    "zamba2_prefill_baseline": lambda: measure_lm(
        "zamba2-7b", "prefill_32k", {}),
    "zamba2_prefill_chunk512": lambda: measure_lm(
        "zamba2-7b", "prefill_32k", {"ssm_chunk": 512}),
    "zamba2_prefill_chunk256": lambda: measure_lm(
        "zamba2-7b", "prefill_32k", {"ssm_chunk": 256}),
    "deepseek_train_baseline": lambda: measure_lm(
        "deepseek-v2-lite-16b", "train_4k", {}),
    "deepseek_train_ep": lambda: measure_lm(
        "deepseek-v2-lite-16b", "train_4k", {"moe_ep": True}),
    "phi35_train_ep": lambda: measure_lm(
        "phi3.5-moe-42b-a6.6b", "train_4k", {"moe_ep": True}),
    "deepseek_decode_baseline": lambda: measure_lm(
        "deepseek-v2-lite-16b", "decode_32k", {}),
    "deepseek_decode_absorb": lambda: measure_lm(
        "deepseek-v2-lite-16b", "decode_32k", {"mla_absorb": True}),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--exp", nargs="*", default=None)
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out", default=RESULTS)
    args = ap.parse_args(argv)

    if args.list:
        for name in EXPERIMENTS:
            print(name)
        return 0

    names = args.exp or list(EXPERIMENTS)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    rc = 0
    for name in names:
        print(f"[hillclimb] {name} ...", flush=True)
        rec = {"experiment": name,
               "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S")}
        try:
            rec.update(EXPERIMENTS[name]())
            rec["status"] = "ok"
            coll = rec.get("collectives", {}).get("total", 0.0)
            print(f"[hillclimb] {name}: flops/dev={rec['flops_per_device']:.3e} "
                  f"bytes/dev={rec['bytes_per_device']:.3e} coll={coll:.3e}B "
                  f"trace={rec['trace_s']}s", flush=True)
        except Exception:
            rec.update(status="error", error=traceback.format_exc()[-3000:])
            print(f"[hillclimb] {name}: ERROR", flush=True)
            rc = 1
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
