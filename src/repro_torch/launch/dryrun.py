"""Multi-pod dry-run (the JAX package's ``launch/dryrun.py``): every
(arch x shape x mesh) cell traced on a 256- or 512-rank fake process group,
its roofline quantities and per-device memory appended to a JSONL file.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape train_4k --mesh single

It needs no card: ``launch/lowering.py``'s trace runs on the CPU on meta
tensors (the ``wfa-paper`` cells on real local data).  Each cell makes and
destroys its own fake group, so importing this module sets nothing up.
Records go to ``results/torch_dryrun/cells.jsonl``; ``analysis.roofline``
and ``analysis.report`` read them.

Where the JAX package lowers scan-rolled layers and extrapolates the
roofline pass from three shallow depths, a torch trace runs every layer,
so :func:`run_cell` traces at full depth; :func:`roofline_depths` and
:func:`_fit_quadratic` stay for ``hillclimb``'s roofline measurements.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import numpy as np

from repro_torch.configs import ARCH_NAMES, get_config, wfa_paper
from repro_torch.launch.lowering import (build_lm_cell, build_wfa_cell,
                                         trace_cell)
from repro_torch.launch.mesh import make_production_mesh, mesh_devices
from repro_torch.models.common import SHAPES, model_flops
from repro_torch.tree import tree_leaves

RESULTS_DEFAULT = "results/torch_dryrun/cells.jsonl"


def mesh_tag(multi_pod: bool) -> str:
    return "pod2-2x16x16" if multi_pod else "pod1-16x16"


def analytic_device_bytes(cell) -> int:
    """Per-device bytes of the cell's arguments from their shard shapes
    (exact), in the JAX package's layout."""
    total = 0
    for arg, sh in zip(cell.args, cell.in_shardings):
        for t, s in zip(tree_leaves(arg), tree_leaves(sh)):
            n = int(np.prod(s.shard_shape(tuple(t.shape)), dtype=np.int64))
            total += n * t.element_size()
    return total


def measure(cell, mesh) -> dict:
    """Trace ``cell`` -> its record fields: the trace's counts, the exact
    argument bytes and the memory fields the fit table reads (arguments,
    and the peak above the traced arguments as temporaries)."""
    out = trace_cell(cell, mesh)
    arg = analytic_device_bytes(cell)
    out["analytic_arg_bytes_per_device"] = arg
    out["mem_argument_size_in_bytes"] = arg
    out["mem_temp_size_in_bytes"] = max(
        0, out["peak_bytes_per_device"] - out["traced_arg_bytes_per_device"])
    return out


def roofline_depths(cfg):
    """Three depths for the per-layer extrapolation.

    Layers are identical stacked blocks, so the roofline quantities are
    polynomial in depth (quadratic: the small quadratic term comes from
    the optimizer's global norm and the like).  Three shallow traces
    determine the quadratic, evaluated at the production depth.  Hybrids
    use depths congruent to the production depth mod the shared-block
    period so the ragged tail segment appears identically in every point;
    MoE keeps its dense head layers fixed.
    """
    if cfg.family == "hybrid" and cfg.hybrid_attn_every:
        e = cfg.hybrid_attn_every
        r = cfg.n_layers % e
        return r + e, r + 2 * e, r + 4 * e
    head = cfg.first_k_dense if cfg.is_moe else 0
    return head + 2, head + 4, head + 8


def _fit_quadratic(depths, values, L):
    """Exact quadratic through three (depth, value) points, evaluated at L."""
    a = np.array([[1.0, d, d * d] for d in depths])
    coef = np.linalg.solve(a, np.asarray(values, float))
    return float(coef @ np.array([1.0, L, L * L]))


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             mode: str = "memory", skip_reason: str = "") -> dict:
    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_tag(multi_pod),
        "pass": mode,
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }
    if skip_reason:
        record.update(status="skipped", reason=skip_reason)
        return record

    mesh = make_production_mesh(multi_pod=multi_pod)
    n_dev = mesh_devices(mesh)
    record["mesh_shape"] = list(mesh.axis_sizes)
    try:
        if arch == "wfa-paper":
            ef = {"fig1_e2": 0.02, "fig1_e4": 0.04}[shape_name]
            cell = build_wfa_cell(wfa_paper, mesh, edit_frac=ef)
            record["model_flops"] = 0.0
        else:
            cfg = get_config(arch)
            shape = SHAPES[shape_name]
            record["model_flops"] = model_flops(cfg, shape)
            record["param_count"] = cfg.param_count()
            record["active_param_count"] = cfg.active_param_count()
            cell = build_lm_cell(cfg, shape, mesh, mode=mode)
        record.update(measure(cell, mesh))
        record.update(status="ok", n_devices=n_dev,
                      **{f"meta_{k}": v for k, v in cell.meta.items()})
    except Exception:
        record.update(status="error", error=traceback.format_exc()[-4000:])
    return record


def applicable_cells(archs, shapes, meshes, passes):
    for arch in archs:
        if arch == "wfa-paper":
            arch_shapes = ["fig1_e2", "fig1_e4"]
        else:
            arch_shapes = list(SHAPES)
        for shape_name in arch_shapes:
            if shapes and shape_name not in shapes:
                continue
            skip = ""
            if arch != "wfa-paper":
                cfg = get_config(arch)
                if (shape_name == "long_500k"
                        and not cfg.supports_long_context):
                    skip = ("quadratic full attention at 512k ctx; runs only "
                            "for ssm/hybrid archs")
            for multi_pod in meshes:
                for mode in (passes if arch != "wfa-paper" else ["memory"]):
                    # roofline numbers come from the single-pod mesh only
                    if mode == "roofline" and multi_pod:
                        continue
                    yield arch, shape_name, multi_pod, mode, skip


def load_done(path):
    done = {}
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                done[(r["arch"], r["shape"], r["mesh"],
                      r.get("pass", "memory"))] = r.get("status")
    return done


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-pod dry-run")
    ap.add_argument("--arch", nargs="*", default=None,
                    help="arch ids (default: all 10 + wfa-paper)")
    ap.add_argument("--shape", nargs="*", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--out", default=RESULTS_DEFAULT)
    ap.add_argument("--force", action="store_true",
                    help="re-run cells already recorded")
    ap.add_argument("--retry-errors", action="store_true")
    ap.add_argument("--pass", dest="passes", nargs="*",
                    choices=["memory", "roofline"],
                    default=["memory", "roofline"])
    args = ap.parse_args(argv)

    archs = args.arch or (ARCH_NAMES + ["wfa-paper"])
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    done = load_done(args.out)

    n_ok = n_err = n_skip = 0
    for arch, shape_name, multi_pod, mode, skip in applicable_cells(
            archs, args.shape, meshes, args.passes):
        key = (arch, shape_name, mesh_tag(multi_pod), mode)
        prev = done.get(key)
        if prev is not None and not args.force:
            if not (args.retry_errors and prev == "error"):
                continue
        print(f"[dryrun] {key} ...", flush=True)
        rec = run_cell(arch, shape_name, multi_pod, mode=mode,
                       skip_reason=skip)
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        status = rec["status"]
        n_ok += status == "ok"
        n_err += status == "error"
        n_skip += status == "skipped"
        extra = ""
        if status == "ok":
            extra = (f" flops/dev={rec['flops_per_device']:.3e}"
                     f" coll={rec['collectives']['total']:.3e}B"
                     f" peak={rec['peak_bytes_per_device'] / 1e9:.2f}GB"
                     f" trace={rec['trace_s']}s")
        elif status == "error":
            extra = " " + rec["error"].strip().splitlines()[-1][:160]
        print(f"[dryrun] {key} -> {status}{extra}", flush=True)

    print(f"[dryrun] done: ok={n_ok} err={n_err} skip={n_skip}")
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
