"""Three-term roofline from the dry-run's records (the JAX package's
``analysis/roofline.py``, on the H100's figures).

    compute    = FLOPs_per_device / peak_FLOP/s
    memory     = bytes_per_device / HBM_bw
    collective = collective_wire_bytes_per_card / link_bw

The terms come from ``launch/dryrun.py``'s traces (rank 0's local ops,
every layer).  Hardware: an NVIDIA H100 SXM at its 700 W power limit, the
published peaks: 989 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s HBM3
and 450 GB/s of NVLink each way.  The production mesh's ``model`` axis of
16 spans two 8-card NVLink hosts, and nothing in this repo measures the
network between hosts, so the collective term divides every byte by the
NVLink rate: it is a lower bound for such a mesh, and ``markdown`` marks
its rows.

MFU bound = model_flops / (cards * peak) / max(terms): the best model-FLOP
share this step could reach if everything else overlapped perfectly.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Optional

PEAK_FLOPS = 989e12          # bf16 dense / card
HBM_BW = 3.35e12             # B/s / card
LINK_BW = 450e9              # B/s / card, NVLink, each way
HOST_CARDS = 8               # cards one NVLink host joins

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k",
               "fig1_e2", "fig1_e4"]


def load(path: str) -> Dict:
    """Latest record per (arch, shape, mesh, pass)."""
    recs: Dict = {}
    with open(path) as f:
        for line in f:
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue
            key = (r["arch"], r["shape"], r["mesh"], r.get("pass", "memory"))
            recs[key] = r
    return recs


def attn_s2_traffic(arch: str, shape_name: str, n_devices: int) -> float:
    """Per-device HBM bytes of the materialised S^2 attention intermediates
    that a fused (flash) attention kernel keeps on chip.

    The unfused count round-trips, per layer: scores bf16 (write+read), the
    fp32 masked copy (write+read by softmax), softmax output fp32 (write) +
    bf16 cast (read+write), and the same again on the A@V side, plus one
    recompute under remat and the bwd chain for train: ~6 S^2-sized
    fp32-equivalent round-trips fwd-only, ~3x that for train.  The
    flash-corrected memory term subtracts this traffic (the flash kernel in
    ``kernels/flash_attention`` is the mechanism).  An arch or shape not
    in the configs has none.
    """
    from repro_torch.configs import get_config
    from repro_torch.models.common import SHAPES
    try:
        cfg = get_config(arch)
    except KeyError:
        return 0.0
    if cfg.is_attn_free or shape_name not in SHAPES:
        return 0.0
    shape = SHAPES[shape_name]
    if shape.kind == "decode":
        return 0.0                       # one-token scores are not S^2
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // max(1, cfg.hybrid_attn_every)
    else:
        n_attn = cfg.n_layers
    heads = cfg.n_heads
    s2 = float(B) * heads * float(S) * float(S)
    per_layer = 6.0 * 4.0 * s2           # ~6 fp32-equivalent round-trips
    total = per_layer * n_attn
    if cfg.family == "encdec":
        total += per_layer * cfg.enc_layers * (cfg.enc_frames / S) ** 2
    if shape.kind == "train":
        total *= 3.0                     # bwd + remat recompute chains
    return total / n_devices


def terms(rec: dict) -> Optional[dict]:
    if rec.get("status") != "ok":
        return None
    n = rec["n_devices"]
    t_c = rec["flops_per_device"] / PEAK_FLOPS
    t_m = rec["bytes_per_device"] / HBM_BW
    t_x = rec["collectives"]["total"] / LINK_BW
    flash_bytes = max(0.0, rec["bytes_per_device"]
                      - attn_s2_traffic(rec["arch"], rec["shape"], n))
    t_mf = flash_bytes / HBM_BW
    dom = max((t_c, "compute"), (t_mf, "memory"), (t_x, "collective"))
    mf = rec.get("model_flops") or 0.0
    hlo_global = rec["flops_per_device"] * n
    out = {
        "compute_s": t_c, "memory_s": t_m, "memory_flash_s": t_mf,
        "collective_s": t_x,
        "dominant": dom[1], "bound_s": dom[0],
        "model_flops": mf,
        "model_over_hlo": (mf / hlo_global) if hlo_global > 0 else 0.0,
        "mfu_bound": (mf / n / PEAK_FLOPS / dom[0]) if mf and dom[0] > 0 else 0.0,
        "n_devices": n,
    }
    return out


def lever_sentence(rec: dict, t: dict) -> str:
    kind = rec.get("meta_kind", "?")
    dom = t["dominant"]
    if dom == "collective":
        if kind == "align":
            return ("per-shard termination (shard_map) removes the lock-step "
                    "any() all-reduce")
        return ("reshard to cut the per-layer TP collective volume, or "
                "overlap it with the next layer's compute")
    if dom == "memory":
        if kind == "decode":
            return ("KV/state cache traffic bound: quantize the cache or "
                    "raise decode batch to amortize weight reads")
        return ("HBM-bound: fuse elementwise chains and raise arithmetic "
                "intensity (bigger per-chip tiles)")
    if t["model_over_hlo"] < 0.5 and kind == "train":
        return ("compute-bound with low useful-FLOP ratio: cut remat "
                "recompute and attention-waste first, then scale batch")
    return "compute-bound near roofline: scale batch/chips or quantize"


def fmt_seconds(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x * 1e6:.1f}µs"
    if x < 1:
        return f"{x * 1e3:.2f}ms"
    return f"{x:.2f}s"


def _crosses_hosts(rec: dict) -> bool:
    """Whether a group of the record's mesh spans more than one NVLink host
    (the collective term is then a lower bound)."""
    return any(int(n) > HOST_CARDS for n in rec.get("mesh_shape", []))


def _approx(rec: dict) -> str:
    """"~" where the trace held other argument bytes than the cell's
    shard shapes give (a stacked leaf's shard it could not place on a
    layer): its peak and collectives are then approximate."""
    traced = rec.get("traced_arg_bytes_per_device")
    exact = rec.get("analytic_arg_bytes_per_device")
    return " ~" if None not in (traced, exact) and traced != exact else ""


def markdown(recs: Dict, mesh: str = "pod1-16x16") -> str:
    """The roofline table; a collective time marked ``≥`` divides bytes
    that cross hosts by the NVLink rate (a lower bound), a shape marked
    ``~`` is approximate (:func:`_approx`)."""
    lines = [
        "| arch | shape | compute | memory(raw) | memory(flash) | collective "
        "| dominant | MODEL/TRACE | MFU bound | lever |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    archs = sorted({k[0] for k in recs})
    for arch in archs:
        shapes = sorted({k[1] for k in recs if k[0] == arch},
                        key=lambda s: SHAPE_ORDER.index(s)
                        if s in SHAPE_ORDER else 99)
        for shape in shapes:
            r = recs.get((arch, shape, mesh, "roofline")) or \
                recs.get((arch, shape, mesh, "memory"))
            if r is None:
                continue
            if r.get("status") == "skipped":
                lines.append(f"| {arch} | {shape} | — | — | — | — | skipped "
                             f"| — | — | {r.get('reason', '')[:60]} |")
                continue
            t = terms(r)
            if t is None:
                lines.append(f"| {arch} | {shape} | — | — | — | — | ERROR | —"
                             f" | — | see dry-run log |")
                continue
            ratio = f"{t['model_over_hlo']:.2f}" if t["model_flops"] else "n/a"
            mfu = f"{t['mfu_bound']:.1%}" if t["model_flops"] else "n/a"
            bound = "≥" if _crosses_hosts(r) and t["collective_s"] else ""
            lines.append(
                f"| {arch} | {shape}{_approx(r)} "
                f"| {fmt_seconds(t['compute_s'])} "
                f"| {fmt_seconds(t['memory_s'])} "
                f"| {fmt_seconds(t['memory_flash_s'])} "
                f"| {bound}{fmt_seconds(t['collective_s'])} | {t['dominant']} "
                f"| {ratio} | {mfu} | {lever_sentence(r, t)} |")
    return "\n".join(lines)


def fit_table(recs: Dict) -> str:
    """Memory-pass per-device sizes vs the H100's 80 GB (a shape marked
    ``~``: :func:`_approx`)."""
    lines = [
        "| arch | shape | mesh | args/dev | temps/dev | total/dev | fits 80GB? |",
        "|---|---|---|---|---|---|---|",
    ]
    for (arch, shape, mesh, p), r in sorted(recs.items()):
        if p != "memory" or r.get("status") != "ok":
            continue
        arg = r.get("mem_argument_size_in_bytes", 0)
        tmp = r.get("mem_temp_size_in_bytes", 0)
        alias = r.get("mem_alias_size_in_bytes", 0)
        tot = arg + tmp - alias + r.get("mem_output_size_in_bytes", 0)
        ok = "YES" if tot < 80e9 else "**NO**"
        lines.append(f"| {arch} | {shape}{_approx(r)} | {mesh} "
                     f"| {arg / 1e9:.2f}GB "
                     f"| {tmp / 1e9:.2f}GB | {tot / 1e9:.2f}GB | {ok} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--in", dest="inp", default="results/torch_dryrun/cells.jsonl")
    ap.add_argument("--mesh", default="pod1-16x16")
    ap.add_argument("--fit", action="store_true",
                    help="emit the memory-fit table instead")
    args = ap.parse_args(argv)
    recs = load(args.inp)
    print(fit_table(recs) if args.fit else markdown(recs, args.mesh))
    return 0


if __name__ == "__main__":
    sys.exit(main())
