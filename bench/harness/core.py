"""One run of one cell: set-up, the measured window, the check, the line.

    python3 bench/run.py --workload NAME --seed N --seconds S --trace 0|1

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with the
reference beside its limit, which the last lines of standard error repeat.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time
from typing import List, Optional

from harness import spec as spec_mod

# top-level module names the measured process must never hold: JAX and the
# JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

# every build and kernel cache at a fixed path inside the checkout
CACHE_ENV = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR":
             "torch_extensions", "CUDA_CACHE_PATH": "cuda"}


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN`, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# glibc's mallopt parameters (malloc.h)
_M_TRIM_THRESHOLD, _M_TOP_PAD, _M_MMAP_MAX = -1, -2, -4


def tune_allocator() -> bool:
    """Serve large host blocks from glibc's heap and keep what is freed
    there, so that the tens of MB a chunk the program allocates and frees
    reuse pages already mapped instead of faulting fresh ones in; the
    latter cost a varying share of each run on the card's machine.
    Returns False where the C library is not glibc (nothing changed)."""
    import ctypes
    try:
        mallopt = ctypes.CDLL("libc.so.6").mallopt
    except (OSError, AttributeError):
        return False
    return all(mallopt(k, v) == 1 for k, v in (
        (_M_MMAP_MAX, 0), (_M_TRIM_THRESHOLD, 2 ** 31 - 1),
        (_M_TOP_PAD, 256 << 20)))


def set_cache_dirs(root: str) -> None:
    for var, sub in CACHE_ENV.items():
        os.environ[var] = os.path.join(root, ".bench_cache", sub)


def e2e_metrics(rec, metrics: List[dict]) -> dict:
    """The cell's end-to-end metrics from the run's record (host clock and
    the device's allocator)."""
    import numpy as np
    vals = {"pairs_per_s": lambda: rec.window_pairs / rec.seconds,
            "request_p95_ms": lambda: float(
                np.percentile(rec.latencies_s, 95) * 1e3)
            if rec.latencies_s.size else None,
            "peak_device_mib": lambda: rec.peak_window_bytes / 2 ** 20,
            "setup_s": lambda: rec.setup_s}
    out = {m["name"]: {"value": vals[m["name"]](), "unit": m["unit"]}
           for m in metrics}
    return {k: v for k, v in out.items() if v["value"] is not None}


def layer_metrics(rec, metrics: List[dict], root: str) -> dict:
    out = {}
    for m in metrics:
        v = spec_mod.reader(m["name"], root)(rec)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", root: str = spec_mod.ROOT,
             t_proc: Optional[float] = None, cell: Optional[dict] = None
             ) -> dict:
    """-> the result line's object.  ``cell`` (default: as the files give
    it) lets a test run a cell at a smaller size on the CPU."""
    t_proc = time.perf_counter() if t_proc is None else t_proc
    spec = spec_mod.load(root)
    cell = spec_mod.cell(spec, name, root) if cell is None else cell
    driver = importlib.import_module(f"harness.{cell['workload']['driver']}")
    rec = driver.run(cell, seed % (1 << 64), seconds, trace, device, t_proc)
    correct = all((c["value"] <= c["limit"]) if c["rule"] == "<="
                  else (c["value"] >= c["limit"])
                  for c in rec.checks.values())
    out = {"correct": bool(correct), "attempted": rec.attempted,
           "failed": rec.failed}
    if trace:
        out["metrics"] = layer_metrics(rec, spec_mod.per_layer(spec, name),
                                       root)
    else:
        out["metrics"] = e2e_metrics(rec, spec_mod.end_to_end(spec, name))
    if device.startswith("cuda"):
        import torch
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": 1, "memory_peak_bytes": int(rec.memory_peak_bytes)}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    if trace and rec.dev is not None:
        dev.update(rec.dev)
    out["device"] = dev
    if trace and rec.breakdown is not None:
        out["breakdown"] = rec.breakdown
    out["checks"] = rec.checks
    return out


def main(argv=None, t_proc: Optional[float] = None) -> int:
    t_proc = time.perf_counter() if t_proc is None else t_proc
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = spec_mod.ROOT
    spec = spec_mod.load(root)
    entry = {w["name"]: w for w in spec["workloads"]}.get(args.workload)
    if entry is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    set_cache_dirs(root)
    tune_allocator()
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < entry["chips"]:
        print(f"the cell needs {entry['chips']} CUDA device(s); found "
              f"{found}", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   device="cuda", root=root, t_proc=t_proc)
    bad = forbidden_modules()
    if bad:
        print(f"the measured process loaded {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['rule']} {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
