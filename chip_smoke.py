#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (each raises on failure, and the script then exits non-zero):

1. environment — torch version, the card, its name and power limit;
2. build — ``nvcc`` builds the CUDA WFA kernel from ``csrc/wfa.cu``;
3. kernel vs plain — the CUDA kernel against its plain PyTorch version on
   the card, over {GapAffine(4,6,2), GapLinear, Edit} x {exact,
   AdaptiveBand, ZDrop} x {score, trace}, on one wave of 4,096 pairs of
   100 bp at E = 2% with pass-1 bounds and on one exact-bound bucket
   (``k_pad`` 384): scores and steps equal, trace words bit-equal; then
   both timed at the main path's wave shape (65,536 pairs);
4. main path — ``repro_torch.launch.align.main`` with ``--backend kernel``
   on 262,144 pairs (``--mode both --verify 512``) and with ``--output
   cigar`` on 65,536 pairs; the kernel's launch counts must rise; then the
   ``ring`` backend on the same pairs must give the same scores;
5. report — a ``kernels`` JSON line, the card's name and power limit, and
   the final ``{"ok": true, ...}`` line.

It needs one card and exits non-zero without one.  It imports nothing of
JAX or of the JAX package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

PAIRS = 262144          # main path: four waves of the engine's default size
WAVE = 65536            # the engine's default wave (chunk_pairs)
GRID_PAIRS = 4096
READ_LEN = 100
EDIT_FRAC = 0.02
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
INT32_OPS_PER_S = 16.7e12      # 132 SMs x 64 INT32 lanes x 1.98 GHz


def log(*a):
    print(*a, flush=True)


def gpu_name_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` from CUDA events, after one warmup."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b) -> int:
    """Largest |kernel - plain| over a tuple of int tensors (raises on a
    shape mismatch)."""
    err = 0
    for x, y in zip(a, b, strict=True):
        if x.shape != y.shape:
            raise AssertionError(f"shape {tuple(x.shape)} != "
                                 f"{tuple(y.shape)}")
        err = max(err, int((x.long() - y.long()).abs().max().item()))
    return err


def wave_inputs(P, plen, T, tlen, n, width, dev):
    """The tensors the engine hands the kernel for ``n`` pairs."""
    import numpy as np
    import torch
    from repro_torch.core.engine import _fit_width
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return (to(_fit_width(P[:n], width)), to(_fit_width(T[:n], width)),
            to(plen[:n, None]), to(tlen[:n, None]))


def torch_sync():
    import torch
    torch.cuda.synchronize()


def phase_grid(K, S, eng_for, P, plen, T, tlen, dev):
    """Phase 3: CUDA kernel vs plain version on the grid -> max |err|."""
    width = 128
    args = wave_inputs(P, plen, T, tlen, GRID_PAIRS, width, dev)
    models = (S.GapAffine(4, 6, 2), S.GapLinear(), S.Edit())
    heurs = (None, S.AdaptiveBand(), S.AdaptiveBand(10, 4), S.ZDrop(),
             S.ZDrop(8))
    worst = 0
    for exact in (False, True):
        for pen in models:
            eng = eng_for(pen)
            s_max, k_max = eng._bounds_for_bucket(
                width, plen[:GRID_PAIRS], tlen[:GRID_PAIRS], exact)
            k_pad = -(-(2 * k_max + 1) // 128) * 128
            for heur in heurs:
                for trace in (False, True):
                    kw = dict(pen=pen, s_max=s_max, k_pad=k_pad,
                              block_pairs=8, trace=trace, heur=heur)
                    got = K.wfa_cuda(*args, **kw)
                    torch_sync()
                    want = K.wfa_plain(*args, **kw)
                    err = max_abs_err(got, want)
                    worst = max(worst, err)
                    if err:
                        raise AssertionError(
                            f"kernel != plain: {pen} {heur} trace={trace} "
                            f"k_pad={k_pad} max|err|={err}")
                    k_ms = cuda_ms(lambda: K.wfa_cuda(*args, **kw), 3)
                    p_ms = cuda_ms(lambda: K.wfa_plain(*args, **kw), 1)
                    log(f"[grid] {type(pen).__name__:9s} "
                        f"{str(heur or 'exact'):44s} "
                        f"{'trace' if trace else 'score'} s_max={s_max:3d} "
                        f"k_pad={k_pad}: equal; kernel {k_ms:8.3f} ms, "
                        f"plain {p_ms:9.3f} ms")
    return worst


def phase_wave_timing(K, S, eng, P, plen, T, tlen, dev):
    """Phase 3b: both variants at the main path's wave shape (65,536 pairs
    of pass 1, GapAffine, exact) -> per-variant timing records."""
    import numpy as np
    width = 128
    args = wave_inputs(P, plen, T, tlen, WAVE, width, dev)
    s_max, k_max = eng._bounds_for_bucket(width, plen[:WAVE], tlen[:WAVE],
                                          False)
    k_pad = -(-(2 * k_max + 1) // 128) * 128
    # least bytes the function needs on these inputs: each int32 character
    # of a sequence up to its length (the padding columns of the rows are
    # never read) and each pair's two lengths, read once
    lens = plen[:WAVE].astype(np.int64) + tlen[:WAVE]
    in_bytes = 4 * int(lens.sum()) + 2 * 4 * WAVE
    # least work: one comparison per aligned column, min(plen, tlen) per pair
    ops = int(np.minimum(plen[:WAVE], tlen[:WAVE]).astype(np.int64).sum())
    out = {}
    for trace in (False, True):
        kw = dict(pen=eng.pen, s_max=s_max, k_pad=k_pad, block_pairs=8,
                  trace=trace, heur=None)
        got = K.wfa_cuda(*args, **kw)
        torch_sync()
        want = K.wfa_plain(*args, **kw)
        err = max_abs_err(got, want)
        if err:
            raise AssertionError(f"kernel != plain at the wave shape "
                                 f"(trace={trace}): max|err|={err}")
        out_bytes = sum(t.numel() * t.element_size() for t in got)
        k_ms = cuda_ms(lambda: K.wfa_cuda(*args, **kw), 20)
        p_ms = cuda_ms(lambda: K.wfa_plain(*args, **kw), 2)
        bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / INT32_OPS_PER_S * 1e3
        name = "wfa_trace" if trace else "wfa_score"
        out[name] = dict(
            max_abs_err=err, ms=k_ms, plain_ms=p_ms,
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        log(f"[wave] {name}: {WAVE} pairs, s_max={s_max} k_pad={k_pad}: "
            f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound "
            f"{max(bytes_ms, ops_ms):.4f} ms ({out[name]['bound_by']}: "
            f"{in_bytes + out_bytes} bytes, {ops} compares)")
    return out


def phase_main_path(K):
    """Phase 4: the launcher on the kernel backend, then on ring."""
    import numpy as np
    from repro_torch.launch import align

    common = ["--pairs", str(PAIRS), "--read-len", str(READ_LEN),
              "--edit-frac", str(EDIT_FRAC), "--chunk-pairs", str(WAVE),
              "--mode", "both", "--verify", "512", "--device", "cuda"]
    K.reset_launches()
    kern = {}
    t0 = time.perf_counter()
    if align.main(["--backend", "kernel", *common], kern) != 0:
        raise AssertionError("launcher failed on the kernel backend")
    cig = {}
    if align.main(["--backend", "kernel", "--output", "cigar",
                   "--pairs", str(WAVE), "--chunk-pairs", str(WAVE),
                   "--mode", "both", "--verify", "512", "--device", "cuda"],
                  cig) != 0:
        raise AssertionError("launcher failed on the CIGAR path")
    launches = dict(K.LAUNCHES)
    log(f"[main] kernel backend + cigar path in "
        f"{time.perf_counter() - t0:.1f}s; launches {launches}")
    if launches["score"] == 0 or launches["trace"] == 0:
        raise AssertionError(f"the main path missed a kernel: {launches}")
    if kern.get("verified") != 512 or cig.get("verified") != 512:
        raise AssertionError("the launcher did not verify 512 pairs")
    ring = {}
    if align.main(["--backend", "ring", *common], ring) != 0:
        raise AssertionError("launcher failed on the ring backend")
    if not np.array_equal(kern["scores"], ring["scores"]):
        n = int((kern["scores"] != ring["scores"]).sum())
        raise AssertionError(f"kernel and ring scores differ on {n} pairs")
    log(f"[main] kernel and ring scores equal on {PAIRS} pairs")
    return launches, kern, ring, cig


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on a card",
              file=sys.stderr)
        return 2
    from repro_torch.core import scoring as S
    from repro_torch.core.engine import AlignmentEngine
    from repro_torch.data.reads import ReadPairSpec, generate_pairs
    from repro_torch.kernels.wfa import build
    from repro_torch.kernels.wfa import kernel as K

    # 1. environment
    card = gpu_name_power()
    dev = torch.device("cuda")
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; {card}")

    # 2. build
    t0 = time.perf_counter()
    build.load()
    log(f"[build] {os.path.relpath(build.SOURCE, ROOT)} -> "
        f"{os.path.relpath(build.BUILD_INFO['path'], ROOT)} in "
        f"{time.perf_counter() - t0:.1f}s")

    # 3. kernel vs plain on the card
    P, plen, T, tlen = generate_pairs(ReadPairSpec(
        n_pairs=WAVE, read_len=READ_LEN, edit_frac=EDIT_FRAC, seed=0))
    eng_for = lambda pen: AlignmentEngine(pen, backend="kernel",
                                          edit_frac=EDIT_FRAC, device=dev)
    worst = phase_grid(K, S, eng_for, P, plen, T, tlen, dev)
    timing = phase_wave_timing(K, S, eng_for(S.GapAffine(4, 6, 2)), P, plen,
                               T, tlen, dev)

    # 4. main path
    launches, kern, ring, cig = phase_main_path(K)
    # Total: pairs over wall clock (streamed and blocking runs); Kernel:
    # pairs over the kernel phase of the blocking run, timed by CUDA events
    # (a streamed run only sees the wait left at retirement)
    for name, run in (("kernel", kern), ("ring", ring),
                      ("kernel/cigar", cig)):
        s, st = run["sync"], run["stream"]
        log(f"[main] {name:12s}: Total {st['total_pairs_per_s']:,.0f} "
            f"pairs/s streamed, {s['total_pairs_per_s']:,.0f} blocking; "
            f"Kernel {s['kernel_pairs_per_s']:,.0f} pairs/s (overflow "
            f"{s['n_overflow']}, recovered {s['n_recovered']}) on {card}")
    ratio = (kern["sync"]["kernel_pairs_per_s"]
             / ring["sync"]["kernel_pairs_per_s"])
    log(f"[main] Kernel pairs/s, kernel / ring backend: {ratio:.1f}x on "
        f"{card}")

    # 5. report
    src = "src/repro_torch/kernels/wfa/csrc/wfa.cu"
    kernels = []
    for name, variant in (("wfa_score", "score"), ("wfa_trace", "trace")):
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": "src/repro/kernels/wfa/kernel.py:334",
            "launches": launches[variant],
            "max_abs_err": max(worst, t["max_abs_err"]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
