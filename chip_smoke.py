#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (each raises on failure, and the script then exits non-zero):

1. environment — torch version, the card, its name and power limit;
2. build — ``nvcc`` builds the CUDA kernels from ``csrc/wfa.cu`` and
   ``csrc/wfa_meet.cu``, one process per source, started together;
3. kernel vs plain — the CUDA WFA kernel against its plain PyTorch version
   on the card, over {GapAffine(4,6,2), GapLinear, Edit} x {exact,
   AdaptiveBand, ZDrop} x {score, trace}, on one wave of 4,096 pairs of
   100 bp at E = 2% with pass-1 bounds and on one exact-bound bucket
   (``k_pad`` 384): scores and steps equal, trace words bit-equal; then
   both timed at the main path's wave shape (65,536 pairs);
4. meet kernel vs plain — the CUDA meet kernel against its plain version
   over {GapAffine(4,6,2), GapLinear, Edit} x {exact, AdaptiveBand(10,4),
   ZDrop(8)} x boundary states ((M,M); (I,D) and (D,M) for affine) on the
   same 4,096 pairs, all eight outputs equal; then one meet wave at the
   BiWFA path's root shape (1,024 pairs of 10 kb at E = 3%), compared and
   timed;
5. main path — ``repro_torch.launch.align.main`` with ``--backend kernel``
   on 262,144 pairs (``--mode both --verify 512``) and with ``--output
   cigar`` on 65,536 pairs; the kernel's launch counts must rise; then the
   ``ring`` backend on the same pairs must give the same scores;
6. BiWFA path — the launcher with ``--output cigar --trace bidir`` on
   1,024 pairs of 10 kb at E = 3% (``--mode both --verify 4``); the meet,
   score and trace kernels must each launch, no meet may go unmet or fall
   back, the scores must equal an ``--output score`` run of the same
   pairs, and block 0 of every meet wave the path launched must equal the
   plain version on the same rows;
7. report — a ``kernels`` JSON line, the card's name and power limit, and
   the final ``{"ok": true, ...}`` line.

It needs one card and exits non-zero without one.  It imports nothing of
JAX or of the JAX package.
"""
from __future__ import annotations

import json
import os
import re
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
# the BiWFA path: the JAX package's long-read headline row
# (benchmarks/longread.py: L = 10 kb at E = 3%, wfa_paper.pen)
LONG_PAIRS = 1024
LONG_LEN = 10000
LONG_EDIT = 0.03
LONG_BUCKET = 16384     # the engine's power-of-two bucket for 10 kb pairs
ROOT_PLAIN_PAIRS = 8    # the root wave's plain version runs on one block
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


def meet_args(P, plen, T, tlen, starget, dev):
    """The padded tensors the meet wrapper hands the meet kernel."""
    import torch
    from repro_torch.core.wavefront import _reverse_rows
    from repro_torch.kernels.wfa import ops
    pp, tt, pl, tl, B = ops._prep(P, T, plen, tlen, 8, dev)
    st = torch.as_tensor(starget, device=dev).to(torch.int32).reshape(-1, 1)
    st = torch.nn.functional.pad(st, (0, 0, 0, pp.shape[0] - B))
    return (pp, tt, _reverse_rows(pp, pl[:, 0]), _reverse_rows(tt, tl[:, 0]),
            pl, tl, st)


def meet_bounds(eng, pen, width, plen, tlen, starget):
    """(s_max, k_pad) of a meet wave: the BiWFA driver's score cap and the
    engine's bounds under it."""
    from repro_torch.core.engine import _round_up
    from repro_torch.core.wavefront import meet_window
    o = pen.o if pen.kind == "affine" else 0
    cap = _round_up((int(max(starget.max(), 0)) + o) // 2 + meet_window(pen)
                    + 2, 32)
    s_max, k_max = eng._bounds_for_bucket(width, plen, tlen, True, pen=pen,
                                          s_cap=cap)
    return s_max, _round_up(2 * k_max + 1, 128)


def phase_meet_grid(K, S, eng_for, P, plen, T, tlen, dev):
    """Phase 4: CUDA meet kernel vs plain on the grid -> max |err|.

    ``starget`` is each pair's cost: from the score kernel for (M, M) and,
    since that kernel has no boundary states, from the plain packed solver
    under the states for (I, D) and (D, M)."""
    import numpy as np
    from repro_torch.core import wavefront as wf
    width = 128
    n = GRID_PAIRS
    P, plen, T, tlen = P[:n], plen[:n], T[:n], tlen[:n]
    score_args = wave_inputs(P, plen, T, tlen, n, width, dev)
    worst = 0
    for pen in (S.GapAffine(4, 6, 2), S.GapLinear(), S.Edit()):
        eng = eng_for(pen)
        s1, k1 = eng._bounds_for_bucket(width, plen, tlen, True)
        states_all = ((("M", "M"), ("I", "D"), ("D", "M"))
                      if pen.kind == "affine" else (("M", "M"),))
        for heur in (None, S.AdaptiveBand(10, 4), S.ZDrop(8)):
            for states in states_all:
                if states == ("M", "M"):
                    st = K.wfa_cuda(*score_args, pen=pen, s_max=s1,
                                    k_pad=-(-(2 * k1 + 1) // 128) * 128,
                                    block_pairs=8, heur=heur)[0][:, 0]
                else:
                    st = wf.wfa_scores_packed(
                        P, T, plen, tlen, pen=pen, s_max=s1, k_max=k1,
                        heur=heur, begin_state=states[0],
                        end_state=states[1], device=dev).score
                st = st.cpu().numpy()
                s_max, k_pad = meet_bounds(eng, pen, width, plen, tlen, st)
                args = meet_args(P, plen, T, tlen, st, dev)
                kw = dict(pen=pen, s_max=s_max, k_pad=k_pad, block_pairs=8,
                          heur=heur, begin_state=states[0],
                          end_state=states[1])
                got = K.wfa_meet_cuda(*args, **kw)
                torch_sync()
                want = K.wfa_meet_plain(*args, **kw)
                err = max_abs_err(got, want)
                worst = max(worst, err)
                if err:
                    raise AssertionError(
                        f"meet kernel != plain: {pen} {heur} {states} "
                        f"s_max={s_max} k_pad={k_pad} max|err|={err}")
                met = int((got[0][:n] >= 0).sum())
                log(f"[meet] {type(pen).__name__:9s} "
                    f"{str(heur or 'exact'):44s} {''.join(states)} "
                    f"s_max={s_max:3d} k_pad={k_pad}: equal; met {met}/{n}")
    return worst


def phase_meet_root(K, S, dev):
    """Phase 4b: one meet wave at the BiWFA path's root shape -> timing
    record.  starget comes from the score kernel at pass-1 bounds; the
    plain version runs on the first ROOT_PLAIN_PAIRS pairs (blocks are
    independent, so those rows of the kernel's full run must equal it)."""
    import numpy as np
    from repro_torch.core.engine import AlignmentEngine
    from repro_torch.core.wavefront import meet_window
    from repro_torch.data.reads import ReadPairSpec, generate_pairs
    P, plen, T, tlen = generate_pairs(ReadPairSpec(
        n_pairs=LONG_PAIRS, read_len=LONG_LEN, edit_frac=LONG_EDIT, seed=0))
    pen = S.GapAffine(4, 6, 2)
    eng = AlignmentEngine(pen, backend="kernel", edit_frac=LONG_EDIT,
                          device=dev)
    s1, k1 = eng._bounds_for_bucket(LONG_BUCKET, plen, tlen, False)
    sargs = wave_inputs(P, plen, T, tlen, LONG_PAIRS,
                        max(P.shape[1], T.shape[1]), dev)
    st = K.wfa_cuda(*sargs, pen=pen, s_max=s1,
                    k_pad=-(-(2 * k1 + 1) // 128) * 128,
                    block_pairs=8)[0][:, 0].cpu().numpy()
    if (st < 0).any():
        raise AssertionError("the score pass left root pairs unresolved")
    s_max, k_pad = meet_bounds(eng, pen, LONG_BUCKET, plen, tlen, st)
    args = meet_args(P, plen, T, tlen, st, dev)
    kw = dict(pen=pen, s_max=s_max, k_pad=k_pad, block_pairs=8)
    got = K.wfa_meet_cuda(*args, **kw)
    torch_sync()
    n = ROOT_PLAIN_PAIRS
    t0 = time.perf_counter()
    want = K.wfa_meet_plain(*(a[:n] for a in args), **kw)
    torch_sync()
    p_ms = (time.perf_counter() - t0) * 1e3
    err = max_abs_err(tuple(g[:n] for g in got), want)
    if err:
        raise AssertionError(f"meet kernel != plain at the root shape: "
                             f"max|err|={err}")
    k_ms = cuda_ms(lambda: K.wfa_meet_cuda(*args, **kw), 3)
    k_ms_n = cuda_ms(lambda: K.wfa_meet_cuda(*(a[:n] for a in args), **kw),
                     3)
    # least bytes: each int32 character of the forward and reversed
    # sequences up to its length, plen / tlen / starget read once, the
    # eight outputs written once; least work: one compare per aligned
    # column, min(plen, tlen) per pair
    lens = plen.astype(np.int64) + tlen
    nbytes = 2 * 4 * int(lens.sum()) + 3 * 4 * LONG_PAIRS \
        + 8 * 4 * LONG_PAIRS
    ops = int(np.minimum(plen, tlen).astype(np.int64).sum())
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    met = int((got[0] >= 0).sum())
    steps = int(got[1].max())
    wd = meet_window(pen)
    log(f"[meet] root wave: {LONG_PAIRS} pairs of {LONG_LEN} bp, cost "
        f"{int(st.min())}-{int(st.max())}, s_max={s_max} k_pad={k_pad}, "
        f"scratch {wd}x8x{k_pad} x7 rings x "
        f"{LONG_PAIRS // 8} blocks = "
        f"{7 * wd * 8 * k_pad * 4 * LONG_PAIRS // 8:,} "
        f"bytes; met {met}/{LONG_PAIRS}, exit step <= {steps}")
    log(f"[meet] root wave: kernel {k_ms:.3f} ms ({k_ms_n:.3f} ms on the "
        f"first {n} pairs), plain {p_ms:.1f} ms on the first {n} pairs "
        f"(equal), bound {max(bytes_ms, ops_ms):.5f} ms "
        f"({'bytes' if bytes_ms >= ops_ms else 'operations'}: {nbytes} "
        f"bytes, {ops} compares)")
    return dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                ms_on_plain_inputs=k_ms_n, plain_pairs=n,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                s_max=s_max, k_pad=k_pad, pass1=(s1, k1))


def check_path_meet_waves(K, waves):
    """Hold block 0 of every meet wave the path launched against the plain
    version on the same rows (blocks are independent) -> max |err|."""
    worst = 0
    for i, (args, kw, got) in enumerate(waves):
        t0 = time.perf_counter()
        want = K.wfa_meet_plain(*args, **kw)
        err = max_abs_err(got, want)
        log(f"[bidir] meet wave {i}: rows of width {args[0].shape[1]}, "
            f"{kw['begin_state']}{kw['end_state']}, s_max={kw['s_max']} "
            f"k_pad={kw['k_pad']}: block 0 "
            f"{'equal' if not err else f'max|err|={err}'} "
            f"(plain {time.perf_counter() - t0:.1f}s)")
        if err:
            raise AssertionError(f"meet kernel != plain on the path's wave "
                                 f"{i}: max|err|={err}")
        worst = max(worst, err)
    return worst


def phase_bidir_path(K, root):
    """Phase 6: the BiWFA CIGAR path through the launcher, then the same
    pairs' --output score run -> (launches, summary, packed bytes, meet
    max |err|).  Block 0 of every meet wave the path launches is kept and
    held against the plain version after the run."""
    import numpy as np
    from repro_torch.core.wavefront import n_trace_words
    from repro_torch.launch import align

    common = ["--backend", "kernel", "--pairs", str(LONG_PAIRS),
              "--read-len", str(LONG_LEN), "--edit-frac", str(LONG_EDIT),
              "--device", "cuda"]
    waves, launch = [], K.wfa_meet_cuda

    def recording(*args, **kw):
        outs = launch(*args, **kw)
        bp = kw["block_pairs"]
        waves.append(([a[:bp].clone() for a in args], kw,
                      [o[:bp].clone() for o in outs]))
        return outs

    K.wfa_meet_cuda = recording
    K.reset_launches()
    bidir = {}
    t0 = time.perf_counter()
    try:
        rc = align.main([*common, "--output", "cigar", "--trace", "bidir",
                         "--mode", "both", "--verify", "4"], bidir)
    finally:
        K.wfa_meet_cuda = launch
    launches = dict(K.LAUNCHES)
    if rc != 0:
        raise AssertionError("launcher failed on the BiWFA path")
    log(f"[bidir] BiWFA path in {time.perf_counter() - t0:.1f}s; launches "
        f"{launches}")
    if min(launches.values()) == 0:
        raise AssertionError(f"the BiWFA path missed a kernel: {launches}")
    if bidir.get("verified") != 4:
        raise AssertionError("the BiWFA launcher did not verify 4 pairs")
    score = {}
    if align.main([*common, "--mode", "sync"], score) != 0:
        raise AssertionError("launcher failed on the score run")
    if not np.array_equal(bidir["scores"], score["scores"]):
        n = int((bidir["scores"] != score["scores"]).sum())
        raise AssertionError(f"BiWFA and score runs differ on {n} pairs")
    s1, k1 = root["pass1"]
    packed = (n_trace_words(s1) * LONG_PAIRS * (-(-(2 * k1 + 1) // 128) * 128)
              * 3 * 4)
    for mode in ("sync", "stream"):
        r = bidir[mode]
        log(f"[bidir] {mode}: n_meet_unmet={r['n_meet_unmet']} "
            f"n_bidir_fallback={r['n_bidir_fallback']} "
            f"peak_trace_bytes={r['peak_trace_bytes']:,} (the packed "
            f"backtrace of the same pairs at pass-1 bounds: {packed:,} "
            f"bytes, {packed / max(r['peak_trace_bytes'], 1):,.0f}x)")
        # a split the driver could not use falls back to the packed trace,
        # which would hide a wrong meet behind exact CIGARs
        if r["n_meet_unmet"] or r["n_bidir_fallback"]:
            raise AssertionError(f"the BiWFA path left meets unused ({mode}):"
                                 f" n_meet_unmet={r['n_meet_unmet']} "
                                 f"n_bidir_fallback={r['n_bidir_fallback']}")
    log(f"[bidir] scores equal the --output score run on {LONG_PAIRS} "
        f"pairs; every CIGAR re-scores exactly and consumes both sequences")
    err = check_path_meet_waves(K, waves)
    return launches, bidir, packed, err


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

    t_start = time.perf_counter()
    # 1. environment
    card = gpu_name_power()
    dev = torch.device("cuda")
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; {card}")

    # 2. build
    t0 = time.perf_counter()
    build.load()
    log(f"[build] {', '.join(os.path.relpath(p, ROOT) for p in build.SOURCES)}"
        f" -> {os.path.relpath(build.BUILD_INFO['path'], ROOT)} in "
        f"{time.perf_counter() - t0:.1f}s ({build.BUILD_INFO['cpu_seconds']:.1f}"
        f"s of compiler CPU: one nvcc after another would take at least "
        f"that)")
    ptxas = build.BUILD_INFO["log"]
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", ptxas)]
    spills = [int(b) for b in re.findall(r"(\d+) bytes spill stores", ptxas)]
    if regs:
        log(f"[build] ptxas: {len(regs)} kernels, <= {max(regs)} registers, "
            f"{sum(1 for b in spills if b)} with spill stores "
            f"(<= {max(spills, default=0)} bytes)")

    # 3. kernel vs plain on the card
    P, plen, T, tlen = generate_pairs(ReadPairSpec(
        n_pairs=WAVE, read_len=READ_LEN, edit_frac=EDIT_FRAC, seed=0))
    eng_for = lambda pen: AlignmentEngine(pen, backend="kernel",
                                          edit_frac=EDIT_FRAC, device=dev)
    worst = phase_grid(K, S, eng_for, P, plen, T, tlen, dev)
    timing = phase_wave_timing(K, S, eng_for(S.GapAffine(4, 6, 2)), P, plen,
                               T, tlen, dev)

    # 4. meet kernel vs plain on the card
    t0 = time.perf_counter()
    meet_worst = phase_meet_grid(K, S, eng_for, P, plen, T, tlen, dev)
    log(f"[meet] grid in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    root = phase_meet_root(K, S, dev)
    log(f"[meet] root wave phase in {time.perf_counter() - t0:.1f}s")

    # 5. main path
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

    # 6. the BiWFA path
    b_launches, bidir, packed, path_meet_err = phase_bidir_path(K, root)
    for mode in ("sync", "stream"):
        r = bidir[mode]
        log(f"[bidir] {mode}: Total {r['total_pairs_per_s']:,.2f} pairs/s "
            f"(wall {r['wall_s']:.2f}s: scatter {r['t_scatter']:.2f}s, "
            f"kernel {r['t_kernel']:.2f}s, gather {r['t_gather']:.2f}s) "
            f"on {card}")

    log(f"[time] all phases in {time.perf_counter() - t_start:.1f}s")

    # 7. report
    src = "src/repro_torch/kernels/wfa/csrc/wfa.cu"
    kernels = []
    for name, variant in (("wfa_score", "score"), ("wfa_trace", "trace")):
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": "src/repro/kernels/wfa/kernel.py:334",
            "launches": launches[variant] + b_launches[variant],
            "max_abs_err": max(worst, t["max_abs_err"]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None})
    kernels.append({
        "name": "wfa_meet", "route": "cuda",
        "source": "src/repro_torch/kernels/wfa/csrc/wfa_meet.cu",
        "replaces": "src/repro/kernels/wfa/kernel.py:617",
        "launches": b_launches["meet"],
        "max_abs_err": max(meet_worst, root["max_abs_err"], path_meet_err),
        "ms": root["ms"], "plain_ms": root["plain_ms"],
        # plain_ms is taken on the first plain_pairs pairs of the root wave;
        # ms_on_plain_inputs is the kernel on those same pairs
        "ms_on_plain_inputs": root["ms_on_plain_inputs"],
        "plain_pairs": root["plain_pairs"],
        "bound_ms": root["bound_ms"], "bound_by": root["bound_by"],
        "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
