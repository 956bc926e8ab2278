#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (each raises on failure, and the script then exits non-zero):

1. environment — torch version, the card, its name and power limit;
2. build — ``nvcc`` builds the CUDA kernels from ``csrc/wfa.cu``,
   ``csrc/wfa_meet.cu``, ``kernels/flash_attention/csrc/
   flash_attention.cu`` and ``flash_wgmma.cu``, one process per source,
   all started together, and prints each kernel's ptxas registers and
   spills (each full-width, meet and band instantiation's too; the wgmma
   flash body must not spill) and the full-width kernel's threads, shared
   bytes and blocks resident per SM at the main path's shapes;
3. kernel vs plain — the CUDA WFA kernel against its plain PyTorch version
   on the card, over {GapAffine(4,6,2), GapLinear, Edit} x {exact,
   AdaptiveBand, ZDrop} x {score, trace}, on one wave of 4,096 pairs of
   100 bp at E = 2% with pass-1 bounds and on one exact-bound bucket
   (``k_pad`` 384): scores and steps equal, trace words bit-equal; then
   both held whole against the plain version and timed at the main path's
   wave shape (65,536 pairs) and at the recovery shape (``k_pad`` 384; the
   trace on 8,192 pairs), with both bounds (bytes; integer operations of the
   cells the recurrence can reach: up to each pair's score for the score
   variant, up to each block's exit step for the trace); then at the BiWFA
   path's pass 1 (1,024 pairs of 10 kb, exact, ``k_pad`` 4,992) the score
   wave and a 64-pair trace launch (39,936 cells a block), each held whole
   against the plain version, both timed;
4. meet kernel vs plain — the CUDA meet kernel against its plain version
   over {GapAffine(4,6,2), GapLinear, Edit} x {exact, AdaptiveBand(10,4),
   ZDrop(8)} x boundary states ((M,M); (I,D) and (D,M) for affine) on the
   same 4,096 pairs, all eight outputs equal; then one meet wave at the
   BiWFA path's root shape (1,024 pairs of 10 kb at E = 3%): its first
   and last 8 pairs compared, the wave and its first 8 pairs timed, the
   pairs' meet steps printed and the bound taken as the larger of the
   bytes and the integer operations of the cells the recurrence reaches
   (``kernel.meet_band``) up to each pair's meet;
5. main path — ``repro_torch.launch.align.main`` with ``--backend kernel``
   on 262,144 pairs (``--mode both --verify 512``) and with ``--output
   cigar`` on 65,536 pairs; the kernel's launch counts must rise; then the
   ``ring`` backend on the same pairs must give the same scores;
6. BiWFA path — the launcher with ``--output cigar --trace bidir`` on
   1,024 pairs of 10 kb at E = 3% (``--mode both --verify 4``); the meet,
   score and trace kernels must each launch, no meet may go unmet or fall
   back, the scores must equal an ``--output score`` run of the same
   pairs, and block 0 of every meet wave the path launched must equal the
   plain version on the same rows; the port's tracer is on for this run
   and the blocking run's wall clock is printed split by span (meet and
   other kernels, host scatter, leaf traceback, split, stitch);
7. read mapping — a seeded synthetic genome of 4,641,652 bp (the length of
   E. coli K-12 MG1655), ``MinimizerIndex.build`` at the mapper's
   defaults, 32,768 reads of 100 bp at E = 2% on both strands
   (``sample_from_reference``, seed 9), ``ReadMapper(top_n=2,
   backend="kernel")`` on the card: the trace kernel must launch, recall
   (strand right, POS within 6 bp) must reach 95%, every mapped record must
   re-score to its cost against ``ref[pos : pos + ref_span]``, and the SAM
   text must equal the same run on the ``ring`` backend; index build,
   seed + chain and extension seconds, mappings/s and the raw pairwise
   pairs/s of as many pairs with CIGARs are printed; then
   ``repro_torch.launch.map_reads --backend kernel`` on FASTA files of
   4,096 of the reads must give the library call's records, and
   ``repro_torch.launch.align --output sam`` on 4,096 pairs must verify;
8. alignment service — ``repro_torch.launch.serve_align --backend
   kernel`` at its defaults (512 requests x 8 pairs, waves of 256, load
   0.75 of the batch rate it measures on the card), at 4,096 requests x 16
   pairs (waves of 8,192, two worker threads) and with ``--output cigar``:
   the score kernel (the trace kernel for CIGARs) must launch, no request
   may fail, the warm replay must create no new specialisation, every
   delivered score must equal batch mode on the same engine and 512 the
   Gotoh oracle, and every CIGAR must re-score to its cost; sustained
   pairs/s, latency percentiles, shed requests, driver lag, flush reasons,
   occupancy and padding waste are printed;
9. band kernel vs plain — the CUDA band kernel (the compacting band,
   ``band_cap``) against its plain version over {GapAffine(4,6,2),
   GapLinear, Edit} x {AdaptiveBand(), ZDrop(), AdaptiveBand(10,4),
   ZDrop(8)} x {score, trace} on 256 pairs of 1 kb at exact-bucket bounds
   (``k_pad`` 2,176, so every band is narrower), plus an exact 512-lane
   band; scores, steps and trace words equal.  Then at the 10 kb root shape
   (GapAffine(4,6,2), AdaptiveBand(), ``k_pad`` 4,992, 128 lanes): the
   whole 1,024-pair score wave and 64-pair trace wave against the plain
   version, the band timed on them and on their block 0 with both bounds
   (bytes; integer operations of the window cells the recurrence can reach
   up to each block's exit step), and the full-width kernel, heuristic and
   exact, timed on the same wave;
10. banded path — ``AlignmentEngine(GapAffine(4,6,2), backend="kernel",
   heuristic=AdaptiveBand(), backend_opts={"band_cap": "auto"})`` on the
   1,024 pairs of 10 kb: ``output="score"`` blocking and streamed,
   ``output="cigar", trace_variant="bidir"``, and the packed CIGAR path on
   the first 64 pairs; the band launch counts must rise, every CIGAR must
   re-score to its cost, no meet may go unmet or fall back, and 4 scores
   must be upper bounds of the Gotoh optimum; the same runs on the ``ring``
   backend (one window per pair) are the yardstick, and the counts of pairs
   equal to the full-width heuristic run are printed, with the seconds the
   band wrapper's byte check of the codes (``band.check_codes``) takes in
   a second, traced run of the blocking score and bidir runs;
11. flash kernel vs plain — every CUDA flash-attention body that takes the
   inputs against the plain version over {MHA 8/8, GQA 16/8, MQA 16/1,
   qwen3-32b's 64/8, granite-34b's 48/1} x {causal, non-causal} x {fp32,
   bf16} x dh {64, 128} x S {128, 250, 1,024, 2,048} (non-causal only at
   block multiples) plus non-causal Sq 128 over Sk 1,024, within 3e-5
   (fp32, no TF32) and 2e-2 (bf16), and in bf16 also within 2 ulps of each
   output plus a floor; bf16 at dh 64 / 128 must run the wgmma body by
   default and runs once more on ``mma.sync`` and on the fp32 pipes; a
   control shows that this check passes a sound attention and fails one
   with a key tile dropped, in the materialised attention and in the wgmma
   body itself; then at the served shape (B 8, S 2,048, H 16, KV 8, dh
   128, bf16, causal) the wgmma, ``mma.sync`` and fp32-pipe bodies, the
   plain version and ``scaled_dot_product_attention`` (the yardstick, timed
   only) are timed in turns, twice;
12. serve path — qwen3-0.6b at full width with random weights from a
   seeded generator on the card: ``repro_torch.launch.serve.main(["--arch",
   "qwen3-0.6b"])`` (8 requests of 4-16 tokens, 32 new each), then one
   ``BatchServer`` wave of 8 prompts of 2,048 tokens, 32 new, ``max_seq``
   4,096; each prefill must launch the flash kernel once per layer on the
   wgmma body, every launch of the 2,048-token prefill must equal the
   plain version on its own inputs (the bf16 check above), and for 2
   requests the logits of prefill + decode (plain attention over the
   cache) must equal those of one ``forward`` (flash kernel) over the same
   tokens within the stated bf16 tolerance; prefill and decode tokens/s and
   peak memory are printed;
13. telemetry — ``repro_torch.launch.align --backend kernel`` on the main
   path's 65,536 pairs in waves of 4,096 with ``--trace-out``: streamed,
   streamed with ``--output cigar``, and blocking (``--mode sync``).  The
   score (the trace) kernel must launch, the three runs must give the same
   scores, and each capture must hold one ``wave.scatter`` and one
   ``wave.kernel`` span per wave of the session.  In the blocking capture
   every wave's kernel seconds by CUDA events (its span's ``t_kernel``)
   must lie inside that span's host duration, and they must add up to the
   session's kernel phase.  ``repro_torch.launch.obs_report
   --assert-phases`` on each capture and ``--diff`` over the two streamed
   ones must exit 0; the phase shares and the pipeline report (time with
   waves in flight as the host sees them, bubbles, host overlap, mean
   depth) are printed;
14. shardmap — the launcher with ``--backend shardmap`` (one shard of the
   host's mesh) on the same pairs must verify 512 and give the kernel
   run's scores, and with ``--output cigar`` every CIGAR must re-score to
   its cost; then ``AlignmentEngine.align_packed`` on one shard and on two
   shards of the one card (``make_mesh((2,), ("pairs",), devices=[cuda:0,
   cuda:0])``) must give the kernel and ring backends' scores, timed in two
   turns; the two-shard run must pad rows to multiples of 2 (3 pairs to
   4), and the per-shard steps of its pass-1 wave are printed;
15. shims — ``WFAligner(backend="kernel")`` and ``PIMBatchAligner`` on
   4,096 pairs must warn ``DeprecationWarning``, launch the score kernel
   and give ``AlignmentEngine.align``'s scores, and ``python -m
   repro_torch.examples.quickstart`` must exit 0 on the card;
16. report — a ``kernels`` JSON line, the card's name and power limit, and
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
BAND_GRID_PAIRS = 256   # the band grid: pairs of 1 kb
BAND_GRID_LEN = 1000
BAND_PACKED_PAIRS = 64  # packed CIGARs at 10 kb: 309 words x 64 x 4,992 x 3
                        # planes x 4 B = 1.18 GB of trace
# read mapping: a synthetic genome (seeded, nothing downloaded) of the
# length of E. coli K-12 MG1655 (NC_000913.3), reads of the main path's
# length and divergence on both strands
MAP_REF_LEN = 4_641_652
MAP_READS = 32768
MAP_LAUNCHER_READS = 4096
# the alignment service at a size the card serves: 65,536 pairs of 100 bp
SERVE_REQUESTS = 4096
SERVE_PAIRS_PER_REQUEST = 16
SERVE_WAVE = 8192
# the telemetry captures: the main path's pairs, waves of 4,096 so that the
# pipeline holds several waves in flight
OBS_WAVE = 4096
SHIM_PAIRS = 4096
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
INT32_OPS_PER_S = 16.7e12      # 132 SMs x 64 INT32 lanes x 1.98 GHz
BF16_FLOPS_PER_S = 989e12      # H100 SXM tensor cores, dense bf16
# integer operations of one front's cell of the meet recurrence (the count
# in the header note of csrc/wfa_meet.cu)
MEET_OPS_PER_CELL = 18
# integer operations of one window cell of the band recurrence (the count in
# the band kernel's note in csrc/wfa.cu, codes not counted); the full-width
# kernel's bound counts the same per reachable cell (a band of k_pad lanes)
BAND_OPS_PER_CELL = 24
RECOVERY_TRACE_PAIRS = 8192   # the k_pad 384 trace: 27 words x 8,192 x 384
                              # x 3 planes x 4 B = 1.0 GB
FULL_TRACE_PAIRS = 64   # the 10 kb trace: 8 x 4,992 = 39,936 cells a block
# flash attention: the tolerances of tests/test_kernel_flash.py (max |err|)
FLASH_TOL = {"float32": 3e-5, "bfloat16": 2e-2}
# In bf16 the absolute 2e-2 is about the size of the outputs at S 2,048
# (|o| ~ 0.4 / sqrt(row) on these inputs), so every bf16 output is also held
# elementwise to FLASH_BF16_ULPS bf16 ulps of |want| plus FLASH_BF16_FLOOR
# x the mean |want| of its row (one position of one head).  Kernel and plain
# both round the fp32 result to bf16 (up to 1 ulp apart) and round the
# weights p to bf16 against the running max of their own key tiles, which
# moves outputs by about a percent of their row's mean |o| between two
# tilings.  A key tile dropped or mis-rescaled moves late rows by tens of
# percent.  phase_flash_control prints both sides on the card.
FLASH_BF16_ULPS = 2
FLASH_BF16_FLOOR = 2 ** -4
# the served model (configs/qwen3_0_6b.py at full width) and its long wave
LM_ARCH = "qwen3-0.6b"
LM_BATCH = 8
LM_PROMPT = 2048
LM_NEW = 32
LM_MAX_SEQ = 4096
LM_E2E_ROWS = 2
# prefill + decode (plain _sdpa over the bf16 cache) against one forward
# (flash kernel) over the same tokens: both bf16, rounded at other places
# (bf16 scores and weights in _sdpa, fp32 in the kernel), so they agree to a
# few bf16 ulps of logits whose std is about 0.64, while a broken attention
# route moves them by the order of that std.  tests/test_torch_lm.py::
# test_prefill_decode_matches_forward_bf16 holds the same check on the
# smoke model, where a wrong GQA head mapping fails both bounds.
LM_E2E_MAX_TOL = 0.25
LM_E2E_MEAN_TOL = 0.03


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


def kernel_bound(plen, tlen, out_bytes):
    """The least time the card could take for one WFA wave -> (ms, "bytes"
    | "operations", bytes, compares): each int32 character of a sequence up
    to its length (the padding columns are never read), both lengths and
    the outputs once, over the memory rate; one compare per aligned column,
    min(plen, tlen) per pair, over the INT32 rate."""
    import numpy as np
    lens = plen.astype(np.int64) + tlen
    nbytes = 4 * int(lens.sum()) + 2 * 4 * len(plen) + out_bytes
    ops = int(np.minimum(plen, tlen).astype(np.int64).sum())
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", nbytes, ops)


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


def full_bound(K, pen, got, s_max, k_pad, plen, tlen, trace):
    """Both bounds of one full-width launch -> (ms, "bytes" | "operations",
    bytes ms, operations ms, reachable cells, operations): :func:`band_bound`
    with a band of k_pad lanes, counting the cells ``kernel.meet_band`` lets
    a pair reach.  Under ``trace`` a pair steps until its block exits (the
    contract gives a settled pair codes to the exit); the score function
    needs a pair's rows only up to its own score, so there each pair counts
    rows 1 to min(score, block exit - 1), an unresolved pair to the exit.
    ``got`` must be outputs held against the plain version."""
    import numpy as np
    out_bytes = sum(t.numel() * t.element_size() for t in got)
    steps = got[1][:, 0].cpu().numpy()
    if trace:
        return band_bound(K, pen, steps, k_pad, 8, s_max, k_pad, plen, tlen,
                          out_bytes)
    score = got[0][:, 0].cpu().numpy()
    rows = np.where(score >= 0, np.minimum(score, steps - 1), steps - 1)
    # band_bound counts rows 1 to steps - 1 of each block: per pair, one
    # pair a block
    return band_bound(K, pen, rows + 1, k_pad, 1, s_max, k_pad, plen, tlen,
                      out_bytes)


def phase_wave_timing(K, S, eng, P, plen, T, tlen, dev):
    """Phase 3b: both variants at the main path's wave shape (65,536 pairs
    of pass 1, GapAffine, exact) and at the recovery shape (the exact
    bounds of the same bucket: s_max 416, k_pad 384; score on the wave,
    trace on its first RECOVERY_TRACE_PAIRS), each held whole against the
    plain version and timed -> per-variant timing records."""
    width = 128
    args = wave_inputs(P, plen, T, tlen, WAVE, width, dev)
    out = {}
    for exact in (False, True):
        s_max, k_max = eng._bounds_for_bucket(width, plen[:WAVE],
                                              tlen[:WAVE], exact)
        k_pad = -(-(2 * k_max + 1) // 128) * 128
        for trace in (False, True):
            n = RECOVERY_TRACE_PAIRS if exact and trace else WAVE
            ins = tuple(a[:n] for a in args)
            kw = dict(pen=eng.pen, s_max=s_max, k_pad=k_pad, block_pairs=8,
                      trace=trace, heur=None)
            got = K.wfa_cuda(*ins, **kw)
            torch_sync()
            want = K.wfa_plain(*ins, **kw)
            err = max_abs_err(got, want)
            del want
            if err:
                raise AssertionError(f"kernel != plain at s_max={s_max} "
                                     f"k_pad={k_pad} (trace={trace}): "
                                     f"max|err|={err}")
            bound, by, bytes_ms, ops_ms, cells, ops = full_bound(
                K, eng.pen, got, s_max, k_pad, plen[:n], tlen[:n], trace)
            del got
            k_ms = cuda_ms(lambda: K.wfa_cuda(*ins, **kw), 20)
            p_ms = cuda_ms(lambda: K.wfa_plain(*ins, **kw), 2)
            name = ("wfa_trace" if trace else "wfa_score") + (
                "_recovery" if exact else "")
            out[name] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                             bound_ms=bound, bound_by=by,
                             bytes_bound_ms=bytes_ms, ops_bound_ms=ops_ms,
                             pairs=n, s_max=s_max, k_pad=k_pad,
                             lanes=K.full_lanes(eng.pen, s_max, k_pad))
            log(f"[wave] {name}: {n} pairs, s_max={s_max} k_pad={k_pad} "
                f"(lanes {out[name]['lanes']}): equal; kernel {k_ms:.4f} "
                f"ms, plain {p_ms:.3f} ms, bound {bound:.5f} ms ({by}): "
                f"bytes {bytes_ms:.5f} ms, operations {ops_ms:.5f} ms "
                f"({cells:,} reachable cells x {BAND_OPS_PER_CELL} + one "
                f"compare per aligned column = {ops:,})")
    return out


def phase_full_10kb(K, S, dev):
    """Phase 3c: the full-width kernel at the BiWFA path's pass 1 (1,024
    pairs of 10 kb at E = 3%, GapAffine(4,6,2), exact, s_max 4,928, k_pad
    4,992): the score wave, and a trace launch of its first
    FULL_TRACE_PAIRS pairs (39,936 cells a block); each held whole against
    the plain version (so every block's exit step that the bound counts is
    checked), the kernel timed on the whole launch and on block 0 -> timing
    records."""
    from repro_torch.core.engine import AlignmentEngine
    from repro_torch.data.reads import ReadPairSpec, generate_pairs
    P, plen, T, tlen = generate_pairs(ReadPairSpec(
        n_pairs=LONG_PAIRS, read_len=LONG_LEN, edit_frac=LONG_EDIT, seed=0))
    pen = S.GapAffine(4, 6, 2)
    eng = AlignmentEngine(pen, backend="kernel", edit_frac=LONG_EDIT,
                          device=dev)
    s1, k1 = eng._bounds_for_bucket(LONG_BUCKET, plen, tlen, False)
    k_pad = -(-(2 * k1 + 1) // 128) * 128
    args = wave_inputs(P, plen, T, tlen, LONG_PAIRS,
                       max(P.shape[1], T.shape[1]), dev)
    out = {}
    for trace, pairs in ((False, LONG_PAIRS), (True, FULL_TRACE_PAIRS)):
        wave = tuple(a[:pairs] for a in args)
        kw = dict(pen=pen, s_max=s1, k_pad=k_pad, block_pairs=8,
                  trace=trace)
        got = K.wfa_cuda(*wave, **kw)
        torch_sync()
        t0 = time.perf_counter()
        want = K.wfa_plain(*wave, **kw)
        torch_sync()
        p_ms = (time.perf_counter() - t0) * 1e3
        err = max_abs_err(got, want)
        del want
        if err:
            raise AssertionError(f"kernel != plain at the 10 kb shape "
                                 f"(trace={trace}): max|err|={err}")
        bound, by, bytes_ms, ops_ms, cells, ops = full_bound(
            K, pen, got, s1, k_pad, plen[:pairs], tlen[:pairs], trace)
        steps = got[1][:, 0].cpu().numpy()
        score = got[0][:, 0].cpu().numpy()
        del got
        k_ms = cuda_ms(lambda: K.wfa_cuda(*wave, **kw), 3)
        k_ms_n = cuda_ms(lambda: K.wfa_cuda(*(a[:8] for a in wave), **kw), 3)
        name = "wfa_trace_10kb" if trace else "wfa_score_10kb"
        out[name] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                         plain_pairs=pairs, block0_ms=k_ms_n, pairs=pairs,
                         bound_ms=bound, bound_by=by,
                         bytes_bound_ms=bytes_ms, ops_bound_ms=ops_ms,
                         s_max=s1, k_pad=k_pad, block0_steps=int(steps[0]),
                         max_steps=int(steps.max()))
        log(f"[full] {name}: {pairs} pairs of {LONG_LEN} bp, s_max={s1} "
            f"k_pad={k_pad}; scores {int(score.min())}-{int(score.max())}, "
            f"block exit steps: block 0 {int(steps[0])}, max "
            f"{int(steps.max())}: kernel {k_ms:.3f} ms ({k_ms_n:.3f} ms on "
            f"block 0), plain {p_ms:.1f} ms on the whole launch (equal); "
            f"bound {bound:.5f} ms ({by}): bytes {bytes_ms:.5f} ms, "
            f"operations {ops_ms:.5f} ms ({cells:,} reachable cells x "
            f"{BAND_OPS_PER_CELL} + one compare per aligned column = "
            f"{ops:,})")
    return out


def phase_main_path(K):
    """Phase 5: the launcher on the kernel backend, then on ring."""
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


def meet_steps(outs, s_max):
    """Each pair's meet step from the meet outputs: the larger of the two
    costs it met at (the test at step s reads the forward or reverse row at
    s and the other at starget - s), s_max for a pair that did not meet."""
    import numpy as np
    score, a, b = (outs[i][:, 0].cpu().numpy() for i in (0, 3, 4))
    return np.where(score >= 0, np.maximum(a, b), s_max)


def meet_bound(K, pen, outs, s_max, k_pad, plen, tlen):
    """The least time the card could take for one meet wave -> (ms, "bytes"
    | "operations", bytes, operations, band cells).  Bytes: each int32
    character of the forward and reversed sequences up to its length,
    plen / tlen / starget read once, the eight outputs written once.
    Operations: MEET_OPS_PER_CELL for each cell that the recurrence can
    reach (``kernel.meet_band``), forward and reverse, at every step up to
    each pair's meet step."""
    import numpy as np
    n = len(plen)
    band = K.meet_band(pen, s_max, k_pad)[:, :, 0]          # M: [S+1, 2, 2]
    width = np.clip(band[..., 1] - band[..., 0] + 1, 0, None).sum(axis=1)
    cum = np.cumsum(width.astype(np.int64))
    cells = int(cum[meet_steps(outs, s_max)[:n]].sum())
    lens = plen.astype(np.int64) + tlen
    nbytes = 2 * 4 * int(lens.sum()) + 3 * 4 * n + 8 * 4 * n
    ops = cells * MEET_OPS_PER_CELL
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", nbytes, ops,
            cells, bytes_ms, ops_ms)


def band_bound(K, pen, steps, band, block_pairs, s_max, k_pad, plen, tlen,
               out_bytes):
    """The least time the card could take for one band wave -> (ms, "bytes"
    | "operations", bytes ms, operations ms, window cells, operations).
    Bytes as :func:`kernel_bound`.  Operations: BAND_OPS_PER_CELL for each
    window cell the recurrence can reach, plus one compare per aligned
    column.  A block computes rows 1 to its exit step (``steps``, per pair)
    less one; at row s its window of ``band`` lanes holds at most
    min(band, lanes of the M range of ``kernel.meet_band``'s forward front
    at s) reachable lanes for each of its ``block_pairs`` pairs (that range
    covers I and D; under GapAffine(4,6,2) no odd row has one)."""
    import numpy as np
    rng = K.meet_band(pen, s_max, k_pad)[:, 0, 0]             # [S+1, 2]
    width = np.minimum(np.clip(rng[:, 1] - rng[:, 0] + 1, 0, None), band)
    cum = np.cumsum(width.astype(np.int64)) - width[0]        # rows 1..s
    blk = np.asarray(steps, dtype=np.int64)[::block_pairs]
    cells = int(cum[np.clip(blk - 1, 0, s_max)].sum()) * block_pairs
    _, _, nbytes, compares = kernel_bound(plen, tlen, out_bytes)
    ops = cells * BAND_OPS_PER_CELL + compares
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", bytes_ms, ops_ms,
            cells, ops)


def phase_meet_root(K, S, dev):
    """Phase 4b: one meet wave at the BiWFA path's root shape -> timing
    record.  starget comes from the score kernel at pass-1 bounds; the
    plain version runs on the first and on the last ROOT_PLAIN_PAIRS pairs
    (blocks are independent, so those rows of the kernel's full run must
    equal it)."""
    import numpy as np
    from repro_torch.core.engine import AlignmentEngine
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
    err, p_ms = 0, []
    for rows in (slice(0, n), slice(LONG_PAIRS - n, LONG_PAIRS)):
        t0 = time.perf_counter()
        want = K.wfa_meet_plain(*(a[rows] for a in args), **kw)
        torch_sync()
        p_ms.append((time.perf_counter() - t0) * 1e3)
        e = max_abs_err(tuple(g[rows] for g in got), want)
        if e:
            raise AssertionError(f"meet kernel != plain at the root shape, "
                                 f"rows {rows.start}-{rows.stop - 1}: "
                                 f"max|err|={e}")
        err = max(err, e)
    k_ms = cuda_ms(lambda: K.wfa_meet_cuda(*args, **kw), 3)
    k_ms_n = cuda_ms(lambda: K.wfa_meet_cuda(*(a[:n] for a in args), **kw),
                     3)
    bound, bound_by, nbytes, ops, cells, bytes_ms, ops_ms = meet_bound(
        K, pen, got, s_max, k_pad, plen, tlen)
    met = int((got[0] >= 0).sum())
    ms_steps = meet_steps(got, s_max)
    log(f"[meet] root wave: {LONG_PAIRS} pairs of {LONG_LEN} bp, cost "
        f"{int(st.min())}-{int(st.max())}, s_max={s_max} k_pad={k_pad}; "
        f"met {met}/{LONG_PAIRS}, meet steps min {int(ms_steps.min())} "
        f"median {float(np.median(ms_steps)):g} max {int(ms_steps.max())}, "
        f"block exit step <= {int(got[1].max())}")
    log(f"[meet] root wave: kernel {k_ms:.3f} ms ({k_ms_n:.3f} ms on the "
        f"first {n} pairs), plain {p_ms[0]:.1f} / {p_ms[1]:.1f} ms on the "
        f"first / last {n} pairs (equal); bound {bound:.5f} ms "
        f"({bound_by}): bytes {bytes_ms:.5f} ms ({nbytes} bytes), "
        f"operations {ops_ms:.5f} ms ({cells:,} band cells x "
        f"{MEET_OPS_PER_CELL} = {ops:,} integer operations)")
    return dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms[0],
                ms_on_plain_inputs=k_ms_n, plain_pairs=n,
                bound_ms=bound, bound_by=bound_by, bytes_bound_ms=bytes_ms,
                ops_bound_ms=ops_ms, band_cells=cells,
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


def wall_split(events, run="align.sync"):
    """Where the wall clock of one traced launcher run went -> dict of
    seconds.  Each span's own time is its duration less that of the spans
    it encloses on its thread; the blocking session's ``wave.scatter``
    spans carry each wave's kernel and copy-out time (CUDA events) and the
    output it served, so the kernel splits into meet waves (``bidir_meet``)
    and the rest, and the host part of a scatter is what remains."""
    spans = [e for e in events if e.get("ph") == "X"]
    top = [e for e in spans if e["name"] == run]
    if len(top) != 1:
        raise AssertionError(f"{len(top)} '{run}' spans in the trace")
    t0, t1 = top[0]["ts"], top[0]["ts"] + top[0]["dur"]
    inner = sorted((e for e in spans if e is not top[0]
                    and t0 <= e["ts"] and e["ts"] + e["dur"] <= t1),
                   key=lambda e: (e["tid"], e["ts"], -e["dur"]))
    own, stack = {}, []
    for e in inner:
        while stack and (stack[-1]["tid"] != e["tid"] or
                         stack[-1]["ts"] + stack[-1]["dur"] <= e["ts"]):
            stack.pop()
        if stack:
            own[id(stack[-1])] -= e["dur"]
        own[id(e)] = e["dur"]
        stack.append(e)
    by_name, kernel, copy_out = {}, {}, 0.0
    for e in inner:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + own[id(e)] / 1e6
        a = e.get("args") or {}
        if e["name"] == "wave.scatter" and "t_kernel" in a:
            key = a["output"]
            kernel[key] = kernel.get(key, 0.0) + a["t_kernel"]
            copy_out += a["t_copy_out"]
    wall = top[0]["dur"] / 1e6
    out = {"wall": wall,
           "meet kernel": kernel.pop("bidir_meet", 0.0),
           "other kernels": sum(kernel.values()),
           "copy out": copy_out,
           "host scatter": by_name.pop("wave.scatter", 0.0)
           - sum(kernel.values()) - copy_out}
    out["host scatter"] -= out["meet kernel"]
    for name, label in (("wave.traceback", "host traceback"),
                        ("bidir.split", "split"),
                        ("bidir.stitch", "stitch"),
                        ("meet.check_codes", "meet code check")):
        out[label] = by_name.pop(name, 0.0)
    out["other spans"] = sum(by_name.values())
    out["remainder"] = wall - sum(v for k, v in out.items() if k != "wall")
    out["kernel by output"] = dict(kernel, bidir_meet=out["meet kernel"])
    return out


def phase_bidir_path(K, root):
    """Phase 6: the BiWFA CIGAR path through the launcher, then the same
    pairs' --output score run -> (launches, summary, packed bytes, meet
    max |err|).  Block 0 of every meet wave the path launches is kept and
    held against the plain version after the run."""
    import numpy as np
    from repro_torch.core.wavefront import n_trace_words
    from repro_torch.launch import align
    from repro_torch.obs import trace

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
    trace.reset()
    trace.enable()
    try:
        rc = align.main([*common, "--output", "cigar", "--trace", "bidir",
                         "--mode", "both", "--verify", "4"], bidir)
    finally:
        K.wfa_meet_cuda = launch
        trace.disable()
    split = wall_split(trace.events())
    stream_split = wall_split(trace.events(), run="align.stream")
    trace.reset()
    launches = dict(K.LAUNCHES)
    if rc != 0:
        raise AssertionError("launcher failed on the BiWFA path")
    log(f"[bidir] BiWFA path in {time.perf_counter() - t0:.1f}s; launches "
        f"{launches}")
    if min(launches[k] for k in ("score", "trace", "meet")) == 0:
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
    log("[bidir] sync wall clock split (s; the tracer on): " + ", ".join(
        f"{k} {v:.4f}" for k, v in split.items() if k != "kernel by output")
        + f"; kernel by wave output {split['kernel by output']}")
    # the meet wrapper's byte check waits for the stream: what it holds the
    # streamed run's host back
    log(f"[bidir] meet code check (a reduction and a sync per meet launch): "
        f"{split['meet code check']:.4f} s of the sync wall "
        f"{split['wall']:.4f} s, {stream_split['meet code check']:.4f} s of "
        f"the stream wall {stream_split['wall']:.4f} s")
    return launches, bidir, packed, err, split


def map_records(sam_text):
    """SAM records (no @PG line) in read order: r0, r1, ... (the launcher
    writes them in retirement order)."""
    lines = [ln for ln in sam_text.splitlines() if not ln.startswith("@PG")]
    head = [ln for ln in lines if ln.startswith("@")]
    body = sorted((ln for ln in lines if not ln.startswith("@")),
                  key=lambda ln: int(ln.split("\t")[0][1:]))
    return head + body


def phase_map(K, card):
    """Phase 7: read mapping at the scale of a bacterial genome on the
    kernel backend -> (launches, summary).  Every extension goes through
    ``engine.stream()`` in CIGAR mode, so through the trace kernel."""
    import io
    import tempfile
    from repro_torch.core.gotoh import score_cigar
    from repro_torch.data.dna import random_reference, revcomp
    from repro_torch.data.reads import (ReadPairSpec, generate_pairs,
                                        sample_from_reference)
    from repro_torch.launch import align, map_reads
    from repro_torch.mapping import MinimizerIndex, ReadMapper, write_sam
    from repro_torch.obs import trace

    t_phase = time.perf_counter()
    ref = random_reference(MAP_REF_LEN, seed=5)
    t0 = time.perf_counter()
    index = MinimizerIndex.build([ref], ["chr1"])
    t_index = time.perf_counter() - t0
    sampled = sample_from_reference(ref, MAP_READS, read_len=READ_LEN,
                                    edit_frac=EDIT_FRAC, seed=9)
    reads = [r.read for r in sampled]
    names = [f"r{i}" for i in range(len(reads))]
    log(f"[map] index of {MAP_REF_LEN:,} bp in {t_index:.2f}s: "
        f"{index.n_occurrences:,} seed occurrences, "
        f"{index.nbytes() / 1e6:.1f} MB; {len(reads):,} reads of "
        f"{READ_LEN} bp at E = {EDIT_FRAC:.0%}, both strands")

    def mapper(backend):
        return ReadMapper(index, top_n=2, edit_frac=EDIT_FRAC,
                          read_len=READ_LEN, backend=backend, device="cuda")

    def sam(maps, n=None):
        buf = io.StringIO()
        write_sam(buf, maps[:n], reads[:n], names[:n], index.names,
                  index.lengths)
        return buf.getvalue()

    kern = mapper("kernel")
    K.reset_launches()
    trace.reset()
    trace.enable()
    t0 = time.perf_counter()
    try:
        maps = kern.map(reads)
    finally:
        trace.disable()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    t_seed = sum(e["dur"] for e in trace.events()
                 if e.get("ph") == "X" and e["name"] == "map.seed_chain") / 1e6
    trace.reset()
    st = kern.stats
    log(f"[map] kernel backend: {wall:.2f}s for {len(reads):,} reads "
        f"({st.n_extensions:,} extensions, {st.n_tickets} tickets, "
        f"{st.engine.n_overflow} overflow, {st.engine.n_recovered} "
        f"recovered, {st.n_unresolved} unresolved); launches {launches}")
    if launches["trace"] == 0:
        raise AssertionError(f"the mapping path missed the trace kernel: "
                             f"{launches}")
    hits = sum(m[0].mapped and m[0].strand == r.strand
               and abs(m[0].pos - r.pos) <= 6
               for r, m in zip(sampled, maps))
    if hits < 0.95 * len(reads):
        raise AssertionError(f"recall {hits}/{len(reads)} below 95%")
    pen = kern.pen.as_penalties()
    n_rec = 0
    for r, ms in zip(sampled, maps):
        for m in ms:
            if not m.mapped:
                continue
            txt = r.read if m.strand == 0 else revcomp(r.read)
            cost, ci, cj, ok = score_cigar(
                m.ops, ref[m.pos: m.pos + m.ref_span()], txt, pen)
            if not (ok and cost == m.score and ci == m.ref_span()
                    and cj == len(txt)):
                raise AssertionError(f"read {r} record {m}: re-scores to "
                                     f"{cost} (ok={ok})")
            n_rec += 1
    sam_kernel = sam(maps)
    ring = mapper("ring")
    t0 = time.perf_counter()
    sam_ring = sam(ring.map(reads))
    t_ring = time.perf_counter() - t0
    if sam_kernel != sam_ring:
        a, b = sam_kernel.splitlines(), sam_ring.splitlines()
        i = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        raise AssertionError(f"kernel and ring SAM differ at line {i}: "
                             f"{a[i]!r} != {b[i]!r}")
    log(f"[map] recall {hits / len(reads):.4f} (strand right, POS within "
        f"6 bp); {n_rec:,} mapped records re-score to their cost; SAM "
        f"identical to the ring backend's ({t_ring:.2f}s on the card)")

    # the raw pairwise yardstick: as many pairs of the same length through
    # the same engine with CIGARs, no mapping stages
    P, plen, T, tlen = generate_pairs(ReadPairSpec(
        n_pairs=st.n_extensions, read_len=READ_LEN, edit_frac=EDIT_FRAC,
        seed=9))
    kern.engine.align_packed(P, plen, T, tlen, output="cigar")
    t0 = time.perf_counter()
    kern.engine.align_packed(P, plen, T, tlen, output="cigar")
    pairwise = st.n_extensions / (time.perf_counter() - t0)
    out = {"index_s": t_index, "seed_chain_s": t_seed,
           "extension_s": wall - t_seed, "wall_s": wall,
           "mappings_per_s": len(reads) / wall,
           "pairwise_pairs_per_s": pairwise, "recall": hits / len(reads),
           "extensions": st.n_extensions}
    log(f"[map] index build {t_index:.3f}s, seed+chain {t_seed:.3f}s, "
        f"extension (the rest of the pass: submit, waves, traceback, trim) "
        f"{wall - t_seed:.3f}s; {out['mappings_per_s']:,.0f} mappings/s "
        f"against {pairwise:,.0f} raw pairwise pairs/s with CIGARs on "
        f"{st.n_extensions:,} pairs of {READ_LEN} bp (ratio "
        f"{pairwise / out['mappings_per_s']:.2f}) on {card}")

    # the launchers: map_reads on FASTA files, align --output sam
    n = MAP_LAUNCHER_READS
    with tempfile.TemporaryDirectory() as tmp:
        refs_p, reads_p = f"{tmp}/ref.fa", f"{tmp}/reads.fa"
        sam_p, pairs_p = f"{tmp}/map.sam", f"{tmp}/pairs.sam"
        with open(refs_p, "w") as f:
            f.write(f">chr1\n{ref.tobytes().decode()}\n")
        with open(reads_p, "w") as f:
            for name, r in zip(names[:n], reads[:n]):
                f.write(f">{name}\n{r.tobytes().decode()}\n")
        t0 = time.perf_counter()
        rc = map_reads.main(["--refs", refs_p, "--reads", reads_p,
                             "--sam-out", sam_p, "--backend", "kernel",
                             "--device", "cuda"])
        if rc != 0:
            raise AssertionError(f"map_reads exited {rc}")
        with open(sam_p) as f:
            launched = f.read()
        if map_records(launched) != map_records(sam(maps, n)):
            raise AssertionError("map_reads and the library call give "
                                 "other records")
        t_launch = time.perf_counter() - t0
        summary = {}
        rc = align.main(["--backend", "kernel", "--device", "cuda",
                         "--output", "sam", "--sam-out", pairs_p,
                         "--pairs", str(n), "--mode", "sync", "--verify",
                         "512"], summary)
        with open(pairs_p) as f:
            n_sam = sum(not ln.startswith("@") for ln in f)
        if rc != 0 or summary.get("verified") != min(512, n) or n_sam != n:
            raise AssertionError(f"align --output sam: rc {rc}, "
                                 f"{n_sam} records")
    log(f"[map] map_reads on {n:,} reads ({t_launch:.2f}s with its index "
        f"build) gives the library call's records; align --output sam "
        f"wrote {n_sam:,} records, {summary['verified']} verified; phase in "
        f"{time.perf_counter() - t_phase:.1f}s")
    return launches, out


def phase_serve_align(K, card):
    """Phase 8: the always-on alignment service on the kernel backend ->
    (launches, summaries): ``launch/serve_align`` at its defaults, at a
    size the card serves (65,536 pairs, waves of 8,192, two worker
    threads), and with ``--output cigar``.  Each run's offered load is
    0.75 of the batch-mode rate of its own trace in its own output, taken
    by the launcher's calibration on an engine of its own before the counts
    are set to 0 and passed as ``--rate``: the counts then hold the warm-up
    and the replay alone, and each of the replay's waves must launch."""
    import numpy as np
    from repro_torch.core.engine import AlignmentEngine
    from repro_torch.core.gotoh import gotoh_score_vec, score_cigar
    from repro_torch.core.penalties import DEFAULT
    from repro_torch.data.reads import ArrivalSpec, generate_trace
    from repro_torch.launch import serve_align

    # name -> (requests, pairs a request, output, other flags); the
    # launcher's defaults are 512 x 8 pairs of 100 bp at E = 2%, seed 13
    runs = {"defaults": (512, 8, "score", []),
            "large": (SERVE_REQUESTS, SERVE_PAIRS_PER_REQUEST, "score",
                      ["--wave-pairs", str(SERVE_WAVE), "--threads", "2"]),
            "cigar": (512, 8, "cigar", [])}
    launches, out = {}, {}
    for name, (n_req, per, output, extra) in runs.items():
        payloads = generate_trace(ArrivalSpec(
            n_requests=n_req, pairs_per_request=per, read_len=100,
            edit_frac=0.02, seed=13))[0]
        batch_pps = serve_align.batch_pairs_per_s(
            AlignmentEngine(backend="kernel", edit_frac=0.02,
                            device="cuda"), payloads, output=output)
        rate = 0.75 * batch_pps / per
        summary = {}
        K.reset_launches()
        t0 = time.perf_counter()
        rc = serve_align.main(["--backend", "kernel", "--device", "cuda",
                               "--requests", str(n_req),
                               "--pairs-per-request", str(per),
                               "--output", output, "--rate", repr(rate),
                               *extra], summary)
        launches[name] = dict(K.LAUNCHES)
        wall = time.perf_counter() - t0
        rep = summary["report"]
        st = rep.stats
        variant = "trace" if output == "cigar" else "score"
        # every device wave (recoveries too) is one launch or more
        n = launches[name]
        if (rc != 0 or rep.n_failed or n[variant] == 0
                or n["score"] + n["trace"] < st.n_waves):
            raise AssertionError(f"serve run {name}: rc {rc}, "
                                 f"{rep.n_failed} failed, launches "
                                 f"{launches[name]} for {st.n_waves} "
                                 f"waves")
        if summary["fresh_specialisations"]:
            raise AssertionError(f"serve run {name}: "
                                 f"{summary['fresh_specialisations']} new "
                                 f"specialisations during the warm replay")
        if not all(np.array_equal(x, y) for a, b in
                   zip(payloads, summary["payloads"]) for x, y in zip(a, b)):
            raise AssertionError(f"serve run {name}: the launcher's trace "
                                 f"is not the one calibrated")
        P, plen, T, tlen = (np.concatenate(a)
                            for a in zip(*summary["payloads"]))
        served = [(i, r) for i, r in enumerate(rep.results) if r is not None]
        rows = np.concatenate([np.arange(i * per, (i + 1) * per)
                               for i, _ in served])
        got = np.concatenate([r.scores for _, r in served])
        batch = summary["engine"].align_packed(P, plen, T, tlen).scores
        if not np.array_equal(got, batch[rows]):
            raise AssertionError(f"serve run {name}: "
                                 f"{int((got != batch[rows]).sum())} scores "
                                 f"differ from batch mode")
        for j in range(0, len(rows), max(1, len(rows) // 512))[:512]:
            i = rows[j]
            g = gotoh_score_vec(P[i, :plen[i]], T[i, :tlen[i]], DEFAULT)
            if got[j] != g:
                raise AssertionError(f"serve run {name}: pair {i} "
                                     f"{got[j]} != Gotoh {g}")
        if name == "cigar":
            cig = [c for _, r in served for c in r.cigars]
            for j, (i, ops) in enumerate(zip(rows, cig)):
                cost, ci, cj, ok = score_cigar(ops, P[i, :plen[i]],
                                               T[i, :tlen[i]], DEFAULT)
                if not (ok and cost == got[j] and ci == plen[i]
                        and cj == tlen[i]):
                    raise AssertionError(f"serve CIGAR of pair {i} "
                                         f"re-scores to {cost} != {got[j]}")
        out[name] = {
            "pairs": int(P.shape[0]), "threads": 2 if name == "large" else 1,
            "batch_output": output, "batch_pairs_per_s": batch_pps,
            "offered_pairs_per_s": rate * per,
            "waves_dispatched": st.n_waves,
            "sustained_pairs_per_s": rep.sustained_pairs_per_s,
            "p50_ms": rep.percentile_ms(50), "p95_ms": rep.percentile_ms(95),
            "p99_ms": rep.percentile_ms(99), "shed": rep.n_shed,
            "driver_lag_max_ms": rep.lag_max * 1e3,
            "waves": [st.waves_full, st.waves_deadline, st.waves_drain],
            "occupancy": st.wave_occupancy,
            "padding_waste": st.padding_waste_frac, "wall_s": wall}
        o = out[name]
        log(f"[serve_align] {name}: {o['pairs']:,} pairs, "
            f"{o['threads']} thread(s); batch mode ({output}s) "
            f"{o['batch_pairs_per_s']:,.0f} pairs/s; offered "
            f"{o['offered_pairs_per_s']:,.0f} pairs/s; sustained "
            f"{o['sustained_pairs_per_s']:,.0f} pairs/s; p50 / p95 / p99 "
            f"{o['p50_ms']:.2f} / {o['p95_ms']:.2f} / {o['p99_ms']:.2f} ms; "
            f"shed {o['shed']}; driver lag max "
            f"{o['driver_lag_max_ms']:.2f} ms; waves full / deadline / "
            f"drain {o['waves']}; occupancy {o['occupancy']:.3f}, padding "
            f"waste {o['padding_waste']:.3f}; launches {launches[name]} "
            f"for {st.n_waves} waves; "
            f"scores equal batch mode, {min(512, len(rows))} Gotoh"
            + (", every CIGAR re-scored" if name == "cigar" else "")
            + f"; {wall:.1f}s on {card}")
    return launches, out


def phase_band_grid(K, S, ops, dev):
    """Phase 9: the CUDA band kernel vs its plain version on 1 kb pairs ->
    (max |err| of the score cases, of the trace cases)."""
    from repro_torch.core.engine import AlignmentEngine
    from repro_torch.data.reads import ReadPairSpec, generate_pairs
    n = BAND_GRID_PAIRS
    P, plen, T, tlen = generate_pairs(ReadPairSpec(
        n_pairs=n, read_len=BAND_GRID_LEN, edit_frac=LONG_EDIT, seed=1))
    args = wave_inputs(P, plen, T, tlen, n, max(P.shape[1], T.shape[1]),
                       dev)
    worst = {False: 0, True: 0}
    for pen in (S.GapAffine(4, 6, 2), S.GapLinear(), S.Edit()):
        eng = AlignmentEngine(pen, backend="kernel", edit_frac=LONG_EDIT,
                              device=dev)
        s_max, k_max = eng._bounds_for_bucket(1024, plen, tlen, True)
        k_pad = -(-(2 * k_max + 1) // 128) * 128
        cases = [(h, ops._band_lanes(h.band_cap(2 * k_max + 1), k_pad))
                 for h in (S.AdaptiveBand(), S.ZDrop(), S.AdaptiveBand(10, 4),
                           S.ZDrop(8))]
        cases.append((None, 512))       # 16 warps a pair
        for heur, cap in cases:
            if cap is None or cap >= k_pad:
                raise AssertionError(f"the band does not engage: {heur} "
                                     f"cap {cap} k_pad {k_pad}")
            for trace in (False, True):
                kw = dict(pen=pen, s_max=s_max, k_pad=k_pad, block_pairs=8,
                          trace=trace, heur=heur, band_cap=cap)
                got = K.wfa_cuda(*args, **kw)
                torch_sync()
                want = K.wfa_plain(*args, **kw)
                err = max_abs_err(got, want)
                worst[trace] = max(worst[trace], err)
                if err:
                    raise AssertionError(
                        f"band kernel != plain: {pen} {heur} band {cap} "
                        f"trace={trace} max|err|={err}")
                k_ms = cuda_ms(lambda: K.wfa_cuda(*args, **kw), 3)
                log(f"[band] {type(pen).__name__:9s} "
                    f"{str(heur or 'exact'):44s} "
                    f"{'trace' if trace else 'score'} band {cap:3d} of "
                    f"k_pad {k_pad}: equal; kernel {k_ms:8.3f} ms")
    return worst[False], worst[True]


def phase_band_root(K, S, ops, dev):
    """Phase 9b: the band at the 10 kb root shape -> timing records for the
    score (1,024-pair wave) and trace (64-pair wave) variants.  Each wave is
    held whole against the plain version (so the exit steps that its bound
    counts are checked), and its block 0 timed on its own; the full-width
    kernel, heuristic and exact, is timed on the same score wave."""
    from repro_torch.core.engine import AlignmentEngine
    from repro_torch.data.reads import ReadPairSpec, generate_pairs
    P, plen, T, tlen = generate_pairs(ReadPairSpec(
        n_pairs=LONG_PAIRS, read_len=LONG_LEN, edit_frac=LONG_EDIT, seed=0))
    pen, heur = S.GapAffine(4, 6, 2), S.AdaptiveBand()
    eng = AlignmentEngine(pen, backend="kernel", edit_frac=LONG_EDIT,
                          device=dev)
    s1, k1 = eng._bounds_for_bucket(LONG_BUCKET, plen, tlen, False)
    k_pad = -(-(2 * k1 + 1) // 128) * 128
    cap = ops._band_lanes(heur.band_cap(2 * k1 + 1), k_pad)
    args = wave_inputs(P, plen, T, tlen, LONG_PAIRS,
                       max(P.shape[1], T.shape[1]), dev)
    n = ROOT_PLAIN_PAIRS
    out = {}
    for trace, pairs in ((False, LONG_PAIRS), (True, BAND_PACKED_PAIRS)):
        wave = tuple(a[:pairs] for a in args)
        kw = dict(pen=pen, s_max=s1, k_pad=k_pad, block_pairs=8,
                  trace=trace, heur=heur)
        got = K.wfa_cuda(*wave, band_cap=cap, **kw)
        torch_sync()
        t0 = time.perf_counter()
        want = K.wfa_plain(*wave, band_cap=cap, **kw)
        torch_sync()
        p_ms = (time.perf_counter() - t0) * 1e3
        err = max_abs_err(got, want)
        del want
        if err:
            raise AssertionError(f"band kernel != plain at the 10 kb shape "
                                 f"(trace={trace}): max|err|={err}")
        out_bytes = sum(t.numel() * t.element_size() for t in got)
        steps = got[1][:, 0].cpu().numpy()
        del got
        k_ms = cuda_ms(lambda: K.wfa_cuda(*wave, band_cap=cap, **kw), 3)
        k_ms_n = cuda_ms(lambda: K.wfa_cuda(*(a[:n] for a in wave),
                                            band_cap=cap, **kw), 3)
        bound, by, bytes_ms, ops_ms, cells, nops = band_bound(
            K, pen, steps, cap, kw["block_pairs"], s1, k_pad, plen[:pairs],
            tlen[:pairs], out_bytes)
        name = "wfa_band_trace" if trace else "wfa_band_score"
        rec = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                   block0_ms=k_ms_n, block_pairs=n, pairs=pairs,
                   bound_ms=bound, bound_by=by, bytes_bound_ms=bytes_ms,
                   ops_bound_ms=ops_ms, window_cells=cells, band=cap,
                   k_pad=k_pad, s_max=s1, block0_steps=int(steps[0]),
                   max_steps=int(steps.max()))
        log(f"[band] {name}: {pairs} pairs of {LONG_LEN} bp, s_max={s1} "
            f"k_pad={k_pad}, band {cap}; block exit steps: block 0 "
            f"{int(steps[0])}, max {int(steps.max())}: kernel {k_ms:.3f} ms "
            f"({k_ms_n:.3f} ms on block 0, the first {n}), plain "
            f"{p_ms:.1f} ms on all {pairs} (equal); bound {bound:.5f} ms "
            f"({by}): bytes {bytes_ms:.5f} ms, operations {ops_ms:.5f} ms "
            f"({cells:,} reachable window cells x {BAND_OPS_PER_CELL} + one "
            f"compare per aligned column = {nops:,})")
        if not trace:
            full = K.wfa_cuda(*wave, **kw)[0]
            band = K.wfa_cuda(*wave, band_cap=cap, **kw)[0]
            rec["equal_full_width"] = int((full == band).sum())
            rec["full_heur_ms"] = cuda_ms(lambda: K.wfa_cuda(*wave, **kw), 2)
            rec["full_exact_ms"] = cuda_ms(
                lambda: K.wfa_cuda(*wave, **{**kw, "heur": None}), 2)
            log(f"[band] same wave at full width (k_pad {k_pad}): "
                f"AdaptiveBand() {rec['full_heur_ms']:.3f} ms, exact "
                f"{rec['full_exact_ms']:.3f} ms; band / full-width "
                f"heuristic {k_ms / rec['full_heur_ms']:.4f}; "
                f"{rec['equal_full_width']}/{pairs} scores equal the "
                f"full-width heuristic kernel's")
        out[name] = rec
    return out


def rescore_all(res, P, plen, T, tlen, pen):
    """Re-score every CIGAR of ``res`` -> number re-scored (raises on any
    CIGAR that does not cost its reported score or does not consume both
    sequences)."""
    from repro_torch.core.gotoh import score_cigar
    triple = pen.as_penalties()
    for i, c in enumerate(res.cigars):
        if res.scores[i] < 0:
            raise AssertionError(f"pair {i} unresolved on the CIGAR path")
        pa, ta = P[i, :plen[i]], T[i, :tlen[i]]
        cost, ci, cj, ok = score_cigar(c, pa, ta, triple)
        if not ok or cost != res.scores[i] or ci != plen[i] \
                or cj != tlen[i]:
            raise AssertionError(f"CIGAR of pair {i} re-scores to {cost} "
                                 f"(ok={ok}, consumed {ci}/{cj}), reported "
                                 f"{res.scores[i]}")
    return len(res.cigars)


def phase_band_path(K, S, dev):
    """Phase 10: the banded path through the engine, then the yardsticks ->
    (launches, summary dict)."""
    import numpy as np
    from repro_torch.core.engine import AlignmentEngine
    from repro_torch.core.gotoh import gotoh_score_vec
    from repro_torch.core.session import run_streamed
    from repro_torch.data.reads import ReadPairSpec, generate_pairs
    from repro_torch.obs import trace
    P, plen, T, tlen = generate_pairs(ReadPairSpec(
        n_pairs=LONG_PAIRS, read_len=LONG_LEN, edit_frac=LONG_EDIT, seed=0))
    pen, heur = S.GapAffine(4, 6, 2), S.AdaptiveBand()
    n64 = BAND_PACKED_PAIRS
    sub = lambda a: a[:n64]
    auto = {"band_cap": "auto"}
    mk = lambda backend, **kw: AlignmentEngine(
        pen, backend=backend, edit_frac=LONG_EDIT, heuristic=heur,
        device=dev, **kw)
    summary = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        res = fn()
        wall = time.perf_counter() - t0
        st = res[2] if isinstance(res, tuple) else res.stats
        summary[name] = dict(wall_s=wall, t_kernel=st.t_kernel,
                             t_scatter=st.t_scatter, t_gather=st.t_gather)
        log(f"[banded] {name}: wall {wall:.2f}s (scatter "
            f"{st.t_scatter:.3f}s, kernel {st.t_kernel:.3f}s, gather "
            f"{st.t_gather:.3f}s)")
        return res

    def checks(name, fn):
        """fn() again with the port's tracer on, timed as ``name`` -> seconds
        in the band kernel's byte check of the codes (span
        band.check_codes)."""
        trace.reset()
        trace.enable()
        try:
            timed(name, fn)
        finally:
            trace.disable()
        sec = sum(e["dur"] for e in trace.events()
                  if e.get("name") == "band.check_codes") / 1e6
        trace.reset()
        return sec

    eng = mk("kernel", backend_opts=auto)
    eng.align_packed(P, plen, T, tlen)              # warmup
    K.reset_launches()
    t0 = time.perf_counter()
    score = timed("kernel score sync",
                  lambda: eng.align_packed(P, plen, T, tlen))
    stream = timed("kernel score stream", lambda: run_streamed(
        eng, P, plen, T, tlen, submit_pairs=LONG_PAIRS // 4,
        output="score"))
    bidir_run = lambda: eng.align_packed(P, plen, T, tlen, output="cigar",
                                         trace_variant="bidir")
    bidir = timed("kernel cigar bidir", bidir_run)
    packed = timed("kernel cigar packed", lambda: eng.align_packed(
        sub(P), sub(plen), sub(T), sub(tlen), output="cigar"))
    launches = dict(K.LAUNCHES)
    log(f"[banded] kernel path in {time.perf_counter() - t0:.1f}s; "
        f"launches {launches}")
    # the byte check's seconds from a second, traced run of the score and
    # bidir runs (their walls above are untraced; these reruns come after
    # the path's launch counts are read)
    chk_score = checks("kernel score sync traced",
                       lambda: eng.align_packed(P, plen, T, tlen))
    chk_bidir = checks("kernel cigar bidir traced", bidir_run)
    summary["band_check_codes_s"] = dict(score_sync=chk_score,
                                         cigar_bidir=chk_bidir)
    log(f"[banded] band code check (a reduction and a sync per band "
        f"launch): {chk_score:.4f} s of the traced score run's wall "
        f"{summary['kernel score sync traced']['wall_s']:.4f} s (untraced "
        f"{summary['kernel score sync']['wall_s']:.4f} s), {chk_bidir:.4f} s "
        f"of the traced bidir run's "
        f"{summary['kernel cigar bidir traced']['wall_s']:.4f} s (untraced "
        f"{summary['kernel cigar bidir']['wall_s']:.4f} s)")
    if not (launches["score_band"] and launches["trace_band"]
            and launches["meet"]):
        raise AssertionError(f"the banded path missed a kernel: {launches}")
    for name, sc in (("streamed", stream[0]), ("bidir", bidir.scores),
                     ("packed", packed.scores)):
        ref = score.scores[:len(sc)]
        if not np.array_equal(sc, ref):
            raise AssertionError(f"the {name} run's scores differ from the "
                                 f"blocking score run on "
                                 f"{int((sc != ref).sum())} pairs")
    st = bidir.stats
    log(f"[banded] bidir: n_meet_unmet={st.n_meet_unmet} "
        f"n_bidir_fallback={st.n_bidir_fallback} "
        f"peak_trace_bytes={st.peak_trace_bytes:,}")
    if st.n_meet_unmet or st.n_bidir_fallback:
        raise AssertionError(f"the banded BiWFA path left meets unused: "
                             f"n_meet_unmet={st.n_meet_unmet} "
                             f"n_bidir_fallback={st.n_bidir_fallback}")
    t0 = time.perf_counter()
    n_rescored = rescore_all(bidir, P, plen, T, tlen, pen) \
        + rescore_all(packed, sub(P), sub(plen), sub(T), sub(tlen), pen)
    log(f"[banded] {n_rescored} CIGARs (bidir {LONG_PAIRS}, packed {n64}) "
        f"re-score to their costs ({time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    triple = pen.as_penalties()
    for i in range(4):
        g = gotoh_score_vec(P[i, :plen[i]], T[i, :tlen[i]], triple)
        if score.scores[i] < g:
            raise AssertionError(f"pair {i}: banded score "
                                 f"{score.scores[i]} below Gotoh {g}")
        log(f"[banded] pair {i}: banded {score.scores[i]} >= Gotoh {g}")
    log(f"[banded] Gotoh on 4 pairs in {time.perf_counter() - t0:.1f}s")

    # yardsticks: the ring backend (one window per pair), the full-width
    # heuristic kernel, the exact kernel
    ring = mk("ring", backend_opts=auto)
    r_score = timed("ring score sync",
                    lambda: ring.align_packed(P, plen, T, tlen))
    r_bidir = timed("ring cigar bidir", lambda: ring.align_packed(
        P, plen, T, tlen, output="cigar", trace_variant="bidir"))
    r_packed = timed("ring cigar packed", lambda: ring.align_packed(
        sub(P), sub(plen), sub(T), sub(tlen), output="cigar"))
    rescore_all(r_packed, sub(P), sub(plen), sub(T), sub(tlen), pen)
    if r_bidir.stats.n_bidir_fallback or r_bidir.stats.n_meet_unmet:
        raise AssertionError("the ring's banded BiWFA path fell back")
    full = mk("kernel")
    full.align_packed(P, plen, T, tlen)             # warmup
    f_score = timed("kernel full-width heuristic score sync",
                    lambda: full.align_packed(P, plen, T, tlen))
    exact = AlignmentEngine(pen, backend="kernel", edit_frac=LONG_EDIT,
                            device=dev)
    exact.align_packed(P, plen, T, tlen)            # warmup
    e_score = timed("kernel full-width exact score sync",
                    lambda: exact.align_packed(P, plen, T, tlen))
    eq = lambda a, b: int((a == b).sum())
    summary["counts"] = counts = dict(
        kernel_band_eq_full=eq(score.scores, f_score.scores),
        ring_band_eq_full=eq(r_score.scores, f_score.scores),
        kernel_band_eq_ring_band=eq(score.scores, r_score.scores),
        ring_bidir_eq_ring_score=eq(r_bidir.scores, r_score.scores),
        kernel_band_eq_exact=eq(score.scores, e_score.scores),
        full_eq_exact=eq(f_score.scores, e_score.scores))
    log(f"[banded] of {LONG_PAIRS} pairs: kernel band = full-width "
        f"heuristic on {counts['kernel_band_eq_full']}, ring band = "
        f"full-width heuristic on {counts['ring_band_eq_full']}, kernel "
        f"band (per block) = ring band (per pair) on "
        f"{counts['kernel_band_eq_ring_band']}; = exact: kernel band "
        f"{counts['kernel_band_eq_exact']}, full-width heuristic "
        f"{counts['full_eq_exact']}; mean cost banded "
        f"{score.scores.mean():.2f}, exact {e_score.scores.mean():.2f}")
    summary["streamed_wall_s"] = stream[3]
    return launches, summary


def attention_bound(B, Sq, Sk, H, KV, dh, causal):
    """The least time the card could take for one bf16 attention -> (ms,
    "bytes" | "operations"): q, k, v read once and o written once over the
    memory rate; 4 * dh FLOPs per (query head, query, key) pair the mask
    keeps (Sq (Sq + 1) / 2 pairs per head under causal, from position 0)
    over the tensor cores' bf16 rate."""
    pairs = Sq * (Sq + 1) // 2 if causal else Sq * Sk
    flops = 4 * dh * B * H * pairs
    nbytes = 2 * dh * B * (2 * Sq * H + 2 * Sk * KV)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations")


def flash_bodies(q):
    """The CUDA bodies that take these inputs, the default first: wgmma,
    mma.sync and the fp32 pipes for bf16 at dh 64 and 128, else the fp32
    pipes."""
    import torch
    if q.dtype == torch.bfloat16 and q.shape[3] in (64, 128):
        return ("wgmma", "mma_sync", "fp32_pipes")
    return ("fp32_pipes",)


def flash_pair(FK, fops, q, k, v, causal):
    """({body: output}, plain output) on the same inputs, padded as the ops
    wrapper pads them, sliced back to Sq.  The default call must take the
    first of :func:`flash_bodies`; the others run by name; each counts one
    launch under its body."""
    import torch
    Sq = q.shape[1]
    qp, kp, vp, bq, bk = fops.pad_blocks(q, k, v, causal=causal)
    bodies = flash_bodies(q)
    before = dict(FK.PATH_LAUNCHES)
    outs = {bodies[0]: FK.flash_attention_cuda(qp, kp, vp, causal=causal,
                                               block_q=bq, block_k=bk)}
    for body in bodies[1:]:
        outs[body] = FK.flash_attention_cuda(qp, kp, vp, causal=causal,
                                             block_q=bq, block_k=bk,
                                             body=body)
    ran = {key: FK.PATH_LAUNCHES[key] - before[key] for key in before}
    if ran != {key: int(key in bodies) for key in before}:
        raise AssertionError(f"{q.dtype} dh {q.shape[3]} ran the bodies "
                             f"{ran}, not {bodies}")
    torch.cuda.synchronize()
    want = FK.flash_attention_plain(qp, kp, vp, causal=causal, block_q=bq,
                                    block_k=bk)
    return {b: o[:, :Sq] for b, o in outs.items()}, want[:, :Sq]


def bf16_ulp(x):
    """One bf16 ulp (8 significant bits) at each |x|, in fp32."""
    import torch
    _, e = torch.frexp(x.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(e, dtype=torch.float32), e - 8)


def flash_check(got, want):
    """-> (max |got - want|, the largest share of a limit): max |err|
    against FLASH_TOL, and in bf16 also each |err| against FLASH_BF16_ULPS
    ulps of |want| + FLASH_BF16_FLOOR x its row's mean |want|.  Passes when
    the share <= 1."""
    import torch
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{tuple(got.shape)} {got.dtype} != "
                             f"{tuple(want.shape)} {want.dtype}")
    dname = str(want.dtype).replace("torch.", "")
    w = want.float()
    diff = (got.float() - w).abs()
    err = float(diff.max())
    share = err / FLASH_TOL[dname]
    if want.dtype == torch.bfloat16:
        w = w.abs()
        limit = (FLASH_BF16_ULPS * bf16_ulp(w)
                 + FLASH_BF16_FLOOR * w.mean(dim=-1, keepdim=True))
        share = max(share, float((diff / limit).max()))
    return err, share


def flash_worst(got, want) -> str:
    """The largest share of the elementwise bf16 limit alone, where it is
    taken, and what that element and its row hold."""
    import torch
    w = want.float()
    a = w.abs()
    ulps = FLASH_BF16_ULPS * bf16_ulp(a)
    floor = (FLASH_BF16_FLOOR * a.mean(dim=-1, keepdim=True)).expand_as(a)
    share = (got.float() - w).abs() / (ulps + floor)
    idx = torch.unravel_index(share.flatten().argmax(), share.shape)
    idx = tuple(int(i) for i in idx)
    return (f"{float(share[idx]):.3f} at [b, pos, head, dim] {list(idx)}: "
            f"want {float(w[idx]):.6g}, "
            f"got {float(got[idx]):.6g}, {FLASH_BF16_ULPS} ulps "
            f"{float(ulps[idx]):.3g} + floor {float(floor[idx]):.3g}; row "
            f"max |want| {float(a[idx[:3]].max()):.4g}")


def attention_fp32(q, k, v, causal, drop=None):
    """Materialised attention in fp32, p rounded to v's type as the kernel
    rounds it, but against each row's final max; keys drop = (k0, k1) are
    left out of every row (the planted fault)."""
    import math
    import torch
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.float().reshape(B, Sq, KV, G, dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) / math.sqrt(dh)
    keep = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        keep = torch.tril(keep)
    if drop is not None:
        keep[:, drop[0]:drop[1]] = False
    s = torch.where(keep, s, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1).permute(0, 3, 1, 2)[..., None]      # [B, Sq, KV, G, 1]
    del s
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), v.float())
    return (o / l).reshape(B, Sq, H, dh).to(q.dtype)


def phase_flash_grid(FK, fops, dev):
    """Phase 11a: every CUDA flash body that takes the inputs against the
    plain version over {MHA 8/8, GQA 16/8, MQA 16/1, 64/8 (qwen3-32b, G 8),
    48/1 (granite-34b, G 48: 96 live rows of the wgmma body's 128)} x
    {causal, non-causal} x {fp32, bf16} x dh {64, 128}, B 2, S in {128,
    250, 1,024, 2,048} (non-causal only where S is a block multiple), plus
    non-causal Sq 128 over Sk 1,024 -> max |err| per dtype and the worst
    share of the limits per body."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(14)
    worst = {name: 0.0 for name in FLASH_TOL}
    share = {body: 0.0 for body in FK.PATH_LAUNCHES}
    n = 0
    for H, KV in ((8, 8), (16, 8), (16, 1), (64, 8), (48, 1)):
        for dname in FLASH_TOL:
            dt = getattr(torch, dname)
            for dh in (64, 128):
                cases = [(S, S, True) for S in (128, 250, 1024, 2048)]
                cases += [(S, S, False) for S in (128, 1024, 2048)]
                cases.append((128, 1024, False))
                for Sq, Sk, causal in cases:
                    rnd = lambda *shape: (torch.randn(
                        shape, generator=gen, device=dev) * 0.5).to(dt)
                    q = rnd(2, Sq, H, dh)
                    k, v = rnd(2, Sk, KV, dh), rnd(2, Sk, KV, dh)
                    outs, want = flash_pair(FK, fops, q, k, v, causal)
                    for body, got in outs.items():
                        e, sh = flash_check(got, want)
                        if not sh <= 1:
                            raise AssertionError(
                                f"flash body {body} != plain: H {H} KV {KV} "
                                f"{dname} dh {dh} Sq {Sq} Sk {Sk} causal "
                                f"{causal}: max |err| {e}, {sh:.3g} of the "
                                f"limit; {flash_worst(got, want)}")
                        worst[dname] = max(worst[dname], e)
                        share[body] = max(share[body], sh)
                    n += 1
    log(f"[flash] every body = plain on {n} cases (bf16 at dh 64 / 128: "
        f"wgmma, mma.sync and the fp32 pipes): max |err| fp32 "
        f"{worst['float32']:.3g} (tol 3e-5), bf16 {worst['bfloat16']:.3g} "
        f"(tol 2e-2, and {FLASH_BF16_ULPS} ulps of |want| + "
        f"{FLASH_BF16_FLOOR} x the row's mean |want| elementwise); worst "
        f"share of these limits by body " + ", ".join(
            f"{body} {sh:.3f}" for body, sh in share.items()))
    return worst, share


def phase_flash_control(FK, dev):
    """Phase 11b: the bf16 check must pass a sound attention and fail one
    that leaves a key tile out.  At S 2,048 (GQA 16/8, dh 128, B 2, causal
    and not), against the plain version (512-key tiles): the plain version
    on 64-key tiles, the materialised fp32 attention (p rounded against
    each row's final max) and the wgmma body must pass; the materialised
    attention with keys 1,024-1,087 dropped and the wgmma body with its
    128-key tile 8 (keys 1,024-1,151) dropped must fail."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(2049)
    rnd = lambda *shape: (torch.randn(shape, generator=gen, device=dev)
                          * 0.5).to(torch.bfloat16)
    S, drop, tile = 2048, (1024, 1088), 8
    q, k, v = rnd(2, S, 16, 128), rnd(2, S, 8, 128), rnd(2, S, 8, 128)
    out = []
    for causal in (True, False):
        want = FK.flash_attention_plain(q, k, v, causal=causal)
        tiled = flash_check(FK.flash_attention_plain(
            q, k, v, causal=causal, block_q=64, block_k=64), want)
        sound = flash_check(attention_fp32(q, k, v, causal), want)
        fault = flash_check(attention_fp32(q, k, v, causal, drop), want)
        body = flash_check(FK.flash_attention_cuda(
            q, k, v, causal=causal, body="wgmma"), want)
        body_fault = flash_check(FK.flash_attention_cuda(
            q, k, v, causal=causal, body="wgmma", drop_key_tile=tile), want)
        if not max(tiled[1], sound[1], body[1]) <= 1:
            raise AssertionError(f"the bf16 check fails a sound attention "
                                 f"(causal {causal}): 64-key tiles {tiled}, "
                                 f"materialised {sound}, wgmma {body}")
        if not min(fault[1], body_fault[1]) > 1:
            raise AssertionError(f"the bf16 check passes a dropped key tile "
                                 f"(causal {causal}): materialised {fault}, "
                                 f"wgmma {body_fault}")
        out.append(f"causal {causal}: 64-key tiles {tiled[1]:.3f}, "
                   f"materialised {sound[1]:.3f}, wgmma {body[1]:.3f}; "
                   f"dropped tile: materialised {fault[1]:.2f}, wgmma "
                   f"{body_fault[1]:.2f} of the limit (max |err| "
                   f"{fault[0]:.3g}, {body_fault[0]:.3g})")
    log(f"[flash] bf16 check control at S {S}: " + "; ".join(out))


def phase_flash_timing(FK, fops, dev):
    """Phase 11c: at the served shape (B 8, S 2,048, H 16, KV 8, dh 128,
    bf16, causal) the wgmma body (the path's), the mma.sync and fp32-pipe
    bodies, the plain version and one PyTorch call that computes the same
    function (scaled_dot_product_attention, the yardstick, never on the
    port's path), each timed with CUDA events, in turns: once in that order
    and once in the reverse; each time is the mean of its two turns."""
    import torch
    import torch.nn.functional as F
    B, S, H, KV, dh = LM_BATCH, LM_PROMPT, 16, 8, 128
    gen = torch.Generator(device=dev).manual_seed(2048)
    rnd = lambda *shape: (torch.randn(shape, generator=gen, device=dev)
                          * 0.5).to(torch.bfloat16)
    q, k, v = rnd(B, S, H, dh), rnd(B, S, KV, dh), rnd(B, S, KV, dh)
    outs, want = flash_pair(FK, fops, q, k, v, True)
    checks = {body: flash_check(got, want) for body, got in outs.items()}
    if not max(sh for _, sh in checks.values()) <= 1:
        raise AssertionError(f"flash bodies != plain at the served shape: "
                             f"{checks}")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)
    lib_err = flash_check(sdpa().transpose(1, 2), want)[0]
    runs = {  # name: (fn, repetitions)
        "wgmma": (lambda: FK.flash_attention_cuda(q, k, v, causal=True), 50),
        "mma_sync": (lambda: FK.flash_attention_cuda(
            q, k, v, causal=True, body="mma_sync"), 20),
        "fp32_pipes": (lambda: FK.flash_attention_cuda(
            q, k, v, causal=True, body="fp32_pipes"), 5),
        "plain": (lambda: FK.flash_attention_plain(q, k, v, causal=True), 3),
        "library": (sdpa, 50)}
    turns = {name: [] for name in runs}
    for order in (list(runs), list(runs)[::-1]):
        for name in order:
            turns[name].append(cuda_ms(*runs[name]))
    ms = {name: sum(t) / len(t) for name, t in turns.items()}
    bound_ms, bound_by = attention_bound(B, S, S, H, KV, dh, True)
    log(f"[flash] served shape B {B} S {S} H {H} KV {KV} dh {dh} bf16 "
        f"causal, bound {bound_ms:.4f} ms ({bound_by}); ms (two turns) and "
        f"share of the bound: " + "; ".join(
            f"{name} {ms[name]:.4f} ({', '.join(f'{t:.4f}' for t in turns[name])}"
            f") {100 * bound_ms / ms[name]:.2f}%" for name in runs)
        + "; |err| vs plain " + ", ".join(
            f"{body} {e:.3g} ({sh:.3f} of the limit)"
            for body, (e, sh) in checks.items())
        + f", scaled_dot_product_attention {lib_err:.3g}; wgmma "
        f"{ms['mma_sync'] / ms['wgmma']:.2f}x faster than mma.sync, "
        f"{ms['wgmma'] / ms['library']:.2f}x the library call's time")
    return dict(ms=ms["wgmma"], mma_sync_ms=ms["mma_sync"],
                fma_ms=ms["fp32_pipes"], plain_ms=ms["plain"],
                library_ms=ms["library"], bound_ms=bound_ms,
                bound_by=bound_by,
                max_abs_err=max(e for e, _ in checks.values()),
                share=max(sh for _, sh in checks.values()))


def phase_serve_defaults(FK):
    """Phase 12a: the JAX defaults through the port's launcher at full width
    (``serve.main(["--arch", "qwen3-0.6b"])``: 8 requests of 4-16 tokens,
    32 new each, batch 4, two waves); every prefill layer must launch the
    flash kernel, on the wgmma body."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    n_layers = get_config(LM_ARCH).n_layers
    FK.reset_launches()
    t0 = time.perf_counter()
    rc = serve.main(["--arch", LM_ARCH])
    wall = time.perf_counter() - t0
    launches = FK.LAUNCHES["flash_attention"]
    if rc != 0:
        raise AssertionError("serve.main failed")
    if launches != 2 * n_layers:
        raise AssertionError(f"two prefills launched the flash kernel "
                             f"{launches} times, not {2 * n_layers}")
    if FK.PATH_LAUNCHES["wgmma"] != launches:
        raise AssertionError(f"the prefills ran the flash bodies "
                             f"{FK.PATH_LAUNCHES}, not all on wgmma")
    log(f"[serve] launcher defaults ({LM_ARCH}, 2 waves) in {wall:.1f}s "
        f"(weights made on the card included); flash launches {launches}")
    return launches


def phase_serve_long(FK, dev, card):
    """Phase 12b: one BatchServer wave of 8 prompts of 2,048 tokens, 32 new
    each, max_seq 4,096, at full width.  The prefill must launch the flash
    kernel once per layer; each launch is held against the plain version on
    its own inputs; for 2 requests the logits of prefill + decode (plain
    attention over the cache) must equal those of one forward (flash kernel)
    over prompt + generated tokens within the stated bf16 tolerance."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import BatchServer
    from repro_torch.models import layers as LM
    from repro_torch.models import transformer as TFM

    cfg = get_config(LM_ARCH)
    params = TFM.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    server = BatchServer(cfg, params, max_seq=LM_MAX_SEQ, batch=LM_BATCH,
                         device=dev)
    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, cfg.vocab_size, size=LM_PROMPT)
               .astype(np.int32) for _ in range(LM_BATCH)]
    logits, times, captured = [], {"prefill": 0.0, "decode": 0.0}, []
    prefill, step = server._prefill, server._step
    launch = FK.flash_attention_cuda

    def capturing(q, k, v, **kw):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        o = launch(q, k, v, **kw)
        ev[1].record()
        captured.append((q, k, v, kw, o, ev))
        return o

    def timed(name, fn):
        def run(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            times[name] += time.perf_counter() - t0
            logits.append(out[0][:LM_E2E_ROWS].clone())
            return out
        return run

    def prefill_capturing(*a):
        FK.flash_attention_cuda = capturing
        try:
            return prefill(*a)
        finally:
            FK.flash_attention_cuda = launch

    sdpa, sdpa_events = LM._sdpa, []

    def sdpa_timed(*a):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = sdpa(*a)
        ev[1].record()
        sdpa_events.append(ev)
        return out

    def step_timing_attention(*a):
        LM._sdpa = sdpa_timed
        try:
            return step(*a)
        finally:
            LM._sdpa = sdpa

    server._prefill = timed("prefill", prefill_capturing)
    server._step = timed("decode", step_timing_attention)
    FK.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outs = server.generate(prompts, max_new=LM_NEW)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = FK.LAUNCHES["flash_attention"]
    if launches != cfg.n_layers or len(captured) != cfg.n_layers:
        raise AssertionError(f"the prefill launched the flash kernel "
                             f"{launches} times, not {cfg.n_layers}")
    if FK.PATH_LAUNCHES["wgmma"] != launches:
        raise AssertionError(f"the prefill ran the flash bodies "
                             f"{FK.PATH_LAUNCHES}, not all on wgmma")
    if any(len(o) != LM_PROMPT + LM_NEW for o in outs):
        raise AssertionError(f"lengths {[len(o) for o in outs]}")
    n_steps = len(logits) - 1
    prefill_tps = LM_BATCH * LM_PROMPT / times["prefill"]
    decode_tps = LM_BATCH * n_steps / times["decode"]
    flash_s = sum(ev[0].elapsed_time(ev[1]) for *_, ev in captured) / 1e3
    sdpa_s = sum(a.elapsed_time(b) for a, b in sdpa_events) / 1e3
    log(f"[serve] {LM_ARCH} wave of {LM_BATCH} x {LM_PROMPT} tokens, "
        f"{LM_NEW} new, max_seq {LM_MAX_SEQ}: prefill {times['prefill']:.3f}s "
        f"({prefill_tps:,.0f} tokens/s; the {len(captured)} flash launches "
        f"{flash_s:.4f}s of it by CUDA events), decode {n_steps} steps in "
        f"{times['decode']:.3f}s ({decode_tps:,.1f} tokens/s; plain "
        f"attention over the cache {sdpa_s:.4f}s of it), wall "
        f"{wall:.2f}s, peak memory {peak / 2**30:.2f} GiB on {card}")

    # every flash launch of the prefill against the plain version
    err = share = 0.0
    where = ""
    for layer, (q, k, v, kw, o, _) in enumerate(captured):
        want = FK.flash_attention_plain(q, k, v, **kw)
        e, sh = flash_check(o, want)
        if not sh <= 1:
            raise AssertionError(f"a prefill flash launch != plain: max "
                                 f"|err| {e}, {sh:.3g} of the limit")
        if sh > share:
            where = f"{flash_worst(o, want)} in layer {layer}"
        err, share = max(err, e), max(share, sh)
    shape = tuple(captured[0][0].shape)
    del captured
    log(f"[serve] {cfg.n_layers} prefill flash launches (q {shape}, all on "
        f"the wgmma body) = plain: max |err| {err:.3g} (tol 2e-2), worst "
        f"share {share:.3f} of the limits; of the elementwise limit alone "
        f"{where}")

    # prefill + decode logits against one forward over the same tokens
    seq = torch.as_tensor(np.stack(outs[:LM_E2E_ROWS]), device=dev).long()
    FK.reset_launches()
    with torch.inference_mode():
        full, _ = TFM.forward(params, cfg, seq)
    if FK.LAUNCHES["flash_attention"] != cfg.n_layers:
        raise AssertionError("forward did not run the flash kernel per layer")
    ref = full[:, LM_PROMPT - 1:LM_PROMPT - 1 + len(logits)].float()
    dec = torch.stack(logits, dim=1)
    diff = (dec - ref).abs()
    e2e = dict(max=float(diff.max()), mean=float(diff.mean()),
               logit_std=float(ref.std()),
               argmax_agree=float((dec.argmax(-1) == ref.argmax(-1))
                                  .float().mean()))
    log(f"[serve] prefill + decode vs forward, {LM_E2E_ROWS} requests x "
        f"{len(logits)} positions: max |dlogit| {e2e['max']:.4f} (tol "
        f"{LM_E2E_MAX_TOL}), mean {e2e['mean']:.5f} (tol {LM_E2E_MEAN_TOL}), "
        f"logit std {e2e['logit_std']:.3f}, greedy tokens agree on "
        f"{100 * e2e['argmax_agree']:.1f}%")
    if not (e2e["max"] <= LM_E2E_MAX_TOL and e2e["mean"] <= LM_E2E_MEAN_TOL):
        raise AssertionError(f"prefill + decode logits != forward: {e2e}")
    if not torch.isfinite(dec).all():
        raise AssertionError("non-finite logits")
    return dict(launches=launches, max_abs_err=err, share=share)


def phase_obs(K):
    """Phase 13: two traced streamed runs of the launcher on the kernel
    backend (scores, then ``--output cigar``) and one traced blocking run,
    read back by the port's ``analyze`` and ``obs_report`` -> (launches,
    per-run report, the score run's scores)."""
    import tempfile

    import numpy as np
    from repro_torch.launch import align
    from repro_torch.obs import analyze, trace

    common = ["--backend", "kernel", "--pairs", str(WAVE), "--read-len",
              str(READ_LEN), "--edit-frac", str(EDIT_FRAC), "--chunk-pairs",
              str(OBS_WAVE), "--verify", "512", "--device", "cuda"]
    launches, report, scores = {"score": 0, "trace": 0}, {}, None
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name, mode, extra, variant in (
                ("score", "stream", [], "score"),
                ("cigar", "stream", ["--output", "cigar"], "trace"),
                ("sync", "sync", [], "score")):
            paths[name] = os.path.join(tmp, f"{name}.json")
            summary = {}
            trace.reset()
            K.reset_launches()
            rc = align.main([*common, "--mode", mode, *extra,
                             "--trace-out", paths[name]], summary)
            got = dict(K.LAUNCHES)
            trace.reset()
            if rc != 0 or summary.get("verified") != 512:
                raise AssertionError(f"the traced {name} run failed")
            if got[variant] == 0:
                raise AssertionError(f"the traced {name} run launched no "
                                     f"{variant} kernel: {got}")
            if scores is None:
                scores = summary["scores"]
            elif not np.array_equal(scores, summary["scores"]):
                raise AssertionError(f"the traced {name} run's scores "
                                     f"differ from the score run's")
            for k in launches:
                launches[k] += got[k]
            tr = analyze.Trace.from_file(paths[name])
            pt = analyze.phase_accounting(tr)
            rep = analyze.pipeline_analysis(tr)
            waves = pt.get("kernel").count
            if mode == "stream" and waves != summary["stream_waves"]:
                raise AssertionError(
                    f"{waves} wave.kernel spans for "
                    f"{summary['stream_waves']} waves of the session ({name})")
            if waves < WAVE // OBS_WAVE or pt.get("scatter").count != waves:
                raise AssertionError(
                    f"{pt.get('scatter').count} wave.scatter and {waves} "
                    f"wave.kernel spans for {WAVE // OBS_WAVE} or more "
                    f"waves ({name})")
            billed = summary[mode]["t_kernel"]
            device_s = None
            if mode == "sync":
                # a blocking session times each kernel by CUDA events (copy
                # in done to kernel done) and writes it into its wave's
                # wave.scatter span, which waits for that kernel on the
                # host: each device interval must lie inside its span (2 us
                # for the trace's rounding), and the spans' device seconds
                # must add up to the session's kernel phase
                dev = [sp for sp in tr.spans if sp.name == "wave.scatter"]
                if any("t_kernel" not in sp.args for sp in dev):
                    raise AssertionError("a blocking wave.scatter span "
                                         "lacks its t_kernel")
                device_s = sum(sp.args["t_kernel"] for sp in dev)
                over = [(sp.args["t_kernel"] * 1e6, sp.dur) for sp in dev
                        if not 0 < sp.args["t_kernel"] * 1e6 <= sp.dur + 2]
                if over:
                    raise AssertionError(
                        f"kernel seconds by CUDA events outside their "
                        f"host spans (us, us): {over[:4]}")
                if abs(device_s - billed) > 1e-9 * len(dev) + 1e-12:
                    raise AssertionError(
                        f"the spans' kernel seconds {device_s!r} against "
                        f"the session's {billed!r}")
            span_s = pt.total_s("kernel")
            shares = {ph: pt.share(ph) for ph in analyze.PHASE_ORDER
                      if ph in pt.stats}
            report[name] = {
                "mode": mode, "waves": waves, "launches": got,
                "shares": shares,
                "phase_s": {ph: pt.total_s(ph) for ph in shares},
                "wall_s": pt.wall_us / 1e6,
                "kernel_span_s": span_s, "kernel_billed_s": billed,
                "kernel_events_s": device_s,
                "busy_s": rep.busy_us / 1e6, "span_s": rep.span_us / 1e6,
                "bubbles": len(rep.bubbles),
                "bubble_s": rep.bubble_us / 1e6,
                "host_overlap": rep.host_overlap_frac,
                "mean_inflight": rep.mean_inflight,
                "total_pairs_per_s": summary[mode]["total_pairs_per_s"]}
            events = ("" if device_s is None else
                      f", kernels by CUDA events {device_s:.6f} s")
            log(f"[obs] {name} ({mode}): {waves} waves, launches {got}; "
                f"phase shares " + ", ".join(f"{ph} {v:.4f}" for ph, v
                                             in shares.items())
                + f" of {sum(report[name]['phase_s'].values()):.4f} s "
                f"accounted; wave.kernel spans {span_s:.6f} s (session "
                f"kernel phase {billed:.6f} s{events}); in flight (host "
                f"view) {rep.busy_us / 1e6:.4f} of {rep.span_us / 1e6:.4f} "
                f"s, {len(rep.bubbles)} bubbles ({rep.bubble_us / 1e6:.6f} "
                f"s), host overlap {rep.host_overlap_frac:.4f}, mean depth "
                f"{rep.mean_inflight:.3f}")
        for args in ([paths["score"], "--assert-phases"],
                     [paths["cigar"], "--assert-phases"],
                     [paths["sync"], "--assert-phases"],
                     ["--diff", paths["score"], paths["cigar"]]):
            r = subprocess.run([sys.executable, "-m",
                                "repro_torch.launch.obs_report", *args],
                               env=env, capture_output=True, text=True,
                               timeout=300)
            if r.returncode != 0:
                raise AssertionError(f"obs_report {args} exited "
                                     f"{r.returncode}: {r.stderr[-2000:]}")
            shown = r.stdout.replace(tmp + os.sep, "")
            log("[obs] obs_report " + " ".join(
                os.path.basename(a) for a in args) + ":\n" + "\n".join(
                    "    " + ln for ln in shown.splitlines()[:24]))
    return launches, report, scores


def phase_shardmap(K, obs_scores):
    """Phase 14: the shardmap backend (the ring solver per mesh shard) ->
    per-run pairs/s.  Through the launcher on one shard of the host's mesh,
    scores and CIGARs; then one and two shards of the card against the
    kernel and ring backends on the same pairs, the per-shard steps of a
    two-shard wave, and padding quantised to the shard count."""
    import types
    import numpy as np
    import torch
    from repro_torch.core import wavefront as wf
    from repro_torch.core.engine import AlignmentEngine, _quantize_rows
    from repro_torch.core.engine import _fit_width
    from repro_torch.core.penalties import DEFAULT
    from repro_torch.core.scoring import as_model
    from repro_torch.data.reads import ReadPairSpec, generate_pairs
    from repro_torch.launch import align
    from repro_torch.launch.mesh import make_host_mesh, make_mesh

    common = ["--backend", "shardmap", "--pairs", str(WAVE), "--read-len",
              str(READ_LEN), "--edit-frac", str(EDIT_FRAC), "--chunk-pairs",
              str(WAVE), "--verify", "512", "--device", "cuda"]
    sm = {}
    if align.main([*common, "--mode", "both"], sm) != 0:
        raise AssertionError("launcher failed on the shardmap backend")
    if not np.array_equal(sm["scores"], obs_scores):
        n = int((sm["scores"] != obs_scores).sum())
        raise AssertionError(f"shardmap and kernel scores differ on {n} "
                             f"pairs")
    cig = {}
    if align.main([*common, "--mode", "sync", "--output", "cigar"],
                  cig) != 0:
        raise AssertionError("launcher failed on the shardmap CIGAR path")
    P, plen, T, tlen = generate_pairs(ReadPairSpec(
        n_pairs=WAVE, read_len=READ_LEN, edit_frac=EDIT_FRAC, seed=0))
    t0 = time.perf_counter()
    n = rescore_all(types.SimpleNamespace(scores=cig["scores"],
                                          cigars=cig["cigars"]),
                    P, plen, T, tlen, as_model(DEFAULT))
    log(f"[shardmap] launcher: scores equal the kernel backend's on {WAVE} "
        f"pairs; {n} CIGARs re-score to their cost "
        f"({time.perf_counter() - t0:.1f}s)")

    dev = torch.device("cuda", 0)
    mesh2 = make_mesh((2,), ("pairs",), devices=[dev, dev])
    engines = {
        "kernel": AlignmentEngine(backend="kernel", edit_frac=EDIT_FRAC,
                                  device=dev),
        "ring": AlignmentEngine(backend="ring", edit_frac=EDIT_FRAC,
                                device=dev),
        "shardmap-1": AlignmentEngine(backend="shardmap",
                                      edit_frac=EDIT_FRAC,
                                      mesh=make_host_mesh()),
        "shardmap-2": AlignmentEngine(backend="shardmap",
                                      edit_frac=EDIT_FRAC, mesh=mesh2)}
    res, rates = {}, {}
    for name, eng in engines.items():      # warm, then two timed turns
        eng.align_packed(P, plen, T, tlen)
    for turn in range(2):
        for name, eng in engines.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[name] = eng.align_packed(P, plen, T, tlen)
            rates.setdefault(name, []).append(
                WAVE / (time.perf_counter() - t0))
    for name, r in res.items():
        if not np.array_equal(r.scores, res["kernel"].scores):
            raise AssertionError(f"{name} scores differ from the kernel "
                                 f"backend's")
    st2 = res["shardmap-2"].stats
    want_rows = sum(min(_quantize_rows(b.n_pairs, 2), WAVE)
                    for b in st2.buckets)
    if st2.n_workers != 2 or st2.rows_padded != want_rows \
            or st2.rows_padded % 2:
        raise AssertionError(f"two shards padded {st2.rows_padded} rows "
                             f"(expected {want_rows}, a multiple of 2)")
    odd = engines["shardmap-2"].align_packed(P[:3], plen[:3], T[:3],
                                             tlen[:3])
    if odd.stats.rows_padded != 4 or not np.array_equal(
            odd.scores, res["kernel"].scores[:3]):
        raise AssertionError(f"3 pairs on two shards padded "
                             f"{odd.stats.rows_padded} rows, not 4")
    b = st2.buckets[0]
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    shards = wf.wfa_shards(to(_fit_width(P, b.lmax)),
                           to(_fit_width(T, b.lmax)), to(plen), to(tlen),
                           pen=engines["kernel"].pen, s_max=b.s_max,
                           k_max=b.k_max, mesh=mesh2)
    steps = [r.n_steps for r in shards]
    log(f"[shardmap] two shards of {dev}: rows padded {st2.rows_padded} "
        f"(3 pairs -> {odd.stats.rows_padded}); per-shard steps of the "
        f"pass-1 wave (s_max {b.s_max}): {steps}")
    out = {name: {"pairs_per_s": v, "overflow": res[name].stats.n_overflow}
           for name, v in rates.items()}
    out["steps_two_shards"] = steps
    out["launcher"] = {m: sm[m]["total_pairs_per_s"]
                       for m in ("sync", "stream")}
    log("[shardmap] blocking align_packed on " + f"{WAVE} pairs, pairs/s "
        "(two turns): " + "; ".join(f"{k} {v[0]:,.0f} / {v[1]:,.0f}"
                                    for k, v in rates.items()))
    return out


def phase_shims(K):
    """Phase 15: the deprecated WFAligner and PIMBatchAligner on the kernel
    backend, and the quickstart example -> launches."""
    import warnings
    import numpy as np
    from repro_torch.core import PIMBatchAligner, WFAligner
    from repro_torch.core.engine import AlignmentEngine
    from repro_torch.data.reads import ReadPairSpec, generate_pairs

    P, plen, T, tlen = generate_pairs(ReadPairSpec(
        n_pairs=SHIM_PAIRS, read_len=READ_LEN, edit_frac=EDIT_FRAC, seed=21))
    pats = [P[i, :plen[i]] for i in range(SHIM_PAIRS)]
    txts = [T[i, :tlen[i]] for i in range(SHIM_PAIRS)]
    want = AlignmentEngine(backend="kernel", edit_frac=EDIT_FRAC,
                           device="cuda").align(pats, txts).scores
    K.reset_launches()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        al = WFAligner(backend="kernel", edit_frac=EDIT_FRAC)
        pim = PIMBatchAligner(al)
    kinds = [w.category for w in caught]
    if kinds != [DeprecationWarning, DeprecationWarning]:
        raise AssertionError(f"the shims warned {kinds}")
    got = al.align(pats, txts)
    scores, pim_stats = pim.run(pats, txts)
    launches = dict(K.LAUNCHES)
    if launches["score"] == 0:
        raise AssertionError(f"the shims launched no score kernel: "
                             f"{launches}")
    for name, s in (("WFAligner", got.scores), ("PIMBatchAligner", scores)):
        if not np.array_equal(s, want):
            raise AssertionError(f"{name} scores differ from "
                                 f"AlignmentEngine.align's")
    log(f"[shims] WFAligner and PIMBatchAligner warned DeprecationWarning "
        f"and equal AlignmentEngine.align on {SHIM_PAIRS} pairs; launches "
        f"{launches}; PIMStats Total {pim_stats.throughput_total():,.0f} "
        f"pairs/s, Kernel {pim_stats.throughput_kernel():,.0f} pairs/s")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m",
                        "repro_torch.examples.quickstart"], env=env,
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"the quickstart exited {r.returncode}: "
                             f"{r.stderr[-2000:]}")
    log(f"[shims] quickstart on the card in {time.perf_counter() - t0:.1f}s:"
        "\n" + "\n".join("    " + ln for ln in r.stdout.splitlines()))
    return launches


def full_occupancy(K, S, lib):
    """The full-width launches of the main path's shapes (GapAffine(4,6,2),
    exact, 8 pairs a block: pass 1 and recovery at 100 bp, pass 1 at 10
    kb; score and trace) -> {shape: threads, dynamic shared bytes, blocks
    resident per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)}."""
    import ctypes
    pen = S.GapAffine(4, 6, 2)
    out = {}
    for tag, B, L, s_max, k_pad in (("100bp", WAVE, 128, 38, 128),
                                    ("recovery", WAVE, 128, 416, 384),
                                    ("10kb", LONG_PAIRS, 10028, 4928, 4992)):
        for trace in (0, 1):
            shape = (ctypes.c_int * 6)()
            rc = lib.wfa_full_shape(B, 8, k_pad,
                                    *K.full_lanes(pen, s_max, k_pad),
                                    pen.window, pen.e, 1, trace, 0, L, L,
                                    shape)
            if rc != 0 or shape[2] < 1:
                raise AssertionError(f"the full-width kernel does not fit "
                                     f"an SM at {tag} (rc {rc}, "
                                     f"{list(shape)})")
            out[f"{tag} {'trace' if trace else 'score'}"] = dict(
                threads=shape[0], smem=shape[1], blocks_per_sm=shape[2])
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on a card",
              file=sys.stderr)
        return 2
    from repro_torch.core import scoring as S
    from repro_torch.core.engine import AlignmentEngine
    from repro_torch.data.reads import ReadPairSpec, generate_pairs
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.flash_attention import build as fbuild
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.wfa import build
    from repro_torch.kernels.wfa import kernel as K

    t_start = time.perf_counter()
    # 1. environment
    card = gpu_name_power()
    dev = torch.device("cuda")
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; {card}")

    # 2. build: one nvcc per source of both libraries, started together
    t0 = time.perf_counter()
    kbuild.build_all([build.LIB, fbuild.LIB])
    build.load()
    fbuild.load()
    srcs = [os.path.relpath(p, ROOT) for p in build.SOURCES + fbuild.SOURCES]
    log(f"[build] {', '.join(srcs)} -> "
        f"{os.path.relpath(build.BUILD_INFO['path'], ROOT)}, "
        f"{os.path.relpath(fbuild.BUILD_INFO['path'], ROOT)} in "
        f"{time.perf_counter() - t0:.1f}s ({build.BUILD_INFO['cpu_seconds']:.1f}"
        f"s of compiler CPU: one nvcc after another would take at least "
        f"that)")
    fentries, wgmma_regs = [], 0
    for name, sp, r in re.findall(
            r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores"
            r".*?Used (\d+) registers", fbuild.BUILD_INFO["log"], re.S):
        m = re.search(r"(flash_(?:mma_|wgmma_)?kernel)I(f|13__nv_bfloat16)?"
                      r"Li(\d+)E", name)
        if m:
            t = {"f": "float,", None: ""}.get(m.group(2), "bf16,")
            fentries.append(f"{m.group(1)}<{t}{m.group(3)}> {r} registers, "
                            f"{sp} B spilled")
            if m.group(1) == "flash_wgmma_kernel":
                wgmma_regs = max(wgmma_regs, int(r))
                if int(sp):
                    raise AssertionError(f"the wgmma flash body spills: "
                                         f"{fentries[-1]}")
    if len(fentries) != 10:
        raise AssertionError(f"ptxas reported {len(fentries)} flash kernels, "
                             f"not 10 (fp32 pipes: 2 types x 3 head dims; "
                             f"mma.sync and wgmma: 2 head dims each)")
    log("[build] ptxas (flash): " + "; ".join(fentries))
    # ptxas says where it ignores setmaxnreg or serialises wgmma
    warned = sorted({w.strip() for w in re.findall(
        r"(?im)^.*(?:warning|setmaxnreg|serialized).*$",
        fbuild.BUILD_INFO["log"])})
    if warned:
        log("[build] ptxas notes (flash): " + " | ".join(warned))
    # ptxas -v: per entry function, its spill stores and registers
    entries = re.findall(r"Compiling entry function '(\w+)'.*?"
                         r"(\d+) bytes spill stores.*?Used (\d+) registers",
                         build.BUILD_INFO["log"], re.S)
    for label, sel in (("all", lambda n: True),
                       ("full", lambda n: "wfa_full_kernel" in n),
                       ("band", lambda n: "wfa_band_kernel" in n)):
        got = [(int(sp), int(r)) for n, sp, r in entries if sel(n)]
        if got:
            log(f"[build] ptxas ({label}): {len(got)} kernels, <= "
                f"{max(r for _, r in got)} registers, "
                f"{sum(1 for sp, _ in got if sp)} with spill stores (<= "
                f"{max(sp for sp, _ in got)} bytes)")

    def short(name):
        """wfa_kernel<1,1,2,16> from the mangled template name."""
        m = re.search(r"(wfa_(?:band_|meet_|full_)?kernel)I(.*?)EEv", name)
        if not m:
            return name
        args = re.findall(r"L[bi](\d+)E", m.group(2))
        return f"{m.group(1)}<{','.join(args)}>"
    meet_regs = [f"{short(n)} {r} registers, {sp} B spilled"
                 for n, sp, r in entries if "wfa_meet_kernel" in n]
    log("[build] ptxas (meet): " + "; ".join(meet_regs))
    band_regs = [f"{short(n)} {r} registers, {sp} B spilled"
                 for n, sp, r in entries if "wfa_band_kernel" in n]
    log("[build] ptxas (band): " + "; ".join(band_regs))
    full_regs = [f"{short(n)} {r} registers, {sp} B spilled"
                 for n, sp, r in entries if "wfa_full_kernel" in n]
    log("[build] ptxas (full width): " + "; ".join(full_regs))
    full_occ = full_occupancy(K, S, build.load())
    log("[build] full width, blocks resident per SM at the main path's "
        "shapes (GapAffine(4,6,2)): " + "; ".join(
            f"{k}: {v['threads']} threads, {v['smem']:,} B shared, "
            f"{v['blocks_per_sm']} blocks" for k, v in full_occ.items()))
    spilled = [f"{short(n)} {sp} B" for n, sp, _ in entries if int(sp)]
    if spilled:
        log(f"[build] spill stores: {', '.join(spilled)}")

    # 3. kernel vs plain on the card
    P, plen, T, tlen = generate_pairs(ReadPairSpec(
        n_pairs=WAVE, read_len=READ_LEN, edit_frac=EDIT_FRAC, seed=0))
    eng_for = lambda pen: AlignmentEngine(pen, backend="kernel",
                                          edit_frac=EDIT_FRAC, device=dev)
    worst = phase_grid(K, S, eng_for, P, plen, T, tlen, dev)
    timing = phase_wave_timing(K, S, eng_for(S.GapAffine(4, 6, 2)), P, plen,
                               T, tlen, dev)
    t0 = time.perf_counter()
    timing.update(phase_full_10kb(K, S, dev))
    log(f"[full] 10 kb phase in {time.perf_counter() - t0:.1f}s")

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
    b_launches, bidir, packed, path_meet_err, split = phase_bidir_path(
        K, root)
    for mode in ("sync", "stream"):
        r = bidir[mode]
        log(f"[bidir] {mode}: Total {r['total_pairs_per_s']:,.2f} pairs/s "
            f"(wall {r['wall_s']:.2f}s: scatter {r['t_scatter']:.2f}s, "
            f"kernel {r['t_kernel']:.2f}s, gather {r['t_gather']:.2f}s) "
            f"on {card}")

    # 7. read mapping; 8. the alignment service
    map_launches, mapped = phase_map(K, card)
    t0 = time.perf_counter()
    sa_launches, served_align = phase_serve_align(K, card)
    log(f"[serve_align] three runs and checks in "
        f"{time.perf_counter() - t0:.1f}s")

    # 9. the band kernel vs plain; 10. the banded path
    from repro_torch.kernels.wfa import ops as kops
    t0 = time.perf_counter()
    band_worst = phase_band_grid(K, S, kops, dev)
    log(f"[band] grid in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    band = phase_band_root(K, S, kops, dev)
    log(f"[band] 10 kb phase in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    band_launches, banded = phase_band_path(K, S, dev)
    log(f"[banded] path and yardsticks in {time.perf_counter() - t0:.1f}s "
        f"on {card}")

    # 11. the flash kernel vs plain; 12. the serve path at full width
    torch.backends.cuda.matmul.allow_tf32 = False   # plain fp32 in fp32
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    flash_worst, flash_share = phase_flash_grid(FK, fops, dev)
    phase_flash_control(FK, dev)
    flash = phase_flash_timing(FK, fops, dev)
    log(f"[flash] grid, control and timing in "
        f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    serve_launches = phase_serve_defaults(FK)
    served = phase_serve_long(FK, dev, card)
    log(f"[serve] both runs and checks in {time.perf_counter() - t0:.1f}s")

    # 13. telemetry captures read back; 14. shardmap; 15. the shims and the
    # quickstart
    t0 = time.perf_counter()
    obs_launches, obs_runs, obs_scores = phase_obs(K)
    log(f"[obs] three captures and reports in "
        f"{time.perf_counter() - t0:.1f}s on {card}")
    t0 = time.perf_counter()
    shard = phase_shardmap(K, obs_scores)
    log(f"[shardmap] phase in {time.perf_counter() - t0:.1f}s on {card}")
    t0 = time.perf_counter()
    shim_launches = phase_shims(K)
    log(f"[shims] phase in {time.perf_counter() - t0:.1f}s")
    log("[slice10] " + json.dumps({"obs": obs_runs, "shardmap": shard}))

    log(f"[time] all phases in {time.perf_counter() - t_start:.1f}s")

    # 16. report
    src = "src/repro_torch/kernels/wfa/csrc/wfa.cu"
    kernels = []
    for name, variant in (("wfa_score", "score"), ("wfa_trace", "trace")):
        t = timing[name]
        shapes = ("100bp", "recovery", "10kb")
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": "src/repro/kernels/wfa/kernel.py:334",
            # the main, BiWFA, mapping, alignment-service, telemetry-capture
            # and shim paths
            "launches": (launches[variant] + b_launches[variant]
                         + map_launches[variant]
                         + sum(v[variant] for v in sa_launches.values())
                         + obs_launches[variant]
                         + shim_launches[variant]),
            "max_abs_err": max(worst, *(timing[f"{name}{x}"]["max_abs_err"]
                                        for x in ("", "_recovery", "_10kb"))),
            # kernel and plain on the same 65,536-pair wave of 100 bp
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            # both bounds: the bytes moved and the integer operations of
            # the cells the recurrence can reach (full_bound)
            "bytes_bound_ms": t["bytes_bound_ms"],
            "ops_bound_ms": t["ops_bound_ms"],
            # the recovery shape (k_pad 384) and the 10 kb pass 1 (plain
            # on the whole launch; block0_ms the kernel on the first 8)
            "recovery": timing[f"{name}_recovery"],
            "wave_10kb": timing[f"{name}_10kb"],
            "registers": [r for r in full_regs
                          if r.startswith(f"wfa_full_kernel<1,"
                                          f"{int(variant == 'trace')},")],
            "blocks_per_sm": {x: full_occ[f"{x} {variant}"]["blocks_per_sm"]
                              for x in shapes},
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
        # both bounds: the bytes moved and the integer operations of the
        # cells the recurrence reaches up to each pair's meet
        "bytes_bound_ms": root["bytes_bound_ms"],
        "ops_bound_ms": root["ops_bound_ms"],
        "registers": meet_regs,
        "library_ms": None})
    for name, key, err in (("wfa_band_score", "score_band", band_worst[0]),
                           ("wfa_band_trace", "trace_band", band_worst[1])):
        r = band[name]
        rec = {"name": name, "route": "cuda", "source": src,
               "replaces": "src/repro/kernels/wfa/kernel.py:334",
               "launches": band_launches[key],
               "max_abs_err": max(err, r["max_abs_err"]),
               # kernel and plain on the same whole wave; block0_ms is the
               # kernel on its first block_pairs pairs
               "ms": r["ms"], "plain_ms": r["plain_ms"],
               "block0_ms": r["block0_ms"], "block_pairs": r["block_pairs"],
               "pairs": r["pairs"],
               "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
               # both bounds: the bytes moved and the integer operations of
               # the window cells the recurrence can reach up to each
               # block's exit step
               "bytes_bound_ms": r["bytes_bound_ms"],
               "ops_bound_ms": r["ops_bound_ms"],
               "registers": band_regs,
               "library_ms": None}
        if "full_heur_ms" in r:
            rec.update(full_width_heuristic_ms=r["full_heur_ms"],
                       full_width_exact_ms=r["full_exact_ms"])
        kernels.append(rec)
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        # the path's body (entry point and the other bodies: csrc/
        # flash_attention.cu)
        "body": "wgmma",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_wgmma.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:82",
        # the main path's prefills: the launcher's two waves and the
        # 2,048-token wave
        "launches": serve_launches + served["launches"],
        "max_abs_err": max(max(flash_worst.values()), flash["max_abs_err"],
                           served["max_abs_err"]),
        # the largest share of a limit (max |err| against 3e-5 / 2e-2; in
        # bf16 also each |err| against 2 ulps of |want| plus a row floor)
        # over the grid, the served shape and the prefill launches; <= 1
        # passes
        "worst_share_of_limit": max(flash_share["wgmma"],
                                    flash["share"], served["share"]),
        "ms": flash["ms"], "plain_ms": flash["plain_ms"],
        # the other bodies on the same inputs: mma.sync (the yardstick of
        # the wgmma design) and the fp32 pipes (fp32, other head dims)
        "mma_sync_ms": flash["mma_sync_ms"], "fp32_pipe_ms": flash["fma_ms"],
        # ptxas at entry (setmaxnreg then gives the consumers 240)
        "registers": wgmma_regs,
        "bound_ms": flash["bound_ms"], "bound_by": flash["bound_by"],
        "library_ms": flash["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
