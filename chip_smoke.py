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
   block multiples) plus non-causal Sq 128 over Sk 1,024, and bf16 at dh
   112 (zamba2's) over the same layouts, causal and not, at S 250 (the
   non-causal keys unpadded) and 2,048, within 3e-5 (fp32, no TF32) and
   2e-2 (bf16), and in bf16 also within 2 ulps of each output plus a
   floor; bf16 at dh 64 / 112 / 128 must run the wgmma body by default and
   runs once more on the fp32 pipes (and at dh 64 / 128 on ``mma.sync``);
   a control shows that this check passes a sound attention and fails one
   with a key tile dropped, in the materialised attention and in the wgmma
   body itself, at dh 128 and 112; then at the served shape (B 8, S 2,048, H 16, KV 8, dh
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
16. training — qwen3-0.6b at published widths on the card, random weights
   from a seed, on the token stream (``data/tokens.py``): (a) one block at
   B 2, S 1,024, bf16: the q, k, v and wq, wk, wv gradients through
   ``layers.FlashAttention`` (kernel forward, plain recompute backward)
   must equal those through ``ref_attention_gqa`` within GRAD_TOL, the same
   with the kernel's output detached must fail (this holds the autograd
   wiring and the backward, not the kernel's arithmetic), and two kernel
   launches on the same inputs must agree bit for bit; (b) ``repro_torch.
   launch.train.main`` at 8 x 1,024 tokens for 12 steps: a finite loss that
   falls, the flash kernel on the wgmma body for every layer's forward
   (twice a step under the model's ``"dots"`` remat, which recomputes
   attention); every flash launch of the first step is held against the
   plain version on its own inputs (q [8, 1,024, 16, 128], k / v [8, 1,024,
   8, 128], bf16, causal) by the flash check, and the last of them, run
   again with the wgmma body's key tile TRAIN_DROP_TILE dropped, must fail
   it; step time, tokens/s, peak memory and the model-FLOP share are
   printed; (d) on the device's side, at the training shape, the flash
   forward, the plain forward and the attention backward each timed alone
   beside ``scaled_dot_product_attention`` forward + backward, and two
   steps under ``torch.profiler``: the device's busy share, its time by
   kind of kernel (the flash kernel must be among them) and a step's split
   into FlashAttention's forward, its backward and the rest; (c) the
   restart drill: 8 steps straight against a failure at step 5 and a
   resume from the step-3 checkpoint, parameters and moments bit for bit
   (at full depth where the temporary disk holds three checkpoints of
   7.2 GB, else at 4 layers, and it says which); (e) the same 12 steps with
   attention on the plain path as the yardstick (tokens/s, and the step-0
   loss within TRAIN_LOSS0_TOL of the kernel run's, a check of the run's
   set-up rather than of the kernel);
17. the MoE family — (a) phi3.5-moe-42b-a6.6b at published widths, 12 of
   its 32 layers (the card holds 59 GiB of fp32 weights, not 156), seeded
   weights: one ``BatchServer`` wave of 8 x 2,048 tokens, 32 new, at the
   published capacity factor 1.25, through :func:`serve_wave` as phase
   12b: 12 flash launches at G 4 on the wgmma body, each held against the
   plain version; prefill and decode tokens/s, the peak, the MoE layers'
   share of the prefill by CUDA events, the dropped slots of every MoE
   call; then 2 of the prompts at a capacity no slot can exceed, prefill +
   decode logits against one ``forward`` given the wave's routes
   (:func:`moe_e2e`: routes flip on bf16 rounding at near ties), the two
   paths' router probabilities within MOE_ROUTER_TOL; (b) deepseek-v2-
   lite-16b whole (27 layers, MLA: no flash launch), the same wave and
   checks for the naive and the absorbed decode; (c) ``launch.train.main``
   on phi at 2 layers, 2 x 1,024 tokens, 3 steps under ``"dots"``: a
   finite loss that holds the aux term, the router and every expert moved
   with a gradient, each flash launch of step 0 held against the plain
   version; step ms, tokens/s, peak; phi's prefill launch shape alone
   beside ``scaled_dot_product_attention`` in two turns;
18. the SSM and hybrid families — (a) mamba2-780m whole at published
   widths, seeded fp32 weights: ``serve.main(["--arch", "mamba2-780m"])``
   and one ``BatchServer`` wave of 8 x 2,048 tokens, 32 new, through
   :func:`serve_wave` (no flash launch: the model has no attention);
   prefill and decode tokens/s, the peak; for 2 requests the logits of
   prefill (the chunked SSD) + decode (the recurrence) against one
   ``forward`` over prompt, decoded tokens and filler up to a multiple of
   the SSD chunk (:func:`ssm_e2e`), in bf16 and in fp32 within
   SSM_E2E_TOL, and a decode that drops the SSM state (the planted fault)
   past them; one Mamba2 layer profiled at the prefill shape; (b)
   zamba2-7b whole
   (81 Mamba2 layers, the shared GQA + MLP block after every 6th: 13
   applications), the same: 13 flash launches a prefill at bf16, dh 112,
   G 1, all on the wgmma body, each held against the plain version to the
   limits, each timed by CUDA events (and the launcher's 26, held the same
   way); that launch shape alone: the wgmma body, the fp32-pipe body (its
   body before dh 112 ran on wgmma), the plain version and
   ``scaled_dot_product_attention`` timed in two turns, with the bound; (c)
   ``launch.train.main`` on mamba2 whole (8 x 1,024 tokens, 6 steps) and
   zamba2 at 12 layers (2 x 1,024 tokens, 3 steps), under ``"dots"``: finite
   losses, mamba2's falling; every leaf of zamba2's SSM layers and shared
   block moved with a gradient, all 12 of its flash launches on wgmma and
   held against the plain version to both limits; step ms, tokens/s,
   peak;
19. the enc-dec and VLM families — (a) whisper-base whole at published
   widths, seeded fp32 weights: a wave of 16 requests of 1,500 seeded frame
   embeddings (30 s of audio through the stubbed frontend) and the 4-token
   start-of-transcript prompt, 224 greedy new tokens in a 448-token
   context, through ``prefill`` / ``serve_step`` (:func:`direct_wave`; the
   serve launcher refuses enc-dec as the JAX package's does): 18 flash
   launches a prefill on wgmma (the encoder's 6 non-causal over the 1,500
   frames unpadded, each decoder layer's causal self- and non-causal
   cross-attention), each held against the plain version, and the first
   encoder launch with its keys zero-padded to 1,536 (a planted fault)
   failing the check; prefill + decode logits against one ``forward`` in
   bf16 and fp32 within ENCDEC_E2E_TOL (:func:`encdec_e2e`), a decode
   reading the next request's cross caches past them; the encoder's and
   the cross-attention's launch shapes timed alone beside their bounds and
   ``scaled_dot_product_attention``; (b) qwen2-vl-7b whole (28 layers, G
   7, dh 128): a wave of 8 x 2,048 tokens, 32 new, the first 256 positions
   seeded patch embeddings on a 16 x 16 M-RoPE grid, text after it
   (:func:`mrope_grid_positions`), each decode step given its M-RoPE
   positions: 28 flash launches a prefill on wgmma, each held against the
   plain version; prefill + decode against one forward in bf16 and fp32
   within VLM_E2E_TOL (:func:`vlm_e2e`), a decode without M-RoPE positions
   past them, its prefill launch shape alone beside
   ``scaled_dot_product_attention`` in two turns; (c) ``launch.train.main``
   on whisper whole (8 x 448 tokens on zero frames, 3 steps) and on
   qwen2-vl at 4 of 28 layers (2 x 1,024, 3 steps), under ``"dots"``: finite losses, 36 and 8 flash launches a
   step on wgmma, step 0's held against the plain version, every leaf of
   the layers moved with a gradient; step ms, tokens/s, peak;
20. report — a ``kernels`` JSON line, the card's name and power limit, and
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
# training (phase 16): the same model at published widths on the token
# stream, 8 x 1,024 = 8,192 tokens a step
TRAIN_BATCH = 8
TRAIN_SEQ = 1024
TRAIN_STEPS = 12
TRAIN_TIMED_FROM = 2          # step times: the median of the steps after 2
DRILL_STEPS, DRILL_EVERY, DRILL_FAIL = 8, 4, 5
DRILL_SMALL_LAYERS = 4        # the drill's depth where the disk holds less
GRAD_BATCH = 2                # one block's gradients, B 2 x S 1,024
# One block's gradients (q, k, v and wq, wk, wv; loss mean(y**2) of the
# block's output) through layers.FlashAttention against autograd through
# the plain attention (ref_attention_gqa), bf16.  Both backwards run plain
# ops (FlashAttention's is the _sdpa recompute), so the two differ by the
# forwards' rounding and by bf16 against fp32 scores in the two plain
# paths: 0.010 of the largest magnitude (max |err| and the L2 ratio alike)
# on the CPU at these widths, S 256.  A detached kernel output gives zero
# attention gradients, 1.0 of it.
GRAD_TOL = 2 ** -4
# the training step's first loss, kernel against plain attention: the same
# parameters and tokens, so only bf16 rounding inside attention differs,
# averaged over 8,192 tokens.  A random-init loss sits near ln(151,936) =
# 11.93 whatever attention returns, so this holds the two runs' set-up, not
# the kernel: the kernel's forward is held by the flash check on the
# launcher's own launches (phase 16b), its gradient wiring by phase 16a.
TRAIN_LOSS0_TOL = 1e-2
# Phase 16b holds the training launches to the elementwise bf16 limit
# alone (FLASH_BF16_ULPS ulps of |want| + FLASH_BF16_FLOOR x the row's mean
# |want|), not to the absolute FLASH_TOL: that 2e-2 is sized to outputs of
# about 0.4 (random inputs of scale 0.5), while the model's attention
# outputs reach |o| ~ 4.2, where one bf16 ulp is 0.031 and kernel and plain,
# each rounding once to bf16, may differ by it (on the H100: max |err|
# 0.03125, 1 ulp at want -4.219, 0.304 of the elementwise limit).
# the planted fault of phase 16b: the wgmma body's 128-key tile 4 (keys
# 512-639) left out of every row, which moves rows 512-1,023 of S 1,024
TRAIN_DROP_TILE = 4
# phase 17, the MoE family at published widths with fp32 weights
# (configs/phi3_5_moe_42b.py, configs/deepseek_v2_lite_16b.py).  phi's 32
# layers take 156 GiB (78 GiB even in bf16), so it serves at 12 layers
# (15.9 B parameters, 59 GiB) and trains at 2 (12 B a parameter for the
# weights, gradients and AdamW moments: 42.7 GiB); deepseek serves whole
# (27 layers, 58.5 GiB).
MOE_ARCH = "phi3.5-moe-42b-a6.6b"
MLA_ARCH = "deepseek-v2-lite-16b"
MOE_SERVE_LAYERS = 12
MOE_TRAIN_LAYERS = 2
MOE_TRAIN_BATCH = 2
MOE_TRAIN_STEPS = 3
# prefill + decode against one forward for MoE (moe_e2e): top-k routing
# flips where bf16 rounding reorders a near tie, and a flipped token moves
# by far more than rounding, so the forward takes the routes the wave took
# (at a capacity no slot can exceed, since capacity depends on the token
# count) and is held to LM_E2E_*_TOL.  The two paths' router probabilities
# must then agree within MOE_ROUTER_TOL (relative; bf16 differences of the
# hidden state move router logits by a few hundredths: 0.060 at most on the
# smoke models, port against JAX), so the forward's own choice can differ
# from the given routes only where its K-th and (K+1)-th probabilities lie
# within 2 x MOE_ROUTER_TOL.  How often that happens depends on the experts
# and top k (printed: on the H100, 0.06% of phi's pairs, 16 experts top 2;
# 7.8% of deepseek's, 64 top 6).
MOE_ROUTER_TOL = 2 ** -2


# phase 18, the SSM and hybrid families at published widths with fp32
# weights (configs/mamba2_780m.py, configs/zamba2_7b.py), both served whole
# (2.9 and 25.1 GiB).  mamba2 trains whole (16 B a parameter of training
# state: 12.5 GB); zamba2's 6.75 B parameters would take 108 GB, so it
# trains at 12 of its 81 layers (2 shared-block applications, 1.37 B
# parameters, about 22 GB).  zamba2's shared attention (bf16, dh 112, 32
# heads on 32) runs the flash kernel's wgmma body (two 64-column halves,
# the second zero-filled past column 112); phase 18b times the fp32-pipe
# body, which ran it before, beside it.
SSM_ARCH = "mamba2-780m"
HYBRID_ARCH = "zamba2-7b"
HYBRID_FLASH_BODY = "wgmma"
SSM_TRAIN_STEPS = 6
HYBRID_TRAIN_LAYERS = 12
HYBRID_TRAIN_BATCH = 2
HYBRID_TRAIN_STEPS = 3
# phase 18's prefill + decode against one forward (ssm_e2e) runs in bf16
# and fp32, each within its bounds, and again with a planted fault (each
# decode step given a zeroed SSM state), which must exceed every bound.
# Max / mean |dlogit| on the H100, sound: mamba2-780m bf16 0.152 / 0.0204,
# zamba2-7b 0.328 / 0.0451, fp32 at most 9.9e-5 / 1.3e-5 (the chunked SSD
# and the recurrence are one function up to the order of sums); the fault
# in either dtype at least 4.75 / 0.753.  The bf16 bounds sit about 4x from
# both sides, the fp32 ones about 10x above the sound readings.
SSM_E2E_TOL = {"bfloat16": {"max": 1.25, "mean": 0.18},
               "float32": {"max": 1e-3, "mean": 1e-4}}
# phase 19, the enc-dec and VLM families at published widths with fp32
# weights (configs/whisper_base.py, configs/qwen2_vl_7b.py), both served
# whole (0.27 and 28.4 GiB).  whisper trains whole; qwen2-vl's 7.62 B
# parameters would take 122 GB of training state (16 B a parameter), so it
# trains at VLM_TRAIN_LAYERS of its 28 layers (2.02 B parameters, untied
# embeddings included: about 32 GB).
ENCDEC_ARCH = "whisper-base"
VLM_ARCH = "qwen2-vl-7b"
# whisper: a wave of 16 requests, each 30 s of audio (1,500 frame
# embeddings, the stubbed frontend's output) with the start-of-transcript
# prompt <|startoftranscript|><|en|><|transcribe|><|notimestamps|>, 224
# greedy new tokens in the decoder's 448-token context; trained on 8 x 448
# tokens over zero frames
ENCDEC_BATCH = 16
ENCDEC_PROMPT = (50258, 50259, 50359, 50363)
ENCDEC_NEW = 224
ENCDEC_MAX_SEQ = 448
ENCDEC_TRAIN_BATCH = 8
ENCDEC_TRAIN_SEQ = 448
ENCDEC_TRAIN_STEPS = 3
# qwen2-vl: phase 12b's wave (LM_BATCH x LM_PROMPT, LM_NEW new) whose first
# 256 positions are an image's patch embeddings on a 16 x 16 grid
VLM_GRID = 16
VLM_TRAIN_LAYERS = 4
VLM_TRAIN_BATCH = 2
VLM_TRAIN_STEPS = 3
# prefill + decode against one forward (max / mean |dlogit|), fp32 held to
# phase 18's bounds, bf16 to bounds of each family's own, set between its
# sound readings and a planted fault's on the H100 (their first readings):
# - whisper: sound bf16 0.01953 / 0.0025; the fault, each request's decode
#   reading the next request's cross caches, only 0.1455 / 0.02305 (fp32
#   0.1358 / 0.02281): attention over 1,500 random frames averages much of
#   a recording out.  Under 12b's 0.25 / 0.03 it passed, so the bounds sit
#   between, 2.6-3.1x from each side;
# - qwen2-vl: logits of std 1.197 against qwen3's 0.64, and bf16
#   differences scale with them: sound 0.1875 / 0.02576 (0.86 of 12b's
#   mean bound), the fault (decode given no M-RoPE positions) 5.88 /
#   0.859.  12b's bounds scaled by the std, 0.5 / 0.06: 2.3-2.7x above the
#   sound reading, 12-14x below the fault's.
ENCDEC_E2E_TOL = {"bfloat16": {"max": 0.05, "mean": 0.0075},
                  "float32": {"max": 1e-3, "mean": 1e-4}}
VLM_E2E_TOL = {"bfloat16": {"max": 0.5, "mean": 0.06},
               "float32": {"max": 1e-3, "mean": 1e-4}}
# phase 20a, expert parallelism: phi3.5-moe at published widths, 4 of its
# 32 layers (fp32 weights, 20 GiB), fp32 compute, moe_ep over a 1 x 4
# ("data", "model") mesh of the one card: its 16 experts split 4 a shard,
# the shards run in turn and the all-to-alls are copies between their
# tensors.  At a capacity no slot can exceed (n_experts / top_k) each MoE
# layer's output must equal the capacity path's on the same input within
# EP_LAYER_TOL (tests/test_dryrun_lowering.py's bound for the JAX
# package's two paths) and the prefill's logits within the fp32 bounds of
# phases 18-19; at the published factor the two drop different slots by
# design (capacity is per shard under EP), so their drops are printed.
EP_LAYERS = 4
EP_MESH = (1, 4)
EP_LAYER_TOL = 1e-4
EP_LOGITS_TOL = SSM_E2E_TOL["float32"]
EP_TIMED = 3                  # CUDA-event repeats of one MoE layer, each path


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
    mma.sync and the fp32 pipes for bf16 at dh 64 and 128, wgmma and the
    fp32 pipes at dh 112, else the fp32 pipes."""
    import torch
    if q.dtype == torch.bfloat16 and q.shape[3] in (64, 128):
        return ("wgmma", "mma_sync", "fp32_pipes")
    if q.dtype == torch.bfloat16 and q.shape[3] == 112:
        return ("wgmma", "fp32_pipes")
    return ("fp32_pipes",)


def flash_pair(FK, fops, q, k, v, causal):
    """({body: output}, plain output) on the same inputs, padded as the ops
    wrappers pad them (non-causal keys unpadded, as
    ``ops.flash_attention_ragged`` hands them over), sliced back to Sq.
    The default call must take the first of :func:`flash_bodies`; the
    others run by name; each counts one launch under its body."""
    import torch
    Sq = q.shape[1]
    qp, kp, vp, bq, bk = fops.pad_blocks(q, k, v, causal=causal,
                                         pad_keys=causal)
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


def flash_check(got, want, absolute=True):
    """-> (max |got - want|, the largest share of a limit): max |err|
    against FLASH_TOL (unless ``absolute`` is false), and in bf16 also each
    |err| against FLASH_BF16_ULPS ulps of |want| + FLASH_BF16_FLOOR x its
    row's mean |want|.  Passes when the share <= 1."""
    import torch
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{tuple(got.shape)} {got.dtype} != "
                             f"{tuple(want.shape)} {want.dtype}")
    dname = str(want.dtype).replace("torch.", "")
    w = want.float()
    diff = (got.float() - w).abs()
    err = float(diff.max())
    share = err / FLASH_TOL[dname] if absolute else 0.0
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
    non-causal Sq 128 over Sk 1,024; and bf16 at dh 112 over the same
    layouts x {causal, non-causal} x S {250, 2,048} -> max |err| per dtype
    and the worst share of the limits per body."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(14)
    worst = {name: 0.0 for name in FLASH_TOL}
    share = {body: 0.0 for body in FK.PATH_LAUNCHES}
    n = 0
    for H, KV in ((8, 8), (16, 8), (16, 1), (64, 8), (48, 1)):
        for dname in FLASH_TOL:
            dt = getattr(torch, dname)
            for dh in (64, 112, 128):
                if dh == 112:
                    if dname != "bfloat16":
                        continue
                    cases = [(S, S, c) for S in (250, 2048)
                             for c in (True, False)]
                else:
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
        f"wgmma, mma.sync and the fp32 pipes; at dh 112: wgmma and the fp32 "
        f"pipes): max |err| fp32 "
        f"{worst['float32']:.3g} (tol 3e-5), bf16 {worst['bfloat16']:.3g} "
        f"(tol 2e-2, and {FLASH_BF16_ULPS} ulps of |want| + "
        f"{FLASH_BF16_FLOOR} x the row's mean |want| elementwise); worst "
        f"share of these limits by body " + ", ".join(
            f"{body} {sh:.3f}" for body, sh in share.items()))
    return worst, share


def phase_flash_control(FK, dev):
    """Phase 11b: the bf16 check must pass a sound attention and fail one
    that leaves a key tile out.  At S 2,048 (B 2, causal and not; GQA 16/8
    at dh 128, then zamba2's 32/32 at dh 112), against the plain version
    (512-key tiles): the plain version on 64-key tiles (at dh 128), the
    materialised fp32 attention (p rounded against each row's final max)
    and the wgmma body must pass; the materialised attention with keys
    1,024-1,087 dropped and the wgmma body with its 128-key tile 8 (keys
    1,024-1,151) dropped must fail."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(2049)
    rnd = lambda *shape: (torch.randn(shape, generator=gen, device=dev)
                          * 0.5).to(torch.bfloat16)
    S, drop, tile = 2048, (1024, 1088), 8
    out = []
    for H, KV, dh in ((16, 8, 128), (32, 32, 112)):
        q, k, v = rnd(2, S, H, dh), rnd(2, S, KV, dh), rnd(2, S, KV, dh)
        for causal in (True, False):
            want = FK.flash_attention_plain(q, k, v, causal=causal)
            tiled = (flash_check(FK.flash_attention_plain(
                q, k, v, causal=causal, block_q=64, block_k=64), want)
                if dh == 128 else None)
            sound = flash_check(attention_fp32(q, k, v, causal), want)
            fault = flash_check(attention_fp32(q, k, v, causal, drop), want)
            body = flash_check(FK.flash_attention_cuda(
                q, k, v, causal=causal, body="wgmma"), want)
            body_fault = flash_check(FK.flash_attention_cuda(
                q, k, v, causal=causal, body="wgmma", drop_key_tile=tile),
                want)
            where = f"dh {dh}, causal {causal}"
            if not max(sound[1], body[1], tiled[1] if tiled else 0) <= 1:
                raise AssertionError(f"the bf16 check fails a sound "
                                     f"attention ({where}): 64-key tiles "
                                     f"{tiled}, materialised {sound}, wgmma "
                                     f"{body}")
            if not min(fault[1], body_fault[1]) > 1:
                raise AssertionError(f"the bf16 check passes a dropped key "
                                     f"tile ({where}): materialised {fault},"
                                     f" wgmma {body_fault}")
            out.append(f"{where}: "
                       + (f"64-key tiles {tiled[1]:.3f}, " if tiled else "")
                       + f"materialised {sound[1]:.3f}, wgmma {body[1]:.3f};"
                       f" dropped tile: materialised {fault[1]:.2f}, wgmma "
                       f"{body_fault[1]:.2f} of the limit (max |err| "
                       f"{fault[0]:.3g}, {body_fault[0]:.3g})")
        del q, k, v
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


def serve_wave(FK, dev, cfg, params, prompts, *, flash_layers, moe=None,
               body="wgmma"):
    """One BatchServer wave of ``prompts`` (equal lengths), LM_NEW new
    tokens each, max_seq LM_MAX_SEQ, on the card.  The prefill must launch
    the flash kernel ``flash_layers`` times, all on ``body``; each launch
    is held against the plain version on its own inputs.  With
    ``moe`` (the port's ``models.moe``), each MoE call of the prefill is
    timed by CUDA events and every MoE call counts its dropped slots.  ->
    dict: the outputs, the logits of rows 0 .. LM_E2E_ROWS - 1 (prefill,
    then each decode step), wall seconds of prefill and decode, the flash
    check, the peak memory, the MoE times and drops."""
    import torch
    from repro_torch.launch.serve import BatchServer
    from repro_torch.models import layers as LM

    batch, plen = len(prompts), len(prompts[0])
    server = BatchServer(cfg, params, max_seq=LM_MAX_SEQ, batch=batch,
                         device=dev)
    logits, times, captured = [], {"prefill": 0.0, "decode": 0.0}, []
    prefill, step = server._prefill, server._step
    moe_events, stats = [], {"prefill": {}, "decode": {}}

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

    def counting(phase, timed_events):
        real = moe.moe_forward

        def moe_forward(p, x, c, _=None):
            if not timed_events:
                return real(p, x, c, stats[phase])
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = real(p, x, c, stats[phase])
            ev[1].record()
            moe_events.append(ev)
            return out
        return real, moe_forward

    def patched(fn, phase, flash):
        def run(*a):
            restore = lambda: None
            if flash:
                launches, restore = capture_flash(FK)
            if moe is not None:
                real, moe.moe_forward = counting(phase, phase == "prefill")
            try:
                return fn(*a)
            finally:
                restore()
                if flash:
                    captured.extend(launches)
                if moe is not None:
                    moe.moe_forward = real
        return run

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

    prefill_ev = [torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)]

    def prefill_events(*a):
        prefill_ev[0].record()
        out = prefill(*a)
        prefill_ev[1].record()
        return out

    server._prefill = timed("prefill", patched(prefill_events, "prefill",
                                               True))
    server._step = timed("decode", patched(step_timing_attention, "decode",
                                           False))
    FK.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outs = server.generate(prompts, max_new=LM_NEW)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = FK.LAUNCHES["flash_attention"]
    if launches != flash_layers or len(captured) != flash_layers:
        raise AssertionError(f"the prefill launched the flash kernel "
                             f"{launches} times, not {flash_layers}")
    if FK.PATH_LAUNCHES[body] != launches:
        raise AssertionError(f"the prefill ran the flash bodies "
                             f"{FK.PATH_LAUNCHES}, not all on {body}")
    if any(len(o) != plen + LM_NEW for o in outs):
        raise AssertionError(f"lengths {[len(o) for o in outs]}")
    n_steps = len(logits) - 1
    r = dict(outs=outs, logits=logits, wall=wall, peak_gib=peak / 2**30,
             launches=launches, n_steps=n_steps,
             prefill_s=times["prefill"], decode_s=times["decode"],
             prefill_tps=batch * plen / times["prefill"],
             decode_tps=batch * n_steps / times["decode"],
             flash_s=sum(ev[0].elapsed_time(ev[1]) for *_, ev in captured)
             / 1e3,
             sdpa_s=sum(a.elapsed_time(b) for a, b in sdpa_events) / 1e3)
    if moe is not None:
        r["moe_share"] = (sum(a.elapsed_time(b) for a, b in moe_events)
                          / prefill_ev[0].elapsed_time(prefill_ev[1]))
        r["prefill_drops"] = [int(d) for d in stats["prefill"]["dropped"]]
        r["prefill_slots"] = stats["prefill"]["slots"][0]
        r["capacity"] = stats["prefill"]["capacity"][0]
        r["decode_drops"] = sum(int(d) for d in stats["decode"]["dropped"])
        r["decode_calls"] = len(stats["decode"]["dropped"])

    err, share, where = check_captured(FK, captured)
    r.update(max_abs_err=err, share=share, where=where)
    if captured:
        (B, S, H, dh), KV = captured[0][0].shape, captured[0][1].shape[2]
        each = [ev[0].elapsed_time(ev[1]) for *_, ev in captured]
        r.update(q_shape=(B, S, H, dh), flash_launch_ms=r["flash_s"] * 1e3
                 / len(captured), flash_ms_range=(min(each), max(each)),
                 flash_bound_ms=attention_bound(B, S, S, H, KV, dh, True)[0])
    r.update(body=body)
    return r


def check_captured(FK, captured):
    """Every captured flash launch ``(q, k, v, kw, o, events)`` of a
    prefill against the plain version on its own inputs, to both limits ->
    (max |err|, worst share, where)."""
    err = share = 0.0
    where = ""
    for i, (q, k, v, kw, o, _) in enumerate(captured):
        want = FK.flash_attention_plain(q, k, v, **kw)
        e, sh = flash_check(o, want)
        if not sh <= 1:
            raise AssertionError(f"a prefill flash launch != plain: max "
                                 f"|err| {e}, {sh:.3g} of the limit")
        if sh > share:
            where = f"{flash_worst(o, want)} in launch {i}"
        err, share = max(err, e), max(share, sh)
    return err, share, where


def log_wave(name, r, card):
    log(f"[serve] {name} wave of {len(r['outs'])} x "
        f"{len(r['outs'][0]) - LM_NEW} tokens, {LM_NEW} new, max_seq "
        f"{LM_MAX_SEQ}: prefill {r['prefill_s']:.3f}s "
        f"({r['prefill_tps']:,.0f} tokens/s; the {r['launches']} flash "
        f"launches {r['flash_s']:.4f}s of it by CUDA events), decode "
        f"{r['n_steps']} steps in {r['decode_s']:.3f}s "
        f"({r['decode_tps']:,.1f} tokens/s; plain attention over the cache "
        f"{r['sdpa_s']:.4f}s of it), wall {r['wall']:.2f}s, peak memory "
        f"{r['peak_gib']:.2f} GiB on {card}")
    if r["launches"]:
        lo, hi = r["flash_ms_range"]
        log(f"[serve] {name}: {r['launches']} prefill flash launches (q "
            f"{r['q_shape']}, all on the {r['body']} body; "
            f"{r['flash_launch_ms']:.4f} ms a launch ({lo:.4f}-{hi:.4f}) "
            f"against a bound of {r['flash_bound_ms']:.4f} ms) = plain: max "
            f"|err| {r['max_abs_err']:.3g} (tol 2e-2), worst share "
            f"{r['share']:.3f} of the limits; of the elementwise limit alone "
            f"{r['where']}")


def e2e_check(name, dec, ref):
    """Decode logits [rows, positions, V] against the forward's: max and
    mean |difference| within LM_E2E_MAX_TOL and LM_E2E_MEAN_TOL."""
    import torch
    diff = (dec - ref).abs()
    e2e = dict(max=float(diff.max()), mean=float(diff.mean()),
               logit_std=float(ref.std()),
               argmax_agree=float((dec.argmax(-1) == ref.argmax(-1))
                                  .float().mean()))
    log(f"[serve] {name} prefill + decode vs forward, {dec.shape[0]} "
        f"requests x {dec.shape[1]} positions: max |dlogit| "
        f"{e2e['max']:.4f} (tol {LM_E2E_MAX_TOL}), mean {e2e['mean']:.5f} "
        f"(tol {LM_E2E_MEAN_TOL}), logit std {e2e['logit_std']:.3f}, greedy "
        f"tokens agree on {100 * e2e['argmax_agree']:.1f}%")
    if not (e2e["max"] <= LM_E2E_MAX_TOL and e2e["mean"] <= LM_E2E_MEAN_TOL):
        raise AssertionError(f"{name}: prefill + decode logits != forward: "
                             f"{e2e}")
    if not torch.isfinite(dec).all():
        raise AssertionError(f"{name}: non-finite logits")
    return e2e


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
    from repro_torch.models import transformer as TFM

    cfg = get_config(LM_ARCH)
    params = TFM.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, cfg.vocab_size, size=LM_PROMPT)
               .astype(np.int32) for _ in range(LM_BATCH)]
    r = serve_wave(FK, dev, cfg, params, prompts, flash_layers=cfg.n_layers)
    log_wave(LM_ARCH, r, card)

    # prefill + decode logits against one forward over the same tokens
    seq = torch.as_tensor(np.stack(r["outs"][:LM_E2E_ROWS]), device=dev) \
        .long()
    FK.reset_launches()
    with torch.inference_mode():
        full, _ = TFM.forward(params, cfg, seq)
    if FK.LAUNCHES["flash_attention"] != cfg.n_layers:
        raise AssertionError("forward did not run the flash kernel per layer")
    n = len(r["logits"])
    e2e_check(LM_ARCH, torch.stack(r["logits"], dim=1),
              full[:, LM_PROMPT - 1:LM_PROMPT - 1 + n].float())
    return {k: r[k] for k in ("launches", "max_abs_err", "share")}


def moe_e2e(cfg, params, prompts, new, device, shift=0,
            max_seq=None):
    """Prefill + decode against one forward for an MoE model.  A wave of
    ``prompts`` (equal lengths) is served with every route recorded; one
    ``forward`` over the served tokens then gets, at every MoE layer, the
    routes the wave took for each token (``shift``: every route moved by
    that many experts, the planted fault), since top-k routing flips on
    bf16 rounding at near ties and a flipped token moves by far more than
    rounding.  -> dict: max and mean |logit difference| over the prefill's
    last position and every decode step, the logits' std, the positions
    compared, the slots dropped in the wave, and where the forward's own
    choice differs from the given routes: the share of (token, layer)
    pairs, and the largest relative difference between the two paths'
    router probabilities over all of them."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import BatchServer
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as TFM

    B, S = len(prompts), len(prompts[0])
    server = BatchServer(cfg, params, max_seq=max_seq or S + new + 1,
                         batch=B, device=device)
    calls, logits, stats = [], [], {}
    top, fwd = MOE.top_k, MOE.moe_forward

    def recording(probs, k):
        vals, idx = top(probs, k)
        calls.append((probs, idx))
        return vals, idx

    def keep_logits(fn):
        return lambda *a: (lambda out: logits.append(out[0]) or out)(fn(*a))

    server._prefill = keep_logits(server._prefill)
    server._step = keep_logits(server._step)
    MOE.top_k = recording
    MOE.moe_forward = lambda p, x, c, _=None: fwd(p, x, c, stats)
    try:
        outs = server.generate(prompts, max_new=new)
    finally:
        MOE.top_k, MOE.moe_forward = top, fwd
    n_moe = sum("moe" in b for b in params["layers"])
    steps = len(logits) - 1
    if len(calls) != n_moe * (1 + steps):
        raise AssertionError(f"{len(calls)} MoE calls, not {n_moe} x "
                             f"{1 + steps}")
    # per MoE layer: the routes of positions 0 .. S - 1 (prefill), then
    # S .. S + steps - 1 (one per decode step), for the forward's tokens
    K, E = cfg.top_k, cfg.n_experts
    given, probs_served = [], []
    for j in range(n_moe):
        per_step = [calls[n_moe * (1 + t) + j] for t in range(steps)]
        idx = torch.cat([calls[j][1].reshape(B, S, K)]
                        + [c[1].reshape(B, 1, K) for c in per_step], dim=1)
        pr = torch.cat([calls[j][0].reshape(B, S, E)]
                       + [c[0].reshape(B, 1, E) for c in per_step], dim=1)
        given.append((idx.reshape(-1, K) + shift) % E)
        probs_served.append(pr.reshape(-1, E))
    seq = torch.as_tensor(np.stack(outs), device=device).long()[:, :S + steps]
    at, differ, worst = [0], [0, 0], [0.0]

    def forcing(probs, k):
        j = at[0]
        at[0] += 1
        idx = given[j]
        own = top(probs, k)[1]
        bad = torch.any(torch.sort(own, 1)[0] != torch.sort(idx, 1)[0], 1)
        differ[0] += int(bad.sum())
        differ[1] += len(bad)
        worst[0] = max(worst[0], float(((probs - probs_served[j]).abs()
                                        / probs_served[j]).max()))
        return probs.gather(-1, idx), idx

    MOE.top_k = forcing
    try:
        with torch.inference_mode():
            full, _ = TFM.forward(params, cfg, seq)
    finally:
        MOE.top_k = top
    ref = full[:, S - 1:S - 1 + len(logits)].float()
    dec = torch.stack(logits, dim=1)
    diff = (dec - ref).abs()
    return dict(max=float(diff.max()), mean=float(diff.mean()),
                logit_std=float(ref.std()), positions=len(logits),
                argmax_agree=float((dec.argmax(-1) == ref.argmax(-1))
                                   .float().mean()),
                dropped=sum(int(d) for d in stats["dropped"]),
                routes_differ=differ[0] / differ[1],
                router_rel_diff=worst[0], finite=bool(torch.isfinite(dec)
                                                      .all()))


def check_moe_e2e(name, chk):
    log(f"[moe] {name} prefill + decode vs forward (no-drop capacity, the "
        f"forward on the wave's routes), {LM_E2E_ROWS} requests x "
        f"{chk['positions']} positions: max |dlogit| {chk['max']:.4f} (tol "
        f"{LM_E2E_MAX_TOL}), mean {chk['mean']:.5f} (tol {LM_E2E_MEAN_TOL}),"
        f" logit std {chk['logit_std']:.3f}, greedy tokens agree on "
        f"{100 * chk['argmax_agree']:.1f}%; dropped slots {chk['dropped']}; "
        f"the forward's own routes differ on {100 * chk['routes_differ']:.3f}"
        f"% of (token, layer) pairs, router probabilities of the two paths "
        f"within {chk['router_rel_diff']:.4f} relative (tol "
        f"{MOE_ROUTER_TOL})")
    if not (chk["max"] <= LM_E2E_MAX_TOL and chk["mean"] <= LM_E2E_MEAN_TOL
            and chk["finite"]):
        raise AssertionError(f"{name}: prefill + decode logits != forward: "
                             f"{chk}")
    if chk["dropped"]:
        raise AssertionError(f"{name}: the no-drop wave dropped slots")
    if not chk["router_rel_diff"] <= MOE_ROUTER_TOL:
        raise AssertionError(f"{name}: the paths' routers disagree: {chk}")


def free_card():
    """Drop what only reference cycles still hold (a BatchServer and the
    wrappers around its calls keep the weights alive) and return the
    cache to the card."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def seeded_params(cfg, dev, seed):
    """Seeded random weights on the card -> (params, seconds, GiB)."""
    import torch
    from repro_torch.models.registry import get_model_fns
    from repro_torch.tree import tree_leaves
    free_card()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = get_model_fns(cfg).init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    torch.cuda.synchronize()
    n = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    return params, time.perf_counter() - t0, n / 2**30


def phase_moe_serve(FK, dev, card, arch, n_layers, why):
    """Phase 17a / 17b: an MoE model at published widths (``n_layers`` of
    its layers, fp32 weights), one BatchServer wave of LM_BATCH x
    LM_PROMPT tokens at the published capacity factor: prefill and decode
    tokens/s, the peak, the MoE layers' share of the prefill (CUDA
    events), the dropped slots of each call; the flash kernel once per
    layer on the wgmma body (GQA; MLA launches none), each launch held
    against the plain version.  Then a second wave of LM_E2E_ROWS of the
    prompts at a capacity no slot can exceed (n_experts / top_k):
    prefill + decode logits against one forward (:func:`moe_e2e`).  MLA
    models run both decode paths (naive, absorbed)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import BatchServer
    from repro_torch.models import moe as MOE

    cfg = get_config(arch).replace(n_layers=n_layers)
    params, init_s, gib = seeded_params(cfg, dev, 17)
    rng = np.random.default_rng(18)
    prompts = [rng.integers(0, cfg.vocab_size, size=LM_PROMPT)
               .astype(np.int32) for _ in range(LM_BATCH)]
    # the first wave loads and picks kernels for these shapes: time it
    # apart (2 new tokens), then measure a warm wave
    t0 = time.perf_counter()
    BatchServer(cfg, params, max_seq=LM_MAX_SEQ, batch=LM_BATCH,
                device=dev).generate(prompts, max_new=2)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    free_card()
    log(f"[moe] {arch}: {cfg.n_layers} of {get_config(arch).n_layers} "
        f"layers ({why}), {cfg.param_count():,} parameters, {gib:.2f} GiB "
        f"of fp32 weights made on the card in {init_s:.1f}s; a first wave "
        f"of the same prompts, 2 new tokens, {cold:.2f}s")
    gqa = cfg.attn_kind == "gqa"
    out = {"n_layers": cfg.n_layers, "params": cfg.param_count()}
    for absorb in ((False,) if gqa else (False, True)):
        c = cfg.replace(mla_absorb=absorb)
        name = arch + (" (absorbed decode)" if absorb else "")
        r = serve_wave(FK, dev, c, params, prompts,
                       flash_layers=cfg.n_layers if gqa else 0, moe=MOE)
        log_wave(name, r, card)
        log(f"[moe] {name}: the MoE layers {100 * r['moe_share']:.1f}% of "
            f"the prefill (CUDA events); dropped slots of "
            f"{r['prefill_slots']:,} per prefill call (capacity "
            f"{r['capacity']:,} a expert, factor {cfg.capacity_factor}): "
            f"{r['prefill_drops']}; in {r['decode_calls']} decode calls "
            f"{r['decode_drops']}")
        nd = c.replace(capacity_factor=cfg.n_experts / cfg.top_k)
        chk = moe_e2e(nd, params, prompts[:LM_E2E_ROWS], LM_NEW, dev,
                      max_seq=LM_MAX_SEQ)
        check_moe_e2e(name, chk)
        if not absorb:
            p = params["layers"][-1]["moe"]
            top, total = layer_profile(lambda m: MOE.moe_forward(p, m, c),
                                       c, dev, 19)
            log(f"[moe] {arch}: one MoE layer alone at the prefill shape "
                f"({LM_BATCH} x {LM_PROMPT} tokens of unit RMS, torch."
                f"profiler): {total:.3f} ms of kernels; the largest: "
                + "; ".join(f"{k} {v:.3f} ms" for k, v in top))
        out["absorbed" if absorb else "naive"] = dict(
            {k: r.get(k) for k in ("prefill_tps", "decode_tps", "peak_gib",
                                   "moe_share", "prefill_drops",
                                   "decode_drops", "launches", "max_abs_err",
                                   "share", "flash_launch_ms",
                                   "flash_bound_ms")},
            e2e={k: chk[k] for k in ("max", "mean", "routes_differ",
                                     "router_rel_diff")})
    del params
    free_card()
    if gqa:
        out["alone"] = flash_library_alone(
            FK, dev, (LM_BATCH, LM_PROMPT, cfg.n_heads, cfg.n_kv_heads,
                      cfg.d_head), card, "moe")
    return out


def layer_profile(fn, cfg, dev, seed):
    """``fn(x)``, one layer's call, at the prefill shape (LM_BATCH x
    LM_PROMPT tokens, random of unit RMS from ``seed``) under
    ``torch.profiler`` -> (the 6 kernels with the most device time [(name,
    ms)], total device ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((LM_BATCH, LM_PROMPT, cfg.d_model), generator=gen,
                    device=dev).to(cfg.cdtype())
    with torch.inference_mode():
        fn(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn(x)
            torch.cuda.synchronize()
    rows = sorted(((e.key[:60], e.self_device_time_total / 1e3)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda kv: -kv[1])
    return rows[:6], sum(v for _, v in rows)


def hold_launches(FK, captured, dev, absolute=False):
    """Each captured flash launch ``(q, k, v, o, kw)`` (host copies)
    against the plain version on its own inputs, to the elementwise bf16
    limit (and to FLASH_TOL where ``absolute``) -> (max |err|, worst share,
    where, the last launch's inputs and plain output on the card)."""
    err = share = 0.0
    where = ""
    for i, (q, k, v, o, kw) in enumerate(captured):
        q, k, v, o = (t.to(dev) for t in (q, k, v, o))
        want_o = FK.flash_attention_plain(q, k, v, **kw)
        e, sh = flash_check(o, want_o, absolute=absolute)
        if not sh <= 1:
            raise AssertionError(f"flash launch {i} != plain: max "
                                 f"|err| {e}, {sh:.3g} of the limit; "
                                 f"{flash_worst(o, want_o)}")
        if sh > share:
            where = f"{flash_worst(o, want_o)} in launch {i}"
        err, share = max(err, e), max(share, sh)
    return err, share, where, (q, k, v, kw, want_o)


def phase_moe_train(FK, dev, card):
    """Phase 17c: ``launch.train.main`` on phi3.5-moe at published widths,
    MOE_TRAIN_LAYERS layers (``get_config`` cut for the run), B
    MOE_TRAIN_BATCH x S TRAIN_SEQ, MOE_TRAIN_STEPS steps under the model's
    ``"dots"`` remat.  The loss must be finite and hold the aux term
    (``loss_fn`` less the same loss at ``router_aux_coef`` 0 equals coef x
    aux / n_layers on the final weights); the router and every expert of
    w1 / w2 / w3 must move from their seeded start and carry a nonzero
    first moment; every layer's forward launches the flash kernel on the
    wgmma body, each launch of the first step held against the plain
    version."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStreamSpec, batch_for_step
    from repro_torch.models import transformer as TFM

    cfg = get_config(MOE_ARCH).replace(n_layers=MOE_TRAIN_LAYERS)
    forwards = 1 if cfg.remat_policy == "everything" else 2
    per_step = cfg.n_layers * forwards
    run = train_main_run(FK, MOE_ARCH, MOE_TRAIN_BATCH, MOE_TRAIN_STEPS,
                         MOE_TRAIN_LAYERS, capture=per_step)
    launches, want = dict(FK.PATH_LAUNCHES), per_step * MOE_TRAIN_STEPS
    if launches["wgmma"] != want or FK.LAUNCHES["flash_attention"] != want:
        raise AssertionError(f"{MOE_TRAIN_STEPS} steps launched the flash "
                             f"bodies {launches}, not wgmma {want} times")
    losses, step_ms, captured = run["losses"], run["step_ms"], run["captured"]

    # the aux term is in the loss, on the final weights and step 0's batch
    state = run.pop("state")
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch_for_step(
        TokenStreamSpec(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                        global_batch=MOE_TRAIN_BATCH, seed=0), 0).items()}
    with torch.no_grad():
        loss = float(TFM.loss_fn(state["params"], cfg, batch))
        ce = float(TFM.loss_fn(state["params"],
                               cfg.replace(router_aux_coef=0.0), batch))
        aux = float(TFM.forward(state["params"], cfg, batch["tokens"])[1])
    aux_term = cfg.router_aux_coef * aux / cfg.n_layers
    if not (aux > 0 and abs(loss - ce - aux_term) <= 1e-3 * aux_term):
        raise AssertionError(f"the loss {loss} is not the cross-entropy {ce}"
                             f" + the aux term {aux_term}")

    # the router and every expert moved and saw a gradient (phi has no
    # shared expert)
    start = TFM.init_params(cfg, 0, dev)
    moved = {}
    for i, (blk, blk0) in enumerate(zip(state["params"]["layers"],
                                        start["layers"])):
        m = state["opt"]["m"]["layers"][i]["moe"]
        for name in ("router", "w1", "w2", "w3"):
            a, b, g = blk["moe"][name], blk0["moe"][name], m[name]
            dims = (0,) if name == "router" else (1, 2)
            ok = (a != b).any(dim=dims) & (g != 0).any(dim=dims)
            moved[f"{i}.{name}"] = f"{int(ok.sum())}/{ok.numel()}"
            if not bool(ok.all()):
                raise AssertionError(f"layer {i} {name}: moved with a "
                                     f"gradient in {moved[f'{i}.{name}']}")
    del start, state
    err, share, where, _ = hold_launches(FK, captured, dev)
    shape = tuple(captured[0][0].shape)
    del captured
    free_card()
    log(f"[moe] train {MOE_ARCH}, {cfg.n_layers} of "
        f"{get_config(MOE_ARCH).n_layers} layers ({cfg.param_count():,} "
        f"parameters; fp32 weights, gradients and AdamW moments), "
        f"{MOE_TRAIN_BATCH} x {TRAIN_SEQ} tokens, {MOE_TRAIN_STEPS} steps "
        f"in {run['wall_s']:.1f}s: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"(aux term {aux_term:.5f} on the final weights); step "
        f"{step_ms:.1f} ms (median of steps 1-{MOE_TRAIN_STEPS - 1}), "
        f"{run['tokens_per_s']:,.0f} tokens/s, peak memory "
        f"{run['peak_gib']:.2f} GiB; flash launches {launches['wgmma']} on "
        f"wgmma; router and experts moved with a gradient (columns or "
        f"experts per layer): {moved}; card: {card}")
    log(f"[moe] train: the {per_step} flash launches of step 0 (q {shape}, "
        f"bf16, causal) = plain: max |err| {err:.3g}, worst share "
        f"{share:.3f} of the elementwise limit, {where}")
    return dict(launches=launches["wgmma"], step_ms=step_ms,
                tokens_per_s=run["tokens_per_s"], peak_gib=run["peak_gib"],
                losses=losses, aux_term=aux_term, max_abs_err=err,
                share=share)


def ssm_e2e(cfg, params, prompts, new, device, served=None,
            drop_state=False):
    """Prefill + decode against one forward for an SSM or hybrid model.
    The logits of a wave of ``prompts`` (equal lengths; served here, or
    ``served`` = the outputs and the logits of a wave already served: the
    prefill's last position, then each decode step) against one
    ``forward`` over the prompt and the tokens decoded from it, with filler
    (token 0) at the end up to a multiple of ``cfg.ssm_chunk``: the SSD
    keeps its chunk rule, and being causal, the filler moves no compared
    position.  ``drop_state`` plants a fault for the check's control: each
    decode step gets a zeroed SSM state in place of the one carried from
    the prefill.  -> dict: max and mean |logit difference|, the logits'
    std, greedy agreement, positions compared, the padded length, finite."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import BatchServer
    from repro_torch.models import ssm as SSM
    from repro_torch.models import transformer as TFM

    S = len(prompts[0])
    if served is None:
        server = BatchServer(cfg, params, max_seq=S + new + 1,
                             batch=len(prompts), device=device)
        logits = []

        def keep(fn):
            return lambda *a: (lambda out: logits.append(out[0]) or out)(
                fn(*a))
        server._prefill = keep(server._prefill)
        server._step = keep(server._step)
        real = SSM.ssm_decode
        if drop_state:
            SSM.ssm_decode = lambda p, h, c, s, cv: real(
                p, h, c, torch.zeros_like(s), cv)
        try:
            outs = server.generate(prompts, max_new=new)
        finally:
            SSM.ssm_decode = real
    else:
        outs, logits = served
    rows, n = logits[0].shape[0], S + len(logits) - 1
    Q = cfg.ssm_chunk
    padded = n if n <= Q else -(-n // Q) * Q
    seq = np.zeros((rows, padded), np.int64)
    seq[:, :n] = np.stack([o[:n] for o in outs[:rows]])
    with torch.inference_mode():
        full, _ = TFM.forward(params, cfg, torch.as_tensor(seq,
                                                           device=device))
    ref = full[:, S - 1:S - 1 + len(logits)].float()
    dec = torch.stack(logits, dim=1).float()
    diff = (dec - ref).abs()
    return dict(max=float(diff.max()), mean=float(diff.mean()),
                logit_std=float(ref.std()), positions=len(logits),
                rows=rows, padded_to=padded, argmax_agree=float(
                    (dec.argmax(-1) == ref.argmax(-1)).float().mean()),
                finite=bool(torch.isfinite(dec).all()))


def check_e2e(name, chks, tol, card="", fault=None, tag="serve", what=""):
    """Log runs of prefill + decode against one forward, one a dtype of
    ``tol`` (``chks[dt]`` against the bounds ``tol[dt]``; ``what`` says
    what the forward ran over); raise unless each is finite and within its
    bounds, or, for a planted ``fault`` (its description), unless each
    exceeds both."""
    def line(c, lim):
        return (f"max |dlogit| {c['max']:.4g} (tol {lim['max']:.4g}), mean "
                f"{c['mean']:.4g} (tol {lim['mean']:.4g}), logit std "
                f"{c['logit_std']:.3f}, greedy tokens agree on "
                f"{100 * c['argmax_agree']:.1f}%")
    c0 = next(iter(chks.values()))
    log(f"[{tag}] {name} prefill + decode"
        + (f" ({fault}, planted)" if fault else "")
        + f" vs one forward{what}, {c0['rows']} requests x "
        f"{c0['positions']} positions: "
        + "; ".join(f"{dt} {line(chks[dt], lim)}" for dt, lim in tol.items())
        + (f"; card: {card}" if card else ""))
    for dt, lim in tol.items():
        c = chks[dt]
        within = [c[k] <= lim[k] for k in ("max", "mean")]
        if fault and any(within):
            raise AssertionError(f"{name}: {fault} passed a {dt} bound: {c} "
                                 f"against {lim}")
        if not fault and not (all(within) and c["finite"]):
            raise AssertionError(f"{name}: {dt} prefill + decode logits != "
                                 f"forward: {c} against {lim}")


def check_ssm_e2e(name, chks, tol, card="", fault=False):
    """:func:`check_e2e` for :func:`ssm_e2e`'s runs; the planted fault is
    a decode without the SSM state."""
    check_e2e(name, chks, tol, card,
              fault="a decode without the SSM state" if fault else None,
              tag="ssm", what=" (prompt, decoded tokens, filler to "
              f"{next(iter(chks.values()))['padded_to']})")


def phase_hybrid_flash(FK, fops, dev, shape, card):
    """Phase 18b's flash launch shape alone (bf16, causal, random inputs
    of scale 0.5): the default body (wgmma at dh 112) and the fp32 pipes by
    name against the plain version, then both, the plain version and
    ``scaled_dot_product_attention`` (timed only) in two turns, beside the
    bound."""
    import torch
    import torch.nn.functional as F
    B, S, H, KV, dh = shape
    gen = torch.Generator(device=dev).manual_seed(112)
    rnd = lambda *s: (torch.randn(s, generator=gen, device=dev)
                      * 0.5).to(torch.bfloat16)
    q, k, v = rnd(B, S, H, dh), rnd(B, S, KV, dh), rnd(B, S, KV, dh)
    outs, want = flash_pair(FK, fops, q, k, v, True)
    body = next(iter(outs))
    checks = {b: flash_check(got, want) for b, got in outs.items()}
    if body != HYBRID_FLASH_BODY or not max(
            sh for _, sh in checks.values()) <= 1:
        raise AssertionError(f"flash at {shape} != plain or not on "
                             f"{HYBRID_FLASH_BODY}: {checks}")
    err, share = checks[body]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    runs = {body: (lambda: FK.flash_attention_cuda(q, k, v, causal=True), 50),
            "fp32_pipes": (lambda: FK.flash_attention_cuda(
                q, k, v, causal=True, body="fp32_pipes"), 5),
            "plain": (lambda: FK.flash_attention_plain(q, k, v, causal=True),
                      2),
            "library": (lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), 50)}
    turns = {name: [] for name in runs}
    for order in (list(runs), list(runs)[::-1]):
        for name in order:
            turns[name].append(cuda_ms(*runs[name]))
    ms = {name: sum(t) / len(t) for name, t in turns.items()}
    bound_ms, bound_by = attention_bound(B, S, S, H, KV, dh, True)
    log(f"[ssm] flash at zamba2's shape B {B} S {S} H {H} KV {KV} dh {dh} "
        f"bf16 causal, default body {body}: = plain, max |err| {err:.3g}, "
        f"{share:.3f} of the limits (fp32 pipes {checks['fp32_pipes'][0]:.3g}"
        f", {checks['fp32_pipes'][1]:.3f}); bound {bound_ms:.4f} ms "
        f"({bound_by}); ms (two turns): " + "; ".join(
            f"{n} {ms[n]:.4f} ({', '.join(f'{t:.4f}' for t in turns[n])})"
            for n in runs)
        + f"; {body} at {100 * bound_ms / ms[body]:.2f}% of the bound, "
        f"{ms['fp32_pipes'] / ms[body]:.1f}x faster than the fp32 pipes, "
        f"{ms[body] / ms['library']:.2f}x the library call's time; card: "
        f"{card}")
    return dict(body=body, ms=ms[body], fp32_pipes_ms=ms["fp32_pipes"],
                plain_ms=ms["plain"], library_ms=ms["library"],
                bound_ms=bound_ms, bound_by=bound_by,
                max_abs_err=max(e for e, _ in checks.values()),
                share=max(sh for _, sh in checks.values()))


def phase_ssm_serve(FK, fops, dev, card, arch):
    """Phase 18a / 18b: an SSM or hybrid model whole at published widths,
    seeded fp32 weights.  ``serve.main(["--arch", arch])`` (the launcher's
    defaults, two waves); then one BatchServer wave of LM_BATCH x
    LM_PROMPT tokens, LM_NEW new (after a cold wave of the same prompts, 2
    new tokens, timed apart): prefill and decode tokens/s, the peak.  A
    hybrid's shared block launches the flash kernel once per application
    in each prefill, all on HYBRID_FLASH_BODY, each launch (the launcher's
    and the wave's) held against the plain version to both limits; an SSM
    model launches none.  Then prefill + decode logits of LM_E2E_ROWS
    requests against one forward (:func:`ssm_e2e`), in bf16 and again in
    fp32, within SSM_E2E_TOL, and with the planted fault past it
    (:func:`check_ssm_e2e`); one Mamba2 layer profiled at the prefill
    shape.  A hybrid's flash launch shape is then timed alone
    (:func:`phase_hybrid_flash`)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.launch.serve import BatchServer
    from repro_torch.models import ssm as SSM
    from repro_torch.models import transformer as TFM

    cfg = get_config(arch)
    apps = TFM.n_shared_apps(cfg)
    free_card()
    FK.reset_launches()
    t0 = time.perf_counter()
    captured, restore = capture_flash(FK)
    try:
        rc = serve.main(["--arch", arch])
    finally:
        restore()
    wall = time.perf_counter() - t0
    main_launches = FK.LAUNCHES["flash_attention"]
    if (rc != 0 or main_launches != 2 * apps
            or len(captured) != main_launches
            or FK.PATH_LAUNCHES[HYBRID_FLASH_BODY] != main_launches):
        raise AssertionError(f"serve.main {arch}: rc {rc}, flash bodies "
                             f"{FK.PATH_LAUNCHES}, not {2 * apps} on "
                             f"{HYBRID_FLASH_BODY}")
    main_err, main_share, _ = check_captured(FK, captured)
    del captured
    log(f"[ssm] serve.main --arch {arch} (2 waves, weights made on the card "
        f"included) in {wall:.1f}s; flash launches {main_launches}"
        + (f" on {HYBRID_FLASH_BODY}, = plain: max |err| {main_err:.3g}, "
           f"{main_share:.3f} of the limits" if main_launches else ""))

    params, init_s, gib = seeded_params(cfg, dev, 23)
    rng = np.random.default_rng(24)
    prompts = [rng.integers(0, cfg.vocab_size, size=LM_PROMPT)
               .astype(np.int32) for _ in range(LM_BATCH)]
    t0 = time.perf_counter()
    BatchServer(cfg, params, max_seq=LM_MAX_SEQ, batch=LM_BATCH,
                device=dev).generate(prompts, max_new=2)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    free_card()
    log(f"[ssm] {arch}: {cfg.n_layers} layers ({apps} shared-block "
        f"applications), {cfg.param_count():,} parameters, {gib:.2f} GiB of "
        f"fp32 weights made on the card in {init_s:.1f}s; a first wave of "
        f"the same prompts, 2 new tokens, {cold:.2f}s")
    r = serve_wave(FK, dev, cfg, params, prompts, flash_layers=apps,
                   body=HYBRID_FLASH_BODY)
    log_wave(arch, r, card)
    cfgs = {"bfloat16": cfg, "float32": cfg.replace(
        compute_dtype="float32", cache_dtype="float32")}
    chks = {dt: ssm_e2e(c, params, prompts[:LM_E2E_ROWS], LM_NEW, dev,
                        served=(r["outs"], r["logits"]) if c is cfg else None)
            for dt, c in cfgs.items()}
    check_ssm_e2e(arch, chks, SSM_E2E_TOL, card)
    bad = {dt: ssm_e2e(c, params, prompts[:LM_E2E_ROWS], LM_NEW, dev,
                       drop_state=True) for dt, c in cfgs.items()}
    check_ssm_e2e(arch, bad, SSM_E2E_TOL, card, fault=True)
    p = params["layers"][-1]["ssm"]
    top, total = layer_profile(lambda h: SSM.ssm_forward(p, h, cfg), cfg,
                               dev, 25)
    log(f"[ssm] {arch}: one Mamba2 layer alone at the prefill shape "
        f"({LM_BATCH} x {LM_PROMPT} tokens of unit RMS, torch.profiler): "
        f"{total:.3f} ms of kernels; the largest: "
        + "; ".join(f"{k} {v:.3f} ms" for k, v in top))
    out = {"params": cfg.param_count(), "main_launches": main_launches,
           "main_max_abs_err": main_err, "main_share": main_share,
           "layer_ms": total,
           **{f"e2e{'_fault' if b else ''}": {
               dt: {k: c[dt][k] for k in ("max", "mean", "logit_std")}
               for dt in c} for b, c in ((False, chks), (True, bad))},
           **{k: r.get(k) for k in ("prefill_tps", "decode_tps", "peak_gib",
                                    "launches", "max_abs_err", "share",
                                    "flash_launch_ms", "flash_ms_range",
                                    "flash_bound_ms")}}
    del params, r
    free_card()
    if apps:
        out["flash"] = phase_hybrid_flash(
            FK, fops, dev, (LM_BATCH, LM_PROMPT, cfg.n_heads, cfg.n_kv_heads,
                            cfg.d_head), card)
    return out


def phase_ssm_train(FK, dev, card):
    """Phase 18c: ``launch.train.main`` on mamba2-780m whole (B TRAIN_BATCH
    x S TRAIN_SEQ, SSM_TRAIN_STEPS steps) and on zamba2-7b at
    HYBRID_TRAIN_LAYERS of its layers (``get_config`` cut for the run; B
    HYBRID_TRAIN_BATCH, HYBRID_TRAIN_STEPS steps), both under the models'
    ``"dots"`` remat.  Losses finite, mamba2's falling; mamba2 launches no
    flash kernel; zamba2's shared block launches it on HYBRID_FLASH_BODY
    once per application and forward (twice under ``"dots"``), each launch
    of every step held against the plain version to both limits; every
    leaf of zamba2's SSM layers and of its shared block moved from its
    seeded start with a nonzero first moment.  Step ms (median after the first), tokens/s,
    peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TFM

    out = {}
    m = train_main_run(FK, SSM_ARCH, TRAIN_BATCH, SSM_TRAIN_STEPS)
    del m["state"], m["captured"]
    if FK.LAUNCHES["flash_attention"] or not m["losses"][-1] < m["losses"][0]:
        raise AssertionError(f"{SSM_ARCH}: flash launches {FK.LAUNCHES}, "
                             f"losses {m['losses']}")
    log(f"[ssm] train {SSM_ARCH} whole ({get_config(SSM_ARCH).param_count():,}"
        f" parameters), {TRAIN_BATCH} x {TRAIN_SEQ} tokens, "
        f"{SSM_TRAIN_STEPS} steps in {m['wall_s']:.1f}s: loss "
        f"{m['losses'][0]:.4f} -> {m['losses'][-1]:.4f}; step "
        f"{m['step_ms']:.1f} ms (median of steps 1-{SSM_TRAIN_STEPS - 1}), "
        f"{m['tokens_per_s']:,.0f} tokens/s, peak memory "
        f"{m['peak_gib']:.2f} GiB; no flash launch; card: {card}")
    out["mamba2"] = m

    cfg = get_config(HYBRID_ARCH).replace(n_layers=HYBRID_TRAIN_LAYERS)
    per_step = TFM.n_shared_apps(cfg) * (
        1 if cfg.remat_policy == "everything" else 2)
    want = per_step * HYBRID_TRAIN_STEPS
    z = train_main_run(FK, HYBRID_ARCH, HYBRID_TRAIN_BATCH,
                       HYBRID_TRAIN_STEPS, HYBRID_TRAIN_LAYERS,
                       capture=want, keep_on_card=True)
    state, captured = z.pop("state"), z.pop("captured")
    if (FK.LAUNCHES["flash_attention"] != want
            or FK.PATH_LAUNCHES[HYBRID_FLASH_BODY] != want):
        raise AssertionError(f"{HYBRID_TRAIN_STEPS} steps launched the "
                             f"flash bodies {FK.PATH_LAUNCHES}, not "
                             f"{HYBRID_FLASH_BODY} {want} times")
    # every leaf of the SSM layers and of the shared block moved with a
    # gradient
    moved = moved_with_gradient(state, TFM.init_params(cfg, 0, dev),
                                ("['layers']", "['shared_attn']"))
    err, share, where, _ = hold_launches(FK, captured, dev, absolute=True)
    shape = tuple(captured[0][0].shape)
    del captured, state
    free_card()
    z.update(launches=want, max_abs_err=err, share=share)
    log(f"[ssm] train {HYBRID_ARCH}, {cfg.n_layers} of "
        f"{get_config(HYBRID_ARCH).n_layers} layers ({cfg.param_count():,} "
        f"parameters; {TFM.n_shared_apps(cfg)} shared-block applications), "
        f"{HYBRID_TRAIN_BATCH} x {TRAIN_SEQ} tokens, {HYBRID_TRAIN_STEPS} "
        f"steps in {z['wall_s']:.1f}s: loss {z['losses'][0]:.4f} -> "
        f"{z['losses'][-1]:.4f}; step {z['step_ms']:.1f} ms, "
        f"{z['tokens_per_s']:,.0f} tokens/s, peak memory {z['peak_gib']:.2f} "
        f"GiB; flash launches {want} on {HYBRID_FLASH_BODY}; {moved} leaves "
        f"of the layers and the shared block moved with a gradient; card: "
        f"{card}")
    log(f"[ssm] train: the {want} flash launches of {HYBRID_TRAIN_STEPS} "
        f"steps (q {shape}, bf16, causal, {HYBRID_FLASH_BODY}) = plain: max "
        f"|err| {err:.3g} (tol 2e-2), worst share {share:.3f} of both "
        f"limits, {where}")
    out["zamba2"] = z
    return out


def mrope_grid_positions(B, S, grid):
    """qwen2-vl's M-RoPE positions [B, S, 3] (numpy int32) of an image of
    ``grid`` x ``grid`` patches at positions 0 .. grid**2 - 1 followed by
    text: a patch has temporal 0, height its row and width its column; the
    text goes on from the grid's largest position plus one, equal in the
    three sections."""
    import numpy as np
    P = grid * grid
    pos = np.zeros((S, 3), np.int32)
    pos[:P, 1], pos[:P, 2] = np.divmod(np.arange(P), grid)
    pos[P:] = (grid + np.arange(S - P))[:, None]
    return np.ascontiguousarray(np.broadcast_to(pos, (B, S, 3)))


def greedy(fns, cfg, params, toks, new, max_seq, prefill_kw,
           step_kw=lambda n: {}, rows=LM_E2E_ROWS, corrupt=None):
    """``fns.prefill(params, cfg, toks, **prefill_kw)`` into a ``max_seq``
    cache, then ``new - 1`` greedy ``fns.serve_step`` calls (``step_kw(n)``
    the keywords of the step at cache length n), the prefill and each step
    synchronised and timed.  ``corrupt(cache)`` (a planted fault) may
    change the cache after the prefill.  -> dict: ``outs`` [B, S + new]
    (numpy), the logits of the first ``rows`` requests (the prefill's last
    position, then each step), prefill and decode seconds."""
    import numpy as np
    import torch
    B, S = toks.shape
    sync = torch.cuda.synchronize if toks.is_cuda else (lambda: None)
    with torch.inference_mode():
        sync()
        t0 = time.perf_counter()
        logits, pcache = fns.prefill(params, cfg, toks, **prefill_kw)
        tok = logits.argmax(-1)
        out, kept = [tok], [logits[:rows].clone()]
        sync()
        t1 = time.perf_counter()
        cache = fns.init_cache(cfg, B, max_seq, toks.device)
        for k, small in pcache.items():
            cache[k][tuple(slice(0, n) for n in small.shape)] = small
        del pcache
        if corrupt is not None:
            corrupt(cache)
        for t in range(new - 1):
            logits, cache = fns.serve_step(params, cfg, cache, tok, S + t,
                                           **step_kw(S + t))
            tok = logits.argmax(-1)
            out.append(tok)
            kept.append(logits[:rows].clone())
        sync()
        t2 = time.perf_counter()
    outs = np.concatenate([toks.cpu().numpy(),
                           torch.stack(out, 1).cpu().numpy()], axis=1)
    return dict(outs=outs, logits=kept, prefill_s=t1 - t0,
                decode_s=t2 - t1, steps=new - 1)


def e2e_against_forward(fns, cfg, params, served, S, forward_kw):
    """The logits of a wave served by :func:`greedy` against one
    ``forward`` over its first rows' prompts and decoded tokens (the last
    decoded token has no logits to compare) -> dict: max and mean
    |difference|, the logits' std, greedy agreement, rows, positions,
    finite."""
    import torch
    kept = served["logits"]
    rows, n = kept[0].shape[0], len(kept)
    dev = kept[0].device
    seq = torch.as_tensor(served["outs"][:rows, :S + n - 1], device=dev)
    with torch.inference_mode():
        full, _ = fns.forward(params, cfg, seq.long(), **forward_kw)
    ref = full[:, S - 1:S - 1 + n].float()
    dec = torch.stack(kept, dim=1).float()
    diff = (dec - ref).abs()
    return dict(max=float(diff.max()), mean=float(diff.mean()),
                logit_std=float(ref.std()), rows=rows, positions=n,
                argmax_agree=float((dec.argmax(-1) == ref.argmax(-1))
                                   .float().mean()),
                finite=bool(torch.isfinite(dec).all()))


def encdec_e2e(cfg, params, frames, prompts, new, device, served=None,
               fault=False):
    """Prefill + greedy decode against one forward for an enc-dec model:
    ``frames`` [B, T, D] and ``prompts`` [B, S] (tensor or numpy) served
    here (or ``served`` = :func:`greedy`'s result for them), the logits of
    the first LM_E2E_ROWS requests against one ``forward`` over the same
    frames, prompts and decoded tokens.  ``fault`` plants one for the
    check's control: each request's decode reads the next request's cross
    caches (another recording's encoder states)."""
    import torch
    from repro_torch.models.registry import get_model_fns
    fns = get_model_fns(cfg)
    toks = torch.as_tensor(prompts, device=device).long()
    frames = torch.as_tensor(frames, device=device)
    S = toks.shape[1]

    def roll(cache):
        for k in ("ck", "cv"):
            cache[k].copy_(cache[k].roll(1, dims=1))

    if served is None:
        served = greedy(fns, cfg, params, toks, new, S + new,
                        {"frames": frames}, corrupt=roll if fault else None)
    rows = served["logits"][0].shape[0]
    return e2e_against_forward(fns, cfg, params, served, S,
                               {"frames": frames[:rows]})


def vlm_e2e(cfg, params, prompts, patches, new, grid, device, served=None,
            fault=False):
    """Prefill + greedy decode against one forward for a VLM: ``prompts``
    [B, S] whose first grid**2 positions are the image's ``patches`` [B,
    grid**2, D], M-RoPE positions by :func:`mrope_grid_positions` (each
    decode step given its token's), served here or ``served`` as in
    :func:`encdec_e2e`.  ``fault`` plants one: the decode steps take no
    M-RoPE positions (plain RoPE at the cache length)."""
    import torch
    from repro_torch.models.registry import get_model_fns
    fns = get_model_fns(cfg)
    toks = torch.as_tensor(prompts, device=device).long()
    patches = torch.as_tensor(patches, device=device)
    B, S = toks.shape
    mpos = torch.as_tensor(mrope_grid_positions(B, S + new, grid),
                           device=device)
    if served is None:
        step_kw = ((lambda n: {}) if fault
                   else (lambda n: {"mrope_pos": mpos[:, n:n + 1]}))
        served = greedy(fns, cfg, params, toks, new, S + new,
                        {"patch_embeds": patches,
                         "mrope_pos": mpos[:, :S]}, step_kw)
    rows, n = served["logits"][0].shape[0], len(served["logits"])
    return e2e_against_forward(fns, cfg, params, served, S, {
        "patch_embeds": patches[:rows],
        "mrope_pos": mpos[:rows, :S + n - 1]})


def capture_flash(FK):
    """Patch ``FK.flash_attention_cuda`` to keep each launch's inputs,
    keywords, output and CUDA events -> (the list, a function that
    restores the real launcher)."""
    import torch
    launch, captured = FK.flash_attention_cuda, []

    def capturing(q, k, v, **kw):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        o = launch(q, k, v, **kw)
        ev[1].record()
        captured.append((q, k, v, kw, o, ev))
        return o

    FK.flash_attention_cuda = capturing
    return captured, lambda: setattr(FK, "flash_attention_cuda", launch)


def direct_wave(FK, cfg, params, toks, new, max_seq, prefill_kw, step_kw,
                flash_layers):
    """A wave served through ``get_model_fns(cfg).prefill`` /
    ``serve_step`` (:func:`greedy`) after a first wave of 2 new tokens
    (timed apart), with the launch counts set to 0 just before it: the
    wave (its prefill; decode attention runs ``_sdpa``) must launch the
    flash kernel ``flash_layers`` times, all on the wgmma body, each launch
    held against the plain version on its own inputs.  -> dict: the served
    wave, tokens/s, the peak, the launches, each launch's ms by CUDA
    events, the check, the captured launches."""
    import torch
    from repro_torch.models.registry import get_model_fns
    fns = get_model_fns(cfg)
    B, S = toks.shape
    t0 = time.perf_counter()
    greedy(fns, cfg, params, toks, 2, max_seq, prefill_kw, step_kw)
    cold = time.perf_counter() - t0
    free_card()
    FK.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    captured, restore = capture_flash(FK)
    try:
        served = greedy(fns, cfg, params, toks, new, max_seq, prefill_kw,
                        step_kw)
    finally:
        restore()
    peak = torch.cuda.max_memory_allocated()
    launches = FK.LAUNCHES["flash_attention"]
    if launches != flash_layers or len(captured) != flash_layers:
        raise AssertionError(f"the prefill launched the flash kernel "
                             f"{launches} times, not {flash_layers}")
    if FK.PATH_LAUNCHES["wgmma"] != launches:
        raise AssertionError(f"the prefill ran the flash bodies "
                             f"{FK.PATH_LAUNCHES}, not all on wgmma")
    err, share, where = check_captured(FK, captured)
    each = [ev[0].elapsed_time(ev[1]) for *_, ev in captured]
    return dict(served=served, cold_s=cold, peak_gib=peak / 2**30,
                launches=launches, launch_ms=each,
                prefill_tps=B * S / served["prefill_s"],
                decode_tps=B * served["steps"] / served["decode_s"],
                max_abs_err=err, share=share, where=where,
                captured=captured)


def flash_alone(FK, q, k, v, kw, Sq):
    """One captured flash launch of the path alone (``q`` padded as the
    model pads it, its first ``Sq`` rows real; ``kw`` the launch's
    keywords): the default body, the plain version and
    ``scaled_dot_product_attention`` on the real rows (timed only) by CUDA
    events in two turns, beside the bound of the real work -> dict."""
    import torch.nn.functional as F
    B, _, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    causal = kw["causal"]
    qt, kt, vt = (t.transpose(1, 2) for t in (q[:, :Sq], k, v))
    runs = {"kernel": (lambda: FK.flash_attention_cuda(q, k, v, **kw), 20),
            "plain": (lambda: FK.flash_attention_plain(q, k, v, **kw), 2),
            "library": (lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True), 20)}
    turns = {name: [] for name in runs}
    for order in (list(runs), list(runs)[::-1]):
        for name in order:
            turns[name].append(cuda_ms(*runs[name]))
    ms = {name: sum(t) / len(t) for name, t in turns.items()}
    bound_ms, bound_by = attention_bound(B, Sq, Sk, H, KV, dh, causal)
    return dict(shape=[B, Sq, Sk, H, KV, dh], causal=causal,
                ms=ms["kernel"], plain_ms=ms["plain"],
                library_ms=ms["library"], bound_ms=bound_ms,
                bound_by=bound_by, turns=turns)


def flash_library_alone(FK, dev, shape, card, tag):
    """A path's flash launch shape ``(B, S, H, KV, dh)`` alone on random
    inputs of scale 0.5 (bf16, causal; its launches on the path are held
    against the plain version there): :func:`flash_alone` -> its dict."""
    import torch
    B, S, H, KV, dh = shape
    gen = torch.Generator(device=dev).manual_seed(S + H + KV)
    rnd = lambda *s: (torch.randn(s, generator=gen, device=dev)
                      * 0.5).to(torch.bfloat16)
    r = flash_alone(FK, rnd(B, S, H, dh), rnd(B, S, KV, dh),
                    rnd(B, S, KV, dh), dict(causal=True), S)
    log(f"[{tag}] flash launch shape alone B {B} S {S} H {H} KV {KV} dh "
        f"{dh} bf16 causal, ms (two turns): " + "; ".join(
            f"{n} {r[k]:.4f} ({', '.join(f'{t:.4f}' for t in r['turns'][n])})"
            for n, k in (("kernel", "ms"), ("plain", "plain_ms"),
                         ("library", "library_ms")))
        + f"; bound {r['bound_ms']:.4f} ms ({r['bound_by']}), the kernel at "
        f"{100 * r['bound_ms'] / r['ms']:.2f}% of it, "
        f"{r['ms'] / r['library_ms']:.2f}x the library call's time; card: "
        f"{card}")
    return r


def log_direct(tag, name, r, card):
    lo, hi = min(r["launch_ms"]), max(r["launch_ms"])
    s = r["served"]
    log(f"[{tag}] {name}: prefill {s['prefill_s']:.3f}s "
        f"({r['prefill_tps']:,.0f} tokens/s; {r['launches']} flash launches "
        f"{sum(r['launch_ms']):.3f} ms of it by CUDA events, {lo:.4f}-"
        f"{hi:.4f} ms each, all on wgmma), decode {s['steps']} steps in "
        f"{s['decode_s']:.3f}s ({r['decode_tps']:,.1f} tokens/s), peak "
        f"memory {r['peak_gib']:.2f} GiB (a first wave of 2 new tokens "
        f"{r['cold_s']:.2f}s); the launches = plain: max |err| "
        f"{r['max_abs_err']:.3g}, worst share {r['share']:.3f} of the "
        f"limits, {r['where']}; card: {card}")


def phase_encdec_serve(FK, dev, card):
    """Phase 19a: whisper-base whole at published widths, seeded fp32
    weights: a wave of ENCDEC_BATCH requests, each 1,500 seeded frame
    embeddings (30 s of audio through the stubbed frontend) and the
    start-of-transcript prompt, ENCDEC_NEW greedy new tokens in the
    decoder's ENCDEC_MAX_SEQ context, through ``prefill`` / ``serve_step``
    (the serve launcher refuses enc-dec, as the JAX package's does).  The
    prefill launches the flash kernel once per encoder layer (non-causal,
    1,500 keys unpadded) and twice per decoder layer (causal; cross over
    the 1,500 frames), all on wgmma, each held against the plain version;
    the first encoder launch rerun with its keys zero-padded to 1,536 (the
    planted fault) must fail the check.  Prefill + decode against one
    forward in bf16 and fp32 within ENCDEC_E2E_TOL, and with each
    request's decode reading the next request's cross caches past it.  The
    encoder's and the cross-attention's launch shapes timed alone."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config

    cfg = get_config(ENCDEC_ARCH)
    params, init_s, gib = seeded_params(cfg, dev, 31)
    gen = torch.Generator(device=dev).manual_seed(32)
    frames = torch.randn((ENCDEC_BATCH, cfg.enc_frames, cfg.d_model),
                         generator=gen, device=dev)
    toks = torch.as_tensor(np.tile(ENCDEC_PROMPT, (ENCDEC_BATCH, 1)),
                           device=dev).long()
    log(f"[encdec] {ENCDEC_ARCH}: {cfg.enc_layers} encoder + {cfg.n_layers} "
        f"decoder layers, {cfg.param_count():,} parameters, {gib:.2f} GiB of "
        f"fp32 weights made on the card in {init_s:.1f}s")
    flash_layers = cfg.enc_layers + 2 * cfg.n_layers
    r = direct_wave(FK, cfg, params, toks, ENCDEC_NEW, ENCDEC_MAX_SEQ,
                    {"frames": frames}, lambda n: {}, flash_layers)
    # the prefill's work is the encoder's: frames, not prompt tokens
    r["prefill_frames_per_s"] = (ENCDEC_BATCH * cfg.enc_frames
                                 / r["served"]["prefill_s"])
    log_direct("encdec", f"{ENCDEC_ARCH} wave of {ENCDEC_BATCH} x "
               f"{cfg.enc_frames} frames, prompt {len(ENCDEC_PROMPT)}, "
               f"{ENCDEC_NEW} new, max_seq {ENCDEC_MAX_SEQ} (the prefill "
               f"{r['prefill_frames_per_s']:,.0f} frames/s)", r, card)
    # launch order: the encoder's layers, then each decoder layer's self-
    # and cross-attention
    captured = r.pop("captured")
    enc, cross = captured[0], captured[cfg.enc_layers + 1]
    for name, (q, k, v, kw, _, _), Sq in (("encoder", enc, cfg.enc_frames),
                                          ("cross", cross, 128)):
        if kw["causal"] or q.shape[1] < Sq or k.shape[1] != cfg.enc_frames:
            raise AssertionError(f"the {name} launch is not non-causal over "
                                 f"the 1,500 frames: q {tuple(q.shape)}, k "
                                 f"{tuple(k.shape)}, {kw}")
    # the planted fault: the encoder launch over keys zero-padded to 1,536
    q, k, v, kw, o, _ = enc
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, 36))
    want = FK.flash_attention_plain(q, k, v, **kw)
    fault = flash_check(FK.flash_attention_cuda(q, pad(k), pad(v), **kw),
                        want)
    if not fault[1] > 1:
        raise AssertionError(f"the check passed keys zero-padded to 1,536: "
                             f"{fault}")
    log(f"[encdec] the encoder launch (q {tuple(q.shape)}, k "
        f"{tuple(k.shape)}) with keys zero-padded to 1,536 (planted fault): "
        f"max |err| {fault[0]:.3g}, {fault[1]:.2f} of the limits (fails, as "
        f"it must)")
    alone = {}
    for name, (q, k, v, kw, _, _), Sq in (
            ("encoder", enc, cfg.enc_frames),
            ("cross", cross, len(ENCDEC_PROMPT))):
        alone[name] = flash_alone(FK, q, k, v, kw, Sq)
        a = alone[name]
        log(f"[encdec] flash at the {name} shape (B, Sq, Sk, H, KV, dh) "
            f"{a['shape']}, q padded to {q.shape[1]}, bf16, non-causal: "
            f"kernel {a['ms']:.4f} ms, plain {a['plain_ms']:.4f}, "
            f"scaled_dot_product_attention {a['library_ms']:.4f} (timed "
            f"only); bound {a['bound_ms']:.4f} ms ({a['bound_by']}), the "
            f"kernel at {100 * a['bound_ms'] / a['ms']:.2f}% of it; card: "
            f"{card}")
    del captured, enc, cross, q, k, v, want
    chks = {}
    for dt in ENCDEC_E2E_TOL:
        c = cfg if dt == "bfloat16" else cfg.replace(
            compute_dtype=dt, cache_dtype=dt)
        rows = LM_E2E_ROWS
        chks[dt] = encdec_e2e(
            c, params, frames[:rows], toks[:rows], ENCDEC_NEW, dev,
            served=({"outs": r["served"]["outs"][:rows],
                     "logits": r["served"]["logits"]}
                    if c is cfg else None))
    check_e2e(ENCDEC_ARCH, chks, ENCDEC_E2E_TOL, card, tag="encdec")
    bad = {dt: encdec_e2e(cfg if dt == "bfloat16" else cfg.replace(
        compute_dtype=dt, cache_dtype=dt), params, frames[:LM_E2E_ROWS],
        toks[:LM_E2E_ROWS], ENCDEC_NEW, dev, fault=True)
        for dt in ENCDEC_E2E_TOL}
    check_e2e(ENCDEC_ARCH, bad, ENCDEC_E2E_TOL, card, tag="encdec",
              fault="decode reading the next request's cross caches")
    out = {k: r[k] for k in ("launches", "max_abs_err", "share",
                             "prefill_tps", "prefill_frames_per_s",
                             "decode_tps", "peak_gib")}
    out.update(params=cfg.param_count(), launch_ms=sum(r["launch_ms"])
               / len(r["launch_ms"]), prefill_s=r["served"]["prefill_s"],
               decode_s=r["served"]["decode_s"], fault_share=fault[1],
               alone=alone,
               e2e={dt: {k: c[k] for k in ("max", "mean", "logit_std")}
                    for dt, c in chks.items()},
               e2e_fault={dt: {k: c[k] for k in ("max", "mean")}
                          for dt, c in bad.items()})
    del params, frames, r
    free_card()
    return out


def phase_vlm_serve(FK, dev, card):
    """Phase 19b: qwen2-vl-7b whole at published widths, seeded fp32
    weights: a wave of LM_BATCH x LM_PROMPT tokens, LM_NEW new, whose first
    VLM_GRID**2 positions are seeded patch embeddings laid out on a
    VLM_GRID x VLM_GRID grid by M-RoPE (:func:`mrope_grid_positions`),
    through ``prefill`` / ``serve_step`` (each step given its token's
    M-RoPE positions).  The prefill launches the flash kernel once per
    layer (G 7, dh 128, causal), all on wgmma, each held against the plain
    version.  Prefill + decode against one forward in bf16 and fp32 within
    VLM_E2E_TOL, and with the decode steps given no M-RoPE positions (the
    planted fault) past them."""
    import torch
    from repro_torch.configs import get_config

    cfg = get_config(VLM_ARCH)
    params, init_s, gib = seeded_params(cfg, dev, 41)
    gen = torch.Generator(device=dev).manual_seed(42)
    toks = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                         generator=gen, device=dev)
    P = VLM_GRID * VLM_GRID
    patches = torch.randn((LM_BATCH, P, cfg.d_model), generator=gen,
                          device=dev)
    mpos = torch.as_tensor(mrope_grid_positions(
        LM_BATCH, LM_PROMPT + LM_NEW, VLM_GRID), device=dev)
    log(f"[vlm] {VLM_ARCH}: {cfg.n_layers} layers, {cfg.param_count():,} "
        f"parameters, {gib:.2f} GiB of fp32 weights made on the card in "
        f"{init_s:.1f}s")
    r = direct_wave(FK, cfg, params, toks, LM_NEW, LM_MAX_SEQ,
                    {"patch_embeds": patches, "mrope_pos": mpos[:, :LM_PROMPT]},
                    lambda n: {"mrope_pos": mpos[:, n:n + 1]}, cfg.n_layers)
    log_direct("vlm", f"{VLM_ARCH} wave of {LM_BATCH} x {LM_PROMPT} tokens "
               f"({P} patch embeddings on a {VLM_GRID} x {VLM_GRID} M-RoPE "
               f"grid), {LM_NEW} new, max_seq {LM_MAX_SEQ}", r, card)
    q = r["captured"][0][0]
    shape = tuple(q.shape) + (r["captured"][0][1].shape[2],)
    del r["captured"], q
    free_card()
    rows = LM_E2E_ROWS
    chks = {}
    for dt in VLM_E2E_TOL:
        c = cfg if dt == "bfloat16" else cfg.replace(
            compute_dtype=dt, cache_dtype=dt)
        chks[dt] = vlm_e2e(c, params, toks[:rows], patches[:rows], LM_NEW,
                           VLM_GRID, dev, served=(
                               {"outs": r["served"]["outs"][:rows],
                                "logits": r["served"]["logits"]}
                               if c is cfg else None))
    check_e2e(VLM_ARCH, chks, VLM_E2E_TOL, card, tag="vlm")
    bad = {dt: vlm_e2e(cfg if dt == "bfloat16" else cfg.replace(
        compute_dtype=dt, cache_dtype=dt), params, toks[:rows],
        patches[:rows], LM_NEW, VLM_GRID, dev, fault=True)
        for dt in VLM_E2E_TOL}
    check_e2e(VLM_ARCH, bad, VLM_E2E_TOL, card, tag="vlm",
              fault="decode without M-RoPE positions")
    B, S, H, dh, KV = shape
    out = {k: r[k] for k in ("launches", "max_abs_err", "share",
                             "prefill_tps", "decode_tps", "peak_gib")}
    out.update(params=cfg.param_count(), launch_ms=sum(r["launch_ms"])
               / len(r["launch_ms"]), bound_ms=attention_bound(
                   B, S, S, H, KV, dh, True)[0],
               prefill_s=r["served"]["prefill_s"],
               decode_s=r["served"]["decode_s"],
               e2e={dt: {k: c[k] for k in ("max", "mean", "logit_std")}
                    for dt, c in chks.items()},
               e2e_fault={dt: {k: c[k] for k in ("max", "mean")}
                          for dt, c in bad.items()})
    del params, r
    free_card()
    out["alone"] = flash_library_alone(FK, dev, (B, S, H, KV, dh), card,
                                       "vlm")
    return out


def moved_with_gradient(state, start, prefixes):
    """How many leaves under ``prefixes`` (key paths) of a train state
    moved from the parameters ``start`` with a nonzero first moment;
    raises on one that did not."""
    import torch
    from repro_torch.tree import key_paths
    start = dict(key_paths(start))
    m1 = dict(key_paths(state["opt"]["m"]))
    moved = 0
    for key, a in key_paths(state["params"]):
        if not key.startswith(prefixes):
            continue
        if torch.equal(a, start[key]) or not bool(m1[key].ne(0).any()):
            raise AssertionError(f"{key} did not move with a gradient")
        moved += 1
    return moved


def phase_encdec_vlm_train(FK, dev, card):
    """Phase 19c: ``launch.train.main`` on whisper-base whole
    (ENCDEC_TRAIN_BATCH x ENCDEC_TRAIN_SEQ tokens on zero frames, as the
    JAX launcher trains it) and on qwen2-vl-7b at VLM_TRAIN_LAYERS of its
    28 layers (text, VLM_TRAIN_BATCH x TRAIN_SEQ), ENCDEC_TRAIN_STEPS and
    VLM_TRAIN_STEPS steps under ``"dots"``: finite losses; the flash
    kernel on wgmma for every attention of each forward (twice a step
    under ``"dots"``), each launch of step 0 held against the plain
    version; every leaf of the layers (whisper: both stacks, the
    cross-attention among them) moved with a gradient.  Step ms, tokens/s,
    peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model_fns

    out = {}
    for arch, batch, steps, layers, seq, prefixes in (
            (ENCDEC_ARCH, ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_STEPS, None,
             ENCDEC_TRAIN_SEQ, ("['layers']", "['enc_layers']")),
            (VLM_ARCH, VLM_TRAIN_BATCH, VLM_TRAIN_STEPS, VLM_TRAIN_LAYERS,
             TRAIN_SEQ, ("['layers']",))):
        cfg = get_config(arch)
        if layers:
            cfg = cfg.replace(n_layers=layers)
        per_forward = cfg.enc_layers + 2 * cfg.n_layers if (
            cfg.family == "encdec") else cfg.n_layers
        per_step = per_forward * (1 if cfg.remat_policy == "everything"
                                  else 2)
        m = train_main_run(FK, arch, batch, steps, layers, capture=per_step,
                           seq=seq)
        state, captured = m.pop("state"), m.pop("captured")
        want = per_step * steps
        if (FK.LAUNCHES["flash_attention"] != want
                or FK.PATH_LAUNCHES["wgmma"] != want):
            raise AssertionError(f"{arch}: {steps} steps launched the flash "
                                 f"bodies {FK.PATH_LAUNCHES}, not wgmma "
                                 f"{want} times")
        moved = moved_with_gradient(
            state, get_model_fns(cfg).init_params(cfg, 0, dev), prefixes)
        err, share, where, _ = hold_launches(FK, captured, dev)
        del state, captured
        free_card()
        m.update(launches=want, max_abs_err=err, share=share,
                 params=cfg.param_count())
        log(f"[{cfg.family}] train {arch}"
            + (f", {layers} of {get_config(arch).n_layers} layers" if layers
               else " whole")
            + f" ({cfg.param_count():,} parameters), {batch} x {seq} "
            f"tokens, {steps} steps in {m['wall_s']:.1f}s: loss "
            f"{m['losses'][0]:.4f} -> {m['losses'][-1]:.4f}; step "
            f"{m['step_ms']:.1f} ms, {m['tokens_per_s']:,.0f} tokens/s, peak "
            f"memory {m['peak_gib']:.2f} GiB; flash launches {want} on wgmma; "
            f"{moved} leaves of the layers moved with a gradient; step 0's "
            f"{per_step} launches = plain: max |err| {err:.3g}, worst share "
            f"{share:.3f} of the elementwise limit, {where}; card: {card}")
        out[cfg.family] = m
    return out


def block_attention_grads(cfg, blk, h, attn):
    """Gradients of one block's loss ``mean(y**2)`` (y the block's output)
    with respect to its q, k, v and to wq, wk, wv, the block's attention
    computed by ``attn(q, k, v)``; a gradient that never arrives is 0."""
    import torch
    from repro_torch.models import layers as L
    B, S, _ = h.shape
    pos = torch.arange(S, device=h.device)[None].expand(B, S)
    p = {k: v.detach().requires_grad_() for k, v in blk["attn"].items()}
    a = L.rmsnorm(blk["ln1"], h, cfg.rms_eps)
    qkv = L._qkv(p, a, cfg, L._rope(cfg, pos))
    for t in qkv:
        t.retain_grad()
    h2 = h + L._out(attn(*qkv), p["wo"], cfg.cdtype())
    m = L.rmsnorm(blk["ln2"], h2, cfg.rms_eps)
    y = h2 + L.mlp_forward(blk["mlp"], m, cfg)
    (y.float() ** 2).mean().backward()
    out = {}
    for name, t in zip(("dq", "dk", "dv", "wq", "wk", "wv"),
                       (*qkv, p["wq"], p["wk"], p["wv"])):
        g = t.grad
        out[name] = (torch.zeros_like(t) if g is None else g).float()
    return out


def grad_shares(got, want) -> dict:
    """Per gradient: the larger of max |got - want| / max |want| and
    ||got - want|| / ||want||, over GRAD_TOL (<= 1 passes)."""
    shares = {}
    for name, w in want.items():
        d = got[name] - w
        shares[name] = max(float(d.abs().max() / w.abs().max()),
                           float(d.norm() / w.norm())) / GRAD_TOL
    return shares


def phase_train_grads(FK, fops, dev, card):
    """Phase 16a: one qwen3-0.6b block at published widths (B 2, S 1,024,
    bf16): q, k, v and wq, wk, wv gradients through layers.FlashAttention
    (the wgmma body on the forward, one launch) against autograd through
    ref_attention_gqa, within GRAD_TOL; the same with the kernel's output
    detached (the planted fault) must fail with zero gradients.  Two
    launches of the kernel on the same inputs must agree bit for bit (the
    restart drill needs a deterministic forward)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ref import ref_attention_gqa
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as TFM

    cfg = get_config(LM_ARCH).replace(n_layers=1)
    gen = torch.Generator(device=dev).manual_seed(16)
    blk = TFM.init_params(cfg, gen, dev)["layers"][0]
    h = torch.randn((GRAD_BATCH, TRAIN_SEQ, cfg.d_model), generator=gen,
                    device=dev).to(cfg.cdtype())
    kernel = lambda q, k, v: L.FlashAttention.apply(q, k, v, cfg, True)
    FK.reset_launches()
    got = block_attention_grads(cfg, blk, h, kernel)
    launches = dict(FK.PATH_LAUNCHES)
    if launches["wgmma"] != 1 or FK.LAUNCHES["flash_attention"] != 1:
        raise AssertionError(f"the block's forward and backward launched "
                             f"the flash bodies {launches}, not wgmma once")
    want = block_attention_grads(
        cfg, blk, h, lambda q, k, v: ref_attention_gqa(q, k, v, causal=True))
    shares = grad_shares(got, want)
    planted = grad_shares(block_attention_grads(
        cfg, blk, h, lambda q, k, v: kernel(q, k, v).detach()), want)
    log(f"[train] one block (B {GRAD_BATCH}, S {TRAIN_SEQ}, bf16) through "
        f"FlashAttention vs plain attention, share of the {GRAD_TOL} "
        f"limit: " + ", ".join(f"{n} {v:.3f}" for n, v in shares.items())
        + "; kernel output detached: " + ", ".join(
            f"{n} {v:.3f}" for n, v in planted.items()))
    if not all(v <= 1 for v in shares.values()):
        raise AssertionError(f"gradients through the kernel != plain: "
                             f"{shares}")
    if not all(v > 1 for v in planted.values()):
        raise AssertionError(f"the check passed a detached kernel output: "
                             f"{planted}")

    qkv = L._qkv(blk["attn"], L.rmsnorm(blk["ln1"], h, cfg.rms_eps), cfg,
                 L._rope(cfg, torch.arange(TRAIN_SEQ, device=dev)[None]
                         .expand(GRAD_BATCH, TRAIN_SEQ)))
    with torch.no_grad():
        a, b = (fops.flash_attention(*qkv, device=dev) for _ in range(2))
    if not torch.equal(a, b):
        raise AssertionError("two flash launches on the same inputs differ")
    log(f"[train] two flash launches on the same q, k, v "
        f"{tuple(qkv[0].shape)}: bit-identical; on {card}")
    return dict(share=max(shares.values()),
                planted_share=min(planted.values()))


TRAIN_LINE = re.compile(r"\[train\] step\s+(\d+) loss (\S+) lr \S+ gnorm "
                        r"\S+ ([\d.]+) ms")


def run_train_main(argv):
    """``launch.train.main(argv)`` -> (exit code, [(step, loss, ms)]); its
    output is echoed after the run."""
    import contextlib
    import io
    from repro_torch.launch import train as T
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = T.main(argv)
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"  {line}")
    return rc, [(int(a), float(b), float(c))
                for a, b, c in TRAIN_LINE.findall(text)]


def train_main_run(FK, arch, batch, steps, layers=None, capture=0,
                   seq=TRAIN_SEQ, keep_on_card=False):
    """``launch.train.main`` on ``arch`` (cut to ``layers`` layers through
    the launcher's ``get_config`` when given), B ``batch`` x S ``seq``,
    ``steps`` steps, with the launch counts set to 0 just before it; the
    first ``capture`` flash launches are copied to the host as ``(q, k, v,
    o, kw)`` (or cloned on the card with ``keep_on_card``: a copy to the
    host inside a timed step would lengthen it; the peak then holds the
    clones).  Raises unless it exits 0 with a finite loss logged at every
    step.  -> dict: losses, step_ms (median after the first step),
    tokens_per_s, wall_s, peak_gib, the final train state, the captured
    launches."""
    import statistics
    import torch
    from repro_torch.launch import train as T

    real_get, real_train = T.get_config, T.train
    launch, captured, kept = FK.flash_attention_cuda, [], {}

    def capturing(q, k, v, **kw):
        o = launch(q, k, v, **kw)
        if len(captured) < capture:
            captured.append((*(t.detach().clone() if keep_on_card
                               else t.cpu() for t in (q, k, v, o)), kw))
        return o

    def keeping(*a, **kw):
        kept["state"], losses = real_train(*a, **kw)
        return kept["state"], losses

    if layers:
        T.get_config = lambda name: real_get(name).replace(n_layers=layers)
    T.train = keeping
    FK.flash_attention_cuda = capturing
    free_card()
    FK.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        rc, rows = run_train_main(
            ["--arch", arch, "--global-batch", str(batch), "--seq",
             str(seq), "--steps", str(steps), "--log-every", "1"])
    finally:
        T.get_config, T.train = real_get, real_train
        FK.flash_attention_cuda = launch
    wall = time.perf_counter() - t0
    if rc != 0 or [r[0] for r in rows] != list(range(steps)):
        raise AssertionError(f"train.main {arch}: rc {rc}, steps "
                             f"{[r[0] for r in rows]}")
    losses = [r[1] for r in rows]
    if not all(x == x and abs(x) < float("inf") for x in losses):
        raise AssertionError(f"{arch}: non-finite loss {losses}")
    step_ms = statistics.median(r[2] for r in rows[1:])
    return dict(losses=losses, step_ms=step_ms, wall_s=wall,
                tokens_per_s=batch * seq / (step_ms / 1e3),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                state=kept.pop("state"), captured=captured)


def train_flops(cfg, tokens: int, seq: int) -> float:
    """Model FLOPs of one training step: 6 x parameters x tokens, plus the
    causal attention's products (4 dh FLOPs per (head, query, key) pair the
    mask keeps, forward and twice in the backward)."""
    pairs = tokens // seq * seq * (seq + 1) // 2
    attn = 3 * 4 * cfg.d_head * cfg.n_heads * pairs * cfg.n_layers
    return 6.0 * cfg.param_count() * tokens + attn


def phase_train(FK, dev, card):
    """Phase 16b, 16e: ``launch.train.main`` on qwen3-0.6b at published
    widths, 8 x 1,024 tokens a step, 12 steps.  The loss must be finite and
    fall from step 0 to the last step; every forward of every layer must
    launch the flash kernel on the wgmma body (twice a step where the remat
    policy recomputes the block).  Each launch of the first step is copied
    to the host as it returns (steps 0-1 are left out of the step time) and
    held afterwards against the plain version on its own inputs by
    :func:`flash_check`; the last, run again with the wgmma body's key tile
    TRAIN_DROP_TILE dropped, must fail that check.  Printed: step time
    (median after the first two), tokens/s, peak memory and the model-FLOP
    share; then the same run with attention on the plain path (no kernel)
    as the yardstick."""
    import statistics
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L

    cfg = get_config(LM_ARCH)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    forwards = 1 if cfg.remat_policy == "everything" else 2
    argv = ["--arch", LM_ARCH, "--global-batch", str(TRAIN_BATCH), "--seq",
            str(TRAIN_SEQ), "--steps", str(TRAIN_STEPS), "--log-every", "1"]
    flops = train_flops(cfg, tokens, TRAIN_SEQ)

    def summary(rows):
        ms = statistics.median(r[2] for r in rows[TRAIN_TIMED_FROM:])
        return dict(step_ms=ms, tokens_per_s=tokens / (ms / 1e3),
                    mfu=flops / (ms / 1e3) / BF16_FLOPS_PER_S,
                    losses=[r[1] for r in rows])

    launch, captured = FK.flash_attention_cuda, []
    per_step = cfg.n_layers * forwards

    def capturing(q, k, v, **kw):
        o = launch(q, k, v, **kw)
        if len(captured) < per_step:
            captured.append((*(t.cpu() for t in (q, k, v, o)), kw))
        return o

    FK.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    FK.flash_attention_cuda = capturing
    t0 = time.perf_counter()
    try:
        rc, rows = run_train_main(argv)
    finally:
        FK.flash_attention_cuda = launch
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dict(FK.PATH_LAUNCHES)
    want = per_step * TRAIN_STEPS
    if rc != 0 or [r[0] for r in rows] != list(range(TRAIN_STEPS)):
        raise AssertionError(f"train.main: rc {rc}, steps logged "
                             f"{[r[0] for r in rows]}")
    if launches["wgmma"] != want or FK.LAUNCHES["flash_attention"] != want:
        raise AssertionError(
            f"{TRAIN_STEPS} steps launched the flash bodies {launches}, not "
            f"wgmma {want} times ({cfg.n_layers} layers x {forwards} "
            f"forwards a step)")
    run = summary(rows)
    losses = run["losses"]
    if not all(map(lambda x: x == x and abs(x) < float("inf"), losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    remat = {1: "no block recompute", 2: "the block recomputed in the "
             "backward"}[forwards]
    log(f"[train] {LM_ARCH} (remat_policy {cfg.remat_policy!r}: {remat}), "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens, {TRAIN_STEPS} steps in "
        f"{wall:.1f}s: loss {losses[0]:.4f} -> {losses[-1]:.4f}; flash "
        f"launches {launches['wgmma']} on wgmma ({cfg.n_layers} x "
        f"{forwards} a step); step {run['step_ms']:.1f} ms (median of steps "
        f"{TRAIN_TIMED_FROM}-{TRAIN_STEPS - 1}), {run['tokens_per_s']:,.0f} "
        f"tokens/s, model-FLOP share {100 * run['mfu']:.1f}% "
        f"({flops / 1e12:.2f} TFLOP a step over {BF16_FLOPS_PER_S / 1e12:.0f}"
        f" TFLOP/s), peak memory {peak / 2**30:.2f} GiB; card: {card}")

    # the first step's flash launches against the plain version
    if len(captured) != per_step:
        raise AssertionError(f"captured {len(captured)} launches of step 0, "
                             f"not {per_step}")
    err, share, where, (q, k, v, kw, want_o) = hold_launches(FK, captured,
                                                             dev)
    shape = tuple(q.shape)
    fault = flash_check(FK.flash_attention_cuda(
        q, k, v, **kw, drop_key_tile=TRAIN_DROP_TILE), want_o, absolute=False)
    del captured, q, k, v, want_o
    log(f"[train] the {per_step} flash launches of step 0 (q {shape}, "
        f"bf16, causal, on the wgmma body) = plain: max |err| {err:.3g} "
        f"(held to the elementwise limit alone), worst share "
        f"{share:.3f} of the limit, {where}; the last launch with key tile "
        f"{TRAIN_DROP_TILE} dropped: {fault[1]:.2f} of the limit (max |err| "
        f"{fault[0]:.3g})")
    if not fault[1] > 1:
        raise AssertionError(f"the flash check passed a dropped key tile at "
                             f"the training shape: {fault}")

    # the yardstick: the same steps with attention on the plain path
    FK.reset_launches()
    L.FlashAttention.apply = staticmethod(
        lambda q, k, v, c, causal: L.sdpa_chunked(q, k, v, c, causal=causal))
    try:
        rc, rows = run_train_main(argv)
    finally:
        del L.FlashAttention.apply
    if rc != 0 or FK.LAUNCHES["flash_attention"] != 0:
        raise AssertionError(f"the plain-attention run: rc {rc}, flash "
                             f"launches {FK.LAUNCHES}")
    plain = summary(rows)
    dloss = [abs(a - b) for a, b in zip(losses, plain["losses"])]
    log(f"[train] yardstick, attention on the plain path (_sdpa, autograd "
        f"end to end): step {plain['step_ms']:.1f} ms, "
        f"{plain['tokens_per_s']:,.0f} tokens/s, model-FLOP share "
        f"{100 * plain['mfu']:.1f}%; kernel run / plain "
        f"{run['tokens_per_s'] / plain['tokens_per_s']:.3f}x; |loss "
        f"difference| per step " + ", ".join(f"{d:.4f}" for d in dloss)
        + f"; card: {card}")
    if not dloss[0] <= TRAIN_LOSS0_TOL:
        raise AssertionError(f"step 0 loss, kernel {losses[0]} against "
                             f"plain {plain['losses'][0]}")
    return dict(launches=launches["wgmma"], forwards_per_step=forwards,
                peak_gib=peak / 2**30, flops_per_step=flops, **{
                    k: run[k] for k in ("step_ms", "tokens_per_s", "mfu")},
                losses=losses, max_abs_err=err, share=share,
                dropped_tile_share=fault[1],
                plain={k: plain[k] for k in ("step_ms", "tokens_per_s",
                                             "mfu")}, loss_diff=dloss)


def phase_train_device(FK, fops, dev, card):
    """Phase 16d, where a step's time goes: at the training shape (B 8,
    S 1,024, 16 query heads over 8 KV heads, dh 128, bf16) the flash
    forward launch, the plain forward and the FlashAttention backward (the
    _sdpa recompute and its gradient) each timed alone by CUDA events,
    beside one PyTorch call for forward + backward
    (``scaled_dot_product_attention``, timed only), and the flash forward
    beside that call's forward in two turns (:func:`flash_library_alone`);
    two train steps under
    ``torch.profiler``: the kernels' device time against the steps' wall
    clock (the device's busy share), the device time by kind of kernel, the
    host's Python dispatch calls, and a step's device time split into the
    ranges the profiler opens for ``FlashAttention`` (its forward: padding
    and the kernel, the backward's block recompute included), for
    autograd's ``FlashAttentionBackward`` (the plain recompute and its
    gradient) and the rest."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStreamSpec, batch_for_step
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as TFM
    from repro_torch.optim.adamw import AdamWConfig

    cfg = get_config(LM_ARCH)
    B, S, H, KV, dh = (TRAIN_BATCH, TRAIN_SEQ, cfg.n_heads, cfg.n_kv_heads,
                       cfg.d_head)
    gen = torch.Generator(device=dev).manual_seed(17)
    rand = lambda *s: (torch.randn(s, generator=gen, device=dev) * 0.5) \
        .to(cfg.cdtype())
    q, k, v, do = rand(B, S, H, dh), rand(B, S, KV, dh), rand(B, S, KV, dh), \
        rand(B, S, H, dh)
    leaf = [t.detach().requires_grad_() for t in (q, k, v)]

    def backward():
        with torch.enable_grad():
            o = L.sdpa_chunked(*leaf, cfg)
            torch.autograd.grad(o, leaf, do)

    def library():
        t = [x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v)]
        with torch.enable_grad():
            o = F.scaled_dot_product_attention(*t, is_causal=True,
                                               enable_gqa=True)
            torch.autograd.grad(o, t, do.transpose(1, 2))

    with torch.no_grad():
        alone = dict(
            flash_forward_ms=cuda_ms(
                lambda: fops.flash_attention(q, k, v, device=dev), 20),
            plain_forward_ms=cuda_ms(lambda: L.sdpa_chunked(q, k, v, cfg),
                                     10))
    alone["backward_ms"] = cuda_ms(backward, 10)
    alone["library_fwd_bwd_ms"] = cuda_ms(library, 10)
    del q, k, v, do, leaf
    fwd = flash_library_alone(FK, dev, (B, S, H, KV, dh), card, "train")
    alone.update(kernel_forward_ms=fwd["ms"],
                 library_forward_ms=fwd["library_ms"],
                 forward_bound_ms=fwd["bound_ms"])

    spec = TokenStreamSpec(vocab_size=cfg.vocab_size, seq_len=S,
                           global_batch=B, seed=0)
    state, _ = TFM.init_train_state(cfg, 0, dev)
    step = TFM.make_train_step(cfg, AdamWConfig(total_steps=4,
                                                warmup_steps=1), 1)
    for i in range(2):
        state, m = step(state, batch_for_step(spec, i))
        float(m["loss"])
    batches = [batch_for_step(spec, i) for i in (2, 3)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            state, m = step(state, b)
            float(m["loss"])
        wall = (time.perf_counter() - t0) / 2 * 1e3
    del state
    kinds, host, ranges = {}, {}, {}
    for e in prof.key_averages():
        if e.key in ("PythonDispatchMode", "cudaLaunchKernel"):
            host[e.key] = dict(calls=e.count // 2,
                               cpu_ms=e.cpu_time_total / 2e3)
        if e.key in ("FlashAttention", "autograd::engine::evaluate_function: "
                     "FlashAttentionBackward"):
            ranges[e.key.split(" ")[-1]] = dict(
                calls=e.count // 2, device_ms=e.device_time_total / 2e3)
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.key.lower()
        kind = ("flash" if "flash" in name else
                "matmul" if any(w in name for w in ("gemm", "nvjet", "cutlass",
                                                    "sm90_xmma")) else
                "softmax" if "softmax" in name else
                "reduce" if "reduce" in name else
                "copy" if "copy" in name else "elementwise" if any(
                    w in name for w in ("elementwise", "functor")) else
                "other")
        kinds[kind] = kinds.get(kind, 0.0) + e.self_device_time_total / 2e3
    busy = sum(kinds.values())
    if kinds.get("flash", 0) <= 0:
        raise AssertionError(f"no flash kernel in the profiled steps: {kinds}")
    fwd, bwd = (ranges.get(n, dict(calls=0, device_ms=0.0))
                for n in ("FlashAttention", "FlashAttentionBackward"))
    if not (fwd["device_ms"] > 0 and bwd["device_ms"] > 0):
        raise AssertionError(f"the profiler gave FlashAttention's ranges no "
                             f"device time: {ranges}")
    split = dict(step_wall_ms=wall, device_busy_ms=busy,
                 flash_forward_ms=fwd["device_ms"],
                 flash_kernel_ms=kinds["flash"], forwards=fwd["calls"],
                 attention_backward_ms=bwd["device_ms"],
                 backwards=bwd["calls"],
                 rest_ms=busy - fwd["device_ms"] - bwd["device_ms"],
                 idle_ms=wall - busy)
    alone["bound_ms"], alone["bound_by"] = attention_bound(B, S, S, H, KV,
                                                           dh, True)
    log(f"[train] alone at B {B}, S {S}, H {H}, KV {KV}, dh {dh}, bf16 (CUDA "
        f"events): flash forward {alone['flash_forward_ms']:.4f} ms (bound "
        f"{alone['bound_ms']:.4f} ms, {alone['bound_by']}), plain "
        f"forward {alone['plain_forward_ms']:.4f} ms, attention backward "
        f"(plain recompute + gradient) {alone['backward_ms']:.4f} ms, "
        f"scaled_dot_product_attention forward + backward (timed only) "
        f"{alone['library_fwd_bwd_ms']:.4f} ms; card: {card}")
    log(f"[train] two profiled steps: wall {wall:.1f} ms a step, kernels "
        f"{busy:.1f} ms of it ({100 * busy / wall:.1f}% busy, "
        f"{100 - 100 * busy / wall:.1f}% idle); by kind: " + ", ".join(
            f"{k} {v:.1f}" for k, v in sorted(kinds.items(),
                                              key=lambda kv: -kv[1]))
        + " ms; on the host a step: " + ", ".join(
            f"{k} {v['calls']:,} calls, {v['cpu_ms']:.1f} ms"
            for k, v in host.items()) + f"; card: {card}")
    log(f"[train] a step's device time by profiler range: {busy:.2f} ms = "
        f"FlashAttention forward {split['flash_forward_ms']:.2f} ms "
        f"({split['forwards']} calls; the flash kernel "
        f"{split['flash_kernel_ms']:.2f} ms of it) + FlashAttentionBackward "
        f"{split['attention_backward_ms']:.2f} ms ({split['backwards']} "
        f"calls, the plain recompute and its gradient) + the rest "
        f"{split['rest_ms']:.2f} ms; idle {split['idle_ms']:.2f} ms of the "
        f"{wall:.2f} ms wall; card: {card}")
    return dict(alone=alone, kinds=kinds, host=host, split=split,
                busy_share=busy / wall)


def phase_train_drill(card):
    """Phase 16c: the restart drill on the card.  A straight run of 8 steps
    against one that checkpoints every 4 steps and fails at step 5, then
    resumes from step 3: final parameters, both moments and the step bit
    for bit.  At full width one checkpoint is 12 B a parameter (fp32
    parameters and two moments); the resumed run's final save rewrites
    step 7 beside step 3, so the temporary disk must hold three.  Where it
    holds less, the drill runs at DRILL_SMALL_LAYERS layers of the same
    widths and says so."""
    import shutil
    import tempfile
    import torch
    from repro_torch import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.distributed.fault import FailureInjector
    from repro_torch.launch import train as T
    from repro_torch.tree import key_paths

    cfg = get_config(LM_ARCH)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        free = shutil.disk_usage(tmp).free
        need = 3 * 12 * cfg.param_count()
        why = (f"full depth: {free / 2**30:.1f} GiB free on the temporary "
               f"disk, 3 checkpoints need {need / 2**30:.1f} GiB")
        if free < need:
            cfg = cfg.replace(n_layers=DRILL_SMALL_LAYERS)
            why = (f"{DRILL_SMALL_LAYERS} layers of the same widths: only "
                   f"{free / 2**30:.1f} GiB free on the temporary disk, 3 "
                   f"full-depth checkpoints need {need / 2**30:.1f} GiB")
        kw = dict(steps=DRILL_STEPS, global_batch=TRAIN_BATCH,
                  seq_len=TRAIN_SEQ, log_every=100)
        times = {}
        t0 = time.perf_counter()
        ref, _ = T.train(cfg, **kw)
        times["straight"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        try:
            T.train(cfg, ckpt_dir=tmp, ckpt_every=DRILL_EVERY,
                    fail_at_step=DRILL_FAIL, **kw)
            raise AssertionError("no simulated failure")
        except FailureInjector.SimulatedFailure:
            pass
        times["failed"] = time.perf_counter() - t0
        if ckpt.latest_step(tmp) != DRILL_EVERY - 1:
            raise AssertionError(f"checkpoints after the failure: "
                                 f"{ckpt.all_steps(tmp)}")
        size = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, fs in os.walk(tmp) for f in fs)
        t0 = time.perf_counter()
        res, _ = T.train(cfg, ckpt_dir=tmp, ckpt_every=DRILL_EVERY,
                         resume=True, **kw)
        times["resumed"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        diff = [k for (k, a), (_, b) in zip(key_paths(ref), key_paths(res))
                if not torch.equal(a, b)]
        n = len(key_paths(ref))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[train] restart drill, {cfg.n_layers} layers ({why}): "
        f"{DRILL_STEPS} steps straight {times['straight']:.1f}s; "
        f"checkpoint every {DRILL_EVERY}, failure at {DRILL_FAIL} "
        f"{times['failed']:.1f}s (one checkpoint, {size / 2**30:.2f} GiB); "
        f"resumed from step {DRILL_EVERY - 1} {times['resumed']:.1f}s; "
        f"{n - len(diff)} of {n} leaves (parameters, moments, step) "
        f"bit-identical; card: {card}")
    if diff:
        raise AssertionError(f"the resumed run differs in {len(diff)} "
                             f"leaves, first {diff[:4]}")
    return dict(n_layers=cfg.n_layers, why=why, ckpt_gib=size / 2**30,
                leaves=n, seconds=times)


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


def moe_calls(MOE, fn):
    """Run ``fn()`` with every ``MOE.moe_forward`` call recorded -> (its
    result, [(params, x, y, stats)] per call)."""
    real, calls = MOE.moe_forward, []

    def recording(p, x, cfg, _=None):
        stats = {}
        y, aux = real(p, x, cfg, stats)
        calls.append((p, x, y, stats))
        return y, aux

    MOE.moe_forward = recording
    try:
        return fn(), calls
    finally:
        MOE.moe_forward = real


def phase_ep_prefill(FK, dev, card):
    """Phase 20a: phi3.5-moe's prefill through ``get_model_fns(cfg).
    prefill`` with ``moe_ep`` under ``use_mesh`` of a 1 x 4 mesh of the
    card, EP_LAYERS layers at published widths, fp32, LM_BATCH x LM_PROMPT
    tokens.  With the launch counts at 0 just before it: the flash kernel
    once a layer (G 4, the fp32-pipe body), each launch held against the
    plain version, and every MoE call on the expert-parallel path, each
    shard's recorded all-to-alls the whole [MP, E_loc, C, D] buffer there
    and back (2 x E x C x D x 4 B).  At the no-drop capacity each layer's
    output against the capacity path on its own input (EP_LAYER_TOL) and
    the logits against the capacity path's prefill (EP_LOGITS_TOL); at the
    published factor each path's dropped slots; one layer of each path
    timed by CUDA events."""
    import statistics
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as MOE
    from repro_torch.models.registry import get_model_fns

    published = get_config(MOE_ARCH).replace(n_layers=EP_LAYERS,
                                              compute_dtype="float32")
    no_drop = published.replace(
        capacity_factor=published.n_experts / published.top_k)
    params, init_s, gib = seeded_params(published, dev, 20)
    fns = get_model_fns(published)
    tokens = torch.as_tensor(np.random.default_rng(21).integers(
        0, published.vocab_size, size=(LM_BATCH, LM_PROMPT)),
        dtype=torch.int32, device=dev)
    mesh = make_mesh(EP_MESH, ("data", "model"),
                     devices=[dev] * int(np.prod(EP_MESH)))
    MP, E, D = EP_MESH[1], published.n_experts, published.d_model

    def prefill(cfg, ep):
        def run():
            with torch.inference_mode(), use_mesh(mesh if ep else None):
                return fns.prefill(params, cfg.replace(moe_ep=ep),
                                   tokens)[0]
        return moe_calls(MOE, run)

    # the main path: the counts at 0 just before, read just after
    captured, restore = capture_flash(FK)
    FK.reset_launches()
    try:
        logits_ep, calls = prefill(no_drop, True)
        torch.cuda.synchronize()
    finally:
        restore()
    launches = FK.LAUNCHES["flash_attention"]
    body = FK.select_body(torch.float32, published.d_head, True)
    if launches != EP_LAYERS or FK.PATH_LAUNCHES[body] != launches:
        raise AssertionError(f"the EP prefill launched the flash kernel "
                             f"{launches} times ({FK.PATH_LAUNCHES}), not "
                             f"{EP_LAYERS} on {body}")
    err, share, where = check_captured(FK, captured)
    if len(calls) != EP_LAYERS or any("collectives" not in st
                                      for *_, st in calls):
        raise AssertionError(f"{len(calls)} MoE calls, not {EP_LAYERS} on "
                             f"the expert-parallel path")
    a2a = set()
    for _, _, _, st in calls:
        C = st["capacity"][0]
        for m in range(MP):
            got = sum(r["bytes"] for r in st["collectives"]
                      if r["shard"] == m and r["kind"] == "all_to_all")
            if got != 2 * E * C * D * 4:
                raise AssertionError(f"shard {m} recorded {got:,} B of "
                                     f"all-to-all, not 2 x {E} x {C} x {D} "
                                     f"x 4 = {2 * E * C * D * 4:,}")
            a2a.add(got)
    layer_err = 0.0
    with torch.inference_mode():
        for p, x, y, _ in calls:
            want, _ = MOE._moe_forward_pjit(p, x, no_drop)
            layer_err = max(layer_err, float((y - want).abs().max()))
    if not layer_err <= EP_LAYER_TOL:
        raise AssertionError(f"an EP layer differs from the capacity path "
                             f"by {layer_err:.3g} > {EP_LAYER_TOL}")
    logits_cap, _ = prefill(no_drop, False)
    diff = (logits_ep - logits_cap).abs()
    lmax, lmean = float(diff.max()), float(diff.mean())
    if not (lmax <= EP_LOGITS_TOL["max"] and lmean <= EP_LOGITS_TOL["mean"]
            and bool(torch.isfinite(logits_ep).all())):
        raise AssertionError(f"EP logits != the capacity path's: max "
                             f"{lmax:.3g}, mean {lmean:.3g}")
    # the published factor: capacity per shard (EP) or over all tokens
    _, ep_pub = prefill(published, True)
    _, cap_pub = prefill(published, False)
    drops = {name: [int(st["dropped"][0]) for *_, st in c]
             for name, c in (("ep", ep_pub), ("capacity", cap_pub))}
    caps = {name: c[0][3]["capacity"][0] for name, c in
            (("ep", ep_pub), ("capacity", cap_pub))}

    # one MoE layer of each path at the prefill shape, CUDA events
    p, x = calls[-1][0], calls[-1][1]

    def layer_ms(ep):
        cfg = published.replace(moe_ep=ep)
        out = []
        with torch.inference_mode(), use_mesh(mesh if ep else None):
            MOE.moe_forward(p, x, cfg)
            for _ in range(EP_TIMED):
                a, b = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
                a.record()
                MOE.moe_forward(p, x, cfg)
                b.record()
                torch.cuda.synchronize()
                out.append(a.elapsed_time(b))
        return statistics.median(out)

    ep_ms, cap_ms = layer_ms(True), layer_ms(False)
    log(f"[ep] {MOE_ARCH}: {EP_LAYERS} of {get_config(MOE_ARCH).n_layers} "
        f"layers, fp32, {gib:.2f} GiB of weights made in {init_s:.1f}s; "
        f"prefill of {LM_BATCH} x {LM_PROMPT} tokens with moe_ep over a "
        f"{EP_MESH[0]} x {EP_MESH[1]} (data, model) mesh of the card: "
        f"{launches} flash launches on the {body} body = plain: max |err| "
        f"{err:.3g} (tol {FLASH_TOL['float32']}), worst share {share:.3f}"
        f"{'; ' + where if where else ''}")
    log(f"[ep] no-drop capacity (factor {no_drop.capacity_factor}): each "
        f"EP layer within {layer_err:.3g} of the capacity path on its input "
        f"(tol {EP_LAYER_TOL}); logits max |d| {lmax:.3g} mean {lmean:.3g} "
        f"(tol {EP_LOGITS_TOL['max']} / {EP_LOGITS_TOL['mean']}); each "
        f"shard's all-to-all bytes {sorted(a2a)} = 2 x E x C x D x 4")
    log(f"[ep] published factor {published.capacity_factor}: dropped slots "
        f"per layer, EP (capacity {caps['ep']} a shard's expert) "
        f"{drops['ep']}, capacity path (capacity {caps['capacity']}) "
        f"{drops['capacity']}")
    log(f"[ep] one MoE layer at {LM_BATCH} x {LM_PROMPT} tokens, median of "
        f"{EP_TIMED} by CUDA events: expert-parallel {ep_ms:.3f} ms (4 "
        f"shards in turn on one card), capacity path {cap_ms:.3f} ms, on "
        f"{card}")
    del params, calls, ep_pub, cap_pub
    free_card()
    return dict(launches=launches, max_abs_err=err, share=share,
                layer_err=layer_err, logits_max=lmax, logits_mean=lmean,
                a2a_bytes=sorted(a2a), drops=drops, capacity=caps,
                ep_layer_ms=ep_ms, capacity_layer_ms=cap_ms)


def phase_roofline_check(dev, card, trained):
    """Phase 20b: the dry-run's trace of phase 16's training cell
    (qwen3-0.6b, B TRAIN_BATCH x S TRAIN_SEQ, "dots") on a 1 x 1 fake mesh
    against the card.  Its meta state must equal the real state on the
    card leaf by leaf and its argument bytes the real bytes; its roofline
    bound must not exceed phase 16's median step (a share above 1 would
    mean the count is wrong).  Prints the dominant term, the model-FLOP
    share and the predicted peak beside torch.cuda.max_memory_allocated
    of phase 16's run."""
    import torch
    from repro_torch.analysis import roofline as R
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.lowering import build_lm_cell
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.common import ShapeSpec, model_flops
    from repro_torch.models.registry import (abstract_train_state,
                                             get_model_fns)
    from repro_torch.tree import key_paths

    cfg = get_config(LM_ARCH)
    shape = ShapeSpec(f"train_b{TRAIN_BATCH}_s{TRAIN_SEQ}", TRAIN_SEQ,
                      TRAIN_BATCH, "train")
    mesh = Mesh((torch.device("meta"),), ("data", "model"), (1, 1))
    free_card()
    real, _ = get_model_fns(cfg).init_train_state(cfg, 0, dev)
    meta, _ = abstract_train_state(cfg)
    want = [(k, tuple(t.shape), t.dtype) for k, t in key_paths(real)]
    got = [(k, tuple(t.shape), t.dtype) for k, t in key_paths(meta)]
    if got != want:
        diff = [(a, b) for a, b in zip(got, want) if a != b][:3]
        raise AssertionError(f"meta state != the card's: {diff}")
    real_bytes = sum(t.numel() * t.element_size()
                     for _, t in key_paths(real))
    del real
    free_card()
    cell = build_lm_cell(cfg, shape, mesh)
    batch_bytes = 2 * TRAIN_BATCH * TRAIN_SEQ * 4      # tokens, targets
    arg = DR.analytic_device_bytes(cell)
    if arg != real_bytes + batch_bytes:
        raise AssertionError(f"argument bytes {arg:,} != the card's state "
                             f"{real_bytes:,} + batch {batch_bytes:,}")
    t0 = time.perf_counter()
    rec = DR.measure(cell, mesh)
    traced_s = time.perf_counter() - t0
    rec.update(status="ok", arch=LM_ARCH, shape=shape.name, n_devices=1,
               model_flops=model_flops(cfg, shape))
    t = R.terms(rec)
    step_s = trained["step_ms"] / 1e3
    if not t["bound_s"] <= step_s:
        raise AssertionError(f"the roofline bound {t['bound_s']:.4f} s "
                             f"exceeds the measured step {step_s:.4f} s")
    share = rec["model_flops"] / (R.PEAK_FLOPS * step_s)
    peak = rec["peak_bytes_per_device"]
    log(f"[roofline] {LM_ARCH} train B {TRAIN_BATCH} x S {TRAIN_SEQ} traced "
        f"on a 1 x 1 fake mesh in {traced_s:.1f}s (meta state = the card's "
        f"leaf by leaf; argument bytes {arg:,} = the card's): compute "
        f"{R.fmt_seconds(t['compute_s'])}, memory {R.fmt_seconds(t['memory_s'])}"
        f" (flash-corrected {R.fmt_seconds(t['memory_flash_s'])}), "
        f"collective {R.fmt_seconds(t['collective_s'])}: {t['dominant']}-"
        f"bound at {t['bound_s'] * 1e3:.1f} ms against phase 16's median "
        f"step {trained['step_ms']:.1f} ms ({t['bound_s'] / step_s:.3f} of "
        f"it); model-FLOP share {100 * share:.2f}% (6ND "
        f"{rec['model_flops']:.3e} over {R.PEAK_FLOPS / 1e12:.0f} TFLOP/s; "
        f"phase 16's with "
        f"attention {100 * trained['mfu']:.2f}%); predicted peak "
        f"{peak / 2**30:.2f} GiB against torch.cuda.max_memory_allocated "
        f"{trained['peak_gib']:.2f} GiB; {card}")
    return dict(flops=rec["flops_per_device"], bytes=rec["bytes_per_device"],
                arg_bytes=arg, dominant=t["dominant"], bound_ms=t["bound_s"]
                * 1e3, step_ms=trained["step_ms"], bound_share=t["bound_s"]
                / step_s, model_flop_share=share, peak_gib=peak / 2**30,
                measured_peak_gib=trained["peak_gib"], trace_s=traced_s)


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
    if len(fentries) != 11:
        raise AssertionError(f"ptxas reported {len(fentries)} flash kernels, "
                             f"not 11 (fp32 pipes: 2 types x 3 head dims; "
                             f"mma.sync: 2 head dims; wgmma: 3)")
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

    # 16. training at full width: gradients through the kernel, the
    # launcher, the restart drill
    t0 = time.perf_counter()
    train_grads = phase_train_grads(FK, fops, dev, card)
    trained = phase_train(FK, dev, card)
    device_side = phase_train_device(FK, fops, dev, card)
    drill = phase_train_drill(card)
    log(f"[train] phase in {time.perf_counter() - t0:.1f}s on {card}")
    log("[slice11] " + json.dumps({"grads": train_grads, "train": trained,
                                   "device": device_side, "drill": drill}))

    # 17. the MoE family at published widths: phi3.5-moe (GQA, the flash
    # kernel on its prefill) and deepseek-v2-lite (MLA) served, phi trained
    t0 = time.perf_counter()
    moe_served = phase_moe_serve(
        FK, dev, card, MOE_ARCH, MOE_SERVE_LAYERS,
        "the card holds 12 of 32 layers with fp32 weights")
    mla_served = phase_moe_serve(FK, dev, card, MLA_ARCH, 27, "full depth")
    moe_trained = phase_moe_train(FK, dev, card)
    log(f"[moe] phase in {time.perf_counter() - t0:.1f}s on {card}")
    log("[slice12] " + json.dumps({"phi": moe_served, "deepseek": mla_served,
                                   "train": moe_trained}))

    # 18. the SSM and hybrid families at published widths: mamba2 (no
    # attention) and zamba2 (the flash kernel on its shared block) served
    # whole, mamba2 trained whole and zamba2 at 12 of 81 layers
    t0 = time.perf_counter()
    ssm_served = phase_ssm_serve(FK, fops, dev, card, SSM_ARCH)
    hybrid_served = phase_ssm_serve(FK, fops, dev, card, HYBRID_ARCH)
    ssm_trained = phase_ssm_train(FK, dev, card)
    hybrid_trained = ssm_trained["zamba2"]
    log(f"[ssm] phase in {time.perf_counter() - t0:.1f}s on {card}")
    log("[slice13] " + json.dumps({"mamba2": ssm_served,
                                   "zamba2": hybrid_served,
                                   "train": ssm_trained}))

    # 19. the enc-dec and VLM families at published widths: whisper-base
    # (the flash kernel on its encoder, decoder and cross-attention) and
    # qwen2-vl-7b (M-RoPE) served whole, whisper trained whole and qwen2-vl
    # at 4 of 28 layers
    t0 = time.perf_counter()
    encdec_served = phase_encdec_serve(FK, dev, card)
    vlm_served = phase_vlm_serve(FK, dev, card)
    ev_trained = phase_encdec_vlm_train(FK, dev, card)
    log(f"[encdec] phase 19 in {time.perf_counter() - t0:.1f}s on {card}")
    log("[slice14] " + json.dumps({"whisper": encdec_served,
                                   "qwen2vl": vlm_served,
                                   "train": ev_trained}))

    # 20. the last slice: expert parallelism on the card (phi3.5-moe's
    # prefill with moe_ep over a 1 x 4 mesh of it) and the dry-run's
    # roofline against phase 16's measured step
    t0 = time.perf_counter()
    ep = phase_ep_prefill(FK, dev, card)
    roof = phase_roofline_check(dev, card, trained)
    log(f"[slice15] phase 20 in {time.perf_counter() - t0:.1f}s on {card}")
    log("[slice15] " + json.dumps({"ep": ep, "roofline": roof}))

    log(f"[time] all phases in {time.perf_counter() - t_start:.1f}s")

    # 21. report
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
        # the main paths: the serve launcher's two prefills, the 2,048-token
        # wave's prefill, the train launcher's forwards (12 steps), phi's
        # served prefill and its 3 training steps, zamba2's launcher
        # prefills, served prefill and 3 training steps, whisper's and
        # qwen2-vl's served prefills and their 3 training steps
        "launches": (serve_launches + served["launches"] + trained["launches"]
                     + moe_served["naive"]["launches"]
                     + moe_trained["launches"]
                     + hybrid_served["main_launches"]
                     + hybrid_served["launches"]
                     + hybrid_trained["launches"]
                     + encdec_served["launches"] + vlm_served["launches"]
                     + ev_trained["encdec"]["launches"]
                     + ev_trained["vlm"]["launches"] + ep["launches"]),
        "max_abs_err": max(max(flash_worst.values()), flash["max_abs_err"],
                           served["max_abs_err"], trained["max_abs_err"],
                           moe_served["naive"]["max_abs_err"],
                           moe_trained["max_abs_err"],
                           hybrid_served["main_max_abs_err"],
                           hybrid_served["max_abs_err"],
                           hybrid_served["flash"]["max_abs_err"],
                           hybrid_trained["max_abs_err"],
                           encdec_served["max_abs_err"],
                           vlm_served["max_abs_err"],
                           ev_trained["encdec"]["max_abs_err"],
                           ev_trained["vlm"]["max_abs_err"],
                           ep["max_abs_err"]),
        # the largest share of a limit (max |err| against 3e-5 / 2e-2; in
        # bf16 also each |err| against 2 ulps of |want| plus a row floor)
        # over the grid, the served shape, the prefill launches and the
        # first training step's launches; <= 1 passes
        "worst_share_of_limit": max(flash_share["wgmma"],
                                    flash["share"], served["share"],
                                    trained["share"],
                                    moe_served["naive"]["share"],
                                    moe_trained["share"],
                                    hybrid_served["main_share"],
                                    hybrid_served["share"],
                                    hybrid_served["flash"]["share"],
                                    hybrid_trained["share"],
                                    encdec_served["share"],
                                    vlm_served["share"],
                                    ev_trained["encdec"]["share"],
                                    ev_trained["vlm"]["share"],
                                    ep["share"]),
        "ms": flash["ms"], "plain_ms": flash["plain_ms"],
        # the other bodies on the same inputs: mma.sync (the yardstick of
        # the wgmma design) and the fp32 pipes (fp32, other head dims)
        "mma_sync_ms": flash["mma_sync_ms"], "fp32_pipe_ms": flash["fma_ms"],
        # ptxas at entry (setmaxnreg then gives the consumers 240)
        "registers": wgmma_regs,
        "bound_ms": flash["bound_ms"], "bound_by": flash["bound_by"],
        "library_ms": flash["library_ms"],
        # training (B 8, S 1,024): launches of the train launcher's run;
        # the kernel, the plain forward and the attention backward (plain
        # recompute) each alone, and scaled_dot_product_attention forward
        # + backward (timed only); the first step's launches against the
        # plain version (max |err|, the worst share of the limits, and the
        # share with a key tile dropped); the largest gradient share of
        # GRAD_TOL against plain attention
        "training": {"launches": trained["launches"], **device_side["alone"],
                     "max_abs_err": trained["max_abs_err"],
                     "share": trained["share"],
                     "dropped_tile_share": trained["dropped_tile_share"],
                     "grad_share": train_grads["share"]},
        # phi3.5-moe (G 4): the served prefill's launches (ms a launch by
        # CUDA events, and the bound at that shape) and its training's
        "moe": {"prefill_launches": moe_served["naive"]["launches"],
                "prefill_launch_ms": moe_served["naive"]["flash_launch_ms"],
                "prefill_bound_ms": moe_served["naive"]["flash_bound_ms"],
                # the prefill's launch shape alone: the kernel and
                # scaled_dot_product_attention (timed only) in two turns
                **{f"alone_{k}": moe_served["alone"][k] for k in (
                    "ms", "library_ms", "bound_ms")},
                "training_launches": moe_trained["launches"],
                "training_share": moe_trained["share"]},
        # zamba2's shared attention (bf16, dh 112, G 1: the wgmma body):
        # its launches (the launcher's prefills, the served prefill, 3
        # training steps), ms a launch in the served prefill by CUDA
        # events, and at that shape alone the body, the fp32-pipe body
        # (zamba2's before dh 112 ran on wgmma), the plain version and
        # scaled_dot_product_attention (timed only) beside the bound; the
        # worst share of both limits over each path's launches
        "hybrid": {"body": hybrid_served["flash"]["body"],
                   "launches": (hybrid_served["main_launches"]
                                + hybrid_served["launches"]
                                + hybrid_trained["launches"]),
                   "prefill_launch_ms": hybrid_served["flash_launch_ms"],
                   **{k: hybrid_served["flash"][k] for k in (
                       "ms", "fp32_pipes_ms", "plain_ms", "bound_ms",
                       "bound_by", "library_ms")},
                   "launcher_share": hybrid_served["main_share"],
                   "prefill_share": hybrid_served["share"],
                   "training_share": hybrid_trained["share"]},
        # whisper-base (bf16, dh 64, G 1, wgmma): its served prefill's
        # launches (6 encoder, non-causal over 1,500 frames; 6 causal; 6
        # cross over 1,500 frames), ms a launch by CUDA events, the
        # encoder's and the cross-attention's launch shapes alone (the
        # kernel, the plain version, scaled_dot_product_attention timed
        # only, the bound of the real rows' work), the planted fault's
        # share (keys zero-padded to 1,536) and its 3 training steps
        "encdec": {"prefill_launches": encdec_served["launches"],
                   "prefill_launch_ms": encdec_served["launch_ms"],
                   "prefill_share": encdec_served["share"],
                   "padded_keys_share": encdec_served["fault_share"],
                   **{name: {k: a[k] for k in (
                       "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                       "library_ms")} for name, a in
                      encdec_served["alone"].items()},
                   "training_launches": ev_trained["encdec"]["launches"],
                   "training_share": ev_trained["encdec"]["share"]},
        # qwen2-vl-7b (bf16, dh 128, G 7, wgmma, causal, M-RoPE): its
        # served prefill's launches, ms a launch by CUDA events and the
        # bound at that shape, and its 3 training steps at 4 layers
        # phi3.5-moe's expert-parallel prefill (fp32, G 4, the fp32-pipe
        # body): its launches and their worst share
        "ep": {"prefill_launches": ep["launches"], "share": ep["share"]},
        "vlm": {"prefill_launches": vlm_served["launches"],
                "prefill_launch_ms": vlm_served["launch_ms"],
                "prefill_bound_ms": vlm_served["bound_ms"],
                **{f"alone_{k}": vlm_served["alone"][k] for k in (
                    "ms", "library_ms", "bound_ms")},
                "prefill_share": vlm_served["share"],
                "training_launches": ev_trained["vlm"]["launches"],
                "training_share": ev_trained["vlm"]["share"]}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
