"""Where the band kernel spends its time, on the card: build variants of
``csrc/wfa.cu`` made by text substitution, report ptxas registers and
spills of the band instantiations the banded path runs (GapAffine with
AdaptiveBand, score and trace), and time each in turns at the 10 kb
pass-1 shape of ``chip_smoke.py``'s band phase: 1,024 pairs of 10 kb at E =
3%, GapAffine(4,6,2), AdaptiveBand(), 128 of 4,992 lanes; the score
variant on the whole wave and on block 0 (its first 8 pairs), the trace
variant on the 64-pair wave and on block 0.

    python -m repro_torch.kernels.wfa.band_variants [--out FILE]

``--variants a,b`` builds and times only those variants ("design" always
among them).

The knock-out variants leave a part of the work out to show what it costs;
their outputs are wrong and only the variants marked ``checked`` are held
against the design's outputs.  Each variant builds into its own directory
under this package's ``build/``.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.kernels import variants as V
from repro_torch.kernels.wfa import build as wbuild
from repro_torch.kernels.wfa import kernel as K

# name: (checked, [(old, new), ...]) applied to wfa.cu
_SEQ = ("  if (fits_smem(l.smem + seq)) {\n"
        "    l.seq_smem = 1;\n"
        "    l.smem += seq;\n"
        "  }\n")
# the rings in shared memory after the trace stage, the characters after
# them where they still fit (at 10 kb: in global scratch); the global
# scratch keeps its size, its rings unused
_RINGS_SHARED = [
    (_SEQ, "  l.smem += rings;\n" + _SEQ),
    ("  int* ring = p.grings + (size_t)blockIdx.x * n_planes * plane;\n",
     "  int* ring = reinterpret_cast<int*>(stage) +\n"
     "              (TRACE ? n_planes * BP * SW : 0);\n"),
    ("stage + (TRACE ? n_planes * BP * SW : 0))",
     "stage + (TRACE ? n_planes * BP * SW : 0) + n_planes * plane)"),
]
# diagnostic: clock cycles a step in block 0, per phase: the top (settle,
# exit, window, trace flush), phase A and phase B, each through its barrier
# as thread 0 sees it; and the slowest warp's own work before each barrier
# (its mean a step), phase B also split up to the live span's warp
# reductions and through them.  Written over the scores of pairs 1-7.
_CLOCK = [
    ("  int s = 1;\n  for (;; ++s) {\n",
     "  int s = 1;\n  long long c_top = 0, c_a = 0, c_b = 0, t_clk = 0;\n"
     "  long long w_a = 0, w_b = 0, w_b1 = 0, w_b2 = 0;\n"
     "  for (;; ++s) {\n    t_clk = clock64();\n"),
    ("      const int b = q ? c / KCP : b_0, j = c - b * KCP;\n"
     "      int2 sx, sg, se;\n"
     "      if (!spans(b, j - lane, sx, sg, se)) continue;   "
     "// warp-uniform\n",
     "      const int b = q ? c / KCP : b_0, j = c - b * KCP;\n"
     "      int2 sx, sg, se;\n"
     "      if (q == 0) {\n        c_top += clock64() - t_clk;\n"
     "        t_clk = clock64();\n      }\n"
     "      if (!spans(b, j - lane, sx, sg, se)) continue;\n"),
    ("    __syncthreads();\n    if constexpr (HEUR != HEUR_NONE) {",
     "    w_a += clock64() - t_clk;\n    __syncthreads();\n"
     "    c_a += clock64() - t_clk;\n"
     "    t_clk = clock64();\n    if constexpr (HEUR != HEUR_NONE) {"),
    ("        add_span(sl, cur, b, keep, j + off);\n      }\n"
     "      __syncthreads();\n",
     "        if (q == 0) w_b1 += clock64() - t_clk;\n"
     "        const int lo_ = __reduce_min_sync(FULL, keep ? j + off : "
     "EMPTY_LO);\n"
     "        const int hi_ = __reduce_max_sync(FULL, keep ? j + off : "
     "-EMPTY_LO);\n"
     "        if (q == 0) w_b2 += clock64() - t_clk;\n"
     "        if (lane == 0 && hi_ >= lo_) {\n"
     "          atomicMin(&s_span[cur * BP + b].x, lo_);\n"
     "          atomicMax(&s_span[cur * BP + b].y, hi_);\n"
     "          atomicMin(&s_bsp[sl].x, lo_);\n"
     "          atomicMax(&s_bsp[sl].y, hi_);\n        }\n      }\n"
     "      w_b += clock64() - t_clk;\n      __syncthreads();\n"),
    ("    rx = rx + 1 == W ? 0 : rx + 1;",
     "    c_b += clock64() - t_clk;\n    rx = rx + 1 == W ? 0 : rx + 1;"),
    ("    p.steps[pair0 + b] = s;\n  }\n}\n",
     "    p.steps[pair0 + b] = s;\n  }\n"
     "  if (tid < 4) s_reach[tid] = 0u;\n  __syncthreads();\n"
     "  if (lane == 0) {\n"
     "    atomicMax(&s_reach[0], (unsigned)(w_a / s));\n"
     "    atomicMax(&s_reach[1], (unsigned)(w_b / s));\n"
     "    atomicMax(&s_reach[2], (unsigned)(w_b1 / s));\n"
     "    atomicMax(&s_reach[3], (unsigned)(w_b2 / s));\n  }\n"
     "  __syncthreads();\n"
     "  if (tid == 0 && BP >= 8) {\n"
     "    p.score[pair0 + 1] = (int)(c_top / s);\n"
     "    p.score[pair0 + 2] = (int)(c_a / s);\n"
     "    p.score[pair0 + 3] = (int)(c_b / s);\n"
     "    for (int i = 0; i < 4; ++i) p.score[pair0 + 4 + i] = "
     "(int)s_reach[i];\n  }\n}\n"),
]
_CLOCK_KEYS = ("top", "phase_a", "phase_b", "slowest_warp_a_work",
               "slowest_warp_b_work", "slowest_warp_b_before_span",
               "slowest_warp_b_through_reductions")

_SHFL = [
    ("__device__ __forceinline__ bool in_span(int a, int2 sp) {",
     "template <typename F>\n"
     "__device__ __forceinline__ int shfl_reduce(F f, int v) {\n"
     "  for (int d = 16; d; d >>= 1) v = f(v, __shfl_xor_sync(FULL, v, d));\n"
     "  return v;\n}\n\n"
     "__device__ __forceinline__ bool in_span(int a, int2 sp) {"),
    ("__reduce_min_sync(\n            FULL, ",
     "shfl_reduce([](int x, int y) { return min(x, y); },\n            "),
    ("__reduce_min_sync(FULL, ",
     "shfl_reduce([](int x, int y) { return min(x, y); }, "),
    ("__reduce_max_sync(FULL, ",
     "shfl_reduce([](int x, int y) { return max(x, y); }, "),
    ("__reduce_add_sync(FULL, ",
     "shfl_reduce([](int x, int y) { return x + y; }, "),
]

VARIANTS = {
    "design": (True, []),
    "rings_shared": (True, _RINGS_SHARED),
    # the characters in global scratch too, served by L1
    "all_global": (True, [(_SEQ, "")]),
    "threads512": (True, [("constexpr int BAND_THREADS = 1024;",
                           "constexpr int BAND_THREADS = 512;")]),
    "threads256": (True, [("constexpr int BAND_THREADS = 1024;",
                           "constexpr int BAND_THREADS = 256;")]),
    # knock-out: no extension after s = 0 (every lane keeps its
    # pre-extension M; the pairs then run to s_max, so compare time a step)
    "no_extend": (False, [("  r.M = extend(Mpre, k, prow, trow, pl, tl);",
                           "  r.M = Mpre;")]),
    # knock-out: the staged words never reach the planes
    "no_plane_stores": (False, [(
        "        if (orin)\n"
        "          *bt |= v;\n"
        "        else\n"
        "          *bt = v;\n",
        "        (void)bt;\n")]),
    # warp reductions by five shuffles (as the meet kernel does) instead of
    # __reduce_*_sync
    "shfl_reduce": (True, _SHFL),
    # the five ring reads under their span checks (predicated loads)
    "guarded_reads": (True, [
        ("const int v_x = m_ring[", "const int v_x = !in_span(a, sx) ? NEG "
         ": m_ring["),
        ("const int v_io = m_ring[", "const int v_io = !(lok && in_span(a - "
         "1, sg)) ? NEG : m_ring["),
        ("const int v_do = m_ring[", "const int v_do = !(hok && in_span(a + "
         "1, sg)) ? NEG : m_ring["),
        ("const int v_ie = AFFINE ? i_ring[", "const int v_ie = AFFINE && lok "
         "&& in_span(a - 1, se) ? i_ring["),
        ("const int v_de = AFFINE ? d_ring[", "const int v_de = AFFINE && hok "
         "&& in_span(a + 1, se) ? d_ring["),
    ]),
    "phase_clock": (False, _CLOCK),
    # knock-out: no codes staged
    "no_stage_codes": (False, [(
        "          if (st.cm) at[0] |= st.cm << sh;\n"
        "          if (st.ci) at[BP * SW] |= st.ci << sh;\n"
        "          if (st.cd) at[2 * BP * SW] |= st.cd << sh;\n",
        "          (void)at;\n")]),
}

def band_wave(dev):
    """The band kernel's inputs and arguments at the 10 kb pass-1 shape ->
    (inputs of the 1,024-pair wave, keyword arguments): s_max and k_pad the
    engine's pass-1 bounds of the 16,384 bucket, the band AdaptiveBand()'s
    lane-aligned cap."""
    from repro_torch.core import scoring
    from repro_torch.core.engine import AlignmentEngine, _fit_width, _round_up
    from repro_torch.data.reads import ReadPairSpec, generate_pairs
    from repro_torch.kernels.wfa import ops
    n, L, E, bucket = 1024, 10000, 0.03, 16384
    P, plen, T, tlen = generate_pairs(ReadPairSpec(
        n_pairs=n, read_len=L, edit_frac=E, seed=0))
    pen, heur = scoring.GapAffine(4, 6, 2), scoring.AdaptiveBand()
    eng = AlignmentEngine(pen, backend="kernel", edit_frac=E, device=dev)
    s1, k1 = eng._bounds_for_bucket(bucket, plen, tlen, False)
    k_pad = _round_up(2 * k1 + 1, 128)
    w = max(P.shape[1], T.shape[1])
    to = lambda a: torch.from_numpy(a).to(dev)
    args = (to(_fit_width(P, w)), to(_fit_width(T, w)), to(plen[:, None]),
            to(tlen[:, None]))
    return args, dict(pen=pen, s_max=s1, k_pad=k_pad, block_pairs=8,
                      heur=heur,
                      band_cap=ops._band_lanes(heur.band_cap(2 * k1 + 1),
                                               k_pad))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the results as JSON here")
    ap.add_argument("--variants", help="comma-separated names of VARIANTS "
                    "to run besides design (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("band_variants: no CUDA device; this runs on a card")
    table = VARIANTS
    if args.variants:
        names = {"design", *args.variants.split(",")}
        table = {k: v for k, v in VARIANTS.items() if k in names}
        if len(table) != len(names):
            raise SystemExit(f"band_variants: unknown variants "
                             f"{sorted(names - set(VARIANTS))}")
    libs = V.build_variants(wbuild.LIB, "wfa.cu", table)
    dev = torch.device("cuda")
    wave, kw = band_wave(dev)
    rows = lambda n: tuple(a[:n] for a in wave)
    runs = {"score": (rows(1024), dict(kw, trace=False)),
            "score_block0": (rows(8), dict(kw, trace=False)),
            "trace": (rows(64), dict(kw, trace=True)),
            "trace_block0": (rows(8), dict(kw, trace=True))}
    results, want = {}, {}
    for name, lib in libs.items():
        # registers and spills of wfa_band_kernel<true, TRACE, ADAPTIVE>
        results[name] = dict(
            {f"{t}_{key}": v
             for t, tr in (("score", 0), ("trace", 1))
             for key, v in V.ptxas_entry(
                 lib.info["log"],
                 f"wfa_band_kernelILb1ELb{tr}ELi1E").items()},
            checked=table[name][0])
        with V.loaded_from(wbuild, lib):
            for run in ("score", "trace"):
                ins, kwr = runs[run]
                out = K.wfa_cuda(*ins, **kwr)
                torch.cuda.synchronize()
                if name == "design":
                    want[run] = out
                elif table[name][0]:
                    for a, b in zip(want[run], out):
                        if not torch.equal(a, b):
                            raise AssertionError(f"variant {name} != "
                                                 f"design ({run})")
                if run == "score":
                    # each block's exit step (a knock-out's own)
                    steps = out[1][:, 0].view(-1, 8)[:, 0].cpu()
                    results[name].update(steps_block0=int(steps[0]),
                                         steps_max=int(steps.max()))
                if name == "phase_clock":
                    results[name][f"{run}_cycles_per_step_block0"] = dict(
                        zip(_CLOCK_KEYS, out[0][1:8, 0].tolist()))
                del out
    del want
    times = V.time_in_turns(
        libs, wbuild, {f"ms_{run}": (lambda ins=ins, kwr=kwr:
                                     K.wfa_cuda(*ins, **kwr))
                       for run, (ins, kwr) in runs.items()}, reps=3)
    for name, t in times.items():
        results[name].update(t)
        r = results[name]
        r["us_per_step_block0"] = (min(r["ms_score_block0"]) * 1e3
                                   / r["steps_block0"])
    card = V.card()
    print(f"10 kb wave: s_max {kw['s_max']}, k_pad {kw['k_pad']}, band "
          f"{kw['band_cap']}")
    for name, r in results.items():
        print(f"{name:16s} " + ", ".join(
            f"{run} {min(r['ms_' + run]):.3f} ms" for run in runs)
            + f"; block 0 {r['steps_block0']} steps, "
            f"{r['us_per_step_block0']:.3f} us a step (score); exit steps "
            f"<= {r['steps_max']}; registers score {r['score_registers']} / "
            f"trace {r['trace_registers']}, spilled {r['score_spill_bytes']} "
            f"/ {r['trace_spill_bytes']} B; "
            + ("equal to the design" if r["checked"]
               else "not checked (knock-out)"))
    for name, r in results.items():
        for run in ("score", "trace"):
            clk = r.get(f"{run}_cycles_per_step_block0")
            if clk:
                print(f"{name}, {run} block 0, cycles a step: "
                      + ", ".join(f"{k} {v}" for k, v in clk.items()))
    print(f"card: {card}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, s_max=kw["s_max"], k_pad=kw["k_pad"],
                           band=kw["band_cap"],
                           variants=results), f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
