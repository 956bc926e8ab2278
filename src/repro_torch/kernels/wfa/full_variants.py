"""Where the full-width kernel spends its time, on the card: build variants
of ``csrc/wfa.cu`` made by text substitution, report ptxas registers and
spills of the GapAffine exact instantiations (score and trace) and the
blocks each launch keeps resident on an SM, and time each in turns on the
waves of ``chip_smoke.py``'s phases 3b and 3c, GapAffine(4,6,2): 65,536
pairs of 100 bp at E = 2%, exact, at pass-1 bounds (s_max 38, k_pad 128;
score and trace) and at the recovery bounds (s_max 416, k_pad 384; score);
1,024 pairs of 10 kb at E = 3% at pass-1 bounds (s_max 4,928, k_pad 4,992;
score, exact and AdaptiveBand(); trace on its first 64 pairs, on their
block 0 and on their block 6, and block 6's score).

    python -m repro_torch.kernels.wfa.full_variants [--out FILE]

``--variants a,b`` builds and times only those variants ("design" always
among them).  The knock-out variants leave a part of the work out to show
what it costs; their outputs are wrong and only the variants marked
``checked`` are held against the design's outputs.  ``no_extend`` runs every
pair to s_max, so compare its milliseconds a step.  Each variant builds into
its own directory under this package's ``build/``.
"""
from __future__ import annotations

import argparse
import ctypes
import json

import torch

from repro_torch.kernels import variants as V
from repro_torch.kernels.wfa import build as wbuild
from repro_torch.kernels.wfa import kernel as K

_ARGS_OK = "  if (!full_args_ok(B, BP, k_pad, lane_lo, lane_hi, W, e))"
_PLANE_OR = ("              atomicOr(&p.bt[q][(word0 + pair0 + b) * KP + a],\n"
             "                       code[q] << sh);")
# name: (checked, [(old, new), ...]) applied to wfa.cu
VARIANTS = {
    "design": (True, []),
    # knock-out: no extension after s = 0 (every lane keeps its
    # pre-extension M; the pairs then run to s_max)
    "no_extend": (False, [("  r.M = extend(Mpre, k, prow, trow, pl, tl);",
                           "  r.M = Mpre;")]),
    # every chunk of the static lanes works every step (the spans still
    # select what a read returns)
    "all_lanes": (True, [(
        "      const int clo = max(min(sx.x, min(sg.x, se.x) - 1), lo);\n"
        "      const int chi = min(max(sx.y, max(sg.y, se.y) + 1), lo + KC - "
        "1);\n",
        "      const int clo = lo, chi = lo + KC - 1;\n")]),
    # all_lanes over all k_pad lanes (no static lane range)
    "all_k_pad": (True, [(
        "      const int clo = max(min(sx.x, min(sg.x, se.x) - 1), lo);\n"
        "      const int chi = min(max(sx.y, max(sg.y, se.y) + 1), lo + KC - "
        "1);\n",
        "      const int clo = lo, chi = lo + KC - 1;\n"),
        (_ARGS_OK, "  lane_lo = 0, lane_hi = k_pad - 1;\n" + _ARGS_OK)]),
    # int32 characters from device memory in every block
    "int_chars": (True, [("  const bool wide = __syncthreads_or(wide_here);",
                          "  const bool wide = __syncthreads_or(1);")]),
    # the rings always in global scratch
    "rings_global": (True, [("  l.rings_smem = fits_smem(l.smem + rings);",
                             "  l.rings_smem = 0;")]),
    # at most 48 / 40 registers a thread (64 under the 1,024-thread launch
    # bound): 5 / 6 blocks of 256 threads resident per SM at 100 bp
    "maxnreg48": (True, [("__launch_bounds__(FULL_THREADS)\n    wfa_full_kernel",
                          "__maxnreg__(48)\n    wfa_full_kernel")]),
    "maxnreg40": (True, [("__launch_bounds__(FULL_THREADS)\n    wfa_full_kernel",
                          "__maxnreg__(40)\n    wfa_full_kernel")]),
    # the codes ORed into the planes by a load and a store instead of
    # atomicOr (one owner a word and step, so both are exact)
    "load_store_or": (True, [(_PLANE_OR, "              p.bt[q][(word0 + "
                              "pair0 + b) * KP + a] |= code[q] << sh;")]),
    # knock-out: the codes never reach the planes
    "no_plane_or": (False, [(_PLANE_OR, "              (void)sh;")]),
    # a warp for every chunk of a pair (2 at 100 bp, 4 at 10 kb)
    "warp_per_chunk": (True, [(
        "  l.wpp = min(FULL_WARPS_PER_PAIR, max(1, nch / 2));",
        "  l.wpp = min(FULL_WARPS_PER_PAIR, nch);")]),
}


def waves(dev):
    """-> {run: (inputs, keyword arguments)}, GapAffine(4,6,2), 8 pairs a
    block: the 100 bp wave at the engine's pass-1 bounds (score and trace)
    and at its exact bounds (the recovery shape, score), the 10 kb wave at
    pass-1 bounds (score, exact and AdaptiveBand())."""
    from repro_torch.core import scoring
    from repro_torch.core.engine import AlignmentEngine, _fit_width, _round_up
    from repro_torch.data.reads import ReadPairSpec, generate_pairs
    pen = scoring.GapAffine(4, 6, 2)
    out = {}
    for tag, n, L, E, bucket in (("100bp", 65536, 100, 0.02, 128),
                                 ("10kb", 1024, 10000, 0.03, 16384)):
        P, plen, T, tlen = generate_pairs(ReadPairSpec(
            n_pairs=n, read_len=L, edit_frac=E, seed=0))
        eng = AlignmentEngine(pen, backend="kernel", edit_frac=E, device=dev)
        w = max(P.shape[1], T.shape[1]) if L > 128 else bucket
        to = lambda a: torch.from_numpy(a).to(dev)
        args = (to(_fit_width(P, w)), to(_fit_width(T, w)),
                to(plen[:, None]), to(tlen[:, None]))

        def kw(exact, trace=False, heur=None):
            s_max, k_max = eng._bounds_for_bucket(bucket, plen, tlen, exact)
            return dict(pen=pen, s_max=s_max,
                        k_pad=_round_up(2 * k_max + 1, 128), block_pairs=8,
                        trace=trace, heur=heur)
        if tag == "100bp":
            out["score_100bp"] = (args, kw(False))
            out["trace_100bp"] = (args, kw(False, trace=True))
            out["score_recovery"] = (args, kw(True))
        else:
            out["score_10kb"] = (args, kw(False))
            out["adaptive_10kb"] = (args, kw(False,
                                             heur=scoring.AdaptiveBand()))
            # 8 x 4,992 = 39,936 cells a block: the 64-pair launch, its block 0 and its slowest block, 6
            # (with its score launch beside it)
            for tag, rows in (("trace_10kb", slice(0, 64)),
                              ("trace_10kb_block0", slice(0, 8)),
                              ("trace_10kb_block6", slice(48, 56))):
                out[tag] = (tuple(a[rows] for a in args),
                            kw(False, trace=True))
            out["score_10kb_block6"] = (tuple(a[48:56] for a in args),
                                        kw(False))
    return out


def launch_shape(lib, args, kw):
    """(threads, dynamic shared bytes, blocks resident per SM) of the
    launch."""
    pen = kw["pen"]
    shape = (ctypes.c_int * 5)()
    rc = lib.wfa_full_shape(
        args[0].shape[0], kw["block_pairs"], kw["k_pad"],
        *K.full_lanes(pen, kw["s_max"], kw["k_pad"]), pen.window, pen.e, 1,
        int(kw["trace"]), 0, args[0].shape[1], args[1].shape[1], shape)
    if rc != 0:
        raise RuntimeError(f"wfa_full_shape refused the launch: {rc}")
    return list(shape)[:3]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the results as JSON here")
    ap.add_argument("--variants", help="comma-separated names of VARIANTS "
                    "to run besides design (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("full_variants: no CUDA device; this runs on a card")
    table = VARIANTS
    if args.variants:
        names = {"design", *args.variants.split(",")}
        table = {k: v for k, v in VARIANTS.items() if k in names}
        if len(table) != len(names):
            raise SystemExit(f"full_variants: unknown variants "
                             f"{sorted(names - set(VARIANTS))}")
    libs = V.build_variants(wbuild.LIB, "wfa.cu", table)
    runs = waves(torch.device("cuda"))
    results, want = {}, {}
    for name, lib in libs.items():
        results[name] = dict(checked=table[name][0])
        for tr in (0, 1):
            # wfa_full_kernel<true, TRACE, NONE>
            results[name][("trace" if tr else "score") + "_ptxas"] = \
                V.ptxas_entry(lib.info["log"],
                              rf"wfa_full_kernelILb1ELb{tr}ELi0E")
        with V.loaded_from(wbuild, lib):
            for run, (ins, kw) in runs.items():
                out = K.wfa_cuda(*ins, **kw)
                torch.cuda.synchronize()
                if name == "design":
                    want[run] = out
                elif table[name][0]:
                    for a, b in zip(want[run], out):
                        if not torch.equal(a, b):
                            raise AssertionError(f"variant {name} != "
                                                 f"design ({run})")
                results[name][f"{run}_max_steps"] = int(out[1].max())
                results[name][f"{run}_launch"] = launch_shape(
                    lib.load(), ins, kw)
                del out
    del want
    times = V.time_in_turns(
        libs, wbuild, {run: (lambda ins=ins, kw=kw: K.wfa_cuda(*ins, **kw))
                       for run, (ins, kw) in runs.items()}, reps=3)
    for name, t in times.items():
        results[name]["ms"] = t
    card = V.card()
    for run, (_, kw) in runs.items():
        print(f"{run}: s_max {kw['s_max']}, k_pad {kw['k_pad']}, lanes "
              f"{K.full_lanes(kw['pen'], kw['s_max'], kw['k_pad'])}")
    for name, r in results.items():
        print(f"{name:15s} " + "; ".join(
            f"{run} {min(r['ms'][run]):.3f} ms ({r[run + '_max_steps']} "
            f"steps, {min(r['ms'][run]) / r[run + '_max_steps'] * 1e3:.2f} "
            f"us a step of the slowest block; launch {r[run + '_launch']})"
            for run in runs)
            + f"; registers score {r['score_ptxas']['registers']} / trace "
            f"{r['trace_ptxas']['registers']}, spilled "
            f"{r['score_ptxas']['spill_bytes']} / "
            f"{r['trace_ptxas']['spill_bytes']} B; "
            + ("equal to the design" if r["checked"]
               else "not checked (knock-out)"))
    print(f"card: {card}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, variants=results), f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
