"""Where the meet kernel spends its time, on the card: build variants of
``csrc/wfa_meet.cu`` made by text substitution, report ptxas registers and
spills of the GapAffine exact instantiation, and time each at the BiWFA
root wave (1,024 pairs of 10 kb at E = 3%, GapAffine(4,6,2), exact; s_max
and k_pad as the BiWFA recursion sets them), on the whole wave and on its
first 8 pairs, in turns.

    python -m repro_torch.kernels.wfa.meet_variants [--out FILE]

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

# name: (checked, [(old, new), ...]) applied to wfa_meet.cu
VARIANTS = {
    "design": (True, []),
    "threads128": (True, [("constexpr int THREADS = 256;",
                           "constexpr int THREADS = 128;")]),
    "threads192": (True, [("constexpr int THREADS = 256;",
                           "constexpr int THREADS = 192;")]),
    # up to 128 registers: two CTAs fill an SM's register file
    "threads256_2": (True, [("__launch_bounds__(THREADS, 4)",
                             "__launch_bounds__(THREADS, 2)")]),
    "threads512": (True, [("constexpr int THREADS = 256;",
                           "constexpr int THREADS = 512;"),
                          ("__launch_bounds__(THREADS, 4)",
                           "__launch_bounds__(THREADS, 1)")]),
    # the rings in shared memory after the sequences (their global scratch
    # stays allocated, unused): one CTA per SM at the root wave
    "rings_shared": (True, [
        ("  int* rg = p.rings + (size_t)pair * ring_ints(KP, Dm, De, AFFINE);",
         "  int* rg = smem + SMALL_INTS +\n"
         "            (p.gseq ? 0 : seq_bytes(p.Lp, p.Lt) / sizeof(int));"),
        ("      SMALL_INTS * sizeof(int) + (seq_smem ? seq_bytes(Lp, Lt) : 0);",
         "      SMALL_INTS * sizeof(int) + (seq_smem ? seq_bytes(Lp, Lt) : 0) +"
         "\n      ring_ints(k_pad, Dm, De, affine) * sizeof(int);")]),
    # the byte sequences in global scratch (through L1) at every row width
    "seq_global": (True, [
        ("  return SMALL_INTS * sizeof(int) + seq_bytes(Lp, Lt) <= MAX_SMEM;",
         "  return false;")]),
    # knock-out: no extension (every lane keeps its pre-extension M)
    "no_extend": (False, [("  return extend(Mpre, k, prow, trow, pl, tl);",
                           "  return Mpre;")]),
}


def root_wave(dev):
    """The meet kernel's inputs and arguments at the BiWFA root wave: each
    pair's cost from the score kernel at the engine's pass-1 bounds, s_max
    the BiWFA recursion's cap, k_pad the engine's bound under it."""
    from repro_torch.core import scoring
    from repro_torch.core.engine import AlignmentEngine, _fit_width, _round_up
    from repro_torch.core.wavefront import _reverse_rows, meet_window
    from repro_torch.data.reads import ReadPairSpec, generate_pairs
    from repro_torch.kernels.wfa import ops
    n, L, E, bucket = 1024, 10000, 0.03, 16384
    P, plen, T, tlen = generate_pairs(ReadPairSpec(
        n_pairs=n, read_len=L, edit_frac=E, seed=0))
    pen = scoring.GapAffine(4, 6, 2)
    eng = AlignmentEngine(pen, backend="kernel", edit_frac=E, device=dev)
    s1, k1 = eng._bounds_for_bucket(bucket, plen, tlen, False)
    w = max(P.shape[1], T.shape[1])
    to = lambda a: torch.from_numpy(a).to(dev)
    st = K.wfa_cuda(to(_fit_width(P, w)), to(_fit_width(T, w)),
                    to(plen[:, None]), to(tlen[:, None]), pen=pen, s_max=s1,
                    k_pad=_round_up(2 * k1 + 1, 128), block_pairs=8)[0]
    cap = _round_up((int(st.max()) + pen.o) // 2 + meet_window(pen) + 2, 32)
    s_max, k_max = eng._bounds_for_bucket(bucket, plen, tlen, True, pen=pen,
                                          s_cap=cap)
    pp, tt, pl, tl, _ = ops._prep(P, T, plen, tlen, 8, dev)
    args = (pp, tt, _reverse_rows(pp, pl[:, 0]), _reverse_rows(tt, tl[:, 0]),
            pl, tl, st.to(torch.int32))
    return args, dict(pen=pen, s_max=s_max, k_pad=_round_up(2 * k_max + 1,
                                                            128),
                      block_pairs=8)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the results as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("meet_variants: no CUDA device; this runs on a card")
    libs = V.build_variants(wbuild.LIB, "wfa_meet.cu", VARIANTS)
    dev = torch.device("cuda")
    ins, kw = root_wave(dev)
    first8 = tuple(a[:8] for a in ins)
    results = {}
    for name, lib in libs.items():
        # registers and spills of wfa_meet_kernel<true, HEUR_NONE>
        results[name] = dict(V.ptxas_entry(lib.info["log"],
                                           "wfa_meet_kernelILb1ELi0E"),
                             checked=VARIANTS[name][0])
        with V.loaded_from(wbuild, lib):
            out = K.wfa_meet_cuda(*ins, **kw)
            torch.cuda.synchronize()
        if name == "design":
            want = out
        elif VARIANTS[name][0]:
            for a, b in zip(want, out):
                if not torch.equal(a, b):
                    raise AssertionError(f"variant {name} != design")
    times = V.time_in_turns(
        libs, wbuild, {"ms": lambda: K.wfa_meet_cuda(*ins, **kw),
                       "ms_first8": lambda: K.wfa_meet_cuda(*first8, **kw)},
        reps=3)
    for name, t in times.items():
        results[name].update(t)
    card = V.card()
    print(f"root wave: s_max {kw['s_max']}, k_pad {kw['k_pad']}")
    for name, r in results.items():
        print(f"{name:13s} {min(r['ms']):.3f} ms, first 8 pairs "
              f"{min(r['ms_first8']):.3f} ms (turns "
              f"{', '.join(f'{t:.3f}' for t in r['ms'])}); "
              f"{r['registers']} registers, {r['spill_bytes']} B spilled; "
              + ("equal to the design" if r["checked"]
                 else "not checked (knock-out)"))
    print(f"card: {card}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, s_max=kw["s_max"], k_pad=kw["k_pad"],
                           variants=results), f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
