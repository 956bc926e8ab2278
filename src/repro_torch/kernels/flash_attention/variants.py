"""Where the wgmma flash body spends its time, on the card: build variants
of ``csrc/flash_wgmma.cu`` made by text substitution, report what ptxas
made of each (registers at entry, spills, its notes; from the SASS the
highest register, HGMMA and ``WARPGROUP.DEPBAR`` counts: one DEPBAR per
HGMMA means ptxas serialised the products) and time each at a launch shape
(bf16, causal), in turns: by default qwen3-0.6b's served prefill (B 8, S
2,048, H 16, KV 8, dh 128), with ``--shape zamba2`` zamba2-7b's shared
attention (B 8, S 2,048, H 32, KV 32, dh 112).

    python -m repro_torch.kernels.flash_attention.variants [--out FILE]
        [--shape qwen3|zamba2] [--variants a,b]

``--variants a,b`` builds and times only those beside "design".

The knock-out variants leave a part of the work out to show what it
costs; their outputs are wrong and only the variants marked ``checked``
are held against the plain version.  Each variant builds into its own
directory under this package's ``build/``.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess

import torch

from repro_torch.kernels import build as kbuild
from repro_torch.kernels import variants as V
from repro_torch.kernels.flash_attention import build as fbuild
from repro_torch.kernels.flash_attention import kernel as FK

_V_LOAD = [("""        mbar_expect_tx(full_v + 8 * s, C::KV_BYTES);
#pragma unroll
        for (int h = 0; h < C::HALVES; ++h)
          tma_load(sv + s * C::KV_BYTES + h * C::KV_HALF, &tv, full_v + 8 * s,
                   h * BOX, kvh, t * BK, b);""",
            "        mbar_arrive(full_v + 8 * s);")]
_K_LOAD = [("""        mbar_expect_tx(full_k + 8 * s, C::KV_BYTES);
#pragma unroll
        for (int h = 0; h < C::HALVES; ++h)
          tma_load(sk + s * C::KV_BYTES + h * C::KV_HALF, &tk, full_k + 8 * s,
                   h * BOX, kvh, t * BK, b);""",
            "        mbar_arrive(full_k + 8 * s);")]

# launch shapes (B, S, H, KV, dh)
SHAPES = {"qwen3": (8, 2048, 16, 8, 128), "zamba2": (8, 2048, 32, 32, 112)}

# name: (checked, [(old, new), ...]) applied to flash_wgmma.cu
VARIANTS = {
    "design": (True, []),
    # dh 112 on the dh-128 products: Q K^T takes 8 k-steps and P V n 128,
    # over the zero-filled columns 112-127 of the second half (the same
    # kernel as the design at dh 64 and 128)
    "pad128": (True, [("static constexpr int PW = DH;",
                       "static constexpr int PW = HALVES * BOX;")]),
    # the two consumers issue their products without taking turns
    "no_pingpong": (True, [
        ('asm volatile("bar.sync %0, %1;" ::"r"(2 + cw), "n"(2 * WG));', ""),
        ('asm volatile("bar.arrive %0, %1;" ::"r"(3 - cw), "n"(2 * WG));',
         "")]),
    # P packed into the A fragments before the P V that reads the previous
    # ones has completed: ptxas serialises every wgmma to keep it right
    "pack_early": (True, [
        ("    softmax<MASK>(sc, t);\n    wg_wait<0>();",
         "    softmax<MASK>(sc, t);\n    pack_p(sc);\n    wg_wait<0>();"),
        ("    mbar_arrive(empty_v + 8 * stage(t - 1));\n    pack_p(sc);",
         "    mbar_arrive(empty_v + 8 * stage(t - 1));")]),
    "stages3": (True, [("STAGES = HALVES == 2 ? 2 : 4;",
                        "STAGES = HALVES == 2 ? 3 : 4;")]),
    # knock-outs: an FMA in place of each exp2, no P V, no Q K^T
    "no_exp2": (False, [('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : '
                         '"f"(x));', "y = fmaf(x, 1e-30f, 1.f);")]),
    "no_pv": (False, [("      wgmma_rs(acc, pf[kc],",
                       "      if (kc < 0) wgmma_rs(acc, pf[kc],")]),
    "no_qk": (False, [("      wgmma_ss_n128(sc, sw128_desc(qa + off",
                       "      if (kk < 0) wgmma_ss_n128(sc, sw128_desc(qa + "
                       "off")]),
    # ... and no V tiles loaded (the products read whatever the ring holds),
    # then no K tiles either: what the loads from L2 cost
    "no_v_load": (False, _V_LOAD),
    "no_kv_load": (False, _V_LOAD + _K_LOAD),
}


def _ptxas(lib: kbuild.Library, dh: int) -> dict:
    """ptxas and SASS facts of flash_wgmma_kernel<dh>."""
    log = lib.info["log"]
    entry = V.ptxas_entry(log, f"flash_wgmma_kernelILi{dh}E")
    notes = sorted({f"{code}: {text}" for code, text in re.findall(
        rf"\((C7\d+)\) Potential Performance Loss: (.*?) in the function "
        rf"'\w*flash_wgmma_kernelILi{dh}E", log)})
    facts = dict(entry_registers=entry["registers"],
                 spill_bytes=entry["spill_bytes"], ptxas_notes=notes)
    cuobjdump = os.path.join(os.path.dirname(kbuild.nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib.info["path"]],
                          capture_output=True, text=True).stdout
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        if f"flash_wgmma_kernelILi{dh}E" in fn.split("\n")[0]:
            ins = [t.strip() for t in re.findall(
                r"/\*[0-9a-f]{4,5}\*/\s+([^;]*);", fn)]
            facts.update(
                max_register=max(int(r) for t in ins
                                 for r in re.findall(r"\bR(\d+)\b", t)),
                hgmma=sum("HGMMA" in t for t in ins),
                depbar=sum("WARPGROUP.DEPBAR" in t for t in ins))
    return facts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the results as JSON here")
    ap.add_argument("--shape", choices=SHAPES, default="qwen3",
                    help="the launch shape to time (default qwen3)")
    ap.add_argument("--variants", help="comma-separated names of VARIANTS "
                    "to build and time beside the design (default: all)")
    args = ap.parse_args(argv)
    table = VARIANTS
    if args.variants:
        names = {"design", *args.variants.split(",")}
        if names - set(VARIANTS):
            raise SystemExit(f"variants: unknown variants "
                             f"{sorted(names - set(VARIANTS))}")
        table = {n: t for n, t in VARIANTS.items() if n in names}
    if not torch.cuda.is_available():
        raise SystemExit("variants: no CUDA device; this runs on a card")
    libs = V.build_variants(fbuild.LIB, "flash_wgmma.cu", table)
    B, S, H, KV, dh = SHAPES[args.shape]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2048)
    rnd = lambda *s: (torch.randn(s, generator=gen, device=dev)
                      * 0.5).to(torch.bfloat16)
    q, k, v = rnd(B, S, H, dh), rnd(B, S, KV, dh), rnd(B, S, KV, dh)
    want = FK.flash_attention_plain(q, k, v, causal=True).float()
    run = lambda: FK.flash_attention_cuda(q, k, v, causal=True, body="wgmma")
    results = {}
    for name, lib in libs.items():
        results[name] = dict(_ptxas(lib, dh), checked=table[name][0])
        if table[name][0]:
            with V.loaded_from(fbuild, lib):
                err = float((run().float() - want).abs().max())
            results[name]["max_abs_err"] = err
            if not err <= 2e-2:
                raise AssertionError(f"variant {name}: max |err| {err}")
    for name, t in V.time_in_turns(libs, fbuild, {"ms": run},
                                   reps=30).items():
        results[name].update(t)
    card = V.card()
    for name, r in results.items():
        print(f"{name:12s} {min(r['ms']):.4f} ms (turns "
              f"{', '.join(f'{t:.4f}' for t in r['ms'])}); entry "
              f"{r['entry_registers']} registers, highest R{r['max_register']}"
              f", {r['spill_bytes']} B spilled, HGMMA {r['hgmma']}, DEPBAR "
              f"{r['depbar']}; {'; '.join(r['ptxas_notes']) or 'no notes'}"
              + (f"; max |err| {r['max_abs_err']:.3g}" if r["checked"]
                 else "; not checked (knock-out)"))
    print(f"shape {args.shape} (B, S, H, KV, dh) {SHAPES[args.shape]}; "
          f"card: {card}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, shape=args.shape,
                           dims=SHAPES[args.shape], variants=results), f,
                      indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
