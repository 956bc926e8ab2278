"""Where the wgmma flash body spends its time, on the card: build variants
of ``csrc/flash_wgmma.cu`` made by text substitution, report what ptxas
made of each (registers at entry, spills, its notes; from the SASS the
highest register, HGMMA and ``WARPGROUP.DEPBAR`` counts: one DEPBAR per
HGMMA means ptxas serialised the products) and time each at a launch shape
(bf16, causal), in turns: by default qwen3-0.6b's served prefill (B 8, S
2,048, H 16, KV 8, dh 128); ``--shape`` names others from SHAPES, several
comma-separated (each variant then runs every shape in its turn), among
them zamba2-7b's shared attention (dh 112), granite-34b's MQA (G 48) and
qwen2-vl's G 7, where the packing of heads into CTAs differs from the
old ``128 // G`` positions x all G heads ("bq_by_g").

    python -m repro_torch.kernels.flash_attention.variants [--out FILE]
        [--shape qwen3|zamba2|granite34b|qwen2vl|granite8b|qwen3_32b,...]
        [--variants a,b] [--turns N]

``--variants a,b`` builds and times only those beside "design";
``--turns`` sets the turns of timing (default 3).

The knock-out variants leave a part of the work out to show what it
costs; their outputs are wrong and only the variants marked ``checked``
are held against the plain version.  Each variant builds into its own
directory under this package's ``build/``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
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

# K and V shared by TMA multicast over a cluster of the chunks of one
# position block (at most 4 chunks; else no cluster): rank 0 loads each tile
# into every CTA of the cluster; each CTA's producer arms its own `full`
# barrier and, once its consumers have released the stage, arrives on rank
# 0's `cluster empty` barrier, which rank 0 waits for before it loads; a
# cluster barrier opens the kernel (barriers initialised) and closes it (no
# CTA exits while a multicast may still write into it).
# flash_wgmma_max_clusters(dh, CL) reports how many clusters fit at once.
_MULTICAST = [
    ("__device__ __forceinline__ void tma_store(", r"""// The same load from
// rank 0 of a cluster into every CTA of `mask`.
__device__ __forceinline__ void tma_load_multicast(uint32_t dst,
                                                   const CUtensorMap* map,
                                                   uint32_t bar, int c0,
                                                   int c1, int c2, int c3,
                                                   uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4, %5, %6}], [%2], %7;" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "h"(mask)
      : "memory");
}

// Arrive on the barrier at `bar`'s offset in CTA `rank` of the cluster.
__device__ __forceinline__ void mbar_arrive_at(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(bar),
      "r"(rank)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.aligned;\nbarrier.cluster.wait.aligned;" ::
          : "memory");
}

__device__ __forceinline__ void tma_store("""),
    ("BARS = 8 * (1 + 4 * STAGES);", "BARS = 8 * (1 + 6 * STAGES);"),
    ("float scale_log2, int drop_tile) {",
     "float scale_log2, int drop_tile, int CL) {"),
    ("  const uint32_t empty_v = empty_k + 8 * C::STAGES;\n",
     "  const uint32_t empty_v = empty_k + 8 * C::STAGES;\n"
     "  const uint32_t cl_empty_k = empty_v + 8 * C::STAGES;\n"
     "  const uint32_t cl_empty_v = cl_empty_k + 8 * C::STAGES;\n"),
    ("      mbar_init(empty_v + 8 * s, 2 * WG);\n",
     "      mbar_init(empty_v + 8 * s, 2 * WG);\n"
     "      mbar_init(cl_empty_k + 8 * s, CL);\n"
     "      mbar_init(cl_empty_v + 8 * s, CL);\n"),
    ("  __syncthreads();\n\n  if (threadIdx.x >= 2 * WG) {",
     "  if (CL > 1)\n    cluster_sync();\n  else\n    __syncthreads();\n\n"
     "  if (threadIdx.x >= 2 * WG) {"),
    ("""      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % C::STAGES;
        const uint32_t ph = ((t / C::STAGES) & 1) ^ 1;
        mbar_wait(empty_k + 8 * s, ph);
        mbar_expect_tx(full_k + 8 * s, C::KV_BYTES);
#pragma unroll
        for (int h = 0; h < C::HALVES; ++h)
          tma_load(sk + s * C::KV_BYTES + h * C::KV_HALF, &tk, full_k + 8 * s,
                   h * BOX, kvh, t * BK, b);
        mbar_wait(empty_v + 8 * s, ph);
        mbar_expect_tx(full_v + 8 * s, C::KV_BYTES);
#pragma unroll
        for (int h = 0; h < C::HALVES; ++h)
          tma_load(sv + s * C::KV_BYTES + h * C::KV_HALF, &tv, full_v + 8 * s,
                   h * BOX, kvh, t * BK, b);
      }""", """      const uint32_t rank = CL > 1 ? cluster_rank() : 0;
      auto fill = [&](const CUtensorMap* map, uint32_t ring, uint32_t full,
                      uint32_t empty, uint32_t cl_empty, int t) {
        const int s = t % C::STAGES;
        const uint32_t use = (t / C::STAGES) & 1;
        mbar_wait(empty + 8 * s, use ^ 1);
        mbar_expect_tx(full + 8 * s, C::KV_BYTES);
        const uint32_t dst = ring + s * C::KV_BYTES;
        if (CL == 1) {
#pragma unroll
          for (int h = 0; h < C::HALVES; ++h)
            tma_load(dst + h * C::KV_HALF, map, full + 8 * s, h * BOX, kvh,
                     t * BK, b);
          return;
        }
        mbar_arrive_at(cl_empty + 8 * s, 0);
        if (rank == 0) {
          mbar_wait(cl_empty + 8 * s, use);
#pragma unroll
          for (int h = 0; h < C::HALVES; ++h)
            tma_load_multicast(dst + h * C::KV_HALF, map, full + 8 * s,
                               h * BOX, kvh, t * BK, b,
                               (uint16_t)((1u << CL) - 1));
        }
      };
      for (int t = 0; t < n_tiles; ++t) {
        fill(&tk, sk, full_k, empty_k, cl_empty_k, t);
        fill(&tv, sv, full_v, empty_v, cl_empty_v, t);
      }"""),
    ("""      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
  }
}""", """      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
  }
  if (CL > 1) {
    __syncwarp();
    cluster_sync();
  }
}"""),
    ("""  dim3 grid((Sq + BQ - 1) / BQ * NCH, B * KV);
  flash_wgmma_kernel<DH><<<grid, NTH, C::SMEM, stream>>>(
      tq, tk, tv, to, Sq, Sk, KV, G, GH, BQ, NCH, causal, scale * LOG2E,
      drop_tile);
  return cudaGetLastError();""", """  const int CL = NCH <= 4 ? NCH : 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((Sq + BQ - 1) / BQ * NCH, B * KV);
  cfg.blockDim = dim3(NTH);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CL > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, flash_wgmma_kernel<DH>, tq, tk, tv, to, Sq,
                           Sk, KV, G, GH, BQ, NCH, causal, scale * LOG2E,
                           drop_tile, CL);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();"""),
    ("int flash_wgmma_max_group() { return ROWS; }",
     """int flash_wgmma_max_group() { return ROWS; }

template <int DH>
int max_clusters_dh(int CL) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      WCfg<DH>::SMEM);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL * 132, 1);
  cfg.blockDim = dim3(NTH);
  cfg.dynamicSmemBytes = WCfg<DH>::SMEM;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(
      &n, (const void*)flash_wgmma_kernel<DH>, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

extern "C" int flash_wgmma_max_clusters(int dh, int cluster) {
  if (cluster < 1 || cluster > 8) return -(int)cudaErrorInvalidValue;
  if (dh == 64) return max_clusters_dh<64>(cluster);
  if (dh == 112) return max_clusters_dh<112>(cluster);
  if (dh == 128) return max_clusters_dh<128>(cluster);
  return -(int)cudaErrorInvalidValue;
}"""),
]

# launch shapes (B, S, H, KV, dh)
SHAPES = {"qwen3": (8, 2048, 16, 8, 128), "zamba2": (8, 2048, 32, 32, 112),
          "granite34b": (8, 2048, 48, 1, 128),
          "qwen2vl": (8, 2048, 28, 4, 128),
          "granite8b": (8, 2048, 32, 8, 128),
          "qwen3_32b": (8, 2048, 64, 8, 128)}

# name: (checked, [(old, new), ...]) applied to flash_wgmma.cu
VARIANTS = {
    "design": (True, []),
    # the old packing, the yardstick: 128 // G positions x all G heads a
    # CTA (G 48: 2 positions, 96 of 128 rows live; G 7: 18, 126 live), one
    # chunk
    "bq_by_g": (True, [("const int GH = gh;", "const int GH = G;")]),
    # the chunks of a position block (at most 4) as one cluster sharing
    # each K and V tile by TMA multicast
    "multicast": (True, _MULTICAST),
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
    ap.add_argument("--shape", default="qwen3",
                    help="launch shapes to time, comma-separated names of "
                         "SHAPES (default qwen3)")
    ap.add_argument("--variants", help="comma-separated names of VARIANTS "
                    "to build and time beside the design (default: all)")
    ap.add_argument("--turns", type=int, default=3,
                    help="turns of timing, the order reversed each turn "
                         "(default 3)")
    args = ap.parse_args(argv)
    shapes = args.shape.split(",")
    if set(shapes) - set(SHAPES):
        raise SystemExit(f"variants: unknown shapes "
                         f"{sorted(set(shapes) - set(SHAPES))}")
    if len({SHAPES[n][4] for n in shapes}) != 1:
        raise SystemExit("variants: the shapes must share one head dim")
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
    dh = SHAPES[shapes[0]][4]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2048)
    rnd = lambda *s: (torch.randn(s, generator=gen, device=dev)
                      * 0.5).to(torch.bfloat16)
    runs, wants = {}, {}
    for shape in shapes:
        B, S, H, KV, _ = SHAPES[shape]
        q, k, v = rnd(B, S, H, dh), rnd(B, S, KV, dh), rnd(B, S, KV, dh)
        wants[shape] = FK.flash_attention_plain(q, k, v, causal=True).float()
        runs[shape] = (lambda q=q, k=k, v=v: FK.flash_attention_cuda(
            q, k, v, causal=True, body="wgmma"))
    results = {}
    for name, lib in libs.items():
        results[name] = dict(_ptxas(lib, dh), checked=table[name][0])
        if table[name][0]:
            errs = {}
            with V.loaded_from(fbuild, lib):
                for shape, run in runs.items():
                    errs[shape] = float((run().float() - wants[shape])
                                        .abs().max())
            results[name]["max_abs_err"] = errs
            if not max(errs.values()) <= 2e-2:
                raise AssertionError(f"variant {name}: max |err| {errs}")
    for name, t in V.time_in_turns(libs, fbuild, runs, reps=30,
                                   turns=args.turns).items():
        results[name]["ms"] = t
    # how many clusters of the multicast variant fit on the card at once
    clusters = {}
    if "multicast" in libs:
        count = libs["multicast"].load().flash_wgmma_max_clusters
        count.argtypes, count.restype = [ctypes.c_int] * 2, ctypes.c_int
        clusters = {cl: count(dh, cl) for cl in (1, 2, 3, 4, 7)}
    card = V.card()
    for name, r in results.items():
        print(f"{name:12s} " + "; ".join(
            f"{shape} min {min(t):.4f} median {statistics.median(t):.4f} "
            f"ms (turns {', '.join(f'{x:.4f}' for x in t)})"
            for shape, t in r["ms"].items())
            + f"; entry {r['entry_registers']} registers, highest "
            f"R{r['max_register']}, {r['spill_bytes']} B spilled, HGMMA "
            f"{r['hgmma']}, DEPBAR {r['depbar']}; "
            f"{'; '.join(r['ptxas_notes']) or 'no notes'}"
            + (f"; max |err| " + ", ".join(
                f"{shape} {e:.3g}" for shape, e in r["max_abs_err"].items())
               if r["checked"] else "; not checked (knock-out)"))
    packing = {n: tuple(FK.wgmma_packing(SHAPES[n][2] // SHAPES[n][3]))
               for n in shapes}
    print("shapes (B, S, H, KV, dh) and packing (heads, positions, chunks) "
          + "; ".join(f"{n} {SHAPES[n]} {packing[n]}" for n in shapes)
          + (f"; multicast clusters of the dh-{dh} body resident at once, by"
             f" size: {clusters}" if clusters else "") + f"; card: {card}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, shapes={n: SHAPES[n] for n in shapes},
                           clusters=clusters, variants=results), f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
