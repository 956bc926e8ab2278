// Forward GQA flash attention for Hopper: the warp-specialised wgmma body.
//
// Replaces, for bf16 at head dims 64, 112 and 128 (the model path), the
// Pallas TPU kernel repro/kernels/flash_attention/kernel.py::flash_attention_gqa
// (body _kernel).  It computes what flash_attention.cu's bodies compute,
// under the same contract: query head h reads KV head h / G; fp32 scores
// and sums; masked scores at the finite NEG_INF, never -inf; the causal
// mask is q_pos >= k_pos from position 0; keys at or past Sk weigh 0; p is
// rounded to bf16 before p @ v while l sums it unrounded; the output is
// acc / max(l, 1e-30), in bf16.
//
// What bounds it.  The served shape (B 8, S 2,048, H 16, KV 8, dh 128,
// causal) needs 137.5 GFLOP and 201 MB: 0.139 ms at the tensor cores' 989
// TFLOP/s, so the bound is operations, and wgmma is the only instruction
// that reaches that rate; zamba2-7b's shared attention (B 8, S 2,048, H 32,
// KV 32, dh 112) needs 240.6 GFLOP, 0.243 ms.  The design keeps the tensor
// cores fed:
//
// - CTA: three warpgroups.  Warpgroup 2 is the producer: one thread issues
//   TMA loads and `setmaxnreg` lowers its registers to 24.  Warpgroups 0
//   and 1 are consumers with 240 registers, each owning 64 rows of a
//   128-row Q tile.  A row is (position, head): BQ = 128 / GH positions x
//   GH query heads of one KV head, GH = gcd(G, 128) (kernel.py::
//   wgmma_packing), so all 128 rows are live at any G.  A KV head's G
//   heads take G / GH chunks, side by side on the grid's x axis (G 48: GH
//   16, BQ 8, 3 chunks; where G divides 128, GH = G and one chunk).
//   The chunks of one position block read the same K and V tiles, each
//   its own copy from L2: sharing them over a cluster by TMA multicast
//   (variants.py's "multicast") measured slower, since clusters of 3 such
//   CTAs fill only 117 of the 132 SMs.
// - TMA: 4-D tensor maps over q, o [B, Sq, H, dh] and k, v [B, Sk, KV, dh]
//   with 128-byte swizzle, so a box is 64 head-dim elements wide and dh
//   128 loads as two boxes ("halves").  dh 112 loads as two halves too:
//   the second box's columns 112-127 lie past the map's dims[0], so TMA
//   fills them with zeros (and still counts them in the barrier's bytes),
//   and the epilogue's store clips them.  The Q box (64, GH, BQ, 1) lands
//   rows in (position, head) order, the K-major layout wgmma reads; per-batch
//   coordinates zero-fill past Sq / Sk.  K and V tiles of 128 keys go
//   through two rings of STAGES stages (a K tile loads while the V tile
//   before it is still read), each stage with a `full` mbarrier (TMA
//   bytes) and an `empty` one (the 256 consumer threads).
// - S = Q K^T: wgmma m64n128k16, both operands K-major in shared memory,
//   dh / 16 k-steps (7 at dh 112: 4 in half 0, 3 in half 1).
// - Softmax on the accumulator fragments: a row's 128 scores sit on the 4
//   threads of a quad; exp2 with scale * log2(e) folded into one FMA; l
//   summed per thread from unrounded p and reduced over the quad at the
//   end; p rounded to bf16 straight into the A fragments of p @ v.
// - O += P V: wgmma m64n{DH}k16 (n112 at dh 112), A from registers, V
//   from shared memory as an MN-major B operand (the transpose bit).
// - Overlap: a consumer issues Q K^T of tile t and P V of tile t - 1
//   together and runs the softmax of t under that P V; the two consumers
//   take turns to issue (ping-pong on named barriers), so one's softmax
//   also runs under the other's products.
// - Causal: key tiles past the q tile's last position are never loaded;
//   only tiles that cross the diagonal or Sk compute the mask; the walk
//   goes upward from key tile 0, which holds key 0, unmasked for every row,
//   so the finite NEG_INF never gets weight; the heaviest q tiles first.
// - Epilogue: acc / max(l, 1e-30) (one reciprocal a row) in bf16 into the
//   Q tile's shared memory (swizzled as the TMA store reads it), then one
//   TMA store, which clips rows past Sq and columns past dh.
//
// Not yet: a persistent grid (one CTA per SM walking the tiles, so one
// tile's epilogue overlaps the next one's loads).
#include <cuda.h>          // CUtensorMap and its enums (header only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WG = 128;           // threads per warpgroup
constexpr int NTH = 3 * WG;       // consumers 0 and 1, producer 2
constexpr int ROWS = 128;         // rows (position, head) per CTA
constexpr int BK = 128;           // keys per tile
constexpr int BOX = 64;           // head-dim elements per box (128 bytes)
constexpr int ROW_BYTES = 128;    // one swizzled shared-memory row
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int DH> struct WCfg {
  // 64-column halves in shared memory: dh 112 takes two, as 128 does
  static constexpr int HALVES = (DH + BOX - 1) / BOX;
  // the products' width: PW / 16 k-steps of Q K^T, n = PW of P V, PW / 2
  // accumulators a thread
  static constexpr int PW = DH;
  static constexpr int STAGES = HALVES == 2 ? 2 : 4;
  static constexpr int Q_HALF = ROWS * ROW_BYTES;        // 16 KB
  static constexpr int KV_HALF = BK * ROW_BYTES;         // 16 KB
  static constexpr int Q_BYTES = HALVES * Q_HALF;
  static constexpr int KV_BYTES = HALVES * KV_HALF;      // one K or V tile
  static constexpr int BARS = 8 * (1 + 4 * STAGES);
  // tiles, barriers, and slack to align the base to 1,024 bytes (the
  // 128-byte swizzle repeats every 8 rows of 128 bytes)
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + BARS + 1024;
  // Q K^T steps through Q and K halves at one offset
  static_assert(Q_HALF == KV_HALF, "Q and K halves must match");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 (SW128).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N commit groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of wgmma accumulators
// across the asynchronous product (the tensor cores write them until the
// wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_D32 WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
#define WG_D56 WG_D32, WG_D8(32), WG_D8(40), WG_D8(48)
#define WG_D64 WG_D56, WG_D8(56)
#define WG_R32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31"
#define WG_R56                                                          \
  WG_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "    \
         "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "  \
         "%55"
#define WG_R64 WG_R56 ", %56, %57, %58, %59, %60, %61, %62, %63"

// d[64] (+)= A (64 x 16, K-major, shared) * B (16 x 128, K-major, shared)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_R64
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_D64
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64] += A (64 x 16, registers) * B (16 x 128, MN-major, shared)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_R64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[56] += A (64 x 16, registers) * B (16 x 112, MN-major, shared): the
// second 64-column half's first 48 columns
__device__ __forceinline__ void wgmma_rs(float (&d)[56], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 " WG_R56
      "}, {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : WG_D56
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[32] += A (64 x 16, registers) * B (16 x 64, MN-major, shared)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_R32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Named barriers 2 and 3 hand the turn to issue wgmma between the two
// consumers (bar 0 is __syncthreads, bar 1 the epilogue's).
__device__ __forceinline__ void turn_wait(int cw) {
  asm volatile("bar.sync %0, %1;" ::"r"(2 + cw), "n"(2 * WG));
}
__device__ __forceinline__ void turn_pass(int cw) {
  asm volatile("bar.arrive %0, %1;" ::"r"(3 - cw), "n"(2 * WG));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// The shared-memory byte offset of element (row, col) of a [rows][64]
// bf16 half-tile under the 128-byte swizzle (16-byte chunks XOR row % 8).
__device__ __forceinline__ uint32_t sw128_offset(int row, int col) {
  return row * ROW_BYTES + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

// One consumer warpgroup's walk over the key tiles.  Q K^T of tile t is
// issued, then P V of tile t - 1 behind it; the softmax of tile t runs on
// the CUDA cores while that P V runs on the tensor cores.  Every register a
// wgmma reads is written before its commit group opens and not again until
// the group has completed (else ptxas serialises every wgmma): P stays in
// fp32 in the score registers during the softmax and becomes bf16 A
// fragments only after the P V before it has completed.
template <int DH> struct Consumer {
  using C = WCfg<DH>;
  float acc[C::PW / 2];          // O: element 4 n + e is row r0 + 8 (e / 2),
                                 // column 8 n + 2 t4 + e % 2
  uint32_t pf[BK / 16][4];       // P of the tile whose P V is next, bf16
  // running max in log2 units (scores x scale x log2 e), this thread's part
  // of the running sum, and the rescale of O that the next P V needs, for
  // rows r0 and r0 + 8
  float m0, m1, l0, l1, c0, c1;
  uint32_t qa, sk, sv, full_k, full_v, empty_k, empty_v;
  int Sk, causal, qpos0, qpos1, t4, drop_tile, cw;
  float scale_log2;

  __device__ __forceinline__ uint32_t stage(int t) const {
    return (uint32_t)(t % C::STAGES);
  }
  __device__ __forceinline__ uint32_t parity(int t) const {
    return (uint32_t)((t / C::STAGES) & 1);
  }

  // S = Q K^T of tile t (one commit group): element 4 j + e of sc is row
  // r0 + 8 (e / 2), key 128 t + 8 j + 2 t4 + e % 2
  __device__ __forceinline__ void issue_s(float (&sc)[64], int t) {
    mbar_wait(full_k + 8 * stage(t), parity(t));
    const uint32_t kt = sk + stage(t) * C::KV_BYTES;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < C::PW / 16; ++kk) {
      const uint32_t off = (kk / 4) * C::Q_HALF + (kk % 4) * 32;
      wgmma_ss_n128(sc, sw128_desc(qa + off, 16, 1024),
                    sw128_desc(kt + off, 16, 1024), kk > 0);
    }
    wg_commit();
  }

  // O = O * (c0, c1) + P V of tile t (one commit group); V is an MN-major
  // B operand: 8 keys of 128 bytes per core block (SBO 1,024 bytes to the
  // next 8 keys), head-dim halves LBO apart
  __device__ __forceinline__ void issue_pv(int t) {
#pragma unroll
    for (int n = 0; n < C::PW / 8; ++n) {
      acc[4 * n] *= c0;
      acc[4 * n + 1] *= c0;
      acc[4 * n + 2] *= c1;
      acc[4 * n + 3] *= c1;
    }
    mbar_wait(full_v + 8 * stage(t), parity(t));
    const uint32_t vt = sv + stage(t) * C::KV_BYTES;
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc)
      wgmma_rs(acc, pf[kc],
               sw128_desc(vt + kc * 16 * ROW_BYTES, C::KV_HALF, 1024));
    wg_commit();
  }

  // The online softmax of tile t's scores, in place: the new running max,
  // the rescale (c0, c1) of what came before, l, and p = exp(s - m) in sc,
  // which l sums unrounded.  MASK: the tile crosses the causal diagonal or
  // Sk.  The planted fault (t == drop_tile) gives the tile weight 0 and
  // leaves m and l as they were.
  template <bool MASK>
  __device__ __forceinline__ void softmax(float (&sc)[64], int t) {
    if (MASK) {
      const int k0 = t * BK + 2 * t4;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int key = k0 + 8 * (i / 4) + (i & 1);
        if (key >= Sk)
          sc[i] = -INFINITY;            // past the keys: weight exactly 0
        else if (causal && key > ((i & 2) ? qpos1 : qpos0))
          sc[i] = NEG_INF;
      }
    }
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    // a row's keys are spread over the 4 lanes of a quad
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const bool drop = t == drop_tile;
    const float mn0 = drop ? m0 : fmaxf(m0, mx0 * scale_log2);
    const float mn1 = drop ? m1 : fmaxf(m1, mx1 * scale_log2);
    c0 = ex2(m0 - mn0);
    c1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    const float sub0 = drop ? INFINITY : mn0, sub1 = drop ? INFINITY : mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      sc[4 * j] = ex2(fmaf(sc[4 * j], scale_log2, -sub0));
      sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], scale_log2, -sub0));
      sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], scale_log2, -sub1));
      sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], scale_log2, -sub1));
      sum0 += sc[4 * j] + sc[4 * j + 1];
      sum1 += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
  }

  // p @ v takes p in bf16 (the TPU kernel's cast): the A fragment of keys
  // 16 kc .. 16 kc + 15 is score tiles 2 kc and 2 kc + 1
  __device__ __forceinline__ void pack_p(const float (&sc)[64]) {
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pf[kc][e] = pack_bf16(sc[8 * kc + 2 * e], sc[8 * kc + 2 * e + 1]);
  }

  // Tile t >= 1: Q K^T of t and P V of t - 1 in flight, then the softmax
  // of t under the P V, then t's P packed once that P V has completed.
  template <bool MASK>
  __device__ __forceinline__ void step(float (&sc)[64], int t) {
    turn_wait(cw);
    issue_s(sc, t);
    issue_pv(t - 1);
    turn_pass(cw);
    wg_wait<1>();                    // Q K^T of t has completed
    fence_regs(sc);
    mbar_arrive(empty_k + 8 * stage(t));
    softmax<MASK>(sc, t);
    wg_wait<0>();                    // P V of t - 1 has completed
    fence_regs(acc);
    mbar_arrive(empty_v + 8 * stage(t - 1));
    pack_p(sc);
  }

  // Tiles [0, n_full) need no mask, [n_full, n_tiles) do.
  __device__ __forceinline__ void run(int n_tiles, int n_full) {
#pragma unroll
    for (int i = 0; i < C::PW / 2; ++i) acc[i] = 0.f;
    m0 = m1 = NEG_INF;
    l0 = l1 = 0.f;
    if (n_tiles == 0) return;
    // the two consumers take turns to issue their products, warpgroup 0
    // first, so that one's softmax runs under the other's products
    if (cw == 1) turn_pass(cw);
    float sc[64];
    turn_wait(cw);
    issue_s(sc, 0);
    turn_pass(cw);
    wg_wait<0>();
    fence_regs(sc);
    mbar_arrive(empty_k + 8 * stage(0));
    if (n_full > 0)
      softmax<false>(sc, 0);
    else
      softmax<true>(sc, 0);
    pack_p(sc);
    int t = 1;
    for (; t < n_full; ++t) step<false>(sc, t);
    for (; t < n_tiles; ++t) step<true>(sc, t);
    turn_wait(cw);
    issue_pv(n_tiles - 1);
    if (cw == 0) turn_pass(cw);      // warpgroup 1's last turn is the end
    wg_wait<0>();
    fence_regs(acc);
    mbar_arrive(empty_v + 8 * stage(n_tiles - 1));
  }
};

template <int DH>
__global__ void __launch_bounds__(NTH, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap to, int Sq, int Sk,
                       int KV, int G, int GH, int BQ, int NCH, int causal,
                       float scale_log2, int drop_tile) {
  using C = WCfg<DH>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw);
  const uint32_t sq = base;                          // Q halves, then O
  const uint32_t sk = sq + C::Q_BYTES;               // K stages
  const uint32_t sv = sk + C::STAGES * C::KV_BYTES;  // V stages
  // barriers, 8 bytes each: Q; then per stage s, at + 8 s, K full, V full,
  // K empty, V empty
  const uint32_t q_full = sv + C::STAGES * C::KV_BYTES;
  const uint32_t full_k = q_full + 8;
  const uint32_t full_v = full_k + 8 * C::STAGES;
  const uint32_t empty_k = full_v + 8 * C::STAGES;
  const uint32_t empty_v = empty_k + 8 * C::STAGES;

  // x: position block (heaviest causal blocks first) x chunk of GH heads
  const int qt = gridDim.x / NCH - 1 - blockIdx.x / NCH;
  const int chunk = blockIdx.x % NCH;
  const int bh = blockIdx.y, b = bh / KV, kvh = bh % KV;
  const int h0 = kvh * G + chunk * GH;          // the chunk's first q head
  const int q0 = qt * BQ;
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int n_tiles = (k_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, 2 * WG);
      mbar_init(empty_v + 8 * s, 2 * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 2 * WG) {
    // producer: one thread keeps both rings full, K of a tile ahead of its V
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 2 * WG) {
      mbar_expect_tx(q_full, C::HALVES * BOX * 2 * GH * BQ);
#pragma unroll
      for (int h = 0; h < C::HALVES; ++h)
        tma_load(sq + h * C::Q_HALF, &tq, q_full, h * BOX, h0, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
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
      }
    }
  } else {
    // consumers: warpgroup cw owns tile rows 64 cw .. 64 cw + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = threadIdx.x / WG;
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % WG) / 32;
    const int g = lane / 4;
    const int r0 = cw * 64 + warp * 16 + g;     // this thread's rows r0, r0 + 8
    Consumer<DH> c;
    c.qa = sq + cw * 64 * ROW_BYTES;
    c.sk = sk;
    c.sv = sv;
    c.full_k = full_k;
    c.full_v = full_v;
    c.empty_k = empty_k;
    c.empty_v = empty_v;
    c.Sk = Sk;
    c.causal = causal;
    c.qpos0 = q0 + r0 / GH;
    c.qpos1 = q0 + (r0 + 8) / GH;
    c.t4 = lane % 4;
    c.drop_tile = drop_tile;
    c.cw = cw;
    c.scale_log2 = scale_log2;
    // tiles wholly below the diagonal and inside Sk come first
    int n_full = min(n_tiles, Sk / BK);
    if (causal) n_full = min(n_full, (q0 + 1) / BK);
    mbar_wait(q_full, 0);
    c.run(n_tiles, n_full);

    // epilogue: acc / max(l, 1e-30) in bf16 (as acc times the correctly
    // rounded reciprocal, within an fp32 ulp of the quotient) over this
    // warpgroup's own Q rows (its last Q K^T has completed), then one TMA
    // store of the tile, which clips columns at or past dh (and rows past
    // Sq)
    float l0 = c.l0, l1 = c.l1;
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float d0 = 1.f / fmaxf(l0, 1e-30f), d1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
    for (int n = 0; n < C::PW / 8; ++n) {
      const int col = 8 * n + 2 * c.t4;
      unsigned char* half = sbase + (col / BOX) * C::Q_HALF;
      *reinterpret_cast<uint32_t*>(half + sw128_offset(r0, col % BOX)) =
          pack_bf16(c.acc[4 * n] * d0, c.acc[4 * n + 1] * d0);
      *reinterpret_cast<uint32_t*>(half + sw128_offset(r0 + 8, col % BOX)) =
          pack_bf16(c.acc[4 * n + 2] * d1, c.acc[4 * n + 3] * d1);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync 1, %0;" ::"n"(2 * WG) : "memory");
    if (threadIdx.x == 0) {
#pragma unroll
      for (int h = 0; h < C::HALVES; ++h)
        tma_store(&to, sq + h * C::Q_HALF, h * BOX, h0, q0, b);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime, so the
// library needs no link against libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 [B, S, heads, dh] tensor as a 4-D map (dh innermost) with boxes
// of (64, box_heads, box_rows, 1) and the 128-byte swizzle.
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int B,
              int S, int heads, int dh, int box_heads, int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)dh * 2,
                                 (cuuint64_t)heads * dh * 2,
                                 (cuuint64_t)S * heads * dh * 2};
  const cuuint32_t box[4] = {(cuuint32_t)BOX, (cuuint32_t)box_heads,
                             (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(ptr), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
int launch_dh(const void* q, const void* k, const void* v, void* o, int B,
              int Sq, int Sk, int H, int KV, int causal, float scale,
              int drop_tile, int gh, cudaStream_t stream) {
  using C = WCfg<DH>;
  const int G = H / KV;
  // GH heads x BQ positions a CTA, G / GH chunks side by side
  const int GH = gh;
  if (G > ROWS || GH < 1 || GH > ROWS || G % GH != 0 ||
      (long long)B * KV > 65535)
    return cudaErrorInvalidValue;
  const int BQ = ROWS / GH, NCH = G / GH;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  // with no keys nothing reads k or v: q stands in as a valid base
  const int Skm = Sk > 0 ? Sk : 1;
  const void* kb = Sk > 0 ? k : q;
  const void* vb = Sk > 0 ? v : q;
  CUtensorMap tq, tk, tv, to;
  if (!make_map(enc, &tq, q, B, Sq, H, DH, GH, BQ) ||
      !make_map(enc, &tk, kb, B, Skm, KV, DH, 1, BK) ||
      !make_map(enc, &tv, vb, B, Skm, KV, DH, 1, BK) ||
      !make_map(enc, &to, o, B, Sq, H, DH, GH, BQ))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ * NCH, B * KV);
  flash_wgmma_kernel<DH><<<grid, NTH, C::SMEM, stream>>>(
      tq, tk, tv, to, Sq, Sk, KV, G, GH, BQ, NCH, causal, scale * LOG2E,
      drop_tile);
  return cudaGetLastError();
}

}  // namespace

// Called by flash_attention_launch (flash_attention.cu) for bf16 at dh 64,
// 112 or 128 on 16-byte aligned bases: one launch on `stream`, gh query
// heads a CTA (a divisor of G up to 128; kernel.py::wgmma_packing);
// drop_tile >= 0 leaves that key tile out (a planted fault for the checks'
// control).
int flash_wgmma_launch(const void* q, const void* k, const void* v, void* o,
                       int B, int Sq, int Sk, int H, int KV, int dh,
                       int causal, float scale, int drop_tile, int gh,
                       cudaStream_t stream) {
  if (dh == 64)
    return launch_dh<64>(q, k, v, o, B, Sq, Sk, H, KV, causal, scale,
                         drop_tile, gh, stream);
  if (dh == 112)
    return launch_dh<112>(q, k, v, o, B, Sq, Sk, H, KV, causal, scale,
                          drop_tile, gh, stream);
  if (dh == 128)
    return launch_dh<128>(q, k, v, o, B, Sq, Sk, H, KV, causal, scale,
                          drop_tile, gh, stream);
  return cudaErrorInvalidValue;
}

// Rows (position, head) of one CTA: the largest G the body serves.
int flash_wgmma_max_group() { return ROWS; }
