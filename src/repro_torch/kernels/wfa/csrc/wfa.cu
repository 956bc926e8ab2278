// Batched WFA (gap-affine / gap-linear / edit) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/wfa/kernel.py::wfa_pallas
// (body _make_kernel), its score variant (trace=False) and its packed-trace
// variant (trace=True), on the compacting band, band_cap set
// (wfa_band_kernel), and at full width (wfa_full_kernel).  Same inputs, same
// outputs, bit for bit: score [B,1] (-1 over s_max), steps [B,1] (the
// block's exit step) and, with TRACE, the [NW, B, k_pad] int32 words of
// 2-bit provenance codes (16 score steps per word).
//
// Both kernels run one CTA per block of BP pairs, whose pairs step in
// lockstep until none is unresolved (or s passes s_max); settled pairs keep
// adding codes until then.  Each score step reads rows s-x, s-(o+e), s-e of
// the rings at lanes k, k-1, k+1, forms X/I/D, extends M along its diagonal
// (eight byte characters a compare), ORs the 2-bit codes of the pre-prune
// fronts into the step's word, stores the fronts into row s and feeds the
// per-pair reductions (target reached; AdaptiveBand's min and count;
// ZDrop's max); after a barrier a heuristic clears the lanes it prunes (M's
// mask prunes I and D too).  Row s is never read during step s (every delta
// is >= 1 and below the ring's depth), so the step may write it in place.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG = -(1 << 20);
constexpr int THRESH = NEG / 2;
constexpr int BIG = 1 << 20;
constexpr int CELLS_PER_WORD = 16;

enum Heur { HEUR_NONE = 0, HEUR_ADAPTIVE = 1, HEUR_ZDROP = 2 };

size_t ring_bytes(int BP, int width, int W, int affine) {
  return (size_t)(affine ? 3 : 1) * W * BP * width * sizeof(int);
}

// Whether `bytes` fit in the shared memory one block may opt into on the
// current device (227 KB on Hopper).
bool fits_smem(size_t bytes) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return false;
  return bytes <= (size_t)optin;
}

__device__ __forceinline__ int extend(int M, int k, const int* __restrict__ prow,
                                      const int* __restrict__ trow, int pl,
                                      int tl) {
  if (M <= THRESH) return M;
  int v = M - k;
  while (M >= 0 && M < tl && v >= 0 && v < pl && trow[M] == prow[v]) {
    ++M;
    ++v;
  }
  return M;
}

// Eight characters from byte i on: three aligned words, funnel-shifted (the
// first character in the lowest byte).
__device__ __forceinline__ uint64_t load8(const uint8_t* row, int i) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(row + (i & ~3));
  const int sh = (i & 3) * 8;
  const uint32_t w0 = w[0], w1 = w[1], w2 = w[2];
  return (uint64_t)__funnelshift_r(w1, w2, sh) << 32 |
         __funnelshift_r(w0, w1, sh);
}

// extend() on byte rows, eight characters per compare: the first differing
// byte of the XOR ends the run.
__device__ __forceinline__ int extend(int M, int k, const uint8_t* prow,
                                      const uint8_t* trow, int pl, int tl) {
  if (M <= THRESH) return M;
  int v = M - k;
  if (M < 0 || v < 0) return M;
  while (M < tl && v < pl) {
    const uint64_t x = load8(trow, M) ^ load8(prow, v);
    const int n = min(8, min(tl - M, pl - v));
    const int eq = x ? (__ffsll((long long)x) - 1) >> 3 : 8;
    if (eq < n) return M + eq;
    M += n;
    v += n;
  }
  return M;
}

// One cell's step from its ring reads (rows s-x, s-(o+e), s-e at lanes k,
// k-1, k+1): the bounded I/D/X candidates, M after the extension and the
// 2-bit codes of the pre-prune fronts (tie-break X, I, D; extend over
// open).  A linear model passes its M_{s-e} neighbours as i_open / d_open
// and NEG as i_ext / d_ext.
struct Cell {
  int M, I, D;
  uint32_t cm, ci, cd;
};

template <bool AFFINE, typename Ch>
__device__ __forceinline__ Cell step_cell(int m_x, int i_open, int i_ext,
                                          int d_open, int d_ext, int k, int pl,
                                          int tl, const Ch* __restrict__ prow,
                                          const Ch* __restrict__ trow) {
  const int i_src = max(i_open, i_ext), d_src = max(d_open, d_ext);
  Cell r;
  r.I = (i_src > THRESH && i_src + 1 <= tl) ? i_src + 1 : NEG;
  r.D = (d_src > THRESH && d_src - k <= pl) ? d_src : NEG;
  const int X = (m_x > THRESH && m_x + 1 <= tl && m_x + 1 - k <= pl)
                    ? m_x + 1 : NEG;
  const int Mpre = max(max(X, r.I), r.D);
  r.M = extend(Mpre, k, prow, trow, pl, tl);
  r.cm = Mpre > THRESH ? (Mpre == X ? 1u : (Mpre == r.I ? 2u : 3u)) : 0u;
  r.ci = AFFINE && r.I > THRESH ? (i_ext >= i_open ? 2u : 1u) : 0u;
  r.cd = AFFINE && r.D > THRESH ? (d_ext >= d_open ? 2u : 1u) : 0u;
  return r;
}

// After the step's reductions: whether the heuristic keeps a cell whose M
// is `M` (keep_mask).
template <int HEUR>
__device__ __forceinline__ bool heur_keep(int M, int k, int pl, int tl,
                                          int red, int live, int hp1,
                                          int hp2) {
  if (M <= THRESH) return false;
  if (HEUR == HEUR_ADAPTIVE)
    return live <= hp1 || max(tl - M, pl - (M - k)) - red <= hp2;
  if (HEUR == HEUR_ZDROP) return red - (2 * M - k) <= hp1;
  return true;
}

// ---------------------------------------------------------------------------
// The compacting band (TPU kernel 3: wfa_pallas with band_cap,
// repro/kernels/wfa/kernel.py:185-207, :239-253).
//
// What it computes.  Rings KC lanes wide ([W, BP, KC]) in a window that
// slides along the k_pad diagonals, one window per block of BP pairs as on
// the TPU: each step the offset re-centres on the live lanes (M|I|D) of the
// block's previous row, its lowest and highest compact lane over all BP
// pairs, settled pairs included; reads of an older row realign by the offset
// delta (NEG outside [0, KC); the +-1 neighbours are read inside the compact
// width first, so the window's edge lanes read NEG, as the TPU kernel's
// shifts do); the target test, the extension and the heuristics use the
// absolute diagonal k = j + off - k_pad/2; codes land at absolute lane
// off + j of the [NW, B, k_pad] planes.  The block's pairs step in lockstep
// until none is unresolved (or s passes s_max), and settled pairs keep
// adding codes until then: the per-block window and exit are the contract
// (a per-pair window changes scores once a block's live span outgrows KC).
//
// What bounds it.  A block is a serial chain of steps (1,489 for block 0 of
// the 10 kb pass-1 wave); each step does about 24 integer operations per
// window cell (five realigned ring reads with their range checks, the
// bounded X / I / D candidates, two maxima, the target test, three stores;
// chip_smoke.py's BAND_OPS_PER_CELL) plus the character compares of the
// extension.  One CTA of 1,024 threads per block holds an SM (128 blocks on
// 132 SMs at 10 kb), so the time is a step's latency: the instructions its
// 32 warps issue on the SM's four schedulers, the longest extension in the
// block and the barriers.  Measured (band_variants.py's phase_clock): the
// phase after the first barrier, though short, takes as long as the rest.
//
// Design.  One CTA per block; lanes per pair rounded up to whole warps
// (KCP, the extra lanes idle), so each warp's 32 cells belong to one pair.
//   * Only live warps work.  Each ring row keeps, per pair, the absolute
//     lanes of its live span (s_span, filled by the step that writes the
//     row); a step's lanes can only come from the spans of the rows it reads
//     (one lane either side for the gaps), so a warp outside them does
//     nothing, and a read outside its row's span is NEG (lanes outside a
//     row's span hold stale values: they are never stored).
//   * Characters narrowed to bytes in the prologue (the wrapper holds every
//     code in [0, 255], so bytes compare exactly as the ints do), eight
//     compared per trip of the extension (three aligned words per row,
//     funnel-shifted, XORed, the first differing byte by __ffsll).
//   * Rings in a global scratch that L1 serves, characters in shared
//     memory where they fit (band_layout): at 10 kb (8 x 2 x 10,036 bytes
//     of characters, 110,592 bytes of affine rings) that measured faster
//     than the rings in shared memory and the characters through L1
//     (band_variants.py); characters past the shared-memory size go to
//     global scratch too.
//   * Per-pair and per-block reductions by warp: __reduce_*_sync over a
//     warp's cells (the target reached, AdaptiveBand's min and count,
//     ZDrop's max, the live span), then one shared atomic per warp and value
//     into small rings indexed by s (each slot reset a step before it is
//     filled); the block's live span gets its own pair of atomics, so the
//     top of a step reads one word for the window and one mask for the exit
//     (pairs still open, kept by warp 0, which also settles the scores).
//     One barrier per step without a heuristic, two with one (the prune
//     needs the pair's totals).
//   * Each step's ring rows ((s - delta) mod W, counters) and offsets are
//     read once per step, not per read.
//   * Trace codes staged on chip: each 16-step word is ORed into shared
//     memory by absolute lane modulo SW (a power of two >= 2 KCP) and its
//     nonzero words written to the planes with plain stores at the word's
//     end (the wrapper zeroes the planes); if the word's windows outgrow SW
//     lanes the staged part is ORed into the planes early.  No load from
//     device memory in a step.
constexpr int BAND_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;
constexpr int EMPTY_LO = 1 << 28;   // a span (lo, hi) = (EMPTY_LO, -EMPTY_LO)
constexpr int STEP_SLOTS = 4;       // rings of per-step values, by s & 3

struct BandParams {
  const int* pattern;  // [B, Lp]
  const int* text;     // [B, Lt]
  const int* plen;     // [B]
  const int* tlen;     // [B]
  int* score;          // [B]
  int* steps;          // [B]
  uint32_t* bt[3];     // [NW, B, k_pad] code planes M, I, D (TRACE)
  int* grings;         // [nblk][planes][W][BP][KCP]
  uint8_t* gseq;       // [nblk][BP][rp + rt] unless in shared memory
  int B, Lp, Lt, BP, k_pad, KC, s_max, x, o, e, W, hp1, hp2, SW, seq_smem;
};

// Bytes of one row of L characters: rounded up to a word, plus the two
// words an 8-byte compare may read past its end.
__host__ __device__ inline int seq_row_bytes(int L) {
  return (L + 3) / 4 * 4 + 8;
}

__host__ __device__ inline int band_lanes(int kc) { return (kc + 31) & ~31; }

// Rows of live spans kept: a power of two above W, so the slot of row s is
// s & (D - 1) and the slot reset at step s (row s + 1) is none a step reads.
__host__ __device__ inline int span_depth(int W) {
  int d = 4;
  while (d < W + 1) d *= 2;
  return d;
}

// Ints of the kernel's small shared arrays (its layout in wfa_band_kernel).
__host__ __device__ inline int band_head_ints(int BP, int W) {
  const int NRW = (BP + 31) / 32;
  return 2 * span_depth(W) * BP + 2 * STEP_SLOTS + 3 * BP + W + 2 * NRW +
         STEP_SLOTS * NRW + 2 * STEP_SLOTS * BP;
}

// Where one launch keeps its characters, and what it needs.
struct BandLayout {
  size_t smem;              // dynamic shared bytes
  int seq_smem, SW;
  long long scratch_ints;   // global scratch of the whole launch
};

BandLayout band_layout(int B, int BP, int kc, int W, int affine, int trace,
                       int Lp, int Lt) {
  const int KCP = band_lanes(kc);
  BandLayout l{};
  l.SW = 1;
  while (l.SW < 2 * KCP) l.SW *= 2;
  l.smem = (size_t)band_head_ints(BP, W) * sizeof(int);
  if (trace) l.smem += (size_t)(affine ? 3 : 1) * BP * l.SW * sizeof(int);
  const size_t rings = ring_bytes(BP, KCP, W, affine);
  const size_t seq = (size_t)BP * (seq_row_bytes(Lp) + seq_row_bytes(Lt));
  if (fits_smem(l.smem + seq)) {
    l.seq_smem = 1;
    l.smem += seq;
  }
  const long long nblk = BP > 0 ? B / BP : 0;
  l.scratch_ints = nblk * (long long)(rings + (l.seq_smem ? 0 : seq)) / 4;
  return l;
}

__device__ __forceinline__ bool in_span(int a, int2 sp) {
  return a >= sp.x && a <= sp.y;
}

// Write the staged code words of `word` ([omin, omax + KC) absolute lanes)
// to the planes and clear them: plain stores, or ORs where part of the word
// was written before (orin).  Out of line: it runs once per 16 steps and
// keeps the step loop's code small.
__device__ __noinline__ void flush_word(uint32_t* stage, uint32_t* const bt0,
                                        uint32_t* const bt1,
                                        uint32_t* const bt2, int n_planes,
                                        int B, int KP, int BP, int KC, int SW,
                                        int word, int omin, int omax,
                                        bool orin) {
  const int span = omax - omin + KC, pair0 = blockIdx.x * BP;
#pragma unroll 1
  for (int it = threadIdx.x; it < BP * span; it += blockDim.x) {
    const int b = it / span, a = omin + (it - b * span);
    const size_t at = ((size_t)word * B + pair0 + b) * KP + a;
    const int si = b * SW + (a & (SW - 1));
#pragma unroll 1
    for (int pl = 0; pl < n_planes; ++pl) {
      uint32_t* st = stage + pl * BP * SW + si;
      const uint32_t v = *st;
      if (v) {
        uint32_t* bt = (pl == 0 ? bt0 : pl == 1 ? bt1 : bt2) + at;
        *st = 0u;
        if (orin)
          *bt |= v;
        else
          *bt = v;
      }
    }
  }
}

template <bool AFFINE, bool TRACE, int HEUR>
__global__ void __launch_bounds__(BAND_THREADS)
    wfa_band_kernel(const BandParams p) {
  extern __shared__ int smem[];
  const int BP = p.BP, KP = p.k_pad, W = p.W, KC = p.KC, SW = p.SW;
  const int KCP = band_lanes(KC), D = span_depth(W), NRW = (BP + 31) / 32;
  const int cells = BP * KCP;
  const int kc_full = KP / 2;
  const int pair0 = blockIdx.x * BP;
  const int tid = threadIdx.x, nthr = blockDim.x, lane = tid & 31;
  const int ncell = (cells + nthr - 1) / nthr;
  const int n_planes = AFFINE ? 3 : 1;
  const int b_0 = tid / KCP;              // the pair of this thread's cell 0

  // band_head_ints(BP, W) ints: the spans first (8-byte aligned)
  int2* s_span = reinterpret_cast<int2*>(smem);  // [D][BP] live lanes of rows
  int2* s_bsp = s_span + D * BP;          // [4] the block's live lanes of row s
  int* s_plen = reinterpret_cast<int*>(s_bsp + STEP_SLOTS);
  int* s_tlen = s_plen + BP;
  int* s_score = s_tlen + BP;             // [BP], settled by warp 0
  int* s_off = s_score + BP;              // [W] absolute lane of lane 0
  unsigned* s_open = reinterpret_cast<unsigned*>(s_off + W);  // [2][NRW]
  unsigned* s_reach = s_open + 2 * NRW;   // [4][NRW] pairs reached at step s
  int* s_red = reinterpret_cast<int*>(s_reach + STEP_SLOTS * NRW);  // [4][BP]
  int* s_live = s_red + STEP_SLOTS * BP;                            // [4][BP]
  uint32_t* stage = reinterpret_cast<uint32_t*>(s_live + STEP_SLOTS * BP);
  const size_t plane = (size_t)W * cells;
  int* ring = p.grings + (size_t)blockIdx.x * n_planes * plane;
  int* m_ring = ring;
  int* i_ring = ring + plane;
  int* d_ring = ring + 2 * plane;
  const int rp = seq_row_bytes(p.Lp), rpt = rp + seq_row_bytes(p.Lt);
  uint8_t* sq = p.seq_smem ? reinterpret_cast<uint8_t*>(
                                 stage + (TRACE ? n_planes * BP * SW : 0))
                           : p.gseq + (size_t)blockIdx.x * BP * rpt;
  const int red_init = HEUR == HEUR_ZDROP ? -BIG : BIG;
  const int off0 = min(max(kc_full - KC / 2, 0), KP - KC);
  const int2 empty = make_int2(EMPTY_LO, -EMPTY_LO);

  for (int i = tid; i < D * BP; i += nthr) s_span[i] = empty;
  if (tid < STEP_SLOTS) s_bsp[tid] = empty;
  for (int b = tid; b < BP; b += nthr) {
    // a length past its row would read out of bounds: clamp it to the row
    s_plen[b] = min(p.plen[pair0 + b], p.Lp);
    s_tlen[b] = min(p.tlen[pair0 + b], p.Lt);
    s_score[b] = -1;
  }
  for (int r = tid; r < W; r += nthr) s_off[r] = off0;
  for (int w = tid; w < NRW; w += nthr)   // every pair open before step 0
    s_open[w] = w < BP / 32 ? FULL : (1u << (BP & 31)) - 1u;
  for (int i = tid; i < STEP_SLOTS * NRW; i += nthr) s_reach[i] = 0u;
  for (int i = tid; i < STEP_SLOTS * BP; i += nthr) {
    s_red[i] = red_init;
    s_live[i] = 0;
  }
  if (TRACE)
    for (int i = tid; i < n_planes * BP * SW; i += nthr) stage[i] = 0u;
  __syncthreads();
  // the characters up to each length, narrowed to bytes, four per store
  for (int b = 0; b < BP; ++b) {
    const int* src[2] = {p.pattern + (size_t)(pair0 + b) * p.Lp,
                         p.text + (size_t)(pair0 + b) * p.Lt};
    const int len[2] = {s_plen[b], s_tlen[b]};
    uint32_t* dst[2] = {reinterpret_cast<uint32_t*>(sq + (size_t)b * rpt),
                        reinterpret_cast<uint32_t*>(sq + (size_t)b * rpt + rp)};
#pragma unroll
    for (int r = 0; r < 2; ++r)
      for (int w = tid; 4 * w < len[r]; w += nthr) {
        uint32_t v = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (4 * w + i < len[r])
            v |= (uint32_t)(__ldg(src[r] + 4 * w + i) & 0xff) << (8 * i);
        dst[r][w] = v;
      }
  }
  __syncthreads();

  // One warp's share of its pair's per-step values: lane 0 adds the warp's
  // reductions to the slots of step (reach) and row (spans).
  auto add_reach = [&](int sl, int b, bool reached) {
    if (__any_sync(FULL, reached) && lane == 0)
      atomicOr(&s_reach[sl * NRW + (b >> 5)], 1u << (b & 31));
  };
  auto add_span = [&](int sl, int row_slot, int b, bool live, int a) {
    const int lo = __reduce_min_sync(FULL, live ? a : EMPTY_LO);
    const int hi = __reduce_max_sync(FULL, live ? a : -EMPTY_LO);
    if (lane == 0 && hi >= lo) {
      atomicMin(&s_span[row_slot * BP + b].x, lo);
      atomicMax(&s_span[row_slot * BP + b].y, hi);
      atomicMin(&s_bsp[sl].x, lo);
      atomicMax(&s_bsp[sl].y, hi);
    }
  };

  // s = 0: M_0[k=0] = LCP(p, t); I/D invalid.  Its reach and live span
  // feed the top of step 1.
#pragma unroll 1
  for (int q = 0; q < ncell; ++q) {
    const int c = tid + q * nthr;
    if (c >= cells) break;                // warp-uniform: cells % 32 == 0
    const int b = c / KCP, j = c - b * KCP, k = j + off0 - kc_full;
    const int pl = s_plen[b], tl = s_tlen[b];
    const uint8_t* prow = sq + (size_t)b * rpt;
    const int M = j < KC ? extend(k == 0 ? 0 : NEG, k, prow, prow + rp, pl, tl)
                         : NEG;
    m_ring[c] = M;
    if (AFFINE) i_ring[c] = d_ring[c] = NEG;
    const bool live = M > THRESH;
    add_reach(0, b, live && k == tl - pl && M >= tl);
    add_span(0, 0, b, live, off0 + j);
  }
  __syncthreads();

  const int oe = AFFINE ? p.o + p.e : p.e;
  // ring rows of steps s - x, s - oe, s - e and s, counted mod W
  const auto wrap = [&](int r) { return ((r % W) + W) % W; };
  int rx = wrap(1 - p.x), rg = wrap(1 - oe), re = wrap(1 - p.e), rw = 1 % W;
  int off = off0;                         // the window of step s - 1
  int omin = off0, omax = off0;           // the windows of the open word
  bool wpart = false;                     // part of the open word written
  int s = 1;
  for (;; ++s) {
    // ---- settle step s-1's pairs (warp 0), the block's exit; reset the
    //      slots step s+1 fills ------------------------------------------------
    const int pv = (s - 1) & (STEP_SLOTS - 1);
    const int nx = (s + 1) & (STEP_SLOTS - 1);
    bool open = false;
#pragma unroll 1
    for (int w = 0; w < NRW; ++w) {
      const unsigned was = s_open[((s - 1) & 1) * NRW + w];
      const unsigned rc = s_reach[pv * NRW + w];
      open |= (was & ~rc) != 0u;
      if (tid < 32) {
        if ((was & rc) >> lane & 1u) s_score[32 * w + lane] = s - 1;
        if (lane == 0) {
          s_open[(s & 1) * NRW + w] = was & ~rc;
          s_reach[nx * NRW + w] = 0u;
        }
      }
    }
    if (tid < 32) {
#pragma unroll 1
      for (int i = lane; i < BP; i += 32) {
        s_span[((s + 1) & (D - 1)) * BP + i] = empty;
        s_red[nx * BP + i] = red_init;
        s_live[nx * BP + i] = 0;
      }
      if (lane == 0) s_bsp[nx] = empty;
    }
    const bool done = !open || s > p.s_max;
    if (TRACE && s >= 2 &&
        (done || (s - 1) % CELLS_PER_WORD == CELLS_PER_WORD - 1)) {
      // the word of step s-1 is complete (or the block exits); the stage
      // is clear before phase A writes it again
      flush_word(stage, p.bt[0], p.bt[1], p.bt[2], n_planes, p.B, KP, BP, KC,
                 SW, (s - 1) / CELLS_PER_WORD, omin, omax, wpart);
      if (!done) __syncthreads();
    }
    if (done) break;
    // ---- this step's window: re-centre on step s-1's live span -----------
    const int2 bs = s_bsp[pv];
    if (bs.y >= bs.x)
      off = min(max(off + (bs.x - off + bs.y - off) / 2 - KC / 2, 0),
                KP - KC);
    if (tid == 0) s_off[rw] = off;        // row s%W is not read in step s
    if (TRACE) {
      if (s % CELLS_PER_WORD == 0 || s == 1) {
        omin = omax = off;
        wpart = false;
      } else if (max(omax, off) - min(omin, off) + KC > SW) {
        // the word's windows outgrow the stage: write what it holds
        flush_word(stage, p.bt[0], p.bt[1], p.bt[2], n_planes, p.B, KP, BP,
                   KC, SW, s / CELLS_PER_WORD, omin, omax, wpart);
        omin = omax = off;
        wpart = true;
        __syncthreads();
      } else {
        omin = min(omin, off);
        omax = max(omax, off);
      }
    }
    const int ox = s_off[rx], og = s_off[rg], oee = s_off[re];
    const int row = rw * cells, sl = s & (STEP_SLOTS - 1);
    const int cur = s & (D - 1);
    const int sh = 2 * (s % CELLS_PER_WORD);
    // The spans of the rows step s reads for pair b, and whether the warp
    // of compact lanes [j0, j0 + 32) holds a lane they can reach.
    auto spans = [&](int b, int j0, int2& sx, int2& sg, int2& se) {
      sx = s_span[((s - p.x) & (D - 1)) * BP + b];
      sg = s_span[((s - oe) & (D - 1)) * BP + b];
      se = AFFINE ? s_span[((s - p.e) & (D - 1)) * BP + b] : sg;
      const int clo = min(sx.x, min(sg.x, se.x) - 1) - off;
      const int chi = max(sx.y, max(sg.y, se.y) + 1) - off;
      return clo <= j0 + 31 && chi >= j0 && j0 < KC;
    };
    bool act0 = false;                    // cell 0's warp works this step
    int m0 = NEG;                         // and its M before the prune
    // ---- phase A: candidates, extension, codes, unpruned store ----------
#pragma unroll 1
    for (int q = 0; q < ncell; ++q) {
      const int c = tid + q * nthr;
      if (c >= cells) break;
      const int b = q ? c / KCP : b_0, j = c - b * KCP;
      int2 sx, sg, se;
      if (!spans(b, j - lane, sx, sg, se)) continue;   // warp-uniform
      const int k = j + off - kc_full, a = j + off;
      const int pl = s_plen[b], tl = s_tlen[b];
      const int bo = b * KCP;
      Cell st{NEG, NEG, NEG, 0u, 0u, 0u};
      if (j < KC) {
        const bool lok = j >= 1, hok = j + 1 < KC;
        // the five reads unconditional, each index clamped into the pair's
        // row, the spans selecting NEG after: independent loads that issue
        // together
        const auto at = [&](int r, int i) {
          return r * cells + bo + min(max(i, 0), KCP - 1);
        };
        const int v_x = m_ring[at(rx, a - ox)];
        const int v_io = m_ring[at(rg, a - 1 - og)];
        const int v_do = m_ring[at(rg, a + 1 - og)];
        const int v_ie = AFFINE ? i_ring[at(re, a - 1 - oee)] : NEG;
        const int v_de = AFFINE ? d_ring[at(re, a + 1 - oee)] : NEG;
        const int m_x = in_span(a, sx) ? v_x : NEG;
        const int i_open = lok && in_span(a - 1, sg) ? v_io : NEG;
        const int d_open = hok && in_span(a + 1, sg) ? v_do : NEG;
        int i_ext = NEG, d_ext = NEG;
        if (AFFINE) {
          if (lok && in_span(a - 1, se)) i_ext = v_ie;
          if (hok && in_span(a + 1, se)) d_ext = v_de;
        }
        const uint8_t* prow = sq + (size_t)b * rpt;
        st = step_cell<AFFINE>(m_x, i_open, i_ext, d_open, d_ext, k, pl, tl,
                               prow, prow + rp);
        if (TRACE) {
          // ci and cd are 0 for linear models
          uint32_t* at = stage + b * SW + (a & (SW - 1));
          if (st.cm) at[0] |= st.cm << sh;
          if (st.ci) at[BP * SW] |= st.ci << sh;
          if (st.cd) at[2 * BP * SW] |= st.cd << sh;
        }
      }
      m_ring[row + c] = st.M;
      if (AFFINE) {
        i_ring[row + c] = st.I;
        d_ring[row + c] = st.D;
      }
      if (q == 0) {
        act0 = true;
        m0 = st.M;
      }
      const bool live = st.M > THRESH;
      add_reach(sl, b, live && k == tl - pl && st.M >= tl);
      if (HEUR == HEUR_ADAPTIVE) {
        const int red = __reduce_min_sync(
            FULL, live ? max(tl - st.M, pl - (st.M - k)) : BIG);
        const int n = __reduce_add_sync(FULL, live ? 1 : 0);
        if (lane == 0 && n) {
          atomicMin(&s_red[sl * BP + b], red);
          atomicAdd(&s_live[sl * BP + b], n);
        }
      } else if (HEUR == HEUR_ZDROP) {
        const int red = __reduce_max_sync(FULL, live ? 2 * st.M - k : -BIG);
        if (lane == 0 && red != -BIG) atomicMax(&s_red[sl * BP + b], red);
      } else {
        add_span(sl, cur, b,
                 live || (AFFINE && (st.I > THRESH || st.D > THRESH)), a);
      }
    }
    __syncthreads();
    if constexpr (HEUR != HEUR_NONE) {
      // ---- phase B: prune on the pair's totals, the row's live span ------
#pragma unroll 1
      for (int q = 0; q < ncell; ++q) {
        const int c = tid + q * nthr;
        if (c >= cells) break;
        const int b = q ? c / KCP : b_0, j = c - b * KCP;
        int2 sx, sg, se;
        if (q ? !spans(b, j - lane, sx, sg, se) : !act0) continue;
        const int k = j + off - kc_full;
        const int M = q ? m_ring[row + c] : m0;
        // M's mask prunes I and D too: a kept lane has a live M
        const bool keep =
            j < KC && heur_keep<HEUR>(M, k, s_plen[b], s_tlen[b],
                                      s_red[sl * BP + b], s_live[sl * BP + b],
                                      p.hp1, p.hp2);
        if (!keep && M > THRESH) {
          m_ring[row + c] = NEG;
          if (AFFINE) i_ring[row + c] = d_ring[row + c] = NEG;
        }
        add_span(sl, cur, b, keep, j + off);
      }
      __syncthreads();
    }
    rx = rx + 1 == W ? 0 : rx + 1;
    rg = rg + 1 == W ? 0 : rg + 1;
    re = re + 1 == W ? 0 : re + 1;
    rw = rw + 1 == W ? 0 : rw + 1;
  }
  // warp 0 settled the scores at the top of step s
  __syncthreads();
  for (int b = tid; b < BP; b += nthr) {
    p.score[pair0 + b] = s_score[b];
    p.steps[pair0 + b] = s;
  }
}

// ---------------------------------------------------------------------------
// Full width (TPU kernels 1 and 2: wfa_pallas without band_cap,
// repro/kernels/wfa/kernel.py:110-331).
//
// What it computes.  k_pad diagonal lanes per pair, centred at k_pad/2, as
// the band above with a window that never moves and covers every lane a
// front can reach.
//
// What bounds it.  As the band: a block is a serial chain of steps, each
// about 24 integer operations per reachable cell (chip_smoke.py's
// BAND_OPS_PER_CELL) plus the compares of the extension; at 100 bp the
// steps are few (under 39) and short, so the blocks resident on an SM and
// the latency of a step's barriers set the rate; at 10 kb exact the live
// span grows by a lane either side every e steps (about 1,500 lanes a pair
// at the exit), and the ring traffic of the live lanes is the step.
//
// Design.
//   * Static lanes.  No front reaches past [lo, lo + KC), the hull up to
//     s_max of kernel.meet_band's forward M range (kernel.full_lanes: kc +-
//     16 of 128 lanes at the 100 bp pass 1, all of k_pad at 10 kb): rings
//     and threads cover KCP = KC rounded up to 32 lanes a pair, in
//     chunks of 32; lanes past KC are never live and get no code, as the TPU
//     kernel's edge lanes.
//   * Only live chunks work.  Per pair and ring row, the live span (as the
//     band keeps it); a warp works on a chunk only where the spans of the
//     rows the step reads reach it (one lane either side for the gaps), a
//     read outside its row's span is NEG (lanes outside a span are never
//     stored), and without TRACE a settled pair's warps do nothing.
//   * wpp warps per pair (1 at 100 bp: 256 threads a block of 8 pairs; 4 at
//     10 kb), each on every wpp-th reachable chunk of its pair; with more
//     than 32 pairs a block, each warp takes every 32nd pair.
//   * Characters narrowed to bytes in the prologue, eight compared a trip;
//     a block that holds a code outside [0, 255] (found in the prologue) runs
//     the same body on its int32 rows, so every code is exact without a
//     check on the host.
//   * Rings of depth W for M and e + 1 for I and D (the 100 bp pass 1: 30,720
//     bytes), in shared memory after the characters where they fit, else in
//     global scratch.
//   * Per-pair reductions by warp (__reduce_*_sync over the warp's chunks of
//     the pair), one shared atomic per warp and value into small rings
//     indexed by s; the open pairs a bit mask kept by warp 0, which settles
//     the scores.  One barrier a step without a heuristic, two with one.
//   * Each nonzero code ORed straight into its word of the planes by
//     atomicOr, a reduction at L2 that the thread does not wait for (the
//     wrapper zeroes the planes): at 100 bp as fast as staging the words in
//     shared memory and storing them once per 16 steps, which cannot hold
//     the words of a 10 kb block, and faster than a load and a store
//     (full_variants.py, PERF.md).  Any BP x k_pad runs.
constexpr int FULL_THREADS = 1024;
constexpr int FULL_WARPS_PER_PAIR = 4;   // at most

struct FullParams {
  const int* pattern;  // [B, Lp]
  const int* text;     // [B, Lt]
  const int* plen;     // [B]
  const int* tlen;     // [B]
  int* score;          // [B]
  int* steps;          // [B]
  uint32_t* bt[3];     // [NW, B, k_pad] code planes M, I, D (TRACE)
  int* grings;         // [nblk][full_ring_ints] unless in shared memory
  uint8_t* gseq;       // [nblk][BP][rp + rt] unless in shared memory
  int B, Lp, Lt, BP, k_pad, lo, KC, s_max, x, o, e, Wm, Wg, hp1, hp2, wpp;
  int rings_smem, seq_smem;
};

// Ints of a block's rings: M of depth Wm, I and D of depth Wg.
__host__ __device__ inline int full_ring_ints(int BP, int KCP, int Wm, int Wg,
                                              bool affine) {
  return (Wm + (affine ? 2 * Wg : 0)) * BP * KCP;
}

// Ints of the kernel's small shared arrays (its layout in wfa_full_kernel).
__host__ __device__ inline int full_head_ints(int BP, int Wm) {
  const int NRW = (BP + 31) / 32;
  return 2 * span_depth(Wm) * BP + 3 * BP + (2 + STEP_SLOTS) * NRW +
         2 * STEP_SLOTS * BP;
}

// One launch's shape: threads, where its arrays live, what it needs.
struct FullLayout {
  int threads, wpp, rings_smem, seq_smem;
  size_t smem;              // dynamic shared bytes
  long long scratch_ints;   // global scratch of the whole launch
};

FullLayout full_layout(int B, int BP, int KC, int Wm, int Wg, int affine,
                       int Lp, int Lt) {
  const int KCP = band_lanes(KC), nch = KCP / 32;
  FullLayout l{};
  l.wpp = min(FULL_WARPS_PER_PAIR, max(1, nch / 2));
  l.wpp = min(l.wpp, max(1, 32 / BP));
  l.threads = 32 * (BP < 32 ? BP * l.wpp : 32);
  const size_t seq = (size_t)BP * (seq_row_bytes(Lp) + seq_row_bytes(Lt));
  const size_t rings =
      (size_t)full_ring_ints(BP, KCP, Wm, Wg, affine) * sizeof(int);
  // shared memory for the characters first, then the rings
  l.smem = (size_t)full_head_ints(BP, Wm) * sizeof(int);
  l.seq_smem = fits_smem(l.smem + seq);
  l.smem += l.seq_smem ? seq : 0;
  l.rings_smem = fits_smem(l.smem + rings);
  l.smem += l.rings_smem ? rings : 0;
  const long long nblk = BP > 0 ? B / BP : 0;
  l.scratch_ints = nblk * (long long)((l.rings_smem ? 0 : rings) +
                                      (l.seq_smem ? 0 : seq)) / 4;
  return l;
}

template <bool AFFINE, bool TRACE, int HEUR>
__global__ void __launch_bounds__(FULL_THREADS)
    wfa_full_kernel(const FullParams p) {
  extern __shared__ int smem[];
  const int BP = p.BP, KP = p.k_pad, KC = p.KC, KCP = band_lanes(KC);
  const int Wm = p.Wm, Wg = p.Wg, D = span_depth(Wm), NRW = (BP + 31) / 32;
  const int kc_full = KP / 2, lo = p.lo, pair0 = blockIdx.x * BP;
  const int tid = threadIdx.x, nthr = blockDim.x, lane = tid & 31;
  const int wpp = p.wpp, sub = (tid >> 5) % wpp;
  const int b_first = (tid >> 5) / wpp, b_step = (nthr >> 5) / wpp;
  constexpr int n_planes = AFFINE ? 3 : 1;
  const int row_ints = BP * KCP;          // one ring row of the block

  // full_head_ints(BP, Wm) ints: the spans first (8-byte aligned)
  int2* s_span = reinterpret_cast<int2*>(smem);  // [D][BP] live lanes of rows
  int* s_plen = reinterpret_cast<int*>(s_span + D * BP);
  int* s_tlen = s_plen + BP;
  int* s_score = s_tlen + BP;             // [BP], settled by warp 0
  unsigned* s_open = reinterpret_cast<unsigned*>(s_score + BP);  // [2][NRW]
  unsigned* s_reach = s_open + 2 * NRW;   // [4][NRW] pairs reached at step s
  int* s_red = reinterpret_cast<int*>(s_reach + STEP_SLOTS * NRW);  // [4][BP]
  int* s_live = s_red + STEP_SLOTS * BP;                            // [4][BP]
  // then the characters and the rings, each where it fits
  uint8_t* dyn = reinterpret_cast<uint8_t*>(s_live + STEP_SLOTS * BP);
  const int rp = seq_row_bytes(p.Lp), rpt = rp + seq_row_bytes(p.Lt);
  uint8_t* sq = p.gseq + (size_t)blockIdx.x * BP * rpt;
  if (p.seq_smem) {
    sq = dyn;
    dyn += (size_t)BP * rpt;
  }
  const int ring_n = full_ring_ints(BP, KCP, Wm, Wg, AFFINE);
  int* mr = p.grings + (size_t)blockIdx.x * ring_n;
  if (p.rings_smem) {
    mr = reinterpret_cast<int*>(dyn);
    dyn += (size_t)ring_n * sizeof(int);
  }
  int* ir = mr + Wm * row_ints;
  int* dr = ir + Wg * row_ints;
  const int red_init = HEUR == HEUR_ZDROP ? -BIG : BIG;
  const int2 empty = make_int2(EMPTY_LO, -EMPTY_LO);

  for (int i = tid; i < D * BP; i += nthr) s_span[i] = empty;
  for (int b = tid; b < BP; b += nthr) {
    // a length past its row would read out of bounds: clamp it to the row
    s_plen[b] = min(p.plen[pair0 + b], p.Lp);
    s_tlen[b] = min(p.tlen[pair0 + b], p.Lt);
    s_score[b] = -1;
  }
  for (int w = tid; w < NRW; w += nthr)   // every pair open before step 0
    s_open[w] = w < BP / 32 ? FULL : (1u << (BP & 31)) - 1u;
  for (int i = tid; i < STEP_SLOTS * NRW; i += nthr) s_reach[i] = 0u;
  for (int i = tid; i < STEP_SLOTS * BP; i += nthr) {
    s_red[i] = red_init;
    s_live[i] = 0;
  }
  __syncthreads();
  // the characters up to each length, narrowed to bytes, four per store, in
  // one pass over (pair, row, word); a code outside [0, 255] makes the
  // block compare its int32 rows instead
  bool wide_here = false;
  const int row_words = (max(p.Lp, p.Lt) + 3) / 4;
#pragma unroll 1
  for (int i = tid; i < 2 * BP * row_words; i += nthr) {
    const int b = i / (2 * row_words), r = i / row_words - 2 * b;
    const int w = i - (2 * b + r) * row_words;
    const int len = r ? s_tlen[b] : s_plen[b];
    if (4 * w >= len) continue;
    const int* src = r ? p.text + (size_t)(pair0 + b) * p.Lt
                       : p.pattern + (size_t)(pair0 + b) * p.Lp;
    uint32_t v = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (4 * w + c < len) {
        const int ch = __ldg(src + 4 * w + c);
        wide_here |= (unsigned)ch > 255u;
        v |= (uint32_t)(ch & 0xff) << (8 * c);
      }
    reinterpret_cast<uint32_t*>(sq + (size_t)b * rpt + (r ? rp : 0))[w] = v;
  }
  const bool wide = __syncthreads_or(wide_here);

  // s = 0: M_0[k=0] = LCP(p, t) on lane kc; I/D invalid.  Its reach and
  // live span feed the top of step 1.
  for (int b = tid; b < BP; b += nthr) {
    const int pl = s_plen[b], tl = s_tlen[b], at = b * KCP + kc_full - lo;
    const uint8_t* prow = sq + (size_t)b * rpt;
    const int M =
        wide ? extend(0, 0, p.pattern + (size_t)(pair0 + b) * p.Lp,
                      p.text + (size_t)(pair0 + b) * p.Lt, pl, tl)
             : extend(0, 0, prow, prow + rp, pl, tl);
    mr[at] = M;
    if (AFFINE) ir[at] = dr[at] = NEG;
    s_span[b] = make_int2(kc_full, kc_full);
    if (pl == tl && M >= tl) atomicOr(&s_reach[b >> 5], 1u << (b & 31));
  }
  __syncthreads();

  const int oe = AFFINE ? p.o + p.e : p.e;
  // ring rows of steps s - x, s - oe and s (M), s - e and s (I, D)
  const auto wrap = [](int r, int n) { return ((r % n) + n) % n; };
  int m_rx = wrap(1 - p.x, Wm), m_rg = wrap(1 - oe, Wm), m_rw = 1 % Wm;
  int g_re = AFFINE ? wrap(1 - p.e, Wg) : 0, g_rw = AFFINE ? 1 % Wg : 0;
  int s;
  for (s = 1;; ++s) {
    // ---- settle step s-1's pairs (warp 0), the block's exit; reset the
    //      slots step s+1 fills ------------------------------------------
    const int pv = (s - 1) & (STEP_SLOTS - 1);
    const int nx = (s + 1) & (STEP_SLOTS - 1);
    bool open = false;
#pragma unroll 1
    for (int w = 0; w < NRW; ++w) {
      const unsigned was = s_open[((s - 1) & 1) * NRW + w];
      const unsigned rc = s_reach[pv * NRW + w];
      open |= (was & ~rc) != 0u;
      if (tid < 32) {
        if ((was & rc) >> lane & 1u) s_score[32 * w + lane] = s - 1;
        if (lane == 0) {
          s_open[(s & 1) * NRW + w] = was & ~rc;
          s_reach[nx * NRW + w] = 0u;
        }
      }
    }
    if (tid < 32) {
#pragma unroll 1
      for (int i = lane; i < BP; i += 32) {
        s_span[((s + 1) & (D - 1)) * BP + i] = empty;
        s_red[nx * BP + i] = red_init;
        s_live[nx * BP + i] = 0;
      }
    }
    const bool done = !open || s > p.s_max;
    if (done) break;

    const int sh = 2 * (s % CELLS_PER_WORD);
    const size_t word0 = (size_t)(s / CELLS_PER_WORD) * p.B;
    const int sl = s & (STEP_SLOTS - 1), cur = s & (D - 1);
    const int2* spx = s_span + ((s - p.x) & (D - 1)) * BP;
    const int2* spg = s_span + ((s - oe) & (D - 1)) * BP;
    const int2* spe = s_span + ((s - p.e) & (D - 1)) * BP;
    // Pair b's spans of the rows step s reads and its chunks they reach,
    // [c0, c1]; false when the pair has nothing to do this step (none, or,
    // without TRACE, the pair is settled).  Warp-uniform.
    const auto reach = [&](int b, int2& sx, int2& sg, int2& se, int& c0,
                           int& c1) {
      if (!TRACE) {
        const int w = b >> 5;
        const unsigned opn = s_open[((s - 1) & 1) * NRW + w] &
                             ~s_reach[pv * NRW + w];
        if (!(opn >> (b & 31) & 1u)) return false;
      }
      sx = spx[b];
      sg = spg[b];
      se = AFFINE ? spe[b] : sg;
      const int clo = max(min(sx.x, min(sg.x, se.x) - 1), lo);
      const int chi = min(max(sx.y, max(sg.y, se.y) + 1), lo + KC - 1);
      c0 = (clo - lo) >> 5;
      c1 = (chi - lo) >> 5;
      c0 += ((sub - c0) % wpp + wpp) % wpp;   // this warp's first chunk
      return clo <= chi;
    };
    // ---- phase A: candidates, extension, codes, unpruned store ----------
#pragma unroll 1
    for (int b = b_first; b < BP; b += b_step) {
      int2 sx, sg, se;
      int c0, c1;
      if (!reach(b, sx, sg, se, c0, c1)) continue;
      const int pl = s_plen[b], tl = s_tlen[b];
      const uint8_t* prow = sq + (size_t)b * rpt;
      const int* ipat = p.pattern + (size_t)(pair0 + b) * p.Lp;
      const int* itxt = p.text + (size_t)(pair0 + b) * p.Lt;
      const int bo = b * KCP;
      bool hit = false;
      int acc = HEUR == HEUR_ZDROP ? -BIG : BIG, n_live = 0;
      int a_lo = EMPTY_LO, a_hi = -EMPTY_LO;
#pragma unroll 1
      for (int ch = c0; ch <= c1; ch += wpp) {
        const int j = 32 * ch + lane, a = lo + j, k = a - kc_full;
        Cell st{NEG, NEG, NEG, 0u, 0u, 0u};
        if (j < KC) {
          // the five reads unconditional, each index clamped into the
          // pair's row, the spans selecting NEG after
          const auto rd = [&](const int* rg, int r, int i) {
            return rg[r * row_ints + bo + min(max(i, 0), KCP - 1)];
          };
          const int r_x = rd(mr, m_rx, j), r_io = rd(mr, m_rg, j - 1);
          const int r_do = rd(mr, m_rg, j + 1);
          const int r_ie = AFFINE ? rd(ir, g_re, j - 1) : NEG;
          const int r_de = AFFINE ? rd(dr, g_re, j + 1) : NEG;
          const int m_x = in_span(a, sx) ? r_x : NEG;
          const int i_open = in_span(a - 1, sg) ? r_io : NEG;
          const int d_open = in_span(a + 1, sg) ? r_do : NEG;
          const int i_ext = AFFINE && in_span(a - 1, se) ? r_ie : NEG;
          const int d_ext = AFFINE && in_span(a + 1, se) ? r_de : NEG;
          st = wide ? step_cell<AFFINE>(m_x, i_open, i_ext, d_open, d_ext, k,
                                        pl, tl, ipat, itxt)
                    : step_cell<AFFINE>(m_x, i_open, i_ext, d_open, d_ext, k,
                                        pl, tl, prow, prow + rp);
          if (TRACE) {
            // ci and cd are 0 for linear models
            const uint32_t code[3] = {st.cm, st.ci, st.cd};
#pragma unroll
            for (int q = 0; q < n_planes; ++q) {
              if (!code[q]) continue;
              atomicOr(&p.bt[q][(word0 + pair0 + b) * KP + a],
                       code[q] << sh);
            }
          }
        }
        mr[m_rw * row_ints + bo + j] = st.M;
        if (AFFINE) {
          ir[g_rw * row_ints + bo + j] = st.I;
          dr[g_rw * row_ints + bo + j] = st.D;
        }
        const bool live = st.M > THRESH;
        hit |= live && k == tl - pl && st.M >= tl;
        if (live) {
          if (HEUR == HEUR_ADAPTIVE) {
            acc = min(acc, max(tl - st.M, pl - (st.M - k)));
            ++n_live;
          } else if (HEUR == HEUR_ZDROP) {
            acc = max(acc, 2 * st.M - k);
          } else {
            a_lo = min(a_lo, a);
            a_hi = max(a_hi, a);
          }
        }
      }
      // the warp's share of its pair's sums: one shared atomic a value
      if (__any_sync(FULL, hit) && lane == 0)
        atomicOr(&s_reach[sl * NRW + (b >> 5)], 1u << (b & 31));
      if (HEUR == HEUR_ADAPTIVE) {
        const int red = __reduce_min_sync(FULL, acc);
        const int n = __reduce_add_sync(FULL, n_live);
        if (lane == 0 && n) {
          atomicMin(&s_red[sl * BP + b], red);
          atomicAdd(&s_live[sl * BP + b], n);
        }
      } else if (HEUR == HEUR_ZDROP) {
        const int red = __reduce_max_sync(FULL, acc);
        if (lane == 0 && red != -BIG) atomicMax(&s_red[sl * BP + b], red);
      } else {
        const int span_lo = __reduce_min_sync(FULL, a_lo);
        const int span_hi = __reduce_max_sync(FULL, a_hi);
        if (lane == 0 && span_hi >= span_lo) {
          atomicMin(&s_span[cur * BP + b].x, span_lo);
          atomicMax(&s_span[cur * BP + b].y, span_hi);
        }
      }
    }
    __syncthreads();                      // the pairs' sums are complete
    if constexpr (HEUR != HEUR_NONE) {
      // ---- phase B: prune on the pair's totals; the row's live span -----
#pragma unroll 1
      for (int b = b_first; b < BP; b += b_step) {
        int2 sx, sg, se;
        int c0, c1;
        if (!reach(b, sx, sg, se, c0, c1)) continue;
        const int pl = s_plen[b], tl = s_tlen[b];
        const int red = s_red[sl * BP + b], n_live = s_live[sl * BP + b];
        const int bo = b * KCP;
        int a_lo = EMPTY_LO, a_hi = -EMPTY_LO;
#pragma unroll 1
        for (int ch = c0; ch <= c1; ch += wpp) {
          const int j = 32 * ch + lane, a = lo + j;
          const int at = m_rw * row_ints + bo + j;
          const int M = mr[at];
          // M's mask prunes I and D too: a kept lane has a live M
          const bool keep = j < KC && heur_keep<HEUR>(M, a - kc_full, pl, tl,
                                                      red, n_live, p.hp1,
                                                      p.hp2);
          if (!keep && M > THRESH) {
            mr[at] = NEG;
            if (AFFINE)
              ir[g_rw * row_ints + bo + j] = dr[g_rw * row_ints + bo + j] =
                  NEG;
          }
          if (keep) {
            a_lo = min(a_lo, a);
            a_hi = max(a_hi, a);
          }
        }
        const int span_lo = __reduce_min_sync(FULL, a_lo);
        const int span_hi = __reduce_max_sync(FULL, a_hi);
        if (lane == 0 && span_hi >= span_lo) {
          atomicMin(&s_span[cur * BP + b].x, span_lo);
          atomicMax(&s_span[cur * BP + b].y, span_hi);
        }
      }
      __syncthreads();
    }
    m_rx = m_rx + 1 == Wm ? 0 : m_rx + 1;
    m_rg = m_rg + 1 == Wm ? 0 : m_rg + 1;
    m_rw = m_rw + 1 == Wm ? 0 : m_rw + 1;
    if (AFFINE) {
      g_re = g_re + 1 == Wg ? 0 : g_re + 1;
      g_rw = g_rw + 1 == Wg ? 0 : g_rw + 1;
    }
  }
  // warp 0 settled the scores at the top of step s
  __syncthreads();
  for (int b = tid; b < BP; b += nthr) {
    p.steps[pair0 + b] = s;
    p.score[pair0 + b] = s_score[b];
  }
}

template <bool A, bool T, int H>
cudaError_t launch_band(const BandParams& p, int threads, size_t smem,
                        cudaStream_t stream) {
  auto kern = wfa_band_kernel<A, T, H>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<p.B / p.BP, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool A, bool T>
cudaError_t band_by_heur(const BandParams& p, int heur, int threads,
                         size_t smem, cudaStream_t stream) {
  switch (heur) {
    case HEUR_NONE: return launch_band<A, T, HEUR_NONE>(p, threads, smem, stream);
    case HEUR_ADAPTIVE:
      return launch_band<A, T, HEUR_ADAPTIVE>(p, threads, smem, stream);
    case HEUR_ZDROP: return launch_band<A, T, HEUR_ZDROP>(p, threads, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool A, bool T, int H>
cudaError_t launch_full(const FullParams& p, int threads, size_t smem,
                        cudaStream_t stream) {
  auto kern = wfa_full_kernel<A, T, H>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<p.B / p.BP, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool A, bool T>
cudaError_t full_by_heur(const FullParams& p, int heur, int threads,
                         size_t smem, cudaStream_t stream) {
  switch (heur) {
    case HEUR_NONE: return launch_full<A, T, HEUR_NONE>(p, threads, smem, stream);
    case HEUR_ADAPTIVE:
      return launch_full<A, T, HEUR_ADAPTIVE>(p, threads, smem, stream);
    case HEUR_ZDROP: return launch_full<A, T, HEUR_ZDROP>(p, threads, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The full-width kernel's blocks resident on one SM at this shape.
template <bool A, bool T>
int full_occupancy(int heur, int threads, size_t smem) {
  int n = 0;
  const void* kern =
      heur == HEUR_ADAPTIVE ? (const void*)wfa_full_kernel<A, T, HEUR_ADAPTIVE>
      : heur == HEUR_ZDROP  ? (const void*)wfa_full_kernel<A, T, HEUR_ZDROP>
                            : (const void*)wfa_full_kernel<A, T, HEUR_NONE>;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, threads, smem) !=
          cudaSuccess)
    return -1;
  return n;
}

bool full_args_ok(int B, int BP, int k_pad, int lane_lo, int lane_hi,
                  int W, int e) {
  return BP >= 1 && B % BP == 0 && k_pad >= 2 && W >= 2 && e >= 1 &&
         lane_lo >= 0 && lane_lo <= k_pad / 2 && k_pad / 2 <= lane_hi &&
         lane_hi < k_pad;
}

}  // namespace

extern "C" {

// Ints of global scratch wfa_launch needs for B pairs in rows of Lp / Lt
// characters on lanes [lane_lo, lane_hi] (kernel.full_lanes): the rings and
// the byte characters of each block that shared memory does not hold
// (full_layout).
long long wfa_scratch_ints(int B, int BP, int k_pad, int lane_lo, int lane_hi,
                           int W, int e, int affine, int Lp, int Lt) {
  if (!full_args_ok(B, BP, k_pad, lane_lo, lane_hi, W, e)) return 0;
  return full_layout(B, BP, lane_hi - lane_lo + 1, W, e + 1, affine, Lp, Lt)
      .scratch_ints;
}

// The launch wfa_launch makes at this shape: out[0] threads a block, out[1]
// dynamic shared bytes, out[2] blocks resident on one SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[3] rings in shared
// memory, out[4] characters in shared memory.  Returns 0, or
// cudaErrorInvalidValue.
int wfa_full_shape(int B, int BP, int k_pad, int lane_lo, int lane_hi, int W,
                   int e, int affine, int trace, int heur, int Lp, int Lt,
                   int* out) {
  if (!full_args_ok(B, BP, k_pad, lane_lo, lane_hi, W, e))
    return cudaErrorInvalidValue;
  const FullLayout l =
      full_layout(B, BP, lane_hi - lane_lo + 1, W, e + 1, affine, Lp, Lt);
  out[0] = l.threads;
  out[1] = (int)l.smem;
  out[2] = affine ? (trace ? full_occupancy<true, true>(heur, l.threads, l.smem)
                           : full_occupancy<true, false>(heur, l.threads, l.smem))
                  : (trace ? full_occupancy<false, true>(heur, l.threads, l.smem)
                           : full_occupancy<false, false>(heur, l.threads, l.smem));
  out[3] = l.rings_smem;
  out[4] = l.seq_smem;
  return 0;
}

// Launch one batched WFA at full width on `stream`: k_pad lanes centred at
// k_pad/2, of which no front can leave [lane_lo, lane_hi] up to s_max
// (kernel.full_lanes); `scratch` holds wfa_scratch_ints(...) ints (null
// when that is 0); with `trace`, the planes are zeroed.  Any character code
// compares exactly.  Returns cudaGetLastError() after the launch (0 =
// launched); faults during the run surface at the next sync.
int wfa_launch(const int* pattern, const int* text, const int* plen,
               const int* tlen, int* score, int* steps, int* m_bt, int* i_bt,
               int* d_bt, int* scratch, int B, int Lp, int Lt, int BP,
               int k_pad, int lane_lo, int lane_hi, int s_max, int x, int o,
               int e, int W, int affine, int trace, int heur, int hp1,
               int hp2, void* stream) {
  if (!full_args_ok(B, BP, k_pad, lane_lo, lane_hi, W, e))
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const int KC = lane_hi - lane_lo + 1;
  const FullLayout l = full_layout(B, BP, KC, W, e + 1, affine, Lp, Lt);
  if (l.scratch_ints > 0 && scratch == nullptr) return cudaErrorInvalidValue;
  const long long nblk = B / BP;
  const int ring_n = full_ring_ints(BP, band_lanes(KC), W, e + 1, affine);
  uint8_t* gseq =
      l.seq_smem || scratch == nullptr
          ? nullptr
          : reinterpret_cast<uint8_t*>(
                scratch + (l.rings_smem ? 0 : nblk * ring_n));
  FullParams p{pattern, text, plen, tlen, score, steps,
               {reinterpret_cast<uint32_t*>(m_bt),
                reinterpret_cast<uint32_t*>(i_bt),
                reinterpret_cast<uint32_t*>(d_bt)},
               l.rings_smem ? nullptr : scratch, gseq, B, Lp, Lt, BP, k_pad,
               lane_lo, KC, s_max, x, o, e, W, e + 1, hp1, hp2, l.wpp,
               l.rings_smem, l.seq_smem};
  cudaStream_t st = (cudaStream_t)stream;
  if (affine)
    return trace ? full_by_heur<true, true>(p, heur, l.threads, l.smem, st)
                 : full_by_heur<true, false>(p, heur, l.threads, l.smem, st);
  return trace ? full_by_heur<false, true>(p, heur, l.threads, l.smem, st)
               : full_by_heur<false, false>(p, heur, l.threads, l.smem, st);
}

// Ints of global scratch wfa_band_launch needs for B pairs in rows of Lp /
// Lt characters: the kc-wide rings and the byte characters of each block
// that shared memory does not hold (band_layout).
long long wfa_band_scratch_ints(int B, int BP, int kc, int W, int affine,
                                int trace, int Lp, int Lt) {
  if (BP < 1 || kc < 2) return 0;
  return band_layout(B, BP, kc, W, affine, trace, Lp, Lt).scratch_ints;
}

// Launch one batched WFA on the compacting band of kc lanes (2 <= kc <=
// k_pad); arguments and return as wfa_launch, `scratch` holding
// wfa_band_scratch_ints(...) ints.  Every character code up to the lengths
// must lie in [0, 255] (they are compared as bytes).
int wfa_band_launch(const int* pattern, const int* text, const int* plen,
                    const int* tlen, int* score, int* steps, int* m_bt,
                    int* i_bt, int* d_bt, int* scratch, int B, int Lp, int Lt,
                    int BP, int k_pad, int kc, int s_max, int x, int o, int e,
                    int W, int affine, int trace, int heur, int hp1, int hp2,
                    void* stream) {
  if (BP < 1 || B % BP != 0 || kc < 2 || kc > k_pad || W < 2)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const BandLayout l = band_layout(B, BP, kc, W, affine, trace, Lp, Lt);
  if (scratch == nullptr) return cudaErrorInvalidValue;
  const int cells = BP * band_lanes(kc);
  const int threads = cells < BAND_THREADS ? cells : BAND_THREADS;
  const size_t plane = (size_t)W * cells;
  const long long nblk = B / BP;
  uint8_t* gseq =
      l.seq_smem ? nullptr
                 : reinterpret_cast<uint8_t*>(scratch + nblk * (affine ? 3 : 1) *
                                                            plane);
  BandParams p{pattern, text, plen, tlen, score, steps,
               {reinterpret_cast<uint32_t*>(m_bt),
                reinterpret_cast<uint32_t*>(i_bt),
                reinterpret_cast<uint32_t*>(d_bt)},
               scratch, gseq, B, Lp, Lt, BP, k_pad, kc, s_max, x, o, e, W, hp1,
               hp2, l.SW, l.seq_smem};
  cudaStream_t st = (cudaStream_t)stream;
  if (affine)
    return trace ? band_by_heur<true, true>(p, heur, threads, l.smem, st)
                 : band_by_heur<true, false>(p, heur, threads, l.smem, st);
  return trace ? band_by_heur<false, true>(p, heur, threads, l.smem, st)
               : band_by_heur<false, false>(p, heur, threads, l.smem, st);
}

const char* wfa_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
