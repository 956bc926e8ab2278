// Batched WFA (gap-affine / gap-linear / edit) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/wfa/kernel.py::wfa_pallas
// (body _make_kernel), its score variant (trace=False) and its packed-trace
// variant (trace=True), at full width (wfa_kernel) and on the compacting
// band, band_cap set (wfa_band_kernel, below).  Same inputs, same outputs,
// bit for bit: score [B,1] (-1 over s_max), steps [B,1] (the block's exit
// step) and, with TRACE, the [NW, B, k_pad] int32 words of 2-bit
// provenance codes (16 score steps per word).
//
// Design.  One CTA per block of BP pairs, threads over the BP * k_pad
// (pair, lane) cells; all k_pad lanes run, centred at k_pad/2, so the trace
// words equal the TPU kernel's.  Each score step is two phases:
//   A  every cell reads rows s-x, s-(o+e), s-e of the rings at lanes k-1,
//      k, k+1, forms X/I/D, extends its own diagonal (a bounds-checked LCP
//      loop), ORs its codes into the current trace word (a register), stores
//      the unpruned fronts into row s%W and feeds the per-pair reductions
//      (target reached; AdaptiveBand's min and count; ZDrop's max) through
//      shared-memory atomics;
//   B  (after a barrier) a heuristic clears the lanes it prunes in row s%W
//      (M's mask prunes I and D too) and each pair's score is settled.
// Row s%W is never read during step s (every delta is >= 1 and < W), so
// phase A may write it in place.  The block exits when none of its pairs is
// unresolved (__syncthreads_or) or s passes s_max.  Trace words are stored
// every 16 steps and at the exit; codes come from the pre-prune fronts.
//
// Rings live in dynamic shared memory when n_rings*W*BP*k_pad*4 bytes fit
// the device's per-block opt-in (the paper's pass 1: 3*9*8*128*4 = 110,592
// bytes), else in a global scratch of wfa_scratch_ints() ints that the
// wrapper allocates; one generic pointer serves both.  This file alone
// decides the layout.
//
// What bounds it.  Per step and cell it does a few dozen integer operations
// and a data-dependent extension loop; the ring traffic stays on chip and
// the inputs are read once.  The work is latency- and issue-bound integer
// code with many idle lanes (k_pad = 128 lanes for about 2*k_max+1 = 35
// live diagonals at E = 2%): the card's memory rate is far from the limit.
// This first version keeps the design simple (one thread per cell, block
// barriers each step); packing sequences, skipping dead lanes and
// persistent CTAs are the levers for later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG = -(1 << 20);
constexpr int THRESH = NEG / 2;
constexpr int BIG = 1 << 20;
constexpr int CELLS_PER_WORD = 16;
constexpr int MAX_THREADS = 1024;
constexpr int HEAD_ARRAYS = 6;  // [BP] int arrays ahead of the rings

enum Heur { HEUR_NONE = 0, HEUR_ADAPTIVE = 1, HEUR_ZDROP = 2 };

struct Params {
  const int* pattern;  // [B, Lp]
  const int* text;     // [B, Lt]
  const int* plen;     // [B]
  const int* tlen;     // [B]
  int* score;          // [B]
  int* steps;          // [B]
  int* m_bt;           // [NW, B, k_pad] (TRACE)
  int* i_bt;           // affine TRACE only
  int* d_bt;
  int* scratch;        // global rings when they do not fit shared memory
  int B, Lp, Lt, BP, k_pad, s_max, x, o, e, W, hp1, hp2, ring_in_smem;
};

size_t head_bytes(int BP) { return (size_t)HEAD_ARRAYS * BP * sizeof(int); }

size_t ring_bytes(int BP, int width, int W, int affine) {
  return (size_t)(affine ? 3 : 1) * W * BP * width * sizeof(int);
}

// Whether `bytes` fit in the shared memory one block may opt into on the
// current device (227 KB on Hopper); else the rings go to a global scratch.
bool fits_smem(size_t bytes) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return false;
  return bytes <= (size_t)optin;
}

bool rings_in_smem(int BP, int k_pad, int W, int affine) {
  return fits_smem(head_bytes(BP) + ring_bytes(BP, k_pad, W, affine));
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

// Phase A: a live cell feeds its pair's heuristic reductions (AdaptiveBand:
// least remaining distance and live lanes; ZDrop: furthest antidiagonal).
template <int HEUR>
__device__ __forceinline__ void heur_reduce(int* red, int* live, int M, int k,
                                            int pl, int tl) {
  if (HEUR == HEUR_ADAPTIVE) {
    atomicMin(red, max(tl - M, pl - (M - k)));
    atomicAdd(live, 1);
  } else if (HEUR == HEUR_ZDROP) {
    atomicMax(red, 2 * M - k);
  }
}

// Phase B: whether the heuristic keeps a cell whose M is `M` (keep_mask).
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

template <bool AFFINE, bool TRACE, int HEUR, int CPT>
__global__ void __launch_bounds__(MAX_THREADS)
    wfa_kernel(const Params p) {
  extern __shared__ int smem[];
  const int BP = p.BP, KP = p.k_pad, W = p.W;
  const int cells = BP * KP;
  const int kc = KP / 2;
  const int pair0 = blockIdx.x * BP;
  const int tid = threadIdx.x, nthr = blockDim.x;
  // TRACE keeps CPT words per plane in registers: its loop bound must be a
  // compile-time constant; the score variant loops over a runtime count.
  const int ncell = TRACE ? CPT : (cells + nthr - 1) / nthr;

  int* s_score = smem;           // [BP] per-pair score (-1 unresolved)
  int* s_reach = smem + BP;      // [BP] target reached this step
  int* s_red = smem + 2 * BP;    // [BP] AdaptiveBand min d / ZDrop max h+v
  int* s_live = smem + 3 * BP;   // [BP] AdaptiveBand live lanes
  int* s_plen = smem + 4 * BP;
  int* s_tlen = smem + 5 * BP;
  const int n_rings = AFFINE ? 3 : 1;
  const size_t plane = (size_t)W * cells;
  int* ring = p.ring_in_smem
                  ? smem + HEAD_ARRAYS * BP
                  : p.scratch + (size_t)blockIdx.x * n_rings * plane;
  int* m_ring = ring;
  int* i_ring = ring + plane;
  int* d_ring = ring + 2 * plane;
  const int red_init = HEUR == HEUR_ZDROP ? -BIG : BIG;

  if (tid < BP) {
    // a length past its row would read out of bounds: clamp it to the row
    s_plen[tid] = min(p.plen[pair0 + tid], p.Lp);
    s_tlen[tid] = min(p.tlen[pair0 + tid], p.Lt);
    s_reach[tid] = 0;
    s_red[tid] = red_init;
    s_live[tid] = 0;
  }
  __syncthreads();

  // s = 0: M_0[k=0] = LCP(p, t); I/D invalid.
  for (int q = 0; q < ncell; ++q) {
    const int c = tid + q * nthr;
    if (c >= cells) break;
    const int b = c / KP, k = c - b * KP - kc;
    const int pair = pair0 + b;
    const int pl = s_plen[b], tl = s_tlen[b];
    const int M = extend(k == 0 ? 0 : NEG, k, p.pattern + (size_t)pair * p.Lp,
                         p.text + (size_t)pair * p.Lt, pl, tl);
    m_ring[c] = M;
    if (AFFINE) {
      i_ring[c] = NEG;
      d_ring[c] = NEG;
    }
    if (k == tl - pl && M >= tl && M > THRESH) s_reach[b] = 1;
  }
  __syncthreads();
  if (tid < BP) {
    s_score[tid] = s_reach[tid] ? 0 : -1;
    s_reach[tid] = 0;
  }
  int s = 1;
  bool cont = __syncthreads_or(tid < BP && s_score[tid] < 0) && s <= p.s_max;

  uint32_t wm[TRACE ? CPT : 1], wi[TRACE ? CPT : 1], wd[TRACE ? CPT : 1];
#pragma unroll
  for (int q = 0; q < (TRACE ? CPT : 1); ++q) wm[q] = wi[q] = wd[q] = 0u;

  auto rd = [&](const int* rg, int delta, int b, int j) -> int {
    if (s < delta || j < 0 || j >= KP) return NEG;
    return rg[(size_t)((s - delta) % W) * cells + b * KP + j];
  };
  auto flush = [&](int word) {
#pragma unroll
    for (int q = 0; q < (TRACE ? CPT : 1); ++q) {
      const int c = tid + q * nthr;
      if (c < cells) {
        const int b = c / KP, j = c - b * KP;
        const size_t at = ((size_t)word * p.B + pair0 + b) * KP + j;
        p.m_bt[at] = (int)wm[q];
        if (AFFINE) {
          p.i_bt[at] = (int)wi[q];
          p.d_bt[at] = (int)wd[q];
        }
      }
      wm[q] = wi[q] = wd[q] = 0u;
    }
  };

  while (cont) {
    const size_t row = (size_t)(s % W) * cells;
    const int sh = 2 * (s % CELLS_PER_WORD);
    // ---- phase A: candidates, extension, codes, unpruned store ----------
#pragma unroll
    for (int q = 0; q < ncell; ++q) {
      const int c = tid + q * nthr;
      if (c < cells) {
        const int b = c / KP, j = c - b * KP, k = j - kc;
        const int pair = pair0 + b;
        const int pl = s_plen[b], tl = s_tlen[b];
        const int oe = AFFINE ? p.o + p.e : p.e;
        const Cell st = step_cell<AFFINE>(
            rd(m_ring, p.x, b, j), rd(m_ring, oe, b, j - 1),
            AFFINE ? rd(i_ring, p.e, b, j - 1) : NEG, rd(m_ring, oe, b, j + 1),
            AFFINE ? rd(d_ring, p.e, b, j + 1) : NEG, k, pl, tl,
            p.pattern + (size_t)pair * p.Lp, p.text + (size_t)pair * p.Lt);
        if (TRACE) {
          wm[TRACE ? q : 0] |= st.cm << sh;
          wi[TRACE ? q : 0] |= st.ci << sh;
          wd[TRACE ? q : 0] |= st.cd << sh;
        }
        m_ring[row + c] = st.M;
        if (AFFINE) {
          i_ring[row + c] = st.I;
          d_ring[row + c] = st.D;
        }
        if (st.M > THRESH) {
          if (k == tl - pl && st.M >= tl) s_reach[b] = 1;
          heur_reduce<HEUR>(&s_red[b], &s_live[b], st.M, k, pl, tl);
        }
      }
    }
    __syncthreads();
    // ---- phase B: prune, settle scores, flush full trace words ----------
    if (HEUR != HEUR_NONE) {
      for (int q = 0; q < ncell; ++q) {
        const int c = tid + q * nthr;
        if (c >= cells) break;
        const int b = c / KP, k = c - b * KP - kc;
        if (!heur_keep<HEUR>(m_ring[row + c], k, s_plen[b], s_tlen[b],
                             s_red[b], s_live[b], p.hp1, p.hp2)) {
          m_ring[row + c] = NEG;
          if (AFFINE) {
            i_ring[row + c] = NEG;
            d_ring[row + c] = NEG;
          }
        }
      }
    }
    if (tid < BP && s_score[tid] < 0 && s_reach[tid]) s_score[tid] = s;
    if (TRACE && s % CELLS_PER_WORD == CELLS_PER_WORD - 1)
      flush(s / CELLS_PER_WORD);
    __syncthreads();
    if (tid < BP) {
      s_reach[tid] = 0;
      s_red[tid] = red_init;
      s_live[tid] = 0;
    }
    ++s;
    cont = __syncthreads_or(tid < BP && s_score[tid] < 0) && s <= p.s_max;
  }
  // the last step's partial word (steps since the last flush)
  if (TRACE && s - 1 >= 1 && (s - 1) % CELLS_PER_WORD != CELLS_PER_WORD - 1)
    flush((s - 1) / CELLS_PER_WORD);
  if (tid < BP) {
    p.score[pair0 + tid] = s_score[tid];
    p.steps[pair0 + tid] = s;
  }
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

template <bool A, bool T, int H, int C>
cudaError_t launch_one(const Params& p, int threads, size_t smem,
                       cudaStream_t stream) {
  auto kern = wfa_kernel<A, T, H, C>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<p.B / p.BP, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool A, bool T, int H>
cudaError_t by_cpt(const Params& p, int cpt, int threads, size_t smem,
                   cudaStream_t stream) {
  if constexpr (!T) {
    return launch_one<A, false, H, 1>(p, threads, smem, stream);
  } else {
    switch (cpt) {
      case 1: return launch_one<A, true, H, 1>(p, threads, smem, stream);
      case 2: return launch_one<A, true, H, 2>(p, threads, smem, stream);
      case 4: return launch_one<A, true, H, 4>(p, threads, smem, stream);
      case 8: return launch_one<A, true, H, 8>(p, threads, smem, stream);
      case 16: return launch_one<A, true, H, 16>(p, threads, smem, stream);
      default: return cudaErrorInvalidValue;
    }
  }
}

template <bool A, bool T>
cudaError_t by_heur(const Params& p, int heur, int cpt, int threads,
                    size_t smem, cudaStream_t stream) {
  switch (heur) {
    case HEUR_NONE: return by_cpt<A, T, HEUR_NONE>(p, cpt, threads, smem, stream);
    case HEUR_ADAPTIVE:
      return by_cpt<A, T, HEUR_ADAPTIVE>(p, cpt, threads, smem, stream);
    case HEUR_ZDROP: return by_cpt<A, T, HEUR_ZDROP>(p, cpt, threads, smem, stream);
    default: return cudaErrorInvalidValue;
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

}  // namespace

extern "C" {

// Largest trace cells-per-thread instantiated (BP * k_pad <= 16 * 1024).
int wfa_max_trace_cells() { return 16 * MAX_THREADS; }

// Ints of global scratch wfa_launch needs for the rings of B pairs: 0 when
// they fit in shared memory.
long long wfa_scratch_ints(int B, int BP, int k_pad, int W, int affine) {
  if (BP < 1 || rings_in_smem(BP, k_pad, W, affine)) return 0;
  return (long long)(B / BP) * (long long)(ring_bytes(BP, k_pad, W, affine) /
                                           sizeof(int));
}

// Launch one batched WFA on `stream`; `scratch` holds wfa_scratch_ints(...)
// ints (null when that is 0).  Returns cudaGetLastError() after the launch
// (0 = launched); faults during the run surface at the next sync.
int wfa_launch(const int* pattern, const int* text, const int* plen,
               const int* tlen, int* score, int* steps, int* m_bt, int* i_bt,
               int* d_bt, int* scratch, int B, int Lp, int Lt, int BP,
               int k_pad, int s_max, int x, int o, int e, int W, int affine,
               int trace, int heur, int hp1, int hp2, void* stream) {
  if (BP < 1 || B % BP != 0 || k_pad < 1 || W < 2) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const int cells = BP * k_pad;
  int cpt = 1;
  if (trace) {
    while (cpt * MAX_THREADS < cells) cpt *= 2;
    if (cpt > 16) return cudaErrorInvalidValue;
  }
  int threads = trace ? (cells + cpt - 1) / cpt
                      : (cells < MAX_THREADS ? cells : MAX_THREADS);
  threads = ((threads + 31) / 32) * 32;
  const int ring_in_smem = rings_in_smem(BP, k_pad, W, affine);
  size_t smem = head_bytes(BP);
  if (ring_in_smem)
    smem += ring_bytes(BP, k_pad, W, affine);
  else if (scratch == nullptr)
    return cudaErrorInvalidValue;
  Params p{pattern, text, plen, tlen, score, steps, m_bt, i_bt, d_bt, scratch,
           B, Lp, Lt, BP, k_pad, s_max, x, o, e, W, hp1, hp2, ring_in_smem};
  cudaStream_t st = (cudaStream_t)stream;
  if (affine)
    return trace ? by_heur<true, true>(p, heur, cpt, threads, smem, st)
                 : by_heur<true, false>(p, heur, cpt, threads, smem, st);
  return trace ? by_heur<false, true>(p, heur, cpt, threads, smem, st)
               : by_heur<false, false>(p, heur, cpt, threads, smem, st);
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
