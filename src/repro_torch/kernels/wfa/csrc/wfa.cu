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

// The band kernel's head adds the [W] row offsets and the [2][2] live spans.
size_t band_head_bytes(int BP, int W) {
  return head_bytes(BP) + (size_t)(W + 4) * sizeof(int);
}

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

bool band_rings_in_smem(int BP, int kc, int W, int affine) {
  return fits_smem(band_head_bytes(BP, W) + ring_bytes(BP, kc, W, affine));
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

// One cell's step from its ring reads (rows s-x, s-(o+e), s-e at lanes k,
// k-1, k+1): the bounded I/D/X candidates, M after the extension and the
// 2-bit codes of the pre-prune fronts (tie-break X, I, D; extend over
// open).  A linear model passes its M_{s-e} neighbours as i_open / d_open
// and NEG as i_ext / d_ext.
struct Cell {
  int M, I, D;
  uint32_t cm, ci, cd;
};

template <bool AFFINE>
__device__ __forceinline__ Cell step_cell(int m_x, int i_open, int i_ext,
                                          int d_open, int d_ext, int k, int pl,
                                          int tl, const int* __restrict__ prow,
                                          const int* __restrict__ trow) {
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
// The compacting band (TPU kernel 3: wfa_pallas with band_cap).
//
// Rings are KC lanes wide ([W, BP, KC]) and sit in a window that slides
// along the k_pad diagonals: s_off[r] is the absolute lane of ring row r's
// lane 0, one offset per block as on the TPU.  Threads run over the BP * KC
// compact cells (KC = 128 for AdaptiveBand(), 256 for ZDrop(): the rings of
// the 10 kb long-read pass fit shared memory).  Each step:
//   - the offset re-centres on the live lanes (M|I|D) of row (s-1)%W: their
//     lowest and highest compact lane, reduced in phase B of the step before
//     (warp reductions, then shared-memory atomics into one of two span
//     slots chosen by the step's parity, so a slot is reset a step before it
//     is filled again);
//   - reads of an older row r take lane j + (off - s_off[r]), NEG outside
//     [0, KC); the +-1 diagonal neighbours are read inside the compact width
//     first, so the window's edge lanes read NEG, as the TPU kernel's shifts
//     do;
//   - the target test, the extension and the heuristics use the absolute
//     diagonal k = j + off - k_pad/2.
// Trace codes cannot stay in a register word as in wfa_kernel: a cell's
// absolute lane changes whenever the window moves inside a 16-step word.
// Each nonzero code is ORed straight into its word at lane off + j in global
// memory (the wrapper zeroes the planes).  Within a step each absolute lane
// has one writer; the block barriers order the steps.
// What bounds it: as wfa_kernel, latency-bound integer code, now with KC
// instead of k_pad cells per pair (1,024 instead of 39,936 per block at the
// 10 kb shape).
template <bool AFFINE, bool TRACE, int HEUR>
__global__ void __launch_bounds__(MAX_THREADS)
    wfa_band_kernel(const Params p, const int KC) {
  extern __shared__ int smem[];
  const int BP = p.BP, KP = p.k_pad, W = p.W;
  const int cells = BP * KC;
  const int kc_full = KP / 2;
  const int pair0 = blockIdx.x * BP;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int ncell = (cells + nthr - 1) / nthr;

  int* s_score = smem;
  int* s_reach = smem + BP;
  int* s_red = smem + 2 * BP;
  int* s_live = smem + 3 * BP;
  int* s_plen = smem + 4 * BP;
  int* s_tlen = smem + 5 * BP;
  int* s_off = smem + HEAD_ARRAYS * BP;   // [W] absolute lane of lane 0
  int* s_span = s_off + W;                // [2][lo, hi] live compact lanes
  const int n_rings = AFFINE ? 3 : 1;
  const size_t plane = (size_t)W * cells;
  int* ring = p.ring_in_smem
                  ? s_span + 4
                  : p.scratch + (size_t)blockIdx.x * n_rings * plane;
  int* m_ring = ring;
  int* i_ring = ring + plane;
  int* d_ring = ring + 2 * plane;
  const int red_init = HEUR == HEUR_ZDROP ? -BIG : BIG;
  const int off0 = min(max(kc_full - KC / 2, 0), KP - KC);

  if (tid < BP) {
    s_plen[tid] = min(p.plen[pair0 + tid], p.Lp);
    s_tlen[tid] = min(p.tlen[pair0 + tid], p.Lt);
    s_reach[tid] = 0;
    s_red[tid] = red_init;
    s_live[tid] = 0;
  }
  for (int r = tid; r < W; r += nthr) s_off[r] = off0;
  if (tid < 4) s_span[tid] = (tid & 1) ? -1 : KC;
  __syncthreads();

  // One warp-reduced contribution of this thread's live lanes [lo, hi].
  auto add_span = [&](int* span, int lo, int hi) {
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if ((tid & 31) == 0 && hi >= 0) {
      atomicMin(span, lo);
      atomicMax(span + 1, hi);
    }
  };

  // s = 0: M_0[k=0] = LCP(p, t); I/D invalid.  Its live span seeds step 1.
  {
    int lo = KC, hi = -1;
    for (int q = 0; q < ncell; ++q) {
      const int c = tid + q * nthr;
      if (c < cells) {
        const int b = c / KC, j = c - b * KC, k = j + off0 - kc_full;
        const int pair = pair0 + b;
        const int pl = s_plen[b], tl = s_tlen[b];
        const int M = extend(k == 0 ? 0 : NEG, k,
                             p.pattern + (size_t)pair * p.Lp,
                             p.text + (size_t)pair * p.Lt, pl, tl);
        m_ring[c] = M;
        if (AFFINE) {
          i_ring[c] = NEG;
          d_ring[c] = NEG;
        }
        if (M > THRESH) {
          if (k == tl - pl && M >= tl) s_reach[b] = 1;
          lo = min(lo, j);
          hi = max(hi, j);
        }
      }
    }
    add_span(s_span + 2, lo, hi);
  }
  __syncthreads();
  if (tid < BP) {
    s_score[tid] = s_reach[tid] ? 0 : -1;
    s_reach[tid] = 0;
  }
  int s = 1;
  bool cont = __syncthreads_or(tid < BP && s_score[tid] < 0) && s <= p.s_max;

  while (cont) {
    const int par = s & 1;
    const int lo = s_span[2 * par], hi = s_span[2 * par + 1];
    const int poff = s_off[(s - 1) % W];
    const int off =
        hi >= lo ? min(max(poff + (lo + hi) / 2 - KC / 2, 0), KP - KC) : poff;
    if (tid == 0) {
      // row s%W is not read in step s; the other span slot was last read at
      // the top of step s-1
      s_off[s % W] = off;
      s_span[2 * (par ^ 1)] = KC;
      s_span[2 * (par ^ 1) + 1] = -1;
    }
    // ring row s-delta realigned to this step's window, lane jj
    auto rd = [&](const int* rg, int delta, int b, int jj) -> int {
      if (s < delta || jj < 0 || jj >= KC) return NEG;
      const int r = (s - delta) % W;
      const int idx = jj + off - s_off[r];
      if (idx < 0 || idx >= KC) return NEG;
      return rg[(size_t)r * cells + b * KC + idx];
    };
    const size_t row = (size_t)(s % W) * cells;
    const int sh = 2 * (s % CELLS_PER_WORD);
    const size_t word = (size_t)(s / CELLS_PER_WORD);
    // ---- phase A: candidates, extension, codes, unpruned store ----------
    for (int q = 0; q < ncell; ++q) {
      const int c = tid + q * nthr;
      if (c < cells) {
        const int b = c / KC, j = c - b * KC, k = j + off - kc_full;
        const int pair = pair0 + b;
        const int pl = s_plen[b], tl = s_tlen[b];
        const int oe = AFFINE ? p.o + p.e : p.e;
        const Cell st = step_cell<AFFINE>(
            rd(m_ring, p.x, b, j), rd(m_ring, oe, b, j - 1),
            AFFINE ? rd(i_ring, p.e, b, j - 1) : NEG, rd(m_ring, oe, b, j + 1),
            AFFINE ? rd(d_ring, p.e, b, j + 1) : NEG, k, pl, tl,
            p.pattern + (size_t)pair * p.Lp, p.text + (size_t)pair * p.Lt);
        if (TRACE) {
          // ci and cd are 0 for linear models, whose i_bt / d_bt are null
          const size_t at = (word * p.B + pair) * KP + off + j;
          if (st.cm) reinterpret_cast<uint32_t*>(p.m_bt)[at] |= st.cm << sh;
          if (st.ci) reinterpret_cast<uint32_t*>(p.i_bt)[at] |= st.ci << sh;
          if (st.cd) reinterpret_cast<uint32_t*>(p.d_bt)[at] |= st.cd << sh;
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
    // ---- phase B: prune, the next step's live span, settle scores -------
    {
      int nlo = KC, nhi = -1;
      for (int q = 0; q < ncell; ++q) {
        const int c = tid + q * nthr;
        if (c < cells) {
          const int b = c / KC, j = c - b * KC, k = j + off - kc_full;
          const int M = m_ring[row + c];
          bool live;
          if (HEUR != HEUR_NONE) {
            // M's mask prunes I and D too: a kept lane has a live M
            const bool keep = heur_keep<HEUR>(M, k, s_plen[b], s_tlen[b],
                                              s_red[b], s_live[b], p.hp1,
                                              p.hp2);
            if (!keep) {
              m_ring[row + c] = NEG;
              if (AFFINE) {
                i_ring[row + c] = NEG;
                d_ring[row + c] = NEG;
              }
            }
            live = keep;
          } else {
            live = M > THRESH ||
                   (AFFINE && (i_ring[row + c] > THRESH ||
                               d_ring[row + c] > THRESH));
          }
          if (live) {
            nlo = min(nlo, j);
            nhi = max(nhi, j);
          }
        }
      }
      add_span(s_span + 2 * (par ^ 1), nlo, nhi);
    }
    if (tid < BP && s_score[tid] < 0 && s_reach[tid]) s_score[tid] = s;
    __syncthreads();
    if (tid < BP) {
      s_reach[tid] = 0;
      s_red[tid] = red_init;
      s_live[tid] = 0;
    }
    ++s;
    cont = __syncthreads_or(tid < BP && s_score[tid] < 0) && s <= p.s_max;
  }
  if (tid < BP) {
    p.score[pair0 + tid] = s_score[tid];
    p.steps[pair0 + tid] = s;
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
cudaError_t launch_band(const Params& p, int kc, int threads, size_t smem,
                        cudaStream_t stream) {
  auto kern = wfa_band_kernel<A, T, H>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<p.B / p.BP, threads, smem, stream>>>(p, kc);
  return cudaGetLastError();
}

template <bool A, bool T>
cudaError_t band_by_heur(const Params& p, int heur, int kc, int threads,
                         size_t smem, cudaStream_t stream) {
  switch (heur) {
    case HEUR_NONE: return launch_band<A, T, HEUR_NONE>(p, kc, threads, smem, stream);
    case HEUR_ADAPTIVE:
      return launch_band<A, T, HEUR_ADAPTIVE>(p, kc, threads, smem, stream);
    case HEUR_ZDROP: return launch_band<A, T, HEUR_ZDROP>(p, kc, threads, smem, stream);
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

// Ints of global scratch wfa_band_launch needs for the kc-wide rings of B
// pairs: 0 when they fit in shared memory.
long long wfa_band_scratch_ints(int B, int BP, int kc, int W, int affine) {
  if (BP < 1 || band_rings_in_smem(BP, kc, W, affine)) return 0;
  return (long long)(B / BP) *
         (long long)(ring_bytes(BP, kc, W, affine) / sizeof(int));
}

// Launch one batched WFA on the compacting band of kc lanes (2 <= kc <=
// k_pad); arguments and return as wfa_launch.
int wfa_band_launch(const int* pattern, const int* text, const int* plen,
                    const int* tlen, int* score, int* steps, int* m_bt,
                    int* i_bt, int* d_bt, int* scratch, int B, int Lp, int Lt,
                    int BP, int k_pad, int kc, int s_max, int x, int o, int e,
                    int W, int affine, int trace, int heur, int hp1, int hp2,
                    void* stream) {
  if (BP < 1 || B % BP != 0 || kc < 2 || kc > k_pad || W < 2)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const int cells = BP * kc;
  int threads = cells < MAX_THREADS ? cells : MAX_THREADS;
  threads = ((threads + 31) / 32) * 32;
  const int ring_in_smem = band_rings_in_smem(BP, kc, W, affine);
  size_t smem = band_head_bytes(BP, W);
  if (ring_in_smem)
    smem += ring_bytes(BP, kc, W, affine);
  else if (scratch == nullptr)
    return cudaErrorInvalidValue;
  Params p{pattern, text, plen, tlen, score, steps, m_bt, i_bt, d_bt, scratch,
           B, Lp, Lt, BP, k_pad, s_max, x, o, e, W, hp1, hp2, ring_in_smem};
  cudaStream_t st = (cudaStream_t)stream;
  if (affine)
    return trace ? band_by_heur<true, true>(p, heur, kc, threads, smem, st)
                 : band_by_heur<true, false>(p, heur, kc, threads, smem, st);
  return trace ? band_by_heur<false, true>(p, heur, kc, threads, smem, st)
               : band_by_heur<false, false>(p, heur, kc, threads, smem, st);
}

const char* wfa_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
