// BiWFA meet-in-the-middle search for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/wfa/kernel.py::wfa_meet_pallas
// (body _make_meet_kernel).  Same inputs, same outputs, bit for bit: eight
// [B,1] int32 arrays (score, steps, state, a, b, k, h, safe), the fields of
// BidirMeetResult plus the block's exit step.
//
// Design.  One CTA per block of BP pairs, threads looping over the BP * k_pad
// (pair, lane) cells, all k_pad lanes centred at k_pad/2.  Each score step s:
//   A  forward (pattern, text) and reverse (pat_rev, txt_rev) fronts each take
//      one WFA step and extend; every cell stores its unpruned values into row
//      s%Wd of the seven rings (forward M, pre-extension M, I, D; reverse M,
//      I, D: three rings for linear models) and feeds the heuristic's per-pair
//      reductions through shared-memory atomics;
//   B  (heuristics only, after a barrier) lanes the heuristic drops are cleared
//      in row s%Wd, the forward mask over the forward rings, the reverse mask
//      over the reverse ones;
//   C  (after a barrier) the meet test: each cell reads its own lane of the
//      forward rings and the complement lane j' = (tlen-plen) + 2*kc - j of the
//      reverse rings at the per-pair costs of both orientations ((s, T-s) and
//      (T-s, s)), and marks every candidate class it satisfies with a
//      shared-memory atomicMin of its lane on the pair's (class, side) slot;
//   R  (after a barrier) one thread per pair takes the first non-empty slot in
//      the reference's order (mm_safe, ii0, dd0, mm_cov, ii_cov, dd_cov, each
//      orientation A then B) at its lowest lane, which is the argmax-of-mask
//      order of the TPU kernel, recomputes h at that lane and retires the pair.
// A pair's fields change only when it meets, so met pairs skip all per-cell
// work.  The block exits when all its pairs have met (__syncthreads_or) or s
// passes s_max.  Row s%Wd is not read by phase A of step s (every delta is >= 1
// and < Wd); the meet test may read it, after the barrier.
//
// Rings live in a global scratch of wfa_meet_scratch_ints() ints that the
// wrapper allocates: even at 100 bp the seven affine rings take 516 KB per
// block, past the per-block shared-memory opt-in.
//
// What bounds it.  Integer code with a data-dependent extension loop and
// cross-lane gathers (the complement lane, the per-pair cost rows); per step
// and cell two recurrences, two extensions and up to 14 ring reads for the
// meet test.  The serial chain of score steps, each a few block barriers, and
// the ring traffic through L2 bound it, not the device memory rate or the
// integer rate.  Skipping dead lanes and keeping the live band in shared
// memory are the levers for later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG = -(1 << 20);
constexpr int THRESH = NEG / 2;
constexpr int BIG = 1 << 20;
constexpr int MAX_THREADS = 1024;
constexpr int N_CLASSES = 6;            // mm_safe ii0 dd0 mm_cov ii_cov dd_cov
constexpr int N_SLOTS = 2 * N_CLASSES;  // x orientation A, B
enum Class { MM_SAFE = 0, II0 = 1, DD0 = 2, MM_COV = 3, II_COV = 4, DD_COV = 5 };
enum Heur { HEUR_NONE = 0, HEUR_ADAPTIVE = 1, HEUR_ZDROP = 2 };
enum State { ST_M = 0, ST_I = 1, ST_D = 2 };
// [BP] int arrays in shared memory, ahead of the slot table
enum Head {
  H_PLEN, H_TLEN, H_STARGET, H_MET, H_MET0, H_RED_F, H_LIVE_F, H_RED_R,
  H_LIVE_R, H_STATE, H_A, H_B, H_K, H_H, H_SAFE, HEAD_ARRAYS
};

struct MeetParams {
  const int* pattern;  // [B, Lp]
  const int* text;     // [B, Lt]
  const int* pat_rev;  // [B, Lp] each row reversed up to its length
  const int* txt_rev;  // [B, Lt]
  const int* plen;     // [B]
  const int* tlen;     // [B]
  const int* starget;  // [B] known optimal cost
  int* score;          // [B] outputs
  int* steps;
  int* state;
  int* a;
  int* b;
  int* k;
  int* h;
  int* safe;
  int* scratch;        // global rings, n_rings * Wd * BP * k_pad per block
  int B, Lp, Lt, BP, k_pad, s_max, x, o, e, Wd, hp1, hp2, begin_state,
      end_state;
};

size_t head_bytes(int BP) {
  return (size_t)(HEAD_ARRAYS + N_SLOTS) * BP * sizeof(int);
}

size_t ring_bytes(int BP, int k_pad, int Wd, int affine) {
  return (size_t)(affine ? 7 : 3) * Wd * BP * k_pad * sizeof(int);
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

// The rings of one block: plane r holds Wd rows of BP * k_pad cells.
struct Rings {
  int *fm, *fmp, *fi, *fd, *rm, *ri, *rd;
  size_t cells;
  int Wd;
  // row at score s - delta (NEG before s = 0 or off the lane range)
  __device__ __forceinline__ int back(const int* rg, int s, int delta, int b,
                                      int j, int KP) const {
    if (s < delta || j < 0 || j >= KP) return NEG;
    return rg[(size_t)((s - delta) % Wd) * cells + (size_t)b * KP + j];
  }
  // row at per-pair cost c, NEG outside the window (c in (s - Wd, s])
  __device__ __forceinline__ int at(const int* rg, int c, int s, int b, int j,
                                    int KP) const {
    if (c < 0 || c > s || c <= s - Wd || j < 0 || j >= KP) return NEG;
    return rg[(size_t)(c % Wd) * cells + (size_t)b * KP + j];
  }
};

// One WFA step of one cell from rings m/ii/dd; returns M after extension and
// sets I, D and the pre-extension M.
template <bool AFFINE>
__device__ __forceinline__ int step_cell(const Rings& R, const int* m,
                                         const int* ii, const int* dd,
                                         const MeetParams& p, int s, int b,
                                         int j, int k, int pl, int tl,
                                         const int* prow, const int* trow,
                                         int& I, int& D, int& Mpre) {
  const int KP = p.k_pad;
  const int m_x = R.back(m, s, p.x, b, j, KP);
  int i_src, d_src;
  if (AFFINE) {
    const int oe = p.o + p.e;
    i_src = max(R.back(m, s, oe, b, j - 1, KP), R.back(ii, s, p.e, b, j - 1, KP));
    d_src = max(R.back(m, s, oe, b, j + 1, KP), R.back(dd, s, p.e, b, j + 1, KP));
  } else {
    i_src = R.back(m, s, p.e, b, j - 1, KP);
    d_src = R.back(m, s, p.e, b, j + 1, KP);
  }
  I = (i_src > THRESH && i_src + 1 <= tl) ? i_src + 1 : NEG;
  D = (d_src > THRESH && d_src - k <= pl) ? d_src : NEG;
  const int X = (m_x > THRESH && m_x + 1 <= tl && m_x + 1 - k <= pl) ? m_x + 1
                                                                    : NEG;
  Mpre = max(max(X, I), D);
  return extend(Mpre, k, prow, trow, pl, tl);
}

// The ring values one orientation's candidate classes read at lane j.
struct Side {
  int fa_m, fa_mp, rb_m, fa_i, rb_i, fa_d, rb_d;
};

template <bool AFFINE>
__device__ __forceinline__ Side side_at(const Rings& R, int s, int b, int j,
                                        int jp, int KP, int a_m, int a_g,
                                        int b_m, int b_g) {
  Side v;
  v.fa_m = R.at(R.fm, a_m, s, b, j, KP);
  v.fa_mp = R.at(R.fmp, a_m, s, b, j, KP);
  v.rb_m = R.at(R.rm, b_m, s, b, jp, KP);
  v.fa_i = v.rb_i = v.fa_d = v.rb_d = NEG;
  if (AFFINE) {
    v.fa_i = R.at(R.fi, a_g, s, b, j, KP);
    v.rb_i = R.at(R.ri, b_g, s, b, jp, KP);
    v.fa_d = R.at(R.fd, a_g, s, b, j, KP);
    v.rb_d = R.at(R.rd, b_g, s, b, jp, KP);
  }
  return v;
}

// Bit c set when class c holds (m2 = tlen).
__device__ __forceinline__ unsigned classes(const Side& v, int m2) {
  unsigned bits = 0;
  const bool vmm = v.fa_m > THRESH && v.rb_m > THRESH;
  const bool cov = vmm && v.fa_m + v.rb_m >= m2;
  if (cov && v.fa_mp + v.rb_m <= m2) bits |= 1u << MM_SAFE;
  if (cov) bits |= 1u << MM_COV;
  const bool vii = v.fa_i > THRESH && v.rb_i > THRESH;
  const bool vdd = v.fa_d > THRESH && v.rb_d > THRESH;
  if (vii && v.fa_i + v.rb_i == m2) bits |= 1u << II0;
  if (vdd && v.fa_d + v.rb_d == m2) bits |= 1u << DD0;
  if (vii && v.fa_i + v.rb_i >= m2) bits |= 1u << II_COV;
  if (vdd && v.fa_d + v.rb_d >= m2) bits |= 1u << DD_COV;
  return bits;
}

template <bool AFFINE, int HEUR>
__global__ void __launch_bounds__(MAX_THREADS) wfa_meet_kernel(const MeetParams p) {
  extern __shared__ int smem[];
  const int BP = p.BP, KP = p.k_pad, Wd = p.Wd;
  const int cells = BP * KP;
  const int kc = KP / 2;
  const int pair0 = blockIdx.x * BP;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int ncell = (cells + nthr - 1) / nthr;
  // hd(array, pair): the per-pair head arrays in shared memory
  auto hd = [&](int arr, int b) -> int& { return smem[arr * BP + b]; };
  int* slot = smem + HEAD_ARRAYS * BP;  // [BP][N_SLOTS] lowest lane, KP = none
  const int n_rings = AFFINE ? 7 : 3;
  const size_t plane = (size_t)Wd * cells;
  int* ring = p.scratch + (size_t)blockIdx.x * n_rings * plane;
  Rings R;
  R.cells = cells;
  R.Wd = Wd;
  R.fm = ring;
  R.fmp = ring + plane;
  if (AFFINE) {
    R.fi = ring + 2 * plane;
    R.fd = ring + 3 * plane;
    R.rm = ring + 4 * plane;
    R.ri = ring + 5 * plane;
    R.rd = ring + 6 * plane;
  } else {
    R.rm = ring + 2 * plane;
    R.fi = R.fd = R.ri = R.rd = nullptr;
  }
  const int o_aff = AFFINE ? p.o : 0;
  // end state I/D: the reverse rings seed the trailing gap at 0, so every
  // reverse cost sits o below the forward convention; shift the target once
  const int oend = p.end_state != ST_M ? o_aff : 0;
  const int red_init = HEUR == HEUR_ZDROP ? -BIG : BIG;

  if (tid < BP) {
    const int pl = p.plen[pair0 + tid], tl = p.tlen[pair0 + tid];
    // a length past its row would read out of bounds: clamp it to the row
    hd(H_PLEN, tid) = min(pl, p.Lp);
    hd(H_TLEN, tid) = min(tl, p.Lt);
    hd(H_STARGET, tid) = p.starget[pair0 + tid];
    const int met0 = pl == 0 && tl == 0;  // padded rows: free the exit
    hd(H_MET0, tid) = met0;
    hd(H_MET, tid) = met0;
    hd(H_RED_F, tid) = hd(H_RED_R, tid) = red_init;
    hd(H_LIVE_F, tid) = hd(H_LIVE_R, tid) = 0;
    hd(H_STATE, tid) = -1;
    hd(H_A, tid) = hd(H_B, tid) = hd(H_K, tid) = hd(H_H, tid) =
        hd(H_SAFE, tid) = 0;
  }
  for (int i = tid; i < N_SLOTS * BP; i += nthr) slot[i] = KP;
  __syncthreads();

  // s = 0: forward M (and its pre-extension seed), reverse M; the begin /
  // end state seeds an open gap in the forward / reverse I or D ring
  for (int q = 0; q < ncell; ++q) {
    const int c = tid + q * nthr;
    if (c >= cells) break;
    const int b = c / KP, k = c - b * KP - kc;
    const size_t pair = pair0 + b;
    const int pl = hd(H_PLEN, b), tl = hd(H_TLEN, b);
    const int seed = k == 0 ? 0 : NEG;
    R.fm[c] = extend(seed, k, p.pattern + pair * p.Lp, p.text + pair * p.Lt,
                     pl, tl);
    R.fmp[c] = seed;
    R.rm[c] = extend(seed, k, p.pat_rev + pair * p.Lp, p.txt_rev + pair * p.Lt,
                     pl, tl);
    if (AFFINE) {
      R.fi[c] = p.begin_state == ST_I ? seed : NEG;
      R.fd[c] = p.begin_state == ST_D ? seed : NEG;
      R.ri[c] = p.end_state == ST_I ? seed : NEG;
      R.rd[c] = p.end_state == ST_D ? seed : NEG;
    }
  }
  int s = 1;
  bool cont = __syncthreads_or(tid < BP && !hd(H_MET, tid)) && s <= p.s_max;

  while (cont) {
    const size_t row = (size_t)(s % Wd) * cells;
    // ---- A: both fronts step, extend, store unpruned; reductions --------
    for (int q = 0; q < ncell; ++q) {
      const int c = tid + q * nthr;
      if (c >= cells) break;
      const int b = c / KP, j = c - b * KP, k = j - kc;
      if (hd(H_MET, b)) continue;
      const size_t pair = pair0 + b;
      const int pl = hd(H_PLEN, b), tl = hd(H_TLEN, b);
      int If, Df, Mfp, Ir, Dr, Mrp;
      const int Mf = step_cell<AFFINE>(R, R.fm, R.fi, R.fd, p, s, b, j, k, pl,
                                       tl, p.pattern + pair * p.Lp,
                                       p.text + pair * p.Lt, If, Df, Mfp);
      const int Mr = step_cell<AFFINE>(R, R.rm, R.ri, R.rd, p, s, b, j, k, pl,
                                       tl, p.pat_rev + pair * p.Lp,
                                       p.txt_rev + pair * p.Lt, Ir, Dr, Mrp);
      R.fm[row + c] = Mf;
      R.fmp[row + c] = Mfp;
      R.rm[row + c] = Mr;
      if (AFFINE) {
        R.fi[row + c] = If;
        R.fd[row + c] = Df;
        R.ri[row + c] = Ir;
        R.rd[row + c] = Dr;
      }
      if (HEUR == HEUR_ADAPTIVE) {
        if (Mf > THRESH) {
          atomicMin(&hd(H_RED_F, b), max(tl - Mf, pl - (Mf - k)));
          atomicAdd(&hd(H_LIVE_F, b), 1);
        }
        if (Mr > THRESH) {
          atomicMin(&hd(H_RED_R, b), max(tl - Mr, pl - (Mr - k)));
          atomicAdd(&hd(H_LIVE_R, b), 1);
        }
      } else if (HEUR == HEUR_ZDROP) {
        if (Mf > THRESH) atomicMax(&hd(H_RED_F, b), 2 * Mf - k);
        if (Mr > THRESH) atomicMax(&hd(H_RED_R, b), 2 * Mr - k);
      }
    }
    __syncthreads();
    // ---- B: prune (each front's M mask over that front's rings) --------
    if (HEUR != HEUR_NONE) {
      for (int q = 0; q < ncell; ++q) {
        const int c = tid + q * nthr;
        if (c >= cells) break;
        const int b = c / KP, k = c - b * KP - kc;
        if (hd(H_MET, b)) continue;
        const int pl = hd(H_PLEN, b), tl = hd(H_TLEN, b);
        for (int side = 0; side < 2; ++side) {
          int* mrow = (side ? R.rm : R.fm) + row + c;
          const int M = *mrow;
          const int red = hd(side ? H_RED_R : H_RED_F, b);
          bool keep = M > THRESH;
          if (keep && HEUR == HEUR_ADAPTIVE) {
            const int d = max(tl - M, pl - (M - k));
            keep = hd(side ? H_LIVE_R : H_LIVE_F, b) <= p.hp1 ||
                   d - red <= p.hp2;
          } else if (keep && HEUR == HEUR_ZDROP) {
            keep = red - (2 * M - k) <= p.hp1;
          }
          if (!keep) {
            *mrow = NEG;
            if (side == 0) R.fmp[row + c] = NEG;
            if (AFFINE) {
              (side ? R.ri : R.fi)[row + c] = NEG;
              (side ? R.rd : R.fd)[row + c] = NEG;
            }
          }
        }
      }
      __syncthreads();
    }
    // ---- C: meet test at the per-pair costs of both orientations -------
    for (int q = 0; q < ncell; ++q) {
      const int c = tid + q * nthr;
      if (c >= cells) break;
      const int b = c / KP, j = c - b * KP;
      if (hd(H_MET, b)) continue;
      const int pl = hd(H_PLEN, b), tl = hd(H_TLEN, b);
      const int jp = (tl - pl) + 2 * kc - j;  // complement lane (may be off)
      const int st2 = hd(H_STARGET, b) - oend;
      const unsigned bits_a = classes(
          side_at<AFFINE>(R, s, b, j, jp, KP, s, s, st2 - s, st2 + o_aff - s),
          tl);
      const unsigned bits_b = classes(
          side_at<AFFINE>(R, s, b, j, jp, KP, st2 - s, st2 + o_aff - s, s, s),
          tl);
      for (int cl = 0; cl < N_CLASSES; ++cl) {
        if (bits_a >> cl & 1u) atomicMin(&slot[b * N_SLOTS + 2 * cl], j);
        if (bits_b >> cl & 1u) atomicMin(&slot[b * N_SLOTS + 2 * cl + 1], j);
      }
    }
    __syncthreads();
    // ---- R: one thread per pair takes the first slot in priority order --
    if (tid < BP) {
      const int b = tid;
      if (!hd(H_MET, b)) {
        for (int sl = 0; sl < N_SLOTS; ++sl) {
          const int j = slot[b * N_SLOTS + sl];
          if (j >= KP) continue;
          const int cl = sl / 2, side = sl % 2;
          const int pl = hd(H_PLEN, b), tl = hd(H_TLEN, b);
          const int st2 = hd(H_STARGET, b) - oend;
          const int jp = (tl - pl) + 2 * kc - j;
          const int a_m = side ? st2 - s : s, a_g = side ? st2 + o_aff - s : s;
          const int b_m = side ? s : st2 - s, b_g = side ? s : st2 + o_aff - s;
          const Side v = side_at<AFFINE>(R, s, b, j, jp, KP, a_m, a_g, b_m, b_g);
          const bool mm = cl == MM_SAFE || cl == MM_COV;
          const bool ii = cl == II0 || cl == II_COV;
          int hv;
          if (mm) {
            const int low = max(j - kc, 0);
            hv = min(max(tl - v.rb_m, low), max(v.fa_m, low));
          } else {
            hv = ii ? v.fa_i : v.fa_d;
          }
          hd(H_MET, b) = 1;
          hd(H_STATE, b) = mm ? ST_M : (ii ? ST_I : ST_D);
          hd(H_A, b) = mm ? a_m : a_g;
          hd(H_B, b) = mm ? b_m : b_g;
          hd(H_K, b) = j - kc;
          hd(H_H, b) = hv;
          hd(H_SAFE, b) = cl == MM_SAFE || cl == II0 || cl == DD0;
          break;
        }
      }
      for (int sl = 0; sl < N_SLOTS; ++sl) slot[b * N_SLOTS + sl] = KP;
      hd(H_RED_F, b) = hd(H_RED_R, b) = red_init;
      hd(H_LIVE_F, b) = hd(H_LIVE_R, b) = 0;
    }
    ++s;
    cont = __syncthreads_or(tid < BP && !hd(H_MET, tid)) && s <= p.s_max;
  }
  if (tid < BP) {
    const int hit = hd(H_MET, tid) && !hd(H_MET0, tid);  // padded: unmet
    const int out = pair0 + tid;
    p.score[out] = hit ? hd(H_STARGET, tid) : -1;
    p.steps[out] = s;
    p.state[out] = hit ? hd(H_STATE, tid) : -1;
    p.a[out] = hd(H_A, tid);
    p.b[out] = hd(H_B, tid);
    p.k[out] = hd(H_K, tid);
    p.h[out] = hd(H_H, tid);
    p.safe[out] = hd(H_SAFE, tid);
  }
}

template <bool A, int H>
cudaError_t launch_meet(const MeetParams& p, int threads, size_t smem,
                        cudaStream_t stream) {
  auto kern = wfa_meet_kernel<A, H>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<p.B / p.BP, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool A>
cudaError_t meet_by_heur(const MeetParams& p, int heur, int threads,
                         size_t smem, cudaStream_t stream) {
  switch (heur) {
    case HEUR_NONE: return launch_meet<A, HEUR_NONE>(p, threads, smem, stream);
    case HEUR_ADAPTIVE:
      return launch_meet<A, HEUR_ADAPTIVE>(p, threads, smem, stream);
    case HEUR_ZDROP: return launch_meet<A, HEUR_ZDROP>(p, threads, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Ints of global scratch wfa_meet_launch needs for the rings of B pairs.
long long wfa_meet_scratch_ints(int B, int BP, int k_pad, int Wd, int affine) {
  if (BP < 1) return 0;
  return (long long)(B / BP) *
         (long long)(ring_bytes(BP, k_pad, Wd, affine) / sizeof(int));
}

// Launch one batched meet search on `stream`; `scratch` holds
// wfa_meet_scratch_ints(...) ints.  States are 0 = M,
// 1 = I, 2 = D.  Returns cudaGetLastError() after the launch (0 = launched);
// faults during the run surface at the next sync.
int wfa_meet_launch(const int* pattern, const int* text, const int* pat_rev,
                    const int* txt_rev, const int* plen, const int* tlen,
                    const int* starget, int* score, int* steps, int* state,
                    int* a, int* b, int* k, int* h, int* safe, int* scratch,
                    int B, int Lp, int Lt, int BP, int k_pad, int s_max, int x,
                    int o, int e, int Wd, int affine, int heur, int hp1,
                    int hp2, int begin_state, int end_state, void* stream) {
  if (BP < 1 || B % BP != 0 || k_pad < 2 || k_pad % 2 || Wd < 2)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const int cells = BP * k_pad;
  int threads = cells < MAX_THREADS ? cells : MAX_THREADS;
  threads = ((threads + 31) / 32) * 32;
  if (scratch == nullptr) return cudaErrorInvalidValue;
  const size_t smem = head_bytes(BP);
  MeetParams p{pattern, text, pat_rev, txt_rev, plen, tlen, starget, score,
               steps, state, a, b, k, h, safe, scratch, B, Lp, Lt, BP, k_pad,
               s_max, x, o, e, Wd, hp1, hp2, begin_state, end_state};
  cudaStream_t st = (cudaStream_t)stream;
  return affine ? meet_by_heur<true>(p, heur, threads, smem, st)
                : meet_by_heur<false>(p, heur, threads, smem, st);
}

}  // extern "C"
