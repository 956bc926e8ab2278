// BiWFA meet-in-the-middle search for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/wfa/kernel.py::wfa_meet_pallas
// (body _make_meet_kernel).  Same inputs, same outputs, bit for bit: eight
// [B,1] int32 arrays (score, steps, state, a, b, k, h, safe), the fields of
// BidirMeetResult plus the exit step.  Here `steps` is each pair's own exit
// step (its meet step + 1, 1 for a padded row, s_max + 1 unmet); the wrapper
// takes the max over each block of block_pairs rows (kernel.block_steps),
// which is the TPU kernel's per-block exit step.
//
// What bounds it on this card.  Each pair is a serial chain of about
// starget/2 score steps (864 at the 10 kb root wave); a step is a few integer
// operations on each lane the recurrence can reach, about 18 per front cell
// (five band-checked ring reads, the X / I / D candidates with their bounds,
// two maxima, the extension test and three stores), plus the character
// compares of the extension.  So the work is integer operations on cells
// that live one step, and the time is the latency of the chain: the memory
// the rings and the characters sit in, the lanes a step visits and the
// barriers between steps.  Measured (meet_variants.py): with the characters
// read as ints from device memory, the extension took about 70% of the time.
//
// Design.  One CTA of 256 threads per pair, so each pair stops at its own
// meet (a block of pairs stepped in lockstep until its slowest pair met).
// At most 64 registers a thread, so four CTAs fit an SM's registers: at the
// root wave four resident pairs per SM beat two with 256 threads and more
// registers, and 128, 192 or 512 threads (meet_variants.py).
//   * The characters narrowed to bytes in shared memory (the wrapper holds
//     every code in [0, 255], so bytes compare exactly as the ints do), four
//     compared per step of the extension: two aligned words, funnel-shifted,
//     XORed, the first differing byte by __ffs.  A pair's four rows (pattern,
//     text, both reversed) at 10 kb take 41 KB; rows past about 58 kb each
//     do not fit, and then the same bytes live in global scratch.
//   * Rings at the depth the recurrence reads: M at s - x and s - (o+e)
//     needs max(x, o+e) + 1 rows (model.window), I and D at s - e need
//     e + 1; two fronts; linear models keep M only.  GapAffine(4,6,2) at
//     k_pad 896: 30 rows x 896 x 4 B = 107,520 B.  They live in global
//     scratch, where L1 holds the few rows a step reads: in shared memory
//     they would leave room for one or two CTAs per SM.
//   * Only the live band.  kernel.meet_band (Python, held against the JAX
//     package's full histories) gives, per step and front, the lane range
//     [lo, hi] the recurrence can reach from the seeds; the wrapper passes
//     the M range (which holds the I and D ranges).  A step computes and
//     stores only those lanes, a read outside its row's range is NEG, and a
//     step whose ranges are empty (odd steps for even penalties) does
//     nothing.  Pruning only clears lanes, so the range stays an upper bound
//     under every heuristic.
//   * The meet test only where it can fire: at step s it reads the forward
//     rows at s and st2 - s (st2 + o - s for gaps) and the reverse rows at
//     the other cost, visible at costs in (s - Wd, s].  So it runs from
//     first = max(1, ceil(st2 / 2)) and can hold nothing from
//     stop = ceil((st2 + o + Wd) / 2) on, where the pair exits unmet
//     (kernel.meet_test_steps).  The rows it reads (M, the pre-extension M,
//     I, D of both fronts) are archived from first - Wd + 1 on, into a
//     per-pair window of Wd rows in global scratch, written only then; the
//     window rule (costs <= s - Wd invisible) is checked on every read.
//   * One barrier per step outside the meet window with no heuristic; two
//     with one (per-pair reductions by warp shuffles and one shared atomic
//     per warp, then the prune); one more per step inside the window, where
//     each (class, orientation) slot's lowest lane comes from __ballot_sync
//     and __ffs per warp and one shared atomicMin per warp.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG = -(1 << 20);
constexpr int THRESH = NEG / 2;
constexpr int BIG = 1 << 20;
constexpr int EMPTY_LO = 1 << 30;       // a lane range that holds nothing
constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr int N_CLASSES = 6;            // mm_safe ii0 dd0 mm_cov ii_cov dd_cov
constexpr int N_SLOTS = 2 * N_CLASSES;  // x orientation A, B
enum Class { MM_SAFE = 0, II0 = 1, DD0 = 2, MM_COV = 3, II_COV = 4, DD_COV = 5 };
enum Heur { HEUR_NONE = 0, HEUR_ADAPTIVE = 1, HEUR_ZDROP = 2 };
enum State { ST_M = 0, ST_I = 1, ST_D = 2 };
// archive planes: forward M, pre-extension M, reverse M, then (affine)
// forward I, D, reverse I, D
enum Plane { P_FM = 0, P_FMP = 1, P_RM = 2, P_FI = 3, P_FD = 4, P_RI = 5,
             P_RD = 6 };
// shared ints ahead of the sequences: red[2 parity][2 front][2], slot[2][12]
constexpr int RED_INTS = 8;
constexpr int SMALL_INTS = RED_INTS + 2 * N_SLOTS;
constexpr size_t MAX_SMEM = 232448;     // per-block opt-in on sm_90

struct MeetParams {
  const int* pattern;  // [B, Lp]
  const int* text;     // [B, Lt]
  const int* pat_rev;  // [B, Lp] each row reversed up to its length
  const int* txt_rev;  // [B, Lt]
  const int* plen;     // [B]
  const int* tlen;     // [B]
  const int* starget;  // [B] known optimal cost
  const int2* band;    // [s_max + 1][2 fronts]: the M lane range (lo, hi)
  int* score;          // [B] outputs; steps: each pair's exit step
  int* steps;
  int* state;
  int* a;
  int* b;
  int* k;
  int* h;
  int* safe;
  int* archive;        // [B][planes][Wd][k_pad], global scratch
  int* rings;          // [B][ring ints]
  uint8_t* gseq;       // [B][seq bytes] when the sequences are not in shared
  int B, Lp, Lt, k_pad, s_max, x, o, e, Wd, Dm, De, hp1, hp2, begin_state,
      end_state;
};

// Ints of one pair's rings: Dm rows of M and (affine) De rows each of I and
// D for both fronts, plus one row of the forward pre-extension M.
__host__ __device__ size_t ring_ints(int k_pad, int Dm, int De,
                                     int affine) {
  return (size_t)(2 * (Dm + (affine ? 2 * De : 0)) + 1) * k_pad;
}

__host__ __device__ size_t archive_ints(int k_pad, int Wd,
                                        int affine) {
  return (size_t)(affine ? 7 : 3) * Wd * k_pad;
}

// Bytes of one row of L characters, narrowed to bytes: rounded up to a
// word, plus the word a 4-byte compare may read past its end.
__host__ __device__ int seq_row_bytes(int L) { return (L + 3) / 4 * 4 + 4; }

// One pair's four sequences (pattern, text, both reversed) as bytes.
__host__ __device__ size_t seq_bytes(int Lp, int Lt) {
  return 2 * (size_t)(seq_row_bytes(Lp) + seq_row_bytes(Lt));
}

// Whether a pair's sequences fit in shared memory beside the small arrays
// (every character compare reads them); else they go to global scratch.
bool seq_in_smem(int Lp, int Lt) {
  return SMALL_INTS * sizeof(int) + seq_bytes(Lp, Lt) <= MAX_SMEM;
}

// Ints of global scratch per pair: the archive window, the rings and the
// sequences when shared memory does not hold them.
size_t scratch_ints(int Lp, int Lt, int k_pad, int Wd, int Dm, int De,
                    int affine) {
  return archive_ints(k_pad, Wd, affine) + ring_ints(k_pad, Dm, De, affine) +
         (seq_in_smem(Lp, Lt) ? 0 : seq_bytes(Lp, Lt) / sizeof(int));
}

__device__ __forceinline__ int2 band_at(const int2* band, int c, int f) {
  return c < 0 ? make_int2(EMPTY_LO, -1) : __ldg(band + 2 * c + f);
}

__device__ __forceinline__ bool inb(int j, int2 r) {
  return j >= r.x && j <= r.y;
}

// Four characters from byte i on: two aligned words, funnel-shifted (the
// first character in the lowest byte).
__device__ __forceinline__ uint32_t load4(const uint8_t* row, int i) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(row + (i & ~3));
  return __funnelshift_r(w[0], w[1], (i & 3) * 8);
}

// Greedy diagonal extension M += LCP(t[M:], p[M-k:]), four characters per
// compare: the first differing byte of the XOR ends the run.
__device__ __forceinline__ int extend(int M, int k, const uint8_t* prow,
                                      const uint8_t* trow, int pl, int tl) {
  if (M <= THRESH) return M;
  int v = M - k;
  if (M < 0 || v < 0) return M;
  while (M < tl && v < pl) {
    const uint32_t x = load4(trow, M) ^ load4(prow, v);
    const int n = min(4, min(tl - M, pl - v));
    const int eq = x ? (__ffs(x) - 1) >> 3 : 4;
    if (eq < n) return M + eq;
    M += n;
    v += n;
  }
  return M;
}

// One front's rings: row r of M at m + r * KP, of I / D at ii / dd + r * KP.
struct Front {
  int* m;
  int* ii;
  int* dd;
};

// Where one step reads and writes: row offsets and lane ranges of the
// sources (M at s - x, M at s - (o+e) for affine / s - e for linear, I and
// D at s - e), and of the row written.
struct StepRows {
  int rx, rg, re, wm, we;
  int2 bx, bg, be;
};

// One WFA step of one cell; returns M after extension and sets I, D and the
// pre-extension M.
template <bool AFFINE>
__device__ __forceinline__ int step_cell(const Front& F, const StepRows& r,
                                         int j, int k, int pl, int tl,
                                         const uint8_t* prow,
                                         const uint8_t* trow, int& I, int& D,
                                         int& Mpre) {
  const int m_x = inb(j, r.bx) ? F.m[r.rx + j] : NEG;
  int i_src, d_src;
  if (AFFINE) {
    i_src = max(inb(j - 1, r.bg) ? F.m[r.rg + j - 1] : NEG,
                inb(j - 1, r.be) ? F.ii[r.re + j - 1] : NEG);
    d_src = max(inb(j + 1, r.bg) ? F.m[r.rg + j + 1] : NEG,
                inb(j + 1, r.be) ? F.dd[r.re + j + 1] : NEG);
  } else {
    i_src = inb(j - 1, r.bg) ? F.m[r.rg + j - 1] : NEG;
    d_src = inb(j + 1, r.bg) ? F.m[r.rg + j + 1] : NEG;
  }
  I = (i_src > THRESH && i_src + 1 <= tl) ? i_src + 1 : NEG;
  D = (d_src > THRESH && d_src - k <= pl) ? d_src : NEG;
  const int X = (m_x > THRESH && m_x + 1 <= tl && m_x + 1 - k <= pl) ? m_x + 1
                                                                    : NEG;
  Mpre = max(max(X, I), D);
  return extend(Mpre, k, prow, trow, pl, tl);
}

// The archive of one pair: plane p, cost c at row c % Wd.
struct Archive {
  int* base;
  const int2* band;
  int KP, Wd;
  __device__ __forceinline__ int* row(int plane, int c) const {
    return base + ((size_t)plane * Wd + c % Wd) * KP;
  }
  // plane p of front f at per-pair cost c, NEG outside the window (c in
  // (s - Wd, s]), the lanes or the front's band at c
  __device__ __forceinline__ int at(int plane, int f, int c, int s,
                                    int j) const {
    if (c < 0 || c > s || c <= s - Wd || j < 0 || j >= KP) return NEG;
    if (!inb(j, __ldg(band + 2 * c + f))) return NEG;
    return row(plane, c)[j];
  }
};

// The ring values one orientation's candidate classes read at lane j.
struct Side {
  int fa_m, fa_mp, rb_m, fa_i, rb_i, fa_d, rb_d;
};

template <bool AFFINE>
__device__ __forceinline__ Side side_at(const Archive& A, int s, int j, int jp,
                                        int a_m, int a_g, int b_m, int b_g) {
  Side v;
  v.fa_m = A.at(P_FM, 0, a_m, s, j);
  v.fa_mp = A.at(P_FMP, 0, a_m, s, j);
  v.rb_m = A.at(P_RM, 1, b_m, s, jp);
  v.fa_i = v.rb_i = v.fa_d = v.rb_d = NEG;
  if (AFFINE) {
    v.fa_i = A.at(P_FI, 0, a_g, s, j);
    v.rb_i = A.at(P_RI, 1, b_g, s, jp);
    v.fa_d = A.at(P_FD, 0, a_g, s, j);
    v.rb_d = A.at(P_RD, 1, b_g, s, jp);
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

__device__ __forceinline__ int warp_min(int v) {
  for (int d = 16; d; d >>= 1) v = min(v, __shfl_xor_sync(FULL, v, d));
  return v;
}
__device__ __forceinline__ int warp_max(int v) {
  for (int d = 16; d; d >>= 1) v = max(v, __shfl_xor_sync(FULL, v, d));
  return v;
}
__device__ __forceinline__ int warp_sum(int v) {
  for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
  return v;
}

__device__ __forceinline__ void write_out(const MeetParams& p, int pair,
                                          int score, int steps, int state,
                                          int a, int b, int k, int h,
                                          int safe) {
  p.score[pair] = score;
  p.steps[pair] = steps;
  p.state[pair] = state;
  p.a[pair] = a;
  p.b[pair] = b;
  p.k[pair] = k;
  p.h[pair] = h;
  p.safe[pair] = safe;
}

template <bool AFFINE, int HEUR>
__global__ void __launch_bounds__(THREADS, 4) wfa_meet_kernel(const MeetParams p) {
  extern __shared__ int smem[];
  const int KP = p.k_pad, kc = KP / 2, Wd = p.Wd, Dm = p.Dm;
  const int De = AFFINE ? p.De : 0;
  const int pair = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pl_raw = p.plen[pair], tl_raw = p.tlen[pair];
  if (pl_raw == 0 && tl_raw == 0) {       // padded row: reported unmet
    if (tid == 0) write_out(p, pair, -1, 1, -1, 0, 0, 0, 0, 0);
    return;
  }
  // a length past its row would read out of bounds: clamp it to the row
  const int pl = min(pl_raw, p.Lp), tl = min(tl_raw, p.Lt);
  const int starget = p.starget[pair];
  const int o_aff = AFFINE ? p.o : 0;
  // end state I/D: the reverse rings seed the trailing gap at 0, so every
  // reverse cost sits o below the forward convention; shift the target once
  const int st2 = starget - (p.end_state != ST_M ? o_aff : 0);
  const int first = max(1, (st2 + 1) >> 1);         // floor division
  const int stop = (st2 + o_aff + Wd + 1) >> 1;
  const int s_arch = max(0, first - Wd + 1);
  // the last step to run: none if no step can test
  const int s_end = first <= min(p.s_max, stop - 1) ? min(p.s_max, stop - 1)
                                                     : 0;
  const int unmet_steps = max(p.s_max, 0) + 1;
  if (s_end == 0) {
    if (tid == 0) write_out(p, pair, -1, unmet_steps, -1, 0, 0, 0, 0, 0);
    return;
  }

  int* red = smem;                        // [2 parity][2 front][value, live]
  int* slot = smem + RED_INTS;            // [2 parity][N_SLOTS] lowest lane
  // shared: the small arrays, then the sequences where the launch put them
  uint8_t* sq = p.gseq ? p.gseq + (size_t)pair * seq_bytes(p.Lp, p.Lt)
                       : reinterpret_cast<uint8_t*>(smem + SMALL_INTS);
  int* rg = p.rings + (size_t)pair * ring_ints(KP, Dm, De, AFFINE);
  Front F[2];
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    int* base = rg + (size_t)f * (Dm + 2 * De) * KP;
    F[f] = Front{base, base + Dm * KP, base + (Dm + De) * KP};
  }
  int* fmp_row = rg + (size_t)2 * (Dm + 2 * De) * KP;
  const Archive A{p.archive + (size_t)pair * archive_ints(KP, Wd, AFFINE),
                  p.band, KP, Wd};
  // the four sequences narrowed to bytes (the wrapper holds every code in
  // [0, 255], so two bytes are equal exactly when the ints are)
  const int rp = seq_row_bytes(p.Lp), rt = seq_row_bytes(p.Lt);
  const uint8_t* prow[2] = {sq, sq + rp + rt};
  const uint8_t* trow[2] = {sq + rp, sq + 2 * rp + rt};
  {
    const int* src[4] = {p.pattern + (size_t)pair * p.Lp,
                         p.text + (size_t)pair * p.Lt,
                         p.pat_rev + (size_t)pair * p.Lp,
                         p.txt_rev + (size_t)pair * p.Lt};
    const int len[4] = {pl, tl, pl, tl};
    uint8_t* dst[4] = {sq, sq + rp, sq + rp + rt, sq + 2 * rp + rt};
#pragma unroll
    for (int r = 0; r < 4; ++r)
      for (int i = tid; i < len[r]; i += THREADS)
        dst[r][i] = static_cast<uint8_t>(__ldg(src[r] + i));
  }
  __syncthreads();
  const int seed_state[2] = {p.begin_state, p.end_state};
  const int red_init = HEUR == HEUR_ZDROP ? -BIG : BIG;
  if (tid < RED_INTS) red[tid] = tid & 1 ? 0 : red_init;
  if (tid < 2 * N_SLOTS) slot[tid] = KP;

  // s = 0: M (and the pre-extension seed) at kc, the begin / end state's
  // open gap in the forward / reverse I or D ring
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    const int2 b0 = band_at(p.band, 0, f);
    for (int j = b0.x + tid; j <= b0.y; j += THREADS) {
      const int k = j - kc;
      const int seed = k == 0 ? 0 : NEG;
      const int M = extend(seed, k, prow[f], trow[f], pl, tl);
      const int I = seed_state[f] == ST_I ? seed : NEG;
      const int D = seed_state[f] == ST_D ? seed : NEG;
      F[f].m[j] = M;
      if (AFFINE) {
        F[f].ii[j] = I;
        F[f].dd[j] = D;
      }
      if (s_arch == 0) {
        A.row(f ? P_RM : P_FM, 0)[j] = M;
        if (f == 0) A.row(P_FMP, 0)[j] = seed;
        if (AFFINE) {
          A.row(f ? P_RI : P_FI, 0)[j] = I;
          A.row(f ? P_RD : P_FD, 0)[j] = D;
        }
      }
    }
  }
  __syncthreads();

  int hpar = 0;  // parity of the heuristic's reduction slots (computed steps)
  for (int s = 1; s <= s_end; ++s) {
    const bool testing = s >= first;
    const bool archiving = s >= s_arch;
    const int2 bnd[2] = {band_at(p.band, s, 0), band_at(p.band, s, 1)};
    const int jlo = min(bnd[0].x, bnd[1].x), jhi = max(bnd[0].y, bnd[1].y);
    const bool any = jlo <= jhi;
    if (!any && !testing) continue;       // nothing to compute or test
    if (any) {
      // ---- both fronts step over their bands, extend, store --------------
      const int cg = AFFINE ? s - (p.o + p.e) : s - p.e;
      StepRows r[2];
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        r[f].bx = band_at(p.band, s - p.x, f);
        r[f].bg = band_at(p.band, cg, f);
        r[f].be = band_at(p.band, s - p.e, f);
        r[f].rx = ((s - p.x) % Dm) * KP;
        r[f].rg = (cg % Dm) * KP;
        r[f].re = AFFINE ? ((s - p.e) % De) * KP : 0;
        r[f].wm = (s % Dm) * KP;
        r[f].we = AFFINE ? (s % De) * KP : 0;
      }
      int acc[2] = {red_init, red_init}, live[2] = {0, 0};
      for (int j = jlo + tid; j <= jhi; j += THREADS) {
        const int k = j - kc;
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          if (!inb(j, bnd[f])) continue;
          int I, D, Mpre;
          const int M = step_cell<AFFINE>(F[f], r[f], j, k, pl, tl, prow[f],
                                          trow[f], I, D, Mpre);
          F[f].m[r[f].wm + j] = M;
          if (AFFINE) {
            F[f].ii[r[f].we + j] = I;
            F[f].dd[r[f].we + j] = D;
          }
          if (HEUR != HEUR_NONE) {
            if (f == 0) fmp_row[j] = Mpre;
            if (M > THRESH) {
              if (HEUR == HEUR_ADAPTIVE) {
                acc[f] = min(acc[f], max(tl - M, pl - (M - k)));
                ++live[f];
              } else {
                acc[f] = max(acc[f], 2 * M - k);
              }
            }
          } else if (archiving) {
            A.row(f ? P_RM : P_FM, s)[j] = M;
            if (f == 0) A.row(P_FMP, s)[j] = Mpre;
            if (AFFINE) {
              A.row(f ? P_RI : P_FI, s)[j] = I;
              A.row(f ? P_RD : P_FD, s)[j] = D;
            }
          }
        }
      }
      if (HEUR != HEUR_NONE) {
        // ---- per-pair reductions of the unpruned rows, then the prune ----
        int* rd = red + hpar * 4;
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          if (HEUR == HEUR_ADAPTIVE) {
            const int v = warp_min(acc[f]), n = warp_sum(live[f]);
            if (lane == 0 && n) {
              atomicMin(&rd[2 * f], v);
              atomicAdd(&rd[2 * f + 1], n);
            }
          } else {
            const int v = warp_max(acc[f]);
            if (lane == 0 && v != red_init) atomicMax(&rd[2 * f], v);
          }
        }
        __syncthreads();
        if (tid < 4) red[(hpar ^ 1) * 4 + tid] = tid & 1 ? 0 : red_init;
        for (int j = jlo + tid; j <= jhi; j += THREADS) {
          const int k = j - kc;
#pragma unroll
          for (int f = 0; f < 2; ++f) {
            if (!inb(j, bnd[f])) continue;
            int* mp = F[f].m + r[f].wm + j;
            int M = *mp;
            bool keep = M > THRESH;
            if (keep && HEUR == HEUR_ADAPTIVE) {
              const int d = max(tl - M, pl - (M - k));
              keep = rd[2 * f + 1] <= p.hp1 || d - rd[2 * f] <= p.hp2;
            } else if (keep && HEUR == HEUR_ZDROP) {
              keep = rd[2 * f] - (2 * M - k) <= p.hp1;
            }
            int I = NEG, D = NEG;
            if (!keep) {
              *mp = M = NEG;
              if (f == 0) fmp_row[j] = NEG;
              if (AFFINE) F[f].ii[r[f].we + j] = F[f].dd[r[f].we + j] = NEG;
            } else if (AFFINE) {
              I = F[f].ii[r[f].we + j];
              D = F[f].dd[r[f].we + j];
            }
            if (archiving) {
              A.row(f ? P_RM : P_FM, s)[j] = M;
              if (f == 0) A.row(P_FMP, s)[j] = fmp_row[j];
              if (AFFINE) {
                A.row(f ? P_RI : P_FI, s)[j] = I;
                A.row(f ? P_RD : P_FD, s)[j] = D;
              }
            }
          }
        }
        hpar ^= 1;
      }
    }
    // rows of s written; the slots of s reset (steps without lanes too)
    __syncthreads();
    if (!testing) continue;
    // ---- the meet test at the costs of both orientations -----------------
    int* sl = slot + (s & 1) * N_SLOTS;
    const int jdiff = (tl - pl) + 2 * kc;   // complement lane: jdiff - j
    const int cm = st2 - s, cgap = st2 + o_aff - s;
    for (int base = 0; base < KP; base += THREADS) {
      const int j = base + tid;
      unsigned bits_a = 0, bits_b = 0;
      if (j < KP) {
        bits_a = classes(side_at<AFFINE>(A, s, j, jdiff - j, s, s, cm, cgap),
                         tl);
        bits_b = classes(side_at<AFFINE>(A, s, j, jdiff - j, cm, cgap, s, s),
                         tl);
      }
      if (!__any_sync(FULL, bits_a | bits_b)) continue;
      for (int cl = 0; cl < N_CLASSES; ++cl) {
        const unsigned ba = __ballot_sync(FULL, bits_a >> cl & 1u);
        const unsigned bb = __ballot_sync(FULL, bits_b >> cl & 1u);
        if (lane == 0) {
          const int w0 = base + warp * 32 - 1;
          if (ba) atomicMin(&sl[2 * cl], w0 + __ffs(ba));
          if (bb) atomicMin(&sl[2 * cl + 1], w0 + __ffs(bb));
        }
      }
    }
    __syncthreads();
    // ---- the first slot in priority order, at its lowest lane ------------
    int q = 0, j = KP;
    for (; q < N_SLOTS; ++q) {
      j = sl[q];
      if (j < KP) break;
    }
    if (j < KP) {
      if (tid == 0) {
        const int cl = q / 2, side = q % 2;
        const int a_m = side ? cm : s, a_g = side ? cgap : s;
        const int b_m = side ? s : cm, b_g = side ? s : cgap;
        const Side v = side_at<AFFINE>(A, s, j, jdiff - j, a_m, a_g, b_m, b_g);
        const bool mm = cl == MM_SAFE || cl == MM_COV;
        const bool ii = cl == II0 || cl == II_COV;
        int hv;
        if (mm) {
          const int low = max(j - kc, 0);
          hv = min(max(tl - v.rb_m, low), max(v.fa_m, low));
        } else {
          hv = ii ? v.fa_i : v.fa_d;
        }
        write_out(p, pair, starget, s + 1, mm ? ST_M : (ii ? ST_I : ST_D),
                  mm ? a_m : a_g, mm ? b_m : b_g, j - kc, hv,
                  cl == MM_SAFE || cl == II0 || cl == DD0);
      }
      return;
    }
    if (tid < N_SLOTS) slot[((s + 1) & 1) * N_SLOTS + tid] = KP;
  }
  if (tid == 0) write_out(p, pair, -1, unmet_steps, -1, 0, 0, 0, 0, 0);
}

// Timing events recorded on the stream right around the kernel (null: none).
struct Marks {
  void* start;
  void* end;
};

template <bool A, int H>
cudaError_t launch_meet(const MeetParams& p, size_t smem, cudaStream_t stream,
                        Marks m) {
  auto kern = wfa_meet_kernel<A, H>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (m.start && (err = cudaEventRecord((cudaEvent_t)m.start, stream)) !=
                     cudaSuccess)
    return err;
  kern<<<p.B, THREADS, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err == cudaSuccess && m.end)
    err = cudaEventRecord((cudaEvent_t)m.end, stream);
  return err;
}

template <bool A>
cudaError_t meet_by_heur(const MeetParams& p, int heur, size_t smem,
                         cudaStream_t stream, Marks m) {
  switch (heur) {
    case HEUR_NONE: return launch_meet<A, HEUR_NONE>(p, smem, stream, m);
    case HEUR_ADAPTIVE:
      return launch_meet<A, HEUR_ADAPTIVE>(p, smem, stream, m);
    case HEUR_ZDROP: return launch_meet<A, HEUR_ZDROP>(p, smem, stream, m);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Ints of global scratch wfa_meet_launch needs for B pairs: each pair's
// archive window and rings, and its sequences where shared memory does not
// hold them.
long long wfa_meet_scratch_ints(int B, int Lp, int Lt, int k_pad, int Wd,
                                int Dm, int De, int affine) {
  return (long long)B *
         (long long)scratch_ints(Lp, Lt, k_pad, Wd, Dm, De, affine);
}

// Launch one batched meet search on `stream`: one CTA per pair.  `band`
// holds kernel.meet_band's M ranges, [s_max + 1][2][2] ints; `steps` gets
// each pair's exit step; `scratch` holds wfa_meet_scratch_ints(...) ints.
// Every character code must lie in [0, 255] (they are compared as bytes).
// States are 0 = M, 1 = I, 2 = D.  `mark_start` / `mark_end` (cudaEvent_t,
// or null) are recorded on `stream` right around the kernel.  Returns
// cudaGetLastError() after the launch (0 = launched); faults during the run
// surface at the next sync.
int wfa_meet_launch(const int* pattern, const int* text, const int* pat_rev,
                    const int* txt_rev, const int* plen, const int* tlen,
                    const int* starget, const int* band, int* score,
                    int* steps, int* state, int* a, int* b, int* k, int* h,
                    int* safe, int* scratch, int B, int Lp, int Lt, int k_pad,
                    int s_max, int x, int o, int e, int Wd, int Dm, int De,
                    int affine, int heur, int hp1, int hp2, int begin_state,
                    int end_state, void* stream, void* mark_start,
                    void* mark_end) {
  const int reach = affine ? o + e : e;   // the recurrence's deepest read
  if (k_pad < 2 || k_pad % 2 || x < 1 || e < 1 || o < 0 ||
      (affine && De != e + 1) || Dm <= x || Dm <= reach || Wd < Dm || B < 0 ||
      Lp < 0 || Lt < 0)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  if (scratch == nullptr || band == nullptr) return cudaErrorInvalidValue;
  const bool seq_smem = seq_in_smem(Lp, Lt);
  int* rings = scratch + (size_t)B * archive_ints(k_pad, Wd, affine);
  int* rest = rings + (size_t)B * ring_ints(k_pad, Dm, De, affine);
  uint8_t* gseq = seq_smem ? nullptr : reinterpret_cast<uint8_t*>(rest);
  const size_t smem =
      SMALL_INTS * sizeof(int) + (seq_smem ? seq_bytes(Lp, Lt) : 0);
  MeetParams p{pattern, text, pat_rev, txt_rev, plen, tlen, starget,
               (const int2*)band, score, steps, state, a, b, k, h, safe,
               scratch, rings, gseq, B, Lp, Lt, k_pad, s_max, x, o, e, Wd,
               Dm, affine ? De : 0, hp1, hp2, begin_state, end_state};
  cudaStream_t st = (cudaStream_t)stream;
  const Marks m{mark_start, mark_end};
  return affine ? meet_by_heur<true>(p, heur, smem, st, m)
                : meet_by_heur<false>(p, heur, smem, st, m);
}

}  // extern "C"
