// Traceback of the packed trace on the card: each pair's 2-bit provenance
// codes, as the trace kernel (wfa.cu, TRACE) leaves them in device memory,
// decoded into its CIGAR ops.
//
// Replaces no TPU kernel: the JAX package, like core/cigar.py on CPU
// tensors, copies the [NW, B, k_pad] planes to the host and decodes them
// there (traceback_packed_batch: _walk_packed / _walk_packed_linear, then
// _replay).  Same codes, same guard, same errors, same ops, bit for bit
// (core/cigar.py::decode_packed_plain is the yardstick): per pair, the ops
// as int8 in a row of L = Lp + Lt bytes padded with -1, their count, and a
// status row [code, s, k, h] (0, or the host walk's error and its
// coordinates; core/cigar.py::TB_ERRORS names the codes).  Unresolved pairs
// (score < 0) and pairs with an error get no ops.  Boundary states are M to
// M only, as the trace kernel takes none.
//
// What bounds it.  Two serial chains a pair: phase A, the walk from the end
// cell back to the origin, one dependent load of a plane word per step (the
// planes were written just before, and a 100 bp wave's fit in the 50 MB
// L2); phase B, the replay, one match run per edit.  At 100 bp a pair has a
// few edits and runs of about 30 characters, so the kernel is a few
// microseconds of latency, against the copy of ~16x the planes' bytes to the
// host and tens of microseconds of Python per pair that it replaces.
//
// Design.  One warp per pair, four pairs a block.
//   * Lane 0 walks (phase A) and writes the edit chain, op << 1 |
//     extend_after, back to front into a per-pair scratch of `cap` bytes
//     (a chain holds at most s / min(x, e) + 1 edits: each costs at least
//     min(x, e), and no edit is read at s <= 0).
//   * The warp replays (phase B): every lane holds the same (v, h, pos);
//     each match run is found 32 characters a step (one compare a lane,
//     __ballot_sync, __ffs) on the int32 rows, so every code compares
//     exactly, and its M ops are written by the lanes side by side.
//   * The rest of the row is padded with -1 by the warp; no memset.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TB_WARPS = 4;            // pairs a block
constexpr int CELLS_PER_WORD = 16;
constexpr unsigned FULL = 0xffffffffu;

enum { OP_M = 0, OP_X = 1, OP_I = 2, OP_D = 3 };
enum { ST_M = 0, ST_I = 1, ST_D = 2 };
// Status codes, core/cigar.py::TB_ERRORS: 1-7 the walk's (s, k), 8-10 the
// replay's (h), 11 the replay's end check (v in the s slot, h).
enum {
  ERR_ORIGIN = 1,       // origin cell off diagonal 0
  ERR_M_CODE = 2,       // invalid M provenance code
  ERR_I_SEED = 3,       // I chain hit s=0 off the gap seed
  ERR_D_SEED = 4,       // D chain hit s=0 off the gap seed
  ERR_I_CODE = 5,       // invalid I provenance code
  ERR_D_CODE = 6,       // invalid D provenance code
  ERR_GUARD = 7,        // packed traceback did not terminate
  ERR_X_PAST = 8,       // mismatch op past sequence end
  ERR_I_PAST = 9,       // insertion op past text end
  ERR_D_PAST = 10,      // deletion op past pattern end
  ERR_CONSUMED = 11,    // replay consumed (v, h) of (plen, tlen)
};

struct TbParams {
  const int* score;        // [B]
  const uint32_t* bt[3];   // [NW, B, K] code planes M, I, D (I, D: affine)
  const int* pattern;      // [B, Lp]
  const int* text;         // [B, Lt]
  const int* plen;         // [B]
  const int* tlen;         // [B]
  int8_t* ops;             // [B, L]
  int* n_ops;              // [B]
  int* status;             // [B, 4]
  uint8_t* chain;          // [B, cap]
  int B, Lp, Lt, L, NW, K, cap, x, o, e;
};

// 2-bit code of cell (s, k) of pair b (core/cigar.py::_code_at): 0 outside
// the planes.
__device__ __forceinline__ int code_at(const TbParams& p, int plane, int b,
                                       int s, int k) {
  const int j = k + p.K / 2;
  if (s < 0 || j < 0 || j >= p.K || s / CELLS_PER_WORD >= p.NW) return 0;
  const uint32_t w =
      p.bt[plane][((size_t)(s / CELLS_PER_WORD) * p.B + b) * p.K + j];
  return (w >> (2 * (s % CELLS_PER_WORD))) & 3u;
}

// Phase A (_walk_packed / _walk_packed_linear with begin and end state M):
// the edit chain back to front into `chain` -> its length, or -1 with the
// error in `err` (code, s, k).
template <bool AFFINE>
__device__ int walk(const TbParams& p, int b, int score, int pl, int tl,
                    uint8_t* chain, int3& err) {
  int s = score, k = tl - pl, state = ST_M, close = 0, n = 0;
  long long guard = 4LL * (pl + tl) + 4LL * (s + 1) + 8;
  auto push = [&](int code) {
    if (n >= p.cap) return false;   // unreachable: cap bounds every chain
    chain[n++] = (uint8_t)code;
    return true;
  };
  while (guard > 0) {
    --guard;
    if (state == ST_M) {
      if (s == 0) {
        if (k != 0) {
          err = make_int3(ERR_ORIGIN, s, k);
          return -1;
        }
        return n;
      }
      const int c = code_at(p, 0, b, s, k);
      if (c == 1) {
        if (!push(OP_X << 1 | 1)) break;
        s -= p.x;
      } else if (c == 2 && AFFINE) {
        state = ST_I;
        close = 1;
      } else if (c == 3 && AFFINE) {
        state = ST_D;
        close = 1;
      } else if (c == 2) {
        if (!push(OP_I << 1 | 1)) break;
        s -= p.e;
        k -= 1;
      } else if (c == 3) {
        if (!push(OP_D << 1 | 1)) break;
        s -= p.e;
        k += 1;
      } else {
        err = make_int3(ERR_M_CODE, s, k);
        return -1;
      }
    } else {
      const bool ins = state == ST_I;
      if (s == 0) {   // no gap seed: the begin state is M
        err = make_int3(ins ? ERR_I_SEED : ERR_D_SEED, s, k);
        return -1;
      }
      const int c = code_at(p, ins ? 1 : 2, b, s, k);
      if (c == 0) {
        err = make_int3(ins ? ERR_I_CODE : ERR_D_CODE, s, k);
        return -1;
      }
      if (!push((ins ? OP_I : OP_D) << 1 | close)) break;
      close = 0;
      k += ins ? -1 : 1;
      if (c == 2) {   // extension
        s -= p.e;
      } else {
        s -= p.o + p.e;
        state = ST_M;
      }
    }
  }
  err = make_int3(ERR_GUARD, s, k);
  return -1;
}

// Length of the match run of pattern[v:] against text[h:] (rows clamped to
// plr / tlr characters), 32 characters a step; the same on every lane.
__device__ __forceinline__ int lcp(const int* prow, const int* trow, int v,
                                   int h, int plr, int tlr, int lane) {
  const int n = min(plr - v, tlr - h);
  if (n <= 0) return 0;
  for (int r = 0;; r += 32) {
    const int i = r + lane;
    const bool stop = i >= n || prow[v + i] != trow[h + i];
    const unsigned m = __ballot_sync(FULL, stop);
    if (m) return r + __ffs(m) - 1;
  }
}

template <bool AFFINE>
__global__ void __launch_bounds__(TB_WARPS * 32)
    wfa_traceback_kernel(const TbParams p) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * TB_WARPS + (threadIdx.x >> 5);
  if (b >= p.B) return;   // whole warps
  int8_t* orow = p.ops + (size_t)b * p.L;
  uint8_t* chain = p.chain + (size_t)b * p.cap;
  const int score = p.score[b];
  // a length past its row is clamped to the row, as the trace kernel does
  const int pl = min(p.plen[b], p.Lp), tl = min(p.tlen[b], p.Lt);
  const int* prow = p.pattern + (size_t)b * p.Lp;
  const int* trow = p.text + (size_t)b * p.Lt;
  int4 st = make_int4(0, 0, 0, 0);
  int pos = 0;
  if (score >= 0) {
    // ---- phase A: lane 0 walks
    int n = 0;
    int3 err = make_int3(0, 0, 0);
    if (lane == 0) n = walk<AFFINE>(p, b, score, pl, tl, chain, err);
    __syncwarp();
    n = __shfl_sync(FULL, n, 0);
    if (n < 0) {
      st = make_int4(__shfl_sync(FULL, err.x, 0), __shfl_sync(FULL, err.y, 0),
                     __shfl_sync(FULL, err.z, 0), 0);
    } else {
      // ---- phase B: the warp replays the chain front to back
      int v = 0, h = 0;
      auto run = [&]() {
        const int r = lcp(prow, trow, v, h, pl, tl, lane);
        for (int i = lane; i < r; i += 32) orow[pos + i] = OP_M;
        pos += r;
        v += r;
        h += r;
      };
      run();   // the chain ends on the origin: its match run first
      for (int i = n - 1; i >= 0 && st.x == 0; --i) {
        const int code = chain[i], op = code >> 1;
        if (op == OP_X) {
          if (v >= pl || h >= tl) st = make_int4(ERR_X_PAST, 0, 0, h);
          ++v;
          ++h;
        } else if (op == OP_I) {
          if (h >= tl) st = make_int4(ERR_I_PAST, 0, 0, h);
          ++h;
        } else {
          if (v >= pl) st = make_int4(ERR_D_PAST, 0, 0, h);
          ++v;
        }
        if (st.x) break;
        if (lane == 0) orow[pos] = (int8_t)op;
        ++pos;
        if (code & 1) run();
      }
      if (st.x == 0 && (v != pl || h != tl))
        st = make_int4(ERR_CONSUMED, v, 0, h);
    }
  }
  if (st.x) pos = 0;     // an error leaves the row empty
  for (int i = pos + lane; i < p.L; i += 32) orow[i] = -1;
  if (lane == 0) {
    p.n_ops[b] = pos;
    int* srow = p.status + (size_t)b * 4;
    srow[0] = st.x;
    srow[1] = st.y;
    srow[2] = st.z;
    srow[3] = st.w;
  }
}

// Timing events a launch records on its stream right around the kernel
// (null: none), as wfa.cu's launches do.
cudaError_t marked_launch(const TbParams& p, bool affine, cudaStream_t stream,
                          void* start, void* end) {
  cudaError_t err;
  if (start && (err = cudaEventRecord((cudaEvent_t)start, stream)) !=
                   cudaSuccess)
    return err;
  const int grid = (p.B + TB_WARPS - 1) / TB_WARPS;
  if (affine)
    wfa_traceback_kernel<true><<<grid, TB_WARPS * 32, 0, stream>>>(p);
  else
    wfa_traceback_kernel<false><<<grid, TB_WARPS * 32, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err == cudaSuccess && end)
    err = cudaEventRecord((cudaEvent_t)end, stream);
  return err;
}

}  // namespace

extern "C" {

// Decode B pairs' packed traces (the trace kernel's [NW, B, K] int32 planes,
// diagonal centre K / 2; i_bt, d_bt null for a linear model) into ops on
// `stream`: ops [B, L] int8 (L >= Lp + Lt), n_ops [B], status [B, 4], all
// written for every pair; `chain` holds B * cap bytes (cap >= s_max /
// min(x, e) + 2).  `mark_start` / `mark_end` (cudaEvent_t, or null) are
// recorded right before and right after the kernel.  Returns
// cudaGetLastError() after the launch (0 = launched).
int wfa_traceback_launch(const int* score, const int* m_bt, const int* i_bt,
                         const int* d_bt, const int* pattern, const int* text,
                         const int* plen, const int* tlen, signed char* ops,
                         int* n_ops, int* status, unsigned char* chain, int B,
                         int Lp, int Lt, int L, int NW, int K, int cap, int x,
                         int o, int e, int affine, void* stream,
                         void* mark_start, void* mark_end) {
  if (B < 0 || Lp < 0 || Lt < 0 || L < Lp + Lt || NW < 1 || K < 2 ||
      K % 2 || cap < 1 || x < 1 || e < 1 || o < 0 ||
      (affine && (i_bt == nullptr || d_bt == nullptr)))
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const TbParams p{score,
                   {reinterpret_cast<const uint32_t*>(m_bt),
                    reinterpret_cast<const uint32_t*>(i_bt),
                    reinterpret_cast<const uint32_t*>(d_bt)},
                   pattern, text, plen, tlen,
                   reinterpret_cast<int8_t*>(ops), n_ops, status, chain,
                   B, Lp, Lt, L, NW, K, cap, x, o, e};
  return marked_launch(p, affine != 0, (cudaStream_t)stream, mark_start,
                       mark_end);
}

}  // extern "C"
