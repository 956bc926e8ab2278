// Forward GQA flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention/kernel.py::flash_attention_gqa (body
// _kernel): o = softmax(q k^T * scale [+ causal mask]) v per query head,
// where query head h reads KV head h / G (G = H / KV), with the online
// softmax of the TPU kernel: per key tile the running row max m, the
// running denominator l and the fp32 accumulator acc are rescaled by
// exp(m_prev - m_new), and the output is acc / max(l, 1e-30), cast to the
// input type.  As there: scores and sums in fp32; masked scores are the
// finite -1e30 (NEG_INF), never -inf, so exp(m_prev - m_new) stays finite;
// the causal mask is q_pos >= k_pos from the start of the sequence; with
// bf16 inputs the weights p are rounded to bf16 before p @ v (the TPU
// kernel casts p to v's type), while l sums them unrounded.
//
// Layout: q [B, Sq, H, dh], k and v [B, Sk, KV, dh], o like q, all
// contiguous, float or bf16.  Any Sq and Sk (keys past Sk weigh nothing),
// 1 <= dh <= 256, G up to the rows of one tile.
//
// Design.  Three bodies compute it; the caller names one (body code 0, 1
// or 2, chosen in kernel.py::select_body).  The model path, bf16 at head
// dims 64, 112 and 128 on 16-byte aligned rows, runs flash_wgmma_kernel
// (flash_wgmma.cu: TMA-fed, warp-specialised wgmma, 128-row tiles).
// flash_mma_kernel (mma.sync m16n8k16, below) takes the same inputs at dh
// 64 and 128 and stays as the yardstick the new body is timed against;
// fp32, other head dims and unaligned rows run flash_kernel on the fp32
// pipes.  The last
// two: one CTA of 128 threads per (q tile, batch x KV head); the tile
// holds BQ positions of all G query heads of that KV head (R = G * BQ <= 64
// rows, 32 for dh > 128 on the fp32 pipes), as the TPU kernel puts the G
// heads in one block.  The CTA walks the key tiles in order, which is the
// TPU grid's sequential last axis: Q is staged once in shared memory, each
// K/V tile is staged in shared memory, and the running (m, l, acc) live in
// registers.  Under causal, key tiles wholly above the diagonal are never
// loaded (they would add exp(-1e30 - m) = 0), and the heaviest q tiles are
// scheduled first.
//
// flash_kernel: the threads form a 16 x 8 grid in which each thread
// computes an RA x KB block of q k^T and an RA x DC block of the
// accumulator with scalar fp32 FMAs (K transposed in shared memory, in the
// input type); the 8 threads of one row group reduce the tile's row max and
// sum with warp shuffles, and the weights pass through shared memory to the
// p @ v product.  Head dims 64 and 128 are exact template widths; other
// widths run the next one up on zero-padded columns.
//
// What bounds it.  The served shape (B 8, S 2,048, H 16, KV 8, dh 128,
// causal, bf16) needs 137.5 GFLOP and 201 MB: 0.139 ms at the tensor
// cores' 989 TFLOP/s, so the bound is operations.  The two bodies here
// reach little of it: mma.sync is not Hopper's full-rate instruction (wgmma
// is), their tiles load synchronously, and their softmax's expf runs
// between the two products.  flash_wgmma.cu is the design for that bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;          // threads per CTA: TY x TX
constexpr int TY = 16;
constexpr int TX = 8;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f(float x) {
  return __float2bfloat16(x);
}

// Tile shape per head-dim template DHT: RA rows and KB keys per thread.
template <int DHT> struct Tile {
  static constexpr int RA = DHT > 128 ? 2 : 4;
  static constexpr int KB = DHT > 128 ? 4 : 8;
  static constexpr int R = TY * RA;      // rows (position, head) per CTA
  static constexpr int BK = TX * KB;     // keys per tile
  static constexpr int DC = DHT / TX;    // accumulator columns per thread
};

// Shared-memory row strides, padded by one 4-byte word so that the
// transposing stores of the tile loads hit distinct banks.
template <typename T> __host__ __device__ constexpr int pad_elems() {
  return 4 / sizeof(T);
}

template <typename T, int DHT>
constexpr size_t smem_bytes() {
  using C = Tile<DHT>;
  return sizeof(T) * ((size_t)DHT * (C::R + pad_elems<T>()) +
                      (size_t)DHT * (C::BK + pad_elems<T>()) +
                      (size_t)C::BK * DHT) +
         sizeof(float) * (size_t)C::BK * (C::R + 1);
}

template <typename T, int DHT>
__global__ void __launch_bounds__(NT)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                 int H, int KV, int dh, int G, int BQ, int causal,
                 float scale) {
  using C = Tile<DHT>;
  constexpr int RA = C::RA, KB = C::KB, R = C::R, BK = C::BK, DC = C::DC;
  constexpr int QS = R + pad_elems<T>();   // Qt [DHT][QS]
  constexpr int KS = BK + pad_elems<T>();  // Kt [DHT][KS]
  constexpr int PS = R + 1;                // Pt [BK][PS] (float)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qt = reinterpret_cast<T*>(smem_raw);
  T* Kt = Qt + DHT * QS;
  T* Vs = Kt + DHT * KS;                   // [BK][DHT]
  float* Pt = reinterpret_cast<float*>(Vs + BK * DHT);

  const int tid = threadIdx.x;
  const int ty = tid / TX, tx = tid % TX;
  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / KV, kvh = bh % KV;
  const int q0 = qt * BQ;
  const int rows = G * BQ;                     // <= R
  const size_t q_row = (size_t)H * dh;         // q/o elements per position
  const size_t k_row = (size_t)KV * dh;

  // Q tile: row r is position q0 + r / G of head kvh * G + r % G.
  for (int e = tid; e < R * DHT; e += NT) {
    const int r = e / DHT, d = e % DHT;
    const int i = r / G, qp = q0 + i;
    T x = from_f<T>(0.f);
    if (r < rows && qp < Sq && d < dh)
      x = q[((size_t)b * Sq + qp) * q_row + (size_t)(kvh * G + r - i * G) * dh +
            d];
    Qt[d * QS + r] = x;
  }

  int qpos[RA];
  float m[RA], l[RA], acc[RA][DC];
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int r = ty + TY * a;
    qpos[a] = q0 + r / G;
    m[a] = NEG_INF;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[a][c] = 0.f;
  }

  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int n_tiles = (k_end + BK - 1) / BK;
  const T* kb = k + (size_t)b * Sk * k_row + (size_t)kvh * dh;
  const T* vb = v + (size_t)b * Sk * k_row + (size_t)kvh * dh;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();            // the last tile's Kt / Vs / Pt are read
    for (int e = tid; e < BK * DHT; e += NT) {
      const int j = e / DHT, d = e % DHT;
      T kx = from_f<T>(0.f), vx = from_f<T>(0.f);
      if (k0 + j < Sk && d < dh) {
        kx = kb[(size_t)(k0 + j) * k_row + d];
        vx = vb[(size_t)(k0 + j) * k_row + d];
      }
      Kt[d * KS + j] = kx;
      Vs[j * DHT + d] = vx;
    }
    __syncthreads();

    float s[RA][KB];
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int j = 0; j < KB; ++j) s[a][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DHT; ++d) {
      float qa[RA], kx[KB];
#pragma unroll
      for (int a = 0; a < RA; ++a) qa[a] = to_f(Qt[d * QS + ty + TY * a]);
#pragma unroll
      for (int j = 0; j < KB; ++j) kx[j] = to_f(Kt[d * KS + tx + TX * j]);
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int j = 0; j < KB; ++j) s[a][j] = fmaf(qa[a], kx[j], s[a][j]);
    }

#pragma unroll
    for (int a = 0; a < RA; ++a) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        const int key = k0 + tx + TX * j;
        float x = s[a][j] * scale;
        if (key >= Sk)
          x = -INFINITY;        // past the keys: weight exactly 0
        else if (causal && key > qpos[a])
          x = NEG_INF;
        s[a][j] = x;
        mx = fmaxf(mx, x);
      }
      // the TX threads of a row group are lanes differing in the low bits
#pragma unroll
      for (int w = 1; w < TX; w <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[a], mx);
      const float corr = expf(m[a] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        const float p = expf(s[a][j] - m_new);
        sum += p;
        // p @ v takes p in the input type, as the TPU kernel's cast
        Pt[(tx + TX * j) * PS + ty + TY * a] = to_f(from_f<T>(p));
      }
#pragma unroll
      for (int w = 1; w < TX; w <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l[a] = l[a] * corr + sum;
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[a][c] *= corr;
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      float pa[RA], vx[DC];
#pragma unroll
      for (int a = 0; a < RA; ++a) pa[a] = Pt[j * PS + ty + TY * a];
#pragma unroll
      for (int c = 0; c < DC; ++c) vx[c] = to_f(Vs[j * DHT + tx + TX * c]);
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[a][c] = fmaf(pa[a], vx[c], acc[a][c]);
    }
  }

#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int r = ty + TY * a;
    if (r >= rows || qpos[a] >= Sq) continue;
    const int i = r / G;
    T* orow = o + ((size_t)b * Sq + qpos[a]) * q_row +
              (size_t)(kvh * G + r - i * G) * dh;
    const float denom = fmaxf(l[a], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + TX * c;
      if (d < dh) orow[d] = from_f<T>(acc[a][c] / denom);
    }
  }
}

template <typename T, int DHT>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int KV, int dh, int causal, float scale,
           cudaStream_t stream) {
  using C = Tile<DHT>;
  const int G = H / KV;
  if (G > C::R) return cudaErrorInvalidValue;
  const int BQ = C::R / G;
  const int nq = (Sq + BQ - 1) / BQ;
  if ((long long)B * KV > 65535) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T, DHT>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DHT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(nq, B * KV);
  flash_kernel<T, DHT><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Sq, Sk, H, KV, dh, G, BQ,
      causal, scale);
  return cudaGetLastError();
}

template <typename T>
int by_dh(const void* q, const void* k, const void* v, void* o, int B,
          int Sq, int Sk, int H, int KV, int dh, int causal, float scale,
          cudaStream_t st) {
  if (dh <= 64)
    return launch<T, 64>(q, k, v, o, B, Sq, Sk, H, KV, dh, causal, scale, st);
  if (dh <= 128)
    return launch<T, 128>(q, k, v, o, B, Sq, Sk, H, KV, dh, causal, scale, st);
  return launch<T, 256>(q, k, v, o, B, Sq, Sk, H, KV, dh, causal, scale, st);
}

// ---------------------------------------------------------------------------
// bf16 at head dims 64 and 128: the same function on the tensor cores.
//
// One CTA of four warps per (q tile, batch x KV head), R = 64 rows as
// above; warp w owns rows 16w..16w+15.  Q, K and V tiles are staged in
// shared memory row-major, rows padded by 16 bytes so that the fragment
// loads of a warp hit 32 distinct banks.  q k^T and p v are
// mma.sync.m16n8k16 products (bf16 in, fp32 accumulate); each thread keeps
// the running m and l of its two rows (g and g + 8 of its warp's 16), and
// the weights go from the score accumulators straight into the A fragments
// of p v, rounded to bf16 there (the TPU kernel's cast), while l sums them
// unrounded.

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

constexpr int MMA_R = 64;     // rows per CTA
constexpr int MMA_BK = 64;    // keys per tile

template <int DH>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)(MMA_R + 2 * MMA_BK) * (DH + 8);
}

template <int DH>
__global__ void __launch_bounds__(NT)
    flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int Sq, int Sk, int H,
                     int KV, int G, int BQ, int causal, float scale) {
  using bf16 = __nv_bfloat16;
  constexpr int ST = DH + 8;      // shared row stride (elements)
  constexpr int CH = DH / 8;      // 16-byte chunks per row
  constexpr int KT = DH / 16;     // k steps of q k^T
  constexpr int NO = DH / 8;      // n tiles of the accumulator
  constexpr int NS = MMA_BK / 8;  // n tiles of the scores
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [R][ST]
  bf16* Ks = Qs + MMA_R * ST;                      // [BK][ST]
  bf16* Vs = Ks + MMA_BK * ST;                     // [BK][ST]
  const uint16_t* Vh = reinterpret_cast<const uint16_t*>(Vs);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / KV, kvh = bh % KV;
  const int q0 = qt * BQ;
  const int rows = G * BQ;
  const size_t q_row = (size_t)H * DH;
  const size_t k_row = (size_t)KV * DH;

  for (int e = tid; e < MMA_R * CH; e += NT) {
    const int r = e / CH, c = e % CH;
    const int i = r / G, qp = q0 + i;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (r < rows && qp < Sq)
      x = *reinterpret_cast<const uint4*>(
          q + ((size_t)b * Sq + qp) * q_row +
          (size_t)(kvh * G + r - i * G) * DH + c * 8);
    *reinterpret_cast<uint4*>(Qs + r * ST + c * 8) = x;
  }
  __syncthreads();
  const int r0 = warp * 16 + g;              // this thread's rows r0, r0 + 8
  uint32_t qf[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const uint32_t* a0 =
        reinterpret_cast<const uint32_t*>(Qs + r0 * ST + kk * 16);
    const uint32_t* a1 =
        reinterpret_cast<const uint32_t*>(Qs + (r0 + 8) * ST + kk * 16);
    qf[kk][0] = a0[t4];
    qf[kk][1] = a1[t4];
    qf[kk][2] = a0[t4 + 4];
    qf[kk][3] = a1[t4 + 4];
  }

  const int qpos[2] = {q0 + r0 / G, q0 + (r0 + 8) / G};
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int n_tiles = (k_end + MMA_BK - 1) / MMA_BK;
  const bf16* kb = k + (size_t)b * Sk * k_row + (size_t)kvh * DH;
  const bf16* vb = v + (size_t)b * Sk * k_row + (size_t)kvh * DH;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * MMA_BK;
    __syncthreads();            // the last tile's K / V are read
    for (int e = tid; e < MMA_BK * CH; e += NT) {
      const int j = e / CH, c = e % CH;
      uint4 kx = make_uint4(0, 0, 0, 0), vx = kx;
      if (k0 + j < Sk) {
        const size_t off = (size_t)(k0 + j) * k_row + c * 8;
        kx = *reinterpret_cast<const uint4*>(kb + off);
        vx = *reinterpret_cast<const uint4*>(vb + off);
      }
      *reinterpret_cast<uint4*>(Ks + j * ST + c * 8) = kx;
      *reinterpret_cast<uint4*>(Vs + j * ST + c * 8) = vx;
    }
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      const uint32_t* krow =
          reinterpret_cast<const uint32_t*>(Ks + (n * 8 + g) * ST);
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
        mma_bf16(s[n], qf[kk], krow[kk * 8 + t4], krow[kk * 8 + t4 + 4]);
    }

    // scale and mask; element e of tile n is row r0 + 8 (e / 2), key
    // k0 + 8 n + 2 t4 + e % 2
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * t4 + (e & 1);
        float x = s[n][e] * scale;
        if (key >= Sk)
          x = -INFINITY;
        else if (causal && key > qpos[e >> 1])
          x = NEG_INF;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // a row's keys are spread over the 4 lanes of a quad
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - m[e >> 1]);
        sum[e >> 1] += p;
        s[n][e] = p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = l[h] * corr[h] + sum[h];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // p v: 16 keys per step; the A fragment is two score tiles
#pragma unroll
    for (int kc = 0; kc < MMA_BK / 16; ++kc) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
      const int key = kc * 16 + 2 * t4;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int d = n * 8 + g;
        const uint32_t b0 = (uint32_t)Vh[key * ST + d] |
                            ((uint32_t)Vh[(key + 1) * ST + d] << 16);
        const uint32_t b1 = (uint32_t)Vh[(key + 8) * ST + d] |
                            ((uint32_t)Vh[(key + 9) * ST + d] << 16);
        mma_bf16(acc[n], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= rows || qpos[h] >= Sq) continue;
    const int i = r / G;
    bf16* orow = o + ((size_t)b * Sq + qpos[h]) * q_row +
                 (size_t)(kvh * G + r - i * G) * DH;
    const float denom = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t4) =
          __floats2bfloat162_rn(acc[n][2 * h] / denom,
                                acc[n][2 * h + 1] / denom);
  }
}

template <int DH>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B,
               int Sq, int Sk, int H, int KV, int causal, float scale,
               cudaStream_t stream) {
  const int G = H / KV;
  if (G > MMA_R || (long long)B * KV > 65535) return cudaErrorInvalidValue;
  const int BQ = MMA_R / G;
  const size_t smem = mma_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, B * KV);
  flash_mma_kernel<DH><<<grid, NT, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, Sq, Sk, H, KV, G, BQ,
      causal, scale);
  return cudaGetLastError();
}

// body codes of flash_attention_launch
constexpr int BODY_FP32_PIPES = 0;
constexpr int BODY_MMA_SYNC = 1;
constexpr int BODY_WGMMA = 2;

// The tensor-core bodies take bf16 on 16-byte aligned bases (TMA needs
// them; rows of 64, 112 or 128 bf16 keep every stride aligned): mma.sync at
// dh 64 or 128, wgmma also at 112.
bool tensor_core_inputs(const void* q, const void* k, const void* v,
                        const void* o, int dh, int dtype, int body) {
  const uintptr_t bits = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                         (uintptr_t)o;
  const bool width = dh == 64 || dh == 128 ||
                     (body == BODY_WGMMA && dh == 112);
  return dtype == 1 && width && bits % 16 == 0;
}

int check_args(int B, int Sq, int Sk, int H, int KV, int dh) {
  if (B < 0 || Sq < 0 || Sk < 0 || KV < 1 || H % KV != 0 || dh < 1 ||
      dh > 256)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

int launch_fma(const void* q, const void* k, const void* v, void* o, int B,
               int Sq, int Sk, int H, int KV, int dh, int dtype, int causal,
               float scale, cudaStream_t st) {
  if (dtype == 0)
    return by_dh<float>(q, k, v, o, B, Sq, Sk, H, KV, dh, causal, scale, st);
  if (dtype == 1)
    return by_dh<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, KV, dh, causal,
                                scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// flash_wgmma.cu
int flash_wgmma_launch(const void* q, const void* k, const void* v, void* o,
                       int B, int Sq, int Sk, int H, int KV, int dh,
                       int causal, float scale, int drop_tile,
                       cudaStream_t stream);
int flash_wgmma_max_group();

extern "C" {

// Launch one attention on `stream` (no synchronisation) with the body
// named by `body`: 0 the fp32 pipes (float or bf16, any dh up to 256),
// 1 mma.sync (bf16 at dh 64 or 128 on 16-byte aligned bases), 2 wgmma
// (the same, and dh 112); dtype 0 = float, 1 = bf16.  drop_tile >= 0
// (wgmma only) leaves that 128-key tile out: a planted fault for the
// checks' control, -1 in every real call.  Returns cudaErrorInvalidValue for a body that cannot
// take the inputs, else cudaGetLastError() after the launch (0 =
// launched); faults during the run surface at the next sync.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int Sq, int Sk, int H, int KV,
                           int dh, int dtype, int causal, float scale,
                           int body, int drop_tile, void* stream) {
  int err = check_args(B, Sq, Sk, H, KV, dh);
  if (err != cudaSuccess) return err;
  if (body < BODY_FP32_PIPES || body > BODY_WGMMA ||
      (drop_tile >= 0 && body != BODY_WGMMA) ||
      (body != BODY_FP32_PIPES &&
       !tensor_core_inputs(q, k, v, o, dh, dtype, body)))
    return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (body == BODY_WGMMA)
    return flash_wgmma_launch(q, k, v, o, B, Sq, Sk, H, KV, dh, causal,
                              scale, drop_tile, st);
  if (body == BODY_MMA_SYNC)
    return dh == 64 ? launch_mma<64>(q, k, v, o, B, Sq, Sk, H, KV, causal,
                                     scale, st)
                    : launch_mma<128>(q, k, v, o, B, Sq, Sk, H, KV, causal,
                                      scale, st);
  return launch_fma(q, k, v, o, B, Sq, Sk, H, KV, dh, dtype, causal, scale,
                    st);
}

// Rows (position, head) of one CTA of `body` at head dim dh: the largest G
// that body serves.
int flash_attention_max_group(int body, int dh) {
  if (body == BODY_WGMMA) return flash_wgmma_max_group();
  if (body == BODY_MMA_SYNC) return MMA_R;
  return dh > 128 ? Tile<256>::R : Tile<128>::R;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
