// fused_spectre_linear_bwd_chain: the LayerNorm/GELU chain of the
// SpectreLinear block's backward,
//
//   u  = (h - mean h) * rsig,  rsig = (var h + eps)^-1/2,  z = u * gamma + beta
//   dz = g * gelu'(z),  gelu'(z) = Phi(z) + z phi(z)  (the erf form, not tanh)
//   du = dz * gamma
//   dh = rsig * (du - mean du - u * mean(du * u))
//   dgamma = sum_rows dz * u,  dbeta = sum_rows dz,  db = sum_rows dh
//
// from the forward's saved pre-LayerNorm activation h = x @ W + b [M, N] and
// the cotangent g [M, N] of the block's output, all arithmetic in float32,
// dh stored once in the input dtype (bf16 or float32) and the three column
// sums in it. It is the part of spectre_tpu/ops/pallas/fused_linear.py's
// custom VJP (_bwd) that is not a product; the caller
// (ops/kernels/fused_linear.py) runs the two products dW = x^T dh and
// dx = dh W^T (+ g when K == N) on the library's matrix product, with bf16
// operands and float32 sums for bf16 inputs, as the JAX package leaves its
// products to XLA.
//
// What bounds it on the H100: bytes, 6 M N of them in bf16 (h and g read,
// dh written once), and close behind them instructions: some 35 float32
// operations an element. So Phi(z) comes from Abramowitz & Stegun's erf
// (7.1.26, |error| <= 1.5e-7, the erf of the JAX package's forward kernel),
// whose e^(-x^2) at x = z / sqrt 2 is the e^(-z^2 / 2) of phi(z): one ex2 and
// one reciprocal an element, no branch.
//
// Design: one warp a row (N <= 1,024). A lane holds C chunks of E values of
// the row: E = 8 (bf16) or 4 (float32) values in a 16-byte vector when N is a
// multiple of E and the bases are aligned, chunk c at column
// (c * 32 + lane) * E so that each warp load is contiguous; else E = 1 (the
// head's N = 100). Row sums (mean, variance, the two means of the LayerNorm
// backward) go by warp shuffles; no barrier inside the row loop. Each lane
// keeps its columns' partial sums of dz * u, dz and dh in registers over its
// rows (3 C E of them, which is what limits a block of 4 warps to 3 an SM);
// so that the few warps an SM still keep the memory busy, a warp copies its
// next row into shared memory by cp.async while it works on the current one
// (16-byte chunks, the ring within 32 KB: bf16, and float32 up to N = 512).
// The grid is the blocks resident at once (3 an SM, the caller's choice), a
// block owning a contiguous share of the rows. At the end the warps add
// their partial sums in shared memory in warp order, and the block writes
// one float32 partial row [3, N]; a second kernel adds the blocks' partials
// per column in a fixed order (8 strided segments, then the 8 segment sums
// in turn) and writes the column sums. No float atomics: on one card two
// runs give the same bits. N > 1,024 is refused, as the forward refuses it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlocksPerSM = 3;  // ops/kernels/fused_linear.py: BWD_BLOCKS_PER_SM
constexpr int kMaxN = 1024;
constexpr int kSegments = 8;  // column-sum pass: strided segments a column
constexpr float kInvSqrt2 = 0.70710678118654752440f;
constexpr float kInvSqrt2Pi = 0.39894228040143267794f;
constexpr float kNegHalfLog2e = -0.72134752044448170368f;  // -log2(e) / 2
// Abramowitz & Stegun 7.1.26: erf(x) = 1 - t (a1 + t (a2 + ... + t a5)) e^(-x^2),
// t = 1 / (1 + p x), x >= 0, |error| <= 1.5e-7 (the JAX package's forward
// kernel takes the same erf)
constexpr float kErfP = 0.3275911f;
constexpr float kErfA1 = 0.254829592f, kErfA2 = -0.284496736f, kErfA3 = 1.421413741f,
                kErfA4 = -1.453152027f, kErfA5 = 1.061405429f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// gelu'(z) = Phi(z) + z phi(z). Phi from erf(|z| / sqrt 2) by A&S 7.1.26,
// whose e^(-x^2) is e^(-z^2 / 2), the exponential of phi(z) too: one ex2 and
// one reciprocal an element, no branch.
__device__ __forceinline__ float gelu_grad(float z) {
  const float e = exp2f(z * z * kNegHalfLog2e);
  const float t = __fdividef(1.0f, fmaf(kErfP * kInvSqrt2, fabsf(z), 1.0f));
  const float poly =
      t * fmaf(t, fmaf(t, fmaf(t, fmaf(t, kErfA5, kErfA4), kErfA3), kErfA2), kErfA1);
  const float erf_abs = fmaf(-poly, e, 1.0f);
  return fmaf(z * kInvSqrt2Pi, e, 0.5f + copysignf(0.5f * erf_abs, z));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// E values at p: one 16-byte vector when E * sizeof(T) == 16, else one value.
template <typename T, int E>
__device__ __forceinline__ void load_chunk(const T* p, float* v) {
  if constexpr (E * sizeof(T) == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // bf16 -> f32 is a 16-bit shift
        v[2 * k] = __uint_as_float(w[k] << 16);
        v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = __uint_as_float(w[k]);
    }
  } else {
    static_assert(E == 1, "a chunk is a 16-byte vector or one value");
    v[0] = to_f(*p);
  }
}

template <typename T, int E>
__device__ __forceinline__ void store_chunk(T* p, const float* v) {
  if constexpr (E * sizeof(T) == 16) {
    unsigned w[4];
    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        w[k] = static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * k]))) |
               (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * k + 1])))
                << 16);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) w[k] = __float_as_uint(v[k]);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    *p = from_f<T>(v[0]);
  }
}

// 16-byte global -> shared copy that bypasses registers; the issuing lane
// reads the chunk back itself, after cp.async.wait_group.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

// Shared memory of the prefetch ring: a warp's two stages of one h row and
// one g row, 32 E C values each.
template <typename T, int E, int C>
constexpr int kRingBytes = kWarps * 2 * 2 * 32 * E * C * static_cast<int>(sizeof(T));
constexpr int kSharedBytes = 32 * 1024;  // the ring of the largest instance that takes one

// C chunks of E values a lane cover the row: 32 E C >= N. The block owns
// rows [blockIdx.x * rows, (blockIdx.x + 1) * rows); warp w takes every
// kWarps-th of them from the w-th. With 16-byte chunks and a ring that fits
// kSharedBytes, a warp copies its next row into shared memory by cp.async
// while it works on the current one.
template <typename T, int E, int C>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
chain_kernel(const T* __restrict__ h, const T* __restrict__ g, const T* __restrict__ gamma,
             const T* __restrict__ beta, T* __restrict__ dh, float* __restrict__ partial,
             long long M, int N, long long rows, float eps) {
  constexpr bool kRing = E * sizeof(T) == 16 && kRingBytes<T, E, C> <= kSharedBytes;
  constexpr int kRow = 32 * E * C;
  static_assert(3 * kMaxN * sizeof(float) <= kSharedBytes, "the column sums reuse the ring");
  __shared__ float s_gamma[kMaxN], s_beta[kMaxN];
  __shared__ __align__(16) unsigned char s_raw[kSharedBytes];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c = threadIdx.x; c < N; c += kThreads) {
    s_gamma[c] = to_f(gamma[c]);
    s_beta[c] = to_f(beta[c]);
  }
  __syncthreads();

  const float inv_n = 1.0f / static_cast<float>(N);
  float p_dgamma[C][E], p_dbeta[C][E], p_db[C][E];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int e = 0; e < E; ++e) p_dgamma[c][e] = p_dbeta[c][e] = p_db[c][e] = 0.f;

  T* ring = reinterpret_cast<T*>(s_raw) + warp * 4 * kRow;  // [stage][h, g][kRow]
  auto fetch = [&](long long r, int stage) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = (c * 32 + lane) * E;
      if (col < N) {
        cp_async16(ring + (2 * stage) * kRow + col, h + r * N + col);
        cp_async16(ring + (2 * stage + 1) * kRow + col, g + r * N + col);
      }
    }
    cp_async_commit();
  };
  const long long r0 = static_cast<long long>(blockIdx.x) * rows;
  const long long r1 = r0 + rows < M ? r0 + rows : M;
  if constexpr (kRing) {
    if (r0 + warp < r1) fetch(r0 + warp, 0);
  }
  int stage = 0;
  for (long long r = r0 + warp; r < r1; r += kWarps, stage ^= 1) {
    float u[C][E], d[C][E];
    if constexpr (kRing) {
      if (r + kWarps < r1) {
        fetch(r + kWarps, stage ^ 1);
      } else {
        cp_async_commit();  // an empty group: wait_group 1 below still means this row
      }
      cp_async_wait1();
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = (c * 32 + lane) * E;
      if (col < N) {
        if constexpr (kRing) {
          load_chunk<T, E>(ring + (2 * stage) * kRow + col, u[c]);
          load_chunk<T, E>(ring + (2 * stage + 1) * kRow + col, d[c]);
        } else {
          load_chunk<T, E>(h + r * N + col, u[c]);
          load_chunk<T, E>(g + r * N + col, d[c]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) u[c][e] = d[c][e] = 0.f;
      }
    }
    // LayerNorm statistics of the row, two passes as the JAX package takes them
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int e = 0; e < E; ++e) s += u[c][e];
    const float mu = warp_sum(s) * inv_n;
    float q = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const bool in = (c * 32 + lane) * E < N;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float t = u[c][e] - mu;
        q += in ? t * t : 0.f;
      }
    }
    const float rsig = rsqrtf(warp_sum(q) * inv_n + eps);
    // dz, and du = dz * gamma in its place
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = (c * 32 + lane) * E;
      const bool in = col < N;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float gam = in ? s_gamma[col + e] : 0.f, bet = in ? s_beta[col + e] : 0.f;
        const float uu = in ? (u[c][e] - mu) * rsig : 0.f;
        const float dz = d[c][e] * gelu_grad(uu * gam + bet);
        p_dgamma[c][e] += dz * uu;
        p_dbeta[c][e] += dz;
        const float du = dz * gam;
        u[c][e] = uu;
        d[c][e] = du;
        m1 += du;
        m2 += du * uu;
      }
    }
    m1 = warp_sum(m1) * inv_n;
    m2 = warp_sum(m2) * inv_n;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = (c * 32 + lane) * E;
      if (col >= N) continue;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float v = rsig * (d[c][e] - m1 - u[c][e] * m2);
        p_db[c][e] += v;
        d[c][e] = v;
      }
      store_chunk<T, E>(dh + r * N + col, d[c]);
    }
  }

  // the block's partial column sums: warps add theirs in warp order, in
  // the shared memory the ring used
  float(*s_sum)[kMaxN] = reinterpret_cast<float(*)[kMaxN]>(s_raw);
  __syncthreads();
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int col = (c * 32 + lane) * E;
        if (col >= N) continue;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float a = p_dgamma[c][e], b = p_dbeta[c][e], q = p_db[c][e];
          s_sum[0][col + e] = w == 0 ? a : s_sum[0][col + e] + a;
          s_sum[1][col + e] = w == 0 ? b : s_sum[1][col + e] + b;
          s_sum[2][col + e] = w == 0 ? q : s_sum[2][col + e] + q;
        }
      }
    }
    __syncthreads();
  }
  float* out = partial + static_cast<long long>(blockIdx.x) * 3 * N;
  for (int i = threadIdx.x; i < 3 * N; i += kThreads) out[i] = s_sum[i / N][i % N];
}

// sums[j] = sum over blocks of partial[block][j], j < 3 N, in a fixed order:
// segment s adds blocks s, s + 8, ... in turn, then the segments in turn.
template <typename T>
__global__ void __launch_bounds__(32 * kSegments)
column_sum_kernel(const float* __restrict__ partial, long long blocks, int N,
                  T* __restrict__ dgamma, T* __restrict__ dbeta, T* __restrict__ db) {
  __shared__ float s_seg[kSegments][32];
  const int lane = threadIdx.x & 31, seg = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + lane;
  const int width = 3 * N;
  float acc = 0.f;
  if (j < width)
    for (long long b = seg; b < blocks; b += kSegments) acc += partial[b * width + j];
  s_seg[seg][lane] = acc;
  __syncthreads();
  if (seg != 0 || j >= width) return;
  float total = s_seg[0][lane];
#pragma unroll
  for (int s = 1; s < kSegments; ++s) total += s_seg[s][lane];
  T* dst = j < N ? dgamma : j < 2 * N ? dbeta : db;
  dst[j % N] = from_f<T>(total);
}

template <typename T, int E, int C>
int launch_chain(const void* h, const void* g, const void* gamma, const void* beta, void* dh,
                 float* partial, long long M, int N, float eps, long long blocks,
                 cudaStream_t st) {
  chain_kernel<T, E, C><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const T*>(h), static_cast<const T*>(g), static_cast<const T*>(gamma),
      static_cast<const T*>(beta), static_cast<T*>(dh), partial, M, N, (M + blocks - 1) / blocks,
      eps);
  return static_cast<int>(cudaGetLastError());
}

// The instance whose lanes cover N: the fewest chunks of E values that do.
template <typename T, int E>
int dispatch_chunks(const void* h, const void* g, const void* gamma, const void* beta, void* dh,
                    float* partial, long long M, int N, float eps, long long blocks,
                    cudaStream_t st) {
  const int chunks = (N + 32 * E - 1) / (32 * E);
#define SPECTRE_CHAIN(CC)                                                                 \
  if (chunks <= CC) return launch_chain<T, E, CC>(h, g, gamma, beta, dh, partial, M, N, eps, \
                                                  blocks, st);
  if constexpr (E == 8) {  // bf16 vectors: N <= 1,024
    SPECTRE_CHAIN(1) SPECTRE_CHAIN(2) SPECTRE_CHAIN(3) SPECTRE_CHAIN(4)
  } else if constexpr (E == 4) {  // float32 vectors
    SPECTRE_CHAIN(1) SPECTRE_CHAIN(2) SPECTRE_CHAIN(3) SPECTRE_CHAIN(4) SPECTRE_CHAIN(6)
    SPECTRE_CHAIN(8)
  } else {  // one value a chunk
    SPECTRE_CHAIN(1) SPECTRE_CHAIN(2) SPECTRE_CHAIN(4) SPECTRE_CHAIN(8) SPECTRE_CHAIN(16)
    SPECTRE_CHAIN(32)
  }
#undef SPECTRE_CHAIN
  return cudaErrorInvalidValue;
}

template <typename T>
int run(const void* h, const void* g, const void* gamma, const void* beta, void* dh,
        void* dgamma, void* dbeta, void* db, void* partial, long long M, int N,
        long long blocks, float eps, cudaStream_t st) {
  constexpr int E = 16 / sizeof(T);
  float* part = static_cast<float*>(partial);
  const bool vec = N % E == 0 &&
                   ((reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(g) |
                     reinterpret_cast<uintptr_t>(dh)) & 15) == 0;
  int err = vec ? dispatch_chunks<T, E>(h, g, gamma, beta, dh, part, M, N, eps, blocks, st)
                : dispatch_chunks<T, 1>(h, g, gamma, beta, dh, part, M, N, eps, blocks, st);
  if (err != 0) return err;
  column_sum_kernel<T><<<static_cast<unsigned>((3 * N + 31) / 32), 32 * kSegments, 0, st>>>(
      part, blocks, N, static_cast<T*>(dgamma), static_cast<T*>(dbeta), static_cast<T*>(db));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// h, g, dh: [M, N] contiguous; gamma, beta, dgamma, dbeta, db: [N]; all of
// one dtype (0: float32, 1: bf16). blocks: the chain kernel's grid, at most
// M (the caller's choice: 3 an SM); partial: float32 scratch of
// blocks * 3 * N values. Returns cudaGetLastError() after the launches (0 on
// success).
extern "C" int fused_spectre_linear_bwd_chain(int dtype_code, const void* h, const void* g,
                                              const void* gamma, const void* beta, void* dh,
                                              void* dgamma, void* dbeta, void* db,
                                              void* partial, long long M, long long N,
                                              long long blocks, float eps, void* stream) {
  if (M <= 0 || N <= 0 || N > kMaxN || blocks <= 0 || blocks > M || blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(N);
  if (dtype_code == 0)
    return run<float>(h, g, gamma, beta, dh, dgamma, dbeta, db, partial, M, n, blocks, eps, st);
  if (dtype_code == 1)
    return run<bf16>(h, g, gamma, beta, dh, dgamma, dbeta, db, partial, M, n, blocks, eps, st);
  return cudaErrorInvalidValue;
}


// ------------------------------------------------------------ N > 1,024
//
// fused_spectre_linear_bwd_wide: the same chain for any N, where a warp can
// no longer hold a row in registers. One block of 256 threads a row, the
// blocks owning contiguous shares of the rows as above. A row is walked
// four times in chunks of E values a thread (16-byte vectors where N and
// the bases allow, else one value), from memory (the row, 2 N values,
// stays in L1 between the walks): the sum for the mean, the squared
// deviations for the variance, dz and du = dz * gamma for the two means of
// the LayerNorm backward, then dh. Row sums go through block_sum (warps by
// shuffles, then the warp sums in warp order). Each thread owns the same
// columns in every row, so the block's partial column sums live in its
// own row of `partial` (float32 [blocks, 3, N], in memory: no bound on N)
// and each entry is read and written by one thread only; the column-sum
// kernel above adds the blocks' rows in its fixed order. No atomics: two
// runs give the same bits.

namespace {

constexpr int kWideThreads = 256;
constexpr int kWideBlocksPerSM = 3;  // ops/kernels/fused_linear.py: BWD_BLOCKS_PER_SM

__device__ __forceinline__ float2 block_sum2(float a, float b, float (*red)[kWideThreads / 32]) {
  a = warp_sum(a);
  b = warp_sum(b);
  if (threadIdx.x % 32 == 0) {
    red[0][threadIdx.x / 32] = a;
    red[1][threadIdx.x / 32] = b;
  }
  __syncthreads();
  float2 s = make_float2(0.f, 0.f);
#pragma unroll
  for (int i = 0; i < kWideThreads / 32; ++i) {
    s.x += red[0][i];
    s.y += red[1][i];
  }
  __syncthreads();  // red is reused by the next call
  return s;
}

template <typename T, int E>
__global__ void __launch_bounds__(kWideThreads, kWideBlocksPerSM)
chain_wide_kernel(const T* __restrict__ h, const T* __restrict__ g, const T* __restrict__ gamma,
                  const T* __restrict__ beta, T* __restrict__ dh, float* __restrict__ partial,
                  long long M, int N, long long rows, float eps) {
  __shared__ float red[2][kWideThreads / 32];
  constexpr int kStep = kWideThreads * E;
  const int first = threadIdx.x * E;
  const float inv_n = 1.0f / static_cast<float>(N);
  float* p_dgamma = partial + static_cast<long long>(blockIdx.x) * 3 * N;
  float* p_dbeta = p_dgamma + N;
  float* p_db = p_dbeta + N;
  for (int col = first; col < N; col += kStep)
#pragma unroll
    for (int e = 0; e < E; ++e) p_dgamma[col + e] = p_dbeta[col + e] = p_db[col + e] = 0.f;

  const long long r0 = static_cast<long long>(blockIdx.x) * rows;
  const long long r1 = r0 + rows < M ? r0 + rows : M;
  for (long long r = r0; r < r1; ++r) {
    const T* hr = h + r * N;
    const T* gr = g + r * N;
    float v[E], d[E];
    float s = 0.f;
    for (int col = first; col < N; col += kStep) {
      load_chunk<T, E>(hr + col, v);
#pragma unroll
      for (int e = 0; e < E; ++e) s += v[e];
    }
    const float mu = block_sum2(s, 0.f, red).x * inv_n;
    float q = 0.f;
    for (int col = first; col < N; col += kStep) {
      load_chunk<T, E>(hr + col, v);
#pragma unroll
      for (int e = 0; e < E; ++e) q += (v[e] - mu) * (v[e] - mu);
    }
    const float rsig = rsqrtf(block_sum2(q, 0.f, red).x * inv_n + eps);
    float m1 = 0.f, m2 = 0.f;
    for (int col = first; col < N; col += kStep) {
      load_chunk<T, E>(hr + col, v);
      load_chunk<T, E>(gr + col, d);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float gam = to_f(gamma[col + e]);
        const float uu = (v[e] - mu) * rsig;
        const float dz = d[e] * gelu_grad(uu * gam + to_f(beta[col + e]));
        p_dgamma[col + e] += dz * uu;
        p_dbeta[col + e] += dz;
        const float du = dz * gam;
        m1 += du;
        m2 += du * uu;
      }
    }
    const float2 ms = block_sum2(m1, m2, red);
    m1 = ms.x * inv_n;
    m2 = ms.y * inv_n;
    for (int col = first; col < N; col += kStep) {
      load_chunk<T, E>(hr + col, v);
      load_chunk<T, E>(gr + col, d);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float gam = to_f(gamma[col + e]);
        const float uu = (v[e] - mu) * rsig;
        const float du = d[e] * gelu_grad(uu * gam + to_f(beta[col + e])) * gam;
        d[e] = rsig * (du - m1 - uu * m2);
        p_db[col + e] += d[e];
      }
      store_chunk<T, E>(dh + r * N + col, d);
    }
  }
}

template <typename T, int E>
int launch_chain_wide(const void* h, const void* g, const void* gamma, const void* beta,
                      void* dh, float* partial, long long M, int N, float eps, long long blocks,
                      cudaStream_t st) {
  chain_wide_kernel<T, E><<<static_cast<unsigned>(blocks), kWideThreads, 0, st>>>(
      static_cast<const T*>(h), static_cast<const T*>(g), static_cast<const T*>(gamma),
      static_cast<const T*>(beta), static_cast<T*>(dh), partial, M, N,
      (M + blocks - 1) / blocks, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_wide(const void* h, const void* g, const void* gamma, const void* beta, void* dh,
             void* dgamma, void* dbeta, void* db, void* partial, long long M, int N,
             long long blocks, float eps, cudaStream_t st) {
  constexpr int E = 16 / sizeof(T);
  float* part = static_cast<float*>(partial);
  const bool vec = N % E == 0 &&
                   ((reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(g) |
                     reinterpret_cast<uintptr_t>(dh)) & 15) == 0;
  int err = vec ? launch_chain_wide<T, E>(h, g, gamma, beta, dh, part, M, N, eps, blocks, st)
                : launch_chain_wide<T, 1>(h, g, gamma, beta, dh, part, M, N, eps, blocks, st);
  if (err != 0) return err;
  column_sum_kernel<T><<<static_cast<unsigned>((3LL * N + 31) / 32), 32 * kSegments, 0, st>>>(
      part, blocks, N, static_cast<T*>(dgamma), static_cast<T*>(dbeta), static_cast<T*>(db));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The arguments of fused_spectre_linear_bwd_chain, for any N >= 1.
extern "C" int fused_spectre_linear_bwd_wide(int dtype_code, const void* h, const void* g,
                                             const void* gamma, const void* beta, void* dh,
                                             void* dgamma, void* dbeta, void* db,
                                             void* partial, long long M, long long N,
                                             long long blocks, float eps, void* stream) {
  if (M <= 0 || N <= 0 || 3 * N > 0x7fffffffLL || blocks <= 0 || blocks > M ||
      blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(N);
  if (dtype_code == 0)
    return run_wide<float>(h, g, gamma, beta, dh, dgamma, dbeta, db, partial, M, n, blocks, eps,
                           st);
  if (dtype_code == 1)
    return run_wide<bf16>(h, g, gamma, beta, dh, dgamma, dbeta, db, partial, M, n, blocks, eps,
                          st);
  return cudaErrorInvalidValue;
}
