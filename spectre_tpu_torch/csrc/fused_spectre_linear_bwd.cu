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

#include <atomic>

#include "vec.cuh"

namespace {

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
  if (j < width) {
#pragma unroll 8  // the loads go out together; the sum keeps its order
    for (long long b = seg; b < blocks; b += kSegments) acc += partial[b * width + j];
  }
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
// fused_spectre_linear_bwd_wide: the same chain for N > 1,024, where a warp
// can no longer hold a row. What bounds it on the H100: bytes, as above (6 M N
// in bf16), plus the blocks' float32 partial rows of column sums, written once
// and read once by column_sum_kernel. What kept the first design (a block a
// row, walked four times from memory) at 15% of that: the column sums went
// through memory for every row (24 bytes of traffic an element), three block
// reductions a row with one row in flight, and threads idle or loading one
// value at a time.
//
// Design. A block takes the rows of a contiguous share one at a time. Thread t
// owns the columns (c * threads + t) * V + [0, V), c < C = 16 / V, of every
// row: V values a vector load (16 bytes where N and the bases allow, else 8,
// 4, or one value), 16 values a thread (kWideValues; fewer threads a row
// spread the row's reductions over more values, and 16 beat 8 at every C6
// shape on the card), so a block has N / 16 threads. A thread's h and g
// sit in registers for the row's whole chain: read once, dh written once. The
// next rows' h and g come into shared memory by cp.async while the current row
// computes (a ring of 3 rows, 2 where shared memory is short); each thread
// copies and reads back only its own columns, so the ring needs no barrier.
// The column sums of dz u, dz and dh stay in registers over all the block's
// rows and go once into its row of `partial`; column_sum_kernel above adds the
// blocks' rows in its fixed order (no atomics: two runs give the same bits).
// gamma and beta are widened once a block into shared memory, again each
// thread its own columns. Two block reductions a row, one barrier each: the
// row's (count, mean, M2), each thread's by Chan's formula over its chunks in
// order (a chunk's by two passes), then across lanes and across warps by
// butterflies of Chan's formula whose lower lane's operand goes first, so
// that every thread holds the same bits; then the sums of du and du u. The
// grid (at most 4 blocks an SM), the threads and V come from
// ops/kernels/fused_linear.py::wide_chain_plan; N up to kWideReach = 512
// threads x 16 values is held in registers. Above, chain_walk_kernel walks
// the row from memory three times (statistics; dz and the two means; dh)
// with the same reductions, one block an SM, and keeps its column sums in
// its row of `partial`.

namespace {

constexpr int kWideMaxThreads = 512;
constexpr int kWideMaxWarps = kWideMaxThreads / 32;
constexpr int kWideValues = 16;  // values a thread holds
constexpr int kWideReach = kWideMaxThreads * kWideValues;  // fused_linear.py: WIDE_REACH
constexpr int kWideStages = 3;   // rows of the prefetch ring, 2 where shared memory is short
// dynamic shared memory a block may take: the card's 232,448 bytes less
// room for the kernels' static reduction buffers
constexpr int kSmemDynamic = 232448 - 1024;
constexpr int kMaxDevices = 16;

struct Stats {
  float n, mean, m2;
};

// Chan's formula: the statistics of a's values followed by b's (counts are
// whole numbers of at most N, so the fast division's 2 ulp are all it costs).
__device__ __forceinline__ Stats chan(Stats a, Stats b) {
  const float tot = a.n + b.n;
  const float d = b.mean - a.mean;
  const float f = tot > 0.f ? __fdividef(b.n, tot) : 0.f;
  return {tot, a.mean + d * f, a.m2 + b.m2 + d * d * a.n * f};
}

// (count, mean, M2) of V values by two passes.
template <int V>
__device__ __forceinline__ Stats chunk_stats(const float* v) {
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < V; ++e) s += v[e];
  const float mean = s * (1.0f / V);
  float m2 = 0.f;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float d = v[e] - mean;
    m2 += d * d;
  }
  return {static_cast<float>(V), mean, m2};
}

// A butterfly of Chan's formula over `width` lanes (a power of two): each
// lane ends with the statistics of all of them; at each level both partners
// compute chan(lower lane's, upper lane's), so they hold the same bits.
__device__ __forceinline__ Stats lane_chan(Stats s, int width) {
  const int lane = threadIdx.x & 31;
  for (int o = 1; o < width; o <<= 1) {
    const Stats t = {__shfl_xor_sync(0xffffffffu, s.n, o), __shfl_xor_sync(0xffffffffu, s.mean, o),
                     __shfl_xor_sync(0xffffffffu, s.m2, o)};
    s = (lane & o) ? chan(t, s) : chan(s, t);
  }
  return s;
}

// The row's statistics across the block: the lanes' butterfly, then every
// warp runs the same butterfly over the warps' results (`wpow2`: the warps
// rounded up to a power of two; each group of wpow2 lanes takes all of them,
// so every lane ends with the same bits). One barrier; `red` is written again
// only after the row's next barrier (block_sum2's).
__device__ __forceinline__ Stats block_stats(Stats s, Stats* red, int wpow2) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  s = lane_chan(s, 32);
  if (lane == 0) red[warp] = s;
  __syncthreads();
  const int w = lane & (wpow2 - 1);  // each group of wpow2 lanes holds every warp's
  return lane_chan(w < static_cast<int>(blockDim.x >> 5) ? red[w] : Stats{0.f, 0.f, 0.f}, wpow2);
}

// The sums of a and b across the block, in the same two butterflies.
__device__ __forceinline__ float2 block_sum2(float a, float b, float2* red, int wpow2) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) red[warp] = make_float2(a, b);
  __syncthreads();
  const int w = lane & (wpow2 - 1);
  float2 s = w < static_cast<int>(blockDim.x >> 5) ? red[w] : make_float2(0.f, 0.f);
  for (int o = 1; o < wpow2; o <<= 1) {
    s.x += __shfl_xor_sync(0xffffffffu, s.x, o);
    s.y += __shfl_xor_sync(0xffffffffu, s.y, o);
  }
  return s;
}

// u, dz and du = dz * gamma of one element.
__device__ __forceinline__ void chain_element(float h, float g, float mu, float rsig, float gam,
                                              float bet, float& u, float& dz, float& du) {
  u = (h - mu) * rsig;
  dz = g * gelu_grad(u * gam + bet);
  du = dz * gam;
}

// V float32 values at p, aligned to 4 V bytes (at most 16).
template <int V>
__device__ __forceinline__ void load_f(const float* p, float* v) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int k = 0; k < V; k += 4) {
      const float4 a = *reinterpret_cast<const float4*>(p + k);
      v[k] = a.x; v[k + 1] = a.y; v[k + 2] = a.z; v[k + 3] = a.w;
    }
  } else if constexpr (V == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x; v[1] = a.y;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store_f(float* p, const float* v) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int k = 0; k < V; k += 4)
      *reinterpret_cast<float4*>(p + k) = make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// B-byte global -> shared copy (B = 4, 8 or 16) that bypasses registers.
template <int B>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (B == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(B)
                 : "memory");
  }
}

// Waits until at most `pending` (0, 1 or 2) of this thread's groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending >= 2) {
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  } else if (pending == 1) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
}

__host__ __device__ constexpr int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Shared memory of chain_wide_kernel: gamma and beta as float32 over a row's
// slots (C threads V of them), and `stages` rows of h and g.
template <typename T>
constexpr int wide_smem(int slots, int stages) {
  return slots * 2 * static_cast<int>(sizeof(float)) +
         stages * 2 * slots * static_cast<int>(sizeof(T));
}

// The ring's rows: kWideStages where they fit beside gamma and beta, else
// 2; none for one bf16 value a chunk (cp.async copies at least 4 bytes).
template <typename T, int V>
constexpr int wide_stages(int slots) {
  if (V * sizeof(T) < 4) return 0;
  return wide_smem<T>(slots, kWideStages) <= kSmemDynamic ? kWideStages : 2;
}

template <typename T, int V, int C>
__global__ void __launch_bounds__(kWideMaxThreads)
chain_wide_kernel(const T* __restrict__ h, const T* __restrict__ g, const T* __restrict__ gamma,
                  const T* __restrict__ beta, T* __restrict__ dh, float* __restrict__ partial,
                  long long M, int N, long long rows, int stages, float eps) {
  constexpr int kBytes = V * static_cast<int>(sizeof(T));
  __shared__ Stats red_stats[kWideMaxWarps];
  __shared__ float2 red_sums[kWideMaxWarps];
  extern __shared__ __align__(16) unsigned char smem[];
  const int threads = blockDim.x, tid = threadIdx.x;
  const int slots = C * threads * V;  // column (c * threads + t) * V + e, c < C
  float* s_gamma = reinterpret_cast<float*>(smem);
  float* s_beta = s_gamma + slots;
  T* ring = reinterpret_cast<T*>(s_beta + slots);  // [stage][h, g][slots]
  const int wpow2 = pow2_at_least(threads >> 5);
  const float inv_n = 1.0f / static_cast<float>(N);

#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = (c * threads + tid) * V;
    if (col < N) {
      float v[V];
      load_vec<T, V>(gamma + col, v);
      store_f<V>(s_gamma + col, v);
      load_vec<T, V>(beta + col, v);
      store_f<V>(s_beta + col, v);
    }
  }
  float sg[C][V], sb[C][V], sd[C][V];  // the block's column sums of dz u, dz, dh
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int e = 0; e < V; ++e) sg[c][e] = sb[c][e] = sd[c][e] = 0.f;

  const long long r0 = static_cast<long long>(blockIdx.x) * rows;
  const long long r1 = r0 + rows < M ? r0 + rows : M;
  auto fetch = [&](long long r, int stage) {
    if constexpr (kBytes >= 4) {
      T* hs = ring + 2 * stage * slots;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int col = (c * threads + tid) * V;
        if (col < N) {
          cp_async<kBytes>(hs + col, h + r * N + col);
          cp_async<kBytes>(hs + slots + col, g + r * N + col);
        }
      }
      cp_async_commit();
    }
  };
  // rows r0 .. r0 + stages - 2 in flight before the loop; one group each,
  // empty past the share, so that wait_group counts rows
  for (int s = 0; s < stages - 1; ++s) {
    if (r0 + s < r1) {
      fetch(r0 + s, s);
    } else {
      cp_async_commit();
    }
  }
  int stage = 0;
  for (long long r = r0; r < r1; ++r) {
    float hv[C][V], gv[C][V];
    if (stages > 0) {
      const int ahead = stage + stages - 1 < stages ? stage + stages - 1 : stage - 1;
      if (r + stages - 1 < r1) {
        fetch(r + stages - 1, ahead);
      } else {
        cp_async_commit();
      }
      cp_async_wait(stages - 1);  // this row's group has landed
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = (c * threads + tid) * V;
      if (col >= N) continue;
      if (stages > 0) {
        load_vec<T, V>(ring + 2 * stage * slots + col, hv[c]);
        load_vec<T, V>(ring + (2 * stage + 1) * slots + col, gv[c]);
      } else {
        load_vec<T, V>(h + r * N + col, hv[c]);
        load_vec<T, V>(g + r * N + col, gv[c]);
      }
    }
    if (++stage == stages) stage = 0;

    Stats st = {0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < C; ++c)
      if ((c * threads + tid) * V < N) st = chan(st, chunk_stats<V>(hv[c]));
    st = block_stats(st, red_stats, wpow2);
    const float mu = st.mean;
    const float rsig = rsqrtf(st.m2 * inv_n + eps);

    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = (c * threads + tid) * V;
      if (col >= N) continue;
      float gam[V], bet[V];
      load_f<V>(s_gamma + col, gam);
      load_f<V>(s_beta + col, bet);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float u, dz, du;
        chain_element(hv[c][e], gv[c][e], mu, rsig, gam[e], bet[e], u, dz, du);
        sg[c][e] += dz * u;
        sb[c][e] += dz;
        hv[c][e] = u;
        gv[c][e] = du;
        m1 += du;
        m2 += du * u;
      }
    }
    const float2 ms = block_sum2(m1, m2, red_sums, wpow2);
    m1 = ms.x * inv_n;
    m2 = ms.y * inv_n;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = (c * threads + tid) * V;
      if (col >= N) continue;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float v = rsig * (gv[c][e] - m1 - hv[c][e] * m2);
        sd[c][e] += v;
        gv[c][e] = v;
      }
      store_vec<T, V>(dh + r * N + col, gv[c]);
    }
  }

  float* out = partial + static_cast<long long>(blockIdx.x) * 3 * N;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = (c * threads + tid) * V;
    if (col < N) {
      store_f<V>(out + col, sg[c]);
      store_f<V>(out + N + col, sb[c]);
      store_f<V>(out + 2 * N + col, sd[c]);
    }
  }
}

// N beyond the registers' reach: the row walked from memory three times,
// the column sums in the block's row of `partial`, each entry read and
// written by its one thread.
template <typename T, int V>
__global__ void __launch_bounds__(kWideMaxThreads)
chain_walk_kernel(const T* __restrict__ h, const T* __restrict__ g, const T* __restrict__ gamma,
                  const T* __restrict__ beta, T* __restrict__ dh, float* __restrict__ partial,
                  long long M, int N, long long rows, float eps) {
  __shared__ Stats red_stats[kWideMaxWarps];
  __shared__ float2 red_sums[kWideMaxWarps];
  const int step = blockDim.x * V, first = threadIdx.x * V;
  const int wpow2 = pow2_at_least(blockDim.x >> 5);
  const float inv_n = 1.0f / static_cast<float>(N);
  float* p_dgamma = partial + static_cast<long long>(blockIdx.x) * 3 * N;
  float* p_dbeta = p_dgamma + N;
  float* p_db = p_dbeta + N;
  const float zero[V] = {};
  for (int col = first; col < N; col += step) {
    store_f<V>(p_dgamma + col, zero);
    store_f<V>(p_dbeta + col, zero);
    store_f<V>(p_db + col, zero);
  }

  const long long r0 = static_cast<long long>(blockIdx.x) * rows;
  const long long r1 = r0 + rows < M ? r0 + rows : M;
  for (long long r = r0; r < r1; ++r) {
    const T* hr = h + r * N;
    const T* gr = g + r * N;
    float hv[V], gv[V], gam[V], bet[V], a[V], b[V];
    Stats st = {0.f, 0.f, 0.f};
    for (int col = first; col < N; col += step) {
      load_vec<T, V>(hr + col, hv);
      st = chan(st, chunk_stats<V>(hv));
    }
    st = block_stats(st, red_stats, wpow2);
    const float mu = st.mean;
    const float rsig = rsqrtf(st.m2 * inv_n + eps);
    float m1 = 0.f, m2 = 0.f;
    for (int col = first; col < N; col += step) {
      load_vec<T, V>(hr + col, hv);
      load_vec<T, V>(gr + col, gv);
      load_vec<T, V>(gamma + col, gam);
      load_vec<T, V>(beta + col, bet);
      load_f<V>(p_dgamma + col, a);
      load_f<V>(p_dbeta + col, b);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float u, dz, du;
        chain_element(hv[e], gv[e], mu, rsig, gam[e], bet[e], u, dz, du);
        a[e] += dz * u;
        b[e] += dz;
        m1 += du;
        m2 += du * u;
      }
      store_f<V>(p_dgamma + col, a);
      store_f<V>(p_dbeta + col, b);
    }
    const float2 ms = block_sum2(m1, m2, red_sums, wpow2);
    m1 = ms.x * inv_n;
    m2 = ms.y * inv_n;
    for (int col = first; col < N; col += step) {
      load_vec<T, V>(hr + col, hv);
      load_vec<T, V>(gr + col, gv);
      load_vec<T, V>(gamma + col, gam);
      load_vec<T, V>(beta + col, bet);
      load_f<V>(p_db + col, a);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float u, dz, du;
        chain_element(hv[e], gv[e], mu, rsig, gam[e], bet[e], u, dz, du);
        gv[e] = rsig * (du - m1 - u * m2);
        a[e] += gv[e];
      }
      store_f<V>(p_db + col, a);
      store_vec<T, V>(dh + r * N + col, gv);
    }
  }
}

// Whether an instance may take kSmemDynamic bytes of dynamic shared memory on
// a device (above the default 48 KB, less its static buffers): set on its
// first launch or query there.
template <typename T, int V, int C>
std::atomic<bool> wide_smem_raised[kMaxDevices];

template <typename T, int V, int C, typename K>
int raise_smem(K kern) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!wide_smem_raised<T, V, C>[dev].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemDynamic);
    if (e != cudaSuccess) return static_cast<int>(e);
    wide_smem_raised<T, V, C>[dev].store(true, std::memory_order_release);
  }
  return 0;
}

// One instance of the wide chain (C == 0: the walk), launched or asked how
// many of its blocks an SM holds.
template <typename T>
struct WideChain {
  const void *h, *g, *gamma, *beta;
  void* dh;
  float* partial;
  long long M;
  int N;
  long long blocks;
  int threads;
  float eps;
  cudaStream_t st;
  int* blocks_per_sm;  // non-null: the query, nothing launched

  template <int V, int C>
  int run() {
    const long long rows = (M + blocks - 1) / blocks;
    const T *h_ = static_cast<const T*>(h), *g_ = static_cast<const T*>(g);
    const T *gam = static_cast<const T*>(gamma), *bet = static_cast<const T*>(beta);
    T* dh_ = static_cast<T*>(dh);
    if constexpr (C == 0) {
      auto kern = chain_walk_kernel<T, V>;
      if (blocks_per_sm)
        return static_cast<int>(
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kern, threads, 0));
      kern<<<static_cast<unsigned>(blocks), threads, 0, st>>>(h_, g_, gam, bet, dh_, partial, M,
                                                              N, rows, eps);
    } else {
      if (C * threads * V < N) return cudaErrorInvalidValue;
      const int slots = C * threads * V;
      const int stages = wide_stages<T, V>(slots);
      const int smem = wide_smem<T>(slots, stages);
      if (smem > kSmemDynamic) return cudaErrorInvalidValue;
      auto kern = chain_wide_kernel<T, V, C>;
      if (int e = raise_smem<T, V, C>(kern)) return e;
      if (blocks_per_sm)
        return static_cast<int>(
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kern, threads, smem));
      kern<<<static_cast<unsigned>(blocks), threads, smem, st>>>(h_, g_, gam, bet, dh_, partial,
                                                                 M, N, rows, stages, eps);
    }
    return static_cast<int>(cudaGetLastError());
  }
};

// The instance for V values a vector and kWideValues / V vectors a thread, or
// the walk (chunks == 0).
template <typename T>
int dispatch_wide(WideChain<T>& op, int vec, int chunks) {
#define SPECTRE_WIDE(VV)                                                         \
  if (vec == VV) return chunks == 0 ? op.template run<VV, 0>()                   \
                                    : op.template run<VV, kWideValues / VV>();
  if constexpr (sizeof(T) == 2) {
    SPECTRE_WIDE(8)
  }
  SPECTRE_WIDE(4) SPECTRE_WIDE(2) SPECTRE_WIDE(1)
#undef SPECTRE_WIDE
  return cudaErrorInvalidValue;
}

bool wide_plan_ok(int vec, int chunks, int threads) {
  return vec > 0 && kWideValues % vec == 0 && threads >= 32 && threads <= kWideMaxThreads &&
         threads % 32 == 0 && (chunks == 0 || chunks * vec == kWideValues);
}

}  // namespace

// How many blocks of the wide chain's instance (vec values a vector, chunks
// vectors a thread, 0: the walk; threads a block) an SM of the current
// device holds, into *blocks_per_sm. Returns a CUDA error code (0 on success).
extern "C" int fused_spectre_linear_bwd_wide_occupancy(int dtype_code, int vec, int chunks,
                                                       int threads, int* blocks_per_sm) {
  if (!wide_plan_ok(vec, chunks, threads) || blocks_per_sm == nullptr)
    return cudaErrorInvalidValue;
  if (dtype_code == 0) {
    WideChain<float> op{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, 1, 1, threads,
                        0.f, nullptr, blocks_per_sm};
    return dispatch_wide(op, vec, chunks);
  }
  if (dtype_code == 1) {
    WideChain<bf16> op{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, 1, 1, threads,
                       0.f, nullptr, blocks_per_sm};
    return dispatch_wide(op, vec, chunks);
  }
  return cudaErrorInvalidValue;
}

// The arguments of fused_spectre_linear_bwd_chain for any N >= 1, and the
// plan (ops/kernels/fused_linear.py::wide_chain_plan): vec values a vector
// load (h, g, dh, gamma and beta aligned to vec elements), chunks vectors a
// thread (0: the walk), threads a block; `blocks` blocks, each owning
// ceil(M / blocks) rows.
extern "C" int fused_spectre_linear_bwd_wide(int dtype_code, const void* h, const void* g,
                                             const void* gamma, const void* beta, void* dh,
                                             void* dgamma, void* dbeta, void* db,
                                             void* partial, long long M, long long N,
                                             long long blocks, float eps, void* stream, int vec,
                                             int chunks, int threads) {
  if (M <= 0 || N <= 0 || 3 * N > 0x7fffffffLL || blocks <= 0 || blocks > M ||
      blocks > 0x7fffffffLL || !wide_plan_ok(vec, chunks, threads) || N % vec != 0 ||
      (chunks > 0 && N > kWideReach))
    return cudaErrorInvalidValue;
  const int el = dtype_code == 1 ? 2 : 4;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(g) |
                          reinterpret_cast<uintptr_t>(dh) | reinterpret_cast<uintptr_t>(gamma) |
                          reinterpret_cast<uintptr_t>(beta);
  if (bases % (static_cast<uintptr_t>(vec) * el) != 0) return cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(N);
  float* part = static_cast<float*>(partial);
  int err;
  if (dtype_code == 0) {
    WideChain<float> op{h, g, gamma, beta, dh, part, M, n, blocks, threads, eps, st, nullptr};
    err = dispatch_wide(op, vec, chunks);
  } else if (dtype_code == 1) {
    WideChain<bf16> op{h, g, gamma, beta, dh, part, M, n, blocks, threads, eps, st, nullptr};
    err = dispatch_wide(op, vec, chunks);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  if (dtype_code == 0) {
    column_sum_kernel<float><<<static_cast<unsigned>((3LL * n + 31) / 32), 32 * kSegments, 0, st>>>(
        part, blocks, n, static_cast<float*>(dgamma), static_cast<float*>(dbeta),
        static_cast<float*>(db));
  } else {
    column_sum_kernel<bf16><<<static_cast<unsigned>((3LL * n + 31) / 32), 32 * kSegments, 0, st>>>(
        part, blocks, n, static_cast<bf16*>(dgamma), static_cast<bf16*>(dbeta),
        static_cast<bf16*>(db));
  }
  return static_cast<int>(cudaGetLastError());
}



// ------------------------------------------------- a column-split layer's chain
//
// fused_spectre_linear_shard_sums and fused_spectre_linear_shard_dh: the
// chain above for a SpectreLinear whose N columns are split over
// tensor-parallel ranks, each rank holding n = N / size of them. A row's
// LayerNorm backward needs two sums over all N columns, sum du and
// sum du * u, so the chain runs in two phases around an all-gather of
// them:
//
//   A (shard_sums): from h, g and this rank's gamma, beta and the forward's
//     merged (mean, rstd) of each row (not recomputed: h holds a part of the
//     row), u, z, dz and du; each row's (sum du, sum du * u) over the n
//     columns [M] float2, and the column sums dgamma = sum dz * u and
//     dbeta = sum dz [2, n].
//   B (shard_dh): the ranks' row sums [size, M] float2 added in rank order
//     (every rank the same bits), then dh = rstd (du - S1 / N - u S2 / N),
//     stored once in the input dtype, and db = sum dh (of the float32 dh).
//
// B recomputes du from h and g rather than reading it back. What bounds both
// on the H100: bytes (A reads h and g, 4 M n bytes in bf16; B reads them
// again and writes dh, 6 M n), and close behind them instruction issue:
// some 30 float32 operations an element, two of them on the special
// function unit (gelu_grad's ex2 and reciprocal). What held the first
// design at 19-31% of the byte bound: scalar 2-byte loads (a warp
// instruction moved 64 bytes), two shared-memory read-modify-writes of the
// column partials an element, gamma and beta loaded again every row, no
// row in flight, and 1,056 blocks of 16 rows, each writing a partial row.
//
// Design (the plan: ops/kernels/fused_linear.py::shard_chain_plan). A team
// of `lanes` lanes (a power of two up to a warp) takes a row; lane l of a
// team owns the columns tile + (c * lanes + l) * V + [0, V), c < C: V values
// a vector load of up to 16 bytes (V divides n; 8 or 4 bytes where 16 would
// leave lanes idle, e.g. n = 384 in bf16: 96 8-byte vectors, 3 a lane), at
// most 4 vectors and 16 values a lane. Its columns are the same in every row,
// so its gamma, beta and column partials (dgamma and dbeta in A, db in B)
// stay in registers over all its rows. A row wider than a warp's 32 C V
// values is cut into tiles of that width, one per blockIdx.y; A then writes
// each tile's row sums, which a third launch adds in tile order. Widths
// that no vector divides evenly among the lanes (n = 25 or 50) leave the
// last lanes' chunks masked. A team's next row of h and g is on its way
// while it computes the current one: in A into registers, in B through a
// ring of two rows in shared memory by cp.async (each lane copies and reads
// back only its own chunks, so the ring needs no barrier), which keeps B's
// registers low enough for three blocks an SM; each phase was measured both
// ways on the card, and A is faster through registers at two blocks an SM,
// B through the ring at three (PERF.md). GELU' takes the ex2 and the
// reciprocal that flush subnormals (gelu_grad_ftz), five instructions of
// some 35 an element fewer. A row's two sums in A go across the team by a
// butterfly of shuffles (the partners add the same two values: every lane
// the same bits). Each block of kShardThreads owns a contiguous share of the
// rows, its teams taking every teams-th row of it; at the end the teams'
// column partials meet in shared memory and are added in team order into one
// float32 partial row a block. The grid is the blocks an SM holds (two or
// three), so a few hundred partial rows, whose column sums
// shard_column_sum_kernel takes in its fixed order in a second launch, a
// programmatic dependent of the first (it is scheduled while the first runs
// and waits for it on the device, which hides its launch). Folding that
// pass into the grid's last block to finish was not taken: one block would
// read every partial row alone, and a counter kept between calls is unsafe
// for ranks that share a card in threads. No float atomics: two
// runs give the same bits.

namespace {

constexpr int kShardThreads = 256;  // fused_linear.py: SHARD_THREADS
constexpr int kShardChunks = 4;     // vectors a lane at most: SHARD_CHUNKS
constexpr int kShardValues = 16;    // values a lane at most: SHARD_VALUES
constexpr int kMaxTiles = 65535;    // blockIdx.y
constexpr int kShardSegments = 32;  // column-sum pass: strided segments a column
constexpr int kShardStages = 2;     // phase B's ring: rows a team

// Phase B's rows come through a ring in shared memory (kShardStages rows a
// team, by cp.async); phase A's, and single bf16 values (cp.async copies at
// least 4 bytes), through registers loaded a row ahead.
template <typename T, int V, bool kDh>
__host__ __device__ constexpr bool shard_ring() {
  return kDh && V * sizeof(T) >= 4;
}

// gelu_grad with the ex2 and the reciprocal flushing subnormals to zero:
// the same bits unless e^(-z^2 / 2) < 2^-126 (|z| > 13.2), where the
// result moves by less than 1e-37; five instructions an element fewer.
__device__ __forceinline__ float gelu_grad_ftz(float z) {
  float e, t;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(z * z * kNegHalfLog2e));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(t) : "f"(fmaf(kErfP * kInvSqrt2, fabsf(z), 1.0f)));
  const float poly =
      t * fmaf(t, fmaf(t, fmaf(t, fmaf(t, kErfA5, kErfA4), kErfA3), kErfA2), kErfA1);
  const float erf_abs = fmaf(-poly, e, 1.0f);
  return fmaf(z * kInvSqrt2Pi, e, 0.5f + copysignf(0.5f * erf_abs, z));
}

// Phase A (kDh false): rowsums [tiles][M] (this tile's (sum du, sum du u) of
// each row) and partial [blocks][2][n] (the block's dgamma, dbeta over its
// rows). Phase B (kDh true): dh, and partial [blocks][n] (the block's db);
// `gathered` [size][M] are the ranks' row sums, inv_full = 1 / N.
template <typename T, int V, int C, bool kDh>
__global__ void __launch_bounds__(kShardThreads)
shard_chain_kernel(const T* __restrict__ h, const T* __restrict__ g, const T* __restrict__ gamma,
                   const T* __restrict__ beta, const float2* __restrict__ mstats,
                   const float2* __restrict__ gathered, int size, float inv_full,
                   T* __restrict__ dh, float2* __restrict__ rowsums, float* __restrict__ partial,
                   long long M, int n, int lanes, long long rows) {
  constexpr int P = kDh ? 1 : 2;  // column sums a column
  constexpr int kBytes = V * static_cast<int>(sizeof(T));
  constexpr bool kRing = shard_ring<T, V, kDh>();
  using R = Raw<T, V>;
  // phase B's rings [team][stage][h, g][tile]; after the rows, the teams'
  // column partials [team][P][tile] in the same bytes
  extern __shared__ __align__(16) unsigned char smem[];
  const int team = threadIdx.x / lanes, lane = threadIdx.x % lanes;
  const int teams = kShardThreads / lanes;
  const int tile = lanes * C * V;
  const int base = blockIdx.y * tile;

  int col[C];
  bool in[C];
  float gam[C][V], bet[C][V], pa[C][V], pb[C][V];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    col[c] = base + (c * lanes + lane) * V;
    in[c] = col[c] < n;  // whole vectors: V divides n
#pragma unroll
    for (int e = 0; e < V; ++e) gam[c][e] = bet[c][e] = pa[c][e] = pb[c][e] = 0.f;
    if (in[c]) {
      load_vec<T, V>(gamma + col[c], gam[c]);
      load_vec<T, V>(beta + col[c], bet[c]);
    }
  }

  const long long r0 = static_cast<long long>(blockIdx.x) * rows;
  const long long r1 = r0 + rows < M ? r0 + rows : M;
  T* ring = reinterpret_cast<T*>(smem) + static_cast<long long>(team) * kShardStages * 2 * tile;
  R hr[C] = {}, gr[C] = {}, hn[C] = {}, gn[C] = {};  // registers: this row, the next
  // a row of the team's h and g on its way: into the ring (one cp.async
  // group a row, empty past the share, so that wait_group counts rows; each
  // lane copies and reads back only its own chunks: no barrier), or into
  // registers
  auto fetch = [&](long long r, int stage, R* hh, R* gg) {
    if (r < r1) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (!in[c]) continue;
        if constexpr (kRing) {
          const int at = (c * lanes + lane) * V;
          cp_async<kBytes>(ring + 2 * stage * tile + at, h + r * n + col[c]);
          cp_async<kBytes>(ring + (2 * stage + 1) * tile + at, g + r * n + col[c]);
        } else {
          hh[c] = *reinterpret_cast<const R*>(h + r * n + col[c]);
          gg[c] = *reinterpret_cast<const R*>(g + r * n + col[c]);
        }
      }
    }
    if constexpr (kRing) cp_async_commit();
  };
  long long r = r0 + team;
  if constexpr (kRing) {
    for (int s = 0; s < kShardStages - 1; ++s) fetch(r + s * teams, s, hr, gr);
  } else {
    fetch(r, 0, hr, gr);
  }
  // the column-sum pass behind this kernel may be scheduled now: it waits
  // for the whole grid before it reads
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  int stage = 0;
  // the trip count is the block's (first team's), so that every lane of a
  // warp reaches the shuffles; a team past the share's end only shuffles
  for (long long first = r0; first < r1; first += teams, r += teams) {
    const bool valid = r < r1;
    if constexpr (kRing) {
      fetch(r + (kShardStages - 1) * teams, stage == 0 ? kShardStages - 1 : stage - 1, hr, gr);
      cp_async_wait(kShardStages - 1);  // this row's group has landed
    } else {
      fetch(r + teams, 0, hn, gn);
    }
    float s1 = 0.f, s2 = 0.f;
    if (valid) {
      const float2 ms = mstats[r];
      float m1 = 0.f, m2 = 0.f;
      if constexpr (kDh) {
        for (int j = 0; j < size; ++j) {  // rank order
          const float2 rs = gathered[static_cast<long long>(j) * M + r];
          m1 += rs.x;
          m2 += rs.y;
        }
        m1 *= inv_full;
        m2 *= inv_full;
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (!in[c]) continue;
        float hv[V], gv[V];
        if constexpr (kRing) {
          const int at = (c * lanes + lane) * V;
          load_vec<T, V>(ring + 2 * stage * tile + at, hv);
          load_vec<T, V>(ring + (2 * stage + 1) * tile + at, gv);
        } else {
          raw_to_f<T, V>(hr[c], hv);
          raw_to_f<T, V>(gr[c], gv);
        }
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float u = (hv[e] - ms.x) * ms.y;
          const float dz = gv[e] * gelu_grad_ftz(u * gam[c][e] + bet[c][e]);
          const float du = dz * gam[c][e];
          if constexpr (kDh) {
            const float v = ms.y * (du - m1 - u * m2);
            pa[c][e] += v;
            gv[e] = v;
          } else {
            s1 += du;
            s2 += du * u;
            pa[c][e] += dz * u;
            pb[c][e] += dz;
          }
        }
        if constexpr (kDh) store_vec<T, V>(dh + r * n + col[c], gv);
      }
    }
    if constexpr (!kDh) {
      s1 = team_sum(s1, lanes);
      s2 = team_sum(s2, lanes);
      if (valid && lane == 0)
        rowsums[static_cast<long long>(blockIdx.y) * M + r] = make_float2(s1, s2);
    }
    if constexpr (kRing) {
      if (++stage == kShardStages) stage = 0;
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        hr[c] = hn[c];
        gr[c] = gn[c];
      }
    }
  }

  // the teams' column partials, added in team order into the block's row
  float* s_part = reinterpret_cast<float*>(smem);
  if constexpr (kRing) cp_async_wait(0);
  __syncthreads();  // every team is done with its ring
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (!in[c]) continue;
    const int at = (c * lanes + lane) * V;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      s_part[team * P * tile + at + e] = pa[c][e];
      if constexpr (!kDh) s_part[(team * P + 1) * tile + at + e] = pb[c][e];
    }
  }
  __syncthreads();
  const int width = n - base < tile ? n - base : tile;
  float* out = partial + static_cast<long long>(blockIdx.x) * P * n + base;
  for (int i = threadIdx.x; i < P * width; i += kShardThreads) {
    const int p = i / width, j = i % width;
    float v = s_part[p * tile + j];
    for (int t = 1; t < teams; ++t) v += s_part[(t * P + p) * tile + j];
    out[static_cast<long long>(p) * n + j] = v;
  }
}

// out[j] = sum over blocks of partial[block][j], j < width, in a fixed
// order: segment s adds blocks s, s + 32, ... in turn, then the 32 segments
// in turn. Launched behind the chain kernel as a programmatic dependent
// (shard_launch_dependent): its blocks may start while the chain kernel
// runs and wait here for all of it.
template <typename T>
__global__ void __launch_bounds__(32 * kShardSegments)
shard_column_sum_kernel(const float* __restrict__ partial, long long blocks, int width,
                        T* __restrict__ out) {
  __shared__ float s_seg[kShardSegments][33];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int lane = threadIdx.x & 31, seg = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (j < width) {
#pragma unroll 4  // the loads go out together; the sum keeps its order
    for (long long b = seg; b < blocks; b += kShardSegments) acc += partial[b * width + j];
  }
  s_seg[seg][lane] = acc;
  __syncthreads();
  if (seg != 0 || j >= width) return;
  float total = s_seg[0][lane];
#pragma unroll
  for (int s = 1; s < kShardSegments; ++s) total += s_seg[s][lane];
  out[j] = from_f<T>(total);
}

// out[m] = the tiles' row sums [tiles][M] of row m added in tile order
__global__ void __launch_bounds__(256)
shard_row_sum_kernel(const float2* __restrict__ part, int tiles, long long M,
                     float2* __restrict__ out) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const long long m = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (m >= M) return;
  float2 s = part[m];
  for (int t = 1; t < tiles; ++t) {
    const float2 v = part[static_cast<long long>(t) * M + m];
    s.x += v.x;
    s.y += v.y;
  }
  out[m] = s;
}

// Dynamic shared memory of an instance: its rings, or the teams' column
// partials after them, whichever is larger.
template <typename T, int V, int C, bool kDh>
constexpr int shard_smem() {
  constexpr int ring = shard_ring<T, V, kDh>()
                           ? kShardStages * kShardThreads * 2 * C * V * static_cast<int>(sizeof(T))
                           : 0;
  constexpr int part = kShardThreads * (kDh ? 1 : 2) * C * V * static_cast<int>(sizeof(float));
  return ring > part ? ring : part;
}

// Whether an instance may take more than the default 48 KB of dynamic
// shared memory on a device: set on its first launch or query there.
template <typename T, int V, int C, bool kDh>
std::atomic<bool> shard_smem_raised[kMaxDevices];

template <typename T, int V, int C, bool kDh, typename K>
int raise_shard_smem(K kern) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!shard_smem_raised<T, V, C, kDh>[dev].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             shard_smem<T, V, C, kDh>());
    if (e != cudaSuccess) return static_cast<int>(e);
    shard_smem_raised<T, V, C, kDh>[dev].store(true, std::memory_order_release);
  }
  return 0;
}

// Launches kern<<<grid, threads>>>(args...) on st as a programmatic
// dependent of the kernel before it (Hopper): it may be scheduled before that
// kernel ends and waits for it with griddepcontrol.wait.
template <typename... Params, typename... Args>
int shard_launch_dependent(void (*kern)(Params...), unsigned grid, unsigned threads,
                           cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kern, static_cast<Params>(args)...));
}

int shard_tiles(long long n, int vec, int lanes, int chunks) {
  const long long tile = static_cast<long long>(lanes) * chunks * vec;
  return static_cast<int>((n + tile - 1) / tile);
}

bool shard_plan_ok(long long M, long long n, long long blocks, int vec, int lanes, int chunks,
                   int el) {
  return M > 0 && n > 0 && 2 * n <= 0x7fffffffLL && blocks > 0 && blocks <= M &&
         blocks <= 0x7fffffffLL && (vec == 1 || vec == 2 || vec == 4 || vec == 8) &&
         vec * el <= 16 && n % vec == 0 && lanes >= 1 && lanes <= 32 &&
         (lanes & (lanes - 1)) == 0 && chunks >= 1 && chunks <= kShardChunks &&
         chunks * vec <= kShardValues && shard_tiles(n, vec, lanes, chunks) <= kMaxTiles;
}

// One instance of a phase, launched or asked how many of its blocks an SM
// holds.
template <typename T, bool kDh>
struct ShardChain {
  const void *h, *g, *gamma, *beta, *mstats, *gathered;
  int size;
  float inv_full;
  void* dh;
  float2* rowsums;
  float* partial;
  long long M;
  int n, lanes, tiles;
  long long blocks;
  cudaStream_t st;
  int* blocks_per_sm;  // non-null: the query, nothing launched

  template <int V, int C>
  int run() {
    auto kern = shard_chain_kernel<T, V, C, kDh>;
    constexpr int smem = shard_smem<T, V, C, kDh>();
    if (int e = raise_shard_smem<T, V, C, kDh>(kern)) return e;
    if (blocks_per_sm)
      return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks_per_sm, kern, kShardThreads, smem));
    const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(tiles));
    kern<<<grid, kShardThreads, smem, st>>>(
        static_cast<const T*>(h), static_cast<const T*>(g), static_cast<const T*>(gamma),
        static_cast<const T*>(beta), static_cast<const float2*>(mstats),
        static_cast<const float2*>(gathered), size, inv_full, static_cast<T*>(dh), rowsums,
        partial, M, n, lanes, (M + blocks - 1) / blocks);
    return static_cast<int>(cudaGetLastError());
  }
};

// The instance of V values a vector and C vectors a lane.
template <typename T, bool kDh>
int run_shard(ShardChain<T, kDh> op, int vec, int chunks) {
#define SPECTRE_SHARD(VV, CC) \
  if (vec == VV && chunks == CC) return op.template run<VV, CC>();
  if constexpr (sizeof(T) == 2) {  // 16-byte bf16 vectors
    SPECTRE_SHARD(8, 1) SPECTRE_SHARD(8, 2)
  }
  SPECTRE_SHARD(4, 1) SPECTRE_SHARD(4, 2) SPECTRE_SHARD(4, 3) SPECTRE_SHARD(4, 4)
  SPECTRE_SHARD(2, 1) SPECTRE_SHARD(2, 2) SPECTRE_SHARD(2, 3) SPECTRE_SHARD(2, 4)
  SPECTRE_SHARD(1, 1) SPECTRE_SHARD(1, 2) SPECTRE_SHARD(1, 3) SPECTRE_SHARD(1, 4)
#undef SPECTRE_SHARD
  return cudaErrorInvalidValue;
}

template <typename T, bool kDh>
int shard_occupancy(int vec, int chunks, int* blocks_per_sm) {
  ShardChain<T, kDh> op{};
  op.blocks_per_sm = blocks_per_sm;
  return run_shard(op, vec, chunks);
}

bool shard_aligned(int vec, int el, const void* a, const void* b, const void* c, const void* d,
                   const void* e) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                          reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d) |
                          reinterpret_cast<uintptr_t>(e);
  return bases % (static_cast<uintptr_t>(vec) * el) == 0;
}

}  // namespace

// How many blocks of phase A (dh_phase 0) or B (1) for dtype_code (0:
// float32, 1: bf16), vec values a vector and chunks vectors a lane an SM of
// the current device holds, into *blocks_per_sm. Returns a CUDA error code
// (0 on success).
extern "C" int fused_spectre_linear_shard_occupancy(int dtype_code, int dh_phase, int vec,
                                                    int chunks, int* blocks_per_sm) {
  const int el = dtype_code == 1 ? 2 : 4;
  if (blocks_per_sm == nullptr || !shard_plan_ok(1, vec, 1, vec, 1, chunks, el))
    return cudaErrorInvalidValue;
  if (dtype_code == 0)
    return dh_phase ? shard_occupancy<float, true>(vec, chunks, blocks_per_sm)
                    : shard_occupancy<float, false>(vec, chunks, blocks_per_sm);
  if (dtype_code == 1)
    return dh_phase ? shard_occupancy<bf16, true>(vec, chunks, blocks_per_sm)
                    : shard_occupancy<bf16, false>(vec, chunks, blocks_per_sm);
  return cudaErrorInvalidValue;
}

// Phase A of a column-split layer's chain. h, g [M, n] contiguous; gamma,
// beta [n]; all of one dtype (0: float32, 1: bf16); mstats [M] float2, the
// forward's merged (mean, rstd). Writes rowsums [M] float2 (sum du,
// sum du * u over the n columns) and sums [2, n] in the dtype (dgamma,
// dbeta). The plan (ops/kernels/fused_linear.py::shard_chain_plan): vec
// values a vector (dividing n; h, g, gamma and beta aligned to vec
// elements), lanes a row (a power of two up to 32), chunks vectors a lane
// (at most 4 and 16 values), so tiles = ceil(n / (lanes chunks vec)) tiles a
// row; `blocks` blocks (at most M) a tile, each owning ceil(M / blocks)
// rows. partial: float32 scratch of blocks * 2 * n values, and tiles * M * 2
// after them when tiles > 1. Returns the launches' CUDA error code (0 on
// success).
extern "C" int fused_spectre_linear_shard_sums(int dtype_code, const void* h, const void* g,
                                               const void* gamma, const void* beta,
                                               const void* mstats, void* rowsums, void* sums,
                                               void* partial, long long M, long long n,
                                               long long blocks, int vec, int lanes, int chunks,
                                               void* stream) {
  const int el = dtype_code == 1 ? 2 : 4;
  if ((dtype_code != 0 && dtype_code != 1) ||
      !shard_plan_ok(M, n, blocks, vec, lanes, chunks, el))
    return cudaErrorInvalidValue;
  if (!shard_aligned(vec, el, h, g, gamma, beta, h)) return cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ni = static_cast<int>(n), tiles = shard_tiles(n, vec, lanes, chunks);
  float* part = static_cast<float*>(partial);
  float2* rows = tiles == 1 ? static_cast<float2*>(rowsums)
                            : reinterpret_cast<float2*>(part + blocks * 2 * n);
  int err;
  if (dtype_code == 0) {
    err = run_shard(ShardChain<float, false>{h, g, gamma, beta, mstats, nullptr, 1, 1.f, nullptr,
                                             rows, part, M, ni, lanes, tiles, blocks, st,
                                             nullptr}, vec, chunks);
  } else {
    err = run_shard(ShardChain<bf16, false>{h, g, gamma, beta, mstats, nullptr, 1, 1.f, nullptr,
                                            rows, part, M, ni, lanes, tiles, blocks, st, nullptr},
                    vec, chunks);
  }
  if (err != 0) return err;
  if (tiles > 1) {
    err = shard_launch_dependent(shard_row_sum_kernel, static_cast<unsigned>((M + 255) / 256),
                                 256, st, rows, tiles, M, static_cast<float2*>(rowsums));
    if (err != 0) return err;
  }
  const unsigned cgrid = static_cast<unsigned>((2LL * n + 31) / 32);
  if (dtype_code == 0)
    return shard_launch_dependent(shard_column_sum_kernel<float>, cgrid, 32 * kShardSegments, st,
                                  part, blocks, 2 * ni, static_cast<float*>(sums));
  return shard_launch_dependent(shard_column_sum_kernel<bf16>, cgrid, 32 * kShardSegments, st,
                                part, blocks, 2 * ni, static_cast<bf16*>(sums));
}

// Phase B. The operands of phase A, rowsums [size, M] float2 (every rank's
// phase-A row sums, all-gathered), n_full = size * n; writes dh [M, n] and
// db [n] in the dtype (dh aligned as h). The plan as for phase A; partial:
// float32 scratch of blocks * n values.
extern "C" int fused_spectre_linear_shard_dh(int dtype_code, const void* h, const void* g,
                                             const void* gamma, const void* beta,
                                             const void* mstats, const void* rowsums, int size,
                                             void* dh, void* db, void* partial, long long M,
                                             long long n, long long n_full, long long blocks,
                                             int vec, int lanes, int chunks, void* stream) {
  const int el = dtype_code == 1 ? 2 : 4;
  if ((dtype_code != 0 && dtype_code != 1) ||
      !shard_plan_ok(M, n, blocks, vec, lanes, chunks, el) || size < 1 || n_full != n * size ||
      n_full > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (!shard_aligned(vec, el, h, g, gamma, beta, dh)) return cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ni = static_cast<int>(n), tiles = shard_tiles(n, vec, lanes, chunks);
  const float inv_full = 1.f / static_cast<float>(n_full);
  float* part = static_cast<float*>(partial);
  int err;
  if (dtype_code == 0) {
    err = run_shard(ShardChain<float, true>{h, g, gamma, beta, mstats, rowsums, size, inv_full,
                                            dh, nullptr, part, M, ni, lanes, tiles, blocks, st,
                                            nullptr}, vec, chunks);
  } else {
    err = run_shard(ShardChain<bf16, true>{h, g, gamma, beta, mstats, rowsums, size, inv_full, dh,
                                           nullptr, part, M, ni, lanes, tiles, blocks, st,
                                           nullptr}, vec, chunks);
  }
  if (err != 0) return err;
  const unsigned cgrid = static_cast<unsigned>((n + 31) / 32);
  if (dtype_code == 0)
    return shard_launch_dependent(shard_column_sum_kernel<float>, cgrid, 32 * kShardSegments, st,
                                  part, blocks, ni, static_cast<float*>(db));
  return shard_launch_dependent(shard_column_sum_kernel<bf16>, cgrid, 32 * kShardSegments, st,
                                part, blocks, ni, static_cast<bf16*>(db));
}
