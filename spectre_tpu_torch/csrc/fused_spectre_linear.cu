// fused_spectre_linear_fwd: the SpectreLinear block in one pass,
//
//   out = GELU(LayerNorm(x @ W + b) * gamma + beta)  [+ x when K == N]
//   x [M, K], W [K, N] (the JAX [in, out] layout), b/gamma/beta [N].
//
// Replaces the forward of the TPU kernel spectre_tpu/ops/pallas/
// fused_linear.py::fused_spectre_linear (its _kernel/_forward). As there, the
// K != N adaptive-pool residual stays with the caller, and LayerNorm eps is
// passed in (1e-5 on the model path). The product is computed here, with
// f32 accumulation; LayerNorm statistics over the full row of N and the exact
// erf GELU (erff) run in f32 and the result is cast once on store. The TPU
// kernel's A&S erf approximation existed only because Mosaic lacks erf.
// When the caller passes h_out (training), the pre-LN activation x @ W + b is
// also written there in x's dtype, as the TPU kernel writes its saved
// residual; the backward (ops/kernels/fused_linear.py) reads it and does not
// run the product again. With h_out null (serving) nothing more is written.
//
// What bounds it on the H100: at the serving path's shapes (M = 65*B rows,
// K x N = 512x768, 768x512; and B x 512x100 for the head) the product is
// ~13 GFLOP per call at B=256, so the tensor cores set the floor in bf16,
// while the epilogue only needs each [M, N] row once. Each block re-reads
// all of W (<= 1.5 MB, L2-resident), so the operand stream comes from L2.
//
// Design: one block owns a tile of 32 rows and the whole N (N <= 1024), so
// the LayerNorm reduction never leaves the block and the [M, N] pre-LN
// activation touches device memory only when h_out asks for it. K is walked
// through shared memory in 32-deep (bf16) or 16-deep (f32) stages, double-buffered: cp.async
// fetches stage k+1 while the block multiplies stage k (synchronous loads
// where a 16-byte chunk would straddle the ragged N=100 edge). bf16 runs the
// product on the tensor cores through WMMA 16x16x16 fragments (f32
// accumulators; 16 warps as 2 row groups x 8 column groups); f32 runs it on
// the FP32 pipes (8 warps, 4 rows x N/32 columns per thread), so that f32
// stays exact f32 (tensor-core TF32 would lose digits). After the K loop the
// f32 tile is parked in shared memory (the stage buffers are reused) and
// each warp normalises its rows with warp-shuffle reductions. N is padded to
// a multiple of 128 with zero weight columns; ragged N and ragged M are
// masked on load and store. Shared-memory rows are padded by 16 bytes so the
// fragment loads do not pile onto one bank. Tiles above 48 KB use dynamic
// shared memory, raised with cudaFuncSetAttribute. wgmma/TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTM = 32;  // rows per block
constexpr int kMaxN = 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// Per-dtype shape of the block: K depth of one stage (two 16-deep WMMA steps
// for bf16; 16 for f32 keeps a W stage at 64 KB for N=1024) and threads.
template <typename T>
struct Cfg;
template <>
struct Cfg<bf16> { static constexpr int TK = 32, THREADS = 512; };
template <>
struct Cfg<float> { static constexpr int TK = 16, THREADS = 256; };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16-byte global -> shared copy that bypasses registers; src_bytes = 0 writes
// zeros (the masked edge) without reading src.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(s), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// dst[r * LD + c] = src[(r0 + r) * ld + c0 + c] for r0 + r < rmax and
// c0 + c < cmax, else 0, for r < ROWS and c < COLS. With vec, 16-byte chunks
// go by cp.async (completion awaited by the caller); the host sets vec only
// when cmax and ld are multiples of the chunk and src is 16-byte aligned, so
// a chunk is either wholly in range or wholly out. Without vec, elements are
// stored directly.
template <typename T, int ROWS, int COLS, int LD, int NT>
__device__ __forceinline__ void load_tile(T* __restrict__ dst, const T* __restrict__ src,
                                          long long ld, long long r0, long long c0,
                                          long long rmax, long long cmax, bool vec) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    constexpr int CV = COLS / V;
    for (int i = threadIdx.x; i < ROWS * CV; i += NT) {
      const int r = i / CV, c = (i % CV) * V;
      const bool ok = r0 + r < rmax && c0 + c < cmax;
      cp_async16(dst + r * LD + c, ok ? src + (r0 + r) * ld + c0 + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS; i += NT) {
      const int r = i / COLS, c = i % COLS;
      T v = from_f<T>(0.f);
      if (r0 + r < rmax && c0 + c < cmax) v = src[(r0 + r) * ld + c0 + c];
      dst[r * LD + c] = v;
    }
  }
}

// NPAD: N padded to a multiple of 128 (the template instance covers N <= NPAD).
template <typename T, int NPAD>
__global__ void __launch_bounds__(Cfg<T>::THREADS)
fused_spectre_linear_kernel(const T* __restrict__ x, const T* __restrict__ w,
                            const T* __restrict__ bias, const T* __restrict__ gamma,
                            const T* __restrict__ beta, T* __restrict__ out,
                            T* __restrict__ h_out, long long M, int K, int N, float eps, int identity,
                            int xvec, int wvec) {
  constexpr int TK = Cfg<T>::TK, NT = Cfg<T>::THREADS, NWARPS = NT / 32;
  // shared-memory row strides, padded by 16 bytes so that the 8 rows one
  // fragment load touches start in different banks
  constexpr int LDX = TK + 16 / sizeof(T), LDW = NPAD + 16 / sizeof(T), LDC = NPAD + 4;
  constexpr int STAGE = kTM * LDX + TK * LDW;  // elements: x tile, then W tile
  extern __shared__ __align__(128) unsigned char smem[];
  T* stages = reinterpret_cast<T*>(smem);     // 2 x [x: kTM][LDX], [W: TK][LDW]
  float* cs = reinterpret_cast<float*>(smem);  // [kTM][LDC], after the K loop
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long m0 = static_cast<long long>(blockIdx.x) * kTM;
  const int nk = (K + TK - 1) / TK;

  auto fetch = [&](int kt) {
    T* xs = stages + (kt & 1) * STAGE;
    load_tile<T, kTM, TK, LDX, NT>(xs, x, K, m0, static_cast<long long>(kt) * TK, M, K, xvec);
    load_tile<T, TK, NPAD, LDW, NT>(xs + kTM * LDX, w, N, static_cast<long long>(kt) * TK, 0, K,
                                    N, wvec);
    cp_async_commit();
  };

  if constexpr (std::is_same<T, bf16>::value) {
    using namespace nvcuda;
    constexpr int FN = NPAD / 128;           // 16-column fragments per warp
    const int wr = warp / 8, wc = warp % 8;  // 16-row group, 16*FN-column group
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FN];
#pragma unroll
    for (int f = 0; f < FN; ++f) wmma::fill_fragment(acc[f], 0.f);
    fetch(0);
    for (int kt = 0; kt < nk; ++kt) {
      if (kt + 1 < nk) {
        fetch(kt + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const T* xs = stages + (kt & 1) * STAGE;
      const T* ws = xs + kTM * LDX;
#pragma unroll
      for (int kk = 0; kk < TK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, xs + wr * 16 * LDX + kk, LDX);
#pragma unroll
        for (int f = 0; f < FN; ++f) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, ws + kk * LDW + (wc * FN + f) * 16, LDW);
          wmma::mma_sync(acc[f], a, b, acc[f]);
        }
      }
      __syncthreads();  // the next fetch overwrites this stage
    }
#pragma unroll
    for (int f = 0; f < FN; ++f)
      wmma::store_matrix_sync(cs + wr * 16 * LDC + (wc * FN + f) * 16, acc[f], LDC,
                              wmma::mem_row_major);
  } else {
    constexpr int CPT = NPAD / 32;  // columns per thread: lane + 32*j; rows warp*4 + i
    float acc[4][CPT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
    fetch(0);
    for (int kt = 0; kt < nk; ++kt) {
      if (kt + 1 < nk) {
        fetch(kt + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const T* xs = stages + (kt & 1) * STAGE;
      const T* ws = xs + kTM * LDX;
#pragma unroll 4
      for (int k = 0; k < TK; ++k) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = to_f(xs[(warp * 4 + i) * LDX + k]);
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const float bv = to_f(ws[k * LDW + lane + 32 * j]);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], bv, acc[i][j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) cs[(warp * 4 + i) * LDC + lane + 32 * j] = acc[i][j];
  }
  __syncthreads();

  // Epilogue: warp `warp` owns kTM / NWARPS consecutive rows of the tile.
  constexpr int RPW = kTM / NWARPS;
  const float inv_n = 1.f / static_cast<float>(N);
#pragma unroll 1
  for (int i = 0; i < RPW; ++i) {
    const int r = warp * RPW + i;
    const long long m = m0 + r;
    if (m >= M) break;  // warp-uniform
    float* row = cs + r * LDC;
    float s = 0.f;
    for (int n = lane; n < N; n += 32) {
      const float v = row[n] + to_f(bias[n]);
      row[n] = v;
      if (h_out != nullptr) h_out[m * N + n] = from_f<T>(v);
      s += v;
    }
    const float mean = warp_sum(s) * inv_n;
    float q = 0.f;
    for (int n = lane; n < N; n += 32) {
      const float dv = row[n] - mean;
      q += dv * dv;
    }
    const float rstd = rsqrtf(warp_sum(q) * inv_n + eps);
    for (int n = lane; n < N; n += 32) {
      const float z = (row[n] - mean) * rstd * to_f(gamma[n]) + to_f(beta[n]);
      float y = 0.5f * z * (1.f + erff(z * 0.70710678118654752f));
      if (identity) y += to_f(x[m * K + n]);
      out[m * N + n] = from_f<T>(y);
    }
  }
}

template <typename T, int NPAD>
int launch(const void* x, const void* w, const void* b, const void* g, const void* be, void* out,
           void* h_out, long long M, long long K, long long N, float eps, cudaStream_t st) {
  constexpr int TK = Cfg<T>::TK;
  constexpr int V = 16 / sizeof(T);
  // the kernel's padded strides: x and W rows + V elements, the f32 tile + 4
  constexpr int stage_bytes =
      2 * (kTM * (TK + V) + TK * (NPAD + V)) * static_cast<int>(sizeof(T));
  constexpr int tile_bytes = kTM * (NPAD + 4) * static_cast<int>(sizeof(float));
  constexpr int smem = stage_bytes > tile_bytes ? stage_bytes : tile_bytes;
  auto kern = fused_spectre_linear_kernel<T, NPAD>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int xvec = (K % V == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const int wvec = (N % V == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  const dim3 grid(static_cast<unsigned>((M + kTM - 1) / kTM));
  kern<<<grid, Cfg<T>::THREADS, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<const T*>(g), static_cast<const T*>(be), static_cast<T*>(out),
      static_cast<T*>(h_out), M,
      static_cast<int>(K), static_cast<int>(N), eps, K == N, xvec, wvec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* w, const void* b, const void* g, const void* be,
             void* out, void* h_out, long long M, long long K, long long N, float eps,
             cudaStream_t st) {
  if (N <= 128) return launch<T, 128>(x, w, b, g, be, out, h_out, M, K, N, eps, st);
  if (N <= 256) return launch<T, 256>(x, w, b, g, be, out, h_out, M, K, N, eps, st);
  if (N <= 512) return launch<T, 512>(x, w, b, g, be, out, h_out, M, K, N, eps, st);
  if (N <= 768) return launch<T, 768>(x, w, b, g, be, out, h_out, M, K, N, eps, st);
  return launch<T, 1024>(x, w, b, g, be, out, h_out, M, K, N, eps, st);
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16 (every tensor in that dtype).
// h_out: null, or [M, N] to receive the pre-LN activation.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int fused_spectre_linear_fwd(int dtype_code, const void* x, const void* w,
                                        const void* b, const void* gamma, const void* beta,
                                        void* out, void* h_out, long long M, long long K,
                                        long long N, float eps, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || N > kMaxN || K > 0x7fffffffLL ||
      (M + kTM - 1) / kTM > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0) return dispatch<float>(x, w, b, gamma, beta, out, h_out, M, K, N, eps, st);
  if (dtype_code == 1) return dispatch<bf16>(x, w, b, gamma, beta, out, h_out, M, K, N, eps, st);
  return cudaErrorInvalidValue;
}
