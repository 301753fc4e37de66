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
// shared memory, raised with cudaFuncSetAttribute.
//
// fused_spectre_linear_wgmma: the same function in bf16 on the Hopper
// mainloop of wgmma_gemm.cuh, which the wrapper (ops/kernels/fused_linear.py
// ::forward_kernel) picks for every bf16 call that TMA can describe (N and K
// multiples of 8, 16-byte aligned x and W) with N <= 768. float32 (exact f32
// on the FP32 pipes), the head's N = 100 (W's 200-byte rows break TMA's
// 16-byte stride rule) and 768 < N <= 1024 stay on the kernel above.
// Why 768: a block owns 64 rows and the whole N so that LayerNorm never
// leaves it, and 64 x N f32 sums in registers take 64 N of the SM's 65,536:
// 49,152 at N = 768, all of them at N = 1,024.
//
// Design. A block owns 64 rows (the wgmma M) and N/256 warpgroups, each
// holding a 64 x 256 f32 tile in 128 registers a thread (ptxas gives 168 a
// thread at 384 threads). Its first thread keeps a ring of K stages full by
// TMA (wgmma_gemm.cuh::Ring). A stage is the [64 rows, 64 K] tile of x
// (K-major, one 128-byte-swizzled box) and the [64 K, N] tile of W in the
// JAX [in, out] layout, N contiguous, as N/64 boxes side by side: W is the
// MN-major ("transposed") B operand of wgmma.mma_async m64n256k16 (trans-b
// = 1; descriptors in wgmma_gemm.cuh). A stage is released by every warp
// once its warpgroup's wgmma on it has completed (wait_group 1 keeps one
// stage's products in flight) and is refilled at once. Ragged M, N and K
// are zeros loaded by TMA and masked in the epilogue. Stages: 2 at N = 768
// (104 KB each: 8 KB of x, 96 KB of W), 3 at N = 512, 4 at N <= 256.
// Epilogue, in registers: h = sums + bias; row sums meet across the quad by
// shuffles and across warpgroups in shared memory behind a named barrier
// (bar.sync 1), first for the mean, then for the variance (two passes over
// the registers); GELU(LN) in f32 with erff; h and out are cast once,
// written into the freed stage buffers in the 128-byte-swizzled box layout
// (no bank conflicts) and stored by TMA, which clips ragged rows and
// columns. What bounds it: at
// (16,640 x 512)(512 x 768) the bytes of x, W, out and h (0.0206 ms at
// 3.35 TB/s) against 13.1 GFLOP (0.0132 ms); every tile reads all of W
// from L2 (260 tiles x 768 KB at B = 256). Measured on the H100 and not
// used: stores straight from the registers in a persistent grid (slower
// than the TMA store), a cluster of two blocks multicasting W (half the L2
// reads, but every stage then waits for both blocks: slower at every
// shape, most at K = 8,192), and 32-deep stages, 4 at N = 768 and 6 at
// N = 512 (faster at N = 768 only).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma_gemm.cuh"

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

__device__ __forceinline__ float gelu_erf(float z) {
  return 0.5f * z * (1.f + erff(z * 0.70710678118654752f));
}

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
      float y = gelu_erf(z);
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


// ---------------------------------------------------------------- wgmma, bf16

constexpr int kWgMaxN = 768;

template <int NWG>
struct WgCfg {
  static constexpr int STAGE = wg::kBoxBytes * (1 + 4 * NWG);  // x box, then N/64 W boxes
  static constexpr int STAGES = NWG == 3 ? 2 : (NWG == 2 ? 3 : 4);
  static constexpr int THREADS = 128 * NWG;
  static constexpr int PARAMS = 3 * 256 * NWG;  // bias, gamma, beta in f32, zero past N
  static constexpr int SMEM = STAGES * STAGE + PARAMS * 4 + 1024;
  // out and h staged for the TMA store in the freed stage buffers
  static_assert(2 * NWG * 4 * wg::kBoxBytes <= STAGES * STAGE, "staging does not fit");
};

template <int NWG>
__global__ void __launch_bounds__(WgCfg<NWG>::THREADS, 1)
fused_linear_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                          const __grid_constant__ CUtensorMap wmap,
                          const __grid_constant__ CUtensorMap omap,
                          const __grid_constant__ CUtensorMap hmap, const bf16* __restrict__ x,
                          const bf16* __restrict__ bias, const bf16* __restrict__ gamma,
                          const bf16* __restrict__ beta, int M, int K, int N, float eps,
                          int save_h) {
  using C = WgCfg<NWG>;
  constexpr int S = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  __shared__ wg::Ring<S> ring;
  __shared__ float red[2][NWG][64];
  unsigned char* smem = wg::align1024(smem_raw);
  float* pb = reinterpret_cast<float*>(smem + S * C::STAGE);  // [3][256 NWG]
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * 64;
  const int nk = (K + 63) / 64, nbox = (N + 63) / 64;
  // step i: the x box at (k, m) = (64 i, m0) and the W boxes at (n, k) = (64 j, 64 i)
  auto load = [&](int i) {
    uint64_t* bar = ring.acquire(i, wg::kBoxBytes * (1 + nbox));
    unsigned char* st = smem + (i % S) * C::STAGE;
    wg::tma_load_2d(st, &xmap, bar, i * 64, m0);
    for (int j = 0; j < nbox; ++j)
      wg::tma_load_2d(st + wg::kBoxBytes * (1 + j), &wmap, bar, j * 64, i * 64);
  };
  if (tid == 0) ring.init(C::THREADS / 32);
  for (int c = tid; c < 256 * NWG; c += C::THREADS) {
    const bool in = c < N;
    pb[c] = in ? __bfloat162float(bias[c]) : 0.f;
    pb[256 * NWG + c] = in ? __bfloat162float(gamma[c]) : 0.f;
    pb[512 * NWG + c] = in ? __bfloat162float(beta[c]) : 0.f;
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < S && i < nk; ++i) load(i);

  // warpgroup g owns columns [256 g, 256 g + 256) of the 64-row tile.
  // Thread (warp, lane) holds rows r0 and r0 + 8 of it, and of each
  // 8-column chunk c the columns 8c + cq, 8c + cq + 1: acc[4c + 2 half + e]
  // is row r0 + 8 half, column 256 g + 8c + cq + e. Only wgmma writes acc
  // (the first product overwrites it): other writes to the accumulators
  // make ptxas serialize the wgmma pipeline.
  const int g = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4, cq = (lane % 4) * 2, col0 = g * 256 + cq;
  float acc[128];
  const uint32_t base = wg::smem_u32(smem);
  for (int kt = 0; kt < nk; ++kt) {
    ring.wait_full(kt);
    const uint32_t xs = base + (kt % S) * C::STAGE;
    const uint32_t ws = xs + wg::kBoxBytes * (1 + 4 * g);
    wg::fence_operands(acc);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg::wgmma_m64n256k16<1>(acc, wg::desc_k_major(xs + kk * 32),
                              wg::desc_mn_major(ws + kk * 2048, wg::kBoxBytes),
                              kt > 0 || kk > 0);
    wg::wgmma_commit();
    if (kt > 0) {
      wg::wgmma_wait<1>();  // the previous step's products are done: free, refill
      if (lane == 0) ring.release(kt - 1);
      if (tid == 0 && kt - 1 + S < nk) load(kt - 1 + S);
      __syncwarp();
    }
  }
  wg::wgmma_wait<0>();
  wg::fence_operands(acc);

  // Epilogue. out and h go to this warpgroup's four 64 x 64 boxes of each
  // in the stage memory, laid out as the 128-byte-swizzled TMA boxes (no
  // bank conflicts); one thread a warpgroup stores them by TMA, which clips
  // ragged edges. h = acc + bias goes first, so that its store drains while
  // the LayerNorm and GELU run.
  wg::named_barrier(1, C::THREADS);  // every warpgroup is past its last wgmma
  unsigned char* ostage = smem + g * 4 * wg::kBoxBytes;
  unsigned char* hstage = smem + (NWG + g) * 4 * wg::kBoxBytes;
  // box c / 8, row r0 + 8 half, 16-byte chunk (c % 8) ^ (row % 8), element cq
  auto box_offset = [&](int c, int half) {
    const int r = r0 + 8 * half;
    return (c / 8) * wg::kBoxBytes + r * 128 + (((c % 8) ^ (r % 8)) * 16) + cq * 2;
  };
  auto store_boxes = [&](const CUtensorMap* map, const unsigned char* stage) {
    wg::fence_proxy_async();
    wg::named_barrier(2 + g, 128);
    if (tid % 128 == 0) {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (g * 256 + b * 64 < N)
          wg::tma_store_2d(map, stage + b * wg::kBoxBytes, g * 256 + b * 64, m0);
      wg::tma_store_commit();
    }
  };
  if (save_h) {
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float2 bb = *reinterpret_cast<const float2*>(pb + col0 + c * 8);
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<__nv_bfloat162*>(hstage + box_offset(c, half)) =
            __floats2bfloat162_rn(acc[4 * c + 2 * half] + bb.x, acc[4 * c + 2 * half + 1] + bb.y);
    }
    store_boxes(&hmap, hstage);
  }

  // the row sums of h, across the quad by shuffles and across warpgroups in
  // shared memory: first for the mean, then for the variance (two passes
  // over the registers)
  const float inv_n = 1.f / static_cast<float>(N);
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    const int col = col0 + c * 8;
    if (col < N) {  // N % 8 == 0: col + 1 < N too
      const float2 b = *reinterpret_cast<const float2*>(pb + col);
      s0 += (acc[4 * c] + b.x) + (acc[4 * c + 1] + b.y);
      s1 += (acc[4 * c + 2] + b.x) + (acc[4 * c + 3] + b.y);
    }
  }
  s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
  s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
  s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
  s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
  if (lane % 4 == 0) {
    red[0][g][r0] = s0;
    red[0][g][r0 + 8] = s1;
  }
  wg::named_barrier(1, C::THREADS);
  float mean0 = 0.f, mean1 = 0.f;
#pragma unroll
  for (int j = 0; j < NWG; ++j) {
    mean0 += red[0][j][r0];
    mean1 += red[0][j][r0 + 8];
  }
  mean0 *= inv_n;
  mean1 *= inv_n;
  float q0 = 0.f, q1 = 0.f;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    const int col = col0 + c * 8;
    if (col < N) {
      const float2 bb = *reinterpret_cast<const float2*>(pb + col);
      const float a = acc[4 * c] + bb.x - mean0, b = acc[4 * c + 1] + bb.y - mean0;
      const float d = acc[4 * c + 2] + bb.x - mean1, e = acc[4 * c + 3] + bb.y - mean1;
      q0 += a * a + b * b;
      q1 += d * d + e * e;
    }
  }
  q0 += __shfl_xor_sync(0xffffffffu, q0, 1);
  q0 += __shfl_xor_sync(0xffffffffu, q0, 2);
  q1 += __shfl_xor_sync(0xffffffffu, q1, 1);
  q1 += __shfl_xor_sync(0xffffffffu, q1, 2);
  if (lane % 4 == 0) {
    red[1][g][r0] = q0;
    red[1][g][r0 + 8] = q1;
  }
  wg::named_barrier(1, C::THREADS);
  float var0 = 0.f, var1 = 0.f;
#pragma unroll
  for (int j = 0; j < NWG; ++j) {
    var0 += red[1][j][r0];
    var1 += red[1][j][r0 + 8];
  }
  const float rstd0 = rsqrtf(var0 * inv_n + eps), rstd1 = rsqrtf(var1 * inv_n + eps);

  const bool identity = K == N;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    const int col = col0 + c * 8;
    const float2 bb = *reinterpret_cast<const float2*>(pb + col);
    const float2 gm = *reinterpret_cast<const float2*>(pb + 256 * NWG + col);
    const float2 bt = *reinterpret_cast<const float2*>(pb + 512 * NWG + col);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
      const float mean = half ? mean1 : mean0, rstd = half ? rstd1 : rstd0;
      const float v0 = acc[4 * c + 2 * half] + bb.x, v1 = acc[4 * c + 2 * half + 1] + bb.y;
      float y0 = gelu_erf((v0 - mean) * rstd * gm.x + bt.x);
      float y1 = gelu_erf((v1 - mean) * rstd * gm.y + bt.y);
      if (identity && m0 + r < M && col < N) {  // K == N: x's row has N entries
        const float2 xr = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            x + static_cast<long long>(m0 + r) * K + col));
        y0 += xr.x;
        y1 += xr.y;
      }
      *reinterpret_cast<__nv_bfloat162*>(ostage + box_offset(c, half)) =
          __floats2bfloat162_rn(y0, y1);
    }
  }
  store_boxes(&omap, ostage);
  if (tid % 128 == 0) wg::tma_store_wait_read();  // the stage memory outlives the reads
}

template <int NWG>
int launch_wgmma(const void* x, const void* w, const void* b, const void* g, const void* be,
                 void* out, void* h_out, long long M, long long K, long long N, float eps,
                 cudaStream_t st) {
  using C = WgCfg<NWG>;
  CUtensorMap xm, wm, om, hm;
  int e = wg::encode_rows(&xm, x, M, K);
  if (e == 0) e = wg::encode_rows(&wm, w, K, N);
  if (e == 0) e = wg::encode_rows(&om, out, M, N);
  if (e == 0) e = wg::encode_rows(&hm, h_out != nullptr ? h_out : out, M, N);
  if (e != 0) return e;
  auto kern = fused_linear_wgmma_kernel<NWG>;
  static std::atomic<bool> raised[wg::kMaxDevices];
  if ((e = wg::raise_smem_once(kern, C::SMEM, raised)) != 0) return e;
  const dim3 grid(static_cast<unsigned>((M + 63) / 64));
  kern<<<grid, C::THREADS, C::SMEM, st>>>(
      xm, wm, om, hm, static_cast<const bf16*>(x), static_cast<const bf16*>(b),
      static_cast<const bf16*>(g), static_cast<const bf16*>(be), static_cast<int>(M),
      static_cast<int>(K), static_cast<int>(N), eps, h_out != nullptr);
  return static_cast<int>(cudaGetLastError());
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

// bfloat16 only, every tensor in it; N and K multiples of 8, N <= 768, x,
// W, out and h_out 16-byte aligned (what TMA can describe). h_out: null, or
// [M, N] to receive the pre-LN activation. Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int fused_spectre_linear_wgmma(const void* x, const void* w, const void* b,
                                          const void* gamma, const void* beta, void* out,
                                          void* h_out, long long M, long long K, long long N,
                                          float eps, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 || N % 8 || N > kWgMaxN || M > 0x7fffffffLL ||
      K > 0x7fffffffLL || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 || reinterpret_cast<uintptr_t>(out) % 16 ||
      reinterpret_cast<uintptr_t>(h_out) % 16)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 256) return launch_wgmma<1>(x, w, b, gamma, beta, out, h_out, M, K, N, eps, st);
  if (N <= 512) return launch_wgmma<2>(x, w, b, gamma, beta, out, h_out, M, K, N, eps, st);
  return launch_wgmma<3>(x, w, b, gamma, beta, out, h_out, M, K, N, eps, st);
}


// ------------------------------------------------------------ N > 1,024
//
// fused_spectre_linear_wide_wgmma (bf16 that TMA can describe) and
// fused_spectre_linear_wide_wmma_fma (float32, and bf16 that TMA cannot
// describe): the same function for any N, where a block can no longer hold
// a whole output row, in two passes.
//
// 1. A column-tiled product writes work = x @ W + b, float32 [M, N], a
//    workspace the wrapper allocates for the call. bf16 through TMA: 64 x
//    256 tiles on the wgmma mainloop above (one warpgroup, a ring of 4
//    stages of the x box and four W boxes). Otherwise: 32 x 128 tiles on the
//    mainloop of fused_spectre_linear_kernel (WMMA for bf16, exact float32
//    FMAs for float32), its cp.async double buffer and its padded strides.
// 2. A row kernel, one block a row: the LayerNorm statistics of the float32
//    row (two passes, the mean, then the squared deviations), GELU with
//    erff, the identity residual when K == N, out cast once; with h_out, h
//    is the row cast once to the input dtype.
//
// Where pass 2 reads from: the float32 workspace, not h. The plain version
// (and the TPU kernel) normalise the float32 sums, so the statistics here
// are of the same values; h in bf16 is only the saved copy for the
// backward. A float32 call that saves h passes h itself as the workspace.
// Both passes add in a fixed order (block reductions in warp order), so two
// runs give the same bits. What bounds it: at (4,160 x 1,536)(1,536 x
// 1,536) bf16, 19.6 GFLOP (0.020 ms at 989 TFLOP/s) against 2 M N bytes of
// h and out and the operands (0.011 ms); the workspace adds 8 M N bytes
// (written once, read once from L2 or memory), a price of the design.

namespace {

constexpr int kWideTN = 128;     // tiled product: columns a block
constexpr int kWideStages = 4;   // wgmma product: ring stages
constexpr int kWideStage = wg::kBoxBytes * 5;  // the x box, then four W boxes
constexpr int kWideSmem = kWideStages * kWideStage + 1024;
constexpr int kRowThreads = 256;

// 64 x 256 tile (blockIdx.x: rows, blockIdx.y: columns) of x @ W + b into
// work, float32. The mainloop of fused_linear_wgmma_kernel<1>, its W boxes
// shifted to the tile's columns.
__global__ void __launch_bounds__(128, 1)
wide_product_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                          const __grid_constant__ CUtensorMap wmap,
                          const bf16* __restrict__ bias, float* __restrict__ work, int M, int K,
                          int N) {
  constexpr int S = kWideStages;
  extern __shared__ unsigned char smem_raw[];
  __shared__ wg::Ring<S> ring;
  unsigned char* smem = wg::align1024(smem_raw);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * 64, n0 = blockIdx.y * 256;
  const int nk = (K + 63) / 64;
  const int nbox = min(4, (N - n0 + 63) / 64);
  auto load = [&](int i) {
    uint64_t* bar = ring.acquire(i, wg::kBoxBytes * (1 + nbox));
    unsigned char* st = smem + (i % S) * kWideStage;
    wg::tma_load_2d(st, &xmap, bar, i * 64, m0);
    for (int j = 0; j < nbox; ++j)
      wg::tma_load_2d(st + wg::kBoxBytes * (1 + j), &wmap, bar, n0 + j * 64, i * 64);
  };
  if (tid == 0) ring.init(4);
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < S && i < nk; ++i) load(i);

  // acc[4c + 2 half + e]: row r0 + 8 half, column n0 + 8c + cq + e (the
  // layout of fused_linear_wgmma_kernel). Boxes past N are not loaded:
  // their columns hold stale values and are not stored.
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4, cq = (lane % 4) * 2;
  float acc[128];
  const uint32_t base = wg::smem_u32(smem);
  for (int kt = 0; kt < nk; ++kt) {
    ring.wait_full(kt);
    const uint32_t xs = base + (kt % S) * kWideStage;
    const uint32_t ws = xs + wg::kBoxBytes;
    wg::fence_operands(acc);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg::wgmma_m64n256k16<1>(acc, wg::desc_k_major(xs + kk * 32),
                              wg::desc_mn_major(ws + kk * 2048, wg::kBoxBytes),
                              kt > 0 || kk > 0);
    wg::wgmma_commit();
    if (kt > 0) {
      wg::wgmma_wait<1>();
      if (lane == 0) ring.release(kt - 1);
      if (tid == 0 && kt - 1 + S < nk) load(kt - 1 + S);
      __syncwarp();
    }
  }
  wg::wgmma_wait<0>();
  wg::fence_operands(acc);

#pragma unroll
  for (int c = 0; c < 32; ++c) {
    const int col = n0 + c * 8 + cq;
    if (col < N) {  // N % 8 == 0: col + 1 < N too
      const float b0 = __bfloat162float(bias[col]), b1 = __bfloat162float(bias[col + 1]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + r0 + 8 * half;
        if (r < M)
          *reinterpret_cast<float2*>(work + static_cast<long long>(r) * N + col) =
              make_float2(acc[4 * c + 2 * half] + b0, acc[4 * c + 2 * half + 1] + b1);
      }
    }
  }
}

// kTM x kWideTN tile (blockIdx.x: rows, blockIdx.y: columns) of x @ W + b
// into work, float32: the K loop of fused_spectre_linear_kernel<T, 128>
// with the W tile taken at the block's columns.
template <typename T>
__global__ void __launch_bounds__(Cfg<T>::THREADS)
wide_product_tiled_kernel(const T* __restrict__ x, const T* __restrict__ w,
                          const T* __restrict__ bias, float* __restrict__ work, long long M,
                          int K, int N, int xvec, int wvec) {
  constexpr int NPAD = kWideTN;
  constexpr int TK = Cfg<T>::TK, NT = Cfg<T>::THREADS;
  constexpr int LDX = TK + 16 / sizeof(T), LDW = NPAD + 16 / sizeof(T), LDC = NPAD + 4;
  constexpr int STAGE = kTM * LDX + TK * LDW;
  extern __shared__ __align__(128) unsigned char smem[];
  T* stages = reinterpret_cast<T*>(smem);
  float* cs = reinterpret_cast<float*>(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long m0 = static_cast<long long>(blockIdx.x) * kTM;
  const int n0 = blockIdx.y * NPAD;
  const int nk = (K + TK - 1) / TK;

  auto fetch = [&](int kt) {
    T* xs = stages + (kt & 1) * STAGE;
    load_tile<T, kTM, TK, LDX, NT>(xs, x, K, m0, static_cast<long long>(kt) * TK, M, K, xvec);
    load_tile<T, TK, NPAD, LDW, NT>(xs + kTM * LDX, w, N, static_cast<long long>(kt) * TK, n0,
                                    K, N, wvec);
    cp_async_commit();
  };

  if constexpr (std::is_same<T, bf16>::value) {
    using namespace nvcuda;
    const int wr = warp / 8, wc = warp % 8;  // 16-row group, 16-column group
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
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
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, xs + wr * 16 * LDX + kk, LDX);
        wmma::load_matrix_sync(b, ws + kk * LDW + wc * 16, LDW);
        wmma::mma_sync(acc, a, b, acc);
      }
      __syncthreads();
    }
    wmma::store_matrix_sync(cs + wr * 16 * LDC + wc * 16, acc, LDC, wmma::mem_row_major);
  } else {
    constexpr int CPT = NPAD / 32;
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
  for (int i = threadIdx.x; i < kTM * NPAD; i += NT) {
    const int r = i / NPAD, c = i % NPAD;
    const long long m = m0 + r;
    if (m < M && n0 + c < N) work[m * N + n0 + c] = cs[r * LDC + c] + to_f(bias[n0 + c]);
  }
}

// the sum of v over the block, every thread getting the same bits: warps by
// shuffles, then the warp sums in warp order
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kRowThreads / 32; ++i) s += red[i];
  __syncthreads();  // red is reused by the next call
  return s;
}

// one block a row: LayerNorm of the float32 row of work, GELU, the identity
// residual, out and (with h_out) h in T
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
wide_row_kernel(const float* __restrict__ work, const T* __restrict__ x,
                const T* __restrict__ gamma, const T* __restrict__ beta, T* __restrict__ out,
                T* __restrict__ h_out, int K, int N, float eps) {
  __shared__ float red[kRowThreads / 32];
  const long long m = blockIdx.x;
  const float* row = work + m * N;
  const float inv_n = 1.f / static_cast<float>(N);
  float s = 0.f;
  for (int n = threadIdx.x; n < N; n += kRowThreads) s += row[n];
  const float mean = block_sum(s, red) * inv_n;
  float q = 0.f;
  for (int n = threadIdx.x; n < N; n += kRowThreads) {
    const float d = row[n] - mean;
    q += d * d;
  }
  const float rstd = rsqrtf(block_sum(q, red) * inv_n + eps);
  for (int n = threadIdx.x; n < N; n += kRowThreads) {
    const float v = row[n];
    if (h_out != nullptr) h_out[m * N + n] = from_f<T>(v);
    float y = gelu_erf((v - mean) * rstd * to_f(gamma[n]) + to_f(beta[n]));
    if (K == N) y += to_f(x[m * K + n]);
    out[m * N + n] = from_f<T>(y);
  }
}

template <typename T>
int launch_wide_row(const void* x, const void* g, const void* be, void* out, void* h_out,
                    const float* work, long long M, long long K, long long N, float eps,
                    cudaStream_t st) {
  wide_row_kernel<T><<<static_cast<unsigned>(M), kRowThreads, 0, st>>>(
      work, static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(be),
      static_cast<T*>(out), static_cast<T*>(h_out), static_cast<int>(K), static_cast<int>(N),
      eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_wide_tiled(const void* x, const void* w, const void* b, const void* g,
                      const void* be, void* out, void* h_out, void* work, long long M,
                      long long K, long long N, float eps, cudaStream_t st) {
  constexpr int TK = Cfg<T>::TK;
  constexpr int V = 16 / sizeof(T);
  constexpr int stage_bytes =
      2 * (kTM * (TK + V) + TK * (kWideTN + V)) * static_cast<int>(sizeof(T));
  constexpr int tile_bytes = kTM * (kWideTN + 4) * static_cast<int>(sizeof(float));
  constexpr int smem = stage_bytes > tile_bytes ? stage_bytes : tile_bytes;
  static_assert(smem <= 48 * 1024, "the tiled product needs no raised shared-memory limit");
  const int xvec = (K % V == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const int wvec = (N % V == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  const dim3 grid(static_cast<unsigned>((M + kTM - 1) / kTM),
                  static_cast<unsigned>((N + kWideTN - 1) / kWideTN));
  float* wk = static_cast<float*>(work);
  wide_product_tiled_kernel<T><<<grid, Cfg<T>::THREADS, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b), wk, M,
      static_cast<int>(K), static_cast<int>(N), xvec, wvec);
  const int e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;
  return launch_wide_row<T>(x, g, be, out, h_out, wk, M, K, N, eps, st);
}

}  // namespace

// N > 1,024 (any N >= 1) in two passes through work, float32 [M, N].
// dtype_code: 0 = float32, 1 = bfloat16 (every tensor but work in that
// dtype). h_out: null, or [M, N] to receive the pre-LN activation; a
// float32 caller that wants h passes it as work and h_out null. Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int fused_spectre_linear_wide_wmma_fma(int dtype_code, const void* x, const void* w,
                                                  const void* b, const void* gamma,
                                                  const void* beta, void* out, void* h_out,
                                                  void* work, long long M, long long K,
                                                  long long N, float eps, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K > 0x7fffffffLL || N > 0x7fffffffLL ||
      M > 0x7fffffffLL || (N + kWideTN - 1) / kWideTN > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0)
    return launch_wide_tiled<float>(x, w, b, gamma, beta, out, h_out, work, M, K, N, eps, st);
  if (dtype_code == 1)
    return launch_wide_tiled<bf16>(x, w, b, gamma, beta, out, h_out, work, M, K, N, eps, st);
  return cudaErrorInvalidValue;
}

// bfloat16 only; N and K multiples of 8, x and W 16-byte aligned (what TMA
// can describe); any N. h_out: null, or [M, N]; work: float32 [M, N].
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int fused_spectre_linear_wide_wgmma(const void* x, const void* w, const void* b,
                                               const void* gamma, const void* beta, void* out,
                                               void* h_out, void* work, long long M,
                                               long long K, long long N, float eps,
                                               void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 || N % 8 || M > 0x7fffffffLL || K > 0x7fffffffLL ||
      N > 0x7fffffffLL || (N + 255) / 256 > 65535 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap xm, wm;
  int e = wg::encode_rows(&xm, x, M, K);
  if (e == 0) e = wg::encode_rows(&wm, w, K, N);
  if (e != 0) return e;
  static std::atomic<bool> raised[wg::kMaxDevices];
  if ((e = wg::raise_smem_once(wide_product_wgmma_kernel, kWideSmem, raised)) != 0) return e;
  float* wk = static_cast<float*>(work);
  const dim3 grid(static_cast<unsigned>((M + 63) / 64), static_cast<unsigned>((N + 255) / 256));
  wide_product_wgmma_kernel<<<grid, 128, kWideSmem, st>>>(
      xm, wm, static_cast<const bf16*>(b), wk, static_cast<int>(M), static_cast<int>(K),
      static_cast<int>(N));
  e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;
  return launch_wide_row<bf16>(x, gamma, beta, out, h_out, wk, M, K, N, eps, st);
}
