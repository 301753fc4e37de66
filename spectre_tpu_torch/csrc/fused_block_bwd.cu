// fused_block_bwd: the backward of the folded permutation mix in one launch,
//
//   dxt[j*blk + t, b] = sum_h s4f[r] * sum_o dy[n_r, b, o] * w[e_r, o]
//   r = h*d + binv[h, j]*blk + t,  n_r = r / EH,  e_r = r % EH
//   dy [N, B, O], w [EH, O], s4 [N, EH] (+-1, s4f its flat view),
//   binv [H, d/blk] int32  ->  dxt [d, B],  with N*EH == H*d.
//
// It is block_gather_sum(s4 * (w @ dy^T)) without the [H*d, B] cotangent in
// device memory. Replaces the TPU kernel spectre_tpu/ops/pallas/
// bwd_gather.py::fused_block_bwd_pallas (its _fused_bwd_kernel).
//
// What bounds it on the H100: 2*d*H*O*B operations against d*B + N*B*O +
// EH*O + N*EH values moved (139.6 GFLOP against 43.5 MB at the flagship
// shape, B=256, bf16), so the tensor cores set the floor, by a factor of ten
// over the memory. The chain it fuses is bound by the bytes of the cotangent
// it writes and reads again.
//
// Design. blk divides EH, so the blk rows of a source block lie in one token
// n_h and are blk consecutive rows of w starting at e0_h. An output tile is
// therefore one product with K = H*O:
//   A'[t, (h, o)] = s4f[start_h + t] * w[e0_h + t, o]   (rows of w, signed)
//   B'[(h, o), b] = dy[n_h, b, o]                       (rows of dy, K-contiguous)
// One thread block owns SB rows (SB = 64, 32 or 16, the largest that divides
// blk: a block of the table is also a run of SB-row blocks) and a tile of
// batch columns; its K loop walks the heads and, inside each, O in chunks.
// blockIdx.x is the row tile and blockIdx.y the batch tile, so the blocks in
// flight together share one batch tile of dy (17 MB of bf16 at BT=256, which
// stays in the 50 MB L2 beside the 8.4 MB of w). The per-head coordinates
// (start_h, n_h, e0_h) are derived once per thread block from binv.
//
// bf16: tensor cores through WMMA 16x16x16 fragments with f32 accumulators
// that live across all heads; 8 warps, each a 32 x 64 tile (SB = 64). Stages
// of 64 K-values are double-buffered with cp.async; once a stage has landed,
// each thread multiplies the chunks of w it copied itself by their row's
// sign, in shared memory (a product with +-1 is exact), before the block
// synchronises. The f32 tile is parked in shared memory and cast once on the
// way to row-major dxt. A batch tail (B not a multiple of the tile) is
// zero-filled on load and masked on store, so any B >= 1 works.
// f32: plain FMAs on the FP32 pipes (no TF32), so that f32 stays f32.
// wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kMaxH = 128;

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

struct Dims {
  long long d, B;
  int H, nb, blk, EH, O;
};

// Per head: the first row of this tile's source block in the flat [H*d]
// stream, its token and its first row of w.
struct HeadCoords {
  long long start[kMaxH];
  int n[kMaxH];
  int e0[kMaxH];
};

template <int SB>
__device__ __forceinline__ void head_coords(HeadCoords& hc, const int* __restrict__ binv,
                                            const Dims& p) {
  const int per = p.blk / SB;  // SB-row tiles in one block of the table
  const long long jb = blockIdx.x / per, sub = blockIdx.x % per;
  for (int h = threadIdx.x; h < p.H; h += kThreads) {
    const long long st = h * p.d + static_cast<long long>(binv[h * static_cast<long long>(p.nb) + jb]) * p.blk + sub * SB;
    hc.start[h] = st;
    hc.n[h] = static_cast<int>(st / p.EH);
    hc.e0[h] = static_cast<int>(st % p.EH);
  }
  __syncthreads();
}

template <int SB>
__global__ void __launch_bounds__(kThreads)
fused_block_bwd_bf16_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ w,
                            const bf16* __restrict__ s4, const int* __restrict__ binv,
                            bf16* __restrict__ out, Dims p) {
  using namespace nvcuda;
  constexpr int BT = 256, KC = 64, CV = KC / 8;
  constexpr int LDK = KC + 8;  // 16 bytes of padding: fragment rows start in different banks
  constexpr int WM = SB >= 32 ? 32 : 16, WR = SB / WM, WC = 8 / WR, WN = BT / WC;
  constexpr int FM = WM / 16, FN = WN / 16;
  constexpr int STAGE = (SB + BT) * LDK;  // elements: A' tile, then B' tile
  constexpr int LDC = BT + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ HeadCoords hc;
  bf16* stages = reinterpret_cast<bf16*>(smem);  // 2 x ([SB][LDK], [BT][LDK])
  float* cs = reinterpret_cast<float*>(smem);    // [SB][LDC], after the K loop
  const int tid = threadIdx.x, warp = tid / 32;
  const long long b0 = static_cast<long long>(blockIdx.y) * BT;
  const long long row0 = static_cast<long long>(blockIdx.x) * SB;
  const int nko = (p.O + KC - 1) / KC;
  const int nstages = p.H * nko;
  head_coords<SB>(hc, binv, p);

  auto fetch = [&](int s) {
    const int h = s / nko, o0 = (s % nko) * KC;
    bf16* as = stages + (s & 1) * STAGE;
    bf16* bs = as + SB * LDK;
    const bf16* wsrc = w + static_cast<long long>(hc.e0[h]) * p.O + o0;
    for (int i = tid; i < SB * CV; i += kThreads) {
      const int r = i / CV, c = (i % CV) * 8;
      const bool ok = o0 + c < p.O;
      cp_async16(as + r * LDK + c, ok ? wsrc + static_cast<long long>(r) * p.O + c : w, ok);
    }
    const bf16* dsrc = dy + (static_cast<long long>(hc.n[h]) * p.B + b0) * p.O + o0;
    for (int i = tid; i < BT * CV; i += kThreads) {
      const int r = i / CV, c = (i % CV) * 8;
      const bool ok = b0 + r < p.B && o0 + c < p.O;
      cp_async16(bs + r * LDK + c, ok ? dsrc + static_cast<long long>(r) * p.O + c : dy, ok);
    }
    cp_async_commit();
  };
  // each thread signs the chunks of w that it copied itself: its own
  // cp.async data is visible to it after the wait, before any barrier
  auto apply_signs = [&](int s) {
    const int h = s / nko;
    bf16* as = stages + (s & 1) * STAGE;
    const bf16* sg = s4 + hc.start[h];
    for (int i = tid; i < SB * CV; i += kThreads) {
      const int r = i / CV, c = (i % CV) * 8;
      const __nv_bfloat162 s2 = __bfloat162bfloat162(sg[r]);
      __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(as + r * LDK + c);
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = __hmul2(v[q], s2);
    }
  };

  const int wr = warp / WC, wc = warp % WC;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  fetch(0);
  for (int s = 0; s < nstages; ++s) {
    if (s + 1 < nstages) {
      fetch(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    apply_signs(s);
    __syncthreads();
    const bf16* as = stages + (s & 1) * STAGE;
    const bf16* bs = as + SB * LDK;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[FM];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], as + (wr * WM + i * 16) * LDK + kk, LDK);
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        // B'[(o), b] = dy[n, b, o]: rows of the stage are batch columns
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, bs + (wc * WN + j * 16) * LDK + kk, LDK);
#pragma unroll
        for (int i = 0; i < FM; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      }
    }
    __syncthreads();  // the next fetch overwrites this stage
  }
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(cs + (wr * WM + i * 16) * LDC + wc * WN + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < SB * BT; i += kThreads) {
    const int r = i / BT, c = i % BT;
    if (b0 + c < p.B) out[(row0 + r) * p.B + b0 + c] = __float2bfloat16_rn(cs[r * LDC + c]);
  }
}

template <int SB>
__global__ void __launch_bounds__(kThreads)
fused_block_bwd_f32_kernel(const float* __restrict__ dy, const float* __restrict__ w,
                           const float* __restrict__ s4, const int* __restrict__ binv,
                           float* __restrict__ out, Dims p) {
  constexpr int BT = 128, KC = 32, RPW = SB / 8, CPT = BT / 32;
  // odd row strides: the transposed store of dy and the column reads are
  // both free of bank conflicts
  __shared__ float as[SB][KC + 1];
  __shared__ float bs[KC][BT + 1];
  __shared__ HeadCoords hc;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long b0 = static_cast<long long>(blockIdx.y) * BT;
  const long long row0 = static_cast<long long>(blockIdx.x) * SB;
  head_coords<SB>(hc, binv, p);
  float acc[RPW][CPT];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  for (int h = 0; h < p.H; ++h) {
    const float* wsrc = w + static_cast<long long>(hc.e0[h]) * p.O;
    const float* sg = s4 + hc.start[h];
    const float* dsrc = dy + (static_cast<long long>(hc.n[h]) * p.B + b0) * p.O;
    for (int o0 = 0; o0 < p.O; o0 += KC) {
      for (int i = tid; i < SB * KC; i += kThreads) {
        const int r = i / KC, k = i % KC;
        as[r][k] = o0 + k < p.O ? sg[r] * wsrc[static_cast<long long>(r) * p.O + o0 + k] : 0.f;
      }
      for (int i = tid; i < BT * KC; i += kThreads) {
        const int c = i / KC, k = i % KC;
        bs[k][c] = (b0 + c < p.B && o0 + k < p.O)
                       ? dsrc[static_cast<long long>(c) * p.O + o0 + k] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < KC; ++k) {
        float a[RPW], bv[CPT];
#pragma unroll
        for (int i = 0; i < RPW; ++i) a[i] = as[warp * RPW + i][k];
#pragma unroll
        for (int j = 0; j < CPT; ++j) bv[j] = bs[k][lane + 32 * j];
#pragma unroll
        for (int i = 0; i < RPW; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const long long c = b0 + lane + 32 * j;
      if (c < p.B) out[(row0 + warp * RPW + i) * p.B + c] = acc[i][j];
    }
}

template <int SB>
int launch(int dtype_code, const void* dy, const void* w, const void* s4, const int* binv,
           void* out, const Dims& p, cudaStream_t st) {
  const long long tiles = p.d / SB;
  if (dtype_code == 1) {
    constexpr int BT = 256, LDK = 64 + 8;
    constexpr int stage_bytes = 2 * (SB + BT) * LDK * static_cast<int>(sizeof(bf16));
    constexpr int tile_bytes = SB * (BT + 4) * static_cast<int>(sizeof(float));
    constexpr int smem = stage_bytes > tile_bytes ? stage_bytes : tile_bytes;
    const long long bt = (p.B + BT - 1) / BT;
    if (tiles > 0x7fffffffLL || bt > 65535) return cudaErrorInvalidValue;
    auto kern = fused_block_bwd_bf16_kernel<SB>;
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(bt));
    kern<<<grid, kThreads, smem, st>>>(static_cast<const bf16*>(dy), static_cast<const bf16*>(w),
                                       static_cast<const bf16*>(s4), binv,
                                       static_cast<bf16*>(out), p);
  } else {
    constexpr int BT = 128;
    const long long bt = (p.B + BT - 1) / BT;
    if (tiles > 0x7fffffffLL || bt > 65535) return cudaErrorInvalidValue;
    const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(bt));
    fused_block_bwd_f32_kernel<SB><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(dy), static_cast<const float*>(w),
        static_cast<const float*>(s4), binv, static_cast<float*>(out), p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16 (dy, w, s4 and out in that dtype).
// Requires blk % 16 == 0, EH % blk == 0, N*EH == H*d with d = nb*blk,
// H <= 128 and, for the 16-byte copies, O % 8 == 0 and 16-byte aligned dy and w.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int fused_block_bwd(int dtype_code, const void* dy, const void* w, const void* s4,
                               const void* binv, void* out, long long H, long long nb,
                               long long blk, long long N, long long EH, long long O,
                               long long B, void* stream) {
  if (H < 1 || H > kMaxH || nb < 1 || blk < 16 || blk % 16 || N < 1 || EH < 1 || EH % blk ||
      O < 8 || O % 8 || B < 1 || N * EH != H * nb * blk || EH > 0x7fffffffLL ||
      O > 0x7fffffffLL || nb > 0x7fffffffLL || (dtype_code != 0 && dtype_code != 1) ||
      reinterpret_cast<uintptr_t>(dy) % 16 || reinterpret_cast<uintptr_t>(w) % 16)
    return cudaErrorInvalidValue;
  Dims p;
  p.d = nb * blk;
  p.B = B;
  p.H = static_cast<int>(H);
  p.nb = static_cast<int>(nb);
  p.blk = static_cast<int>(blk);
  p.EH = static_cast<int>(EH);
  p.O = static_cast<int>(O);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* bi = static_cast<const int*>(binv);
  if (blk % 64 == 0) return launch<64>(dtype_code, dy, w, s4, bi, out, p, st);
  if (blk % 32 == 0) return launch<32>(dtype_code, dy, w, s4, bi, out, p, st);
  return launch<16>(dtype_code, dy, w, s4, bi, out, p, st);
}
