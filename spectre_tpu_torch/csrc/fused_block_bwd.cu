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
// One thread block owns SB rows (the largest of 64, 32 and 16 that divides
// blk, at most 32 in bf16: a block of the table is also a run of SB-row
// blocks) and a tile of
// batch columns; its K loop walks the heads and, inside each, O in chunks.
// blockIdx.x is the row tile and blockIdx.y the batch tile, so the blocks in
// flight together share one batch tile of dy (17 MB of bf16 at BT=256, which
// stays in the 50 MB L2 beside the 8.4 MB of w). The per-head coordinates
// (start_h, n_h, e0_h) are derived once per thread block from binv.
//
// bf16: tensor cores through WMMA 16x16x16 fragments with f32 accumulators
// that live across all heads; 8 warps, each a 32 x 32 tile (SB = 32). Stages
// of 64 K-values are double-buffered with cp.async; once a stage has landed,
// each thread multiplies the chunks of w it copied itself by their row's
// sign, in shared memory (a product with +-1 is exact), before the block
// synchronises. The f32 tile is parked in shared memory and cast once on the
// way to row-major dxt. A batch tail (B not a multiple of the tile) is
// zero-filled on load and masked on store, so any B >= 1 works.
// f32: plain FMAs on the FP32 pipes (no TF32), so that f32 stays f32.
//
// fused_block_bwd_wgmma: bf16 with blk a multiple of 64, the flagship's
// case, on the Hopper mainloop of wgmma_gemm.cuh (the wrapper,
// ops/kernels/fused_block_bwd.py::block_bwd_kernel, picks it; f32 and the
// bf16 tables with blk of 16 or 32 stay on the kernels above, whose 64-row
// tile would straddle tokens). A block owns the 64 rows of one source block
// (one wgmma M) and 256 batch columns, two warpgroups of 128 columns each;
// its first thread fills a ring of 5 stages by TMA (wgmma_gemm.cuh::Ring):
// per head h and 64-deep chunk of O, w rows [e0_h, e0_h + 64) from a map on
// w [EH, O] and dy[n_h, b0 : b0 + 256, :] from a 3-D map on dy [N, B, O],
// both K-major (O contiguous) boxes with the 128-byte swizzle; a batch tail
// loads as zeros and is masked on store. The signs are per (head, row), so
// the design is the TPU kernel's: each head's product goes into a fresh
// accumulator `part` (wgmma m64n128k16, scale-d = 0 on its first slice),
// then acc += s (.) part in registers, in head order, in f32: exact signs, no
// pass over shared memory and no barrier between the copy and the product
// (signing A in shared memory, as the kernel above does, needs both). The
// price is two accumulator sets (128 registers a thread), so 128 columns a
// warpgroup. The head's last stage drains the warpgroup's wgmma before the
// signed add; the other warpgroup keeps the tensor cores busy meanwhile.
// What bounds it: each 64-row tile reads its heads' dy rows again, 2.2 GB
// from L2 at B = 256 where the bound counts dy once; the kernel reads them
// at about 5.9 TB/s (measured on the H100), and one warpgroup a block (two
// blocks an SM) is no faster.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "wgmma_gemm.cuh"

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

// bf16 on WMMA takes SB = 32 or 16: a table with blk % 64 == 0 goes to the
// wgmma kernel below (and runs here, when asked, as 32-row tiles)
template <int SB>
int launch_bf16(const void* dy, const void* w, const void* s4, const int* binv, void* out,
                const Dims& p, cudaStream_t st) {
  static_assert(SB == 16 || SB == 32, "bf16 WMMA instances: SB of 16 or 32");
  const long long tiles = p.d / SB;
  constexpr int BT = 256, LDK = 64 + 8;
  constexpr int stage_bytes = 2 * (SB + BT) * LDK * static_cast<int>(sizeof(bf16));
  constexpr int tile_bytes = SB * (BT + 4) * static_cast<int>(sizeof(float));
  constexpr int smem = stage_bytes > tile_bytes ? stage_bytes : tile_bytes;
  const long long bt = (p.B + BT - 1) / BT;
  if (tiles > 0x7fffffffLL || bt > 65535) return cudaErrorInvalidValue;
  auto kern = fused_block_bwd_bf16_kernel<SB>;
  static std::atomic<bool> raised[wg::kMaxDevices];
  const int e = wg::raise_smem_once(kern, smem, raised);
  if (e != 0) return e;
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(bt));
  kern<<<grid, kThreads, smem, st>>>(static_cast<const bf16*>(dy), static_cast<const bf16*>(w),
                                     static_cast<const bf16*>(s4), binv,
                                     static_cast<bf16*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

template <int SB>
int launch_f32(const void* dy, const void* w, const void* s4, const int* binv, void* out,
               const Dims& p, cudaStream_t st) {
  const long long tiles = p.d / SB;
  constexpr int BT = 128;
  const long long bt = (p.B + BT - 1) / BT;
  if (tiles > 0x7fffffffLL || bt > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(bt));
  fused_block_bwd_f32_kernel<SB><<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(dy), static_cast<const float*>(w),
      static_cast<const float*>(s4), binv, static_cast<float*>(out), p);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------- wgmma, bf16

// two warpgroups of 128 batch columns a block
struct B8Cfg {
  static constexpr int BT = 256;
  static constexpr int STAGE = wg::kBoxBytes * 5;  // w [64 rows, 64 O], dy [256 b, 64 O]
  static constexpr int STAGES = 5;
  static constexpr int THREADS = 256;
  static constexpr int SMEM = STAGES * STAGE + 1024;
};

__global__ void __launch_bounds__(B8Cfg::THREADS, 1)
fused_block_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                             const __grid_constant__ CUtensorMap dymap,
                             const bf16* __restrict__ s4, const int* __restrict__ binv,
                             bf16* __restrict__ out, Dims p) {
  using C = B8Cfg;
  constexpr int S = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  __shared__ HeadCoords hc;
  __shared__ wg::Ring<S> ring;
  unsigned char* smem = wg::align1024(smem_raw);
  const int tid = threadIdx.x;
  const int b0 = static_cast<int>(blockIdx.y) * C::BT;
  const long long row0 = static_cast<long long>(blockIdx.x) * 64;
  const int nko = (p.O + 63) / 64, steps = p.H * nko;
  // step i = (head h, O chunk o0): w rows [e0_h, e0_h + 64) and dy[n_h, b0 : b0 + BT]
  auto load = [&](int i) {
    const int h = i / nko, o0 = (i % nko) * 64;
    uint64_t* bar = ring.acquire(i, C::STAGE);
    unsigned char* st = smem + (i % S) * C::STAGE;
    wg::tma_load_2d(st, &wmap, bar, o0, hc.e0[h]);
    wg::tma_load_3d(st + wg::kBoxBytes, &dymap, bar, o0, b0, hc.n[h]);
  };
  if (tid == 0) ring.init(C::THREADS / 32);
  head_coords<64>(hc, binv, p);  // ends in __syncthreads
  if (tid == 0)
    for (int i = 0; i < S && i < steps; ++i) load(i);

  // warpgroup g owns batch columns [b0 + 128 g, b0 + 128 g + 128)
  const int g = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4, cq = (lane % 4) * 2;
  auto retire = [&](int i) {  // step i's products are done
    if (lane == 0) ring.release(i);
    if (tid == 0 && i + S < steps) load(i + S);
    __syncwarp();
  };
  float acc[64], part[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] = 0.f;
  const uint32_t base = wg::smem_u32(smem);
  int i = 0;
  for (int h = 0; h < p.H; ++h) {
    for (int oc = 0; oc < nko; ++oc, ++i) {
      ring.wait_full(i);
      const uint32_t as = base + (i % S) * C::STAGE;
      const uint32_t bs = as + wg::kBoxBytes + g * 2 * wg::kBoxBytes;  // 128 rows of 128 B
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wg::wgmma_m64n128k16<0>(part, wg::desc_k_major(as + kk * 32),
                                wg::desc_k_major(bs + kk * 32), oc > 0 || kk > 0);
      wg::wgmma_commit();
      if (oc > 0) {
        wg::wgmma_wait<1>();
        retire(i - 1);
      }
    }
    wg::wgmma_wait<0>();
    wg::fence_operands(part);
    retire(i - 1);  // the head's last step
    const bf16* sg = s4 + hc.start[h];
    const float sg0 = __bfloat162float(sg[r0]), sg1 = __bfloat162float(sg[r0 + 8]);
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      acc[4 * c] += sg0 * part[4 * c];
      acc[4 * c + 1] += sg0 * part[4 * c + 1];
      acc[4 * c + 2] += sg1 * part[4 * c + 2];
      acc[4 * c + 3] += sg1 * part[4 * c + 3];
    }
  }

  // acc[4c + 2 half + e]: row r0 + 8 half, batch column 128 g + 8c + cq + e
  const bool pairs = p.B % 2 == 0;  // then a pair never straddles the end of a row
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    const long long col = b0 + g * 128 + c * 8 + cq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      bf16* o = out + (row0 + r0 + 8 * half) * p.B + col;
      const float v0 = acc[4 * c + 2 * half], v1 = acc[4 * c + 2 * half + 1];
      if (pairs && col < p.B) {
        *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
      } else {
        if (col < p.B) o[0] = __float2bfloat16_rn(v0);
        if (col + 1 < p.B) o[1] = __float2bfloat16_rn(v1);
      }
    }
  }
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
  if (dtype_code == 1)
    return blk % 32 == 0 ? launch_bf16<32>(dy, w, s4, bi, out, p, st)
                         : launch_bf16<16>(dy, w, s4, bi, out, p, st);
  if (blk % 64 == 0) return launch_f32<64>(dy, w, s4, bi, out, p, st);
  if (blk % 32 == 0) return launch_f32<32>(dy, w, s4, bi, out, p, st);
  return launch_f32<16>(dy, w, s4, bi, out, p, st);
}

// bfloat16 only (dy, w, s4 and out); the contract of fused_block_bwd with
// blk % 64 == 0; dy, w and out 16-byte aligned. Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int fused_block_bwd_wgmma(const void* dy, const void* w, const void* s4,
                                     const void* binv, void* out, long long H, long long nb,
                                     long long blk, long long N, long long EH, long long O,
                                     long long B, void* stream) {
  if (H < 1 || H > kMaxH || nb < 1 || blk < 64 || blk % 64 || N < 1 || EH < 1 || EH % blk ||
      O < 8 || O % 8 || B < 1 || N * EH != H * nb * blk || EH > 0x7fffffffLL ||
      O > 0x7fffffffLL || B > 0x7fffffffLL || N > 0x7fffffffLL ||
      (nb * blk) / 64 > 0x7fffffffLL || (B + 255) / 256 > 65535 ||
      reinterpret_cast<uintptr_t>(dy) % 16 || reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return cudaErrorInvalidValue;
  Dims p;
  p.d = nb * blk;
  p.B = B;
  p.H = static_cast<int>(H);
  p.nb = static_cast<int>(nb);
  p.blk = static_cast<int>(blk);
  p.EH = static_cast<int>(EH);
  p.O = static_cast<int>(O);
  CUtensorMap wm, dym;
  int e = wg::encode_rows(&wm, w, EH, O);
  if (e == 0) {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(O), static_cast<cuuint64_t>(B),
                                static_cast<cuuint64_t>(N)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(O) * 2,
                                   static_cast<cuuint64_t>(B) * O * 2};
    const cuuint32_t box[3] = {64, B8Cfg::BT, 1};
    e = wg::encode_bf16(&dym, dy, 3, dims, strides, box);
  }
  if (e != 0) return e;
  using C = B8Cfg;
  static std::atomic<bool> raised[wg::kMaxDevices];
  if ((e = wg::raise_smem_once(fused_block_bwd_wgmma_kernel, C::SMEM, raised)) != 0) return e;
  const dim3 grid(static_cast<unsigned>(p.d / 64), static_cast<unsigned>((B + C::BT - 1) / C::BT));
  fused_block_bwd_wgmma_kernel<<<grid, C::THREADS, C::SMEM, static_cast<cudaStream_t>(stream)>>>(
      wm, dym, static_cast<const bf16*>(s4), static_cast<const int*>(binv),
      static_cast<bf16*>(out), p);
  return static_cast<int>(cudaGetLastError());
}
