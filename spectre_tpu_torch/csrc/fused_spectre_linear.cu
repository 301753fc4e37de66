// Kernel 2's forward: the SpectreLinear block in one pass,
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
// The statistics are always those of the float32 sums, not of the rounded h.
//
// Three kernels, picked by ops/kernels/fused_linear.py::forward_kernel:
// fused_spectre_linear_wgmma (bf16 that TMA can describe, N <= 768);
// fused_spectre_linear_wide_cluster (the same above N = 768, up to the
// largest cluster the card holds: N = 4,096 on the H100, further down); and
// fused_spectre_linear_cluster, everything else: float32 at any K and N,
// bf16 whose operands TMA cannot describe (the head's N = 100, whose
// 200-byte rows of W break TMA's 16-byte stride rule; K or N not a multiple
// of 8; unaligned pointers) and bf16 beyond the wide cluster's reach.
//
// fused_spectre_linear_cluster. What bounds it: the shapes it takes are
// small in rows (the head: M = 1 .. 1,024 rows, N = 100; float32 sweeps on 8
// rows) or float32 (the FP32 pipes' 67 TFLOP/s). A design that gives a block
// whole output rows launches ceil(M / rows a block) blocks: 8 for the head at
// M = 256, one for 8 rows, which then streams all of W through one SM. So the
// card is filled by splitting each row tile's work across a thread-block
// cluster: the c = cn * ck blocks of a cluster share BM rows; block (jn, jk)
// owns bn columns [jn bn, jn bn + bn) and kc of K [jk kc, jk kc + kc). The
// plan (bm, bn, cn, ck, kc) comes from the caller
// (ops/kernels/fused_linear.py::cluster_plan), so the choice is testable on
// a machine without a card; it fills the card where M, N and K allow.
//
// A block walks its columns in chunks of TN (64 to 256) and, for each
// chunk, its K range in TK-deep stages (32; 16 for float32 at 32 rows)
// through a ring of cp.async stages, as one stream of tiles so the ring
// never drains between chunks. Copies are 16, 8 or 4 bytes wide, as x's and
// W's row strides and pointers allow (the head's W: 8 bytes; N = 10: 4
// bytes); bf16 with an odd stride is copied element by element. Copies past
// M or N are not made (those rows and columns of the products are never
// stored); past K they write zeros. bf16 products run on the tensor cores
// (mma.sync m16n8k16, f32 sums, fed by ldmatrix; .trans for W's [K, N]
// rows); float32 runs exact float32 FMAs on the FP32 pipes (no TF32), each
// thread 8 rows by 2 columns, x kept transposed in shared memory (4-byte
// copies) so that a thread reads its 8 rows as two float4. Each chunk's
// float32 sums are parked in the block's shared memory ([BM, bn], rows
// padded so the fragment stores do not collide in a bank).
//
// Epilogue, on the float32 sums. With a K split, after a cluster.sync()
// block (jn, jk) takes the rows r with r % ck == jk: it adds the ck partial
// sums of its columns in rank order, reading the other blocks' shared
// memory through DSMEM (cluster.map_shared_rank), and adds the bias. Each
// block reduces its rows over its own columns to (mean, M2) by two passes
// over shared memory (the second corrects the first mean by the sum of the
// deviations from it) and pushes them into the shared memory of the cn
// blocks that share the rows. One cluster.sync(); then every block combines
// the cn partials of its rows in rank order by Chan's formula (the count of
// a block is its columns inside N; the divisor is N), normalises its
// columns, applies gamma, beta, erf GELU and the identity residual, and
// writes out (and h) once, lanes along the row. After that barrier no block
// touches another's shared memory, so none waits for the others to leave.
// Without a K split the first barrier is only an arrive at the start and a
// wait before the push (the peers must have started). The fixed orders make
// two runs equal bit for bit.
//
// fused_spectre_linear_wgmma: the same function in bf16 on the Hopper
// mainloop of wgmma_gemm.cuh, which the wrapper picks for every bf16 call
// that TMA can describe (N and K multiples of 8, 16-byte aligned x and W)
// with N <= 768. Why 768: a block owns 64 rows and the whole N so that
// LayerNorm never leaves it, and 64 x N f32 sums in registers take 64 N of
// the SM's 65,536: 49,152 at N = 768, all of them at N = 1,024.
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

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "vec.cuh"
#include "wgmma_gemm.cuh"

namespace {

namespace cg = cooperative_groups;

__device__ __forceinline__ float gelu_erf(float z) {
  return 0.5f * z * (1.f + erff(z * 0.70710678118654752f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ------------------------------------------------------- the cluster kernel

constexpr int kClTK = 32;          // the K split's unit: a multiple of every stage's TK
constexpr int kClMaxCluster = 16;  // blocks a cluster (above 8: non-portable)
constexpr int kClMaxSmem = 232448;  // dynamic shared memory a block may have (227 KB)

// The block shape of an instance: TN columns a chunk, TK of K a stage,
// threads, ring stages, blocks an SM must hold (registers:
// __launch_bounds__); bf16 also its warps' grid (WM x WN warps, each
// (BM / WM) x (TN / WN)). float32 threads own 8 rows and TN / (THREADS /
// (BM / 8)) columns each.
template <typename T, int BM>
struct Cl;
template <>
struct Cl<bf16, 16> {
  static constexpr int TN = 64, TK = 32, THREADS = 128, STAGES = 8, MINB = 3, WM = 1, WN = 4;
};
template <>
struct Cl<bf16, 64> {
  static constexpr int TN = 128, TK = 32, THREADS = 256, STAGES = 4, MINB = 1, WM = 2, WN = 4;
};
template <>
struct Cl<float, 16> {
  static constexpr int TN = 256, TK = 32, THREADS = 256, STAGES = 4, MINB = 1;
};
template <>
struct Cl<float, 32> {
  static constexpr int TN = 128, TK = 16, THREADS = 256, STAGES = 3, MINB = 3;
};

// A stage: the x tile, then the W tile [TK][TN]. bf16 keeps x row-major
// [BM][TK] for ldmatrix; float32 keeps it transposed, [TK][BM], so that a
// thread reads its 8 rows of one k as two float4. Rows are padded by 16
// bytes, so that the 8 rows of an ldmatrix (or the rows of a warp's
// reads and copies) start in different banks.
template <typename T, int BM>
struct ClLayout {
  static constexpr bool XT = std::is_same<T, float>::value;
  static constexpr int PAD = static_cast<int>(16 / sizeof(T)), TK = Cl<T, BM>::TK;
  static constexpr int LDX = XT ? BM + PAD : TK + PAD, LDW = Cl<T, BM>::TN + PAD;
  static constexpr int XTILE = XT ? TK * LDX : BM * LDX;
  static constexpr int STAGE = XTILE + TK * LDW;  // elements
  static constexpr int STAGE_BYTES = STAGE * static_cast<int>(sizeof(T));
};

// The parked sums' row stride for bn columns: bn rounded up to 8 mod 32
// floats, so that the fragment stores of 4 rows fall in different banks.
__host__ __device__ __forceinline__ int cluster_ldp(int bn) { return bn + ((8 - bn % 32) + 32) % 32; }

template <typename T, int BM>
__host__ __device__ __forceinline__ int cluster_smem(int bn, int cn) {
  return Cl<T, BM>::STAGES * ClLayout<T, BM>::STAGE_BYTES + BM * cluster_ldp(bn) * 4 + cn * BM * 8;
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(valid ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src),
                 "n"(BYTES), "r"(valid ? BYTES : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// dst[r * LD + c] = src[r * ld + c] for r < ROWS and c < COLS, src the
// tile's first element, in copies of V elements (cp.async, completion
// awaited by the caller). The host picks V so that ld and the tile's column
// offset and limit are multiples of it and the base is aligned to it: a copy
// is wholly in range (r < rlim, c < clim) or wholly out. Out of range along
// K (the columns if KCOLS, else the rows) the copy writes zeros, so that no
// stale value enters a sum; out of range along M or N it is not made at
// all: those rows and columns of the products are never stored.
template <typename T, int V, int ROWS, int COLS, int LD, int NT, bool KCOLS>
__device__ __forceinline__ void load_tile_v(T* __restrict__ dst, const T* __restrict__ src,
                                            long long ld, int rlim, int clim) {
  constexpr int BYTES = V * sizeof(T);
  constexpr int CV = COLS / V;
#pragma unroll
  for (int i0 = 0; i0 < ROWS * CV; i0 += NT) {
    const int i = i0 + threadIdx.x;
    if (ROWS * CV % NT != 0 && i >= ROWS * CV) break;
    const int r = i / CV, c = (i % CV) * V;
    const bool rin = r < rlim, cin = c < clim;
    if (KCOLS ? !rin : !cin) continue;
    if constexpr (BYTES >= 4) {
      cp_async<BYTES>(dst + r * LD + c, rin && cin ? src + r * ld + c : src, rin && cin);
    } else {  // a 2-byte element (bf16 at an odd stride): cp.async copies 4 bytes or more
      dst[r * LD + c] = rin && cin ? src[r * ld + c] : from_f<T>(0.f);
    }
  }
}

// the tile at (r0, c0) of src, rows below rmax and columns below cmax, with
// V the widest copy the strides allow (v: elements a copy)
template <typename T, int ROWS, int COLS, int LD, int NT, bool KCOLS>
__device__ __forceinline__ void load_tile(T* __restrict__ dst, const T* __restrict__ src,
                                          long long ld, long long r0, long long c0,
                                          long long rmax, long long cmax, int v) {
  constexpr int V16 = static_cast<int>(16 / sizeof(T)), V8 = static_cast<int>(8 / sizeof(T));
  constexpr int V4 = static_cast<int>(4 / sizeof(T));
  const T* tile = src + r0 * ld + c0;
  const int rlim = static_cast<int>(max(min(rmax - r0, static_cast<long long>(ROWS)), 0LL));
  const int clim = static_cast<int>(max(min(cmax - c0, static_cast<long long>(COLS)), 0LL));
  if (v == V16)
    load_tile_v<T, V16, ROWS, COLS, LD, NT, KCOLS>(dst, tile, ld, rlim, clim);
  else if (v == V8)
    load_tile_v<T, V8, ROWS, COLS, LD, NT, KCOLS>(dst, tile, ld, rlim, clim);
  else if (v == V4)
    load_tile_v<T, V4, ROWS, COLS, LD, NT, KCOLS>(dst, tile, ld, rlim, clim);
  else
    load_tile_v<T, 1, ROWS, COLS, LD, NT, KCOLS>(dst, tile, ld, rlim, clim);
}

// dst[c * LD + r] = src[(r0 + r) * ld + c0 + c] (x transposed into shared
// memory, float32) for r < ROWS and c < COLS, a 4-byte cp.async each; zeros
// past K (c0 + c >= cmax), nothing past M. A warp copies 8 consecutive c of
// 4 consecutive rows: 32-byte pieces of global memory, 32 banks of shared.
template <int ROWS, int COLS, int LD, int NT>
__device__ __forceinline__ void load_tile_t(float* __restrict__ dst, const float* __restrict__ src,
                                            long long ld, long long r0, long long c0,
                                            long long rmax, long long cmax) {
  static_assert(COLS % 8 == 0 && ROWS * COLS % NT == 0, "copies go 8 columns at a time");
  const float* tile = src + r0 * ld + c0;
  const int rlim = static_cast<int>(max(min(rmax - r0, static_cast<long long>(ROWS)), 0LL));
  const int clim = static_cast<int>(max(min(cmax - c0, static_cast<long long>(COLS)), 0LL));
#pragma unroll
  for (int i0 = 0; i0 < ROWS * COLS; i0 += NT) {
    const int i = i0 + threadIdx.x;
    const int rest = i / 8, r = rest % ROWS, c = (rest / ROWS) * 8 + i % 8;
    if (r >= rlim) continue;
    cp_async<4>(dst + c * LD + r, c < clim ? tile + r * ld + c : tile, c < clim);
  }
}

// four 8x8 bf16 matrices; lanes 8m .. 8m + 7 give the row addresses of matrix m
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(wg::smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(wg::smem_u32(p))
               : "memory");
}
// c[16x8] += a[16x16] b[16x8], bf16 operands, f32 sums. Lane l = 4 g + t holds
// c[0..1] at (row g, cols 2t, 2t + 1) and c[2..3] at row g + 8.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The products of one block: its columns in chunks of TN, each chunk's K
// range in stages, the float32 sums of each chunk parked at P[r * ldp + c]
// (c < bn: the block's own columns). tile t of the stream is chunk t / nk,
// stage t % nk.
template <typename T, int BM>
__device__ __forceinline__ void cluster_products(const T* __restrict__ x, const T* __restrict__ w,
                                                 T* stages, float* P, int ldp, long long M,
                                                 int K, int N, long long m0, int n0, int ncols,
                                                 int bn, int k0, int kend, int vx, int vw) {
  using C = Cl<T, BM>;
  using L = ClLayout<T, BM>;
  constexpr int TK = C::TK, TN = C::TN, NT = C::THREADS, S = C::STAGES;
  constexpr int LDX = L::LDX, LDW = L::LDW;
  const int nk = (kend - k0 + TK - 1) / TK, nch = (ncols + TN - 1) / TN, total = nk * nch;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  auto fetch = [&](int t) {
    T* xs = stages + (t % S) * L::STAGE;
    const int ch = t / nk, k = k0 + (t % nk) * TK;
    if constexpr (L::XT)
      load_tile_t<BM, TK, LDX, NT>(xs, x, K, m0, k, M, kend);
    else
      load_tile<T, BM, TK, LDX, NT, true>(xs, x, K, m0, k, M, kend, vx);
    load_tile<T, TK, TN, LDW, NT, false>(xs + L::XTILE, w, N, k, n0 + ch * TN, kend, n0 + ncols,
                                         vw);
  };

  if constexpr (std::is_same<T, bf16>::value) {
    constexpr int WN = C::WN;
    constexpr int MI = BM / C::WM / 16, NI = TN / WN / 8;  // m16 and n8 tiles a warp
    static_assert(NI % 2 == 0, "B fragments come in pairs of n8 tiles");
    const int wm = warp / WN, wn = warp % WN;
    float acc[MI][NI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll 1
    for (int s = 0; s < S - 1; ++s) {
      if (s < total) fetch(s);
      cp_async_commit();
    }
    for (int t = 0; t < total; ++t) {
      cp_async_wait<S - 2>();
      __syncthreads();  // tile t is in; every warp is done with tile t - 1
      if (t + S - 1 < total) fetch(t + S - 1);
      cp_async_commit();
      const bf16* xs = stages + (t % S) * L::STAGE;
      const bf16* ws = xs + L::XTILE;
#pragma unroll
      for (int kk = 0; kk < TK; kk += 16) {
        uint32_t a[MI][4];
#pragma unroll
        for (int i = 0; i < MI; ++i)
          ldsm_x4(a[i], xs + (wm * MI * 16 + i * 16 + (lane & 15)) * LDX + kk + (lane >> 4) * 8);
#pragma unroll
        for (int p = 0; p < NI / 2; ++p) {
          uint32_t b[4];
          ldsm_x4_trans(b, ws + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LDW + wn * NI * 8 +
                               p * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            mma16816(acc[i][2 * p], a[i], b[0], b[1]);
            mma16816(acc[i][2 * p + 1], a[i], b[2], b[3]);
          }
        }
      }
      if (t % nk == nk - 1) {  // the chunk's sums are complete: park them
        const int cb = (t / nk) * TN;
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NI; ++j) {
            const int r = wm * MI * 16 + i * 16 + lane / 4;
            const int c = cb + wn * NI * 8 + j * 8 + (lane % 4) * 2;
            if (c < bn) {
              *reinterpret_cast<float2*>(P + r * ldp + c) = make_float2(acc[i][j][0], acc[i][j][1]);
              *reinterpret_cast<float2*>(P + (r + 8) * ldp + c) =
                  make_float2(acc[i][j][2], acc[i][j][3]);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
          }
      }
    }
  } else {
    // thread (ty, tx): rows 8 ty + i of the tile; columns 2 tx + j of a chunk
    // (CPT = 2), or g TN / G + 4 tx + e for G = CPT / 4 float4 groups
    constexpr int TX = NT / (BM / 8), CPT = TN / TX, G = CPT < 4 ? 1 : CPT / 4;
    static_assert(CPT == 2 || CPT % 4 == 0, "a thread's columns: a float2 or float4 groups");
    const int ty = tid / TX, tx = tid % TX;
    auto col = [&](int j) { return CPT == 2 ? 2 * tx + j : (j / 4) * (TN / G) + 4 * tx + j % 4; };
    float acc[8][CPT];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
#pragma unroll 1
    for (int s = 0; s < S - 1; ++s) {
      if (s < total) fetch(s);
      cp_async_commit();
    }
    for (int t = 0; t < total; ++t) {
      cp_async_wait<S - 2>();
      __syncthreads();
      if (t + S - 1 < total) fetch(t + S - 1);
      cp_async_commit();
      const float* xs = stages + (t % S) * L::STAGE;
      const float* ws = xs + L::XTILE;
#pragma unroll 4
      for (int k = 0; k < TK; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(xs + k * LDX + 8 * ty);
        const float4 a1 = *reinterpret_cast<const float4*>(xs + k * LDX + 8 * ty + 4);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        float b[CPT];
        if constexpr (CPT == 2) {
          const float2 v = *reinterpret_cast<const float2*>(ws + k * LDW + 2 * tx);
          b[0] = v.x;
          b[1] = v.y;
        } else {
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float4 v = *reinterpret_cast<const float4*>(ws + k * LDW + g * (TN / G) + 4 * tx);
            b[4 * g] = v.x;
            b[4 * g + 1] = v.y;
            b[4 * g + 2] = v.z;
            b[4 * g + 3] = v.w;
          }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      if (t % nk == nk - 1) {  // the chunk's sums are complete: park them
        const int cb = (t / nk) * TN;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float* row = P + (8 * ty + i) * ldp + cb;
          if constexpr (CPT == 2) {
            if (cb + col(0) < bn)
              *reinterpret_cast<float2*>(row + col(0)) = make_float2(acc[i][0], acc[i][1]);
          } else {
#pragma unroll
            for (int g = 0; g < G; ++g)
              if (cb + col(4 * g) < bn)
                *reinterpret_cast<float4*>(row + col(4 * g)) =
                    make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                                acc[i][4 * g + 3]);
          }
#pragma unroll
          for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
        }
      }
    }
  }
  cp_async_wait<0>();  // only empty groups are left; nothing may be pending at exit
}

template <typename T, int BM>
__global__ void __launch_bounds__(Cl<T, BM>::THREADS, Cl<T, BM>::MINB)
fused_linear_cluster_kernel(const T* __restrict__ x, const T* __restrict__ w,
                            const T* __restrict__ bias, const T* __restrict__ gamma,
                            const T* __restrict__ beta, T* __restrict__ out,
                            T* __restrict__ h_out, float2* __restrict__ stats_out, long long M,
                            int K, int N, int bn, int cn, int ck, int kc, float eps, int vx,
                            int vw) {
  constexpr int NT = Cl<T, BM>::THREADS, NWARPS = NT / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int ldp = cluster_ldp(bn);
  T* stages = reinterpret_cast<T*>(smem);
  float* P = reinterpret_cast<float*>(smem + Cl<T, BM>::STAGES * ClLayout<T, BM>::STAGE_BYTES);
  // [cn][BM]: (mean, M2) of each column block's columns, pushed by every
  // block of the row group into the shared memory of all of them
  float2* stats = reinterpret_cast<float2*>(P + BM * ldp);

  const bool solo = cn * ck == 1;
  const int rank = solo ? 0 : static_cast<int>(cluster.block_rank());
  const int jn = rank % cn, jk = rank / cn;
  const long long m0 = static_cast<long long>(blockIdx.x / (cn * ck)) * BM;
  const int n0 = jn * bn, ncols = min(bn, N - n0);
  const int k0 = jk * kc, kend = min(K, k0 + kc);
  // Without a K split a block reads only its own sums, and the first touch
  // of another block's shared memory (step 1's push) only needs every
  // block to have started: arrive now, wait before the push. A cluster of
  // one block (launched as a plain grid) needs no cluster barrier at all.
  if (ck == 1 && !solo) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  cluster_products<T, BM>(x, w, stages, P, ldp, M, K, N, m0, n0, ncols, bn, k0, kend, vx, vw);
  if (ck > 1) {
    cluster.sync();  // every block's partial sums are parked
  } else {
    if (!solo) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    __syncthreads();
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // 1. this block's rows (r % ck == jk), its columns: the K split's partial
  // sums in rank order, + bias, back into P; (mean, M2) over the columns,
  // pushed to the cn blocks that share the rows
  for (int r = jk + warp * ck; r < BM; r += NWARPS * ck) {
    float* row = P + r * ldp;
    float s = 0.f;
    for (int c = lane; c < ncols; c += 32) {
      float v;
      if (ck == 1) {
        v = row[c];
      } else {
        v = 0.f;
        for (int q = 0; q < ck; ++q) v += cluster.map_shared_rank(row, jn + q * cn)[c];
      }
      v += to_f(bias[n0 + c]);
      row[c] = v;
      s += v;
    }
    // the second pass also sums the deviations from the first mean, which
    // corrects it (and M2) for the first sum's rounding: the blocks' means
    // enter Chan's combine through their differences
    const float nb = static_cast<float>(ncols), mean1 = warp_sum(s) / nb;
    float dsum = 0.f, q2 = 0.f;
    for (int c = lane; c < ncols; c += 32) {
      const float d = row[c] - mean1;
      dsum += d;
      q2 += d * d;
    }
    dsum = warp_sum(dsum);
    q2 = warp_sum(q2);
    const float2 st = make_float2(mean1 + dsum / nb, q2 - dsum * dsum / nb);
    if (solo && lane == 0)
      stats[r] = st;
    else if (!solo && lane < cn)
      *cluster.map_shared_rank(stats + jn * BM + r, lane + jk * cn) = st;
  }
  // every (mean, M2) is in; after this no block touches another's shared
  // memory, so none has to wait for the others before it leaves
  if (solo)
    __syncthreads();
  else
    cluster.sync();

  // 2. the row statistics over N: the cn column blocks' partials in rank
  // order (Chan), then LayerNorm, GELU, the identity residual; out and h
  const float inv_n = 1.f / static_cast<float>(N);
  for (int r = jk + warp * ck; r < BM; r += NWARPS * ck) {
    const long long m = m0 + r;
    if (m >= M) break;  // warp-uniform; the rows go up
    float na = 0.f, mean = 0.f, m2 = 0.f;
    for (int j = 0; j < cn; ++j) {
      const float2 st = stats[j * BM + r];
      const float nb = static_cast<float>(min(bn, N - j * bn));
      if (j == 0) {
        na = nb;
        mean = st.x;
        m2 = st.y;
      } else {
        const float n = na + nb, d = st.x - mean;
        mean += d * (nb / n);
        m2 += st.y + d * d * (na * nb / n);
        na = n;
      }
    }
    const float* row = P + r * ldp;
    if (stats_out != nullptr) {  // a column shard's forward: h and (mean, M2), no epilogue
      if (jn == 0 && lane == 0) stats_out[m] = make_float2(mean, m2);
      for (int c = lane; c < ncols; c += 32) h_out[m * N + n0 + c] = from_f<T>(row[c]);
      continue;
    }
    const float rstd = rsqrtf(m2 * inv_n + eps);
    for (int c = lane; c < ncols; c += 32) {
      const int n = n0 + c;
      const float v = row[c];
      if (h_out != nullptr) h_out[m * N + n] = from_f<T>(v);
      float y = gelu_erf((v - mean) * rstd * to_f(gamma[n]) + to_f(beta[n]));
      if (K == N) y += to_f(x[m * K + n]);
      out[m * N + n] = from_f<T>(y);
    }
  }
}

// the widest copy (elements) that a row stride of ld elements and a base
// pointer allow: 16, 8 or 4 bytes, else one element
template <typename T>
int copy_width(long long ld, const void* p) {
  for (int bytes = 16; bytes >= 4; bytes /= 2) {
    const int v = bytes / static_cast<int>(sizeof(T));
    if (v >= 1 && ld % v == 0 && reinterpret_cast<uintptr_t>(p) % bytes == 0) return v;
  }
  return 1;
}

template <typename T, int BM>
int launch_cluster(const void* x, const void* w, const void* b, const void* g, const void* be,
                   void* out, void* h_out, float2* stats_out, long long M, long long K,
                   long long N, int bn, int cn, int ck, int kc, float eps, cudaStream_t st) {
  const int c = cn * ck;
  const long long tiles = (M + BM - 1) / BM;
  const int smem = cluster_smem<T, BM>(bn, cn);
  if (tiles * c > 0x7fffffffLL || smem > kClMaxSmem) return cudaErrorInvalidValue;
  auto kern = fused_linear_cluster_kernel<T, BM>;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= wg::kMaxDevices) return cudaErrorInvalidDevice;
  // once a device: the shared-memory cap raised to the most a plan may ask,
  // and clusters above 8 blocks allowed
  static std::atomic<bool> prepared[wg::kMaxDevices];
  if (!prepared[dev].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kClMaxSmem);
    if (e == cudaSuccess) e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
    prepared[dev].store(true, std::memory_order_release);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles * c));
  cfg.blockDim = dim3(Cl<T, BM>::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = c > 1;  // one block: a plain grid
  // a cluster that cannot be resident is refused here, not left to hang or
  // to fail quietly: the largest shared memory checked so far a cluster size
  static std::atomic<int> checked[wg::kMaxDevices][kClMaxCluster + 1];
  if (c > 1 && smem > checked[dev][c].load(std::memory_order_acquire)) {
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (clusters == 0) return cudaErrorInvalidConfiguration;
    checked[dev][c].store(smem, std::memory_order_release);
  }
  const int vx = copy_width<T>(K, x), vw = copy_width<T>(N, w);
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(x), static_cast<const T*>(w),
                         static_cast<const T*>(b), static_cast<const T*>(g),
                         static_cast<const T*>(be), static_cast<T*>(out), static_cast<T*>(h_out),
                         stats_out, M, static_cast<int>(K), static_cast<int>(N), bn, cn, ck, kc,
                         eps, vx, vw);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
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
                          const bf16* __restrict__ beta, float2* __restrict__ stats_out, int M,
                          int K, int N, float eps, int save_h) {
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
  // A column shard's forward (h and (mean, M2), no epilogue) took this mode
  // until it got its own kernel (shard_stats_wgmma_kernel below); nothing
  // passes stats_out now. The branch stays: without it ptxas spills more of
  // the 3-warpgroup instance's registers, and the flagship's linear1
  // forward with h ran 2% slower on the H100 (PERF.md).
  if (stats_out != nullptr) {
    if (g == 0 && lane % 4 == 0) {
      if (m0 + r0 < M) stats_out[m0 + r0] = make_float2(mean0, var0);
      if (m0 + r0 + 8 < M) stats_out[m0 + r0 + 8] = make_float2(mean1, var1);
    }
    if (tid % 128 == 0) wg::tma_store_wait_read();  // the stage memory outlives the reads
    return;
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
                 void* out, void* h_out, float2* stats_out, long long M, long long K, long long N,
                 float eps, cudaStream_t st) {
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
      static_cast<const bf16*>(g), static_cast<const bf16*>(be), stats_out, static_cast<int>(M),
      static_cast<int>(K), static_cast<int>(N), eps, h_out != nullptr);
  return static_cast<int>(cudaGetLastError());
}

// The cluster kernel on a checked plan; with stats_out, the column shard's
// forward (h_out and each row's (mean, M2) over the N columns given, no
// LayerNorm, GELU or out).
int cluster_entry(int dtype_code, const void* x, const void* w, const void* b, const void* gamma,
                  const void* beta, void* out, void* h_out, float2* stats_out, long long M,
                  long long K, long long N, int bm, int bn, int cn, int ck, int kc, float eps,
                  void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K > 0x7fffffffLL || N > 0x7fffffffLL || cn < 1 || ck < 1 ||
      cn * ck > kClMaxCluster || bn < 8 || bn % 8 || kc < kClTK || kc % kClTK ||
      static_cast<long long>(cn) * bn < N || static_cast<long long>(cn - 1) * bn >= N ||
      static_cast<long long>(ck) * kc < K || static_cast<long long>(ck - 1) * kc >= K ||
      (stats_out != nullptr && h_out == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SPECTRE_CLUSTER(T, BM)                                                                  \
  return launch_cluster<T, BM>(x, w, b, gamma, beta, out, h_out, stats_out, M, K, N, bn, cn, ck, \
                               kc, eps, st);
  if (dtype_code == 0 && bm == 16) SPECTRE_CLUSTER(float, 16)
  if (dtype_code == 0 && bm == 32) SPECTRE_CLUSTER(float, 32)
  if (dtype_code == 1 && bm == 16) SPECTRE_CLUSTER(bf16, 16)
  if (dtype_code == 1 && bm == 64) SPECTRE_CLUSTER(bf16, 64)
#undef SPECTRE_CLUSTER
  return cudaErrorInvalidValue;
}

// The wgmma kernel on checked operands; stats_out as for cluster_entry.
int wgmma_entry(const void* x, const void* w, const void* b, const void* gamma, const void* beta,
                void* out, void* h_out, float2* stats_out, long long M, long long K, long long N,
                float eps, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 || N % 8 || N > kWgMaxN || M > 0x7fffffffLL ||
      K > 0x7fffffffLL || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 || reinterpret_cast<uintptr_t>(out) % 16 ||
      reinterpret_cast<uintptr_t>(h_out) % 16 || (stats_out != nullptr && h_out == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 256) return launch_wgmma<1>(x, w, b, gamma, beta, out, h_out, stats_out, M, K, N, eps, st);
  if (N <= 512) return launch_wgmma<2>(x, w, b, gamma, beta, out, h_out, stats_out, M, K, N, eps, st);
  return launch_wgmma<3>(x, w, b, gamma, beta, out, h_out, stats_out, M, K, N, eps, st);
}

// ------------------------------------------ the product of a split layer
//
// shard_stats_wgmma_kernel (kernel B3's entry 1 under tensor parallelism,
// bf16): h = x @ W + b [M, n] for this rank's n columns of a SpectreLinear
// split by columns, rounded once to bf16, and each row's (mean, M2) over
// those n columns of the float32 sums: the product and the row statistics
// of the TPU kernel spectre_tpu/ops/pallas/fused_linear.py::_kernel (:56-77,
// call :94). float32, and shards that TMA cannot describe, take the cluster
// kernel's statistics mode (cluster_entry).
//
// What bounds it on the H100: bytes, x read and h written once (0.0091 ms
// at (16,640 x 512)(512 x 384)), with the products at 73% of that. What held
// the first version (an epilogue mode of fused_linear_wgmma_kernel) at 37%
// of it: (1) every 64-row tile read all of W from L2 into shared memory, 6
// KB a row of output at n = 384 (116 MB in all); (2) its m64n256k16
// products ran 512 columns for n = 384, a quarter of them past n; (3) one
// block an SM and no overlap of a tile's epilogue with the next tile's
// loads; (4) the consumers refilled the ring themselves after their own
// wgmma wait, two steps ahead at most.
//
// Design (the plan: ops/kernels/fused_linear.py::shard_stats_plan).
// (1) A row tile is 128 rows: two consumer warpgroups of 64 rows read the
// same W boxes of a stage, which halves W's L2 reads a row (3 KB at n =
// 384). (2) A row tile's n columns are cut into column tiles of 64, 128 or
// 192 up to n's last multiple of 64, and the rest (8 to 56 columns) into a
// tile of its own; a warpgroup's products on one are an
// m64n{64,128,192}k16 or an m64n{8..56}k16, so no product runs past n; 96
// float32 sums a thread. The column tiles of a row tile run one after
// another in the block (x read again from L2 for each: 2 KB a row at n =
// 384), and each row's (mean, M2) over a column tile is merged into the
// row's running pair in registers by Chan's formula, in column order.
// (3) A persistent grid (one block an SM at most) walks the row tiles; h
// leaves each warpgroup's staging area by TMA store, drained under the
// next tile's products and waited for only before the next epilogue writes
// there. (4) One producer warp keeps a ring of 4 stages (a 128 x 64 box of
// x and up to three 64 x 64 boxes of W, 40 KB) full by TMA across tiles, so
// the next tile's loads run under an epilogue; the consumers only wait on
// full barriers and release empty ones (one arrival a warp, once its
// warpgroup's wgmma on the stage is done). 96 sums a consumer thread and
// 288 threads keep within the launch bound's registers.
//
// Measured on the H100 (clock64 stamps of each phase; PERF.md):
// what decides its time is not the bytes from L2 but the code around the
// wgmma. A width chosen at run time between the products, or roles chosen
// on threadIdx, made ptxas fence or serialise the wgmma (C7519, C7520), so
// the roles go by a shuffled warp index and each width is its own template
// (shard_stats_column: 10 widths for the products; the epilogue's
// arithmetic fixed at compile time for the multiples of 64). The epilogue
// runs with the tensor cores idle, so it is one pass over the sums (h and
// both statistics), with stmatrix into the staging area. Not kept: an L2 prefetch of the
// next row tile's x (slower at B = 1,024: the row tiles' second halves
// then wait on HBM too), and a cluster of two blocks on two row tiles,
// each loading half of a step's W boxes by multicast into both (W's L2
// bytes a row halved again, but every stage then waits for both blocks:
// slower at every shape).
//
// Statistics of a column tile of w columns, for each of a thread's two
// rows, in one pass: k = the row's value at the tile's first column (lane
// cq = 0 of the quad holds it, shuffled to the others); over the thread's
// 8-column chunks in column order, with v = acc + bias and d = v - k, s1 +=
// d0 + d1 and s2 += d0^2 + d1^2; across the quad by shuffles (xor 1, then
// xor 2); the tile's mean = k + s1 / w and M2 = s2 - s1^2 / w; then Chan's
// merge with the column tiles before it. The fixed orders make two runs
// equal bit for bit.

constexpr int kSsRows = 128;                                    // a row tile
constexpr int kSsMaxTile = 192;                                 // a column tile's columns at most
constexpr int kSsBoxes = kSsMaxTile / 64;                       // W boxes a stage at most
constexpr int kSsStages = 4;
constexpr int kSsXBytes = kSsRows * 128;                        // a stage's x box, 128 x 64
constexpr int kSsStage = kSsXBytes + kSsBoxes * wg::kBoxBytes;  // 40 KB
constexpr int kSsStaging = 2 * kSsBoxes * wg::kBoxBytes;        // h of a column tile
constexpr int kSsThreads = 2 * 128 + 32;  // two consumer warpgroups and the producer warp
// the bias in float32, zero past N up to a column tile past kWgMaxN
constexpr int kSsBias = kWgMaxN + kSsMaxTile;
constexpr int kSsSmem = kSsStages * kSsStage + kSsStaging + kSsBias * 4 + 1024;

// L of the sums from float `off` on, as the array one wgmma writes
#define SS_ACC(L, off) (*reinterpret_cast<float(*)[L]>(acc + (off)))

// A warpgroup's products on one column tile of W columns (64, 128 or 192,
// or a remainder of 8 to 56 in a box of its own), steps i to i + nk - 1 of
// the ring: one m64nWk16 a 16-deep slice into acc[0, W / 2). Each stage is
// released once the warpgroup's products on it are done. A width known at
// compile time keeps every wgmma off a branch, which ptxas would otherwise
// fence.
template <int W>
__device__ __forceinline__ void shard_stats_tile(float (&acc)[96], wg::Ring<kSsStages>& ring,
                                                 uint32_t base, int g, int lane, int nk,
                                                 int i) {
  for (int kt = 0; kt < nk; ++kt) {
    ring.wait_full(i + kt);
    const uint32_t st = base + ((i + kt) % kSsStages) * kSsStage;
    wg::fence_operands(acc);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg::wgmma_mn<W>(SS_ACC(W / 2, 0), wg::desc_k_major(st + g * (kSsXBytes / 2) + kk * 32),
                      wg::desc_mn_major(st + kSsXBytes + kk * 2048, wg::kBoxBytes),
                      kt > 0 || kk > 0);
    wg::wgmma_commit();
    if (kt > 0) {
      wg::wgmma_wait<1>();  // the previous step's products are done: free its stage
      if (lane == 0) ring.release(i + kt - 1);
      __syncwarp();
    }
  }
  wg::wgmma_wait<0>();
  wg::fence_operands(acc);
  if (lane == 0) ring.release(i + nk - 1);
  __syncwarp();
}

// The width of the column tile from n0 of a row tile's N columns: tiles of
// tile_n (a multiple of 64) up to N's last multiple of 64, then the rest
__device__ __forceinline__ int ss_width(int n0, int N, int tile_n) {
  const int n64 = N & ~63;
  return n0 < n64 ? min(tile_n, n64 - n0) : N - n0;
}

// A consumer thread's place in the kernel and its rows' running statistics
struct SsThread {
  wg::Ring<kSsStages>* ring;
  const float* pb;     // the bias in float32
  unsigned char* hst;  // the warpgroup's staging area for h
  const CUtensorMap* hmap;
  uint32_t base;  // the ring's stages
  int g, lane, tid, r0, cq, nk, M;
  float na, mean[2], m2[2];  // the column tiles so far: count, rows r0 and r0 + 8
};

// The epilogue of a warpgroup's column tile of w columns from n0, rows from
// m0; W: w where it is known at compile time (a multiple of 64), else 0 (a
// remainder of 8 to 56 columns, in the first 8 chunks). h = acc + bias,
// rounded once, into the staging area in the 128-byte swizzled box layout
// (once the last column tile's store has read it; by stmatrix for a width
// known at compile time, two chunks of both rows an instruction), then
// stored by TMA. The tile's (mean, M2) of each row in the same pass, on
// values shifted by the row's first value of the tile (k, from chunk 0,
// which every tile's product writes): the sums of d = v - k and of d^2,
// mean = k + sum(d) / w and M2 = sum(d^2) - sum(d)^2 / w, then merged into
// the row's running pair. A remainder's chunks past w (no product wrote
// their sums) run the same arithmetic, kept out of the sums and not
// stored, so that no branch holds the bias loads back.
template <int W>
__device__ __forceinline__ void shard_stats_epilogue(const float (&acc)[96], SsThread& th, int n0,
                                                     int m0, int w_rt) {
  constexpr int kChunks = W > 0 ? W / 8 : 8;
  const int w = W > 0 ? W : w_rt;
  if (th.tid % 128 == 0) wg::tma_store_wait_read();
  wg::named_barrier(1 + th.g, 128);
  const float b0 = th.pb[n0];
  float k[2], s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
  for (int half = 0; half < 2; ++half)  // column n0 is chunk 0 of lane cq = 0
    k[half] = __shfl_sync(0xffffffffu, acc[2 * half] + b0, th.lane & ~3);
  // stmatrix: lane t gives the address of row t % 8 of matrix t / 8, which
  // is chunk 2p + t / 16 of row half (t / 8) % 2
  const int t = th.lane;
  const uint32_t row_addr =
      wg::smem_u32(th.hst) + (th.r0 - t / 4 + 8 * ((t / 8) % 2) + t % 8) * 128;
  uint32_t pk[4];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int col = 8 * c + th.cq;
    const bool valid = W > 0 || 8 * c < w;
    const float2 bb = *reinterpret_cast<const float2*>(th.pb + n0 + col);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = th.r0 + 8 * half;
      const float v0 = acc[4 * c + 2 * half] + bb.x, v1 = acc[4 * c + 2 * half + 1] + bb.y;
      const float d0 = v0 - k[half], d1 = v1 - k[half];
      s1[half] += valid ? d0 + d1 : 0.f;
      s2[half] += valid ? d0 * d0 + d1 * d1 : 0.f;
      const __nv_bfloat162 hv = __floats2bfloat162_rn(v0, v1);
      if constexpr (W > 0) {
        pk[2 * (c % 2) + half] = *reinterpret_cast<const uint32_t*>(&hv);
      } else if (valid) {
        *reinterpret_cast<__nv_bfloat162*>(th.hst + r * 128 + (((col / 8) ^ (r % 8)) * 16) +
                                           th.cq * 2) = hv;
      }
    }
    if constexpr (W > 0) {
      if (c % 2 == 1) {
        const int chunk = (c - 1) % 8 + t / 16;
        wg::stmatrix_x4(row_addr + (c / 8) * wg::kBoxBytes + ((chunk ^ (t % 8)) * 16), pk);
      }
    }
  }
  wg::fence_proxy_async();
  wg::named_barrier(1 + th.g, 128);
  if (th.tid % 128 == 0 && m0 < th.M) {  // TMA clips the rows past M and the columns past n
    for (int b = 0; b * 64 < w; ++b)
      wg::tma_store_2d(th.hmap, th.hst + b * wg::kBoxBytes, n0 + 64 * b, m0);
    wg::tma_store_commit();
  }

  const float nb = static_cast<float>(w);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    s1[half] += __shfl_xor_sync(0xffffffffu, s1[half], 1);
    s1[half] += __shfl_xor_sync(0xffffffffu, s1[half], 2);
    s2[half] += __shfl_xor_sync(0xffffffffu, s2[half], 1);
    s2[half] += __shfl_xor_sync(0xffffffffu, s2[half], 2);
    const float tm = k[half] + s1[half] / nb, tq = s2[half] - s1[half] * s1[half] / nb;
    if (n0 == 0) {
      th.mean[half] = tm;
      th.m2[half] = tq;
    } else {
      const float tot = th.na + nb, d = tm - th.mean[half];
      th.mean[half] += d * (nb / tot);
      th.m2[half] += tq + d * d * (th.na * nb / tot);
    }
  }
  th.na += nb;
}

// A warpgroup's column tile of w columns from n0 (ss_width), steps i to i +
// nk - 1 of the ring: its products and its epilogue on the width known at
// compile time (a remainder's epilogue on the width at run time).
__device__ __forceinline__ void shard_stats_column(float (&acc)[96], SsThread& th, int i, int n0,
                                                   int m0, int w) {
  switch (w) {
#define SS_REM(q)                                                                           \
  case 8 * (q):                                                                             \
    shard_stats_tile<8 * (q)>(acc, *th.ring, th.base, th.g, th.lane, th.nk, i);             \
    shard_stats_epilogue<0>(acc, th, n0, m0, w);                                            \
    break;
    SS_REM(1) SS_REM(2) SS_REM(3) SS_REM(4) SS_REM(5) SS_REM(6) SS_REM(7)
#undef SS_REM
#define SS_BIG(W)                                                                           \
  case W:                                                                                   \
    shard_stats_tile<W>(acc, *th.ring, th.base, th.g, th.lane, th.nk, i);                   \
    shard_stats_epilogue<W>(acc, th, n0, m0, w);                                            \
    break;
    SS_BIG(64) SS_BIG(128) SS_BIG(192)
#undef SS_BIG
  }
}

__global__ void __launch_bounds__(kSsThreads, 1)
shard_stats_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap wmap,
                         const __grid_constant__ CUtensorMap hmap, const bf16* __restrict__ bias,
                         float2* __restrict__ stats, int M, int K, int N, int tile_n) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ wg::Ring<kSsStages> ring;
  unsigned char* smem = wg::align1024(smem_raw);
  unsigned char* staging = smem + kSsStages * kSsStage;
  float* pb = reinterpret_cast<float*>(staging + kSsStaging);  // the bias in float32
  const int tid = threadIdx.x;
  const int nk = (K + 63) / 64, row_tiles = (M + kSsRows - 1) / kSsRows;
  if (tid == 0) ring.init(8);  // each consumer warp releases a stage
  for (int c = tid; c < kSsBias; c += kSsThreads) pb[c] = c < N ? __bfloat162float(bias[c]) : 0.f;
  __syncthreads();

  // The roles go by the warp's index through a shuffle, so that ptxas sees
  // it is the same in every lane: a role chosen on threadIdx itself puts
  // the consumers' wgmma on a divergent path, and ptxas then serialises them.
  const int warp_id = __shfl_sync(0xffffffffu, tid / 32, 0);
  if (warp_id == 8) {  // the producer warp: one lane fills the ring in the consumers' order
    if (tid == 256) {
      int i = 0;
      for (int t = blockIdx.x; t < row_tiles; t += gridDim.x)
        for (int n0 = 0, w; n0 < N; n0 += w) {
          w = ss_width(n0, N, tile_n);
          const int boxes = (w + 63) / 64;
          for (int kt = 0; kt < nk; ++kt, ++i) {
            uint64_t* bar = ring.acquire(i, kSsXBytes + boxes * wg::kBoxBytes);
            unsigned char* st = smem + (i % kSsStages) * kSsStage;
            wg::tma_load_2d(st, &xmap, bar, kt * 64, t * kSsRows);
            for (int b = 0; b < boxes; ++b)
              wg::tma_load_2d(st + kSsXBytes + b * wg::kBoxBytes, &wmap, bar, n0 + 64 * b,
                              kt * 64);
          }
        }
    }
    return;
  }

  // Warpgroup g owns rows [64 g, 64 g + 64) of each row tile. Thread (warp,
  // lane) holds rows r0 and r0 + 8 of them and, of each 8-column chunk c of
  // a column tile, the columns 8c + cq, 8c + cq + 1: acc[4c + 2 half + e]
  // (the rem piece's chunks from c = 16 on). Only wgmma writes acc.
  const int g = warp_id / 4, warp = warp_id % 4, lane = tid % 32;
  SsThread th{&ring, pb, staging + g * kSsBoxes * wg::kBoxBytes, &hmap, wg::smem_u32(smem), g,
              lane, tid, warp * 16 + lane / 4, (lane % 4) * 2, nk, M};
  float acc[96];
  int i = 0;
  for (int t = blockIdx.x; t < row_tiles; t += gridDim.x) {
    const int m0 = t * kSsRows + 64 * g;
    th.na = 0.f;
    for (int n0 = 0, w; n0 < N; n0 += w, i += nk) {
      w = ss_width(n0, N, tile_n);
      shard_stats_column(acc, th, i, n0, m0, w);
    }
    if (lane % 4 == 0) {
      if (m0 + th.r0 < M) stats[m0 + th.r0] = make_float2(th.mean[0], th.m2[0]);
      if (m0 + th.r0 + 8 < M) stats[m0 + th.r0 + 8] = make_float2(th.mean[1], th.m2[1]);
    }
  }
  if (tid % 128 == 0) wg::tma_store_wait_read();  // the staging area outlives the reads
}
#undef SS_ACC

// entry 1's bf16 kernel on checked operands and plan
int shard_stats_wgmma(const void* x, const void* w, const void* b, void* h, void* stats,
                      long long M, long long K, long long N, int tile_n, int grid,
                      cudaStream_t st) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 || N % 8 || N > kWgMaxN || M > 0x7fffffffLL ||
      K > 0x7fffffffLL || tile_n < 64 || tile_n % 64 || tile_n > kSsMaxTile || grid < 1 ||
      grid > (M + kSsRows - 1) / kSsRows ||
      b == nullptr || stats == nullptr || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 || reinterpret_cast<uintptr_t>(h) % 16 ||
      reinterpret_cast<uintptr_t>(stats) % 8)
    return cudaErrorInvalidValue;
  CUtensorMap xm, wm, hm;
  const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M)};
  const cuuint64_t xstrides[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t xbox[2] = {64, kSsRows};
  int e = wg::encode_bf16(&xm, x, 2, xdims, xstrides, xbox);
  if (e == 0) e = wg::encode_rows(&wm, w, K, N);
  if (e == 0) e = wg::encode_rows(&hm, h, M, N);
  if (e != 0) return e;
  static std::atomic<bool> raised[wg::kMaxDevices];
  if ((e = wg::raise_smem_once(shard_stats_wgmma_kernel, kSsSmem, raised)) != 0) return e;
  shard_stats_wgmma_kernel<<<grid, kSsThreads, kSsSmem, st>>>(
      xm, wm, hm, static_cast<const bf16*>(b), static_cast<float2*>(stats), static_cast<int>(M),
      static_cast<int>(K), static_cast<int>(N), tile_n);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------- the epilogue of a split layer
//
// fused_spectre_linear_shard_ln (kernel B3's entry 2 under tensor
// parallelism): the LayerNorm, GELU and residual of a SpectreLinear whose
// rows are spread over tensor-parallel ranks, i.e. the epilogue of the TPU
// kernel spectre_tpu/ops/pallas/fused_linear.py::_kernel (:67-76) after its
// product. Two forms:
//
// - a column shard (stats given): h [M, n] is this rank's n of the row's
//   n_full columns, stats [size, M] the (mean, M2) of every rank's columns
//   (each rank's n), all-gathered. They are merged in rank order by Chan's
//   formula, as the cluster kernels merge their blocks, so every rank
//   computes the same statistics bit for bit, whatever order the collective
//   took.
// - a whole row (stats null): h is the float32 sum of the row-split
//   product, all-reduced; the bias is added here, the sum rounded into h_out
//   for the backward, and (mean, M2) taken over the float32 row by two
//   passes over registers, the second summing the deviations from the first
//   mean to correct it (as the cluster kernel).
//
// Then out = GELU((h - mean) rstd gamma + beta) [+ res], in float32 with
// erff, cast once; mstats [M] gets (mean, rstd) for the backward.
//
// What bounds it on the H100: bytes (h and res read, out written; h_out too
// for a whole row), and close behind them, for bf16 shards ahead of them,
// instruction issue: erff takes one of two polynomials by |x|, and a
// warp's lanes straddle the two, so both are issued for every element;
// the bf16 shards stop further from the byte bound than the float32 shards
// and the whole rows, which move twice the bytes an element (PERF.md).
// What held the first design (one warp a row) below half of that bound:
// 2-byte loads (a warp load instruction moved 64 bytes), gamma and beta
// (and the bias) loaded again every row, a whole row read three times, and
// no row in flight while one was computed.
//
// Design (the plan: ops/kernels/fused_linear.py::shard_ln_plan, on
// shard_chain_plan's vectors, lanes and chunks). A team of `lanes` lanes
// takes a row; lane l owns the columns tile + (c * lanes + l) * V + [0, V),
// c < C: V values a vector load of up to 16 bytes (V divides n; the bases
// and the row strides are aligned to it), at most 16 values a lane. Its
// columns are the same in every row, so its gamma, beta and bias stay in
// registers over all its rows. The team's next two rows of h and res are on
// their way while it computes one: each lane copies its own vectors by
// cp.async into a ring of three rows in shared memory and reads back only
// those (no barrier), which keeps the registers low enough for two or more
// blocks an SM (measured on the card against the next row in registers, at
// one or two blocks an SM, and rings of two and four rows; single bf16
// values, too narrow for cp.async, come a row ahead through registers); a
// shard's ranks' statistics come a row ahead, one rank's pair a lane,
// shuffled across the team. A shard wider than a
// warp's reach is cut into tiles of it, one per blockIdx.y: a shard needs
// no row sums. A whole row wider than that is shared by `warps` warps of
// one block, tile w to warp w; its sums go by a butterfly across the lanes
// (partners add the same two values: every lane the same bits), then
// across the warps in warp order through shared memory, two barriers a
// row. Wider than the block's 8 warps reach, the block walks the row
// (shard_ln_walk_kernel: the same reductions, the row read three times).
// Each block (up to 256 threads) owns a contiguous share of the rows, its
// teams taking every teams-th row of it; the grid is the blocks the card
// holds at once. Fixed orders throughout: two runs give the same bits.

constexpr int kLnThreads = 256;  // ops/kernels/fused_linear.py: SHARD_THREADS
constexpr int kLnWarps = kLnThreads / 32;
constexpr int kLnStages = 3;  // the ring: rows a team, two in flight

// A launch's operands: h and res in TI, bias, gamma, beta, out and h_out in
// TO; stats null for a whole row.
struct ShardLn {
  const void *h, *res, *bias, *gamma, *beta;
  const float2* stats;
  void *out, *h_out;
  float2* mstats;
  long long ldh, ldr, M, rows;  // rows: a block's share
  int size, n, lanes, warps;
  float inv_full, eps;
};

// A whole row's two sums: this lane's, across the team's lanes, then across
// its `warps` warps in warp order (red: the team's slots; a block barrier).
__device__ __forceinline__ float2 row_sum2(float2 s, int lanes, int warps, float2* red, int w) {
  s.x = team_sum(s.x, lanes);
  s.y = team_sum(s.y, lanes);
  if (warps > 1) {
    if ((threadIdx.x & 31) == 0) red[w] = s;
    __syncthreads();
    s = red[0];
    for (int j = 1; j < warps; ++j) {
      s.x += red[j].x;
      s.y += red[j].y;
    }
  }
  return s;
}

// (mean, M2) of a whole row from the first pass's sum and the second's sum
// of the deviations d and of d^2.
__device__ __forceinline__ float2 corrected(float mean1, float2 t, float nb) {
  return make_float2(mean1 + t.x / nb, t.y - t.x * t.x / nb);
}

// Rows come through a ring in shared memory (kLnStages rows of h and res a
// team, by cp.async), except single bf16 values (cp.async copies at least 4
// bytes), which come through registers loaded a row ahead.
template <typename TI, int V>
__host__ __device__ constexpr bool ln_ring() {
  return V * sizeof(TI) >= 4;
}

// Dynamic shared memory of an instance at `threads` threads: its ring.
template <typename TI, int V, int C>
__host__ __device__ constexpr int ln_smem(int threads) {
  return ln_ring<TI, V>() ? kLnStages * 2 * threads * C * V * static_cast<int>(sizeof(TI)) : 0;
}

template <typename TI, typename TO, int V, int C, bool kWhole>
__global__ void __launch_bounds__(kLnThreads) shard_ln_kernel(const ShardLn a) {
  constexpr bool kRing = ln_ring<TI, V>();
  constexpr int kBytes = V * static_cast<int>(sizeof(TI));
  using R = Raw<TI, V>;
  // the ring [stage][h, res][the block's tiles]; a thread copies and reads
  // back only its own chunks, so the ring needs no barrier
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float2 s_red[2][kLnWarps];  // a whole row's warps: the two passes' sums
  const int lanes = a.lanes, warps = a.warps, width = lanes * warps, n = a.n;
  const int team = threadIdx.x / width, teams = blockDim.x / width;
  const int lane = threadIdx.x % lanes, w = threadIdx.x % width / lanes;
  const int tile = lanes * C * V;
  const int base = (warps > 1 ? w : static_cast<int>(blockIdx.y)) * tile;
  const TI* h = static_cast<const TI*>(a.h);
  const TI* res = static_cast<const TI*>(a.res);
  TO* out = static_cast<TO*>(a.out);
  TO* h_out = static_cast<TO*>(a.h_out);
  TI* ring = reinterpret_cast<TI*>(smem);
  const int slots = blockDim.x * C * V;                   // an array of a stage
  const int mine = (team * warps + w) * tile + lane * V;  // chunk c at + c lanes V

  int col[C];
  bool in[C];
  float gam[C][V], bet[C][V], bia[kWhole ? C : 1][V];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    col[c] = base + (c * lanes + lane) * V;
    in[c] = col[c] < n;  // whole vectors: V divides n
#pragma unroll
    for (int e = 0; e < V; ++e) gam[c][e] = bet[c][e] = bia[kWhole ? c : 0][e] = 0.f;
    if (in[c]) {
      load_vec<TO, V>(static_cast<const TO*>(a.gamma) + col[c], gam[c]);
      load_vec<TO, V>(static_cast<const TO*>(a.beta) + col[c], bet[c]);
      if constexpr (kWhole) load_vec<TO, V>(static_cast<const TO*>(a.bias) + col[c], bia[c]);
    }
  }

  const long long M = a.M, r0 = static_cast<long long>(blockIdx.x) * a.rows;
  const long long r1 = r0 + a.rows < M ? r0 + a.rows : M;
  R hr[kRing ? 1 : C] = {}, rr[kRing ? 1 : C] = {};  // registers: this row, the next
  R hn[kRing ? 1 : C] = {}, rn[kRing ? 1 : C] = {};
  // a row of the team's h and res on its way: into the ring (one cp.async
  // group a row, empty past the share, so that wait_group counts rows) or
  // into registers
  auto fetch = [&](long long r, int stage, R* hh, R* rs) {
    if (r < r1) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (!in[c]) continue;
        const TI* hp = h + r * a.ldh + col[c];
        const TI* rp = res + r * a.ldr + col[c];
        if constexpr (kRing) {
          TI* at = ring + 2 * stage * slots + mine + c * lanes * V;
          cp_async<kBytes>(at, hp, true);
          if (res != nullptr) cp_async<kBytes>(at + slots, rp, true);
        } else {
          hh[c] = *reinterpret_cast<const R*>(hp);
          if (res != nullptr) rs[c] = *reinterpret_cast<const R*>(rp);
        }
      }
    }
    if constexpr (kRing) cp_async_commit();
  };
  // a shard's statistics a row ahead: lane j holds rank j's (mean, M2), or
  // each rank's is loaded when the team has fewer lanes than ranks
  const bool lane_stats = a.size <= lanes;
  float2 sr = make_float2(0.f, 0.f), sn = sr;
  auto fetch_stats = [&](long long r, float2& st) {
    if (!kWhole && lane_stats && lane < a.size && r < r1) st = a.stats[lane * M + r];
  };
  auto rank_stats = [&](int j, long long r, bool valid) -> float2 {
    if (lane_stats)
      return make_float2(__shfl_sync(0xffffffffu, sr.x, j, lanes),
                         __shfl_sync(0xffffffffu, sr.y, j, lanes));
    return valid ? a.stats[j * M + r] : make_float2(0.f, 0.f);
  };
  const float nb = static_cast<float>(n);
  long long r = r0 + team;
  if constexpr (kRing) {
    for (int s = 0; s < kLnStages - 1; ++s) fetch(r + s * teams, s, hr, rr);
  } else {
    fetch(r, 0, hr, rr);
  }
  fetch_stats(r, sr);
  int stage = 0;
  // the trip count is the block's (its first team's), so that every thread
  // reaches the shuffles and barriers; a team past the share's end only
  // takes part in them
  for (long long first = r0; first < r1; first += teams, r += teams) {
    if constexpr (kRing) {
      fetch(r + (kLnStages - 1) * teams, stage == 0 ? kLnStages - 1 : stage - 1, hr, rr);
      cp_async_wait<kLnStages - 1>();  // this row's group has landed
    } else {
      fetch(r + teams, 0, hn, rn);
    }
    fetch_stats(r + teams, sn);
    const bool valid = r < r1;
    const TI* at = ring + 2 * stage * slots + mine;
    float v[C][V];  // h (+ bias) in float32
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if constexpr (kRing) {
        load_vec<TI, V>(at + c * lanes * V, v[c]);
      } else {
        raw_to_f<TI, V>(hr[c], v[c]);
      }
      if constexpr (kWhole) {
#pragma unroll
        for (int e = 0; e < V; ++e) v[c][e] += bia[c][e];
      }
    }
    float mean, m2;
    if constexpr (kWhole) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (!in[c]) continue;
#pragma unroll
        for (int e = 0; e < V; ++e) s += v[c][e];
      }
      const float mean1 =
          row_sum2(make_float2(s, 0.f), lanes, warps, s_red[0] + team * warps, w).x / nb;
      float dsum = 0.f, q2 = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (!in[c]) continue;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float d = v[c][e] - mean1;
          dsum += d;
          q2 += d * d;
        }
      }
      const float2 st = corrected(
          mean1, row_sum2(make_float2(dsum, q2), lanes, warps, s_red[1] + team * warps, w), nb);
      mean = st.x;
      m2 = st.y;
    } else {  // the ranks' statistics in rank order (Chan)
      float na = nb;
      float2 st = rank_stats(0, r, valid);
      mean = st.x;
      m2 = st.y;
      for (int j = 1; j < a.size; ++j) {
        st = rank_stats(j, r, valid);
        const float tot = na + nb, d = st.x - mean;
        mean += d * (nb / tot);
        m2 += st.y + d * d * (na * nb / tot);
        na = tot;
      }
    }
    const float rstd = rsqrtf(m2 * a.inv_full + a.eps);
    if (valid) {
      if (lane == 0 && w == 0 && blockIdx.y == 0) a.mstats[r] = make_float2(mean, rstd);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (!in[c]) continue;
        if constexpr (kWhole) store_vec<TO, V>(h_out + r * n + col[c], v[c]);
        float y[V], rv[V];
        if (res != nullptr) {
          if constexpr (kRing) {
            load_vec<TI, V>(at + slots + c * lanes * V, rv);
          } else {
            raw_to_f<TI, V>(rr[c], rv);
          }
        }
#pragma unroll
        for (int e = 0; e < V; ++e) {
          y[e] = gelu_erf((v[c][e] - mean) * rstd * gam[c][e] + bet[c][e]);
          if (res != nullptr) y[e] += rv[e];
        }
        store_vec<TO, V>(out + r * n + col[c], y);
      }
    }
    if constexpr (kRing) {
      if (++stage == kLnStages) stage = 0;
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        hr[c] = hn[c];
        rr[c] = rn[c];
      }
    }
    sr = sn;
  }
  if constexpr (kRing) cp_async_wait<0>();
}

// A whole row beyond the block's register reach: the block takes a row at a
// time, thread t the vectors t, t + 256, ... of it in turn, and reads it
// three times (the two passes, then the output), with the reductions of
// shard_ln_kernel over its 8 warps.
template <typename TI, typename TO, int V>
__global__ void __launch_bounds__(kLnThreads) shard_ln_walk_kernel(const ShardLn a) {
  __shared__ float2 s_red[2][kLnWarps];
  const TO* bias = static_cast<const TO*>(a.bias);
  const TO* gamma = static_cast<const TO*>(a.gamma);
  const TO* beta = static_cast<const TO*>(a.beta);
  const int n = a.n, w = threadIdx.x / 32, step = kLnThreads * V;
  const float nb = static_cast<float>(n);
  const long long r0 = static_cast<long long>(blockIdx.x) * a.rows;
  const long long r1 = r0 + a.rows < a.M ? r0 + a.rows : a.M;
  for (long long r = r0; r < r1; ++r) {
    const TI* row = static_cast<const TI*>(a.h) + r * a.ldh;
    auto value = [&](int j, float* v) {  // h + bias at columns j + [0, V)
      float b[V];
      load_vec<TI, V>(row + j, v);
      load_vec<TO, V>(bias + j, b);
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] += b[e];
    };
    float s = 0.f;
    for (int j = threadIdx.x * V; j < n; j += step) {
      float v[V];
      value(j, v);
#pragma unroll
      for (int e = 0; e < V; ++e) s += v[e];
    }
    const float mean1 = row_sum2(make_float2(s, 0.f), 32, kLnWarps, s_red[0], w).x / nb;
    float dsum = 0.f, q2 = 0.f;
    for (int j = threadIdx.x * V; j < n; j += step) {
      float v[V];
      value(j, v);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float d = v[e] - mean1;
        dsum += d;
        q2 += d * d;
      }
    }
    const float2 st =
        corrected(mean1, row_sum2(make_float2(dsum, q2), 32, kLnWarps, s_red[1], w), nb);
    const float rstd = rsqrtf(st.y * a.inv_full + a.eps);
    if (threadIdx.x == 0) a.mstats[r] = make_float2(st.x, rstd);
    for (int j = threadIdx.x * V; j < n; j += step) {
      float v[V], g[V], be[V], y[V], rv[V];
      value(j, v);
      load_vec<TO, V>(gamma + j, g);
      load_vec<TO, V>(beta + j, be);
      if (a.res != nullptr) load_vec<TI, V>(static_cast<const TI*>(a.res) + r * a.ldr + j, rv);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        y[e] = gelu_erf((v[e] - st.x) * rstd * g[e] + be[e]);
        if (a.res != nullptr) y[e] += rv[e];
      }
      store_vec<TO, V>(static_cast<TO*>(a.h_out) + r * n + j, v);
      store_vec<TO, V>(static_cast<TO*>(a.out) + r * n + j, y);
    }
  }
}

// One instance of entry 2 (V values a vector, C vectors a lane; C = 0: the
// walk), launched or asked how many of its blocks an SM holds.
template <typename TI, typename TO>
struct ShardLnLaunch {
  ShardLn a;
  bool whole;
  unsigned blocks, tiles, threads;
  cudaStream_t st;
  int* blocks_per_sm;  // non-null: the query, nothing launched

  template <typename K>
  int go(K kern, int smem) {
    if (blocks_per_sm)
      return static_cast<int>(
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kern, threads, smem));
    kern<<<dim3(blocks, tiles), threads, smem, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }

  template <int V, int C, bool kWhole>
  int ring_instance() {
    auto kern = shard_ln_kernel<TI, TO, V, C, kWhole>;
    static std::atomic<bool> raised[wg::kMaxDevices];
    if (int e = wg::raise_smem_once(kern, ln_smem<TI, V, C>(kLnThreads), raised)) return e;
    return go(kern, ln_smem<TI, V, C>(static_cast<int>(threads)));
  }

  template <int V, int C>
  int run() {
    if constexpr (C == 0) {
      return go(shard_ln_walk_kernel<TI, TO, V>, 0);
    } else {
      return whole ? ring_instance<V, C, true>() : ring_instance<V, C, false>();
    }
  }
};

template <typename TI, typename TO>
int run_shard_ln(ShardLnLaunch<TI, TO> op, int vec, int chunks) {
#define SPECTRE_LN(VV, CC) \
  if (vec == VV && chunks == CC) return op.template run<VV, CC>();
  if constexpr (sizeof(TI) == 2) {  // 16-byte bf16 vectors
    SPECTRE_LN(8, 0) SPECTRE_LN(8, 1) SPECTRE_LN(8, 2)
  }
  SPECTRE_LN(4, 0) SPECTRE_LN(4, 1) SPECTRE_LN(4, 2) SPECTRE_LN(4, 3) SPECTRE_LN(4, 4)
  SPECTRE_LN(2, 0) SPECTRE_LN(2, 1) SPECTRE_LN(2, 2) SPECTRE_LN(2, 3) SPECTRE_LN(2, 4)
  SPECTRE_LN(1, 0) SPECTRE_LN(1, 1) SPECTRE_LN(1, 2) SPECTRE_LN(1, 3) SPECTRE_LN(1, 4)
#undef SPECTRE_LN
  return cudaErrorInvalidValue;
}

// The (in, out) dtypes entry 2 takes: (bf16, bf16), (float32, bf16) and
// (float32, float32).
template <typename TI, typename TO>
int shard_ln_typed(const ShardLn& a, bool whole, unsigned blocks, unsigned tiles,
                   unsigned threads, cudaStream_t st, int* blocks_per_sm, int vec, int chunks) {
  return run_shard_ln(ShardLnLaunch<TI, TO>{a, whole, blocks, tiles, threads, st, blocks_per_sm},
                      vec, chunks);
}

int shard_ln_codes(int in_code, int out_code, const ShardLn& a, bool whole, unsigned blocks,
                   unsigned tiles, unsigned threads, cudaStream_t st, int* blocks_per_sm, int vec,
                   int chunks) {
  if (in_code == 1 && out_code == 1)
    return shard_ln_typed<bf16, bf16>(a, whole, blocks, tiles, threads, st, blocks_per_sm, vec,
                                      chunks);
  if (in_code == 0 && out_code == 1)
    return shard_ln_typed<float, bf16>(a, whole, blocks, tiles, threads, st, blocks_per_sm, vec,
                                       chunks);
  if (in_code == 0 && out_code == 0)
    return shard_ln_typed<float, float>(a, whole, blocks, tiles, threads, st, blocks_per_sm, vec,
                                        chunks);
  return cudaErrorInvalidValue;
}

// Whether (vec, lanes, chunks, warps) is an instance entry 2 has, for
// elements of el bytes in: vec values a vector of at most 16 bytes, a
// power of two of lanes up to a warp, 1 to 4 chunks of at most 16 values
// (0: the walk, a block of 8 warps), a team of 1 to 8 warps (more than one
// only as a whole row's warps of 32 lanes).
bool shard_ln_instance(int vec, int lanes, int chunks, int warps, int el) {
  return (vec == 1 || vec == 2 || vec == 4 || vec == 8) && vec * el <= 16 && lanes >= 1 &&
         lanes <= 32 && (lanes & (lanes - 1)) == 0 && chunks >= 0 && chunks <= 4 &&
         chunks * vec <= 16 && warps >= 1 && warps <= kLnWarps &&
         (warps == 1 || lanes == 32) && (chunks > 0 || (lanes == 32 && warps == kLnWarps));
}

unsigned shard_ln_threads(int lanes, int warps) {
  const int width = lanes * warps;
  return static_cast<unsigned>(kLnThreads / width * width);
}

bool aligned_to(long long bytes, const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % static_cast<uintptr_t>(bytes) == 0;
}

}  // namespace

// fused_spectre_linear_cluster: dtype_code 0 = float32, 1 = bfloat16 (every
// tensor in that dtype); any K and N. The plan (ops/kernels/fused_linear.py::
// cluster_plan): bm rows a cluster (16; 32 float32, 64 bf16), cn column blocks of bn
// columns (bn % 8 == 0, each block at least one column inside N), ck K
// blocks of kc (kc % 32 == 0, each inside K), cn * ck <= 16. h_out: null, or
// [M, N] to receive the pre-LN activation. Returns cudaGetLastError() after
// the launch (0 on success); a plan that does not cover the shape, or a
// cluster that cannot be resident, is refused with an error.
extern "C" int fused_spectre_linear_cluster(int dtype_code, const void* x, const void* w,
                                            const void* b, const void* gamma, const void* beta,
                                            void* out, void* h_out, long long M, long long K,
                                            long long N, int bm, int bn, int cn, int ck, int kc,
                                            float eps, void* stream) {
  return cluster_entry(dtype_code, x, w, b, gamma, beta, out, h_out, nullptr, M, K, N, bm, bn, cn,
                       ck, kc, eps, stream);
}

// bfloat16 only, every tensor in it; N and K multiples of 8, N <= 768, x,
// W, out and h_out 16-byte aligned (what TMA can describe). h_out: null, or
// [M, N] to receive the pre-LN activation. Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int fused_spectre_linear_wgmma(const void* x, const void* w, const void* b,
                                          const void* gamma, const void* beta, void* out,
                                          void* h_out, long long M, long long K, long long N,
                                          float eps, void* stream) {
  return wgmma_entry(x, w, b, gamma, beta, out, h_out, nullptr, M, K, N, eps, stream);
}

// fused_spectre_linear_shard_stats: the forward of a SpectreLinear split by
// columns up to its LayerNorm statistics on the cluster kernel (float32,
// and bf16 that fused_spectre_linear_shard_stats_wgmma does not take). h = x
// @ W + b [M, N] in x's dtype, N this rank's columns, and stats [M] float32
// (mean, M2) of each row's float32 sums over them; the plan (bm, bn, cn,
// ck, kc) and dtype_code as for fused_spectre_linear_cluster. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int fused_spectre_linear_shard_stats(int dtype_code, const void* x, const void* w,
                                                const void* b, void* h, void* stats,
                                                long long M, long long K, long long N, int bm,
                                                int bn, int cn, int ck, int kc, void* stream) {
  float2* st = static_cast<float2*>(stats);
  if (st == nullptr) return cudaErrorInvalidValue;
  return cluster_entry(dtype_code, x, w, b, b, b, h, h, st, M, K, N, bm, bn, cn, ck, kc, 0.f,
                       stream);
}

// fused_spectre_linear_shard_stats_wgmma: the same in bf16 on
// shard_stats_wgmma_kernel, every tensor bf16 but stats; K and N multiples
// of 8, N <= 768, x, W and h 16-byte aligned (what TMA can describe). The
// plan (ops/kernels/fused_linear.py::shard_stats_plan): column tiles of
// tile_n columns (64, 128 or 192) up to N's last multiple of 64, the rest
// in a tile of its own, and `grid` persistent blocks (1 to the row tiles of 128). Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int fused_spectre_linear_shard_stats_wgmma(const void* x, const void* w,
                                                      const void* b, void* h, void* stats,
                                                      long long M, long long K, long long N,
                                                      int tile_n, int grid, void* stream) {
  return shard_stats_wgmma(x, w, b, h, stats, M, K, N, tile_n, grid,
                           static_cast<cudaStream_t>(stream));
}

// fused_spectre_linear_shard_ln: the epilogue of a split SpectreLinear
// (shard_ln_kernel above). in_code / out_code: 0 float32, 1 bf16, for h and
// res (in) and bias, gamma, beta, out, h_out (out); (bf16, bf16),
// (float32, bf16) and (float32, float32). h [M, n] with row stride ldh; stats:
// null (a whole row: bias and h_out [M, n] given) or [size, M] float2 (a
// column shard of size * n columns, n_full = size * n); res: null or [M, n]
// with row stride ldr; out [M, n]; mstats [M] float2. The plan
// (ops/kernels/fused_linear.py::shard_ln_plan): vec values a vector
// (dividing n; every base and row stride aligned to vec elements of its
// tensor), lanes a row (a power of two up to 32), chunks vectors a lane (1
// to 4, at most 16 values), so tiles = ceil(n / (lanes chunks vec)) tiles a
// row: a shard's on blockIdx.y (warps 1), a whole row's as its `warps`
// warps (warps = tiles, at most 8); chunks 0: a whole row walked by a block
// of 8 warps; `blocks` blocks (at most M), each owning ceil(M / blocks) rows.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int fused_spectre_linear_shard_ln(int in_code, int out_code, const void* h,
                                             long long ldh, const void* stats, int size,
                                             const void* bias, const void* gamma,
                                             const void* beta, const void* res, long long ldr,
                                             void* out, void* h_out, void* mstats, long long M,
                                             long long n, long long n_full, float eps,
                                             long long blocks, int vec, int lanes, int chunks,
                                             int warps, void* stream) {
  const bool whole = stats == nullptr;
  const int el = in_code == 1 ? 2 : 4;
  if (M <= 0 || n <= 0 || n_full < n || n_full > 0x7fffffffLL || ldh < n ||
      (res != nullptr && ldr < n) || size < 1 || blocks < 1 || blocks > M ||
      blocks > 0x7fffffffLL ||
      (whole ? (bias == nullptr || h_out == nullptr || n_full != n) : n_full != n * size) ||
      !shard_ln_instance(vec, lanes, chunks, warps, el) || n % vec)
    return cudaErrorInvalidValue;
  long long tiles = 1;
  if (chunks > 0) {
    const long long tile = static_cast<long long>(lanes) * chunks * vec;
    tiles = (n + tile - 1) / tile;
    if (whole ? tiles != warps : (warps != 1 || tiles > 65535)) return cudaErrorInvalidValue;
  } else if (!whole) {
    return cudaErrorInvalidValue;
  }
  // a vector's bytes in h and res, and in out, h_out, gamma, beta and bias
  const long long vb = static_cast<long long>(vec) * el, vo = vec * (out_code == 1 ? 2LL : 4LL);
  if (!aligned_to(vb, h) || !aligned_to(vb, res) || (ldh * el) % vb ||
      (res != nullptr && (ldr * el) % vb) || !aligned_to(vo, out) || !aligned_to(vo, h_out) ||
      !aligned_to(vo, gamma) || !aligned_to(vo, beta) || !aligned_to(vo, bias) ||
      !aligned_to(8, stats) || !aligned_to(8, mstats))
    return cudaErrorMisalignedAddress;
  ShardLn a{h, res, bias, gamma, beta, static_cast<const float2*>(stats), out, h_out,
            static_cast<float2*>(mstats), ldh, ldr, M, (M + blocks - 1) / blocks, size,
            static_cast<int>(n), lanes, warps, 1.f / static_cast<float>(n_full), eps};
  return shard_ln_codes(in_code, out_code, a, whole, static_cast<unsigned>(blocks),
                        whole ? 1u : static_cast<unsigned>(tiles), shard_ln_threads(lanes, warps),
                        static_cast<cudaStream_t>(stream), nullptr, vec, chunks);
}

// How many blocks of entry 2's instance (in_code, out_code as above; a
// whole row or a shard; vec, chunks; chunks 0: the walk) of `threads`
// threads an SM of the current device holds, into *blocks_per_sm. Returns a
// CUDA error code (0 on success).
extern "C" int fused_spectre_linear_shard_ln_occupancy(int in_code, int out_code, int whole,
                                                       int vec, int chunks, int threads,
                                                       int* blocks_per_sm) {
  if (blocks_per_sm == nullptr || threads < 1 || threads > kLnThreads ||
      !shard_ln_instance(vec, 32, chunks, chunks > 0 ? 1 : kLnWarps, in_code == 1 ? 2 : 4))
    return cudaErrorInvalidValue;
  ShardLn a{};
  return shard_ln_codes(in_code, out_code, a, whole != 0, 1, 1, static_cast<unsigned>(threads),
                        nullptr, blocks_per_sm, vec, chunks);
}

// ------------------------------------------------------------ N > 768
//
// fused_spectre_linear_wide_cluster (bf16 that TMA can describe, 768 < N
// <= 256 * the largest cluster the card launches: 2,048 with a portable 8,
// 4,096 with a non-portable 16): the whole function in one launch with no
// workspace, where a block can no longer hold a whole output row. A
// thread-block cluster of cn = ceil(N / 256) blocks shares a row tile of
// 128 rows; block jn (its rank) owns columns [256 jn, 256 jn + 256). Each
// block runs the mainloop of fused_linear_wgmma_kernel: two warpgroups of
// 64 rows, each a 64 x 256 f32 tile in 128 registers a thread; its first
// thread fills a ring of 4 stages by TMA, a stage being the two x boxes
// and the four W boxes of the block's columns (48 KB). One block an SM.
// Measured on the H100 and not kept: one warpgroup a block with 2 stages
// (two blocks an SM) or 4, and a producer warp beside two warpgroups, all
// slower at the C6 shapes.
// Epilogue, in registers: h = sums + bias (stored by TMA when asked); each
// row's (mean, M2) over the block's columns, by two passes over the
// registers (a row's 256 columns are one quad's: shuffles, no shared memory),
// the second summing the deviations from the first mean to correct it; the
// pair pushed into the shared memory of every block of the cluster (DSMEM);
// one cluster barrier; the cn partials combined in rank order by Chan's
// formula (count of a block: its columns inside N; divisor N), as the
// cluster kernel above does; then gamma, beta, erf GELU and the identity
// residual (x's columns of this block, K == N), and out stored once by TMA.
// The statistics are those of the float32 sums. After the cluster barrier
// no block touches another's shared memory, so none waits to leave; before
// the push every block must have started (an arrive at the start, a wait
// before the push). Fixed orders throughout: two runs give the same bits.
// What bounds it: at (4,160 x 1,536)(1,536 x 1,536) bf16 19.6 GFLOP (0.0198
// ms) against 2 M N + M K + K N values moved (0.011 ms); every block of a
// cluster reads the x tile, and every row tile all of W, from L2.
//
namespace {

struct WcCfg {
  static constexpr int NWG = 2;  // warpgroups of 64 rows
  static constexpr int S = 4;    // ring stages
  static constexpr int ROWS = 64 * NWG;
  static constexpr int STAGE = wg::kBoxBytes * (NWG + 4);  // NWG x boxes, then four W boxes
  static constexpr int THREADS = 128 * NWG;
  static constexpr int SMEM = S * STAGE + 3 * 256 * 4 + kClMaxCluster * ROWS * 8 + 1024;
  // out and h staged for the TMA store in the freed stage buffers
  static_assert(2 * NWG * 4 * wg::kBoxBytes <= S * STAGE, "staging does not fit");
};

__global__ void __launch_bounds__(WcCfg::THREADS, 1)
fused_linear_wide_cluster_kernel(const __grid_constant__ CUtensorMap xmap,
                                 const __grid_constant__ CUtensorMap wmap,
                                 const __grid_constant__ CUtensorMap omap,
                                 const __grid_constant__ CUtensorMap hmap,
                                 const bf16* __restrict__ x, const bf16* __restrict__ bias,
                                 const bf16* __restrict__ gamma, const bf16* __restrict__ beta,
                                 int M, int K, int N, int cn, float eps, int save_h) {
  using C = WcCfg;
  constexpr int NWG = C::NWG, S = C::S;
  extern __shared__ unsigned char smem_raw[];
  __shared__ wg::Ring<S> ring;
  unsigned char* smem = wg::align1024(smem_raw);
  float* pb = reinterpret_cast<float*>(smem + S * C::STAGE);  // [3][256]: bias, gamma, beta
  float2* stats = reinterpret_cast<float2*>(pb + 3 * 256);     // [cn][ROWS]: (mean, M2)
  cg::cluster_group cluster = cg::this_cluster();
  const int jn = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int m0 = static_cast<int>(blockIdx.x / cn) * C::ROWS, n0 = jn * 256;
  const int ncols = min(256, N - n0), nk = (K + 63) / 64, nbox = (ncols + 63) / 64;
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  // step i: the x boxes at (k, m) = (64 i, m0 + 64 g), the W boxes at (n, k)
  // = (n0 + 64 j, 64 i); boxes past N are not loaded (their columns are
  // never stored)
  auto load = [&](int i) {
    uint64_t* bar = ring.acquire(i, wg::kBoxBytes * (NWG + nbox));
    unsigned char* st = smem + (i % S) * C::STAGE;
    for (int g = 0; g < NWG; ++g) wg::tma_load_2d(st + g * wg::kBoxBytes, &xmap, bar, i * 64, m0 + 64 * g);
    for (int j = 0; j < nbox; ++j)
      wg::tma_load_2d(st + wg::kBoxBytes * (NWG + j), &wmap, bar, n0 + j * 64, i * 64);
  };
  if (tid == 0) ring.init(C::THREADS / 32);
  for (int c = tid; c < 256; c += C::THREADS) {
    const bool in = c < ncols;
    pb[c] = in ? __bfloat162float(bias[n0 + c]) : 0.f;
    pb[256 + c] = in ? __bfloat162float(gamma[n0 + c]) : 0.f;
    pb[512 + c] = in ? __bfloat162float(beta[n0 + c]) : 0.f;
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < S && i < nk; ++i) load(i);

  // warpgroup g owns rows [64 g, 64 g + 64) of the tile, all 256 columns:
  // acc[4c + 2 half + e] is row r0 + 8 half, column 8c + cq + e (the layout
  // of fused_linear_wgmma_kernel)
  const int g = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4, cq = (lane % 4) * 2;
  float acc[128];
  const uint32_t base = wg::smem_u32(smem);
  for (int kt = 0; kt < nk; ++kt) {
    ring.wait_full(kt);
    const uint32_t st = base + (kt % S) * C::STAGE;
    const uint32_t xs = st + g * wg::kBoxBytes, ws = st + NWG * wg::kBoxBytes;
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

  // out and h go to this warpgroup's four 64 x 64 boxes of each in the
  // stage memory, in the 128-byte-swizzled box layout, and out by TMA
  wg::named_barrier(1, C::THREADS);  // every warpgroup is past its last wgmma
  unsigned char* ostage = smem + g * 4 * wg::kBoxBytes;
  unsigned char* hstage = smem + (NWG + g) * 4 * wg::kBoxBytes;
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
        if (b * 64 < ncols) wg::tma_store_2d(map, stage + b * wg::kBoxBytes, n0 + b * 64, m0 + 64 * g);
      wg::tma_store_commit();
    }
  };
  if (save_h) {
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float2 bb = *reinterpret_cast<const float2*>(pb + c * 8 + cq);
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<__nv_bfloat162*>(hstage + box_offset(c, half)) =
            __floats2bfloat162_rn(acc[4 * c + 2 * half] + bb.x, acc[4 * c + 2 * half + 1] + bb.y);
    }
    store_boxes(&hmap, hstage);
  }

  // (mean, M2) of rows r0 and r0 + 8 over this block's columns; a quad
  // holds a row
  const float nb = static_cast<float>(ncols);
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    if (c * 8 + cq < ncols) {  // N % 8 == 0: both columns are in
      const float2 b = *reinterpret_cast<const float2*>(pb + c * 8 + cq);
      s0 += (acc[4 * c] + b.x) + (acc[4 * c + 1] + b.y);
      s1 += (acc[4 * c + 2] + b.x) + (acc[4 * c + 3] + b.y);
    }
  }
  auto quad_sum = [](float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
  };
  const float mean0 = quad_sum(s0) / nb, mean1 = quad_sum(s1) / nb;
  float d0 = 0.f, d1 = 0.f, q0 = 0.f, q1 = 0.f;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    if (c * 8 + cq < ncols) {
      const float2 b = *reinterpret_cast<const float2*>(pb + c * 8 + cq);
      const float a = acc[4 * c] + b.x - mean0, e = acc[4 * c + 1] + b.y - mean0;
      const float f = acc[4 * c + 2] + b.x - mean1, u = acc[4 * c + 3] + b.y - mean1;
      d0 += a + e;
      q0 += a * a + e * e;
      d1 += f + u;
      q1 += f * f + u * u;
    }
  }
  d0 = quad_sum(d0);
  q0 = quad_sum(q0);
  d1 = quad_sum(d1);
  q1 = quad_sum(q1);
  const float2 st0 = make_float2(mean0 + d0 / nb, q0 - d0 * d0 / nb);
  const float2 st1 = make_float2(mean1 + d1 / nb, q1 - d1 * d1 / nb);
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // every peer has started
  const int row = 64 * g + r0;
  for (int q = lane % 4; q < cn; q += 4) {
    float2* peer = cluster.map_shared_rank(stats + jn * C::ROWS + row, q);
    peer[0] = st0;
    peer[8] = st1;
  }
  cluster.sync();  // every (mean, M2) is in; no block touches another's shared memory after

  // the row statistics over N: the cn partials in rank order (Chan)
  const float inv_n = 1.f / static_cast<float>(N);
  float mean[2], rstd[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float na = 0.f, mu = 0.f, m2 = 0.f;
    for (int j = 0; j < cn; ++j) {
      const float2 st = stats[j * C::ROWS + row + 8 * half];
      const float nj = static_cast<float>(min(256, N - 256 * j));
      if (j == 0) {
        na = nj;
        mu = st.x;
        m2 = st.y;
      } else {
        const float n = na + nj, d = st.x - mu;
        mu += d * (nj / n);
        m2 += st.y + d * d * (na * nj / n);
        na = n;
      }
    }
    mean[half] = mu;
    rstd[half] = rsqrtf(m2 * inv_n + eps);
  }

  const bool identity = K == N;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    const int col = c * 8 + cq;
    const float2 bb = *reinterpret_cast<const float2*>(pb + col);
    const float2 gm = *reinterpret_cast<const float2*>(pb + 256 + col);
    const float2 bt = *reinterpret_cast<const float2*>(pb + 512 + col);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + row + 8 * half;
      const float v0 = acc[4 * c + 2 * half] + bb.x, v1 = acc[4 * c + 2 * half + 1] + bb.y;
      float y0 = gelu_erf((v0 - mean[half]) * rstd[half] * gm.x + bt.x);
      float y1 = gelu_erf((v1 - mean[half]) * rstd[half] * gm.y + bt.y);
      if (identity && m < M && col < ncols) {  // K == N: x's row has N entries
        const float2 xr = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            x + static_cast<long long>(m) * K + n0 + col));
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

int wide_cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr, int cn,
                        long long M) {
  using C = WcCfg;
  auto kern = fused_linear_wide_cluster_kernel;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= wg::kMaxDevices) return cudaErrorInvalidDevice;
  static std::atomic<bool> prepared[wg::kMaxDevices];
  if (!prepared[dev].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e == cudaSuccess) e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
    prepared[dev].store(true, std::memory_order_release);
  }
  cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((M + C::ROWS - 1) / C::ROWS * cn));
  cfg.blockDim = dim3(C::THREADS);
  cfg.dynamicSmemBytes = C::SMEM;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cn;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return 0;
}

// the clusters of cn blocks that can be resident at once (0: none launches)
int wide_cluster_fits(int cn, int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const int e = wide_cluster_config(cfg, attr, cn, WcCfg::ROWS);
  if (e != 0) return e;
  const cudaError_t r =
      cudaOccupancyMaxActiveClusters(clusters, fused_linear_wide_cluster_kernel, &cfg);
  if (r != cudaSuccess) cudaGetLastError();  // not left for a later launch's check to find
  return static_cast<int>(r);
}

int launch_wide_cluster(const void* x, const void* w, const void* b, const void* g,
                        const void* be, void* out, void* h_out, long long M, long long K,
                        long long N, float eps, cudaStream_t st) {
  const int cn = static_cast<int>((N + 255) / 256);
  CUtensorMap xm, wm, om, hm;
  int e = wg::encode_rows(&xm, x, M, K);
  if (e == 0) e = wg::encode_rows(&wm, w, K, N);
  if (e == 0) e = wg::encode_rows(&om, out, M, N);
  if (e == 0) e = wg::encode_rows(&hm, h_out != nullptr ? h_out : out, M, N);
  if (e != 0) return e;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= wg::kMaxDevices) return cudaErrorInvalidDevice;
  // a cluster that cannot be resident is refused here, not left to hang
  static std::atomic<bool> checked[wg::kMaxDevices][kClMaxCluster + 1];
  if (!checked[dev][cn].load(std::memory_order_acquire)) {
    int clusters = 0;
    if ((e = wide_cluster_fits(cn, &clusters)) != 0) return e;
    if (clusters == 0) return cudaErrorInvalidConfiguration;
    checked[dev][cn].store(true, std::memory_order_release);
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  if ((e = wide_cluster_config(cfg, attr, cn, M)) != 0) return e;
  cfg.stream = st;
  const cudaError_t r = cudaLaunchKernelEx(
      &cfg, fused_linear_wide_cluster_kernel, xm, wm, om, hm, static_cast<const bf16*>(x),
      static_cast<const bf16*>(b), static_cast<const bf16*>(g), static_cast<const bf16*>(be),
      static_cast<int>(M), static_cast<int>(K), static_cast<int>(N), cn, eps,
      static_cast<int>(h_out != nullptr));
  if (r != cudaSuccess) return static_cast<int>(r);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bfloat16 only, every tensor in it; N and K multiples of 8, N <= 4,096,
// x, W, out and h_out 16-byte aligned (what TMA can describe). h_out: null,
// or [M, N] to receive the pre-LN activation. Returns cudaGetLastError()
// after the launch (0 on success); a cluster of ceil(N / 256) blocks that
// the card cannot hold is refused with an error.
extern "C" int fused_spectre_linear_wide_cluster(const void* x, const void* w, const void* b,
                                                 const void* gamma, const void* beta, void* out,
                                                 void* h_out, long long M, long long K,
                                                 long long N, float eps, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 || N % 8 || N > 256LL * kClMaxCluster ||
      M > 0x7fffffffLL || K > 0x7fffffffLL || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 || reinterpret_cast<uintptr_t>(out) % 16 ||
      reinterpret_cast<uintptr_t>(h_out) % 16)
    return cudaErrorInvalidValue;
  return launch_wide_cluster(x, w, b, gamma, beta, out, h_out, M, K, N, eps,
                             static_cast<cudaStream_t>(stream));
}

// The largest cluster of the wide cluster kernel's blocks (at most 16) that
// the current card can hold, in *size: the kernel then takes N up to 256
// times it. Returns 0 or a CUDA error.
extern "C" int fused_spectre_linear_wide_cluster_reach(int* size) {
  *size = 0;
  for (int cn = kClMaxCluster; cn >= 1; --cn) {
    int clusters = 0;
    const int e = wide_cluster_fits(cn, &clusters);
    if (e != 0 && e != cudaErrorInvalidClusterSize) return e;
    if (e == 0 && clusters > 0) {
      *size = cn;
      return 0;
    }
  }
  return 0;
}
