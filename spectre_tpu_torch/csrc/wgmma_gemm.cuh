// wgmma_gemm.cuh: the Hopper matrix-product mainloop shared by kernel 2's
// bf16 forwards (csrc/fused_spectre_linear.cu) and kernel 5's bf16 kernels
// (csrc/fused_block_bwd.cu), written by hand as inline PTX.
//
// The pieces, each a thin wrapper over one PTX instruction or CUDA call:
// - TMA tensor maps, encoded on the host at every launch (the pointers change
//   every call) through cuTensorMapEncodeTiled, fetched with
//   cudaGetDriverEntryPoint so that the library needs no -lcuda. A map goes
//   to the kernel as a `const __grid_constant__ CUtensorMap` parameter.
// - 128-byte swizzled shared-memory tiles: the inner box of such a map holds
//   64 bf16 values (128 bytes), so a wider tile is several 64-wide boxes side
//   by side, 8 KB apart for 64 rows. Stage buffers are 1024-byte aligned, so
//   the swizzle (16-byte chunk index XOR row % 8) is the one the wgmma
//   descriptors assume, with base offset 0.
// - Ring: S stages, each with a full barrier (one arrival plus the bytes
//   its TMA loads bring) and an empty barrier (one arrival per consumer
//   warp, once its warpgroup's wgmma on the stage has completed). The first
//   thread of the block fills the ring: S steps up front, then step i + S
//   as soon as every warp has released step i. There is no separate
//   producer warp: ptxas allocates registers against the launch bound (a
//   producer warpgroup beside three consumers makes 512 threads, 128
//   registers each, and setmaxnreg does not change what ptxas allocates),
//   while a 64 x 256 f32 accumulator takes 128 by itself. A wait that has
//   not passed after ~10 s of clock traps, so that a protocol fault ends the
//   kernel with an error instead of holding the card.
// - wgmma.mma_async m64nNk16 with f32 accumulators in registers, bf16
//   operands read from shared memory through 64-bit matrix descriptors,
//   with wgmma.fence / commit_group / wait_group.
//
// Descriptors (PTX ISA, "Matrix Descriptor Format"; CUTLASS's canonical GMMA
// layouts): bits 0-13 start address >> 4, 16-29 leading byte offset >> 4,
// 32-45 stride byte offset >> 4, 62-63 layout (1 = 128-byte swizzle).
// - K-major (rows of 64 K-values, 128 B each): SBO = 1024 B between groups of
//   8 rows, LBO unused (1). The k-th 16-deep slice starts 32 B further.
// - MN-major (rows of 64 MN-values, one row per K index): LBO = the stride
//   between 64-wide MN chunks (one box), SBO = 1024 B between groups of 8 K
//   rows. The k-th 16-deep slice starts 16 rows (2048 B) further.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace wg {

// ---------------------------------------------------------------- host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once; null where CUDA does not have it.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor of `rank` dims (innermost first), strides in bytes of dims
// 1.., boxed by `box` with the 128-byte swizzle. Out-of-range elements of a
// box load as zeros and are not written by a store. Returns 0 or a CUDA error.
inline int encode_bf16(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
                       const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, static_cast<cuuint32_t>(rank),
                        const_cast<void*>(ptr), dims, strides, box, ones,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// a row-major [rows, cols] bf16 matrix in boxes of 64 x 64
inline int encode_rows(CUtensorMap* map, const void* ptr, long long rows, long long cols) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, 64};
  return encode_bf16(map, ptr, 2, dims, strides, box);
}

constexpr int kMaxDevices = 16;

// Raise a kernel's dynamic shared-memory limit to `bytes` on the current
// device once: `raised` is the kernel's own flag a device, set after the
// first call there succeeded. Returns 0 or a CUDA error.
template <typename Kernel>
inline int raise_smem_once(Kernel kern, int bytes, std::atomic<bool> (&raised)[kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (raised[dev].load(std::memory_order_acquire)) return 0;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  raised[dev].store(true, std::memory_order_release);
  return 0;
}

// ------------------------------------------------------------- device side

constexpr int kBoxBytes = 64 * 64 * 2;  // one 64 x 64 bf16 box
constexpr long long kStallCycles = 1LL << 34;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the dynamic shared memory rounded up to 1024 bytes (the launch adds 1024)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024u - (a & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > kStallCycles) {
      __trap();
    }
  }
}

// A ring of S stages of `bytes` each; lives in shared memory.
template <int S>
struct Ring {
  uint64_t full[S];
  uint64_t empty[S];

  // by one thread, before a __syncthreads
  __device__ __forceinline__ void init(int consumer_warps) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumer_warps);
    }
    mbar_init_fence();
  }
  // consumers: wait until step i's loads have landed
  __device__ __forceinline__ void wait_full(int i) { mbar_wait(&full[i % S], (i / S) & 1); }
  // lane 0 of each consumer warp, once its warpgroup's wgmma on step i is done
  __device__ __forceinline__ void release(int i) { mbar_arrive(&empty[i % S]); }
  // the filling thread: wait until step i's stage is free (step i - S
  // released), expect `bytes` on it; returns its full barrier for the loads
  __device__ __forceinline__ uint64_t* acquire(int i, uint32_t bytes) {
    if (i >= S) mbar_wait(&empty[i % S], ((i / S) - 1) & 1);
    mbar_expect_tx(&full[i % S], bytes);
    return &full[i % S];
  }
};

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::
                   "l"(reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(src)), "r"(c0), "r"(c1)
               : "memory");
}
// close the thread's group of TMA stores
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// wait until the thread's committed TMA stores have read their shared memory
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// generic-proxy writes to shared memory, made visible to TMA (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// arrive at a named barrier without waiting: the other `threads` - (this
// warp's group) wait for it with named_barrier
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// four 8 x 8 b16 matrices from registers into shared memory: lane t gives
// the address of row t % 8 of matrix t / 8 and holds, in r[j], its two
// values of matrix j (row t / 4, columns 2 (t % 4) and 2 (t % 4) + 1: an mma
// or wgmma accumulator fragment, packed)
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}
// keeps the compiler from moving accesses of accumulator registers across
// the wgmma that writes them asynchronously
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint64_t desc_k_major(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t saddr, uint32_t lbo_bytes) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo_bytes >> 4) << 16) | (64ull << 32) | (1ull << 62);
}

// D[64 x N] (+)= A[64 x 16] * B[16 x N]; A K-major; B K-major (TRANS_B = 0)
// or MN-major (TRANS_B = 1); scale_d = 0 overwrites D.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

// D[64 x N] (+)= A[64 x 16] * B[16 x N] for any N in 8 .. 192 that is a
// multiple of 8, A K-major, B MN-major (W's [K, N] rows); scale_d = 0
// overwrites D. One specialisation per width, generated below: the
// descriptors and scale_d are read-write operands so that they take the
// numbers %0-%2 whatever the width, and the N / 2 sums follow as %3 ...
template <int N>
__device__ __forceinline__ void wgmma_mn(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d);

#define WG_ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_R4 "%3, %4, %5, %6"
#define WG_R8 WG_R4 ", %7, %8, %9, %10"
#define WG_R12 WG_R8 ", %11, %12, %13, %14"
#define WG_R16 WG_R12 ", %15, %16, %17, %18"
#define WG_R20 WG_R16 ", %19, %20, %21, %22"
#define WG_R24 WG_R20 ", %23, %24, %25, %26"
#define WG_R28 WG_R24 ", %27, %28, %29, %30"
#define WG_R32 WG_R28 ", %31, %32, %33, %34"
#define WG_R36 WG_R32 ", %35, %36, %37, %38"
#define WG_R40 WG_R36 ", %39, %40, %41, %42"
#define WG_R44 WG_R40 ", %43, %44, %45, %46"
#define WG_R48 WG_R44 ", %47, %48, %49, %50"
#define WG_R52 WG_R48 ", %51, %52, %53, %54"
#define WG_R56 WG_R52 ", %55, %56, %57, %58"
#define WG_R60 WG_R56 ", %59, %60, %61, %62"
#define WG_R64 WG_R60 ", %63, %64, %65, %66"
#define WG_R68 WG_R64 ", %67, %68, %69, %70"
#define WG_R72 WG_R68 ", %71, %72, %73, %74"
#define WG_R76 WG_R72 ", %75, %76, %77, %78"
#define WG_R80 WG_R76 ", %79, %80, %81, %82"
#define WG_R84 WG_R80 ", %83, %84, %85, %86"
#define WG_R88 WG_R84 ", %87, %88, %89, %90"
#define WG_R92 WG_R88 ", %91, %92, %93, %94"
#define WG_R96 WG_R92 ", %95, %96, %97, %98"
#define WG_D4 WG_ACC4(0)
#define WG_D8 WG_D4, WG_ACC4(4)
#define WG_D12 WG_D8, WG_ACC4(8)
#define WG_D16 WG_D12, WG_ACC4(12)
#define WG_D20 WG_D16, WG_ACC4(16)
#define WG_D24 WG_D20, WG_ACC4(20)
#define WG_D28 WG_D24, WG_ACC4(24)
#define WG_D32 WG_D28, WG_ACC4(28)
#define WG_D36 WG_D32, WG_ACC4(32)
#define WG_D40 WG_D36, WG_ACC4(36)
#define WG_D44 WG_D40, WG_ACC4(40)
#define WG_D48 WG_D44, WG_ACC4(44)
#define WG_D52 WG_D48, WG_ACC4(48)
#define WG_D56 WG_D52, WG_ACC4(52)
#define WG_D60 WG_D56, WG_ACC4(56)
#define WG_D64 WG_D60, WG_ACC4(60)
#define WG_D68 WG_D64, WG_ACC4(64)
#define WG_D72 WG_D68, WG_ACC4(68)
#define WG_D76 WG_D72, WG_ACC4(72)
#define WG_D80 WG_D76, WG_ACC4(76)
#define WG_D84 WG_D80, WG_ACC4(80)
#define WG_D88 WG_D84, WG_ACC4(84)
#define WG_D92 WG_D88, WG_ACC4(88)
#define WG_D96 WG_D92, WG_ACC4(92)
#define WG_MMA_MN(N, R)                                                                          \
  template <>                                                                                    \
  __device__ __forceinline__ void wgmma_mn<N>(float (&d)[R], uint64_t desc_a, uint64_t desc_b,   \
                                              int scale_d) {                                     \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"                                     \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" WG_R##R           \
                 "}, %0, %1, p, 1, 1, 0, 1;\n}\n"                                                \
                 : "+l"(desc_a), "+l"(desc_b), "+r"(scale_d), WG_D##R);                          \
  }
WG_MMA_MN(8, 4)
WG_MMA_MN(16, 8)
WG_MMA_MN(24, 12)
WG_MMA_MN(32, 16)
WG_MMA_MN(40, 20)
WG_MMA_MN(48, 24)
WG_MMA_MN(56, 28)
WG_MMA_MN(64, 32)
WG_MMA_MN(128, 64)
WG_MMA_MN(192, 96)
#undef WG_MMA_MN

}  // namespace wg
