// fwht: the Walsh-Hadamard transform of the last axis, natural order,
//
//   out[m, :] = scale * H_n x[m, :]          x [M, n], n a power of two,
//
// scale = n^-1/2 when normalised, else 1. Replaces the TPU kernel
// spectre_tpu/ops/pallas/fwht.py::fwht_pallas. That kernel is one product
// with the dense H_128 plus log2(n / 128) stages of adds, a form that exists
// because the TPU has a 128 x 128 matrix unit; here it is the butterfly.
//
// What bounds it on the H100: bytes. Each element is read once and written
// once, and n log2(n) additions per row are far below the float32 rate, so
// the floor is 2 * M * n * sizeof(T) over the memory rate.
//
// Every stage adds the same float32 pairs in the same order as the plain
// version (csrc/hadamard.cuh, ops/kernels/fwht.py), h = 1, 2, 4, ... in turn,
// so the two agree bit for bit. Two designs, by n:
//
// n <= 32 E (E = 16 / sizeof(T) values in a 16-byte vector: 256 in bf16,
// 128 in float32, up to 1,024 with C chunks a lane): one warp a tile of
// 32 E C consecutive values, no shared memory and no barrier. Lane l holds
// C vectors, chunk c at c * 32 E + l E, so that each load and each store of
// the warp is 512 contiguous bytes. Stages h < E run in registers inside a
// vector; stages E <= h < 32 E pair lanes l and l ^ (h / E) by
// __shfl_xor_sync; stages h >= 32 E (n = 512 and 1,024 in bf16) pair the
// chunks of one lane in registers. Shorter rows lie side by side in a tile.
//
// n > 1,024: a block transforms one row in shared memory, n <= 32,768 (128
// KB, raised once per device with cudaFuncSetAttribute). A thread loads
// eight consecutive values as 16-byte vectors and runs the stages h = 1, 2, 4
// in registers; the remaining stages run three at a time (radix 8: a thread
// reads eight values h apart, does three stages in registers and writes them
// back), with one block barrier per pass; the last pass is followed by the
// scale, one cast and a vector store of eight consecutive values.
//
// A ragged last tile is zero-filled and masked; unaligned bases go element
// by element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "hadamard.cuh"

namespace {

using hadamard::butterfly_regs;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kMaxN = 32768;
constexpr long long kMaxWarpN = 1024;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxDevices = 16;

// ---- n <= 1,024: a warp a tile -------------------------------------------

// One 16-byte vector of E = 16 / sizeof(T) values; p 16-byte aligned.
__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* v) { hadamard::load8(p, v); }
__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* v) {
  hadamard::store8(p, v);
}

// E consecutive values from p + at (one vector when vec), zeros past total.
template <typename T, int E>
__device__ __forceinline__ void load_chunk(const T* p, long long at, long long total, float* v,
                                           bool vec) {
  if (vec && at + E <= total) {
    load16(p + at, v);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = at + e < total ? hadamard::to_f(p[at + e]) : 0.f;
  }
}

template <typename T, int E>
__device__ __forceinline__ void store_chunk(T* p, long long at, long long total, const float* v,
                                            bool vec) {
  if (vec && at + E <= total) {
    store16(p + at, v);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (at + e < total) p[at + e] = hadamard::from_f<T>(v[e]);
  }
}

// C chunks of E values a lane; n <= 32 E when C == 1, else n == 32 E C.
template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
fwht_warp_kernel(const T* __restrict__ x, T* __restrict__ out, long long total, int n,
                 float scale, int vec) {
  constexpr int E = 16 / sizeof(T);
  constexpr int kTile = 32 * E * C;
  const int lane = threadIdx.x & 31;
  const long long tile = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const long long base = tile * kTile;
  if (base >= total) return;  // the whole warp: shuffles below need every lane

  float v[C][E];
#pragma unroll
  for (int c = 0; c < C; ++c) load_chunk<T, E>(x, base + c * 32 * E + lane * E, total, v[c], vec);

  // h < min(n, E): inside a vector; rows shorter than E lie side by side in it
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (n >= E) {
      butterfly_regs<E == 8 ? 3 : 2>(v[c]);
    } else if (n == 4) {  // bf16 only (E == 8)
      butterfly_regs<2>(v[c]);
      butterfly_regs<2>(v[c] + 4);
    } else if (n == 2) {
#pragma unroll
      for (int e = 0; e < E; e += 2) butterfly_regs<1>(v[c] + e);
    }
  }
  // E <= h < min(n, 32 E): between lanes
  for (int h = E; h < n && h < 32 * E; h <<= 1) {
    const int mask = h / E;
    hadamard::butterfly_lanes<C * E>(&v[0][0], mask, (lane & mask) != 0);
  }
  // h >= 32 E: between the chunks of a lane (C > 1 only when n == 32 E C)
#pragma unroll
  for (int s = 1; s < C; s <<= 1) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if ((c & s) == 0) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float a = v[c][e], b = v[c | s][e];
          v[c][e] = a + b;
          v[c | s][e] = a - b;
        }
      }
    }
  }

#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int e = 0; e < E; ++e) v[c][e] *= scale;
    store_chunk<T, E>(out, base + c * 32 * E + lane * E, total, v[c], vec);
  }
}

template <typename T, int C>
int launch_warp(const T* x, T* out, long long total, long long n, float scale, int vec,
                cudaStream_t st) {
  constexpr long long kTile = 32 * (16 / sizeof(T)) * C;
  const long long tiles = (total + kTile - 1) / kTile;
  const long long blocks = (tiles + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  fwht_warp_kernel<T, C><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      x, out, total, static_cast<int>(n), scale, vec);
  return static_cast<int>(cudaGetLastError());
}

// ---- n > 1,024: a block a row in shared memory ----------------------------

// R stages of stride h, 2h, ... on the row in shared memory.
template <int R>
__device__ __forceinline__ void smem_pass(float* s, int n, int h) {
  const int groups = n >> R;
  for (int g = threadIdx.x; g < groups; g += kThreads) {
    const int i0 = (g / h) * (h << R) + (g % h);
    float v[1 << R];
#pragma unroll
    for (int k = 0; k < (1 << R); ++k) v[k] = s[i0 + k * h];
    butterfly_regs<R>(v);
#pragma unroll
    for (int k = 0; k < (1 << R); ++k) s[i0 + k * h] = v[k];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fwht_smem_kernel(const T* __restrict__ x, T* __restrict__ out, int n, float scale, int vec) {
  extern __shared__ __align__(16) float s[];
  const long long base = static_cast<long long>(blockIdx.x) * n;
  const int groups = n / 8;

  for (int g = threadIdx.x; g < groups; g += kThreads) {
    float v[8];
    hadamard::load_vals<T, 8>(x + base + g * 8, v, vec != 0);
    butterfly_regs<3>(v);
    hadamard::store8(s + g * 8, v);
  }
  __syncthreads();

  for (int h = 8; h < n;) {
    const int left = n / h;
    if (left >= 8) {
      smem_pass<3>(s, n, h);
      h <<= 3;
    } else if (left == 4) {
      smem_pass<2>(s, n, h);
      h <<= 2;
    } else {
      smem_pass<1>(s, n, h);
      h <<= 1;
    }
    __syncthreads();
  }

  for (int g = threadIdx.x; g < groups; g += kThreads) {
    float v[8];
    hadamard::load8(s + g * 8, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] *= scale;
    hadamard::store_vals<T, 8>(out + base + g * 8, v, vec != 0);
  }
}

// Whether an instance may take kMaxN floats of shared memory on a device:
// set on its first launch there that needs more than the default.
template <typename T>
std::atomic<bool> smem_raised[kMaxDevices];

template <typename T>
int launch_smem(const T* x, T* out, long long total, long long n, float scale, int vec,
                cudaStream_t st) {
  const long long rows = total / n;
  if (rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int smem = static_cast<int>(n * sizeof(float));
  auto kern = fwht_smem_kernel<T>;
  if (smem > kDefaultSmem) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (!smem_raised<T>[dev].load(std::memory_order_acquire)) {
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kMaxN * sizeof(float)));
      if (e != cudaSuccess) return static_cast<int>(e);
      smem_raised<T>[dev].store(true, std::memory_order_release);
    }
  }
  kern<<<static_cast<unsigned>(rows), kThreads, smem, st>>>(x, out, static_cast<int>(n), scale,
                                                             vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* xv, void* outv, long long total, long long n, float scale,
           cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  T* out = static_cast<T*>(outv);
  const int vec =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  constexpr long long E = 16 / sizeof(T);
  if (n > kMaxWarpN) return launch_smem<T>(x, out, total, n, scale, vec, st);
  switch (n <= 32 * E ? 1 : n / (32 * E)) {
    case 1: return launch_warp<T, 1>(x, out, total, n, scale, vec, st);
    case 2: return launch_warp<T, 2>(x, out, total, n, scale, vec, st);
    case 4: return launch_warp<T, 4>(x, out, total, n, scale, vec, st);
    case 8:
      if constexpr (E == 4) return launch_warp<T, 8>(x, out, total, n, scale, vec, st);
      break;
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x, out: [total / n, n] contiguous; elem_bytes: 2 (bf16) or 4 (f32).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int fwht(const void* x, void* out, long long total, long long n, float scale,
                    int elem_bytes, void* stream) {
  if (total <= 0 || n <= 0 || n > kMaxN || (n & (n - 1)) != 0 || total % n != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) return launch<float>(x, out, total, n, scale, st);
  if (elem_bytes == 2) return launch<__nv_bfloat16>(x, out, total, n, scale, st);
  return cudaErrorInvalidValue;
}
