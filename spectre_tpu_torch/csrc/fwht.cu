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
// Design: rows are contiguous, and no stage h < n pairs elements of two
// rows, so a block transforms a flat chunk of max(n, 2048) elements: whole
// rows, however short. A thread loads eight consecutive values as one or two
// 16-byte vectors, widens them to float32 and runs the stages h = 1, 2, 4 in
// registers, then parks them in shared memory. The remaining stages run three
// at a time (radix 8: a thread reads eight values h apart, does three stages
// in registers and writes them back), with one block barrier per pass. After
// the last pass each thread takes its eight consecutive values again,
// multiplies by the scale, casts once and stores a vector. The float32
// butterfly adds the same pairs in the same order as the plain version
// (csrc/hadamard.cuh), so the two agree bit for bit. n goes up to 32,768
// (128 KB of shared memory, raised with cudaFuncSetAttribute); a ragged last
// chunk is zero-filled and masked; unaligned bases go element by element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hadamard.cuh"

namespace {

using hadamard::butterfly_regs;

constexpr int kThreads = 256;
constexpr long long kMinChunk = 2048;
constexpr long long kMaxN = 32768;

// R stages of stride h, 2h, ... on the chunk in shared memory.
template <int R>
__device__ __forceinline__ void smem_pass(float* s, int chunk, int h) {
  const int groups = chunk >> R;
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
fwht_kernel(const T* __restrict__ x, T* __restrict__ out, long long total, int n, int chunk,
            float scale, int vec) {
  extern __shared__ __align__(16) float s[];
  const long long base = static_cast<long long>(blockIdx.x) * chunk;
  const int groups = chunk / 8;

  for (int g = threadIdx.x; g < groups; g += kThreads) {
    const long long at = base + static_cast<long long>(g) * 8;
    float v[8];
    if (at + 8 <= total) {
      hadamard::load_vals<T, 8>(x + at, v, vec != 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = at + e < total ? hadamard::to_f(x[at + e]) : 0.f;
    }
    // the stages h < min(n, 8); shorter rows lie side by side in the eight
    if (n >= 8) {
      butterfly_regs<3>(v);
    } else if (n == 4) {
      butterfly_regs<2>(v);
      butterfly_regs<2>(v + 4);
    } else if (n == 2) {
#pragma unroll
      for (int e = 0; e < 8; e += 2) butterfly_regs<1>(v + e);
    }
    hadamard::store8(s + g * 8, v);
  }
  __syncthreads();

  for (int h = 8; h < n;) {
    const int left = n / h;
    if (left >= 8) {
      smem_pass<3>(s, chunk, h);
      h <<= 3;
    } else if (left == 4) {
      smem_pass<2>(s, chunk, h);
      h <<= 2;
    } else {
      smem_pass<1>(s, chunk, h);
      h <<= 1;
    }
    __syncthreads();
  }

  for (int g = threadIdx.x; g < groups; g += kThreads) {
    const long long at = base + static_cast<long long>(g) * 8;
    if (at >= total) continue;
    float v[8];
    hadamard::load8(s + g * 8, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] *= scale;
    if (at + 8 <= total) {
      hadamard::store_vals<T, 8>(out + at, v, vec != 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (at + e < total) out[at + e] = hadamard::from_f<T>(v[e]);
    }
  }
}

template <typename T>
int launch(const void* x, void* out, long long total, long long n, float scale,
           cudaStream_t st) {
  const long long chunk = n > kMinChunk ? n : kMinChunk;
  const long long blocks = (total + chunk - 1) / chunk;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int smem = static_cast<int>(chunk * sizeof(float));
  auto kern = fwht_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int vec =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  kern<<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<T*>(out), total, static_cast<int>(n),
      static_cast<int>(chunk), scale, vec);
  return static_cast<int>(cudaGetLastError());
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
