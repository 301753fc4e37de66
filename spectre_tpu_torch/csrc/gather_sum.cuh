// gather_sum: the device code shared by block_gather_sum.cu and
// inverse_gather_sum.cu, the two backwards of the permutation mix.
//
//   out[c*L + i] = sum_h g[(h*nc + idx[h, c])*L + i]      c < nc, i < L
//
// g is [H*nc*L] elements, idx int32 [H, nc], out [nc*L]; a "chunk" is L
// contiguous elements (L = blk*B for a block table, L = B for single rows).
// Each of the H source chunks of an output chunk is contiguous in g, so the
// kernel reads 16-byte vectors, adds them in float32 registers in head order
// 0..H-1, casts once and stores. The sum order is fixed, so the result does
// not change from run to run and equals a sequential float32 sum bit for bit.
//
// What bounds it on the H100: bytes. Every element of g is read once
// (H times the output), nothing is reused, so the floor is
// (H + 1) * nc * L * sizeof(T) over the memory rate. The design keeps many
// loads in flight: a thread owns one output vector and issues its source
// loads eight heads at a time before it adds them (streaming loads, since g
// is far larger than L2 and read once). Long chunks put the chunk on grid x
// and the 4 KB part of it on grid y, the launch shape that runs fastest for
// the forward copy (block_scatter_rows.cu); chunks shorter than a block
// share one block, so single 512-byte rows still fill every thread. When the
// chunk size or a base pointer is not 16-byte aligned the unit is one
// element instead of a vector.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gather_sum {
namespace {  // internal linkage: two sources include this file

constexpr int kThreads = 256;
constexpr int kHeadsInFlight = 8;
constexpr long long kMaxParts = 65535;  // grid y limit; parts loop beyond it

// Unit<V, T>: V is what one load moves (uint4 or T), holding N values of T.
template <typename V, typename T>
struct Unit {
  static constexpr int N = sizeof(V) / sizeof(T);
};

__device__ __forceinline__ uint4 load_unit(const uint4* p) { return __ldcs(p); }
__device__ __forceinline__ float load_unit(const float* p) { return __ldcs(p); }
__device__ __forceinline__ unsigned short load_unit(const unsigned short* p) { return __ldcs(p); }

// add the values of one unit to acc
__device__ __forceinline__ void add_unit(float* acc, uint4 v, const float*) {
  acc[0] += __uint_as_float(v.x);
  acc[1] += __uint_as_float(v.y);
  acc[2] += __uint_as_float(v.z);
  acc[3] += __uint_as_float(v.w);
}
__device__ __forceinline__ void add_unit(float* acc, uint4 v, const __nv_bfloat16*) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // bf16 -> f32 is a 16-bit shift
    acc[2 * k] += __uint_as_float(w[k] << 16);
    acc[2 * k + 1] += __uint_as_float(w[k] & 0xffff0000u);
  }
}
__device__ __forceinline__ void add_unit(float* acc, float v, const float*) { acc[0] += v; }
__device__ __forceinline__ void add_unit(float* acc, unsigned short v, const __nv_bfloat16*) {
  acc[0] += __uint_as_float(static_cast<unsigned>(v) << 16);
}

__device__ __forceinline__ unsigned bf16_bits(float v) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
}
__device__ __forceinline__ void store_unit(uint4* p, const float* acc, const float*) {
  *p = make_uint4(__float_as_uint(acc[0]), __float_as_uint(acc[1]), __float_as_uint(acc[2]),
                  __float_as_uint(acc[3]));
}
__device__ __forceinline__ void store_unit(uint4* p, const float* acc, const __nv_bfloat16*) {
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) w[k] = bf16_bits(acc[2 * k]) | (bf16_bits(acc[2 * k + 1]) << 16);
  *p = make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void store_unit(float* p, const float* acc, const float*) { *p = acc[0]; }
__device__ __forceinline__ void store_unit(unsigned short* p, const float* acc,
                                           const __nv_bfloat16*) {
  *p = static_cast<unsigned short>(bf16_bits(acc[0]));
}

// units: units per chunk. cpb: chunks per block (1 when units >= kThreads).
template <typename V, typename T>
__global__ void __launch_bounds__(kThreads)
gather_sum_kernel(const V* __restrict__ g, const int* __restrict__ idx, V* __restrict__ out,
                  int heads, long long nc, long long units, int cpb) {
  constexpr int N = Unit<V, T>::N;
  long long chunk, first, step;
  if (cpb == 1) {
    chunk = blockIdx.x;
    first = static_cast<long long>(blockIdx.y) * kThreads + threadIdx.x;
    step = static_cast<long long>(gridDim.y) * kThreads;
  } else {  // several short chunks in one block; one unit per thread
    const int local = threadIdx.x / static_cast<int>(units);
    chunk = static_cast<long long>(blockIdx.x) * cpb + local;
    first = threadIdx.x - local * units;
    step = units;
    if (local >= cpb || chunk >= nc) return;
  }
  for (long long i = first; i < units; i += step) {
    float acc[N];
#pragma unroll
    for (int k = 0; k < N; ++k) acc[k] = 0.f;
    for (int h0 = 0; h0 < heads; h0 += kHeadsInFlight) {
      V v[kHeadsInFlight];
#pragma unroll
      for (int k = 0; k < kHeadsInFlight; ++k) {
        if (h0 + k < heads) {
          long long src = idx[(h0 + k) * nc + chunk];
          // out-of-range indices clamp, as the TPU path's take(mode="clip")
          // does; the model validates its tables before they reach here
          src = src < 0 ? 0 : (src >= nc ? nc - 1 : src);
          v[k] = load_unit(g + ((h0 + k) * nc + src) * units + i);
        }
      }
#pragma unroll
      for (int k = 0; k < kHeadsInFlight; ++k)
        if (h0 + k < heads) add_unit(acc, v[k], static_cast<const T*>(nullptr));
    }
    store_unit(out + chunk * units + i, acc, static_cast<const T*>(nullptr));
  }
}

template <typename V, typename T>
void launch(const void* g, const int* idx, void* out, int heads, long long nc,
            long long chunk_bytes, cudaStream_t st) {
  const long long units = chunk_bytes / static_cast<long long>(sizeof(V));
  dim3 grid;
  int cpb = 1;
  if (units >= kThreads) {
    long long parts = (units + kThreads - 1) / kThreads;
    parts = parts < kMaxParts ? parts : kMaxParts;
    grid = dim3(static_cast<unsigned>(nc), static_cast<unsigned>(parts));
  } else {
    cpb = static_cast<int>(kThreads / units);
    grid = dim3(static_cast<unsigned>((nc + cpb - 1) / cpb));
  }
  gather_sum_kernel<V, T><<<grid, kThreads, 0, st>>>(
      static_cast<const V*>(g), idx, static_cast<V*>(out), heads, nc, units, cpb);
}

// elem_bytes: 2 (bf16) or 4 (f32); chunk_len: elements per chunk.
// Returns cudaGetLastError() after the launch.
inline int run(const void* g, const void* idx, void* out, long long heads, long long nc,
               long long chunk_len, int elem_bytes, void* stream) {
  if (heads <= 0 || nc <= 0 || chunk_len <= 0) return cudaErrorInvalidValue;
  if (elem_bytes != 2 && elem_bytes != 4) return cudaErrorInvalidValue;
  if (nc > 0x7fffffffLL || heads > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long chunk_bytes = chunk_len * elem_bytes;
  const bool vec = chunk_bytes % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* table = static_cast<const int*>(idx);
  const int h = static_cast<int>(heads);
  if (elem_bytes == 2) {
    if (vec) launch<uint4, __nv_bfloat16>(g, table, out, h, nc, chunk_bytes, st);
    else launch<unsigned short, __nv_bfloat16>(g, table, out, h, nc, chunk_bytes, st);
  } else {
    if (vec) launch<uint4, float>(g, table, out, h, nc, chunk_bytes, st);
    else launch<float, float>(g, table, out, h, nc, chunk_bytes, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace gather_sum
