// hadamard: the Walsh-Hadamard butterfly shared by fwht.cu and
// structured_mix.cu.
//
// Natural (Sylvester) order: stage h = 1, 2, 4, ... turns every pair
// (a, b) = (v[i], v[i + h]), i with bit h clear, into (a + b, a - b). That is
// the order of spectre_tpu/ops/hadamard.py::fwht, so a float32 butterfly here
// adds the same pairs in the same order as the plain PyTorch version and the
// two agree bit for bit. Only additions happen in a stage; the n^-1/2 scale
// is one multiply after the last stage.
//
// A thread holds 2^R values in registers (R stages without any exchange,
// butterfly_regs); stages between lanes of a warp go by __shfl_xor_sync
// (butterfly_lanes); stages across warps go through shared memory, in the
// caller.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hadamard {
namespace {  // internal linkage: two sources include this file

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// R stages on the 2^R values of v: stage s pairs v[k] with v[k | 1 << s].
template <int R>
__device__ __forceinline__ void butterfly_regs(float* v) {
#pragma unroll
  for (int s = 0; s < R; ++s) {
#pragma unroll
    for (int k = 0; k < (1 << R); ++k) {
      if ((k & (1 << s)) == 0) {
        const float a = v[k], b = v[k | (1 << s)];
        v[k] = a + b;
        v[k | (1 << s)] = a - b;
      }
    }
  }
}

// One stage between lanes: the partner of a lane is lane ^ lane_mask, and the
// lane whose bit is clear holds `a`. Every lane of the warp must call it.
template <int E>
__device__ __forceinline__ void butterfly_lanes(float* v, int lane_mask, bool upper) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float other = __shfl_xor_sync(0xffffffffu, v[e], lane_mask);
    v[e] = upper ? other - v[e] : v[e] + other;
  }
}

// Eight consecutive values as 16-byte vectors; p must be 16-byte aligned.
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // bf16 -> f32 is a 16-bit shift
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}
__device__ __forceinline__ void store8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ unsigned bf16_bits(float v) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) w[k] = bf16_bits(v[2 * k]) | (bf16_bits(v[2 * k + 1]) << 16);
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// E consecutive values, as vectors when E == 8 and vec says p is aligned.
template <typename T, int E>
__device__ __forceinline__ void load_vals(const T* p, float* v, bool vec) {
  if constexpr (E == 8) {
    if (vec) {
      load8(p, v);
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) v[e] = to_f(p[e]);
}
template <typename T, int E>
__device__ __forceinline__ void store_vals(T* p, const float* v, bool vec) {
  if constexpr (E == 8) {
    if (vec) {
      store8(p, v);
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) p[e] = from_f<T>(v[e]);
}

}  // namespace
}  // namespace hadamard
