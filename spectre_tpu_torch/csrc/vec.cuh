// Vectors of float32 or bf16 values as kernel B3's row kernels load and
// store them (fused_spectre_linear.cu, fused_spectre_linear_bwd.cu): V
// consecutive values in one access of V * sizeof(T) bytes (2 to 16, the
// address aligned to it), converted to and from float32 in registers, and
// the sum across a team of lanes.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// The sum over a team of `lanes` lanes (aligned groups of a power of two):
// partners add the same two values, so every lane holds the same bits.
__device__ __forceinline__ float team_sum(float v, int lanes) {
  for (int o = 1; o < lanes; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int B>
struct RawOf;
template <>
struct RawOf<16> { using type = uint4; };
template <>
struct RawOf<8> { using type = uint2; };
template <>
struct RawOf<4> { using type = unsigned; };
template <>
struct RawOf<2> { using type = unsigned short; };

// V values of T as they lie in memory: one load of V * sizeof(T) bytes.
template <typename T, int V>
using Raw = typename RawOf<V * static_cast<int>(sizeof(T))>::type;

// V values of T from 4-byte words (bf16 -> f32 is a 16-bit shift).
template <typename T, int V>
__device__ __forceinline__ void unpack(const unsigned* w, float* v) {
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int k = 0; k < V / 2; ++k) {
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = __uint_as_float(w[k]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void raw_to_f(const Raw<T, V>& r, float* v) {
  constexpr int kBytes = V * static_cast<int>(sizeof(T));
  if constexpr (kBytes == 16) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
    unpack<T, V>(w, v);
  } else if constexpr (kBytes == 8) {
    const unsigned w[2] = {r.x, r.y};
    unpack<T, V>(w, v);
  } else if constexpr (kBytes == 4) {
    const unsigned w[1] = {r};
    unpack<T, V>(w, v);
  } else {
    v[0] = __uint_as_float(static_cast<unsigned>(r) << 16);  // one bf16
  }
}

// V consecutive values at p (global or shared) in one load of V * sizeof(T)
// bytes, p aligned to it.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float* v) {
  raw_to_f<T, V>(*reinterpret_cast<const Raw<T, V>*>(p), v);
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float* v) {
  constexpr int kBytes = V * static_cast<int>(sizeof(T));
  if constexpr (kBytes < 4) {
    *p = from_f<T>(v[0]);
  } else {
    unsigned w[kBytes / 4];
    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int k = 0; k < kBytes / 4; ++k)
        w[k] = static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * k]))) |
               (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * k + 1])))
                << 16);
    } else {
#pragma unroll
      for (int k = 0; k < kBytes / 4; ++k) w[k] = __float_as_uint(v[k]);
    }
    if constexpr (kBytes == 16) {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (kBytes == 8) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else {
      *reinterpret_cast<unsigned*>(p) = w[0];
    }
  }
}

}  // namespace
