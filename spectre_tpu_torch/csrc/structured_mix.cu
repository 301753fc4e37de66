// structured_mix: the tile-structured mix, forward and backward.
//
//   forward   out[b, h*d + j*t + s] = signs[h, j*t + s] * t^-1/2 * (x[b, src*t : +t] H_t)[s]
//             with src = tile_perms[h, j];   x [B, d] batch-major -> out [B, H*d]
//   backward  dx[b, src*t : +t] = t^-1/2 * (sum_h signs[h, j_h*t : +t] * g[b, h*d + j_h*t : +t]) H_t
//             with j_h the tile of head h that reads src (tile_perms[h, j_h] = src)
//
// d = T*t, tile_perms [H, T] holds one permutation of the T tiles per head,
// H_t is the unnormalised Hadamard matrix. Replaces the TPU kernel
// spectre_tpu/ops/pallas/structured_mix.py::structured_mix_pallas (forward;
// its backward is jnp there and a second kernel here). The TPU kernel is a
// [t, t] product per (head, tile) on the matrix unit with the signs applied
// outside; x H_t is a length-t Walsh-Hadamard transform, so here it is the
// butterfly of csrc/hadamard.cuh, and the signs ride in the same pass.
//
// What bounds it on the H100: bytes. The forward reads B*d and writes H*B*d
// elements, the backward the reverse; a tile's butterfly is t log2(t)
// additions. Both kernels are organised by SOURCE tile, not by output tile:
// the transform of x[b, src] does not depend on the head, so the forward
// transforms each source tile once and stores it H times, each time with
// that head's signs, at the place the inverse table inv[h, src] = j_h names;
// the backward adds the H signed cotangent tiles in head order in float32
// and transforms the sum once (the transform is linear). So the butterfly
// costs 1/H of what a per-output-tile kernel would pay, and what remains is
// the stream of 16-byte loads and stores. A block loads its own entries of
// inv; the signs (H*d values) stay in L1/L2.
//
// A tile is held by t/8 neighbouring lanes of a warp, eight values each
// (one value-vector per lane): three stages in registers, the rest by
// __shfl_xor_sync, no shared memory. t < 8 puts the whole tile in one
// thread. t goes up to 256 (32 lanes). Any B >= 1: a block walks batch rows,
// and rows past B only take part in the shuffles. The float32 arithmetic is
// that of the plain versions (butterfly, scale, sign; head-order sum), so
// kernel and plain version agree bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hadamard.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr long long kMaxTile = 256;

// The butterfly of one tile spread over `lanes` neighbouring lanes, 2^R
// values each, then the scale. Every lane of the warp must call it.
template <int R>
__device__ __forceinline__ void tile_fwht(float* v, int lanes, int l, float scale) {
  constexpr int E = 1 << R;
  hadamard::butterfly_regs<R>(v);
  for (int m = 1; m < lanes; m <<= 1) hadamard::butterfly_lanes<E>(v, m, (l & m) != 0);
#pragma unroll
  for (int e = 0; e < E; ++e) v[e] *= scale;
}

// grid x: source tile; grid y: a slice of the batch rows.
template <typename T, int R, bool FWD>
__global__ void __launch_bounds__(kThreads)
structured_mix_kernel(const T* __restrict__ in, const int* __restrict__ inv,
                      const T* __restrict__ signs, T* __restrict__ out, int B, int H,
                      int n_tiles, int t, float scale, int vec) {
  constexpr int E = 1 << R;
  const int lanes = t / E;                 // lanes per tile, a power of two <= 32
  const int per_block = kThreads / lanes;  // tiles a block transforms at once
  const int group = threadIdx.x / lanes, l = threadIdx.x % lanes;
  const int src = blockIdx.x;
  const long long d = static_cast<long long>(n_tiles) * t;
  const long long hd = d * H;
  const bool v16 = vec != 0;
  for (int b0 = blockIdx.y * per_block; b0 < B; b0 += gridDim.y * per_block) {
    const int b = b0 + group;
    const bool valid = b < B;
    float v[E];
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = 0.f;
    if (FWD) {
      if (valid) hadamard::load_vals<T, E>(in + b * d + static_cast<long long>(src) * t + l * E, v, v16);
    } else if (valid) {
#pragma unroll 4
      for (int h = 0; h < H; ++h) {
        const long long off =
            (static_cast<long long>(h) * n_tiles + inv[h * n_tiles + src]) * t + l * E;
        float g[E], sg[E];
        hadamard::load_vals<T, E>(in + b * hd + off, g, v16);
        hadamard::load_vals<T, E>(signs + off, sg, v16);
#pragma unroll
        for (int e = 0; e < E; ++e) v[e] += g[e] * sg[e];
      }
    }
    tile_fwht<R>(v, lanes, l, scale);
    if (!valid) continue;
    if (FWD) {
      for (int h = 0; h < H; ++h) {
        const long long off =
            (static_cast<long long>(h) * n_tiles + inv[h * n_tiles + src]) * t + l * E;
        float sg[E], y[E];
        hadamard::load_vals<T, E>(signs + off, sg, v16);
#pragma unroll
        for (int e = 0; e < E; ++e) y[e] = v[e] * sg[e];
        hadamard::store_vals<T, E>(out + b * hd + off, y, v16);
      }
    } else {
      hadamard::store_vals<T, E>(out + b * d + static_cast<long long>(src) * t + l * E, v, v16);
    }
  }
}

template <typename T, int R, bool FWD>
int launch(const void* in, const void* inv, const void* signs, void* out, long long B,
           long long H, long long n_tiles, long long t, float scale, cudaStream_t st) {
  const int lanes = static_cast<int>(t >> R);
  const int per_block = kThreads / lanes;
  long long slices = (B + per_block - 1) / per_block;
  slices = slices < 65535 ? slices : 65535;
  const dim3 grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(slices));
  const int vec = ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out) |
                    reinterpret_cast<uintptr_t>(signs)) & 15) == 0;
  structured_mix_kernel<T, R, FWD><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(in), static_cast<const int*>(inv), static_cast<const T*>(signs),
      static_cast<T*>(out), static_cast<int>(B), static_cast<int>(H),
      static_cast<int>(n_tiles), static_cast<int>(t), scale, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool FWD>
int dispatch(const void* in, const void* inv, const void* signs, void* out, long long B,
             long long H, long long n_tiles, long long t, float scale, cudaStream_t st) {
  if (t >= 8) return launch<T, 3, FWD>(in, inv, signs, out, B, H, n_tiles, t, scale, st);
  if (t == 4) return launch<T, 2, FWD>(in, inv, signs, out, B, H, n_tiles, t, scale, st);
  if (t == 2) return launch<T, 1, FWD>(in, inv, signs, out, B, H, n_tiles, t, scale, st);
  return launch<T, 0, FWD>(in, inv, signs, out, B, H, n_tiles, t, scale, st);
}

template <bool FWD>
int run(int dtype_code, const void* in, const void* inv, const void* signs, void* out,
        long long B, long long H, long long n_tiles, long long t, float scale, void* stream) {
  if (B <= 0 || H <= 0 || n_tiles <= 0 || t <= 0 || t > kMaxTile || (t & (t - 1)) != 0 ||
      B > 0x7fffffffLL || H > 0x7fffffffLL || n_tiles > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0)
    return dispatch<float, FWD>(in, inv, signs, out, B, H, n_tiles, t, scale, st);
  if (dtype_code == 1)
    return dispatch<bf16, FWD>(in, inv, signs, out, B, H, n_tiles, t, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16 (x, signs and out in that dtype).
// inv: int32 [H, T], inv[h, tile_perms[h, j]] = j. signs: [H, d].
// Both return cudaGetLastError() after the launch (0 on success).
extern "C" int structured_mix_fwd(int dtype_code, const void* x, const void* inv,
                                  const void* signs, void* out, long long B, long long H,
                                  long long n_tiles, long long t, float scale, void* stream) {
  return run<true>(dtype_code, x, inv, signs, out, B, H, n_tiles, t, scale, stream);
}

// g: [B, H*d] -> dx: [B, d].
extern "C" int structured_mix_bwd(int dtype_code, const void* g, const void* inv,
                                  const void* signs, void* dx, long long B, long long H,
                                  long long n_tiles, long long t, float scale, void* stream) {
  return run<false>(dtype_code, g, inv, signs, dx, B, H, n_tiles, t, scale, stream);
}
