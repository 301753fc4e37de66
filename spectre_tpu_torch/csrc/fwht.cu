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
// n > 1,024 (2,048 to 32,768): a block a row, the warp route extended to a
// block. What kept the first design (a block a row in shared memory) at 46%
// of the bound at n = 4,096: four radix-8 passes of the row through shared
// memory, each behind a block barrier, and no load in flight while a block's
// stages ran. Here a thread holds V values (16 up to n = 8,192, a block of
// n / 512 threads: 16 beat 32 at every such n on the card; 32 above): the
// stages inside a vector run in registers, the next five between lanes by
// __shfl_xor_sync, the next between a lane's chunks in registers again, and
// only the stages between warps go through shared memory, in one exchange
// and one barrier a row (two above n = 8,192, with one buffer). The grid is
// persistent: the blocks that fit the card at once, each taking every
// grid-th row, with the next row's vectors loaded into registers while the
// current one transforms (up to n = 16,384; at 32,768 a block of 1,024
// threads has 64 registers a thread and loads its row first).
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
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxDevices = 16;
constexpr int kBlockValues = 16;  // values a thread of the block route holds up to n = 8,192

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

// ---- n > 1,024: a block a row, the row in registers ----------------------

// The index bits of a row of n = 32 V W values, low to high: e (E values of
// a 16-byte vector), lane (5), c (C = V / E chunks), w (W warps). Phase 1:
// thread (w, lane) holds chunk c at w * 32 V + c * 32 E + lane * E, so each
// warp load is 512 contiguous bytes, and runs the stages of e in registers,
// of lane by shuffles and of c in registers. Then one exchange through shared
// memory, and phase 2: thread t holds, for every w, the P = V / W positions
// t P + [0, P) of the w-th segment of 32 V and runs the stages of w in
// registers; the scale, one cast, and P consecutive values stored per w.
// Shared memory goes by 16-byte granules whose low three bits are XORed with
// the next three, so that neither phase's vector accesses meet in a bank.
__device__ __forceinline__ int swizzle(int i) { return i ^ (((i >> 5) & 7) << 2); }

// E = 16 / sizeof(T) values at p as the raw bits of one 16-byte vector, in
// one load when vec, else value by value.
template <typename T>
__device__ __forceinline__ uint4 load_raw(const T* p, int vec) {
  if (vec) return *reinterpret_cast<const uint4*>(p);
  constexpr int E = 16 / sizeof(T);
  unsigned w[4];
  if constexpr (E == 8) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = static_cast<unsigned>(__bfloat16_as_ushort(p[2 * k])) |
             (static_cast<unsigned>(__bfloat16_as_ushort(p[2 * k + 1])) << 16);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = __float_as_uint(p[k]);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T>
__device__ __forceinline__ void unpack16(uint4 u, float* v) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // bf16 -> f32 is a 16-bit shift
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = __uint_as_float(w[k]);
  }
}

// P consecutive values: in vectors of up to 16 bytes when vec (and P *
// sizeof(T) >= 4), else value by value.
template <typename T, int P>
__device__ __forceinline__ void store_run(T* p, const float* v, int vec) {
  constexpr int kBytes = P * static_cast<int>(sizeof(T));
  if constexpr (kBytes >= 4) {
    if (vec) {
      unsigned w[kBytes / 4];
#pragma unroll
      for (int k = 0; k < kBytes / 4; ++k) {
        if constexpr (sizeof(T) == 2) {
          w[k] = hadamard::bf16_bits(v[2 * k]) | (hadamard::bf16_bits(v[2 * k + 1]) << 16);
        } else {
          w[k] = __float_as_uint(v[k]);
        }
      }
      if constexpr (kBytes >= 16) {
#pragma unroll
        for (int k = 0; k < kBytes / 4; k += 4)
          *reinterpret_cast<uint4*>(p + k * 4 / static_cast<int>(sizeof(T))) =
              make_uint4(w[k], w[k + 1], w[k + 2], w[k + 3]);
      } else if constexpr (kBytes == 8) {
        *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
      } else {
        *reinterpret_cast<unsigned*>(p) = w[0];
      }
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < P; ++k) p[k] = hadamard::from_f<T>(v[k]);
}

// P consecutive floats of shared memory at swizzled index i (P a power of two).
template <int P>
__device__ __forceinline__ void load_shared(const float* s, int i, float* v) {
  if constexpr (P >= 4) {
#pragma unroll
    for (int k = 0; k < P; k += 4) {
      const float4 a = *reinterpret_cast<const float4*>(s + swizzle(i + k));
      v[k] = a.x; v[k + 1] = a.y; v[k + 2] = a.z; v[k + 3] = a.w;
    }
  } else if constexpr (P == 2) {
    const float2 a = *reinterpret_cast<const float2*>(s + swizzle(i));
    v[0] = a.x; v[1] = a.y;
  } else {
    v[0] = s[swizzle(i)];
  }
}

template <typename T, int V, int W>
__global__ void __launch_bounds__(32 * W)
fwht_block_kernel(const T* __restrict__ x, T* __restrict__ out, long long rows, float scale,
                  int vec) {
  constexpr int E = 16 / sizeof(T), C = V / E;
  constexpr int kSeg = 32 * V;  // a warp's values
  constexpr int n = kSeg * W;
  constexpr int P = V / W;
  static_assert(C >= 1 && P >= 1, "a thread holds whole vectors and a position of every warp");
  // the next row's vectors in registers while this one transforms (up to
  // 512 threads: 1,024 leaves 64 registers a thread); two buffers of the
  // exchange where they fit beside other blocks, so one barrier a row
  constexpr bool kPrefetch = W <= 16;
  constexpr int kBuffers = n <= 8192 ? 2 : 1;
  extern __shared__ __align__(16) float s[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = threadIdx.x;
  const T* xw = x + warp * kSeg + lane * E;
  uint4 pre[C];
  auto load_row = [&](long long row) {
#pragma unroll
    for (int c = 0; c < C; ++c) pre[c] = load_raw<T>(xw + row * n + c * 32 * E, vec);
  };
  const long long stride = gridDim.x;
  if constexpr (kPrefetch) {
    if (blockIdx.x < rows) load_row(blockIdx.x);
  }
  int buf = 0;
  for (long long row = blockIdx.x; row < rows; row += stride) {
    if constexpr (!kPrefetch) load_row(row);
    float v[C][E];
#pragma unroll
    for (int c = 0; c < C; ++c) unpack16<T>(pre[c], v[c]);
    if constexpr (kPrefetch) {
      if (row + stride < rows) load_row(row + stride);
    }
    // e: in registers; lane: by shuffles; c: in registers
#pragma unroll
    for (int c = 0; c < C; ++c) butterfly_regs<E == 8 ? 3 : 2>(v[c]);
#pragma unroll
    for (int m = 1; m < 32; m <<= 1) hadamard::butterfly_lanes<C * E>(&v[0][0], m, (lane & m) != 0);
#pragma unroll
    for (int sc = 1; sc < C; sc <<= 1) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if ((c & sc) == 0) {
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const float a = v[c][e], b = v[c | sc][e];
            v[c][e] = a + b;
            v[c | sc][e] = a - b;
          }
        }
      }
    }
    float* sb = s + buf * n;
    if (kBuffers == 1 && row != blockIdx.x) __syncthreads();  // the last row's reads are done
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int i = warp * kSeg + c * 32 * E + lane * E;
#pragma unroll
      for (int k = 0; k < E; k += 4)
        *reinterpret_cast<float4*>(sb + swizzle(i + k)) =
            make_float4(v[c][k], v[c][k + 1], v[c][k + 2], v[c][k + 3]);
    }
    __syncthreads();
    // w: in registers, then the scale and the store
    float y[W][P];
#pragma unroll
    for (int w = 0; w < W; ++w) load_shared<P>(sb, w * kSeg + t * P, y[w]);
#pragma unroll
    for (int sw = 1; sw < W; sw <<= 1) {
#pragma unroll
      for (int w = 0; w < W; ++w) {
        if ((w & sw) == 0) {
#pragma unroll
          for (int k = 0; k < P; ++k) {
            const float a = y[w][k], b = y[w | sw][k];
            y[w][k] = a + b;
            y[w | sw][k] = a - b;
          }
        }
      }
    }
#pragma unroll
    for (int w = 0; w < W; ++w) {
#pragma unroll
      for (int k = 0; k < P; ++k) y[w][k] *= scale;
      store_run<T, P>(out + row * n + w * kSeg + t * P, y[w], vec);
    }
    if constexpr (kBuffers == 2) buf ^= 1;
  }
}

constexpr int block_smem(int n) { return (n <= 8192 ? 2 : 1) * n * 4; }

// The grid of an instance on a device, a persistent one: the blocks its SMs
// hold at once, asked once per device (after allowing the instance its shared
// memory where it needs more than the default).
template <typename T, int V, int W>
std::atomic<int> block_grid[kMaxDevices];

template <typename T, int V, int W>
int launch_block(const T* x, T* out, long long total, float scale, int vec, cudaStream_t st) {
  constexpr int n = 32 * V * W;
  const long long rows = total / n;
  auto kern = fwht_block_kernel<T, V, W>;
  constexpr int smem = block_smem(n);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int grid = block_grid<T, V, W>[dev].load(std::memory_order_acquire);
  if (grid == 0) {
    if (smem > kDefaultSmem) {
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, 32 * W, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm <= 0) return cudaErrorInvalidConfiguration;
    grid = per_sm * sms;
    block_grid<T, V, W>[dev].store(grid, std::memory_order_release);
  }
  const long long blocks = rows < grid ? rows : grid;
  kern<<<static_cast<unsigned>(blocks), 32 * W, smem, st>>>(x, out, rows, scale, vec);
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
  // n > 1,024: kBlockValues values a thread up to n = 8,192, 32 above
  constexpr int V = kBlockValues;
  switch (n) {
    case 2048: return launch_block<T, V, 2048 / (32 * V)>(x, out, total, scale, vec, st);
    case 4096: return launch_block<T, V, 4096 / (32 * V)>(x, out, total, scale, vec, st);
    case 8192: return launch_block<T, V, 8192 / (32 * V)>(x, out, total, scale, vec, st);
    case 16384: return launch_block<T, 32, 16>(x, out, total, scale, vec, st);
    case 32768: return launch_block<T, 32, 32>(x, out, total, scale, vec, st);
  }
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
