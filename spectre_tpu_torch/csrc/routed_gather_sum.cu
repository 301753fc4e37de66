// routed_gather_sum: the permutation-mix backward through 3-stage Clos
// route tables, as the TPU kernel computes it.
//
//   dxt[j, :] = sum_h g[h*d + inv[h, j], :]        g [H*d, B], dxt [d, B]
//
// with inv given by its route (spectre_tpu_torch/ops/routing.py): over the
// [r, c] view of the d rows (j = q*c + s), for head h
//
//   t = c_idx[h, q, s]   p = b_idx[h, q, t]   inv[h, j] = p*c + a_idx[h, p, t]
//
// a_idx, b_idx, c_idx int32 [H, r, c]. The sum runs in head order in the
// data type, rounded after every head: o = y_0, then o = o + y_h for
// h = 1..H-1. In bf16 that is the bf16 chain of the TPU kernel's output
// block (each add in float32, rounded to bf16), not kernel 4's float32 sum
// with one cast; in float32 the two are the same.
//
// Replaces the TPU kernel spectre_tpu/ops/pallas/routed_gather.py::
// routed_gather_sum_pallas. That kernel exists to avoid the TPU's (8, 128)
// tiling of device memory: it applies the three stages as one-hot products on
// the matrix unit, so that g streams through fast memory in whole tiles. On
// this card a row is B contiguous values and is read directly, so none of the
// one-hot work comes over: the three stages compose into one source row per
// (head, output row), resolved here from the same tables the TPU kernel
// takes.
//
// What bounds it on the H100: bytes. Every row of g is read once (H times the
// output), the output written once, and the 3*H*d*4 bytes of tables read
// once (6.4 MB at the flagship, which stays in L2). The design: a block owns
// a run of output rows. First its threads resolve the H source rows of each
// of them (three dependent 4-byte loads each) into shared memory; then, as
// in gather_sum.cuh, a thread owns one 16-byte vector of an output row and
// issues the loads of eight heads at a time before it adds them (streaming
// loads: g is far larger than L2 and is read once). Rows shorter than a block
// share one; longer rows loop. When a row or a base pointer is not 16-byte
// aligned the unit is one element instead of a vector.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHeadsInFlight = 8;

template <typename V, typename T>
struct Unit {
  static constexpr int N = sizeof(V) / sizeof(T);
};

__device__ __forceinline__ uint4 load_unit(const uint4* p) { return __ldcs(p); }
__device__ __forceinline__ float load_unit(const float* p) { return __ldcs(p); }
__device__ __forceinline__ unsigned short load_unit(const unsigned short* p) { return __ldcs(p); }

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// unpack one unit into float values
__device__ __forceinline__ void unpack(float* x, uint4 v, const float*) {
  x[0] = __uint_as_float(v.x);
  x[1] = __uint_as_float(v.y);
  x[2] = __uint_as_float(v.z);
  x[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(float* x, uint4 v, const __nv_bfloat16*) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // bf16 -> f32 is a 16-bit shift
    x[2 * k] = __uint_as_float(w[k] << 16);
    x[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(float* x, float v, const float*) { x[0] = v; }
__device__ __forceinline__ void unpack(float* x, unsigned short v, const __nv_bfloat16*) {
  x[0] = __uint_as_float(static_cast<unsigned>(v) << 16);
}

// o = o + y in the data type: a float32 add, then (bf16) round to bf16
__device__ __forceinline__ void chain_add(float& o, float y, const float*) { o = __fadd_rn(o, y); }
__device__ __forceinline__ void chain_add(float& o, float y, const __nv_bfloat16*) {
  o = bf16_round(__fadd_rn(o, y));
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

__device__ __forceinline__ int clampi(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

// units: units per row. rpb: output rows per block. Dynamic shared memory:
// rpb * heads ints, the absolute source row of each (row, head).
template <typename V, typename T>
__global__ void __launch_bounds__(kThreads)
routed_gather_sum_kernel(const V* __restrict__ g, const int* __restrict__ a_idx,
                         const int* __restrict__ b_idx, const int* __restrict__ c_idx,
                         V* __restrict__ out, int heads, int r, int c, long long units, int rpb) {
  extern __shared__ int src[];
  constexpr int N = Unit<V, T>::N;
  const long long d = static_cast<long long>(r) * c;
  const long long row0 = static_cast<long long>(blockIdx.x) * rpb;

  // index phase: the H source rows of each of this block's output rows
  for (int i = threadIdx.x; i < rpb * heads; i += kThreads) {
    const int local = i / heads, h = i - local * heads;
    const long long j = row0 + local;
    if (j >= d) continue;
    const int q = static_cast<int>(j / c), s = static_cast<int>(j - static_cast<long long>(q) * c);
    const long long base = static_cast<long long>(h) * d;
    // out-of-range entries clamp; the tables are built and checked on the host
    const int t = clampi(c_idx[base + static_cast<long long>(q) * c + s], c - 1);
    const int p = clampi(b_idx[base + static_cast<long long>(q) * c + t], r - 1);
    const int a = clampi(a_idx[base + static_cast<long long>(p) * c + t], c - 1);
    src[i] = h * static_cast<int>(d) + p * c + a;
  }
  __syncthreads();

  // copy phase: thread -> (row, unit)
  int local;
  long long first, step;
  if (rpb == 1) {
    local = 0;
    first = threadIdx.x;
    step = kThreads;
  } else {
    local = threadIdx.x / static_cast<int>(units);
    first = threadIdx.x - static_cast<long long>(local) * units;
    step = units;
    if (local >= rpb) return;
  }
  const long long j = row0 + local;
  if (j >= d) return;
  const int* rows = src + local * heads;
  for (long long u = first; u < units; u += step) {
    float acc[N];
    for (int h0 = 0; h0 < heads; h0 += kHeadsInFlight) {
      V v[kHeadsInFlight];
#pragma unroll
      for (int k = 0; k < kHeadsInFlight; ++k)
        if (h0 + k < heads) v[k] = load_unit(g + static_cast<long long>(rows[h0 + k]) * units + u);
#pragma unroll
      for (int k = 0; k < kHeadsInFlight; ++k) {
        if (h0 + k < heads) {
          float y[N];
          unpack(y, v[k], static_cast<const T*>(nullptr));
          if (h0 + k == 0) {
#pragma unroll
            for (int e = 0; e < N; ++e) acc[e] = y[e];
          } else {
#pragma unroll
            for (int e = 0; e < N; ++e) chain_add(acc[e], y[e], static_cast<const T*>(nullptr));
          }
        }
      }
    }
    store_unit(out + j * units + u, acc, static_cast<const T*>(nullptr));
  }
}

template <typename V, typename T>
int launch(const void* g, const int* a, const int* b, const int* cc, void* out, int heads, int r,
           int c, long long row_bytes, cudaStream_t st) {
  const long long units = row_bytes / static_cast<long long>(sizeof(V));
  const long long d = static_cast<long long>(r) * c;
  constexpr int kSmemInts = 48 * 1024 / sizeof(int);  // the static shared-memory limit
  int rpb = units >= kThreads ? 1 : static_cast<int>(kThreads / units);
  if (rpb * heads > kSmemInts) rpb = kSmemInts / heads > 0 ? kSmemInts / heads : 1;
  const long long blocks = (d + rpb - 1) / rpb;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(rpb) * heads * sizeof(int);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;  // more than 12,288 heads
  routed_gather_sum_kernel<V, T><<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
      static_cast<const V*>(g), a, b, cc, static_cast<V*>(out), heads, r, c, units, rpb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g [heads*r*c, batch], tables int32 [heads, r, c], out [r*c, batch];
// elem_bytes: 2 (bf16) or 4 (f32). Returns cudaGetLastError() after launch.
extern "C" int routed_gather_sum(const void* g, const void* a_idx, const void* b_idx,
                                 const void* c_idx, void* out, long long heads, long long r,
                                 long long c, long long batch, int elem_bytes, void* stream) {
  if (heads <= 0 || r <= 0 || c <= 0 || batch <= 0) return cudaErrorInvalidValue;
  if (elem_bytes != 2 && elem_bytes != 4) return cudaErrorInvalidValue;
  if (heads * r * c > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long row_bytes = batch * elem_bytes;
  const bool vec = row_bytes % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const int*>(a_idx);
  const auto* b = static_cast<const int*>(b_idx);
  const auto* cc = static_cast<const int*>(c_idx);
  const int h = static_cast<int>(heads), rr = static_cast<int>(r), ci = static_cast<int>(c);
  if (elem_bytes == 2) {
    if (vec) return launch<uint4, __nv_bfloat16>(g, a, b, cc, out, h, rr, ci, row_bytes, st);
    return launch<unsigned short, __nv_bfloat16>(g, a, b, cc, out, h, rr, ci, row_bytes, st);
  }
  if (vec) return launch<uint4, float>(g, a, b, cc, out, h, rr, ci, row_bytes, st);
  return launch<float, float>(g, a, b, cc, out, h, rr, ci, row_bytes, st);
}
