// flash_attention: softmax attention for short sequences, forward and backward.
//
//   forward   S = q k^T * D^-1/2,  P = softmax(S),  O = (P * pm) v,
//             LSE = rowmax(S) + log(rowsum(exp(S - rowmax(S))))
//   backward  P = exp(S - LSE),  delta = rowsum(dO * O),  dV = (P * pm)^T dO,
//             dP = (dO v^T) * pm,  dS = P * (dP - delta),
//             dQ = dS k * D^-1/2,  dK = dS^T q * D^-1/2
//
// q, k, v, O, dO, dQ, dK, dV are [B, H, N, D] with any strides on B, H and N
// and D contiguous, every row of q, k, v and dO starting on a 16-byte boundary
// and a whole number of 16-byte chunks long (the wrapper refuses anything
// else); LSE is float32 [B, H, N]; pm is null or a float32 [N, N]
// multiplier on P shared by every batch and head (a dropout keep-mask over
// its keep-probability; null computes plain softmax attention). Replaces the
// two TPU kernels of spectre_tpu/ops/pallas/attention.py (_fwd_kernel,
// _bwd_kernel), which take no pm. As there, all arithmetic is float32
// whatever the storage type, results are cast once on store, the backward
// rebuilds P from the saved LSE without reducing the rows again, and neither
// S, P, dP nor dS ever reaches device memory.
//
// What bounds it on the H100: bytes. At N = 65, D = 32 a (batch, head) pair
// needs 0.54 MFLOP forward and 1.35 MFLOP backward on 4 + 8 tensors of 4 KB,
// so at the float32 rate outside the tensor cores the arithmetic takes about
// as long as the memory traffic, and at the tensor-core rate far less.
//
// Design: one thread block owns one (batch, head) pair, as one grid program
// does on the TPU, with its operands widened into shared memory: K (and V in
// the backward) transposed with an odd row stride so that both "lanes walk
// the keys" and "lanes walk the feature columns" are free of bank conflicts.
// A warp owns four query rows at a time: lanes hold the score columns
// (column j = lane + 32 c), row maxima and sums are warp shuffles, the
// normalised row goes to a per-warp strip of shared memory and is read back
// by broadcast for P v with lanes on the feature columns. N = 65 is a
// multiple of no tile: keys are padded to a multiple of 32, a padded column
// gets a score of -inf before the row maximum and so a probability of 0, and
// a ragged row group repeats its last row and stores nothing for it. The
// backward keeps P * pm and dS in shared memory ([N, N] each) because dV and
// dK sum over query rows: phase 1 walks query rows (S, P, dP, dS, dQ), phase
// 2 walks key rows (dV, dK). One block owns both sums whole, so there are no
// atomics and the result does not change from run to run. Products run on
// the float32 pipes; tensor cores (and more than 128 keys or 64 features)
// are later work.
//
// A block first waits for device memory: it loads its three or four matrices
// together, sixteen bytes a thread and matrix, all loads of a chunk started
// before any is used; the backward asks for its rows of O and LSE before the
// products that hide their latency. What the inner loops pay for is
// shared-memory loads, so: operands that are broadcast to the warp (a query
// row, a row of P or dS) are read four values at a time as one 16-byte load;
// the number of score and feature columns a lane holds is a template
// parameter, built for the shapes the configs have (two or three score
// columns with one feature column: N <= 64 or 96 with D <= 32) and once for
// everything else (four and two), so no lane of a config's shape multiplies a
// column that does not exist; and the block has as many warps as divide the
// row groups evenly (nine for 65 rows: 17 groups in two rounds where eight
// warps would need three). Registers are capped so that three
// forward blocks or two backward blocks (what its shared memory allows) fit
// an SM: uncapped, the backward took 0.63 ms where it now takes 0.44 at
// [256, 16, 65, 32] in bf16 on an H100. What is left is the shared-memory
// pipe: four or eight rows a warp, and scalar or 16-byte broadcast loads,
// moved the forward's time by under a tenth, so both kernels run at the rate
// of their shared-memory loads, not of their FMAs (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxWarps = 10;
constexpr int kMaxThreads = 32 * kMaxWarps;
constexpr int kR = 4;      // query (or key) rows a warp works on at once; a multiple of 4
constexpr int kMaxNC = 4;  // score columns per lane: N <= 128
constexpr int kMaxDC = 2;  // feature columns per lane: D <= 64
constexpr int kMaxSmem = 227 * 1024;

struct Strides {
  long long b, h, n;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Sixteen bytes of T widened to float32.
template <typename T>
struct Chunk;
template <>
struct Chunk<float> {
  static constexpr int V = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
  }
};
template <>
struct Chunk<bf16> {
  static constexpr int V = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bf16 -> f32 is a 16-bit shift
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// One [N, D] matrix of a (batch, head) pair and where it goes in shared
// memory: dst[n * ld_n + d * ld_d] = src[n * stride_n + d].
template <typename T>
struct Tile {
  const T* src;
  long long stride_n;
  float* dst;
  int ld_n, ld_d;
};

// Load M matrices at once (rows 16-byte aligned): a thread starts the M
// 16-byte loads of a chunk before it uses any of them, so a block waits for
// device memory about once, not once per element.
template <typename T, int M>
__device__ __forceinline__ void load_tiles(const Tile<T> (&t)[M], int N, int D) {
  constexpr int V = Chunk<T>::V;
  const int per_row = D / V;
  for (int i = threadIdx.x; i < N * per_row; i += blockDim.x) {
    const int n = i / per_row, d0 = (i - n * per_row) * V;
    uint4 raw[M];
#pragma unroll
    for (int m = 0; m < M; ++m)
      raw[m] = *reinterpret_cast<const uint4*>(t[m].src + n * t[m].stride_n + d0);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      float f[V];
      Chunk<T>::unpack(raw[m], f);
#pragma unroll
      for (int e = 0; e < V; ++e) t[m].dst[n * t[m].ld_n + (d0 + e) * t[m].ld_d] = f[e];
    }
  }
}

// dst[first .. first + count) = 0
__device__ __forceinline__ void zero_fill(float* dst, int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = 0.f;
}

// Columns N .. npad - 1 of a transposed [D, ldt] matrix, set to zero.
__device__ __forceinline__ void zero_pad(float* t, int N, int npad, int D, int ldt) {
  const int extra = npad - N;
  for (int i = threadIdx.x; i < D * extra; i += blockDim.x)
    t[(i / extra) * ldt + N + i % extra] = 0.f;
}

__device__ __forceinline__ float pick(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// acc[r][c] += sum_d a[row[r], d] * bt[d, lane + 32 c]: kR rows of a product
// against a transposed operand, lanes on its columns. a is [rows][D], D a
// multiple of 4.
template <int NC>
__device__ __forceinline__ void rows_times_transposed(float (*acc)[kMaxNC], const float* a,
                                                      const int* row, const float* bt, int D,
                                                      int ldt, int lane) {
  for (int d0 = 0; d0 < D; d0 += 4) {
    float4 av[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) av[r] = *reinterpret_cast<const float4*>(a + row[r] * D + d0);
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) {
      float bv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) bv[c] = bt[(d0 + dd) * ldt + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(pick(av[r], dd), bv[c], acc[r][c]);
    }
  }
}

// acc[r][c] += sum_j w[r][j] * m(j, lane + 32 c) for j < n4 (a multiple of 4):
// kR rows of a product with lanes on the feature columns. The rows of w are
// ldw apart, 16-byte aligned, and hold zeros past the last real j.
// m(j, col) = mat[j * sj + col * sc].
template <int DC>
__device__ __forceinline__ void weights_times_matrix(float (*acc)[kMaxDC], const float* w,
                                                     int ldw, const float* mat, int sj, int sc,
                                                     int n4, int D, int lane) {
  bool in[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) in[c] = lane + 32 * c < D;
  for (int j0 = 0; j0 < n4; j0 += 4) {
    float4 wv[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) wv[r] = *reinterpret_cast<const float4*>(w + r * ldw + j0);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float mv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c)
        mv[c] = in[c] ? mat[(j0 + jj) * sj + (lane + 32 * c) * sc] : 0.f;
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[r][c] = fmaf(pick(wv[r], jj), mv[c], acc[r][c]);
    }
  }
}

template <typename T, int NC, int DC>
__global__ void __launch_bounds__(kMaxThreads, 3)
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const float* __restrict__ pm,
                           T* __restrict__ o, float* __restrict__ lse, int H, int N, int D,
                           Strides sq, Strides sk, Strides sv, Strides so, float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int npad = 32 * NC;
  const int n4 = round_up(N, 4), ldt = npad + 1, warps = blockDim.x / 32;
  // the strips first: their rows stay 16-byte aligned whatever D is
  float* ps = smem;                     // [warps][kR][npad]
  float* qs = ps + warps * kR * npad;   // [n4][D]
  float* vs = qs + n4 * D;              // [n4][D], rows past N zero
  float* kt = vs + n4 * D;              // [D][ldt], K transposed, columns past N zero
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const Tile<T> tiles[3] = {{q + b * sq.b + h * sq.h, sq.n, qs, D, 1},
                            {v + b * sv.b + h * sv.h, sv.n, vs, D, 1},
                            {k + b * sk.b + h * sk.h, sk.n, kt, 1, ldt}};
  load_tiles<T, 3>(tiles, N, D);
  zero_fill(vs + N * D, (n4 - N) * D);
  zero_pad(kt, N, npad, D, ldt);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* pw = ps + warp * kR * npad;
  T* ob = o + b * so.b + h * so.h;
  for (int i0 = warp * kR; i0 < N; i0 += warps * kR) {
    int row[kR];
    float s[kR][kMaxNC];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      row[r] = min(i0 + r, N - 1);
#pragma unroll
      for (int c = 0; c < NC; ++c) s[r][c] = 0.f;
    }
    rows_times_transposed<NC>(s, qs, row, kt, D, ldt, lane);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      float m = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        s[r][c] = lane + 32 * c < N ? s[r][c] * scale : -CUDART_INF_F;
        m = fmaxf(m, s[r][c]);
      }
      m = warp_max(m);
      float l = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        s[r][c] = expf(s[r][c] - m);  // 0 in a padded column
        l += s[r][c];
      }
      l = warp_sum(l);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int j = lane + 32 * c;
        float p = s[r][c] / l;
        if (pm != nullptr && j < N) p *= pm[row[r] * N + j];
        pw[r * npad + j] = p;
      }
      if (lane == 0 && i0 + r < N) lse[static_cast<long long>(bh) * N + i0 + r] = m + logf(l);
    }
    __syncwarp();
    float acc[kR][kMaxDC];
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
    weights_times_matrix<DC>(acc, pw, npad, vs, D, 1, n4, D, lane);
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int c = 0; c < DC; ++c)
        if (i0 + r < N && lane + 32 * c < D)
          ob[(i0 + r) * so.n + lane + 32 * c] = from_f<T>(acc[r][c]);
    __syncwarp();  // the next row group overwrites this warp's strip
  }
}

template <typename T, int NC, int DC>
__global__ void __launch_bounds__(kMaxThreads, 2)
flash_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ o,
                           const float* __restrict__ lse, const T* __restrict__ g,
                           const float* __restrict__ pm, T* __restrict__ dq,
                           T* __restrict__ dk, T* __restrict__ dv, int H, int N, int D,
                           Strides sq, Strides sk, Strides sv, Strides so, Strides sg,
                           Strides sdq, Strides sdk, Strides sdv, float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int npad = 32 * NC;
  const int n4 = round_up(N, 4), ldt = npad + 1, warps = blockDim.x / 32;
  // pp and ds first: their rows stay 16-byte aligned whatever D is
  float* pp = smem;               // [n4][npad], P * pm, columns past N zero
  float* ds = pp + n4 * npad;     // [n4][npad], dS, columns past N zero
  float* qs = ds + n4 * npad;     // [n4][D]
  float* gs = qs + n4 * D;        // [n4][D], dO
  float* kt = gs + n4 * D;        // [D][ldt], K transposed, columns past N zero
  float* vt = kt + D * ldt;       // [D][ldt], V transposed
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const Tile<T> tiles[4] = {{q + b * sq.b + h * sq.h, sq.n, qs, D, 1},
                            {g + b * sg.b + h * sg.h, sg.n, gs, D, 1},
                            {k + b * sk.b + h * sk.h, sk.n, kt, 1, ldt},
                            {v + b * sv.b + h * sv.h, sv.n, vt, 1, ldt}};
  load_tiles<T, 4>(tiles, N, D);
  zero_pad(kt, N, npad, D, ldt);
  zero_pad(vt, N, npad, D, ldt);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* ob = o + b * so.b + h * so.h;
  T* dqb = dq + b * sdq.b + h * sdq.h;
  // phase 1: a warp owns query rows
  for (int i0 = warp * kR; i0 < N; i0 += warps * kR) {
    int row[kR];
    float s[kR][kMaxNC], dp[kR][kMaxNC];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      row[r] = min(i0 + r, N - 1);
#pragma unroll
      for (int c = 0; c < NC; ++c) s[r][c] = dp[r][c] = 0.f;
    }
    // the rows of O and LSE this group needs, asked for before the products
    // so that the loads from device memory overlap them
    float ov[kR][kMaxDC], row_lse[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      row_lse[r] = lse[static_cast<long long>(bh) * N + row[r]];
#pragma unroll
      for (int c = 0; c < DC; ++c)
        ov[r][c] = lane + 32 * c < D ? to_f(ob[row[r] * so.n + lane + 32 * c]) : 0.f;
    }
    rows_times_transposed<NC>(s, qs, row, kt, D, ldt, lane);
    rows_times_transposed<NC>(dp, gs, row, vt, D, ldt, lane);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < DC; ++c)
        if (lane + 32 * c < D) part += gs[row[r] * D + lane + 32 * c] * ov[r][c];
      const float delta = warp_sum(part);
      if (i0 + r < N) {  // warp-uniform
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int j = lane + 32 * c;
          float pv = 0.f, dsv = 0.f;
          if (j < N) {
            const float p = expf(s[r][c] * scale - row_lse[r]);
            const float mult = pm != nullptr ? pm[row[r] * N + j] : 1.f;
            pv = p * mult;
            dsv = p * (dp[r][c] * mult - delta);
          }
          pp[row[r] * npad + j] = pv;
          ds[row[r] * npad + j] = dsv;
        }
      }
    }
    __syncwarp();
    // dQ = dS k * scale, lanes on the feature columns: k[j, d] = kt[d, j]. A
    // ragged group reads its last row again (row[] is clamped) and stores
    // nothing for it.
    float acc[kR][kMaxDC];
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
    if (i0 + kR <= N) {
      weights_times_matrix<DC>(acc, ds + i0 * npad, npad, kt, 1, ldt, n4, D, lane);
    } else {  // the last, ragged group: row by row through the clamped index
      for (int j = 0; j < N; ++j) {
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float kv = lane + 32 * c < D ? kt[(lane + 32 * c) * ldt + j] : 0.f;
#pragma unroll
          for (int r = 0; r < kR; ++r) acc[r][c] = fmaf(ds[row[r] * npad + j], kv, acc[r][c]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int c = 0; c < DC; ++c)
        if (i0 + r < N && lane + 32 * c < D)
          dqb[(i0 + r) * sdq.n + lane + 32 * c] = from_f<T>(acc[r][c] * scale);
  }
  __syncthreads();

  // phase 2: a warp owns key rows j0 .. j0 + 3 (columns of pp and ds; those
  // past N hold zeros and are not stored); dV = (P pm)^T dO, dK = dS^T q * scale
  T* dkb = dk + b * sdk.b + h * sdk.h;
  T* dvb = dv + b * sdv.b + h * sdv.h;
  for (int j0 = warp * kR; j0 < N; j0 += warps * kR) {
    float ak[kR][kMaxDC], av[kR][kMaxDC];
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int c = 0; c < DC; ++c) ak[r][c] = av[r][c] = 0.f;
    for (int i = 0; i < N; ++i) {
      float qv[DC], gv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const bool in = lane + 32 * c < D;
        qv[c] = in ? qs[i * D + lane + 32 * c] : 0.f;
        gv[c] = in ? gs[i * D + lane + 32 * c] : 0.f;
      }
#pragma unroll
      for (int r0 = 0; r0 < kR; r0 += 4) {
        const float4 d4 = *reinterpret_cast<const float4*>(ds + i * npad + j0 + r0);
        const float4 p4 = *reinterpret_cast<const float4*>(pp + i * npad + j0 + r0);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            ak[r0 + r][c] = fmaf(pick(d4, r), qv[c], ak[r0 + r][c]);
            av[r0 + r][c] = fmaf(pick(p4, r), gv[c], av[r0 + r][c]);
          }
      }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int c = 0; c < DC; ++c)
        if (j0 + r < N && lane + 32 * c < D) {
          dkb[(j0 + r) * sdk.n + lane + 32 * c] = from_f<T>(ak[r][c] * scale);
          dvb[(j0 + r) * sdv.n + lane + 32 * c] = from_f<T>(av[r][c]);
        }
  }
}

bool shape_ok(long long B, long long H, long long N, long long D) {
  return B > 0 && H > 0 && N > 0 && D > 0 && N <= 32 * kMaxNC && D <= 32 * kMaxDC &&
         B * H <= 0x7fffffffLL;
}

// As many warps as spread the groups of kR rows evenly over the fewest rounds.
int warps_for(long long N) {
  const int groups = static_cast<int>((N + kR - 1) / kR);
  const int rounds = (groups + kMaxWarps - 1) / kMaxWarps;
  return (groups + rounds - 1) / rounds;
}

Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

// True when every row of the count matrices starts on a 16-byte boundary and
// is a whole number of 16-byte chunks, as the loader's vectors need.
bool rows_aligned(const void* const* ptrs, const long long* strides, int count, long long D,
                  int elem_bytes) {
  if ((D * elem_bytes) % 16 != 0) return false;
  for (int i = 0; i < count; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
    for (int j = 0; j < 3; ++j)
      if ((strides[3 * i + j] * elem_bytes) % 16 != 0) return false;
  }
  return true;
}

struct FwdArgs {
  const void *q, *k, *v, *pm;
  void *o, *lse;
  long long B, H, N, D;
  const long long* s;
  float scale;
  cudaStream_t st;
};

template <typename T, int NC, int DC>
int launch_fwd(const FwdArgs& a) {
  const int n4 = round_up(static_cast<int>(a.N), 4), npad = 32 * NC, warps = warps_for(a.N);
  const long long smem =
      (2LL * n4 * a.D + a.D * (npad + 1) + 1LL * warps * kR * npad) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = flash_attention_fwd_kernel<T, NC, DC>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const void* ptrs[3] = {a.q, a.k, a.v};
  if (!rows_aligned(ptrs, a.s, 3, a.D, sizeof(T))) return cudaErrorMisalignedAddress;
  kern<<<static_cast<unsigned>(a.B * a.H), 32 * warps, smem, a.st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const float*>(a.pm), static_cast<T*>(a.o), static_cast<float*>(a.lse),
      static_cast<int>(a.H), static_cast<int>(a.N), static_cast<int>(a.D), strides_at(a.s, 0),
      strides_at(a.s, 1), strides_at(a.s, 2), strides_at(a.s, 3), a.scale);
  return static_cast<int>(cudaGetLastError());
}

struct BwdArgs {
  const void *q, *k, *v, *o, *lse, *g, *pm;
  void *dq, *dk, *dv;
  long long B, H, N, D;
  const long long* s;
  float scale;
  cudaStream_t st;
};

template <typename T, int NC, int DC>
int launch_bwd(const BwdArgs& a) {
  const int n4 = round_up(static_cast<int>(a.N), 4), npad = 32 * NC, warps = warps_for(a.N);
  const long long smem =
      (2LL * n4 * a.D + 2 * a.D * (npad + 1) + 2LL * n4 * npad) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = flash_attention_bwd_kernel<T, NC, DC>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  // the loader's four matrices: q, k, v (strides 0..2) and dO (strides 4)
  const void* ptrs[4] = {a.q, a.k, a.v, a.g};
  long long bwd_strides[12];
  for (int i = 0; i < 12; ++i) bwd_strides[i] = a.s[i < 9 ? i : i + 3];
  if (!rows_aligned(ptrs, bwd_strides, 4, a.D, sizeof(T))) return cudaErrorMisalignedAddress;
  kern<<<static_cast<unsigned>(a.B * a.H), 32 * warps, smem, a.st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.o), static_cast<const float*>(a.lse), static_cast<const T*>(a.g),
      static_cast<const float*>(a.pm), static_cast<T*>(a.dq), static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), static_cast<int>(a.H), static_cast<int>(a.N),
      static_cast<int>(a.D), strides_at(a.s, 0), strides_at(a.s, 1), strides_at(a.s, 2),
      strides_at(a.s, 3), strides_at(a.s, 4), strides_at(a.s, 5), strides_at(a.s, 6),
      strides_at(a.s, 7), a.scale);
  return static_cast<int>(cudaGetLastError());
}

// Pick the instance by the score columns (N) and feature columns (D) a lane
// holds: the two the configs reach (vit_mnist: N = 50, D = 16; vit_cifar100:
// N = 65, D = 32), and the widest for every other shape, whose padded columns
// score -inf or hold zeros. ops/kernels/attention.py::score_columns repeats
// this choice to size the shared memory.
template <typename T, typename Args, template <typename, int, int> class Launch>
int dispatch(const Args& a) {
  if (a.D <= 32 && a.N <= 64) return Launch<T, 2, 1>::run(a);
  if (a.D <= 32 && a.N <= 96) return Launch<T, 3, 1>::run(a);
  return Launch<T, kMaxNC, kMaxDC>::run(a);
}

template <typename T, int NC, int DC>
struct Fwd {
  static int run(const FwdArgs& a) { return launch_fwd<T, NC, DC>(a); }
};
template <typename T, int NC, int DC>
struct Bwd {
  static int run(const BwdArgs& a) { return launch_bwd<T, NC, DC>(a); }
};

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16 (q, k, v, o in that dtype). pm: null
// or float32 [N, N]. lse: float32 [B, H, N] contiguous. strides: host array
// of the (B, H, N) element strides of q, k, v, o, in that order (12 values);
// D has stride 1. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention_fwd(int dtype_code, const void* q, const void* k, const void* v,
                                   const void* pm, void* o, void* lse, long long B, long long H,
                                   long long N, long long D, const long long* strides,
                                   float scale, void* stream) {
  if (!shape_ok(B, H, N, D) || strides == nullptr) return cudaErrorInvalidValue;
  const FwdArgs a{q, k, v, pm, o, lse, B, H, N, D, strides, scale,
                  static_cast<cudaStream_t>(stream)};
  if (dtype_code == 0) return dispatch<float, FwdArgs, Fwd>(a);
  if (dtype_code == 1) return dispatch<bf16, FwdArgs, Fwd>(a);
  return cudaErrorInvalidValue;
}

// strides: of q, k, v, o, dO, dq, dk, dv, in that order (24 values).
extern "C" int flash_attention_bwd(int dtype_code, const void* q, const void* k, const void* v,
                                   const void* o, const void* lse, const void* g,
                                   const void* pm, void* dq, void* dk, void* dv, long long B,
                                   long long H, long long N, long long D,
                                   const long long* strides, float scale, void* stream) {
  if (!shape_ok(B, H, N, D) || strides == nullptr) return cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, o, lse, g, pm, dq, dk, dv, B, H, N, D, strides, scale,
                  static_cast<cudaStream_t>(stream)};
  if (dtype_code == 0) return dispatch<float, BwdArgs, Bwd>(a);
  if (dtype_code == 1) return dispatch<bf16, BwdArgs, Bwd>(a);
  return cudaErrorInvalidValue;
}
