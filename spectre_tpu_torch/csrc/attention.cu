// flash_attention: softmax attention for short sequences, forward and backward.
//
//   forward   S = q k^T * D^-1/2,  P = softmax(S),  O = (P * pm) v,
//             LSE = rowmax(S) + log(rowsum(exp(S - rowmax(S))))
//   backward  P = exp(S - LSE),  delta = rowsum(dO * O),  dV = (P * pm)^T dO,
//             dP = (dO v^T) * pm,  dS = P * (dP - delta),
//             dQ = dS k * D^-1/2,  dK = dS^T q * D^-1/2
//
// q, k, v, O, dO, dQ, dK, dV are [B, H, N, D] with any strides on B, H and N
// and D contiguous, every row of q, k, v, O and dO starting on a 16-byte
// boundary and a whole number of 16-byte chunks long (the wrapper refuses
// anything else); LSE is float32 [B, H, N]; pm is null or a float32 [N, N]
// multiplier on P shared by every batch and head (a dropout keep-mask over
// its keep-probability; null computes plain softmax attention). Replaces the
// two TPU kernels of spectre_tpu/ops/pallas/attention.py (_fwd_kernel,
// _bwd_kernel), which take no pm. As there, the backward rebuilds P from the
// saved LSE without reducing the rows again, and neither S, P, dP nor dS
// ever reaches device memory. One thread block owns a (batch, head) pair's
// dK and dV whole: there are no atomics, and the result does not change from
// run to run.
//
// What bounds it on the H100: bytes. At N = 65, D = 32 a (batch, head) pair
// needs 0.54 MFLOP forward and 1.35 MFLOP backward on 4 + 8 tensors of 4 KB
// in bf16: 2.2 GFLOP forward at B = 256, H = 16 takes 2 us at the
// tensor-core rate against a 20.7 us byte bound.
//
// bfloat16, every config's compute type: the tensor-core kernels
// (flash_attention_{fwd,bwd}_kernel_tc). Operands stay bf16 in shared
// memory, copied in by 16-byte cp.async without widening, rows and features
// padded with zeros to multiples of 16, rows 16 * k + 8 elements apart (an
// odd number of 16-byte units, so the eight row addresses of an ldmatrix
// fall in eight different bank groups). Every product is
// mma.sync.m16n8k16 (bf16 operands, f32 sums) fed by ldmatrix (.trans for
// operands read transposed); wgmma's 64-row tiles would nearly double the
// rows at N = 65, and the work is bound by bytes, not by the product rate.
// A warp owns 16 query rows (five warps at N = 65, four at N = 50).
//   Forward: S for the warp's rows and all keys stays in f32 registers (the
//   mma C layout); row max and sum are quad shuffles; P = exp(S - m) / l,
//   times pm, is rounded to bf16 and feeds P v from registers (the C layout
//   of one mma is the A layout of the next), so P never touches shared
//   memory. LSE = m + log l in f32.
//   Backward, phase 1 by query rows and 16 keys at a time: S and dP by mma,
//   P = exp(S * scale - LSE), delta from dO and O in bf16 (O read once,
//   straight from device memory), dS = P * (dP * pm - delta); dQ = dS k *
//   scale from registers; P * pm and dS go to shared memory as bf16 ([Npad,
//   Npad] each). Phase 2 by key rows: dV = (P pm)^T dO and dK = dS^T q *
//   scale, both operands through ldmatrix.trans.
//   Results leave through the warp's own rows of a tile nobody reads any
//   more (q for O, k and v for dK and dV), as whole 16-byte chunks.
// So P * pm (forward and for dV) and dS (for dQ and dK) are rounded to bf16
// before their products, where the float32 design keeps them in f32: the
// plain versions (ops/kernels/attention.py) round at the same places for
// bf16 inputs. q k^T and dO v^T have exact bf16 operands; only the order of
// their sums differs. Where a second buffer costs no block an SM (the
// forward), a block walks several (batch, head) pairs, the grid sized to the
// SMs times the blocks that fit, and copies the next pair's tiles in with
// cp.async while it computes the current one; else one block takes one pair
// (the backward: 140 KB at N = 128, D = 64).
// Measured (chip_smoke.py, H100 SXM at 700 W, [256, 16, 65, 32], device
// time): forward 0.046 ms, backward 0.095 ms, 45% and 43% of their byte
// bounds, against 0.072 and 0.239 ms for scaled_dot_product_attention and
// its autograd; walking pairs with the copy in flight gained the forward
// little over one block a pair (PERF.md). What holds them back: the
// instructions each pair costs (five 16-row warps for 65 rows, 80 padded
// keys, the softmax and the address arithmetic around few mma), the
// scattered reads of pm (+17% forward, +23% backward with it), and, for a
// caller that launches them one after another, the host's time per call
// (Python, ctypes and the launch), near the forward's device time at B = 256.
//
// float32: the kernels of the first design (flash_attention_{fwd,bwd}_kernel),
// all arithmetic float32, results cast once on store. Operands are widened
// into shared memory, K (and V in the backward) transposed with an odd row
// stride so that both "lanes walk the keys" and "lanes walk the feature
// columns" are free of bank conflicts.
// A warp owns four query rows at a time: lanes hold the score columns
// (column j = lane + 32 c), row maxima and sums are warp shuffles, the
// normalised row goes to a per-warp strip of shared memory and is read back
// by broadcast for P v with lanes on the feature columns. N = 65 is a
// multiple of no tile: keys are padded to a multiple of 32, a padded column
// gets a score of -inf before the row maximum and so a probability of 0, and
// a ragged row group repeats its last row and stores nothing for it. The
// backward keeps P * pm and dS in shared memory ([N, N] each) because dV and
// dK sum over query rows: phase 1 walks query rows (S, P, dP, dS, dQ), phase
// 2 walks key rows (dV, dK). Products run on the float32 pipes.
//
// A float32 block first waits for device memory: it loads its three or four
// matrices together, sixteen bytes a thread and matrix, all loads of a chunk
// started before any is used; the backward asks for its rows of O and LSE
// before the products that hide their latency. What the inner loops pay for
// is shared-memory loads, so: operands that are broadcast to the warp (a
// query row, a row of P or dS) are read four values at a time as one 16-byte
// load; the number of score and feature columns a lane holds is a template
// parameter, built for the shapes the configs have (two or three score
// columns with one feature column: N <= 64 or 96 with D <= 32) and once for
// everything else (four and two), so no lane of a config's shape multiplies a
// column that does not exist; and the block has as many warps as divide the
// row groups evenly (nine for 65 rows: 17 groups in two rounds where eight
// warps would need three). Registers are capped so that three forward
// blocks or two backward blocks (what its shared memory allows) fit an SM.
// These kernels run at the rate of their shared-memory loads, not of their
// FMAs (PERF.md, where their earlier bf16 times stand).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <mutex>

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
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }

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

// Sixteen bytes of T widened to float32 (the float32 kernels).
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

// ---- bfloat16: the tensor-core kernels ----------------------------------

constexpr int kPad = 8;  // a tile's rows are 16 * k + kPad elements apart
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// Four 8x8 bf16 matrices; lanes 8m .. 8m + 7 give the row addresses of matrix m.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c[16x8] += a[16x16] b[16x8], bf16 operands, f32 sums. Lane l = 4 g + t holds
// c[0..1] at (row g, cols 2t, 2t + 1) and c[2..3] at row g + 8; a[0..3] at
// (row g, cols 2t..), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..); b0, b1
// at (rows 2t.., col g) and (rows 2t + 8.., col g).
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Where lane l points ldmatrix for the 16x16 tile at (row0, col0) of a
// row-major tile with rows ld apart:
//   a_frag  the A operand (rows of the tile are rows of A);
//   b_frag  the B operands of two 8-column tiles, B[k][n] = tile[row0 + n][col0 + k]
//           (x4 gives b0, b1 of columns row0 .. + 7, then of row0 + 8 .. + 15);
//           with .trans the same addresses give the A operand of the
//           transposed tile, A[m][k] = tile[row0 + k][col0 + m];
//   t_frag  (.trans) the B operands of two 8-column tiles, B[k][n] = tile[row0 + k][col0 + n].
__device__ __forceinline__ const bf16* a_frag(const bf16* t, int ld, int row0, int col0,
                                              int lane) {
  return t + (row0 + (lane & 15)) * ld + col0 + (lane >> 4) * 8;
}
__device__ __forceinline__ const bf16* b_frag(const bf16* t, int ld, int row0, int col0,
                                              int lane) {
  return t + (row0 + (lane & 7) + (lane >> 4) * 8) * ld + col0 + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ const bf16* t_frag(const bf16* t, int ld, int row0, int col0,
                                              int lane) {
  return t + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + col0 + (lane >> 4) * 8;
}
// The [N, D] rows of M matrices of one (batch, head) pair, copied by cp.async
// into consecutive tiles of shared memory (tile elements apart, rows ld
// apart). The pads past N and D are never written: they stay zero.
template <int M>
struct PairSrc {
  const bf16* p[M];
  Strides s[M];
};

// A thread copies chunk (n, c) of every matrix, then steps blockDim.x chunks
// on (no division in the loop).
template <int M>
__device__ __forceinline__ void copy_pair_async(const PairSrc<M>& src, int b, int h, bf16* dst,
                                                int tile, int ld, int N, int D) {
  const int per_row = D / 8;
  const int step_n = blockDim.x / per_row, step_c = blockDim.x % per_row;
  const bf16* base[M];
#pragma unroll
  for (int m = 0; m < M; ++m) base[m] = src.p[m] + b * src.s[m].b + h * src.s[m].h;
  int n = threadIdx.x / per_row, c = threadIdx.x % per_row;
  for (; n < N; n += step_n, c += step_c) {
    if (c >= per_row) {
      c -= per_row;
      if (++n >= N) break;
    }
#pragma unroll
    for (int m = 0; m < M; ++m)
      cp_async16(dst + m * tile + n * ld + 8 * c, base[m] + n * src.s[m].n + 8 * c);
  }
}

// The pair loop of both kernels: block x takes pairs x, x + gridDim.x, ...;
// with two buffers the next pair's copy is in flight while this one computes.
// work(pair, buffer) runs between two __syncthreads.
template <int M, typename Work>
__device__ __forceinline__ void walk_pairs(const PairSrc<M>& src, bf16* bufs, int buf_elems,
                                           int nbuf, int BH, int H, int N, int D, int tile,
                                           int ld, Work work) {
  // zero both buffers once: the copies never touch the pads
  for (int i = threadIdx.x; i < nbuf * buf_elems / 8; i += blockDim.x)
    reinterpret_cast<uint4*>(bufs)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  int pair = blockIdx.x;
  if (pair < BH) copy_pair_async<M>(src, pair / H, pair % H, bufs, tile, ld, N, D);
  cp_async_commit();
  for (int it = 0; pair < BH; pair += gridDim.x, ++it) {
    const int next = pair + gridDim.x;
    bf16* cur = bufs + (it % nbuf) * buf_elems;
    if (nbuf == 2) {
      if (next < BH)
        copy_pair_async<M>(src, next / H, next % H, bufs + ((it + 1) % 2) * buf_elems, tile, ld,
                           N, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    work(pair, cur);
    __syncthreads();
    if (nbuf == 1 && next < BH) {
      copy_pair_async<M>(src, next / H, next % H, bufs, tile, ld, N, D);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
}

// A warp's 16 result rows row0 .. row0 + 15 (those < N), held in the C layout
// (acc[nt] covers columns 8 nt ..), times mul, stored as bf16: first into the
// warp's rows of a shared tile that nobody else reads any more (stage, rows
// ld apart), then out as whole 16-byte chunks of each row.
template <int DT>
__device__ __forceinline__ void store_rows(const float (&acc)[2 * DT][4], float mul, bf16* stage,
                                           int ld, int row0, int N, int D, bf16* dst,
                                           long long stride_n, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 2 * DT; ++nt)
    if (8 * nt < D)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row0 + g + 8 * r < N)
          *reinterpret_cast<uint32_t*>(stage + (row0 + g + 8 * r) * ld + 8 * nt + 2 * t) =
              pack_bf16(acc[nt][2 * r] * mul, acc[nt][2 * r + 1] * mul);
  __syncwarp();
  const int per_row = D / 8, rows = min(16, N - row0);
  const int step_r = 32 / per_row, step_c = 32 % per_row;
  int r = lane / per_row, c = lane % per_row;
  for (; r < rows; r += step_r, c += step_c) {
    if (c >= per_row) {
      c -= per_row;
      if (++r >= rows) break;
    }
    *reinterpret_cast<uint4*>(dst + (row0 + r) * stride_n + 8 * c) =
        *reinterpret_cast<const uint4*>(stage + (row0 + r) * ld + 8 * c);
  }
}

// KT, DT: the most 16-row key tiles and 16-wide feature tiles an instance
// takes (N <= 16 KT, D <= 16 DT); the loops stop at the pair's own counts.
template <int KT, int DT>
__global__ void __launch_bounds__(32 * KT)
flash_attention_fwd_kernel_tc(PairSrc<3> src, const float* __restrict__ pm,
                              bf16* __restrict__ o, float* __restrict__ lse, int BH, int H,
                              int N, int D, Strides so, float scale, int nbuf) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* bufs = reinterpret_cast<bf16*>(smem_raw);
  const int nkt = (N + 15) / 16, ndt = (D + 15) / 16;
  const int ld = 16 * ndt + kPad, tile = 16 * nkt * ld;
  const int lane = threadIdx.x % 32, r0 = 16 * (threadIdx.x / 32), g = lane >> 2, t = lane & 3;
  const int row[2] = {r0 + g, r0 + g + 8};

  walk_pairs<3>(src, bufs, 3 * tile, nbuf, BH, H, N, D, tile, ld, [&](int pair, bf16* cur) {
    bf16* qs = cur;
    const bf16 *ks = cur + tile, *vs = cur + 2 * tile;
    uint32_t qa[DT][4];
#pragma unroll
    for (int kb = 0; kb < DT; ++kb)
      if (kb < ndt) ldsm_x4(qa[kb], a_frag(qs, ld, r0, 16 * kb, lane));
    // S = q k^T for the warp's 16 rows and every key, in the C layout
    float s[2 * KT][4];
#pragma unroll
    for (int nb = 0; nb < KT; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[2 * nb][e] = s[2 * nb + 1][e] = 0.f;
      if (nb < nkt) {
#pragma unroll
        for (int kb = 0; kb < DT; ++kb)
          if (kb < ndt) {
            uint32_t kf[4];
            ldsm_x4(kf, b_frag(ks, ld, 16 * nb, 16 * kb, lane));
            mma16816(s[2 * nb], qa[kb], kf[0], kf[1]);
            mma16816(s[2 * nb + 1], qa[kb], kf[2], kf[3]);
          }
      }
    }
    // softmax over the columns < N, in base 2: P = exp2(S * scale * log2(e)
    // - m), one FMA and one ex2; a row's four lanes share m and l by shuffles
    const float scale2 = scale * kLog2e;
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 2 * KT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (8 * nt + 8 > N && 8 * nt + 2 * t + (e & 1) >= N)  // past the last key
          s[nt][e] = -CUDART_INF_F;
        m[e >> 1] = fmaxf(m[e >> 1], s[nt][e]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
      m[r] *= scale2;  // scale2 > 0: the max of the scaled row
    }
#pragma unroll
    for (int nt = 0; nt < 2 * KT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(fmaf(s[nt][e], scale2, -m[e >> 1]));  // 0 past the last key
        l[e >> 1] += s[nt][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      if (t == 0 && row[r] < N)
        lse[static_cast<long long>(pair) * N + row[r]] = (m[r] + log2f(l[r])) * kLn2;
      l[r] = 1.f / l[r];
    }
    // P * pm rounded to bf16: the A operand of P v, straight from the C layout
    uint32_t pa[KT][4];
#pragma unroll
    for (int nb = 0; nb < KT; ++nb)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 16 * nb + 8 * half + 2 * t + (e & 1), r = row[e >> 1];
          p[e] = s[2 * nb + half][e] * l[e >> 1];  // l holds 1 / l
          if (pm != nullptr) p[e] *= r < N && col < N ? pm[r * N + col] : 0.f;
        }
        pa[nb][2 * half] = pack_bf16(p[0], p[1]);
        pa[nb][2 * half + 1] = pack_bf16(p[2], p[3]);
      }
    float acc[2 * DT][4];
#pragma unroll
    for (int nt = 0; nt < 2 * DT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
    for (int nb = 0; nb < KT; ++nb)
      if (nb < nkt) {
#pragma unroll
        for (int db = 0; db < DT; ++db)
          if (db < ndt) {
            uint32_t vf[4];
            ldsm_x4_trans(vf, t_frag(vs, ld, 16 * nb, 16 * db, lane));
            mma16816(acc[2 * db], pa[nb], vf[0], vf[1]);
            mma16816(acc[2 * db + 1], pa[nb], vf[2], vf[3]);
          }
      }
    // through the warp's own rows of q, which nobody reads any more
    store_rows<DT>(acc, 1.f, qs, ld, r0, N, D,
                   o + (pair / H) * so.b + (pair % H) * so.h, so.n, lane);
  });
}

// The register cap lets four blocks share an SM at the configs' shapes
// (shared memory allows four at N = 65, D = 32).
template <int KT, int DT>
__global__ void __launch_bounds__(32 * KT, KT <= 5 ? 4 : 1)
flash_attention_bwd_kernel_tc(PairSrc<4> src, const bf16* __restrict__ o, Strides so,
                              const float* __restrict__ lse,
                              const float* __restrict__ pm, bf16* __restrict__ dq,
                              bf16* __restrict__ dk, bf16* __restrict__ dv, int BH, int H, int N,
                              int D, Strides sdq, Strides sdk, Strides sdv, float scale,
                              int nbuf) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* bufs = reinterpret_cast<bf16*>(smem_raw);
  const int nkt = (N + 15) / 16, ndt = (D + 15) / 16, npad = 16 * nkt;
  const int ld = 16 * ndt + kPad, tile = npad * ld, ldn = npad + kPad;
  // P * pm and dS, [npad][ldn] each, after the tile buffers
  bf16* pps = bufs + nbuf * 4 * tile;
  bf16* dss = pps + npad * ldn;
  const int lane = threadIdx.x % 32, r0 = 16 * (threadIdx.x / 32), g = lane >> 2, t = lane & 3;
  const int row[2] = {r0 + g, r0 + g + 8};

  walk_pairs<4>(src, bufs, 4 * tile, nbuf, BH, H, N, D, tile, ld, [&](int pair, bf16* cur) {
    // q, k, v, dO
    bf16 *qs = cur, *ks = cur + tile, *vs = cur + 2 * tile, *gs = cur + 3 * tile;
    const int b = pair / H, h = pair % H;
    // phase 1: the warp's 16 query rows
    // P = exp2(S * scale * log2(e) - LSE * log2(e))
    const float scale2 = scale * kLog2e;
    float row_lse[2], delta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      row_lse[r] = row[r] < N ? lse[static_cast<long long>(pair) * N + row[r]] * kLog2e : 0.f;
    {  // delta = rowsum(dO * O): two lanes a row, alternate 16-byte chunks;
       // O straight from device memory, read once
      const int dr = r0 + lane / 2;
      const bf16* gr = gs + dr * ld;
      const bf16* orow = o + b * so.b + h * so.h + dr * so.n;
      float part = 0.f;
      for (int c = (lane & 1) * 8; dr < N && c < D; c += 16) {
        const uint4 gu = *reinterpret_cast<const uint4*>(gr + c);
        const uint4 ou = *reinterpret_cast<const uint4*>(orow + c);
        const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gu);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ou);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 gf = __bfloat1622float2(g2[i]), of = __bfloat1622float2(o2[i]);
          part = fmaf(gf.x, of.x, part);
          part = fmaf(gf.y, of.y, part);
        }
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      delta[0] = __shfl_sync(0xffffffffu, part, 2 * g);
      delta[1] = __shfl_sync(0xffffffffu, part, 2 * g + 16);
    }
    uint32_t qa[DT][4], ga[DT][4];
#pragma unroll
    for (int kb = 0; kb < DT; ++kb)
      if (kb < ndt) {
        ldsm_x4(qa[kb], a_frag(qs, ld, r0, 16 * kb, lane));
        ldsm_x4(ga[kb], a_frag(gs, ld, r0, 16 * kb, lane));
      }
    float dqa[2 * DT][4];
#pragma unroll
    for (int nt = 0; nt < 2 * DT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dqa[nt][e] = 0.f;
#pragma unroll
    for (int nb = 0; nb < KT; ++nb)
      if (nb < nkt) {  // keys 16 nb .. 16 nb + 15
        float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
        for (int kb = 0; kb < DT; ++kb)
          if (kb < ndt) {
            uint32_t kf[4], vf[4];
            ldsm_x4(kf, b_frag(ks, ld, 16 * nb, 16 * kb, lane));
            ldsm_x4(vf, b_frag(vs, ld, 16 * nb, 16 * kb, lane));
            mma16816(s[0], qa[kb], kf[0], kf[1]);
            mma16816(s[1], qa[kb], kf[2], kf[3]);
            mma16816(dp[0], ga[kb], vf[0], vf[1]);
            mma16816(dp[1], ga[kb], vf[2], vf[3]);
          }
        uint32_t da[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float pv[4], dsv[4];
          const int col0 = 16 * nb + 8 * half + 2 * t;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = col0 + (e & 1), r = e >> 1;
            pv[e] = dsv[e] = 0.f;
            if (row[r] < N && col < N) {
              const float p = exp2f(fmaf(s[half][e], scale2, -row_lse[r]));
              const float mult = pm != nullptr ? pm[row[r] * N + col] : 1.f;
              pv[e] = p * mult;
              dsv[e] = p * (dp[half][e] * mult - delta[r]);
            }
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const uint32_t pw = pack_bf16(pv[2 * r], pv[2 * r + 1]);
            const uint32_t dw = pack_bf16(dsv[2 * r], dsv[2 * r + 1]);
            *reinterpret_cast<uint32_t*>(pps + row[r] * ldn + col0) = pw;
            *reinterpret_cast<uint32_t*>(dss + row[r] * ldn + col0) = dw;
            da[2 * half + r] = dw;
          }
        }
        // dQ += dS k for these keys, dS straight from registers
#pragma unroll
        for (int db = 0; db < DT; ++db)
          if (db < ndt) {
            uint32_t kf[4];
            ldsm_x4_trans(kf, t_frag(ks, ld, 16 * nb, 16 * db, lane));
            mma16816(dqa[2 * db], da, kf[0], kf[1]);
            mma16816(dqa[2 * db + 1], da, kf[2], kf[3]);
          }
      }
    bf16* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
    for (int nt = 0; nt < 2 * DT; ++nt) {
      const int col = 8 * nt + 2 * t;
      if (col < D)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (row[r] < N)
            *reinterpret_cast<uint32_t*>(dqb + row[r] * sdq.n + col) =
                pack_bf16(dqa[nt][2 * r] * scale, dqa[nt][2 * r + 1] * scale);
    }
    __syncthreads();
    // phase 2: the warp's 16 key rows r0 .. r0 + 15 (columns of P * pm and dS)
    float dka[2 * DT][4], dva[2 * DT][4];
#pragma unroll
    for (int nt = 0; nt < 2 * DT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[nt][e] = dva[nt][e] = 0.f;
#pragma unroll
    for (int ib = 0; ib < KT; ++ib)
      if (ib < nkt) {  // query rows 16 ib .. 16 ib + 15
        uint32_t pa[4], sa[4];
        ldsm_x4_trans(pa, b_frag(pps, ldn, 16 * ib, r0, lane));
        ldsm_x4_trans(sa, b_frag(dss, ldn, 16 * ib, r0, lane));
#pragma unroll
        for (int db = 0; db < DT; ++db)
          if (db < ndt) {
            uint32_t gf[4], qf[4];
            ldsm_x4_trans(gf, t_frag(gs, ld, 16 * ib, 16 * db, lane));
            ldsm_x4_trans(qf, t_frag(qs, ld, 16 * ib, 16 * db, lane));
            mma16816(dva[2 * db], pa, gf[0], gf[1]);
            mma16816(dva[2 * db + 1], pa, gf[2], gf[3]);
            mma16816(dka[2 * db], sa, qf[0], qf[1]);
            mma16816(dka[2 * db + 1], sa, qf[2], qf[3]);
          }
      }
    // through the warp's rows of k and v, which phase 2 does not read
    store_rows<DT>(dka, scale, ks, ld, r0, N, D, dk + b * sdk.b + h * sdk.h, sdk.n, lane);
    store_rows<DT>(dva, 1.f, vs, ld, r0, N, D, dv + b * sdv.b + h * sdv.h, sdv.n, lane);
  });
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

// Grid, buffers and shared memory of a tensor-core launch. Blocks that walk
// pairs, as many as fit on the SMs, with a second buffer for the next pair's
// copy, where the second buffer costs no block an SM (the forward at the
// configs' shapes); else one block a pair with one buffer (the backward,
// whose P * pm and dS already fill the SM: two buffers would leave two
// blocks an SM where one leaves four, and measured slower). The answer
// depends only on the instance, its pair's tile counts and the card, so it
// is worked out on an instance's first launch at those counts on a device
// and kept in the instance's table (one cudaGetDevice a launch after that).
// buf_bytes: one buffer; extra: shared memory beside the buffers;
// max_bytes: the most the instance asks for at any tile counts.
struct TcShape {
  std::atomic<int> ready;
  int nbuf, max_grid;
};
constexpr int kMaxDevices = 16;
template <int KT, int DT>
using TcTable = TcShape[kMaxDevices][KT + 1][DT + 1];

template <typename Kern, int KT, int DT>
int tc_launch_shape(Kern kern, TcTable<KT, DT>& table, int nkt, int ndt, int threads,
                    long long buf_bytes, long long extra, long long max_bytes, long long BH,
                    int* grid, int* nbuf, int* smem) {
  if (buf_bytes + extra > kMaxSmem) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  TcShape& shape = table[dev][nkt][ndt];
  if (!shape.ready.load(std::memory_order_acquire)) {
    static std::mutex lock;
    std::lock_guard<std::mutex> hold(lock);
    if (!shape.ready.load(std::memory_order_relaxed)) {
      // the instance's largest request, so that no later launch of it needs more
      if ((e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(std::min<long long>(max_bytes, kMaxSmem)))) !=
          cudaSuccess)
        return static_cast<int>(e);
      int sms = 0, one = 0, two = 0;
      shape.nbuf = 1;
      shape.max_grid = 0;  // one block a pair
      if (2 * buf_bytes + extra <= kMaxSmem) {
        if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
                cudaSuccess ||
            (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &one, kern, threads, static_cast<int>(buf_bytes + extra))) != cudaSuccess ||
            (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &two, kern, threads, static_cast<int>(2 * buf_bytes + extra))) != cudaSuccess)
          return static_cast<int>(e);
        if (two >= one && two > 0) {
          shape.nbuf = 2;
          shape.max_grid = sms * two;
        }
      }
      shape.ready.store(1, std::memory_order_release);
    }
  }
  *nbuf = shape.nbuf;
  *grid = static_cast<int>(shape.max_grid > 0 ? std::min<long long>(BH, shape.max_grid) : BH);
  *smem = static_cast<int>(*nbuf * buf_bytes + extra);
  return cudaSuccess;
}

template <int KT, int DT>
int launch_fwd_tc(const FwdArgs& a) {
  const int nkt = static_cast<int>((a.N + 15) / 16), ndt = static_cast<int>((a.D + 15) / 16);
  const long long tile = 16LL * nkt * (16 * ndt + kPad);
  const void* ptrs[3] = {a.q, a.k, a.v};
  if (!rows_aligned(ptrs, a.s, 3, a.D, sizeof(bf16))) return cudaErrorMisalignedAddress;
  auto kern = flash_attention_fwd_kernel_tc<KT, DT>;
  static TcTable<KT, DT> table;
  const long long max_tile = 16LL * KT * (16 * DT + kPad);
  int grid, nbuf, smem;
  const int err = tc_launch_shape<decltype(kern), KT, DT>(
      kern, table, nkt, ndt, 32 * nkt, 3 * tile * sizeof(bf16), 0,
      2 * 3 * max_tile * sizeof(bf16), a.B * a.H, &grid, &nbuf, &smem);
  if (err != cudaSuccess) return err;
  const PairSrc<3> src{{static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
                        static_cast<const bf16*>(a.v)},
                       {strides_at(a.s, 0), strides_at(a.s, 1), strides_at(a.s, 2)}};
  kern<<<grid, 32 * nkt, smem, a.st>>>(
      src, static_cast<const float*>(a.pm), static_cast<bf16*>(a.o), static_cast<float*>(a.lse),
      static_cast<int>(a.B * a.H), static_cast<int>(a.H), static_cast<int>(a.N),
      static_cast<int>(a.D), strides_at(a.s, 3), a.scale, nbuf);
  return static_cast<int>(cudaGetLastError());
}

template <int KT, int DT>
int launch_bwd_tc(const BwdArgs& a) {
  const int nkt = static_cast<int>((a.N + 15) / 16), ndt = static_cast<int>((a.D + 15) / 16);
  const long long npad = 16LL * nkt, tile = npad * (16 * ndt + kPad);
  // q, k, v, O, dO: strides 0 .. 4
  const void* ptrs[5] = {a.q, a.k, a.v, a.o, a.g};
  if (!rows_aligned(ptrs, a.s, 5, a.D, sizeof(bf16))) return cudaErrorMisalignedAddress;
  auto kern = flash_attention_bwd_kernel_tc<KT, DT>;
  static TcTable<KT, DT> table;
  const long long max_npad = 16LL * KT, max_tile = max_npad * (16 * DT + kPad);
  int grid, nbuf, smem;
  const int err = tc_launch_shape<decltype(kern), KT, DT>(
      kern, table, nkt, ndt, 32 * nkt, 4 * tile * sizeof(bf16),
      2 * npad * (npad + kPad) * sizeof(bf16),
      (2 * 4 * max_tile + 2 * max_npad * (max_npad + kPad)) * sizeof(bf16), a.B * a.H, &grid,
      &nbuf, &smem);
  if (err != cudaSuccess) return err;
  const PairSrc<4> src{{static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
                        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.g)},
                       {strides_at(a.s, 0), strides_at(a.s, 1), strides_at(a.s, 2),
                        strides_at(a.s, 4)}};
  kern<<<grid, 32 * nkt, smem, a.st>>>(
      src, static_cast<const bf16*>(a.o), strides_at(a.s, 3), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.pm),
      static_cast<bf16*>(a.dq), static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
      static_cast<int>(a.B * a.H), static_cast<int>(a.H), static_cast<int>(a.N),
      static_cast<int>(a.D), strides_at(a.s, 5), strides_at(a.s, 6), strides_at(a.s, 7), a.scale,
      nbuf);
  return static_cast<int>(cudaGetLastError());
}

// Pick the float32 instance by the score columns (N) and feature columns (D)
// a lane holds: the two the configs reach (vit_mnist: N = 50, D = 16; vit_cifar100:
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

// The tensor-core instances by the most 16-key and 16-feature tiles they
// take: vit_mnist's shape (N = 50, D = 16), vit_cifar100's (N = 65, D = 32),
// and everything else up to N = 128, D = 64; a pair's own tile counts bound
// its loops.
template <typename Args, template <int, int> class Launch>
int dispatch_tc(const Args& a) {
  if (a.N <= 64 && a.D <= 16) return Launch<4, 1>::run(a);
  if (a.N <= 80 && a.D <= 32) return Launch<5, 2>::run(a);
  return Launch<8, 4>::run(a);
}

template <int KT, int DT>
struct FwdTc {
  static int run(const FwdArgs& a) { return launch_fwd_tc<KT, DT>(a); }
};
template <int KT, int DT>
struct BwdTc {
  static int run(const BwdArgs& a) { return launch_bwd_tc<KT, DT>(a); }
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
  if (dtype_code == 1) return dispatch_tc<FwdArgs, FwdTc>(a);
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
  if (dtype_code == 1) return dispatch_tc<BwdArgs, BwdTc>(a);
  return cudaErrorInvalidValue;
}
