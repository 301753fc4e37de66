// fused_block_bwd: the backward of the folded permutation mix in one launch,
//
//   dxt[j*blk + t, b] = sum_h s4f[r] * sum_o dy[n_r, b, o] * w[e_r, o]
//   r = h*d + binv[h, j]*blk + t,  n_r = r / EH,  e_r = r % EH
//   dy [N, B, O], w [EH, O], s4 [N, EH] (+-1, s4f its flat view),
//   binv [H, d/blk] int32  ->  dxt [d, B],  with N*EH == H*d.
//
// It is block_gather_sum(s4 * (w @ dy^T)) without the [H*d, B] cotangent in
// device memory. Replaces the TPU kernel spectre_tpu/ops/pallas/
// bwd_gather.py::fused_block_bwd_pallas (its _fused_bwd_kernel).
//
// What bounds it on the H100: 2*d*H*O*B operations against d*B + N*B*O +
// EH*O + N*EH values moved (139.6 GFLOP against 43.5 MB at the flagship
// shape, B=256, bf16), so the tensor cores set the floor, by a factor of ten
// over the memory (float32: the FP32 pipes, 2.08 ms). The chain it fuses is
// bound by the bytes of the cotangent it writes and reads again.
//
// blk divides EH, so the blk rows of a source block lie in one token n and
// are blk consecutive rows of w starting at e0. Two kernels, picked by the
// wrapper (ops/kernels/fused_block_bwd.py::block_bwd_kernel):
//
// fused_block_bwd_grouped: float32 at any blk, bf16 with blk % 64 != 0.
// Why an output-stationary kernel is slow here: each output block reads,
// for every head, that head's token's whole dy[n, b-tile, :], so dy (17 MB
// at the flagship shape) comes from L2 H*d/blk times over: 4.4 GB at
// blk = 32, 8.7 GB at blk = 16, more than the chain moves. The design: a
// thread block owns R rows of dxt (R = J slabs of sb rows, sb = 64, 32 or 16,
// the largest that divides blk: a block of the table is a run of slabs) and
// one tile of BT = 128 batch columns. Its H*J (head, slab) pairs draw on few
// tokens (at most 65 at the flagship shape, against 256 pairs at blk = 16),
// so the block orders them by (token, head, slab) and runs them in steps:
// a run of one token's pairs, no slab twice, stacked as the rows of one
// product with the token's dy tile, which each step reads once for all its
// slabs. The schedule is built on the device in the kernel's prologue (pair
// coordinates from binv; a rank sort of the pairs' keys in shared memory;
// each token's run cut into steps by its first thread; a ballot count of the
// steps), never on the host.
// - Signs and the sums. A step's products go into fresh f32 accumulators;
//   each row is multiplied by its sign s4f[start + t] and added into the
//   block's R x BT f32 sums, which live in shared memory (a runtime slab
//   index cannot index registers). A step holds distinct slabs, so no two of
//   its rows meet in one sum; steps add in schedule order. For one output
//   row, its H pairs come in token order, and a head's tokens all come before
//   the next head's (n_h <= n_h' for h < h'), with two heads of one token
//   in different steps, so the order is the head order of the plain version
//   and of the TPU kernel; two runs are equal bit for bit.
// - bf16: Hopper's wgmma + TMA (wgmma_gemm.cuh). A step is up to 64 rows
//   (64 / sb slabs), one wgmma M. Its stage is the dy box [BT b, 64 O] from
//   a 3-D map on dy and its slabs from a map on w whose box is sb rows,
//   stacked into one K-major 64-row tile (a missing slab leaves rows that
//   are computed and never added); wgmma m64n128k16 with A = the slabs,
//   B = dy (both K-major). Two consumer warpgroups take the steps in turns
//   and a producer warp fills a ring of 3 stages of 24 KB, so one
//   warpgroup's signed adds overlap the other's products. Named barriers
//   order the turns: the products of step s start once those of step s - 1
//   have been issued (a full barrier's waiter may not run more than one
//   phase ahead), and the adds of step s wait for those of step s - 1, which
//   keeps the order fixed. 139 KB of f32 sums (R = 256 rows) and 72 KB of
//   stages: one block an SM. What bounds it: the L2 traffic of dy (a step's
//   tile) and w (each slab once a batch tile), about 4.1 GB at blk = 16 and
//   3.8 GB at blk = 32 for B = 256 (the flagship's seeded tables: 88.8 and
//   80.2 steps a block), against 0.04 GB counted once. Measured on the H100
//   and not kept: steps of up to 128 rows (fewer steps, 2.2 GB of dy), whose
//   32 KB stages leave room for only 2 beside the sums: slower at both blk.
// - float32: the same schedule in steps of up to 64 rows, plain FMAs on the
//   FP32 pipes (no TF32), so that f32 stays f32: a step's 64 rows x 128
//   columns over 128 threads, an 8 x 8 register tile each, cp.async
//   double-buffered 16-deep stages of O (the slabs' w rows and the dy tile,
//   K contiguous). A warp's rows lie in one slab; a warp whose slab is
//   missing skips the products. R = 128 rows (68 KB of sums), two blocks
//   an SM.
// A batch tail (B not a multiple of the tile) loads as zeros and is masked
// on store, so any B >= 1 works.
//
// fused_block_bwd_wgmma: bf16 with blk a multiple of 64, the flagship's
// case, on the Hopper mainloop of wgmma_gemm.cuh. A block owns the 64 rows
// of one source block (one wgmma M) and 256 batch columns, two warpgroups of
// 128 columns each; its first thread fills a ring of 5 stages by TMA
// (wgmma_gemm.cuh::Ring): per head h and 64-deep chunk of O, w rows [e0_h,
// e0_h + 64) from a map on w [EH, O] and dy[n_h, b0 : b0 + 256, :] from a
// 3-D map on dy [N, B, O], both K-major (O contiguous) boxes with the
// 128-byte swizzle; a batch tail loads as zeros and is masked on store. The
// signs are per (head, row), so the design is the TPU kernel's: each head's
// product goes into a fresh accumulator `part` (wgmma m64n128k16, scale-d =
// 0 on its first slice), then acc += s (.) part in registers, in head order,
// in f32. The price is two accumulator sets (128 registers a thread), so 128
// columns a warpgroup. The head's last stage drains the warpgroup's wgmma
// before the signed add; the other warpgroup keeps the tensor cores busy
// meanwhile. What bounds it: each 64-row tile reads its heads' dy rows
// again, 2.2 GB from L2 at B = 256 where the bound counts dy once; the
// kernel reads them at about 5.9 TB/s (measured on the H100), and one
// warpgroup a block (two blocks an SM) is no faster.
//
// The pool residual's cotangent (fused_block_bwd_wgmma with a dpool). The
// folded mix's forward also returns pool[n, b, u] = sum_v g4[n, u*grp + v, b]
// * s4[n, u*grp + v] / grp (EH = O * grp), so the cotangent of g4 has a
// second term, and the train step's input cotangent is
//   dxt = block_gather_sum(s4 * (w @ dy^T + P @ dpool^T)),
// P[e, u] = 1/grp where e / grp == u. The kernel adds P @ dpool^T to each
// head's `part` before the signed add: part[r, b] += dpool[n_h, b, (e0_h + r)
// / grp] * (1/grp), one float32 multiply and one float32 add, then acc += s
// (.) part as before; no [H*d, B] tensor, no second pass. The rule: grp a
// multiple of 16. A warp's 16 rows (r0 and r0 + 8, r0 = 16 warp + lane / 4)
// then start at a multiple of 16 of e and lie in one pool column u_w, so a
// warpgroup needs 4 values a batch column a head (u_0 .. u_3 of its 4
// warps). dpool is read in the layout it arrives in (strides for n and b, u
// contiguous; the train step's is a transposed [B, N, O] view). At a head's
// start each thread loads its own column's 4 values (one 8-byte load where
// grp = 16 and the view is aligned: u_0 .. u_3 are adjacent), before the
// head's products; once they are done it puts them in shared memory, the
// warpgroup meets at a named barrier, and each thread reads its 32 (16
// bf16 pairs). So dpool comes from L2 once a (head, tile, column), 256
// sectors a block a head against 8 boxes of 32 KB of dy. Measured on the
// H100 at the flagship layer (B=1,024; B=256): the kernel 1.421 ms (0.369)
// against 1.326 (0.334) without the pool term; each thread loading its 32
// values itself, 1.571 (0.409); the design that adds P @ dpool^T as one more
// wgmma a head (A a 1/16 staircase in shared memory, B a [256 b, 16 u] box
// of dpool by TMA with the 32-byte swizzle), 2.036 (0.528).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kMaxH = 128;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

struct Dims {
  long long d, B;
  int H, nb, blk, EH, O;
};

// The pool residual's cotangent dpool[n, b, u] at p + n*sn + b*sb + u, grp
// rows of g4 a pool column, inv = 1/grp as float32, vec: grp = 16 and the
// 4 values a column a tile 8-byte aligned; p == nullptr: no pool term
// (fused_block_bwd_wgmma).
struct PoolCot {
  const bf16* p;
  long long sn, sb;
  int grp;
  float inv;
  bool vec;
};

// Per head: the first row of this 64-row tile's source block in the flat
// [H*d] stream, its token and its first row of w (fused_block_bwd_wgmma).
struct HeadCoords {
  long long start[kMaxH];
  int n[kMaxH];
  int e0[kMaxH];
};

__device__ __forceinline__ void head_coords(HeadCoords& hc, const int* __restrict__ binv,
                                            const Dims& p) {
  const int per = p.blk / 64;  // 64-row tiles in one block of the table
  const long long jb = blockIdx.x / per, sub = blockIdx.x % per;
  for (int h = threadIdx.x; h < p.H; h += kThreads) {
    const long long st =
        h * p.d + static_cast<long long>(binv[h * static_cast<long long>(p.nb) + jb]) * p.blk +
        sub * 64;
    hc.start[h] = st;
    hc.n[h] = static_cast<int>(st / p.EH);
    hc.e0[h] = static_cast<int>(st % p.EH);
  }
  __syncthreads();
}

// ------------------------------------------------------- the grouped schedule

constexpr int kMaxPairs = 256;  // (head, slab) pairs a block: H * J <= 256

// A block's schedule, in shared memory. Pair i = (head i / J, slab i % J).
struct Schedule {
  unsigned long long key[kMaxPairs];  // (token, head, slab); past every valid key if absent
  long long start[kMaxPairs];         // the slab's first row in the flat [H*d] stream
  int n[kMaxPairs];                   // its token
  int e0[kMaxPairs];                  // its first row of w
  short sorted[kMaxPairs];            // pairs in schedule order
  short first[kMaxPairs + 1];         // position of step s's first pair; [steps] = pairs
  unsigned char starts[kMaxPairs];    // 1 where a step starts
  int steps;
};

// The pairs of this block (slabs blockIdx.x * J ..), ordered by key, cut
// into steps: each a run of pairs of one token, at most GS of them and no
// slab twice (so that no two rows of a step add into one row of dxt). Every
// thread of the block (NT) takes part; ends in __syncthreads.
template <int NT>
__device__ void build_schedule(Schedule& s, const int* __restrict__ binv, const Dims& p, int sb,
                               int J, int GS) {
  const int tid = threadIdx.x, P = p.H * J, per = p.blk / sb;
  const long long q0 = static_cast<long long>(blockIdx.x) * J;
  const int slabs = static_cast<int>(min(static_cast<long long>(J), p.d / sb - q0));
  for (int i = tid; i < P; i += NT) {
    const int h = i / J, jj = i % J;
    unsigned long long key = (1ull << 62) + i;
    if (jj < slabs) {
      const long long q = q0 + jj;
      const long long st = h * p.d +
                           static_cast<long long>(binv[h * static_cast<long long>(p.nb) + q / per]) * p.blk +
                           (q % per) * sb;
      const long long n = st / p.EH;
      s.start[i] = st;
      s.n[i] = static_cast<int>(n);
      s.e0[i] = static_cast<int>(st - n * p.EH);
      key = (static_cast<unsigned long long>(n) * p.H + h) * J + jj;
    }
    s.key[i] = key;
  }
  __syncthreads();
  for (int i = tid; i < P; i += NT) {  // keys are distinct: a rank sort
    const unsigned long long k = s.key[i];
    int r = 0;
    for (int q = 0; q < P; ++q) r += s.key[q] < k;
    s.sorted[r] = static_cast<short>(i);
  }
  __syncthreads();
  const int pairs = p.H * slabs;  // the valid pairs come first
  for (int i = tid; i < P; i += NT) {
    if (i >= pairs) {
      s.starts[i] = 0;
      continue;
    }
    const int tok = s.n[s.sorted[i]];
    if (i > 0 && s.n[s.sorted[i - 1]] == tok) continue;
    // the first pair of a token's run walks the run (J <= 16 slabs a block)
    unsigned used = 0;
    int cnt = 0;
    for (int k = i; k < pairs && s.n[s.sorted[k]] == tok; ++k) {
      const unsigned bit = 1u << (s.sorted[k] % J);
      if (cnt == GS || (used & bit)) {
        used = 0;
        cnt = 0;
      }
      s.starts[k] = cnt == 0;
      used |= bit;
      ++cnt;
    }
  }
  __syncthreads();
  if (tid < 32) {
    int base = 0;
    for (int i0 = 0; i0 < P; i0 += 32) {
      const int i = i0 + tid;
      const bool f = i < P && s.starts[i];
      const unsigned bal = __ballot_sync(0xffffffffu, f);
      if (f) s.first[base + __popc(bal & ((1u << tid) - 1u))] = static_cast<short>(i);
      base += __popc(bal);
    }
    if (tid == 0) {
      s.steps = base;
      s.first[base] = static_cast<short>(pairs);
    }
  }
  __syncthreads();
}

// ------------------------------------------------------- grouped, bf16

struct GbCfg {
  static constexpr int BT = 128;                             // batch columns a block
  static constexpr int RMAX = 256;                           // rows of dxt a block
  static constexpr int DY_BOX = BT * 128;                    // dy [BT b, 64 O]
  static constexpr int STAGE = DY_BOX + wg::kBoxBytes;       // then the step's 64 slab rows
  static constexpr int STAGES = 3;
  static constexpr int LDA = BT + 8;  // the sums' row stride: a quad's float2 pairs of 8 rows in 2 wavefronts
  static constexpr int THREADS = 288;  // two consumer warpgroups, then the producer warp
  static constexpr int SMEM = STAGES * STAGE + RMAX * LDA * 4 + 1024;
};

__global__ void __launch_bounds__(GbCfg::THREADS, 1)
fused_block_bwd_grouped_bf16_kernel(const __grid_constant__ CUtensorMap wmap,
                                    const __grid_constant__ CUtensorMap dymap,
                                    const bf16* __restrict__ s4, const int* __restrict__ binv,
                                    bf16* __restrict__ out, Dims p, int sb, int J) {
  using C = GbCfg;
  constexpr int S = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  __shared__ Schedule sch;
  __shared__ wg::Ring<S> ring;
  unsigned char* smem = wg::align1024(smem_raw);
  float* acc = reinterpret_cast<float*>(smem + S * C::STAGE);  // [J sb][LDA]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = 64 / sb, rows = J * sb, nko = (p.O + 63) / 64;
  const int b0 = static_cast<int>(blockIdx.y) * C::BT;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows;
  if (tid == 0) ring.init(4);  // a stage is one warpgroup's
  for (int i = tid; i < rows * C::LDA / 4; i += C::THREADS)
    reinterpret_cast<float4*>(acc)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  build_schedule<C::THREADS>(sch, binv, p, sb, J, G);
  const int steps = sch.steps;

  if (warp == 8) {
    // the producer: step s, O chunk c is ring step s * nko + c
    if (lane == 0) {
      int i = 0;
      for (int s = 0; s < steps; ++s) {
        const int first = sch.first[s], cnt = sch.first[s + 1] - first;
        const int tok = sch.n[sch.sorted[first]];
        for (int c = 0; c < nko; ++c, ++i) {
          uint64_t* bar = ring.acquire(i, C::DY_BOX + cnt * sb * 128);
          unsigned char* st = smem + (i % S) * C::STAGE;
          wg::tma_load_3d(st, &dymap, bar, c * 64, b0, tok);
          for (int k = 0; k < cnt; ++k)
            wg::tma_load_2d(st + C::DY_BOX + k * sb * 128, &wmap, bar, c * 64,
                            sch.e0[sch.sorted[first + k]]);
        }
      }
    }
    __syncwarp();
  } else {
    // warpgroup g takes steps g, g + 2, ...; thread (warp, lane) holds rows
    // r0 and r0 + 8 of the step's 64 (slots of sb rows): part[4c + 2 half +
    // e] is row r0 + 8 half, batch column 8c + cq + e
    const int g = warp / 4, r0 = (warp % 4) * 16 + lane / 4, cq = (lane % 4) * 2;
    const uint32_t base = wg::smem_u32(smem);
    float part[64];
    for (int s = g; s < steps; s += 2) {
      // a full barrier tells phases apart by parity only: wait for step s's
      // stages once step s - 1's have all been waited for
      if (s > 0) wg::named_barrier(3 + s % 2, 256);
      const int first = sch.first[s], cnt = sch.first[s + 1] - first;
      const int i0 = s * nko;
      for (int c = 0; c < nko; ++c) {
        const int i = i0 + c;
        ring.wait_full(i);
        const uint32_t st = base + (i % S) * C::STAGE;
        wg::fence_operands(part);
        wg::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wg::wgmma_m64n128k16<0>(part, wg::desc_k_major(st + C::DY_BOX + kk * 32),
                                  wg::desc_k_major(st + kk * 32), c > 0 || kk > 0);
        wg::wgmma_commit();
        if (c > 0) {
          wg::wgmma_wait<1>();
          if (lane == 0) ring.release(i - 1);
          __syncwarp();
        }
      }
      if (s + 1 < steps) wg::named_arrive(3 + (s + 1) % 2, 256);
      wg::wgmma_wait<0>();
      wg::fence_operands(part);
      if (lane == 0) ring.release(i0 + nko - 1);
      __syncwarp();
      // the signed adds of step s come after those of step s - 1
      if (s > 0) wg::named_barrier(1 + s % 2, 256);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + 8 * half, slot = r / sb;
        if (slot < cnt) {
          const int pr = sch.sorted[first + slot], t = r % sb;
          const float sg = __bfloat162float(s4[sch.start[pr] + t]);
          float* row = acc + ((pr % J) * sb + t) * C::LDA + cq;
#pragma unroll
          for (int c = 0; c < 16; ++c) {
            float2* a = reinterpret_cast<float2*>(row + 8 * c);
            float2 v = *a;
            v.x += sg * part[4 * c + 2 * half];
            v.y += sg * part[4 * c + 2 * half + 1];
            *a = v;
          }
        }
      }
      if (s + 1 < steps) {
        __threadfence_block();
        wg::named_arrive(1 + (s + 1) % 2, 256);
      }
    }
  }
  __syncthreads();
  const int rv = static_cast<int>(min(static_cast<long long>(rows), p.d - row0));
  const bool pairs = p.B % 2 == 0;  // then a pair never straddles the end of a row
  for (int i = tid; i < rv * (C::BT / 2); i += C::THREADS) {
    const int r = i / (C::BT / 2), c = (i % (C::BT / 2)) * 2;
    const long long col = b0 + c;
    const float* a = acc + r * C::LDA + c;
    bf16* o = out + (row0 + r) * p.B + col;
    if (pairs && col < p.B) {
      *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a[0], a[1]);
    } else {
      if (col < p.B) o[0] = __float2bfloat16_rn(a[0]);
      if (col + 1 < p.B) o[1] = __float2bfloat16_rn(a[1]);
    }
  }
}

// ------------------------------------------------------- grouped, float32

struct GfCfg {
  static constexpr int BT = 128, RMAX = 128, KC = 16;
  static constexpr int LDK = KC + 4;  // 80-byte rows: 8 lanes' float4 reads cover the 32 banks
  static constexpr int LDA = BT + 4;
  static constexpr int THREADS = 128;
  static constexpr int STAGE = (64 + BT) * LDK;  // floats: the step's 64 slab rows, then dy
  static constexpr int SMEM = (2 * STAGE + RMAX * LDA) * 4;
};

__global__ void __launch_bounds__(GfCfg::THREADS, 2)
fused_block_bwd_grouped_f32_kernel(const float* __restrict__ dy, const float* __restrict__ w,
                                   const float* __restrict__ s4, const int* __restrict__ binv,
                                   float* __restrict__ out, Dims p, int sb, int J) {
  using C = GfCfg;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Schedule sch;
  float* stages = reinterpret_cast<float*>(smem_raw);
  float* acc = stages + 2 * C::STAGE;  // [J sb][LDA]
  const int tid = threadIdx.x, warp = tid / 32, ty = tid / 16, tx = tid % 16;
  const int G = 64 / sb, rows = J * sb, nk = (p.O + C::KC - 1) / C::KC;
  const long long b0 = static_cast<long long>(blockIdx.y) * C::BT;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows;
  for (int i = tid; i < rows * C::LDA / 4; i += C::THREADS)
    reinterpret_cast<float4*>(acc)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  build_schedule<C::THREADS>(sch, binv, p, sb, J, G);
  const int total = sch.steps * nk;

  // tile t: step t / nk, O chunk t % nk; the step's slabs stacked as rows
  // [k sb, k sb + sb) of the stage, dy's batch columns after them. Rows of
  // a missing slab are not loaded: their warps skip the products.
  auto fetch = [&](int t) {
    float* as = stages + (t & 1) * C::STAGE;
    float* bs = as + 64 * C::LDK;
    const int s = t / nk, o0 = (t % nk) * C::KC;
    const int first = sch.first[s], cnt = sch.first[s + 1] - first;
    for (int i = tid; i < cnt * sb * (C::KC / 4); i += C::THREADS) {
      const int r = i / (C::KC / 4), c = (i % (C::KC / 4)) * 4;
      const bool ok = o0 + c < p.O;
      const float* src =
          w + (static_cast<long long>(sch.e0[sch.sorted[first + r / sb]]) + r % sb) * p.O + o0 + c;
      cp_async16(as + r * C::LDK + c, ok ? src : w, ok);
    }
    const float* dsrc = dy + (static_cast<long long>(sch.n[sch.sorted[first]]) * p.B + b0) * p.O + o0;
    for (int i = tid; i < C::BT * (C::KC / 4); i += C::THREADS) {
      const int r = i / (C::KC / 4), c = (i % (C::KC / 4)) * 4;
      const bool ok = b0 + r < p.B && o0 + c < p.O;
      cp_async16(bs + r * C::LDK + c, ok ? dsrc + static_cast<long long>(r) * p.O + c : dy, ok);
    }
    cp_async_commit();
  };

  // thread (ty, tx): rows 8 ty + i of the step's 64 (all in slab 16 warp /
  // sb), batch columns tx + 16 j
  float part[8][8];
  if (total > 0) fetch(0);
  for (int t = 0; t < total; ++t) {
    if (t + 1 < total) {
      fetch(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int s = t / nk, kc = t % nk;
    const int first = sch.first[s], cnt = sch.first[s + 1] - first;
    const bool mine = (16 * warp) / sb < cnt;
    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) part[i][j] = 0.f;
    }
    if (mine) {
      const float* as = stages + (t & 1) * C::STAGE;
      const float* bs = as + 64 * C::LDK;
#pragma unroll
      for (int k = 0; k < C::KC; k += 4) {
        float4 a[8], b[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = *reinterpret_cast<const float4*>(as + (8 * ty + i) * C::LDK + k);
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = *reinterpret_cast<const float4*>(bs + (tx + 16 * j) * C::LDK + k);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float v = fmaf(a[i].x, b[j].x, part[i][j]);
            v = fmaf(a[i].y, b[j].y, v);
            v = fmaf(a[i].z, b[j].z, v);
            part[i][j] = fmaf(a[i].w, b[j].w, v);
          }
      }
      if (kc == nk - 1) {  // the step's products are complete: signed adds
        const int pr = sch.sorted[first + (8 * ty) / sb];
        const float* sg = s4 + sch.start[pr];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int t8 = (8 * ty + i) % sb;
          const float sgn = sg[t8];
          float* row = acc + ((pr % J) * sb + t8) * C::LDA + tx;
#pragma unroll
          for (int j = 0; j < 8; ++j) row[16 * j] += sgn * part[i][j];
        }
      }
    }
    __syncthreads();  // the next fetch overwrites this stage; the next step's adds come after
  }
  const int rv = static_cast<int>(min(static_cast<long long>(rows), p.d - row0));
  for (int i = tid; i < rv * C::BT; i += C::THREADS) {
    const int r = i / C::BT, c = i % C::BT;
    if (b0 + c < p.B) out[(row0 + r) * p.B + b0 + c] = acc[r * C::LDA + c];
  }
}

// ---------------------------------------------------------------- wgmma, bf16

// two warpgroups of 128 batch columns a block
struct B8Cfg {
  static constexpr int BT = 256;
  static constexpr int STAGE = wg::kBoxBytes * 5;  // w [64 rows, 64 O], dy [256 b, 64 O]
  static constexpr int STAGES = 5;
  static constexpr int THREADS = 256;
  static constexpr int SMEM = STAGES * STAGE + 1024;
};

__global__ void __launch_bounds__(B8Cfg::THREADS, 1)
fused_block_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                             const __grid_constant__ CUtensorMap dymap,
                             const bf16* __restrict__ s4, const int* __restrict__ binv,
                             bf16* __restrict__ out, Dims p, PoolCot pool) {
  using C = B8Cfg;
  constexpr int S = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  __shared__ HeadCoords hc;
  __shared__ wg::Ring<S> ring;
  __shared__ __align__(16) bf16 dps[2][2][4][128];  // [head parity][warpgroup][warp][column]
  unsigned char* smem = wg::align1024(smem_raw);
  const int tid = threadIdx.x;
  const int b0 = static_cast<int>(blockIdx.y) * C::BT;
  const long long row0 = static_cast<long long>(blockIdx.x) * 64;
  const int nko = (p.O + 63) / 64, steps = p.H * nko;
  // step i = (head h, O chunk o0): w rows [e0_h, e0_h + 64) and dy[n_h, b0 : b0 + BT]
  auto load = [&](int i) {
    const int h = i / nko, o0 = (i % nko) * 64;
    uint64_t* bar = ring.acquire(i, C::STAGE);
    unsigned char* st = smem + (i % S) * C::STAGE;
    wg::tma_load_2d(st, &wmap, bar, o0, hc.e0[h]);
    wg::tma_load_3d(st + wg::kBoxBytes, &dymap, bar, o0, b0, hc.n[h]);
  };
  if (tid == 0) ring.init(C::THREADS / 32);
  head_coords(hc, binv, p);  // ends in __syncthreads
  if (tid == 0)
    for (int i = 0; i < S && i < steps; ++i) load(i);

  // warpgroup g owns batch columns [b0 + 128 g, b0 + 128 g + 128)
  const int g = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4, cq = (lane % 4) * 2;
  auto retire = [&](int i) {  // step i's products are done
    if (lane == 0) ring.release(i);
    if (tid == 0 && i + S < steps) load(i + S);
    __syncwarp();
  };
  float acc[64], part[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] = 0.f;
  const uint32_t base = wg::smem_u32(smem);
  // pre[w]: the pool cotangent of this thread's batch column 128 g + tid %
  // 128 in warp w's pool column
  __align__(8) bf16 pre[4];
  int i = 0;
  for (int h = 0; h < p.H; ++h) {
    if (pool.p != nullptr) {
      const long long col = b0 + g * 128 + tid % 128;
      const bf16* src = pool.p + hc.n[h] * pool.sn + col * pool.sb;
      if (pool.vec) {
        uint2 v = make_uint2(0u, 0u);
        if (col < p.B) v = *reinterpret_cast<const uint2*>(src + hc.e0[h] / 16);
        *reinterpret_cast<uint2*>(pre) = v;
      } else {
#pragma unroll
        for (int w = 0; w < 4; ++w)
          pre[w] = col < p.B ? src[(hc.e0[h] + w * 16) / pool.grp] : __float2bfloat16_rn(0.f);
      }
    }
    for (int oc = 0; oc < nko; ++oc, ++i) {
      ring.wait_full(i);
      const uint32_t as = base + (i % S) * C::STAGE;
      const uint32_t bs = as + wg::kBoxBytes + g * 2 * wg::kBoxBytes;  // 128 rows of 128 B
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wg::wgmma_m64n128k16<0>(part, wg::desc_k_major(as + kk * 32),
                                wg::desc_k_major(bs + kk * 32), oc > 0 || kk > 0);
      wg::wgmma_commit();
      if (oc > 0) {
        wg::wgmma_wait<1>();
        retire(i - 1);
      }
    }
    wg::wgmma_wait<0>();
    wg::fence_operands(part);
    retire(i - 1);  // the head's last step
    if (pool.p != nullptr) {
      // heads alternate buffers: a thread writes this one again two heads
      // on, after every thread of its warpgroup has passed the next barrier
      bf16* buf = &dps[h & 1][g][0][0];
#pragma unroll
      for (int w = 0; w < 4; ++w) buf[w * 128 + tid % 128] = pre[w];
      wg::named_barrier(1 + g, 128);
      const bf16* mine = buf + warp * 128 + cq;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(mine + 8 * c));
#pragma unroll
        for (int j = 0; j < 4; ++j)  // rows r0 and r0 + 8 share the column's value
          part[4 * c + j] = __fadd_rn(part[4 * c + j], __fmul_rn(j % 2 ? v.y : v.x, pool.inv));
      }
    }
    const bf16* sg = s4 + hc.start[h];
    const float sg0 = __bfloat162float(sg[r0]), sg1 = __bfloat162float(sg[r0 + 8]);
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      acc[4 * c] += sg0 * part[4 * c];
      acc[4 * c + 1] += sg0 * part[4 * c + 1];
      acc[4 * c + 2] += sg1 * part[4 * c + 2];
      acc[4 * c + 3] += sg1 * part[4 * c + 3];
    }
  }

  // acc[4c + 2 half + e]: row r0 + 8 half, batch column 128 g + 8c + cq + e
  const bool pairs = p.B % 2 == 0;  // then a pair never straddles the end of a row
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    const long long col = b0 + g * 128 + c * 8 + cq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      bf16* o = out + (row0 + r0 + 8 * half) * p.B + col;
      const float v0 = acc[4 * c + 2 * half], v1 = acc[4 * c + 2 * half + 1];
      if (pairs && col < p.B) {
        *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
      } else {
        if (col < p.B) o[0] = __float2bfloat16_rn(v0);
        if (col + 1 < p.B) o[1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16 (dy, w, s4 and out in that dtype).
// Requires blk % 16 == 0, EH % blk == 0, N*EH == H*d with d = nb*blk,
// H <= 128, O % 8 == 0 and 16-byte aligned dy and w (16-byte copies and TMA
// boxes). The plan (ops/kernels/fused_block_bwd.py::grouped_plan): sb rows a
// slab, 64, 32 or 16 dividing blk; J slabs a block, H * J <= 256 and J * sb
// at most 256 rows (bf16) or 128 (float32). Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int fused_block_bwd_grouped(int dtype_code, const void* dy, const void* w,
                                       const void* s4, const void* binv, void* out, long long H,
                                       long long nb, long long blk, long long N, long long EH,
                                       long long O, long long B, int sb, int J, void* stream) {
  if (H < 1 || H > kMaxH || nb < 1 || blk < 16 || blk % 16 || N < 1 || EH < 1 || EH % blk ||
      O < 8 || O % 8 || B < 1 || N * EH != H * nb * blk || EH > 0x7fffffffLL ||
      O > 0x7fffffffLL || nb > 0x7fffffffLL || N > 0x7fffffffLL || B > 0x7fffffffLL ||
      (dtype_code != 0 && dtype_code != 1) || reinterpret_cast<uintptr_t>(dy) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return cudaErrorInvalidValue;
  Dims p;
  p.d = nb * blk;
  p.B = B;
  p.H = static_cast<int>(H);
  p.nb = static_cast<int>(nb);
  p.blk = static_cast<int>(blk);
  p.EH = static_cast<int>(EH);
  p.O = static_cast<int>(O);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bt = dtype_code == 1 ? GbCfg::BT : GfCfg::BT;
  if ((sb != 16 && sb != 32 && sb != 64) || blk % sb || J < 1 || p.H * J > kMaxPairs ||
      J * sb > (dtype_code == 1 ? GbCfg::RMAX : GfCfg::RMAX))
    return cudaErrorInvalidValue;
  const long long tiles = (p.d / sb + J - 1) / J, btiles = (B + bt - 1) / bt;
  if (tiles > 0x7fffffffLL || btiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(btiles));
  int e = 0;
  if (dtype_code == 0) {
    static std::atomic<bool> raised[wg::kMaxDevices];
    if ((e = wg::raise_smem_once(fused_block_bwd_grouped_f32_kernel, GfCfg::SMEM, raised)) != 0)
      return e;
    fused_block_bwd_grouped_f32_kernel<<<grid, GfCfg::THREADS, GfCfg::SMEM, st>>>(
        static_cast<const float*>(dy), static_cast<const float*>(w), static_cast<const float*>(s4),
        static_cast<const int*>(binv), static_cast<float*>(out), p, sb, J);
    return static_cast<int>(cudaGetLastError());
  }
  CUtensorMap wm, dym;
  {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(O), static_cast<cuuint64_t>(EH)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(O) * 2};
    const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(sb)};
    e = wg::encode_bf16(&wm, w, 2, dims, strides, box);
  }
  if (e == 0) {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(O), static_cast<cuuint64_t>(B),
                                static_cast<cuuint64_t>(N)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(O) * 2,
                                   static_cast<cuuint64_t>(B) * O * 2};
    const cuuint32_t box[3] = {64, GbCfg::BT, 1};
    e = wg::encode_bf16(&dym, dy, 3, dims, strides, box);
  }
  if (e != 0) return e;
  static std::atomic<bool> raised[wg::kMaxDevices];
  if ((e = wg::raise_smem_once(fused_block_bwd_grouped_bf16_kernel, GbCfg::SMEM, raised)) != 0)
    return e;
  fused_block_bwd_grouped_bf16_kernel<<<grid, GbCfg::THREADS, GbCfg::SMEM, st>>>(
      wm, dym, static_cast<const bf16*>(s4), static_cast<const int*>(binv),
      static_cast<bf16*>(out), p, sb, J);
  return static_cast<int>(cudaGetLastError());
}

// bfloat16 only (dy, w, s4, dpool and out); the contract of fused_block_bwd
// with blk % 64 == 0; dy, w and out 16-byte aligned. dpool [N, B, O] at
// dpool + n*dp_sn + b*dp_sb + u (elements), or null for no pool term; with
// one, grp a multiple of 16 and EH == O * grp. Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int fused_block_bwd_wgmma(const void* dy, const void* w, const void* s4,
                                     const void* binv, void* out, long long H, long long nb,
                                     long long blk, long long N, long long EH, long long O,
                                     long long B, const void* dpool, long long dp_sn,
                                     long long dp_sb, long long grp, void* stream) {
  if (H < 1 || H > kMaxH || nb < 1 || blk < 64 || blk % 64 || N < 1 || EH < 1 || EH % blk ||
      O < 8 || O % 8 || B < 1 || N * EH != H * nb * blk || EH > 0x7fffffffLL ||
      O > 0x7fffffffLL || B > 0x7fffffffLL || N > 0x7fffffffLL ||
      (nb * blk) / 64 > 0x7fffffffLL || (B + 255) / 256 > 65535 ||
      reinterpret_cast<uintptr_t>(dy) % 16 || reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return cudaErrorInvalidValue;
  if (dpool != nullptr &&
      (grp < 16 || grp % 16 || EH != O * grp || dp_sn < 0 || dp_sb < 0 ||
       reinterpret_cast<uintptr_t>(dpool) % 2))
    return cudaErrorInvalidValue;
  PoolCot pool;
  pool.p = static_cast<const bf16*>(dpool);
  pool.sn = dp_sn;
  pool.sb = dp_sb;
  pool.grp = dpool != nullptr ? static_cast<int>(grp) : 1;
  pool.inv = static_cast<float>(1.0 / static_cast<double>(pool.grp));
  pool.vec = grp == 16 && dp_sn % 4 == 0 && dp_sb % 4 == 0 &&
             reinterpret_cast<uintptr_t>(dpool) % 8 == 0;
  Dims p;
  p.d = nb * blk;
  p.B = B;
  p.H = static_cast<int>(H);
  p.nb = static_cast<int>(nb);
  p.blk = static_cast<int>(blk);
  p.EH = static_cast<int>(EH);
  p.O = static_cast<int>(O);
  CUtensorMap wm, dym;
  int e = wg::encode_rows(&wm, w, EH, O);
  if (e == 0) {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(O), static_cast<cuuint64_t>(B),
                                static_cast<cuuint64_t>(N)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(O) * 2,
                                   static_cast<cuuint64_t>(B) * O * 2};
    const cuuint32_t box[3] = {64, B8Cfg::BT, 1};
    e = wg::encode_bf16(&dym, dy, 3, dims, strides, box);
  }
  if (e != 0) return e;
  using C = B8Cfg;
  static std::atomic<bool> raised[wg::kMaxDevices];
  if ((e = wg::raise_smem_once(fused_block_bwd_wgmma_kernel, C::SMEM, raised)) != 0) return e;
  const dim3 grid(static_cast<unsigned>(p.d / 64), static_cast<unsigned>((B + C::BT - 1) / C::BT));
  fused_block_bwd_wgmma_kernel<<<grid, C::THREADS, C::SMEM, static_cast<cudaStream_t>(stream)>>>(
      wm, dym, static_cast<const bf16*>(s4), static_cast<const int*>(binv),
      static_cast<bf16*>(out), p, pool);
  return static_cast<int>(cudaGetLastError());
}
