// block_scatter_rows: the permutation-mix forward for block-structured tables.
//
//   out[h*d + jb*blk + t, :] = xt[bsrc[h, jb]*blk + t, :]
//   xt [d, B] row-major, bsrc int32 [H, d/blk], out [H*d, B] row-major.
//
// Replaces the TPU kernel spectre_tpu/ops/pallas/bwd_gather.py::
// block_scatter_rows_pallas (same contract and layout).
//
// What bounds it on the H100: it is a pure copy. Every output chunk of
// blk*B elements is contiguous in both xt and out, so the kernel moves the
// H*d*B output bytes once (write stream) and reads each source chunk H times
// (the [d, B] source is small enough to stay in the 50 MB L2 at the
// flagship's d=33,280, B<=256 in bf16). At bucket 256 that is ~272.6 MB
// written per layer; the floor is that over the HBM bandwidth.
//
// Design: a 2-D grid of (output chunk, 4 KB part of it) with the chunk on
// grid x, so blocks launched together write the same part of many chunks;
// each thread moves one 16-byte vector (streaming store: the output is far
// larger than L2 and read once). On the H100 this order runs the write
// stream faster than one block streaming each whole chunk (PERF.md has the
// times); which memory-system effect causes it is not known. Each block
// reads its own bsrc entry. Chunks shorter than a block (single rows, the
// table of mix_block=0) share one block, so that every thread still moves a
// vector. When the chunk size or a base pointer is not
// 16-byte aligned, the copy goes element by element instead. None of the
// TPU constraints (B % 128 lane gate, VMEM residency cap, 8-row alignment)
// apply here: every B >= 1 goes through this kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxParts = 65535;  // grid y limit; parts loop beyond it

// V: the unit of the copy, uint4 (16 bytes) or the element type.
// units: units per chunk. cpb: chunks per block (1 when units >= kThreads).
template <typename V>
__global__ void __launch_bounds__(kThreads)
block_scatter_rows_kernel(const V* __restrict__ xt, const int* __restrict__ bsrc,
                          V* __restrict__ out, long long chunks, long long nb,
                          long long units, int cpb) {
  long long chunk, first, step;  // chunk: flat (h, jb) == output chunk index
  if (cpb == 1) {
    chunk = blockIdx.x;
    first = static_cast<long long>(blockIdx.y) * kThreads + threadIdx.x;
    step = static_cast<long long>(gridDim.y) * kThreads;
  } else {  // several short chunks in one block; one unit per thread
    const int local = threadIdx.x / static_cast<int>(units);
    chunk = static_cast<long long>(blockIdx.x) * cpb + local;
    first = threadIdx.x - local * units;
    step = units;
    if (local >= cpb || chunk >= chunks) return;
  }
  long long src = bsrc[chunk];
  // out-of-range indices clamp, as the TPU path's take(mode="clip") does;
  // the model validates its tables before they reach here
  src = src < 0 ? 0 : (src >= nb ? nb - 1 : src);
  const V* s = xt + src * units;
  V* d = out + chunk * units;
  for (long long i = first; i < units; i += step) __stcs(d + i, __ldg(s + i));
}

template <typename V>
void launch(const void* xt, const int* bsrc, void* out, long long chunks, long long nb,
            long long chunk_bytes, cudaStream_t st) {
  const long long units = chunk_bytes / static_cast<long long>(sizeof(V));
  dim3 grid;
  int cpb = 1;
  if (units >= kThreads) {
    long long parts = (units + kThreads - 1) / kThreads;
    parts = parts < kMaxParts ? parts : kMaxParts;
    grid = dim3(static_cast<unsigned>(chunks), static_cast<unsigned>(parts));
  } else {
    cpb = static_cast<int>(kThreads / units);
    grid = dim3(static_cast<unsigned>((chunks + cpb - 1) / cpb));
  }
  block_scatter_rows_kernel<V><<<grid, kThreads, 0, st>>>(
      static_cast<const V*>(xt), bsrc, static_cast<V*>(out), chunks, nb, units, cpb);
}

}  // namespace

// elem_bytes: 2 (bf16) or 4 (f32). Returns cudaGetLastError() after launch.
extern "C" int block_scatter_rows(const void* xt, const void* bsrc, void* out,
                                  long long heads, long long nb, long long blk,
                                  long long batch, int elem_bytes,
                                  void* stream) {
  if (heads <= 0 || nb <= 0 || blk <= 0 || batch <= 0) return cudaErrorInvalidValue;
  if (elem_bytes != 2 && elem_bytes != 4) return cudaErrorInvalidValue;
  const long long chunks = heads * nb;
  if (chunks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long chunk_bytes = blk * batch * elem_bytes;
  const bool vec = chunk_bytes % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(xt) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* idx = static_cast<const int*>(bsrc);
  if (vec) {
    launch<uint4>(xt, idx, out, chunks, nb, chunk_bytes, st);
  } else if (elem_bytes == 2) {
    launch<unsigned short>(xt, idx, out, chunks, nb, chunk_bytes, st);
  } else {
    launch<unsigned int>(xt, idx, out, chunks, nb, chunk_bytes, st);
  }
  return static_cast<int>(cudaGetLastError());
}
