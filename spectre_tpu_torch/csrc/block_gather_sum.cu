// block_gather_sum: the permutation-mix backward for block-structured tables.
//
//   dxt[jb*blk + t, :] = sum_h g[h*d + binv[h, jb]*blk + t, :]
//   g [H*d, B] row-major, binv int32 [H, d/blk], dxt [d, B] row-major.
//
// Replaces the TPU kernel spectre_tpu/ops/pallas/bwd_gather.py::
// block_gather_sum_pallas (same contract: float32 sum over heads in head
// order, one cast). Every [blk, B] source block is blk*B contiguous elements
// here, so this is gather_sum.cuh with a chunk of blk*B elements; that file
// says what bounds the kernel and what its design does about it. The TPU
// form's staging buffers, head chunks and 8-row alignment do not come over:
// any blk >= 1 and any B >= 1 run.

#include "gather_sum.cuh"

// elem_bytes: 2 (bf16) or 4 (f32). Returns cudaGetLastError() after launch.
extern "C" int block_gather_sum(const void* g, const void* binv, void* out, long long heads,
                                long long nb, long long blk, long long batch, int elem_bytes,
                                void* stream) {
  if (blk <= 0 || batch <= 0) return cudaErrorInvalidValue;
  return gather_sum::run(g, binv, out, heads, nb, blk * batch, elem_bytes, stream);
}
