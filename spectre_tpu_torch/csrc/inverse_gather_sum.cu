// inverse_gather_sum: the permutation-mix backward for uniform tables.
//
//   dxt[j, :] = sum_h g[h*d + inv[h, j], :]
//   g [H*d, B] row-major, inv int32 [H, d] (perms[h, inv[h, j]] = j), dxt [d, B].
//
// Replaces the TPU kernel spectre_tpu/ops/pallas/bwd_gather.py::
// inverse_gather_sum_pallas. That kernel fetches the aligned 8-row tile
// around every wanted row and selects the row with a one-hot product,
// because TPU device memory is tiled; here a row is B contiguous elements
// and is read directly, so none of that comes over. This is gather_sum.cuh
// with a chunk of one row: rows shorter than a block (B < 2048 in bf16)
// share a block, 256 / (B*2/16) rows each. It moves the same bytes as
// block_gather_sum; only the length of a contiguous read differs.

#include "gather_sum.cuh"

// elem_bytes: 2 (bf16) or 4 (f32). Returns cudaGetLastError() after launch.
extern "C" int inverse_gather_sum(const void* g, const void* inv, void* out, long long heads,
                                  long long d, long long batch, int elem_bytes, void* stream) {
  if (batch <= 0) return cudaErrorInvalidValue;
  return gather_sum::run(g, inv, out, heads, d, batch, elem_bytes, stream);
}
