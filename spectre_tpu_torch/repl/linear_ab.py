"""Kernel 2's forward at the shapes its cluster kernels took over and at the
flagship's on its wgmma kernel, kernel 5 at the tables its token-grouped
kernel takes, kernel 2's backward above N = 1,024, the Walsh-Hadamard
transform and kernel 2's column-shard entries, timed in two trees of the
repository in turns on one card.

    python -m spectre_tpu_torch.repl.linear_ab [--parent DIR] [--out FILE]

Times ``spectre_tpu_torch.ops.kernels.fused_spectre_linear`` (whichever
kernel ``forward_kernel`` picks in that tree) beside the cuBLAS chain
``gelu(layer_norm(addmm(b, x, w)))`` (+ x when K == N, a yardstick the port
never calls), each back to back and on the device alone
(``utils/timing.py``), with and without the saved ``h``, at:

- the head, (M x 512)(512 x 100) bf16, at the serving buckets M = 1, 2, 7,
  64, 256 and the train batches 256 and 1,024;
- the MNIST head, (64 x 16)(16 x 10) bf16;
- ``repl/perf.py linear``'s 8 rows in float32 at dims 1,024, 2,048, 4,096;
- (4,160 x 1,536)(1,536 x 1,536) float32 and (4,160 x 768)(768 x 1,100)
  bf16 (C6);
- the wide bf16 shapes (4,160 x 1,536)(1,536 x 1,536), (4,160 x 768)(768 x
  2,048) and (4,160 x 768)(768 x 1,024), and (1,040 x 512)(512 x 4,096) and
  (512 x 4,608), at and beyond the wide cluster kernel's reach;
- the flagship's linear1 and linear3 at B = 256, (16,640 x 512)(512 x 768)
  and (16,640 x 768)(768 x 512) bf16, on the wgmma kernel.

Then ``fused_block_bwd`` (whichever kernel ``block_bwd_kernel`` picks in
that tree) beside the chain it fuses (the dg4 product, the signs,
``block_gather_sum``) at the flagship mix backward's shape (d = 33,280, H =
16, 65 tokens, O = 512) for B = 256 and 1,024: bf16 with blk 16 and 32,
float32 with blk 16 and 64.

Then kernel 2's backward above N = 1,024 (``fused_spectre_linear_bwd``, the
wide chain and the two products) at the three C6 shapes in bf16 and float32,
at N = 4,096 and at N = 16,384 (beyond the registers' reach of the wide
chain): the whole backward, and the chain with its column-sum pass alone
(the C entry point called directly), each beside its bound; the chain's
bound is bytes, h and g read and dh written once, and separately with the
blocks' float32 partial rows written and read once. Then ``fwht`` at
[16,640, 512] and [16,640, 1,024] (the warp route), [4,160, 2,048], [4,160,
4,096], [1,040, 16,384] and [520, 32,768] in bf16, and [4,160, 4,096] in
float32, beside its bound (x read and written once).

Then kernel 2's column-shard backward entries (``chain_shard_sums`` and
``chain_shard_dh``, each with its column-sum pass) at ``chip_smoke.py``
phase 28's shards (SHARD_TAGS), beside their bounds. Then entry 2
(``sharded_ln_gelu``) at SHARD_LN_TAGS: the flagship's column shards, the
ragged ones, linear3's whole float32 rows and a whole row of 1,536, beside
its bound, its plain version and, on whole rows, the torch chain
``gelu(layer_norm(s + b)) + res`` (a yardstick the port never calls). Then
entry 1 (``fused_spectre_linear_shard_stats``) at SHARD_STATS_TAGS beside
its bound, its plain version and ``torch.addmm(b, x, w)`` (h alone).

With ``--parent DIR`` (an unpacked tree of another commit, its kernels built
into its own ``build/kernels/``) the shapes run in four processes in turns,
parent / this tree / this tree / parent, each importing its own tree's
package; the card's name and power limit and every turn's numbers go to
``--out`` as JSON, with each shape's bound (the larger of the bytes read and
written once over 3.35 TB/s and the operations over the dtype's peak).
``--root DIR`` runs one turn of the tree at DIR (what the turns call).
``--parts`` picks the groups (``fwd``, ``block_bwd``, ``bwd``, ``fwht``,
``shard_chain``, ``shard_ln``, ``shard_stats``; all by default).
``--chain-sweep`` times this tree's wide chain alone at the C6 shapes for each cap of
``WIDE_BLOCKS_PER_SM`` in 1 .. 8 instead; ``--shard-sweep`` entries 3 and 4
at the flagship's shards for each cap of ``SHARD_BLOCKS_PER_SM``, with each
kernel's share. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SHAPES = ([("bfloat16", m, 512, 100) for m in (1, 2, 7, 64, 256, 1024)]
          + [("bfloat16", 64, 16, 10)]
          + [("float32", 8, d, d) for d in (1024, 2048, 4096)]
          + [("float32", 4160, 1536, 1536), ("bfloat16", 4160, 768, 1100)]
          + [("bfloat16", 4160, 1536, 1536), ("bfloat16", 4160, 768, 2048),
             ("bfloat16", 4160, 768, 1024), ("bfloat16", 1040, 512, 4096),
             ("bfloat16", 1040, 512, 4608)]
          + [("bfloat16", 16640, 512, 768), ("bfloat16", 16640, 768, 512)])
# kernel 5: (dtype, blk) at the flagship mix backward's shape, and its batches
BLOCK_BWD_ROUTES = (("bfloat16", 16), ("bfloat16", 32), ("float32", 16), ("float32", 64))
BLOCK_BWD_BATCHES = (256, 1024)
# kernel 2's backward above N = 1,024: (rows, K, N), each in both dtypes
BWD_SHAPES = ((4160, 1536, 1536), (4160, 768, 2048), (4160, 768, 1100), (4160, 768, 4096),
              (1040, 512, 16384))
FWHT_SHAPES = (("bfloat16", 16640, 512), ("bfloat16", 16640, 1024), ("bfloat16", 4160, 2048),
               ("bfloat16", 4160, 4096), ("bfloat16", 1040, 16384), ("bfloat16", 520, 32768),
               ("float32", 4160, 4096))
# kernel 2's column-shard backward entries 3 and 4 at chip_smoke.py phase 28's
# shards: (dtype, batch, N, ranks), this rank's n = N / ranks columns of
# 65 x batch rows; the flagship's linear1 at both batches, the ragged and
# the tiled shards at B = 256
SHARD_TAGS = ([(dt, b, 768, size) for dt in ("bfloat16", "float32") for b in (256, 1024)
               for size in (2, 4)]
              + [(dt, 256, n_full, size) for dt in ("bfloat16", "float32")
                 for n_full, size in ((100, 4), (100, 2), (3072, 2))])
# entry 2 (sharded_ln_gelu): (dtype, batch, N, ranks) as SHARD_TAGS, the
# column shards of linear1 (768) and of the head (100, ragged); ranks 1:
# linear3's whole rows of N (the all-reduced float32 sum), and one wider
# than a warp's registers
SHARD_LN_TAGS = ([(dt, b, 768, size) for dt in ("bfloat16", "float32") for b in (256, 1024)
                  for size in (2, 4)]
                 + [(dt, 256, 100, size) for dt in ("bfloat16", "float32") for size in (4, 2)]
                 + [(dt, b, 512, 1) for dt in ("bfloat16", "float32") for b in (256, 1024)]
                 + [(dt, 256, 1536, 1) for dt in ("bfloat16", "float32")])
# entry 1 (fused_spectre_linear_shard_stats): (dtype, batch, N, ranks) as
# SHARD_TAGS, linear1's shards, the widest shard its bf16 kernel takes (768
# columns of 1,536) and the head's ragged 25 of 100 (the cluster kernel's
# statistics mode in both dtypes)
SHARD_STATS_TAGS = ([(dt, b, 768, size) for dt in ("bfloat16", "float32") for b in (256, 1024)
                     for size in (2, 4)]
                    + [("bfloat16", 256, 1536, 2)]
                    + [(dt, 256, 100, 4) for dt in ("bfloat16", "float32")])
PARTS = ("fwd", "block_bwd", "bwd", "fwht", "shard_chain", "shard_ln", "shard_stats")


def one_turn(root: str, parts=PARTS) -> dict:
    """Time every shape of ``parts`` with the package of the tree at
    ``root`` (first on the path, in place of this file's directory)."""
    sys.path[0] = root
    import torch

    from spectre_tpu_torch.ops import kernels

    if not torch.cuda.is_available():
        raise SystemExit("linear_ab: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = {}
    if "fwd" in parts:
        rows.update(fwd_turn(root, kernels))
    if "block_bwd" in parts:
        rows.update(block_bwd_turn(kernels))
    if "bwd" in parts:
        rows.update(bwd_turn(kernels))
    if "fwht" in parts:
        rows.update(fwht_turn(kernels))
    if "shard_chain" in parts:
        rows.update(shard_turn(kernels))
    if "shard_ln" in parts:
        rows.update(shard_ln_turn(kernels))
    if "shard_stats" in parts:
        rows.update(shard_stats_turn(kernels))
    return rows


def fwd_turn(root: str, kernels) -> dict:
    """Kernel 2's forward at SHAPES beside the cuBLAS chain."""
    import torch
    import torch.nn.functional as F

    from spectre_tpu_torch.utils.timing import (BF16_FLOPS, FP32_FLOPS, bound_ms, cuda_time_ms,
                                                device_time_ms)

    gen = torch.Generator().manual_seed(0)
    rows = {}
    for dt, m, k, n in SHAPES:
        dtype = getattr(torch, dt)
        x = torch.randn(m, k, generator=gen).to("cuda", dtype)
        w = torch.empty(k, n).uniform_(-k ** -0.5, k ** -0.5, generator=gen).to("cuda", dtype)
        b, beta = ((0.1 * torch.randn(n, generator=gen)).to("cuda", dtype) for _ in range(2))
        gamma = (1.0 + 0.1 * torch.randn(n, generator=gen)).to("cuda", dtype)
        args = (x, w, b, gamma, beta)

        def chain():
            y = F.gelu(F.layer_norm(torch.addmm(b, x, w), (n,), gamma, beta))
            return y + x if k == n else y

        it = 5 if m * k * n > 1e9 else 20
        fns = {"kernel_h": lambda: kernels.fused_spectre_linear(*args, save_h=True),
               "kernel": lambda: kernels.fused_spectre_linear(*args),
               "chain": chain}
        row = {"route": kernels.forward_kernel(dtype, k, n)}
        # x, W, b/gamma/beta read and out and h written once; bf16 on the tensor
        # cores, float32 on the FP32 pipes
        row["bound_ms"], row["bound_by"] = bound_ms(
            (m * k + k * n + 3 * n + 2 * m * n) * x.element_size(), 2 * m * k * n,
            FP32_FLOPS if dtype == torch.float32 else BF16_FLOPS)
        for name, fn in fns.items():
            row[name + "_ms"] = cuda_time_ms(fn, iters=it)
            row[name + "_device_ms"] = device_time_ms(fn, iters=min(it, 10))
        rows[f"{m}x{k}x{n}_{dt}"] = row
        print(f"{root}: ({m}x{k})x({k}x{n}) {dt} {row['route']}: with h {row['kernel_h_ms']:.4f}"
              f" ms (device {row['kernel_h_device_ms']:.4f}), without {row['kernel_ms']:.4f} "
              f"({row['kernel_device_ms']:.4f}); cuBLAS chain {row['chain_ms']:.4f} "
              f"({row['chain_device_ms']:.4f}); bound {row['bound_ms']:.4f} by {row['bound_by']}",
              flush=True)
        del x, w, args
    return rows


def block_bwd_turn(kernels) -> dict:
    """Kernel 5 and the chain it fuses at the flagship mix backward's shape,
    every route of BLOCK_BWD_ROUTES at every batch of BLOCK_BWD_BATCHES."""
    import torch

    from spectre_tpu_torch.utils.timing import (BF16_FLOPS, FP32_FLOPS, bound_ms, cuda_time_ms,
                                                device_time_ms)

    d, heads, n_tok, o = 33_280, 16, 65, 512
    eh = heads * d // n_tok
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = {}
    for dt, blk in BLOCK_BWD_ROUTES:
        dtype = getattr(torch, dt)
        binv = torch.stack([torch.randperm(d // blk, generator=gen, device="cuda")
                            for _ in range(heads)]).to(torch.int32)
        w = torch.randn(eh, o, generator=gen, device="cuda").to(dtype)
        s4 = (torch.randint(0, 2, (n_tok, eh), generator=gen, device="cuda") * 2 - 1).to(dtype)
        for b in BLOCK_BWD_BATCHES:
            dy = torch.randn(n_tok, b, o, generator=gen, device="cuda").to(dtype)

            def chain():
                dg4 = torch.bmm(w.expand(n_tok, -1, -1), dy.transpose(1, 2))
                dg4.mul_(s4[:, :, None])
                return kernels.block_gather_sum(dg4.view(heads * d, b), binv, blk)

            def kernel():
                return kernels.fused_block_bwd(dy, w, s4, binv, blk)

            it = 10 if dtype == torch.bfloat16 else 3
            row = {"route": kernels.block_bwd_kernel(dtype, blk)}
            # dy, w, s4 and binv read and dxt written once
            row["bound_ms"], row["bound_by"] = bound_ms(
                (n_tok * b * o + eh * o + n_tok * eh + d * b) * dy.element_size()
                + binv.numel() * 4, 2 * d * heads * o * b,
                FP32_FLOPS if dtype == torch.float32 else BF16_FLOPS)
            for name, fn in (("kernel", kernel), ("chain", chain)):
                row[name + "_ms"] = cuda_time_ms(fn, iters=it)
                row[name + "_device_ms"] = device_time_ms(fn, iters=min(it, 5))
            rows[f"block_bwd_{dt}_blk{blk}_b{b}"] = row
            print(f"kernel 5 {dt} blk={blk} B={b} {row['route']}: {row['kernel_ms']:.4f} ms "
                  f"(device {row['kernel_device_ms']:.4f}); chain {row['chain_ms']:.4f} "
                  f"({row['chain_device_ms']:.4f}); bound {row['bound_ms']:.4f} by "
                  f"{row['bound_by']}", flush=True)
            del dy
            torch.cuda.empty_cache()
    return rows


def chain_fn(kernels, h, g, gamma, beta):
    """The wide chain with its column-sum pass alone, as the tree at hand
    launches it: ``backward_chain`` where the tree has it, else the C entry
    point with the grid of the first wide chain (3 blocks an SM). Returns
    the call and the blocks' count (the partial rows)."""
    import torch

    fl = kernels.fused_linear
    if hasattr(fl, "backward_chain"):
        m, n = h.shape
        plan = fl.wide_chain_plan(h.dtype, m, n, 16, fl._sm_count(0),
                                  lambda *a: fl._wide_occupancy(0, h.dtype, *a))
        return (lambda: fl.backward_chain(h, g, gamma, beta)), plan.blocks
    m, n = h.shape
    blocks = min(m, fl._bwd_grid(0))
    dh = torch.empty_like(h)
    sums = torch.empty((3, n), dtype=h.dtype, device=h.device)
    partial = torch.empty((blocks, 3, n), dtype=torch.float32, device=h.device)
    at, step = sums.data_ptr(), n * sums.element_size()
    lib = fl.load_library()

    def call():
        fl.check(lib.fused_spectre_linear_bwd_wide(
            fl._DTYPE_CODES[h.dtype], h.data_ptr(), g.data_ptr(), gamma.data_ptr(),
            beta.data_ptr(), dh.data_ptr(), at, at + step, at + 2 * step, partial.data_ptr(), m,
            n, blocks, 1e-5, fl.current_stream(0)), "fused_spectre_linear_bwd_wide")
    return call, blocks


def _bwd_case(m, k, n, dtype, seed):
    """x, w, gamma, beta, the saved h = x w + b and a cotangent, on the card."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(m, k, generator=gen)
    w = torch.empty(k, n).uniform_(-k ** -0.5, k ** -0.5, generator=gen)
    b = 0.1 * torch.randn(n, generator=gen)
    gamma = 1.0 + 0.1 * torch.randn(n, generator=gen)
    beta = 0.1 * torch.randn(n, generator=gen)
    g = torch.randn(m, n, generator=gen)
    return [t.to("cuda", dtype) for t in (x, w, gamma, beta, x @ w + b, g)]


def bwd_turn(kernels) -> dict:
    """Kernel 2's backward at BWD_SHAPES in both dtypes: the whole of it and
    the chain alone, on the device and back to back, beside the bounds."""
    import torch

    from spectre_tpu_torch.utils.timing import (BF16_FLOPS, FP32_FLOPS, bound_ms, cuda_time_ms,
                                                device_time_ms)

    rows = {}
    for m, k, n in BWD_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            args = _bwd_case(m, k, n, dtype, m + k + n)
            el = args[0].element_size()
            chain, blocks = chain_fn(kernels, *args[4:], args[2], args[3])
            whole = lambda: kernels.fused_spectre_linear_bwd(*args)  # noqa: E731
            it = 10 if dtype == torch.bfloat16 else 3
            row = {"bwd_ms": cuda_time_ms(whole, iters=it),
                   "bwd_device_ms": device_time_ms(whole, iters=min(it, 5)),
                   "chain_ms": cuda_time_ms(chain, iters=20),
                   "chain_device_ms": device_time_ms(chain, iters=10), "blocks": blocks}
            # x, h, g, W, gamma, beta read and dx, dW, the three [N] written
            row["bwd_bound_ms"], row["bwd_bound_by"] = bound_ms(
                (2 * m * k + 2 * m * n + 2 * k * n + 5 * n) * el, 4 * m * k * n,
                FP32_FLOPS if dtype == torch.float32 else BF16_FLOPS)
            row["chain_bound_ms"] = bound_ms((3 * m * n + 5 * n) * el)[0]
            row["chain_bound_partial_ms"] = bound_ms((3 * m * n + 5 * n) * el
                                                     + 2 * blocks * 3 * n * 4)[0]
            key = f"bwd_{m}x{k}x{n}_{str(dtype)[6:]}"
            rows[key] = row
            print(f"{key}: backward {row['bwd_ms']:.4f} ms (device {row['bwd_device_ms']:.4f}), "
                  f"bound {row['bwd_bound_ms']:.4f} by {row['bwd_bound_by']}; chain alone "
                  f"{row['chain_ms']:.4f} (device {row['chain_device_ms']:.4f}), bound "
                  f"{row['chain_bound_ms']:.4f} by bytes, {row['chain_bound_partial_ms']:.4f} "
                  f"with {blocks} partial rows", flush=True)
            del args
            torch.cuda.empty_cache()
    return rows


def fwht_turn(kernels) -> dict:
    """``fwht`` at FWHT_SHAPES beside its bound."""
    import torch

    from spectre_tpu_torch.utils.timing import bound_ms, cuda_time_ms, device_time_ms

    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = {}
    for dt, m, n in FWHT_SHAPES:
        x = torch.randn(m, n, generator=gen, device="cuda").to(getattr(torch, dt))
        row = {"ms": cuda_time_ms(lambda: kernels.fwht(x)),
               "device_ms": device_time_ms(lambda: kernels.fwht(x))}
        row["bound_ms"], row["bound_by"] = bound_ms(2 * m * n * x.element_size())
        rows[f"fwht_{m}x{n}_{dt}"] = row
        print(f"fwht [{m}, {n}] {dt}: {row['ms']:.4f} ms (device {row['device_ms']:.4f}), bound "
              f"{row['bound_ms']:.4f} by {row['bound_by']}", flush=True)
        del x
    return rows


def _shard_case(dt, batch, n_full, size):
    """Entries 3 and 4's operands on the card: (tag, h, g, gamma, beta, the
    merged (mean, rstd) [M, 2], the gathered row sums [size, M, 2], N)."""
    import torch

    dtype, m, n = getattr(torch, dt), 65 * batch, n_full // size
    gen = torch.Generator(device="cuda").manual_seed(m + n)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    h, g = randn(m, n).to(dtype), randn(m, n).to(dtype)
    gamma, beta = (1 + 0.1 * randn(n)).to(dtype), (0.1 * randn(n)).to(dtype)
    mstats = torch.stack([0.1 * randn(m), 1 + 0.1 * randn(m).abs()], -1)
    tag = f"shard_{'bf16' if dtype == torch.bfloat16 else 'f32'}_B{batch}_n{n}"
    return tag, h, g, gamma, beta, mstats, 0.5 * randn(size, m, 2), n_full


def _shard_bounds(m, n, size, el):
    """(bound ms, bound by) of entries 3 and 4 (chip_smoke.py phase 28's):
    h, g, gamma, beta and the row statistics read, the outputs written
    once; some 35 and 40 float32 operations an element."""
    from spectre_tpu_torch.utils.timing import FP32_FLOPS, bound_ms

    return (bound_ms((2 * m * n + 4 * n) * el + 2 * m * 8, 35 * m * n, FP32_FLOPS),
            bound_ms((3 * m * n + 3 * n) * el + (size + 1) * m * 8, 40 * m * n, FP32_FLOPS))


def shard_turn(kernels) -> dict:
    """Entries 3 and 4 (``chain_shard_sums``, ``chain_shard_dh``) at
    SHARD_TAGS, back to back and on the device, beside their bounds."""
    import torch

    from spectre_tpu_torch.utils.timing import cuda_time_ms, device_time_ms

    rows = {}
    for dt, batch, n_full, size in SHARD_TAGS:
        tag, h, g, gamma, beta, mstats, rowsums, f = _shard_case(dt, batch, n_full, size)
        m, n = h.shape
        fns = {"sums": lambda: kernels.chain_shard_sums(h, g, gamma, beta, mstats),
               "dh": lambda: kernels.chain_shard_dh(h, g, gamma, beta, mstats, rowsums, f)}
        row = {}
        for (name, fn), (bound, by) in zip(fns.items(), _shard_bounds(m, n, size,
                                                                      h.element_size())):
            row[name + "_ms"] = cuda_time_ms(fn, iters=20)
            row[name + "_device_ms"] = device_time_ms(fn, iters=10)
            row[name + "_bound_ms"], row[name + "_bound_by"] = bound, by
        rows[tag] = row
        print(f"{tag}: chain_shard_sums {row['sums_ms']:.4f} ms (device "
              f"{row['sums_device_ms']:.4f}), bound {row['sums_bound_ms']:.4f} by "
              f"{row['sums_bound_by']}; chain_shard_dh {row['dh_ms']:.4f} (device "
              f"{row['dh_device_ms']:.4f}), bound {row['dh_bound_ms']:.4f} by "
              f"{row['dh_bound_by']}", flush=True)
        del h, g, rowsums
        torch.cuda.empty_cache()
    return rows


def _shard_ln_case(dt, batch, n_full, size):
    """Entry 2's operands on the card, as ``parallel/tp.py`` hands them over:
    (tag, the call's arguments, bound ms, bound by). A column shard: rank
    0's n = N / size columns of h, the ranks' statistics [size, M, 2] and
    its columns of the pool [M, N] (a strided view). ``size`` 1: linear3's
    whole rows, h and the residual the halves of the all-reduced float32 sum
    [M, 2N], with the bias. The bound: h, the residual, gamma, beta (and the
    bias), the statistics read, out (and h) and (mean, rstd) written once;
    some 20 float32 operations an element."""
    import torch

    from spectre_tpu_torch.utils.timing import FP32_FLOPS, bound_ms

    dtype, m, n = getattr(torch, dt), 65 * batch, n_full // size
    el = dtype.itemsize
    gen = torch.Generator(device="cuda").manual_seed(m + n_full + size)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    gamma, beta = (1 + 0.1 * randn(n)).to(dtype), (0.1 * randn(n)).to(dtype)
    name = "bf16" if dtype == torch.bfloat16 else "f32"
    if size == 1:
        s = 2.0 + randn(m, 2 * n)
        args = (s[:, :n], None, gamma, beta, n, (0.1 * randn(n)).to(dtype), s[:, n:])
        nbytes = m * 2 * n * 4 + 3 * n * el + 2 * m * n * el + m * 8
        tag = f"shard_ln_{name}_B{batch}_rows{n}"
    else:
        stats = torch.stack([0.5 * randn(size, m), n * (0.5 + randn(size, m).abs())], -1)
        pool = randn(m, n_full).to(dtype)
        args = ((2.0 + randn(m, n)).to(dtype), stats, gamma, beta, n_full, None, pool[:, :n])
        nbytes = 3 * m * n * el + 2 * n * el + size * m * 8 + m * 8
        tag = f"shard_ln_{name}_B{batch}_n{n}"
    return (tag, args, *bound_ms(nbytes, 20 * m * n, FP32_FLOPS))


def shard_ln_turn(kernels) -> dict:
    """Entry 2 (``sharded_ln_gelu``) at SHARD_LN_TAGS, back to back and on
    the device, beside its bound and its plain version; on whole rows also
    the torch chain gelu(layer_norm(s + b)) + res in float32, cast once."""
    import torch
    import torch.nn.functional as F

    from spectre_tpu_torch.utils.timing import cuda_time_ms, device_time_ms

    rows = {}
    for case in SHARD_LN_TAGS:
        tag, args, bound, by = _shard_ln_case(*case)
        h, _, gamma, beta, _, bias, res = args
        fns = {"kernel": lambda: kernels.sharded_ln_gelu(*args),
               "plain": lambda: kernels.sharded_ln_gelu_plain(*args)}
        if bias is not None:
            n = h.shape[1]
            b32, g32, be32 = bias.float(), gamma.float(), beta.float()
            fns["chain"] = lambda: (F.gelu(F.layer_norm(h + b32, (n,), g32, be32))
                                    + res).to(gamma.dtype)
        row = {"bound_ms": bound, "bound_by": by}
        for name, fn in fns.items():
            row[name + "_ms"] = cuda_time_ms(fn, iters=20 if name == "kernel" else 5)
            row[name + "_device_ms"] = device_time_ms(fn, iters=10 if name == "kernel" else 3)
        rows[tag] = row
        print(f"{tag}: sharded_ln_gelu {row['kernel_ms']:.4f} ms (device "
              f"{row['kernel_device_ms']:.4f}), bound {bound:.4f} by {by} "
              f"({bound / row['kernel_device_ms']:.2f}); plain {row['plain_device_ms']:.4f}"
              + (f"; torch chain {row['chain_device_ms']:.4f}" if "chain" in fns else ""),
              flush=True)
        del args, h, res
        torch.cuda.empty_cache()
    return rows


def shard_stats_turn(kernels) -> dict:
    """Entry 1 (``fused_spectre_linear_shard_stats``) at SHARD_STATS_TAGS on
    rank 0's shard, back to back and on the device, beside its bound (x, W,
    b read, h and the statistics written once; 2 M K n operations on the
    dtype's peak), its plain version and ``torch.addmm(b, x, w)`` (h alone,
    without the statistics; a yardstick the port never calls); the kernel
    the tree routes it to and, where the tree has it, the bf16 kernel's
    L2-to-shared bytes a row of output as its plan counts them
    (``shard_stats_plan``; not measured)."""
    import torch

    from spectre_tpu_torch.utils.timing import (BF16_FLOPS, FP32_FLOPS, bound_ms, cuda_time_ms,
                                                device_time_ms)

    rows = {}
    for dt, batch, n_full, size in SHARD_STATS_TAGS:
        dtype, m, k, n = getattr(torch, dt), 65 * batch, 512, n_full // size
        gen = torch.Generator(device="cuda").manual_seed(m + n_full + size)
        x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
        w = (torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5).to(dtype)
        b = (0.1 * torch.randn(n, generator=gen, device="cuda")).to(dtype)
        el = dtype.itemsize
        route = kernels.shard_stats_kernel(dtype, k, n)
        row = {"route": route}
        row["bound_ms"], row["bound_by"] = bound_ms(
            (m * k + k * n + n + m * n) * el + m * 8, 2 * m * k * n,
            BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS)
        if route == "fused_spectre_linear_shard_stats_wgmma":
            plan = kernels.shard_stats_plan(m, k, n)
            row["l2_bytes_row"] = {"w": plan.w_bytes_row, "x": plan.x_bytes_row}
        fns = {"kernel": lambda: kernels.fused_spectre_linear_shard_stats(x, w, b),
               "plain": lambda: kernels.shard_stats_plain(x, w, b),
               "addmm": lambda: torch.addmm(b, x, w)}
        for name, fn in fns.items():
            row[name + "_ms"] = cuda_time_ms(fn, iters=20 if name != "plain" else 5)
            row[name + "_device_ms"] = device_time_ms(fn, iters=10 if name != "plain" else 3)
        tag = f"shard_stats_{'bf16' if dtype == torch.bfloat16 else 'f32'}_B{batch}_n{n}"
        rows[tag] = row
        print(f"{tag} ({route}): {row['kernel_ms']:.4f} ms (device {row['kernel_device_ms']:.4f}),"
              f" bound {row['bound_ms']:.4f} by {row['bound_by']} "
              f"({row['bound_ms'] / row['kernel_device_ms']:.2f}); plain "
              f"{row['plain_device_ms']:.4f}; addmm {row['addmm_device_ms']:.4f}"
              + (f"; plan's L2 bytes a row W {row['l2_bytes_row']['w']:.0f}, x "
                 f"{row['l2_bytes_row']['x']:.0f}" if "l2_bytes_row" in row else ""), flush=True)
        del x, w, b
        torch.cuda.empty_cache()
    return rows


def shard_sweep() -> dict:
    """This tree's entries 3 and 4 at the flagship's shards of SHARD_TAGS,
    the device time for each cap of SHARD_BLOCKS_PER_SM, and at the shipped
    cap each kernel's share by ``torch.profiler`` (the entry's kernel and
    its column-sum pass)."""
    sys.path[0] = ROOT
    import torch

    from spectre_tpu_torch.ops import kernels
    from spectre_tpu_torch.repl.perf import kernel_rows
    from spectre_tpu_torch.utils.timing import device_time_ms

    fl = kernels.fused_linear
    keep, rows = fl.SHARD_BLOCKS_PER_SM, {}
    try:
        for dt, batch, n_full, size in SHARD_TAGS[:8]:
            tag, h, g, gamma, beta, mstats, rowsums, f = _shard_case(dt, batch, n_full, size)
            fns = {"sums": lambda: kernels.chain_shard_sums(h, g, gamma, beta, mstats),
                   "dh": lambda: kernels.chain_shard_dh(h, g, gamma, beta, mstats, rowsums, f)}
            row = {}
            for cap in range(1, 9):
                fl.SHARD_BLOCKS_PER_SM = cap
                plan = fl._shard_plan(h, False, g, gamma, beta)
                row[cap] = {"blocks": plan.blocks, **{
                    name: device_time_ms(fn, iters=10) for name, fn in fns.items()}}
            fl.SHARD_BLOCKS_PER_SM = keep
            row["kernels"] = {name: [(k, c / 20, ms / 20) for k, c, ms in kernel_rows(fn, 20)[0]]
                              for name, fn in fns.items()}
            rows[tag] = row
            print(f"shard sweep {tag}: " + ", ".join(
                f"cap {c}: {v['sums']:.4f} / {v['dh']:.4f} ({v['blocks']} blocks)"
                for c, v in row.items() if c != "kernels")
                + "; by kernel, ms a call: " + json.dumps(row["kernels"]), flush=True)
            del h, g, rowsums
    finally:
        fl.SHARD_BLOCKS_PER_SM = keep
    return rows


def chain_sweep() -> dict:
    """This tree's wide chain alone at the C6 shapes, the device time for
    each cap of WIDE_BLOCKS_PER_SM."""
    sys.path[0] = ROOT
    import torch

    from spectre_tpu_torch.ops import kernels
    from spectre_tpu_torch.utils.timing import device_time_ms

    fl = kernels.fused_linear
    keep, rows = fl.WIDE_BLOCKS_PER_SM, {}
    try:
        for m, k, n in BWD_SHAPES:
            for dtype in (torch.bfloat16, torch.float32):
                args = _bwd_case(m, k, n, dtype, m + k + n)
                row = {}
                for cap in range(1, 9):
                    fl.WIDE_BLOCKS_PER_SM = cap
                    chain, blocks = chain_fn(kernels, *args[4:], args[2], args[3])
                    row[cap] = {"blocks": blocks, "device_ms": device_time_ms(chain, iters=10)}
                rows[f"{m}x{n}_{str(dtype)[6:]}"] = row
                print(f"chain sweep {m}x{n} {str(dtype)[6:]}: " + ", ".join(
                    f"cap {c}: {v['device_ms']:.4f} ({v['blocks']} blocks)"
                    for c, v in row.items()), flush=True)
                del args
    finally:
        fl.WIDE_BLOCKS_PER_SM = keep
    return rows


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parent", help="an unpacked tree to time in turns with this one")
    p.add_argument("--root", help="time one turn of the tree at this directory")
    p.add_argument("--out", help="write the turns as JSON here")
    p.add_argument("--parts", default=",".join(PARTS),
                   help=f"comma-separated groups to time, of {', '.join(PARTS)}")
    p.add_argument("--chain-sweep", action="store_true",
                   help="time the wide chain alone at each cap of WIDE_BLOCKS_PER_SM")
    p.add_argument("--shard-sweep", action="store_true",
                   help="time entries 3 and 4 at each cap of SHARD_BLOCKS_PER_SM")
    args = p.parse_args(argv)
    if args.chain_sweep or args.shard_sweep:
        rows = chain_sweep() if args.chain_sweep else shard_sweep()
        if args.out:
            with open(args.out, "w") as f:
                json.dump(rows, f, indent=1)
        return rows
    if args.root:
        rows = one_turn(os.path.abspath(args.root), args.parts.split(","))
        if args.out:
            with open(args.out, "w") as f:
                json.dump(rows, f)
        return rows
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    trees = [("parent", args.parent), ("change", ROOT), ("change", ROOT), ("parent", args.parent)]
    if not args.parent:
        trees = [("change", ROOT)]
    turns = []
    for i, (name, root) in enumerate(trees):
        out = os.path.join(ROOT, "build", f"linear_ab_turn{i}.json")
        subprocess.run([sys.executable, os.path.abspath(__file__), "--root", os.path.abspath(root),
                        "--out", out, "--parts", args.parts], check=True, cwd=root)
        with open(out) as f:
            turns.append({"tree": name, "rows": json.load(f)})
    result = {"card": card, "turns": turns}
    print(card, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
