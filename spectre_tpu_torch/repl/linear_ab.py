"""Kernel 2's forward at the shapes its cluster kernels took over, and kernel
5 at the tables its token-grouped kernel takes, timed in two trees of the
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
  (512 x 4,608), at and beyond the wide cluster kernel's reach.

Then ``fused_block_bwd`` (whichever kernel ``block_bwd_kernel`` picks in
that tree) beside the chain it fuses (the dg4 product, the signs,
``block_gather_sum``) at the flagship mix backward's shape (d = 33,280, H =
16, 65 tokens, O = 512) for B = 256 and 1,024: bf16 with blk 16 and 32,
float32 with blk 16 and 64.

With ``--parent DIR`` (an unpacked tree of another commit, its kernels built
into its own ``build/kernels/``) the shapes run in four processes in turns,
parent / this tree / this tree / parent, each importing its own tree's
package; the card's name and power limit and every turn's numbers go to
``--out`` as JSON, with each shape's bound (the larger of the bytes read and
written once over 3.35 TB/s and the operations over the dtype's peak).
``--root DIR`` runs one turn of the tree at DIR (what the turns call). Needs
a CUDA card.
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
             ("bfloat16", 1040, 512, 4608)])
# kernel 5: (dtype, blk) at the flagship mix backward's shape, and its batches
BLOCK_BWD_ROUTES = (("bfloat16", 16), ("bfloat16", 32), ("float32", 16), ("float32", 64))
BLOCK_BWD_BATCHES = (256, 1024)


def one_turn(root: str) -> dict:
    """Time every shape with the package of the tree at ``root`` (first on
    the path, in place of this file's directory)."""
    sys.path[0] = root
    import torch
    import torch.nn.functional as F

    from spectre_tpu_torch.ops import kernels
    from spectre_tpu_torch.utils.timing import (BF16_FLOPS, FP32_FLOPS, bound_ms, cuda_time_ms,
                                                device_time_ms)

    if not torch.cuda.is_available():
        raise SystemExit("linear_ab: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
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
    rows.update(block_bwd_turn(kernels))
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


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parent", help="an unpacked tree to time in turns with this one")
    p.add_argument("--root", help="time one turn of the tree at this directory")
    p.add_argument("--out", help="write the turns as JSON here")
    args = p.parse_args(argv)
    if args.root:
        rows = one_turn(os.path.abspath(args.root))
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
                        "--out", out], check=True, cwd=root)
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
