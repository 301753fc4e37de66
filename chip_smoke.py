"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each raising on failure (nothing is caught):

1. device: require CUDA; print the card's name and power limit; TF32 off.
2. build: compile every kernel in spectre_tpu_torch/csrc/ with nvcc.
3. kernel 1 (block_scatter_rows) vs its plain version at the flagship mix
   shape (d=33,280, H=16) with a block table (blk=64) and a uniform one
   (blk=1, as mix_block=0 trains), B in {1, 3, 64, 256, 1024}, bf16 and f32:
   bitwise equal. Median times at B=256 for both tables.
4. kernel 2 (fused_spectre_linear_fwd) vs its plain version at the path's
   three shapes for B=256 and B=1024, f32 (<= 1e-4: only the summation order differs)
   and bf16 (<= 2e-2: one bf16 ulp is 7.8e-3 near 1 and 1.6e-2 in [2, 4)),
   for the output and for the saved pre-LN ``h``; the autograd Function's
   five gradients vs autograd of the plain version (limits at GRAD_REL);
   times with and without ``h``, and of the backward.
5. kernel 3 (block_gather_sum) and kernel 4 (inverse_gather_sum) vs their
   plain versions at the flagship mix shape, B in {1, 3, 64, 256, 1024},
   bf16 and f32: bitwise equal (kernel and plain version add the same
   float32 values in head order and cast once). Median times and GB/s at
   B=256 and B=1024, kernel 4 beside kernel 3.
6. model: the flagship config (spectre_tpu_torch/configs/spectre_vit_cifar100.py)
   at full width on cuda, the port's seeded init; one bucket-256 forward
   must launch exactly 4 block-scatter and 9 fused-linear kernels, give
   finite [256, 100] logits, and agree with the same module run on the
   plain versions (tolerance below).
7. serve: the serving CLI's start path (repl/serve.py) on loopback port 0;
   SPQ2 f32 requests of batch 1, 7 and 64 and an SPQ3 u8 request of batch
   5 through the port's SpectreClient, each sent twice; replies checked
   against a direct forward of the same padded bucket. Launch counts are
   reset just before the server starts and read right after its run.
8. train: the flagship in train mode at the config's batch 256 on synthetic
   data. One step must launch exactly 4 block-scatter, 4 block-gather and 9
   fused-linear kernels, give a finite loss and a finite gradient for every
   parameter; 8 steps on one fixed batch must end below the first loss; one
   backward on the kernel path must agree with the same backward on the
   plain versions (TRAIN_GRAD_REL). With mix_block=0 one step must launch 4
   inverse-gather kernels instead. ms per step, img/s and peak memory at
   B=256 and B=1024 for both tables.
9. the training CLI (repl/train.py) as a user starts it, 4 steps and the
   validation pass, with mix_block=64 and with mix_block=0: exact launch
   counts, reset just before and read just after each run; these are the
   ``launches`` of the result line.

Prints the card line, one JSON line of per-kernel results, then
``{"ok": true, "device": {...}}`` as the last line. Exits non-zero, with no
result, when CUDA is missing or the port is not beside this script.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "spectre_tpu_torch", "configs", "spectre_vit_cifar100.py")
# bf16 logits of the kernel path vs the plain path: both round each op's
# output to bf16 once, but a 1-ulp flip inside an early layer is carried
# through 4 layers and the head. Logits are O(1) (GELU(LN(.)) + pool), so
# 0.1 is about three bf16 ulps at the largest logit magnitudes.
MODEL_ATOL = 0.1
# kernel 2's Function vs autograd of its plain version, each gradient
# relative to its largest entry. f32: the kernel's product sums in another
# order than cuBLAS. bf16: both paths save h rounded to bf16, out of float32
# products that differ in their last bits, so single entries of h differ by
# one bf16 ulp (2^-8); everything after is float32 on both paths.
GRAD_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# one backward through the whole flagship in bf16, kernel path vs plain
# path, each gradient relative to its largest entry: the one-ulp flips of
# kernel 2's outputs pass through up to 4 layers of bf16 products and
# LayerNorms in both directions.
TRAIN_GRAD_REL = 0.05
# published peaks of one H100 SXM: device memory rate, dense bf16 tensor-core
# rate, float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
PLAIN_PATCHES = (
    ("spectre_tpu_torch.ops.fused_mix.block_scatter_rows", "block_scatter_rows_plain"),
    ("spectre_tpu_torch.ops.fused_mix.block_gather_sum", "block_gather_sum_plain"),
    ("spectre_tpu_torch.ops.fused_mix.inverse_gather_sum", "inverse_gather_sum_plain"),
    ("spectre_tpu_torch.ops.linear.fused_spectre_linear", "fused_spectre_linear_plain"),
    ("spectre_tpu_torch.ops.kernels.fused_linear.fused_spectre_linear",
     "fused_spectre_linear_plain"),
)


@contextlib.contextmanager
def plain_versions(kernels):
    """Swap every wrapper the model calls for its plain version."""
    with contextlib.ExitStack() as stack:
        for target, name in PLAIN_PATCHES:
            stack.enter_context(mock.patch(target, getattr(kernels, name)))
        yield


def bound(n_bytes: float, flops: float = 0.0) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the bytes over
    the memory rate and the operations over the bf16 tensor-core rate."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def cuda_time_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Median over ``reps`` of the mean time of ``iters`` back-to-back calls,
    by CUDA events, after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def max_abs_diff(got: torch.Tensor, ref: torch.Tensor) -> float:
    return (got.float() - ref.float()).abs().max().item()


BATCHES = (1, 3, 64, 256, 1024)


def phase_kernel1(kernels, gen):
    """Kernel 1 at the flagship mix shape with both tables the train path
    gives it: blocks of 64 rows (bsrc [16, 520]) and single rows (blk=1,
    bsrc = perms [16, 33,280])."""
    d, heads = 33_280, 16
    tables = {}
    for blk in (64, 1):
        bsrc = torch.stack([torch.randperm(d // blk, generator=gen) for _ in range(heads)])
        tables[blk] = bsrc.to(torch.int32).cuda()
    worst = 0.0
    for blk, bsrc in tables.items():
        for dtype in (torch.bfloat16, torch.float32):
            for b in BATCHES:
                xt = torch.randn(d, b, generator=gen).to("cuda", dtype)
                got = kernels.block_scatter_rows(xt, bsrc, blk)
                ref = kernels.block_scatter_rows_plain(xt, bsrc, blk)
                torch.cuda.synchronize()
                worst = max(worst, max_abs_diff(got, ref))
                if not torch.equal(got, ref):
                    raise AssertionError(f"block_scatter_rows != plain at blk={blk} B={b} {dtype}")
                del xt, got, ref
    print(f"kernel 1 block_scatter_rows: bitwise equal to plain for blk in (64, 1), "
          f"B in {BATCHES}, bf16 and f32 (max abs err {worst})", flush=True)
    xt = torch.randn(d, 256, generator=gen).to("cuda", torch.bfloat16)
    moved = (heads * d * 256 + d * 256) * 2
    bound_ms, bound_by = bound(moved)
    res = {}
    for blk, bsrc in tables.items():
        ms_k = cuda_time_ms(lambda: kernels.block_scatter_rows(xt, bsrc, blk))
        ms_p = cuda_time_ms(lambda: kernels.block_scatter_rows_plain(xt, bsrc, blk))
        chunks, flat = xt.view(d // blk, blk * 256), bsrc.reshape(-1)
        ms_lib = cuda_time_ms(lambda: torch.index_select(chunks, 0, flat))
        res[blk] = (ms_k, ms_p, ms_lib)
        print(f"kernel 1 at d={d} H={heads} blk={blk} B=256 bf16: kernel {ms_k:.4f} ms "
              f"({moved / ms_k / 1e6:.1f} GB/s of write+read), plain {ms_p:.4f} ms, "
              f"index_select {ms_lib:.4f} ms, bound {bound_ms:.4f} ms", flush=True)
    ms_k, ms_p, ms_lib = res[64]
    return {"name": "block_scatter_rows", "route": "cuda",
            "source": "spectre_tpu_torch/csrc/block_scatter_rows.cu",
            "replaces": "spectre_tpu/ops/pallas/bwd_gather.py:343",
            "max_abs_err": worst, "ms": ms_k, "plain_ms": ms_p, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": ms_lib, "ms_blk1": res[1][0],
            "shape": f"xt[{d},256] bf16 -> [{heads * d},256]"}


def _grad_errors(kernels, args, ct):
    """Worst relative error (to each gradient's largest entry) of the
    Function's five gradients against autograd of the plain version."""
    a = [t.detach().clone().requires_grad_() for t in args]
    b = [t.detach().clone().requires_grad_() for t in args]
    kernels.fused_spectre_linear_grad(*a).backward(ct)
    kernels.fused_spectre_linear_plain(*b).backward(ct)
    torch.cuda.synchronize()
    worst = 0.0
    for ta, tb in zip(a, b):
        scale = tb.grad.float().abs().max().item()
        worst = max(worst, (ta.grad.float() - tb.grad.float()).abs().max().item() / scale)
    return worst


def phase_kernel2(kernels, gen):
    # the path's three shapes at the config's batch 256 and at the batch 1024
    # whose train steps are timed below
    shapes = [(rows, k, n) for b in (256, 1024)
              for rows, k, n in ((65 * b, 512, 768), (65 * b, 768, 512), (b, 512, 100))]
    limits = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    worst, worst_h, worst_grad = {}, {}, {}
    times = []
    for m, k, n in shapes:
        x = torch.randn(m, k, generator=gen)
        w = torch.empty(k, n).uniform_(-k ** -0.5, k ** -0.5, generator=gen)
        bias = torch.empty(n).uniform_(-k ** -0.5, k ** -0.5, generator=gen)
        gamma = 1.0 + 0.1 * torch.randn(n, generator=gen)
        beta = 0.1 * torch.randn(n, generator=gen)
        ct = torch.randn(m, n, generator=gen)
        for dtype, limit in limits.items():
            args = [t.to("cuda", dtype) for t in (x, w, bias, gamma, beta)]
            got = kernels.fused_spectre_linear(*args)
            got2, h = kernels.fused_spectre_linear(*args, save_h=True)
            ref, ref_h = kernels.fused_spectre_linear_plain(*args, save_h=True)
            torch.cuda.synchronize()
            if not torch.equal(got, got2):
                raise AssertionError("fused_spectre_linear: writing h changed the output")
            err = (got.float() - ref.float()).abs().max().item()
            err_h = (h.float() - ref_h.float()).abs().max().item()
            worst[dtype] = max(worst.get(dtype, 0.0), err)
            worst_h[dtype] = max(worst_h.get(dtype, 0.0), err_h)
            if not max(err, err_h) <= limit:
                raise AssertionError(f"fused_spectre_linear ({m}x{k})x({k}x{n}) {dtype}: "
                                     f"max abs err out {err}, h {err_h} > {limit}")
            gerr = _grad_errors(kernels, args, ct.to("cuda", dtype))
            worst_grad[dtype] = max(worst_grad.get(dtype, 0.0), gerr)
            if not gerr <= GRAD_REL[dtype]:
                raise AssertionError(f"fused_spectre_linear_grad ({m}x{k})x({k}x{n}) {dtype}: "
                                     f"gradient rel err {gerr} > {GRAD_REL[dtype]}")
            ms_k = cuda_time_ms(lambda: kernels.fused_spectre_linear(*args))
            ms_h = cuda_time_ms(lambda: kernels.fused_spectre_linear(*args, save_h=True))
            ms_p = cuda_time_ms(lambda: kernels.fused_spectre_linear_plain(*args))
            gflops = 2 * m * k * n / 1e9
            line = (f"kernel 2 ({m}x{k})x({k}x{n}) {str(dtype)[6:]}: max abs err {err:.3g} "
                    f"(h {err_h:.3g}), grads rel {gerr:.3g}, kernel {ms_k:.4f} ms "
                    f"({gflops / ms_k:.1f} TFLOP/s), with h {ms_h:.4f} ms, plain {ms_p:.4f} ms")
            if dtype == torch.bfloat16:
                req = [t.detach().clone().requires_grad_() for t in args]
                cot = ct.to("cuda", dtype)
                out_k = kernels.fused_spectre_linear_grad(*req)
                out_p = kernels.fused_spectre_linear_plain(*req)
                ms_bk = cuda_time_ms(lambda: torch.autograd.grad(out_k, req, cot,
                                                                 retain_graph=True), iters=5)
                ms_bp = cuda_time_ms(lambda: torch.autograd.grad(out_p, req, cot,
                                                                 retain_graph=True), iters=5)
                line += f"; backward {ms_bk:.4f} ms, plain autograd backward {ms_bp:.4f} ms"
                el = 2
                io = (m * k + k * n + 3 * n + 2 * m * n) * el  # x, W, b/gamma/beta, out, h
                if m <= 65 * 256:  # the result line reports the config's batch
                    times.append((m, k, n, ms_h, ms_k, ms_p, ms_bk, ms_bp, io, gflops * 1e9))
            print(line, flush=True)
    m, k, n, ms_h, ms_k, ms_p, ms_bk, ms_bp, io, flops = max(times, key=lambda t: t[3])
    bound_ms, bound_by = bound(io, flops)
    bound_nh, _ = bound(io - m * n * 2, flops)
    print(f"kernel 2 bound at ({m}x{k})x({k}x{n}) bf16: {bound_ms:.4f} ms with h by "
          f"{bound_by}, {bound_nh:.4f} ms without", flush=True)
    return {"name": "fused_spectre_linear_fwd", "route": "cuda",
            "source": "spectre_tpu_torch/csrc/fused_spectre_linear.cu",
            "replaces": "spectre_tpu/ops/pallas/fused_linear.py:94",
            "max_abs_err": max(worst[torch.bfloat16], worst_h[torch.bfloat16]),
            "ms": ms_h, "plain_ms": ms_p, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "ms_without_h": ms_k, "bound_ms_without_h": bound_nh,
            "backward_ms": ms_bk, "plain_backward_ms": ms_bp,
            "max_abs_err_f32": max(worst[torch.float32], worst_h[torch.float32]),
            "grad_rel_err": worst_grad[torch.bfloat16],
            "grad_rel_err_f32": worst_grad[torch.float32],
            "shape": f"({m}x{k})x({k}x{n}) bf16, writing h"}


def phase_gather_kernels(kernels, gen):
    """Kernels 3 and 4 at the flagship mix shape: d=33,280, H=16; a block
    table with blk=64 and a uniform one."""
    d, heads, blk = 33_280, 16, 64
    nb = d // blk
    dev_gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(b, dtype):
        return torch.randn(heads * d, b, generator=dev_gen, device="cuda").to(dtype)

    bsrc = torch.stack([torch.randperm(nb, generator=gen) for _ in range(heads)])
    perms_blk = (bsrc[:, :, None] * blk + torch.arange(blk)).reshape(heads, d)
    perms_uni = torch.stack([torch.randperm(d, generator=gen) for _ in range(heads)])
    binv = torch.argsort(bsrc, dim=1).to(torch.int32).cuda()
    inv = torch.argsort(perms_uni, dim=1).to(torch.int32).cuda()
    cases = (
        ("block_gather_sum", 3, lambda g: kernels.block_gather_sum(g, binv, blk),
         lambda g: kernels.block_gather_sum_plain(g, binv, blk), perms_blk),
        ("inverse_gather_sum", 4, lambda g: kernels.inverse_gather_sum(g, inv),
         lambda g: kernels.inverse_gather_sum_plain(g, inv), perms_uni),
    )
    results, worst = {}, {}
    for name, num, kern, plain, perms in cases:
        for dtype in (torch.bfloat16, torch.float32):
            for b in BATCHES:
                g = randn(b, dtype)
                got, ref = kern(g), plain(g)
                torch.cuda.synchronize()
                worst[name] = max(worst.get(name, 0.0), max_abs_diff(got, ref))
                if not torch.equal(got, ref):
                    raise AssertionError(f"{name} != plain at B={b} {dtype}")
                del g, got, ref
        print(f"kernel {num} {name}: bitwise equal to plain for B in {BATCHES}, "
              f"bf16 and f32 (max abs err {worst[name]})", flush=True)
        flat = perms.reshape(-1).cuda()
        # the library call that computes the same function, by scatter-add:
        # held to the kernel in f32, where only the order of the sum differs
        g = randn(64, torch.float32)
        lib = torch.zeros(d, 64, device="cuda").index_add_(0, flat, g)
        lib_err = (lib - kern(g)).abs().max().item()
        if not lib_err <= 1e-4:
            raise AssertionError(f"{name}: index_add_ differs from the kernel by {lib_err}")
        res = {}
        for b in (256, 1024):
            g = randn(b, torch.bfloat16)
            out = torch.zeros(d, b, dtype=torch.bfloat16, device="cuda")
            ms_k, ms_p = cuda_time_ms(lambda: kern(g)), cuda_time_ms(lambda: plain(g), iters=5)
            ms_lib = cuda_time_ms(lambda: out.index_add_(0, flat, g), iters=5)
            moved = (heads * d * b + d * b) * 2
            bound_ms, bound_by = bound(moved)
            res[b] = (ms_k, ms_p, ms_lib, bound_ms, bound_by)
            print(f"kernel {num} {name} at d={d} H={heads} B={b} bf16: kernel {ms_k:.4f} ms "
                  f"({moved / ms_k / 1e6:.1f} GB/s of read+write, bound {bound_ms:.4f} ms), "
                  f"plain {ms_p:.4f} ms, index_add_ {ms_lib:.4f} ms", flush=True)
            del g, out
        results[name] = res
    for b in (256, 1024):
        k3, k4 = results["block_gather_sum"][b][0], results["inverse_gather_sum"][b][0]
        print(f"kernel 4 beside kernel 3 at B={b} bf16: rows of {b * 2} B {k4:.4f} ms, "
              f"blocks of {blk * b * 2} B {k3:.4f} ms, ratio {k4 / k3:.3f}", flush=True)
    out = []
    for (name, _, _, _, _), src, line in zip(
            cases, ("block_gather_sum.cu", "inverse_gather_sum.cu"), (277, 135)):
        ms_k, ms_p, ms_lib, bound_ms, bound_by = results[name][256]
        out.append({"name": name, "route": "cuda",
                    "source": f"spectre_tpu_torch/csrc/{src}",
                    "replaces": f"spectre_tpu/ops/pallas/bwd_gather.py:{line}",
                    "max_abs_err": worst[name], "ms": ms_k, "plain_ms": ms_p,
                    "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": ms_lib,
                    "ms_b1024": results[name][1024][0],
                    "bound_ms_b1024": results[name][1024][3],
                    "shape": f"g[{heads * d},256] bf16 -> [{d},256]"})
    return out


def expected_launches(cfg, forwards: int = 0, steps: int = 0) -> dict[str, int]:
    """Launches of ``forwards`` inference forwards plus ``steps`` train steps
    (forward and backward) of the configured model."""
    layers, block = cfg.num_encoders, bool(getattr(cfg, "mix_block", 0))
    return {"block_scatter_rows": layers * (forwards + steps),
            "block_gather_sum": layers * steps * block,
            "inverse_gather_sum": layers * steps * (not block),
            "fused_spectre_linear": (2 * layers + 1) * (forwards + steps)}


def phase_model(kernels, build_model, parse_config):
    cfg = parse_config(CONFIG)
    t0 = time.perf_counter()
    model = build_model(cfg, "cuda")
    torch.cuda.synchronize()
    print(f"model: flagship built on cuda in {time.perf_counter() - t0:.2f} s "
          f"(E={cfg.embed_dim} H={cfg.num_heads} layers={cfg.num_encoders} "
          f"{cfg.compute_dtype} compute, mix_block={cfg.mix_block})", flush=True)
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (256, cfg.in_channels, cfg.img_size, cfg.img_size)).astype(np.float32)).cuda()
    with torch.inference_mode():
        model(x)  # warm-up
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        logits = model(x)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3
        counts = kernels.launch_counts()
        want = expected_launches(cfg, forwards=1)
        if counts != want:
            raise AssertionError(f"one forward launched {counts}, want {want}")
        # the same module on the plain versions, swapped in where the model
        # calls the wrappers
        with plain_versions(kernels):
            ref = model(x)
        torch.cuda.synchronize()
    if tuple(logits.shape) != (256, cfg.num_classes) or not torch.isfinite(logits).all():
        raise AssertionError(f"bad logits: shape {tuple(logits.shape)}, "
                             f"finite {bool(torch.isfinite(logits).all())}")
    diff = (logits - ref).abs().max().item()
    if not diff <= MODEL_ATOL:
        raise AssertionError(f"kernel path vs plain path logits differ by {diff} > {MODEL_ATOL}")
    print(f"model: bucket-256 forward {fwd_ms:.2f} ms (host clock, synchronised), "
          f"launches {counts}, logits finite [256, {cfg.num_classes}], max |kernel - plain| "
          f"{diff:.4g} (limit {MODEL_ATOL}), |logits| max {logits.abs().max().item():.3f}",
          flush=True)
    return model, cfg


def phase_serve(kernels, serve, client_cls, model, cfg):
    rng = np.random.default_rng(1)
    shape = (cfg.in_channels, cfg.img_size, cfg.img_size)
    requests = [("SPQ2", rng.uniform(0, 1, (b, *shape)).astype(np.float32)) for b in (1, 7, 64)]
    requests.append(("SPQ3", rng.integers(0, 256, (5, *shape), dtype=np.uint8)))
    kernels.reset_launch_counts()
    srv, port = serve.start(["--config", CONFIG, "--device", "cuda", "--port", "0"])
    replies = []
    try:
        with client_cls(port=port) as c:
            for rnd in ("first", "second"):
                for wire, x in requests:
                    t0 = time.perf_counter()
                    got = c.infer(x) if wire == "SPQ2" else c.infer_u8(x)
                    ms = (time.perf_counter() - t0) * 1e3
                    print(f"serve: {wire} batch {x.shape[0]} ({rnd} send): {ms:.2f} ms",
                          flush=True)
                    replies.append((wire, x, got))
    finally:
        srv.close()
    counts = kernels.launch_counts()
    if min(counts["block_scatter_rows"], counts["fused_spectre_linear"]) < 1:
        raise AssertionError(f"serving run launched no kernel of the path: {counts}")
    if counts["block_gather_sum"] or counts["inverse_gather_sum"]:
        raise AssertionError(f"serving launched a backward kernel: {counts}")
    for wire, x, got in replies:
        b = x.shape[0]
        bucket = 1 << (b - 1).bit_length()
        xp = np.concatenate([x, np.zeros((bucket - b, *shape), x.dtype)])
        with torch.inference_mode():
            xt = torch.from_numpy(xp).cuda()
            if wire == "SPQ3":
                xt = xt.to(torch.float32) / 255.0
            want = model(xt)[:b].float().cpu().numpy()
        if got.shape != (b, cfg.num_classes):
            raise AssertionError(f"{wire} batch {b}: reply shape {got.shape}")
        diff = float(np.abs(got - want).max())
        if not diff <= 1e-3:
            raise AssertionError(f"{wire} batch {b}: reply differs from a direct forward "
                                 f"by {diff}")
    print(f"serve: {len(replies)} replies match direct forwards (<= 1e-3); "
          f"launches during the serving run {counts}", flush=True)
    return counts


def _train_batch(cfg, normalize, batch: int):
    from spectre_tpu_torch.data import synthetic_dataset

    x, y = synthetic_dataset(cfg.dataset, "train")
    reps = -(-batch // len(x))
    x, y = np.tile(x, (reps, 1, 1, 1))[:batch], np.tile(y, reps)[:batch]
    return normalize(torch.from_numpy(x).cuda()), torch.from_numpy(y).cuda()


def _backward_once(state, x, y, seed: int):
    """Loss and gradients of one forward and backward from the current
    weights, with the dropout masks of ``seed``."""
    from spectre_tpu_torch.train import cross_entropy_loss

    state.model.zero_grad(set_to_none=True)
    state.dropout_generator.manual_seed(seed)
    loss = cross_entropy_loss(state.model(x), y)
    loss.backward()
    torch.cuda.synchronize()
    return loss.item(), {n: p.grad.clone() for n, p in state.model.named_parameters()}


def phase_train(kernels, parse_config, mix_block: int):
    """The train path below the loop: exact launches of one step, finite
    loss and gradients, a falling loss on one batch, kernel path against
    plain path, then step times at B=256 and B=1024."""
    from spectre_tpu_torch.train import make_train_step
    from spectre_tpu_torch.train.loop import create_trainer, make_normalize

    cfg = parse_config(CONFIG)
    cfg.mix_block = mix_block
    tag = f"train mix_block={mix_block}"
    state = create_trainer(cfg, "cuda", steps_per_epoch=16)
    step = make_train_step(grad_clip_norm=cfg.grad_clip_norm)
    normalize = make_normalize(cfg.dataset, torch.device("cuda"))
    x, y = _train_batch(cfg, normalize, cfg.batch_size)

    kernels.reset_launch_counts()
    first = step(state, x, y)
    torch.cuda.synchronize()
    counts, want = kernels.launch_counts(), expected_launches(cfg, steps=1)
    if counts != want:
        raise AssertionError(f"{tag}: one step launched {counts}, want {want}")
    bad = [n for n, p in state.model.named_parameters()
           if p.grad is None or not torch.isfinite(p.grad).all()]
    if bad or not torch.isfinite(first["loss"]):
        raise AssertionError(f"{tag}: loss {first['loss'].item()}, no finite gradient for {bad}")
    losses = [first["loss"].item()] + [step(state, x, y)["loss"].item() for _ in range(7)]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{tag}: loss did not fall on a fixed batch: {losses}")
    print(f"{tag}: one step launches {counts}; every parameter has a finite gradient; "
          f"8 steps on one batch: loss {losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)

    loss_k, grads_k = _backward_once(state, x, y, seed=1)
    with plain_versions(kernels):
        kernels.reset_launch_counts()
        loss_p, grads_p = _backward_once(state, x, y, seed=1)
        if any(kernels.launch_counts().values()):
            raise AssertionError(f"{tag}: the plain path launched {kernels.launch_counts()}")
    worst, where = 0.0, ""
    for name, gp in grads_p.items():
        rel = ((grads_k[name] - gp).abs().max() / gp.abs().max()).item()
        if rel > worst:
            worst, where = rel, name
    if not (worst <= TRAIN_GRAD_REL and abs(loss_k - loss_p) <= 0.05):
        raise AssertionError(f"{tag}: kernel path vs plain path: loss {loss_k} vs {loss_p}, "
                             f"gradient rel err {worst} at {where} > {TRAIN_GRAD_REL}")
    print(f"{tag}: kernel path vs plain path, one backward in bf16: loss {loss_k:.5f} vs "
          f"{loss_p:.5f}, worst gradient rel err {worst:.4g} at {where} "
          f"(limit {TRAIN_GRAD_REL})", flush=True)
    del grads_k, grads_p

    timings = {}
    for batch in (256, 1024):
        xb, yb = _train_batch(cfg, normalize, batch)
        for _ in range(2):
            step(state, xb, yb)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_time_ms(lambda: step(state, xb, yb), iters=1, reps=5)
        peak = torch.cuda.max_memory_allocated() / 1e9
        timings[batch] = (ms, batch / ms * 1e3, peak)
        print(f"{tag}: B={batch} {ms:.2f} ms/step, {batch / ms * 1e3:.0f} img/s, peak memory "
              f"{peak:.2f} GB (CUDA events, median of 5 steps after warm-up)", flush=True)
        del xb, yb
    return timings


def phase_train_cli(kernels, train_cli, parse_config, mix_block: int):
    """The entry point a user calls: 4 steps and the validation pass."""
    cfg = parse_config(CONFIG)
    cfg.mix_block = mix_block
    kernels.reset_launch_counts()
    result = train_cli.main(["--config", CONFIG, "--synthetic", "--steps", "4",
                             "--no-checkpoint", "--set", "epochs=1",
                             f"mix_block={mix_block}"])
    counts = kernels.launch_counts()
    val_batches = -(-1024 // cfg.val_batch_size)
    want = expected_launches(cfg, forwards=val_batches, steps=4)
    if counts != want:
        raise AssertionError(f"train CLI mix_block={mix_block} launched {counts}, want {want}")
    if result.state.step != 4 or not np.isfinite(result.train_losses[-1]):
        raise AssertionError(f"train CLI: step {result.state.step}, "
                             f"loss {result.train_losses}")
    print(f"train CLI mix_block={mix_block}: 4 steps + {val_batches} validation batches "
          f"launched {counts}", flush=True)
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 2
    # the port, imported only once a card is known to be there
    from spectre_tpu_torch.configs import parse_config
    from spectre_tpu_torch.models import build_model
    from spectre_tpu_torch.ops import kernels
    from spectre_tpu_torch.ops.kernels import build
    from spectre_tpu_torch.repl import serve
    from spectre_tpu_torch.repl import train as train_cli
    from spectre_tpu_torch.serving import SpectreClient

    if not os.path.exists(CONFIG):
        raise FileNotFoundError(CONFIG)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"device: {name} ({smi}); torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    so = build.build()
    build.load_library()
    print(f"build: {os.path.relpath(so, ROOT)} in {time.perf_counter() - t0:.2f} s", flush=True)

    gen = torch.Generator().manual_seed(0)
    k1 = phase_kernel1(kernels, gen)
    k2 = phase_kernel2(kernels, gen)
    k3, k4 = phase_gather_kernels(kernels, gen)
    model, cfg = phase_model(kernels, build_model, parse_config)
    serving = phase_serve(kernels, serve, SpectreClient, model, cfg)
    del model
    torch.cuda.empty_cache()
    step_times = {blk: phase_train(kernels, parse_config, blk) for blk in (64, 0)}
    block_run = phase_train_cli(kernels, train_cli, parse_config, 64)
    uniform_run = phase_train_cli(kernels, train_cli, parse_config, 0)

    # launches: the training CLI's run (kernel 4 from the mix_block=0 run)
    k1["launches"] = block_run["block_scatter_rows"]
    k2["launches"] = block_run["fused_spectre_linear"]
    k3["launches"] = block_run["block_gather_sum"]
    k4["launches"] = uniform_run["inverse_gather_sum"]
    k1["launches_serving"] = serving["block_scatter_rows"]
    k2["launches_serving"] = serving["fused_spectre_linear"]
    result = {"kernels": [k1, k2, k3, k4],
              "train_step": {f"mix_block={blk}": {f"B={b}": {"ms": ms, "img_per_s": rate,
                                                             "peak_gb": peak}
                                                  for b, (ms, rate, peak) in t.items()}
                             for blk, t in step_times.items()}}
    print(smi, flush=True)
    print(json.dumps(result), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
