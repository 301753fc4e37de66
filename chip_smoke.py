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
   three shapes for B=256 and B=1024, and at the structured and gather mixes'
   projection (16,640 x 8,192)·(8,192 x 512), f32 (<= 1e-4: only the summation
   order differs) and bf16 (<= 2e-2: one bf16 ulp is 7.8e-3 near 1 and 1.6e-2
   in [2, 4); <= 4e-2 at K=8,192, whose pre-LN values reach [4, 8)),
   for the output and for the saved pre-LN ``h``; the autograd Function's
   five gradients vs autograd of the plain version (limits at GRAD_REL);
   times with and without ``h``, and of the backward.
5. kernel 5 (fused_block_bwd) vs its plain version at the flagship mix shape
   (d=33,280, H=16, O=512, blk=64) for B in {256, 1024, 250}, bf16 (<= 1e-2 of
   the largest entry: one bf16 ulp of an entry is 2^-8 of it) and f32 (<= 1e-4
   of the largest entry: FMAs in another order), with its distance to the
   chain it fuses (the dg4 product, the signs, block_gather_sum); times of
   the kernel, the plain version and the chain.
6. kernel 3 (block_gather_sum) and kernel 4 (inverse_gather_sum) vs their
   plain versions at the flagship mix shape, B in {1, 3, 64, 256, 1024},
   bf16 and f32: bitwise equal (kernel and plain version add the same
   float32 values in head order and cast once). Median times and GB/s at
   B=256 and B=1024, kernel 4 beside kernel 3.
7. model: the flagship config (spectre_tpu_torch/configs/spectre_vit_cifar100.py)
   at full width on cuda, the port's seeded init; one bucket-256 forward
   must launch exactly 4 block-scatter and 9 fused-linear kernels, give
   finite [256, 100] logits, and agree with the same module run on the
   plain versions (tolerance below).
8. serve: the serving CLI's start path (repl/serve.py) on loopback port 0;
   SPQ2 f32 requests of batch 1, 7 and 64 and an SPQ3 u8 request of batch
   5 through the port's SpectreClient, each sent twice; replies checked
   against a direct forward of the same padded bucket. Launch counts are
   reset just before the server starts and read right after its run.
9. train: the flagship in train mode at the config's batch 256 on synthetic
   data. One step must launch exactly 4 block-scatter, 4 block-gather and 9
   fused-linear kernels, give a finite loss and a finite gradient for every
   parameter; 8 steps on one fixed batch must end below the first loss; one
   backward on the kernel path must agree with the same backward on the
   plain versions (TRAIN_GRAD_REL). With mix_block=0 one step must launch 4
   inverse-gather kernels instead. ms per step, img/s and peak memory at
   B=256 and B=1024 for both tables, without and (mix_block=64) with the
   trainer's augmentation inside the step, and the augmentation alone. The
   augmentation runs once under ``torch.cuda.set_sync_debug_mode("error")``:
   a host sync inside it fails the phase.
10. the training CLI (repl/train.py) as a user starts it, 4 steps and the
   validation pass, with mix_block=64 and with mix_block=0: exact launch
   counts, reset just before and read just after each run.
11. the whole trainer through the same CLI, flagship config, synthetic data,
   augmentation on, checkpoints and metric files in a temporary directory:
   one run to step 20 (the second epoch's fourth step); a run to step 6 and
   the same command with ``--resume`` to step 20. Exact launch counts of
   each run (4 + 4 + 9 per step, kernel 5 none); the resumed run must end
   with the uninterrupted run's step, loss, validation accuracy, parameters,
   AdamW moments and generator state, bit for bit. These are the
   ``launches`` of kernels 1-3 in the result line. Checkpoint save and
   restore seconds and the file's size.
12. a training subprocess gets SIGTERM after its second epoch: it must save
   and exit 0, and repl/eval.py must restore that checkpoint.
13. ``repl/perf.py fused-bwd`` (kernel 5's entry point: chain against kernel at
   B=256 and B=1024; its launch count is kernel 5's ``launches``) and the
   ``repl/bench.py`` line (flagship step with augmentation at B=1024).
14. the attention kernels (flash_attention_fwd, flash_attention_bwd) vs their
   plain versions at [256,16,65,32], [1024,16,65,32] and [64,4,50,16], bf16
   and f32, with and without the probability multiplier ``pm``, on strided
   [B, N, H, D] views as the model passes them: f32 within 1e-5 of the
   largest entry (sums in another order), bf16 (the tensor-core kernels,
   with P * pm and dS rounded to bf16 as the plain version states) within
   one bf16 ulp of the largest entry (2^-7 of it at most), and within 2^-6
   of the float32 arithmetic on the same inputs. Times at B=256 and B=1024,
   back to back and on the device alone (calls queued ahead of the card),
   beside the plain version and ``scaled_dot_product_attention`` (forward;
   backward by autograd).
15. the Walsh-Hadamard kernel (fwht) vs its plain version at [16,640, 512],
   [16,640, 1024], [4,160, 4,096] and [520, 32,768], bf16 and f32,
   normalised and not: bitwise equal (the same float32 pairs added in the
   same order). Times at the first three.
16. the structured-mix kernels (structured_mix, structured_mix_bwd) vs their
   plain versions at the flagship shape (d=33,280, H=16, tile 128) for B=256
   and B=250 and at small ragged shapes, bf16 and f32: bitwise equal. Times
   at B=256, beside the matrix form (ops/permute.py::structured_mix).
17. the baseline ViT (spectre_tpu_torch/configs/vit_cifar100.py) at full
   width: a bucket-256 forward must launch exactly 4 attention kernels, give
   finite logits and agree with the plain path (MODEL_ATOL); the serving CLI
   answers requests of batch 1, 7 and 64 (replies within 1e-3 of direct
   forwards); the training CLI runs to step 14 in one run, and to step 10
   and then ``--resume`` to step 14 in two, with the augmentation, the
   validation pass and checkpoints: exact launch counts (4 forward and 4
   backward attention launches a step at the config's dropout 0.001, 4
   forward per validation batch; these are the ``launches`` of kernels 8 and
   9), and the resumed run must equal the uninterrupted one bit for bit;
   one step under ``set_sync_debug_mode("error")``; ms per step and peak
   memory at B=256 and B=1024. Then the serving CLI serves that trainer's
   checkpoint directory (``--ckpt``; its best step, 14): replies within 1e-3
   of the trained model's direct forwards.
18. SpectreViT with ``mix_impl="structured"`` at full width: a bucket-256
   forward against the plain path, 3 train steps at B=256 through the
   training CLI with exact launch counts (4 structured_mix and 4
   structured_mix_bwd a step, 13 fused-linear of which 4 at K=8,192; kernel
   7's ``launches``), one step under ``set_sync_debug_mode("error")``, ms per
   step; ``repl/perf.py attention`` and ``repl/perf.py structured`` through
   their ``main``; ``ops/hadamard.py::fwht`` and ``hadamard_transform`` on
   card tensors (kernel 6's ``launches``).

19. kernel B9 (routed_gather_sum) against its plain version and kernel 4,
   the routed flagship trainer (route tables cold and cached, one backward
   against kernel 3's, the training CLI with ``mix_routed``) and
   ``repl/bench.py --set mix_routed=True mix_routed_impl=pallas`` at B=256:
   B9 on every layer of every step, none of kernel 3, and ``"mix_routed":
   true`` on its line; SpectreBranch through the server, the training CLI
   and the bench; ``gather_tm`` steps.

Prints the card line, one JSON line of per-kernel results, then
``{"ok": true, "device": {...}}`` as the last line. Exits non-zero, with no
result, when CUDA is missing or the port is not beside this script.
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from unittest import mock

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "spectre_tpu_torch", "configs", "spectre_vit_cifar100.py")
VIT_CONFIG = os.path.join(ROOT, "spectre_tpu_torch", "configs", "vit_cifar100.py")
BRANCH_CONFIG = os.path.join(ROOT, "spectre_tpu_torch", "configs", "spectre_branch.py")
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
    ("spectre_tpu_torch.ops.fused_mix.routed_gather_sum", "routed_gather_sum_plain"),
    ("spectre_tpu_torch.ops.linear.fused_spectre_linear", "fused_spectre_linear_plain"),
    ("spectre_tpu_torch.ops.kernels.fused_linear.fused_spectre_linear",
     "fused_spectre_linear_plain"),
)


@contextlib.contextmanager
def plain_versions(kernels):
    """Swap every wrapper the model calls for its plain version."""
    attention = "spectre_tpu_torch.ops.kernels.attention."
    structured = "spectre_tpu_torch.ops.kernels.structured_mix."
    with contextlib.ExitStack() as stack:
        for target, name in PLAIN_PATCHES:
            stack.enter_context(mock.patch(target, getattr(kernels, name)))
        # the autograd Functions look these up when they run
        for target, plain in (
                (attention + "flash_attention_fwd", kernels.flash_attention_fwd_plain),
                (attention + "flash_attention_bwd", kernels.flash_attention_bwd_plain),
                (structured + "structured_mix",
                 lambda x, tp, sg, n, inv=None: kernels.structured_mix_plain(x, tp, sg, n)),
                (structured + "structured_mix_bwd",
                 lambda g, tp, sg, inv=None: kernels.structured_mix_bwd_plain(g, tp, sg))):
            stack.enter_context(mock.patch(target, plain))
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


def device_time_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """As ``cuda_time_ms``, with the calls queued behind a device sleep so
    that the card runs them back to back: the device's own time, without the
    host's per-call overhead (Python, ctypes), which a small kernel can fall
    below. A repetition whose calls took the host longer to queue than the
    sleep lasted is taken again behind a sleep twice as long."""
    fn()
    times, cycles = [], 10_000_000
    while len(times) < reps:
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
        t0 = time.perf_counter()
        torch.cuda._sleep(cycles)
        marks[1].record()
        for _ in range(iters):
            fn()
        queued_ms = (time.perf_counter() - t0) * 1e3
        marks[2].record()
        torch.cuda.synchronize()
        if queued_ms >= marks[0].elapsed_time(marks[1]):
            if cycles >= 640_000_000:
                raise AssertionError(f"device_time_ms: queueing {iters} calls took "
                                     f"{queued_ms:.2f} ms, longer than any sleep tried")
            cycles *= 2
            continue
        times.append(marks[1].elapsed_time(marks[2]) / iters)
    return statistics.median(times)


def max_abs_diff(got: torch.Tensor, ref: torch.Tensor) -> float:
    return (got.float() - ref.float()).abs().max().item()


def rel_to_largest(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest difference as a share of the reference's largest entry."""
    return max_abs_diff(got, ref) / ref.float().abs().max().item()


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
    # the mix projection under mix_impl "gather" and "structured", at B=256
    wide = (65 * 256, 8192, 512)
    shapes.append(wide)
    limits = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    worst, worst_h, worst_grad = {}, {}, {}
    times, wide_res = [], {}
    for m, k, n in shapes:
        x = torch.randn(m, k, generator=gen)
        w = torch.empty(k, n).uniform_(-k ** -0.5, k ** -0.5, generator=gen)
        bias = torch.empty(n).uniform_(-k ** -0.5, k ** -0.5, generator=gen)
        gamma = 1.0 + 0.1 * torch.randn(n, generator=gen)
        beta = 0.1 * torch.randn(n, generator=gen)
        ct = torch.randn(m, n, generator=gen)
        for dtype, limit in limits.items():
            if k > 1024 and dtype == torch.bfloat16:
                limit = 4e-2  # pre-LN values reach [4, 8): one bf16 ulp there is 3.1e-2
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
            it = 5 if k > 1024 else 20
            ms_k = cuda_time_ms(lambda: kernels.fused_spectre_linear(*args), iters=it)
            ms_h = cuda_time_ms(lambda: kernels.fused_spectre_linear(*args, save_h=True),
                                iters=it)
            ms_p = cuda_time_ms(lambda: kernels.fused_spectre_linear_plain(*args), iters=it)
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
                if (m, k, n) == wide:
                    bound_w, by_w = bound(io, gflops * 1e9)
                    wide_res = {"ms_k8192": ms_h, "ms_without_h_k8192": ms_k,
                                "plain_ms_k8192": ms_p, "bound_ms_k8192": bound_w,
                                "bound_by_k8192": by_w, "backward_ms_k8192": ms_bk,
                                "plain_backward_ms_k8192": ms_bp,
                                "max_abs_err_k8192": max(err, err_h)}
                elif m <= 65 * 256:  # the result line reports the config's batch
                    times.append((m, k, n, ms_h, ms_k, ms_p, ms_bk, ms_bp, io, gflops * 1e9))
            print(line, flush=True)
        del x, w, ct
        torch.cuda.empty_cache()
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
            "grad_rel_err_f32": worst_grad[torch.float32], **wide_res,
            "shape": f"({m}x{k})x({k}x{n}) bf16, writing h"}


# kernel 5 against its plain version, as a share of the result's largest
# entry. bf16: both add exact products in float32 and round once, so single
# entries differ by one bf16 ulp (2^-8 of the entry). f32: plain FMAs (no
# TF32) in another order than the plain version's float32 product.
FUSED_BWD_REL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def phase_kernel5(kernels):
    """Kernel 5 at the flagship mix backward's shape: dy [65, B, 512],
    w [8,192, 512], s4 [65, 8,192], binv [16, 520], blk 64 -> dxt [33,280, B]."""
    d, heads, blk, n_tok, o = 33_280, 16, 64, 65, 512
    eh = heads * d // n_tok
    gen = torch.Generator(device="cuda").manual_seed(5)
    binv = torch.stack([torch.randperm(d // blk, generator=gen, device="cuda")
                        for _ in range(heads)]).to(torch.int32)
    res = {}
    for dtype in (torch.bfloat16, torch.float32):
        w = torch.randn(eh, o, generator=gen, device="cuda").to(dtype)
        s4 = (torch.randint(0, 2, (n_tok, eh), generator=gen, device="cuda") * 2 - 1).to(dtype)
        for b in (256, 1024, 250):
            dy = torch.randn(n_tok, b, o, generator=gen, device="cuda").to(dtype)

            def chain():
                dg4 = torch.bmm(w.expand(n_tok, -1, -1), dy.transpose(1, 2))
                dg4.mul_(s4[:, :, None])
                return kernels.block_gather_sum(dg4.view(heads * d, b), binv, blk)

            got = kernels.fused_block_bwd(dy, w, s4, binv, blk)
            torch.cuda.synchronize()
            want = kernels.fused_block_bwd_plain(dy, w, s4, binv, blk)
            scale = want.float().abs().max().item()
            err, err_chain = max_abs_diff(got, want), max_abs_diff(got, chain())
            limit = FUSED_BWD_REL[dtype] * scale
            if tuple(got.shape) != (d, b) or not err <= limit:
                raise AssertionError(f"fused_block_bwd B={b} {dtype}: max abs err {err} > "
                                     f"{limit} ({FUSED_BWD_REL[dtype]} of {scale})")
            bf = dtype == torch.bfloat16
            ms_k = cuda_time_ms(lambda: kernels.fused_block_bwd(dy, w, s4, binv, blk),
                                iters=20 if bf else 3)
            ms_p = cuda_time_ms(lambda: kernels.fused_block_bwd_plain(dy, w, s4, binv, blk),
                                iters=2, reps=3)
            ms_c = cuda_time_ms(chain, iters=20 if bf else 3)
            flops = 2 * d * heads * o * b
            moved = (n_tok * b * o + eh * o + n_tok * eh + d * b) * dy.element_size() \
                + binv.numel() * 4
            bound_ms, bound_by = bound(moved, flops)
            res[dtype, b] = dict(err=err, scale=scale, err_chain=err_chain, ms=ms_k, plain=ms_p,
                                 chain=ms_c, bound=bound_ms, by=bound_by)
            print(f"kernel 5 fused_block_bwd B={b} {str(dtype)[6:]}: max abs err {err:.4g} "
                  f"({err / scale:.3g} of the largest entry {scale:.1f}, limit "
                  f"{FUSED_BWD_REL[dtype]}), to the chain {err_chain:.4g}; kernel {ms_k:.4f} ms "
                  f"({flops / ms_k / 1e9:.1f} TFLOP/s), chain {ms_c:.4f} ms, plain {ms_p:.4f} "
                  f"ms, bound {bound_ms:.4f} ms by {bound_by} (bf16 tensor-core peak)",
                  flush=True)
            del dy, got, want
            torch.cuda.empty_cache()
    r = res[torch.bfloat16, 256]
    bf16 = [v for (dt, _), v in res.items() if dt == torch.bfloat16]
    f32 = [v for (dt, _), v in res.items() if dt == torch.float32]
    return {"name": "fused_block_bwd", "route": "cuda",
            "source": "spectre_tpu_torch/csrc/fused_block_bwd.cu",
            "replaces": "spectre_tpu/ops/pallas/bwd_gather.py:426",
            "max_abs_err": max(v["err"] for v in bf16), "ms": r["ms"], "plain_ms": r["plain"],
            "bound_ms": r["bound"], "bound_by": r["by"], "library_ms": None,
            "chain_ms": r["chain"],
            "max_rel_err": max(v["err"] / v["scale"] for v in bf16),
            "max_rel_err_f32": max(v["err"] / v["scale"] for v in f32),
            "max_abs_err_to_chain": max(v["err_chain"] for v in bf16),
            **{f"{key}_b{b}": res[torch.bfloat16, b][src] for b in (1024, 250)
               for key, src in (("ms", "ms"), ("chain_ms", "chain"), ("bound_ms", "bound"))},
            **{f"{key}_f32_b{b}": res[torch.float32, b][src] for b in (256, 1024)
               for key, src in (("ms", "ms"), ("chain_ms", "chain"))},
            "shape": f"dy[{n_tok},256,{o}] w[{eh},{o}] bf16 -> [{d},256]"}


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


KERNEL_NAMES = ("block_scatter_rows", "block_gather_sum", "inverse_gather_sum",
                "fused_spectre_linear", "fused_block_bwd", "flash_attention_fwd",
                "flash_attention_bwd", "fwht", "structured_mix", "structured_mix_bwd",
                "routed_gather_sum")


def expected_launches(cfg, forwards: int = 0, steps: int = 0) -> dict[str, int]:
    """Launches of ``forwards`` inference forwards plus ``steps`` train steps
    (forward and backward) of the configured model."""
    layers, both = cfg.num_encoders, forwards + steps
    counts = dict.fromkeys(KERNEL_NAMES, 0)
    if cfg.model == "vit":  # Dense layers, no SpectreLinear
        counts.update(flash_attention_fwd=layers * both, flash_attention_bwd=layers * steps)
        return counts
    # linear1 and linear3 of each layer and the head; the branch's are Denses
    linears = 0 if cfg.model == "spectre_branch" else 2 * layers + 1
    if cfg.method == "attention":
        counts.update(flash_attention_fwd=layers * both, flash_attention_bwd=layers * steps)
    elif cfg.method == "permut_mix" and cfg.mix_impl == "folded":
        # the routed backward takes precedence over the block tables
        routed = bool(getattr(cfg, "mix_routed", False))
        block = bool(getattr(cfg, "mix_block", 0)) and not routed
        counts.update(block_scatter_rows=layers * both, block_gather_sum=layers * steps * block,
                      inverse_gather_sum=layers * steps * (not block and not routed),
                      routed_gather_sum=layers * steps * routed)
    elif cfg.method == "permut_mix" and cfg.mix_impl != "gather_tm":
        linears += layers  # the mix projection is a SpectreLinear at K = E*H
        if cfg.mix_impl == "structured":
            counts.update(structured_mix=layers * both, structured_mix_bwd=layers * steps)
    counts["fused_spectre_linear"] = linears * both
    return counts


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
    # one closed-loop client: every request is one bucket, one forward
    counts, want = kernels.launch_counts(), expected_launches(cfg, forwards=srv.forwards)
    if srv.forwards != len(replies) or counts != want:
        raise AssertionError(f"serving ran {srv.forwards} forwards for {len(replies)} requests "
                             f"and launched {counts}, want {want}")
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


def _train_batch(cfg, batch: int):
    """Raw pixels in [0, 1] and labels of the synthetic dataset, on the card."""
    from spectre_tpu_torch.data import synthetic_batch

    x, y = synthetic_batch(cfg.dataset, batch)
    return torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()


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
    from spectre_tpu_torch.data import make_eval_transform
    from spectre_tpu_torch.train import make_train_step
    from spectre_tpu_torch.train.loop import create_trainer, dataset_stats, default_augment

    cfg = parse_config(CONFIG)
    cfg.mix_block = mix_block
    tag = f"train mix_block={mix_block}"
    state = create_trainer(cfg, "cuda", steps_per_epoch=16)
    step = make_train_step(grad_clip_norm=cfg.grad_clip_norm)
    normalize = make_eval_transform(*dataset_stats(cfg.dataset))
    augment = default_augment(cfg.dataset, cfg.in_channels)
    step_aug = make_train_step(augment, grad_clip_norm=cfg.grad_clip_norm)
    raw, y = _train_batch(cfg, cfg.batch_size)
    x = normalize(raw)

    if mix_block:
        # the trainer's augmentation may not wait for the host: one call makes
        # the per-device constants, the next runs with every sync an error
        augment(state.dropout_generator, raw)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = augment(state.dropout_generator, raw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if tuple(out.shape) != tuple(raw.shape) or not torch.isfinite(out).all():
            raise AssertionError(f"{tag}: augmentation gave shape {tuple(out.shape)}")
        print(f"{tag}: the augmentation ran under set_sync_debug_mode('error') with no host "
              f"sync; output mean {out.mean().item():.4f}, std {out.std().item():.4f}",
              flush=True)

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
        rawb, yb = _train_batch(cfg, batch)
        xb = normalize(rawb)
        for _ in range(2):
            step(state, xb, yb)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_time_ms(lambda: step(state, xb, yb), iters=1, reps=5)
        peak = torch.cuda.max_memory_allocated() / 1e9
        timings[batch] = {"ms": ms, "img_per_s": batch / ms * 1e3, "peak_gb": peak}
        print(f"{tag}: B={batch} {ms:.2f} ms/step, {batch / ms * 1e3:.0f} img/s, peak memory "
              f"{peak:.2f} GB (CUDA events, median of 5 steps after warm-up)", flush=True)
        if mix_block:
            # the step users run: raw pixels in, the augmentation inside;
            # without, with, with, without in one process
            step_aug(state, rawb, yb)
            ms_aug = [cuda_time_ms(lambda: step_aug(state, rawb, yb), iters=1, reps=5)
                      for _ in range(2)]
            ms_again = cuda_time_ms(lambda: step(state, xb, yb), iters=1, reps=5)
            ms_alone = cuda_time_ms(lambda: augment(state.dropout_generator, rawb))
            with_aug, without = min(ms_aug), min(ms, ms_again)
            timings[batch].update(ms_with_augment=with_aug, ms_without_again=ms_again,
                                  augment_alone_ms=ms_alone,
                                  augment_share=(with_aug - without) / with_aug)
            print(f"{tag}: B={batch} with the augmentation {ms_aug[0]:.2f}, {ms_aug[1]:.2f} "
                  f"ms/step, without again {ms_again:.2f}; the augmentation alone "
                  f"{ms_alone:.3f} ms; its share of a step "
                  f"{(with_aug - without) / with_aug:.4f}", flush=True)
        del rawb, xb, yb
    return timings


def phase_train_cli(kernels, train_cli, parse_config, mix_block: int, tmp: str):
    """The entry point a user calls: 4 steps and the validation pass (metric
    files under ``tmp``)."""
    cfg = parse_config(CONFIG)
    cfg.mix_block = mix_block
    kernels.reset_launch_counts()
    result = train_cli.main(["--config", CONFIG, "--synthetic", "--steps", "4",
                             "--no-checkpoint", "--set", "epochs=1",
                             f"mix_block={mix_block}",
                             f"checkpoint_dir={os.path.join(tmp, f'cli{mix_block}')}"])
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


def _same_state(a, b) -> list[str]:
    """Names of what differs, bit for bit, between two train states."""
    bad = [] if a.step == b.step else [f"step {a.step} != {b.step}"]
    sa, sb = a.model.state_dict(), b.model.state_dict()
    bad += [k for k in sa if not torch.equal(sa[k], sb[k])]
    oa, ob = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    bad += [f"adamw[{i}].{k}" for i in oa for k in ("step", "exp_avg", "exp_avg_sq")
            if not torch.equal(oa[i][k], ob[i][k])]
    if not torch.equal(a.dropout_generator.get_state(), b.dropout_generator.get_state()):
        bad.append("generator")
    if a.scheduler.state_dict() != b.scheduler.state_dict():
        bad.append("scheduler")
    return bad


def phase_trainer(kernels, train_cli, parse_config, tmp: str):
    """The whole trainer through its CLI: an uninterrupted run to step 20
    against a run to step 6 resumed to step 20, at full width with the
    augmentation, checkpoints and metric files on."""
    from spectre_tpu_torch.train import CheckpointManager

    cfg = parse_config(CONFIG)
    val_batches = -(-1024 // cfg.val_batch_size)

    def run(name, steps, resume=False):
        kernels.reset_launch_counts()
        result = train_cli.main(["--config", CONFIG, "--synthetic", "--steps", str(steps),
                                 *(["--resume"] if resume else []),
                                 "--set", f"checkpoint_dir={os.path.join(tmp, name)}"])
        return result, kernels.launch_counts()

    runs = {}
    # (steps this run takes, epochs whose validation pass it runs)
    for name, steps, resume, took, vals in (("whole", 20, False, 20, 2), ("first", 6, False, 6, 1),
                                            ("resumed", 20, True, 14, 2)):
        result, counts = run("whole" if name == "whole" else "parts", steps, resume)
        want = expected_launches(cfg, forwards=vals * val_batches, steps=took)
        if counts != want:
            raise AssertionError(f"trainer run {name!r} launched {counts}, want {want}")
        if result.state.step != steps:
            raise AssertionError(f"trainer run {name!r} ended at step {result.state.step}")
        runs[name] = (result, counts)
        print(f"trainer {name}: to step {steps} ({took} steps, {vals} validation passes) "
              f"launched {counts}", flush=True)
    whole, resumed = runs["whole"][0], runs["resumed"][0]
    bad = _same_state(whole.state, resumed.state)
    same_numbers = (whole.train_losses[-1] == resumed.train_losses[-1]
                    and whole.last_val_accuracy == resumed.last_val_accuracy)
    if bad or not same_numbers or not np.isfinite(whole.train_losses[-1]):
        raise AssertionError(
            f"resumed run differs from the uninterrupted one: {bad[:8]} ({len(bad)} in all); "
            f"loss {whole.train_losses[-1]!r} vs {resumed.train_losses[-1]!r}, val acc "
            f"{whole.last_val_accuracy!r} vs {resumed.last_val_accuracy!r}")
    n_tensors = len(whole.state.model.state_dict())
    print(f"trainer: stopped at step 6 and resumed to step 20 == uninterrupted, bit for bit "
          f"({n_tensors} parameters and buffers, their AdamW moments, the generator, the "
          f"schedule); epoch-2 train loss {whole.train_losses[-1]:.6f}, val acc "
          f"{whole.last_val_accuracy:.4f}", flush=True)
    for name in ("whole", "parts"):
        logdir = runs["whole" if name == "whole" else "resumed"][0].logdir
        for must in ("events.jsonl", os.path.join("ckpt", "index.json"),
                     os.path.join("ckpt", "step_00000020.pt")):
            if not os.path.exists(os.path.join(logdir, must)):
                raise AssertionError(f"trainer: {must} missing under {logdir}")

    # checkpoint cost at the flagship
    mgr = CheckpointManager(os.path.join(tmp, "timing"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(whole.state, {"accuracy": whole.last_val_accuracy})
    save_s = time.perf_counter() - t0
    size = os.path.getsize(os.path.join(tmp, "timing", "step_00000020.pt"))
    t0 = time.perf_counter()
    mgr.restore(resumed.state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if _same_state(whole.state, resumed.state):
        raise AssertionError("trainer: a restored checkpoint differs from the saved state")
    print(f"trainer: checkpoint of the flagship state {size / 1e6:.1f} MB, save {save_s:.3f} s, "
          f"restore {restore_s:.3f} s (host clock, synchronised)", flush=True)
    return runs["whole"][1], {"checkpoint_mb": size / 1e6, "save_s": save_s,
                              "restore_s": restore_s,
                              "loop_steps_per_s": whole.steps_per_sec,
                              "loop_img_per_s": whole.images_per_sec}


def phase_sigterm(eval_cli, parse_config, tmp: str):
    """SIGTERM to a training subprocess: it saves and exits 0, and the eval
    entry point restores what it left."""
    from spectre_tpu_torch.train import CheckpointManager

    cmd = [sys.executable, "-m", "spectre_tpu_torch.repl.train", "--config", CONFIG,
           "--synthetic", "--set", f"checkpoint_dir={os.path.join(tmp, 'sigterm')}"]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    watchdog = threading.Timer(300, proc.kill)
    watchdog.start()
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("epoch 2/"):
                proc.send_signal(signal.SIGTERM)
                break
        lines += proc.communicate()[0].splitlines(keepends=True)
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = "".join(lines)
    if proc.returncode != 0 or "preempted at step " not in out:
        raise AssertionError(f"SIGTERM run: exit {proc.returncode}\n{out[-3000:]}")
    step = int(out.split("preempted at step ")[1].split(":")[0])
    ckpt = os.path.join(out.strip().rsplit("-> ", 1)[1], "ckpt")
    mgr = CheckpointManager(ckpt)
    if mgr.latest_step != step or not step > 32:
        raise AssertionError(f"SIGTERM run: preempted at {step}, latest checkpoint "
                             f"{mgr.latest_step}")
    loss, acc = eval_cli.evaluate(parse_config(CONFIG), ckpt, synthetic=True, device="cuda")
    if not (np.isfinite(loss) and 0.0 <= acc <= 1.0):
        raise AssertionError(f"SIGTERM run: eval of the saved checkpoint gave {loss}, {acc}")
    print(f"sigterm: the training subprocess saved at step {step} and exited 0; repl/eval.py "
          f"restored it: val loss {loss:.4f}, top-1 {acc:.4f}", flush=True)
    return step


def phase_fused_bwd_cli(kernels, perf_cli):
    """Kernel 5's entry point, as a user starts it."""
    kernels.reset_launch_counts()
    res = perf_cli.main(["fused-bwd", "--batch", "256", "1024", "--iters", "10"])
    counts = kernels.launch_counts()
    if counts["fused_block_bwd"] < 1 or counts["block_gather_sum"] < 1:
        raise AssertionError(f"perf fused-bwd launched {counts}")
    for b, r in res["fused_bwd"].items():
        if not r["max_abs_diff"] <= 4 * FUSED_BWD_REL[torch.bfloat16] * r["largest_entry"]:
            raise AssertionError(f"perf fused-bwd B={b}: chain and kernel differ by "
                                 f"{r['max_abs_diff']} of {r['largest_entry']}")
    print(f"perf fused-bwd launched {counts}", flush=True)
    return counts, res["fused_bwd"]


# the attention kernels against their plain versions, as a share of the
# reference's largest entry. f32: the same float32 products summed in another
# order. bf16: the plain version rounds P * pm and dS to bf16 where the
# tensor-core kernels do, so single entries differ by one bf16 ulp, which is
# 2^-8 to 2^-7 of the entry.
ATTENTION_REL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
# the bf16 kernels against the all-float32 arithmetic (the f32 plain version
# on the same bf16 inputs): P * pm, dS and the outputs each rounded once to
# bf16 (2^-9 of a value each)
ATTENTION_F32_REL = 2.0 ** -6


def phase_attention(kernels):
    """Kernels 8 and 9 at vit_cifar100's shape for B=256 and B=1024 and at
    vit_mnist's, on [B, H, N, D] views of [B, N, H, D] memory."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(8)
    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        for b, h, n, d in ((256, 16, 65, 32), (1024, 16, 65, 32), (64, 4, 50, 16)):
            q, k, v, g = (torch.randn(b, n, h, d, generator=gen, device="cuda").to(dtype)
                          .permute(0, 2, 1, 3) for _ in range(4))
            for use_pm in (False, True):
                pm = None
                if use_pm:
                    pm = torch.empty(n, n, device="cuda").bernoulli_(0.9, generator=gen) / 0.9
                o, lse = kernels.flash_attention_fwd(q, k, v, pm)
                dq, dk, dv = kernels.flash_attention_bwd(q, k, v, o, lse, g, pm)
                torch.cuda.synchronize()
                o_p, lse_p = kernels.flash_attention_fwd_plain(q, k, v, pm)
                grads_p = kernels.flash_attention_bwd_plain(q, k, v, o, lse, g, pm)
                err_f = rel_to_largest(o, o_p)
                err_l = max_abs_diff(lse, lse_p)
                err_b = max(rel_to_largest(a, r) for a, r in zip((dq, dk, dv), grads_p))
                limit = ATTENTION_REL[dtype]
                if not (err_f <= limit and err_b <= limit and err_l <= 1e-5):
                    raise AssertionError(
                        f"flash_attention [{b},{h},{n},{d}] {dtype} pm={use_pm}: forward "
                        f"{err_f}, lse {err_l}, backward {err_b} of the largest entry > {limit}")
                for key, val in (("fwd", err_f), ("bwd", err_b)):
                    worst[key, dtype] = max(worst.get((key, dtype), 0.0), val)
                    worst[key + "_abs", dtype] = max(
                        worst.get((key + "_abs", dtype), 0.0),
                        max_abs_diff(o, o_p) if key == "fwd" else
                        max(max_abs_diff(a, r) for a, r in zip((dq, dk, dv), grads_p)))
                if dtype == torch.bfloat16:  # how far the tensor cores move the results
                    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
                    o32, _ = kernels.flash_attention_fwd_plain(qf, kf, vf, pm)
                    grads32 = kernels.flash_attention_bwd_plain(qf, kf, vf, o.float(), lse, gf,
                                                                pm)
                    for key, val in (("fwd_f32", rel_to_largest(o, o32)),
                                     ("bwd_f32", max(rel_to_largest(a, r) for a, r in
                                                     zip((dq, dk, dv), grads32)))):
                        if not val <= ATTENTION_F32_REL:
                            raise AssertionError(
                                f"flash_attention [{b},{h},{n},{d}] bf16 pm={use_pm}: {key} "
                                f"{val} of the largest entry > {ATTENTION_F32_REL}")
                        worst[key] = max(worst.get(key, 0.0), val)
                    del qf, kf, vf, gf, o32, grads32
            del q, k, v, g, o, lse, dq, dk, dv
    print(f"kernels 8/9 flash_attention: within {ATTENTION_REL[torch.float32]} (f32) and one "
          f"bf16 ulp (bf16, <= 2^-7) of the largest entry at three shapes, with and without "
          f"pm: forward {worst['fwd', torch.float32]:.3g} / {worst['fwd', torch.bfloat16]:.3g}, "
          f"backward {worst['bwd', torch.float32]:.3g} / {worst['bwd', torch.bfloat16]:.3g}; "
          f"bf16 against the float32 arithmetic: forward {worst['fwd_f32']:.3g}, backward "
          f"{worst['bwd_f32']:.3g} of the largest entry (<= {ATTENTION_F32_REL})", flush=True)

    res = {}
    for b in (256, 1024):
        h, n, d = 16, 65, 32
        q, k, v, g = (torch.randn(b, n, h, d, generator=gen, device="cuda").to(torch.bfloat16)
                      .permute(0, 2, 1, 3) for _ in range(4))
        pm = torch.empty(n, n, device="cuda").bernoulli_(0.999, generator=gen) / 0.999
        o, lse = kernels.flash_attention_fwd(q, k, v)
        ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
        out_lib = F.scaled_dot_product_attention(ql, kl, vl)
        out_plain = kernels.flash_attention_plain(ql, kl, vl)
        # back to back from the host (cuda_time_ms), as every kernel's "ms";
        # "_dev": the calls queued ahead of the card, its own time (device_time_ms)
        r = {
            "fwd": cuda_time_ms(lambda: kernels.flash_attention_fwd(q, k, v)),
            "fwd_dev": device_time_ms(lambda: kernels.flash_attention_fwd(q, k, v)),
            "fwd_pm": cuda_time_ms(lambda: kernels.flash_attention_fwd(q, k, v, pm)),
            "fwd_plain": cuda_time_ms(lambda: kernels.flash_attention_fwd_plain(q, k, v),
                                      iters=5),
            "fwd_lib": cuda_time_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
            "fwd_lib_dev": device_time_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
            "bwd": cuda_time_ms(lambda: kernels.flash_attention_bwd(q, k, v, o, lse, g)),
            "bwd_dev": device_time_ms(lambda: kernels.flash_attention_bwd(q, k, v, o, lse, g)),
            "bwd_pm": cuda_time_ms(lambda: kernels.flash_attention_bwd(q, k, v, o, lse, g, pm)),
            "bwd_plain": cuda_time_ms(
                lambda: kernels.flash_attention_bwd_plain(q, k, v, o, lse, g), iters=5),
            "bwd_plain_autograd": cuda_time_ms(lambda: torch.autograd.grad(
                out_plain, (ql, kl, vl), g, retain_graph=True), iters=5),
            "bwd_lib": cuda_time_ms(lambda: torch.autograd.grad(
                out_lib, (ql, kl, vl), g, retain_graph=True)),
            "bwd_lib_dev": device_time_ms(lambda: torch.autograd.grad(
                out_lib, (ql, kl, vl), g, retain_graph=True)),
        }
        el, rows = 2, b * h * n
        flops_f = 4 * rows * n * d
        r["bound_fwd"], r["by_fwd"] = bound(4 * rows * d * el + rows * 4, flops_f)
        r["bound_bwd"], r["by_bwd"] = bound(8 * rows * d * el + rows * 4, 2.5 * flops_f)
        res[b] = r
        print(f"kernels 8/9 at [{b},{h},{n},{d}] bf16, back to back (device time): forward "
              f"{r['fwd']:.4f} ({r['fwd_dev']:.4f}) ms, with pm {r['fwd_pm']:.4f}, plain "
              f"{r['fwd_plain']:.4f}, scaled_dot_product_attention {r['fwd_lib']:.4f} "
              f"({r['fwd_lib_dev']:.4f}), bound {r['bound_fwd']:.4f} by {r['by_fwd']}; backward "
              f"{r['bwd']:.4f} ({r['bwd_dev']:.4f}) ms, with pm {r['bwd_pm']:.4f}, plain "
              f"{r['bwd_plain']:.4f} (autograd of plain {r['bwd_plain_autograd']:.4f}), autograd "
              f"of scaled_dot_product_attention {r['bwd_lib']:.4f} ({r['bwd_lib_dev']:.4f}), "
              f"bound {r['bound_bwd']:.4f} by {r['by_bwd']}", flush=True)
        del q, k, v, g, o, lse, ql, kl, vl, out_lib, out_plain
        torch.cuda.empty_cache()
    out = []
    for key, name, line in (("fwd", "flash_attention_fwd", 96),
                            ("bwd", "flash_attention_bwd", 116)):
        r = res[256]
        out.append({"name": name, "route": "cuda",
                    "source": "spectre_tpu_torch/csrc/attention.cu",
                    "replaces": f"spectre_tpu/ops/pallas/attention.py:{line}",
                    "max_abs_err": worst[key + "_abs", torch.bfloat16], "ms": r[key],
                    "plain_ms": r[key + "_plain"], "bound_ms": r["bound_" + key],
                    "bound_by": r["by_" + key], "library_ms": r[key + "_lib"],
                    "device_ms": r[key + "_dev"], "library_device_ms": r[key + "_lib_dev"],
                    "ms_with_pm": r[key + "_pm"], "ms_b1024": res[1024][key],
                    "device_ms_b1024": res[1024][key + "_dev"],
                    "bound_ms_b1024": res[1024]["bound_" + key],
                    "library_ms_b1024": res[1024][key + "_lib"],
                    "plain_ms_b1024": res[1024][key + "_plain"],
                    "max_rel_err": worst[key, torch.bfloat16],
                    "max_rel_err_f32": worst[key, torch.float32],
                    "rel_distance_to_f32_arithmetic": worst[key + "_f32"],
                    "shape": "q, k, v [256,16,65,32] bf16, views of [B,N,H,D]; device_ms: "
                             "the calls queued behind a device sleep"})
    return out


def phase_fwht(kernels, hadamard_matrix):
    """Kernel 6 against its plain version: bitwise equal, the same float32
    pairs added in the same order."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    shapes = ((16_640, 512), (16_640, 1024), (4160, 4096), (520, 32_768), (7, 8), (5, 4), (3, 1))
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for m, n in shapes:
            x = torch.randn(m, n, generator=gen, device="cuda").to(dtype)
            for normalize in (True, False):
                got, ref = kernels.fwht(x, normalize), kernels.fwht_plain(x, normalize)
                torch.cuda.synchronize()
                worst = max(worst, max_abs_diff(got, ref))
                if not torch.equal(got, ref):
                    raise AssertionError(f"fwht != plain at [{m}, {n}] {dtype} normalize="
                                         f"{normalize}: max abs err {max_abs_diff(got, ref)}")
            del x, got, ref
    print(f"kernel 6 fwht: bitwise equal to plain at {shapes}, bf16 and f32, normalised and "
          f"not (max abs err {worst})", flush=True)
    res = {}
    for m, n in shapes[:3]:
        x = torch.randn(m, n, generator=gen, device="cuda").to(torch.bfloat16)
        # the one library call that computes the same function, as the TPU
        # kernel does it: a product with H_n (entries +-1, exact in bf16; the
        # bound counts the bytes of x and the result, as for the kernel)
        h_n = hadamard_matrix(n, normalize=False).to("cuda", torch.bfloat16)
        err_lib = rel_to_largest(torch.matmul(x, h_n).float() * n ** -0.5, kernels.fwht(x))
        if not err_lib <= 2.0 ** -6:  # the product rounds before the scale, the kernel after
            raise AssertionError(f"x @ H_{n} differs from fwht by {err_lib} of the largest entry")
        ms_k = cuda_time_ms(lambda: kernels.fwht(x))
        ms_p = cuda_time_ms(lambda: kernels.fwht_plain(x), iters=3, reps=3)
        ms_lib = cuda_time_ms(lambda: torch.matmul(x, h_n))
        bound_ms, bound_by = bound(2 * m * n * 2)
        res[n] = (ms_k, ms_p, bound_ms, ms_lib, bound_by)
        print(f"kernel 6 fwht at [{m}, {n}] bf16: kernel {ms_k:.4f} ms "
              f"({2 * m * n * 2 / ms_k / 1e6:.1f} GB/s of read+write), plain {ms_p:.4f} ms, "
              f"matmul with H_{n} {ms_lib:.4f} ms ({2 * m * n * n / ms_lib / 1e9:.1f} TFLOP/s, "
              f"within {err_lib:.3g} of the kernel), bound {bound_ms:.4f} ms by {bound_by}",
              flush=True)
        del x, h_n
    ms_k, ms_p, bound_ms, ms_lib, bound_by = res[512]
    return {"name": "fwht", "route": "cuda", "source": "spectre_tpu_torch/csrc/fwht.cu",
            "replaces": "spectre_tpu/ops/pallas/fwht.py:71", "max_abs_err": worst, "ms": ms_k,
            "plain_ms": ms_p, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": ms_lib,
            **{f"{key}_n{n}": res[n][i] for n in (1024, 4096)
               for i, key in enumerate(("ms", "plain_ms", "bound_ms", "library_ms"))},
            "shape": "x [16640, 512] bf16"}


def phase_structured_kernels(kernels, structured_matrix):
    """Kernel 7 (forward and backward) against its plain versions at the
    flagship mix shape: bitwise equal."""
    d, heads, tile = 33_280, 16, 128
    n_tiles = d // tile
    gen = torch.Generator(device="cuda").manual_seed(7)

    def tables(h, t_count, width):
        tp = torch.stack([torch.randperm(t_count, generator=gen, device="cuda")
                          for _ in range(h)]).to(torch.int32)
        sg = (torch.randint(0, 2, (1, h, t_count * width), generator=gen, device="cuda") * 2
              - 1).float()
        return tp, sg

    cases = [(256, heads, n_tiles, tile), (250, heads, n_tiles, tile), (3, 2, 5, 16),
             (5, 3, 6, 4), (2, 2, 3, 1), (4, 2, 2, 256), (9, 2, 3, 8)]
    worst_f = worst_b = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for b, h, t_count, width in cases:
            tp, sg = tables(h, t_count, width)
            x = torch.randn(b, t_count * width, generator=gen, device="cuda").to(dtype)
            g = torch.randn(b, h * t_count * width, generator=gen, device="cuda").to(dtype)
            got, ref = kernels.structured_mix(x, tp, sg, 1), \
                kernels.structured_mix_plain(x, tp, sg, 1)
            got_b, ref_b = kernels.structured_mix_bwd(g, tp, sg), \
                kernels.structured_mix_bwd_plain(g, tp, sg)
            torch.cuda.synchronize()
            worst_f = max(worst_f, max_abs_diff(got, ref))
            worst_b = max(worst_b, max_abs_diff(got_b, ref_b))
            if not (torch.equal(got, ref) and torch.equal(got_b, ref_b)):
                raise AssertionError(
                    f"structured_mix != plain at B={b} H={h} T={t_count} t={width} {dtype}: "
                    f"forward {max_abs_diff(got, ref)}, backward {max_abs_diff(got_b, ref_b)}")
            del x, g, got, ref, got_b, ref_b
    print(f"kernel 7 structured_mix: forward and backward bitwise equal to plain at "
          f"(B, H, T, t) in {cases}, bf16 and f32 (max abs err forward {worst_f}, backward "
          f"{worst_b})", flush=True)
    tp, sg = tables(heads, n_tiles, tile)
    sgb, inv = sg.to(torch.bfloat16), kernels.invert_tile_perms(tp)
    x = torch.randn(256, d, generator=gen, device="cuda").to(torch.bfloat16)
    g = torch.randn(256, heads * d, generator=gen, device="cuda").to(torch.bfloat16)
    matrix = structured_matrix(x, tp, sgb, 1)
    err_matrix = rel_to_largest(kernels.structured_mix(x, tp, sgb, 1, inv), matrix)
    if not err_matrix <= 2.0 ** -6:  # the matrix form rounds the product, then the sign pass
        raise AssertionError(f"structured_mix differs from the matrix form by {err_matrix}")
    ms_f = cuda_time_ms(lambda: kernels.structured_mix(x, tp, sgb, 1, inv))
    ms_fp = cuda_time_ms(lambda: kernels.structured_mix_plain(x, tp, sgb, 1), iters=2, reps=3)
    ms_fm = cuda_time_ms(lambda: structured_matrix(x, tp, sgb, 1), iters=5)
    ms_b = cuda_time_ms(lambda: kernels.structured_mix_bwd(g, tp, sgb, inv))
    ms_bp = cuda_time_ms(lambda: kernels.structured_mix_bwd_plain(g, tp, sgb), iters=2, reps=3)
    moved = (heads * d * 256 + d * 256 + heads * d) * 2 + heads * n_tiles * 4
    bound_ms, bound_by = bound(moved)
    print(f"kernel 7 at d={d} H={heads} tile={tile} B=256 bf16: forward {ms_f:.4f} ms "
          f"({moved / ms_f / 1e6:.1f} GB/s), plain {ms_fp:.4f} ms, matrix form {ms_fm:.4f} ms "
          f"(kernel within {err_matrix:.3g} of its largest entry); backward {ms_b:.4f} ms, "
          f"plain {ms_bp:.4f} ms; bound {bound_ms:.4f} ms by {bound_by}", flush=True)
    return {"name": "structured_mix", "route": "cuda",
            "source": "spectre_tpu_torch/csrc/structured_mix.cu",
            "replaces": "spectre_tpu/ops/pallas/structured_mix.py:73",
            "max_abs_err": max(worst_f, worst_b), "backward_max_abs_err": worst_b, "ms": ms_f,
            "plain_ms": ms_fp, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "matrix_form_ms": ms_fm, "backward_ms": ms_b,
            "backward_plain_ms": ms_bp, "backward_bound_ms": bound_ms,
            "shape": f"x [256, {d}] bf16 -> [256, {heads * d}]"}


def _step_times(tag, cfg, kernels, batches=(256, 1024)):
    """ms per train step (the trainer's augmentation inside) and peak memory
    at each batch; at the first batch one step must launch exactly what the
    config implies and one step runs with every host sync an error."""
    from spectre_tpu_torch.ops import register_mix_routes
    from spectre_tpu_torch.train import make_train_step
    from spectre_tpu_torch.train.loop import create_trainer, default_augment

    state = create_trainer(cfg, "cuda", steps_per_epoch=16)
    if getattr(cfg, "mix_routed", False):
        register_mix_routes(state.model, cfg.mix_routed_impl)
    step = make_train_step(default_augment(cfg.dataset, cfg.in_channels),
                           grad_clip_norm=getattr(cfg, "grad_clip_norm", None))
    out = {}
    for i, batch in enumerate(batches):
        raw, y = _train_batch(cfg, batch)
        for _ in range(2):
            step(state, raw, y)
        torch.cuda.synchronize()
        if i == 0:
            kernels.reset_launch_counts()
            torch.cuda.set_sync_debug_mode("error")
            try:
                metrics = step(state, raw, y)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            counts, want = kernels.launch_counts(), expected_launches(cfg, steps=1)
            if counts != want or not torch.isfinite(metrics["loss"]):
                raise AssertionError(f"{tag}: one step launched {counts}, want {want}; loss "
                                     f"{metrics['loss'].item()}")
            print(f"{tag}: one train step ran under set_sync_debug_mode('error') with no host "
                  f"sync and launched {counts}", flush=True)
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_time_ms(lambda: step(state, raw, y), iters=1, reps=5)
        peak = torch.cuda.max_memory_allocated() / 1e9
        out[batch] = {"ms": ms, "img_per_s": batch / ms * 1e3, "peak_gb": peak}
        print(f"{tag}: B={batch} {ms:.2f} ms/step with the augmentation, "
              f"{batch / ms * 1e3:.0f} img/s, peak memory {peak:.2f} GB (CUDA events, median of "
              f"5 steps after warm-up)", flush=True)
        del raw, y
    del state
    torch.cuda.empty_cache()
    return out


def _forward_against_plain(tag, kernels, model, cfg):
    """A bucket-256 forward: exact launches, finite logits, the kernel path
    within MODEL_ATOL of the same module on the plain versions."""
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
        counts, want = kernels.launch_counts(), expected_launches(cfg, forwards=1)
        if counts != want:
            raise AssertionError(f"{tag}: one forward launched {counts}, want {want}")
        with plain_versions(kernels):
            ref = model(x)
            if any(kernels.launch_counts()[k] != want[k] for k in want):
                raise AssertionError(f"{tag}: the plain path launched a kernel")
        torch.cuda.synchronize()
    diff = (logits - ref).abs().max().item()
    ok = tuple(logits.shape) == (256, cfg.num_classes) and bool(torch.isfinite(logits).all())
    if not ok or not diff <= MODEL_ATOL:
        raise AssertionError(f"{tag}: logits shape {tuple(logits.shape)}, finite {ok}, kernel "
                             f"path vs plain path {diff} > {MODEL_ATOL}")
    print(f"{tag}: bucket-256 forward {fwd_ms:.2f} ms (host clock, synchronised), launches "
          f"{ {k: v for k, v in counts.items() if v} }, logits finite [256, {cfg.num_classes}], "
          f"max |kernel - plain| {diff:.4g} (limit {MODEL_ATOL})", flush=True)
    return fwd_ms


def _serve_check(tag, config, kernels, model, cfg, serve, client_cls, seed: int, ckpt=None):
    """The serving CLI on ``config`` (with ``--ckpt ckpt`` when given, and
    ``model`` then the model that checkpoint holds): requests of batch 1, 7
    and 64, each sent twice, replies within 1e-3 of direct forwards of the
    padded bucket; the launches during the serving run are exactly those of
    the batcher's forwards."""
    rng = np.random.default_rng(seed)
    shape = (cfg.in_channels, cfg.img_size, cfg.img_size)
    requests = [rng.uniform(0, 1, (b, *shape)).astype(np.float32) for b in (1, 7, 64)]
    kernels.reset_launch_counts()
    srv, port = serve.start(["--config", config, "--device", "cuda", "--port", "0",
                             *(["--ckpt", ckpt] if ckpt else [])])
    try:
        with client_cls(port=port) as c:
            replies = []
            for x in requests * 2:
                t0 = time.perf_counter()
                replies.append((x, c.infer(x)))
                print(f"{tag} serve: batch {x.shape[0]}: "
                      f"{(time.perf_counter() - t0) * 1e3:.2f} ms", flush=True)
    finally:
        srv.close()
    # one closed-loop client: every request is one bucket, one forward, and
    # the server runs no forward of its own
    serving, want = kernels.launch_counts(), expected_launches(cfg, forwards=srv.forwards)
    if srv.forwards != len(replies) or serving != want:
        raise AssertionError(f"{tag} serve ran {srv.forwards} forwards for {len(replies)} "
                             f"requests and launched {serving}, want {want}")
    for x, got in replies:
        b = x.shape[0]
        bucket = 1 << (b - 1).bit_length()
        xp = np.concatenate([x, np.zeros((bucket - b, *shape), x.dtype)])
        with torch.inference_mode():
            want = model(torch.from_numpy(xp).cuda())[:b].float().cpu().numpy()
        diff = float(np.abs(got - want).max())
        if got.shape != (b, cfg.num_classes) or not diff <= 1e-3:
            raise AssertionError(f"{tag} serve batch {b}: reply {got.shape} differs from a "
                                 f"direct forward by {diff}")
    print(f"{tag} serve: {len(replies)} replies match direct forwards (<= 1e-3); launches "
          f"{ {k: v for k, v in serving.items() if v} }", flush=True)
    return serving


def phase_vit(kernels, build_model, parse_config, serve, client_cls, train_cli, tmp: str):
    """The baseline attention ViT at full width through the server and the
    trainer; returns (launches of the uninterrupted trainer run, numbers)."""
    cfg = parse_config(VIT_CONFIG)
    model = build_model(cfg, "cuda")
    print(f"vit: vit_cifar100 built on cuda (E={cfg.embed_dim}, {cfg.num_heads} heads of "
          f"{cfg.embed_dim // cfg.num_heads}, FF {cfg.hidden_dim}, {cfg.num_encoders} layers, "
          f"{cfg.compute_dtype} compute, dropout {cfg.dropout})", flush=True)
    fwd_ms = _forward_against_plain("vit", kernels, model, cfg)

    serving = _serve_check("vit", VIT_CONFIG, kernels, model, cfg, serve, client_cls, seed=2)
    del model
    torch.cuda.empty_cache()

    val_batches = -(-1024 // cfg.val_batch_size)
    runs = {}
    for name, steps, resume, took in (("whole", 14, False, 14), ("first", 10, False, 10),
                                      ("resumed", 14, True, 4)):
        kernels.reset_launch_counts()
        result = train_cli.main([
            "--config", VIT_CONFIG, "--synthetic", "--steps", str(steps),
            *(["--resume"] if resume else []), "--set",
            f"checkpoint_dir={os.path.join(tmp, 'vit_whole' if name == 'whole' else 'vit_parts')}"])
        counts = kernels.launch_counts()
        want = expected_launches(cfg, forwards=val_batches, steps=took)
        if counts != want or result.state.step != steps:
            raise AssertionError(f"vit trainer run {name!r}: step {result.state.step}, "
                                 f"launched {counts}, want {want}")
        runs[name] = (result, counts)
        print(f"vit trainer {name}: to step {steps} ({took} steps with the augmentation, "
              f"{val_batches} validation batches, a checkpoint) launched "
              f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    whole, resumed = runs["whole"][0], runs["resumed"][0]
    # the interrupted epoch's mean train loss covers only the steps each call
    # ran, so it is the state and the validation pass that must agree
    bad = _same_state(whole.state, resumed.state)
    if bad or whole.last_val_accuracy != resumed.last_val_accuracy \
            or not np.isfinite(whole.train_losses[-1]):
        raise AssertionError(
            f"vit: resumed run differs from the uninterrupted one: {bad[:8]} ({len(bad)} in "
            f"all); val acc {whole.last_val_accuracy!r} vs {resumed.last_val_accuracy!r}")
    print(f"vit trainer: stopped at step 10 and resumed to step 14 == uninterrupted, bit for "
          f"bit ({len(whole.state.model.state_dict())} tensors, AdamW moments, generator); "
          f"train loss {whole.train_losses[-1]:.6f}, val acc {whole.last_val_accuracy:.4f}",
          flush=True)
    del runs["first"], resumed
    torch.cuda.empty_cache()
    # serve what the trainer saved: its one checkpoint, step 14, is the best
    restored = _serve_check("vit checkpoint", VIT_CONFIG, kernels, whole.state.model.eval(),
                            cfg, serve, client_cls, seed=3,
                            ckpt=os.path.join(whole.logdir, "ckpt"))
    times = _step_times("vit", cfg, kernels)
    return runs["whole"][1], serving, {
        "forward_ms_b256": fwd_ms, "train_step": {f"B={b}": v for b, v in times.items()},
        "checkpoint_serving_launches": {k: v for k, v in restored.items() if v}}


def phase_structured_model(kernels, build_model, parse_config, train_cli, perf_cli, tmp: str):
    """SpectreViT with mix_impl="structured" at full width: forward against
    the plain path, three train steps through the CLI, the perf entry points
    of the new kernels, and fwht through ops/hadamard.py."""
    from spectre_tpu_torch.ops import fwht, hadamard_transform

    cfg = parse_config(CONFIG)
    cfg.mix_impl = "structured"
    model = build_model(cfg, "cuda")
    fwd_ms = _forward_against_plain("structured", kernels, model, cfg)
    del model
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    result = train_cli.main(["--config", CONFIG, "--synthetic", "--steps", "3",
                             "--no-checkpoint", "--set", "mix_impl=structured", "epochs=1",
                             f"checkpoint_dir={os.path.join(tmp, 'structured')}"])
    counts = kernels.launch_counts()
    val_batches = -(-1024 // cfg.val_batch_size)
    want = expected_launches(cfg, forwards=val_batches, steps=3)
    if counts != want or result.state.step != 3 or not np.isfinite(result.train_losses[-1]):
        raise AssertionError(f"structured train CLI launched {counts}, want {want}; step "
                             f"{result.state.step}, loss {result.train_losses}")
    print(f"structured train CLI: 3 steps + {val_batches} validation batches launched "
          f"{ {k: v for k, v in counts.items() if v} } (of the fused-linear launches "
          f"{cfg.num_encoders * (3 + val_batches)} are the mix projection at K="
          f"{cfg.embed_dim * cfg.num_heads}); train loss {result.train_losses[-1]:.4f}",
          flush=True)
    del result
    torch.cuda.empty_cache()
    times = _step_times("structured", cfg, kernels, batches=(256,))

    kernels.reset_launch_counts()
    att = perf_cli.main(["attention", "--batch", "256", "--iters", "10"])["attention"]
    smix = perf_cli.main(["structured", "--batch", "256", "--iters", "10"])["structured"]
    x = torch.randn(65, 256, 512, device="cuda")
    got = fwht(x, axis=-1)
    moved = fwht(x.transpose(0, 2), axis=0)  # the same transform along a moved axis
    flat = hadamard_transform(x[0])
    torch.cuda.synchronize()
    if not (torch.equal(moved.transpose(0, 2), got) and torch.equal(flat, got[0])
            and torch.allclose(fwht(got), x, atol=1e-4)):
        raise AssertionError("ops.hadamard.fwht: axis handling or the inverse is wrong")
    entry = kernels.launch_counts()
    if min(entry["flash_attention_fwd"], entry["flash_attention_bwd"], entry["structured_mix"],
           entry["structured_mix_bwd"]) < 1 or entry["fwht"] != 4:
        raise AssertionError(f"perf attention / structured and ops.fwht launched {entry}")
    if not att["256"]["max_abs_diff"] <= 0.1 or smix["256"]["max_abs_diff"] != 0.0:
        raise AssertionError(f"perf entry points: attention differs from plain by "
                             f"{att['256']['max_abs_diff']}, structured by "
                             f"{smix['256']['max_abs_diff']}")
    print(f"perf attention, perf structured and ops.hadamard.fwht launched "
          f"{ {k: v for k, v in entry.items() if v} }", flush=True)
    return counts, entry, {"forward_ms_b256": fwd_ms,
                           "train_step": {f"B={b}": v for b, v in times.items()},
                           "perf_attention": att, "perf_structured": smix}


def phase_routed_kernel(kernels, routing, perf_cli):
    """Kernel B9 against its plain version (bitwise) and kernel 4, at the
    flagship mix shape with c=128 and c=8 and at SpectreBranch's; times at
    the flagship shape; ``repl/perf.py routed``."""
    gen = torch.Generator().manual_seed(9)
    dev_gen = torch.Generator(device="cuda").manual_seed(9)

    def case(h, d, c=None):
        perms = torch.stack([torch.randperm(d, generator=gen) for _ in range(h)])
        inv = torch.argsort(perms, dim=1).to(torch.int32)
        rt = routing.build_route_tables_cached(inv.numpy(), c)
        tables = [torch.from_numpy(t).cuda() for t in (rt.a_idx, rt.b_idx, rt.c_idx)]
        return perms, inv.cuda(), tables

    t0 = time.perf_counter()
    flagship = case(16, 33_280)
    build_s = time.perf_counter() - t0
    cases = [(flagship, b) for b in (256, 1024, 250)]
    cases += [(case(16, 33_280, 8), 64), (case(8, 49_920), 256)]
    worst, to_k4 = 0.0, 0.0
    for (_, inv, tables), b in cases:
        h, r, c = tables[0].shape
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.randn(h * r * c, b, generator=dev_gen, device="cuda").to(dtype)
            got = kernels.routed_gather_sum(g, *tables)
            ref = kernels.routed_gather_sum_plain(g, *tables)
            k4 = kernels.inverse_gather_sum(g, inv)
            torch.cuda.synchronize()
            worst = max(worst, max_abs_diff(got, ref))
            if not torch.equal(got, ref):
                raise AssertionError(f"routed_gather_sum != plain at H={h} r={r} c={c} B={b} "
                                     f"{dtype}: max abs err {max_abs_diff(got, ref)}")
            if dtype == torch.float32 and not torch.equal(got, k4):
                raise AssertionError(f"routed_gather_sum != inverse_gather_sum in f32 at H={h} "
                                     f"r={r} c={c} B={b}")
            if dtype == torch.bfloat16:
                to_k4 = max(to_k4, rel_to_largest(got, k4))
            del g, got, ref, k4
    shapes = [(t[0].shape[0], t[0].shape[1], t[0].shape[2], b) for (_, _, t), b in cases]
    print(f"kernel B9 routed_gather_sum: bitwise equal to plain at (H, r, c, B) in {shapes}, "
          f"bf16 and f32 (max abs err {worst}); f32 bitwise equal to kernel 4; bf16 head chain "
          f"vs kernel 4's one rounding: {to_k4:.4g} of the largest entry; flagship route "
          f"tables (16 heads) {build_s:.2f} s", flush=True)
    perms, inv, tables = flagship
    d, heads = 33_280, 16
    flat = perms.reshape(-1).cuda()
    res = {}
    for b in (256, 1024):
        g = torch.randn(heads * d, b, generator=dev_gen, device="cuda").to(torch.bfloat16)
        out = torch.zeros(d, b, dtype=torch.bfloat16, device="cuda")
        ms_k = cuda_time_ms(lambda: kernels.routed_gather_sum(g, *tables))
        ms_p = cuda_time_ms(lambda: kernels.routed_gather_sum_plain(g, *tables), iters=2, reps=3)
        ms_4 = cuda_time_ms(lambda: kernels.inverse_gather_sum(g, inv))
        ms_lib = cuda_time_ms(lambda: out.index_add_(0, flat, g), iters=5)
        moved = (heads * d * b + d * b) * 2 + 3 * heads * d * 4
        bound_ms, bound_by = bound(moved)
        res[b] = (ms_k, ms_p, ms_4, ms_lib, bound_ms, bound_by)
        print(f"kernel B9 at d={d} H={heads} c=128 B={b} bf16: kernel {ms_k:.4f} ms "
              f"({moved / ms_k / 1e6:.1f} GB/s, bound {bound_ms:.4f} ms by {bound_by}), plain "
              f"{ms_p:.4f} ms, kernel 4 {ms_4:.4f} ms, index_add_ {ms_lib:.4f} ms", flush=True)
        del g, out
    torch.cuda.empty_cache()
    perf = perf_cli.main(["routed", "--batch", "256", "--iters", "10"])["routed"]
    if perf["256"]["max_abs_diff"] != 0.0:
        raise AssertionError(f"perf routed: kernel and plain differ by "
                             f"{perf['256']['max_abs_diff']}")
    ms_k, ms_p, ms_4, ms_lib, bound_ms, bound_by = res[256]
    return {"name": "routed_gather_sum", "route": "cuda",
            "source": "spectre_tpu_torch/csrc/routed_gather_sum.cu",
            "replaces": "spectre_tpu/ops/pallas/routed_gather.py:127",
            "max_abs_err": worst, "ms": ms_k, "plain_ms": ms_p, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": ms_lib, "inverse_gather_sum_ms": ms_4,
            "ms_b1024": res[1024][0], "plain_ms_b1024": res[1024][1],
            "inverse_gather_sum_ms_b1024": res[1024][2], "library_ms_b1024": res[1024][3],
            "bound_ms_b1024": res[1024][4], "bf16_rel_to_inverse_gather_sum": to_k4,
            "route_tables_s": build_s, "perf_routed": perf,
            "shape": f"g[{heads * d},256] bf16, tables [16,260,128] -> [{d},256]"}


def phase_routed_trainer(kernels, parse_config, train_cli, bench_cli, tmp: str):
    """The flagship trainer with the Clos-routed backward through B9: route
    build seconds, the routed backward against kernel 3's, step times and the
    training CLI with exact launches."""
    import copy

    from spectre_tpu_torch.data import make_eval_transform
    from spectre_tpu_torch.ops import clear_mix_routes, register_mix_routes
    from spectre_tpu_torch.train.loop import create_trainer, dataset_stats

    cfg = parse_config(CONFIG)
    cfg.mix_routed, cfg.mix_routed_impl = True, "pallas"
    state = create_trainer(cfg, "cuda", steps_per_epoch=16)
    build_s = []
    for _ in range(2):  # cold, then from the cache
        clear_mix_routes(state.model)
        t0 = time.perf_counter()
        routed = register_mix_routes(state.model, "pallas")
        torch.cuda.synchronize()
        build_s.append(time.perf_counter() - t0)
        if routed != cfg.num_encoders:
            raise AssertionError(f"routed trainer: {routed} mixes routed, want {cfg.num_encoders}")
    print(f"routed trainer: route tables of {cfg.num_encoders} layers (16 heads, r=260, c=128) "
          f"derived in {build_s[0]:.2f} s cold, {build_s[1]:.3f} s from the cache", flush=True)

    normalize = make_eval_transform(*dataset_stats(cfg.dataset))
    raw, y = _train_batch(cfg, cfg.batch_size)
    x = normalize(raw)
    kernels.reset_launch_counts()
    loss_r, grads_r = _backward_once(state, x, y, seed=1)
    if kernels.launch_counts()["routed_gather_sum"] != cfg.num_encoders:
        raise AssertionError(f"routed trainer: one backward launched {kernels.launch_counts()}")
    clear_mix_routes(state.model)
    loss_b, grads_b = _backward_once(state, x, y, seed=1)
    # the config's default route impl, "mxu": one-hot products in cuBLAS
    register_mix_routes(state.model, "mxu")
    loss_m, grads_m = _backward_once(state, x, y, seed=1)
    clear_mix_routes(state.model)
    errs = {}
    for tag, grads in (("pallas", grads_r), ("mxu", grads_m)):
        errs[tag] = (0.0, "")
        for name, gb in grads_b.items():
            rel = ((grads[name] - gb).abs().max() / gb.abs().max()).item()
            if rel > errs[tag][0]:
                errs[tag] = (rel, name)
    if not (loss_r == loss_b == loss_m and max(e for e, _ in errs.values()) <= TRAIN_GRAD_REL):
        raise AssertionError(f"routed trainer: loss {loss_r}, {loss_m} vs {loss_b}, gradient "
                             f"rel err against kernel 3 {errs} > {TRAIN_GRAD_REL}")
    (worst, where), (worst_mxu, where_mxu) = errs["pallas"], errs["mxu"]
    del state, grads_r, grads_b, grads_m
    torch.cuda.empty_cache()
    cfg32 = copy.copy(cfg)
    cfg32.compute_dtype = "float32"
    state = create_trainer(cfg32, "cuda", steps_per_epoch=16)
    register_mix_routes(state.model, "pallas")
    _, grads_r = _backward_once(state, x, y, seed=1)
    clear_mix_routes(state.model)
    _, grads_b = _backward_once(state, x, y, seed=1)
    bad = [n for n in grads_b if not torch.equal(grads_r[n], grads_b[n])]
    if bad:
        raise AssertionError(f"routed trainer f32: gradients differ from kernel 3's at {bad}")
    print(f"routed trainer: one backward through B9 against kernel 3's: bf16 loss equal, worst "
          f"gradient rel err {worst:.4g} at {where} (limit {TRAIN_GRAD_REL}; the bf16 head "
          f"chain against one rounding); f32: all {len(grads_b)} gradients bit for bit; "
          f"through the 'mxu' route (one-hot products): {worst_mxu:.4g} at {where_mxu}",
          flush=True)
    del state, grads_r, grads_b
    torch.cuda.empty_cache()
    times = _step_times("routed", cfg, kernels)

    kernels.reset_launch_counts()
    result = train_cli.main(["--config", CONFIG, "--synthetic", "--steps", "4",
                             "--no-checkpoint", "--set", "epochs=1", "mix_routed=True",
                             "mix_routed_impl=pallas",
                             f"checkpoint_dir={os.path.join(tmp, 'routed')}"])
    counts = kernels.launch_counts()
    val_batches = -(-1024 // cfg.val_batch_size)
    want = expected_launches(cfg, forwards=val_batches, steps=4)
    if counts != want or result.state.step != 4 or not np.isfinite(result.train_losses[-1]):
        raise AssertionError(f"routed train CLI launched {counts}, want {want}; step "
                             f"{result.state.step}, loss {result.train_losses}")
    print(f"routed train CLI: 4 steps + {val_batches} validation batches launched "
          f"{ {k: v for k, v in counts.items() if v} }; train loss "
          f"{result.train_losses[-1]:.4f}", flush=True)
    del result
    torch.cuda.empty_cache()

    # the bench routes its step as the trainer does: B9 in every step
    kernels.reset_launch_counts()
    bench = bench_cli.main(["--batch", "256", "--set", "mix_routed=True",
                            "mix_routed_impl=pallas"])
    bench_counts = kernels.launch_counts()
    steps = bench_cli.WARMUP + bench_cli.REPS * (bench_cli.ITERS_SHORT + bench_cli.ITERS_LONG)
    if not (bench["mix_routed"] and bench["mix_routed_impl"] == "pallas"
            and bench_counts["routed_gather_sum"] == cfg.num_encoders * steps
            and bench_counts["block_gather_sum"] == 0):
        raise AssertionError(f"routed bench: line {bench}, launched {bench_counts} in {steps} "
                             "steps")
    print(f"routed bench: {steps} steps launched B9 {bench_counts['routed_gather_sum']} times, "
          f"kernel 3 none", flush=True)
    torch.cuda.empty_cache()
    return counts, {"route_build_cold_s": build_s[0], "route_build_cached_s": build_s[1],
                    "bench_b256": bench,
                    "grad_rel_err_bf16_vs_block_gather": worst,
                    "grad_rel_err_bf16_mxu_vs_block_gather": worst_mxu,
                    "train_step": {f"B={b}": v for b, v in times.items()}}


def phase_branch(kernels, build_model, parse_config, serve, client_cls, train_cli, bench_cli,
                 tmp: str):
    """SpectreBranch at full width: forward against the plain path, the
    server, the training CLI with exact launches, step times, the bench."""
    cfg = parse_config(BRANCH_CONFIG)
    t0 = time.perf_counter()
    model = build_model(cfg, "cuda")
    torch.cuda.synchronize()
    print(f"branch: spectre_branch built on cuda in {time.perf_counter() - t0:.2f} s "
          f"(E={cfg.embed_dim} H={cfg.num_heads} hidden {cfg.hidden_dim} {cfg.num_encoders} "
          f"layers, d={65 * cfg.embed_dim}, {cfg.mix_impl}, {cfg.compute_dtype} compute, "
          f"{sum(p.numel() for p in model.parameters()):,} parameters)", flush=True)
    fwd_ms = _forward_against_plain("branch", kernels, model, cfg)
    serving = _serve_check("branch", BRANCH_CONFIG, kernels, model, cfg, serve, client_cls,
                           seed=3)
    del model
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    result = train_cli.main(["--config", BRANCH_CONFIG, "--synthetic", "--steps", "4",
                             "--no-checkpoint", "--set", "epochs=1",
                             f"checkpoint_dir={os.path.join(tmp, 'branch')}"])
    counts = kernels.launch_counts()
    val_batches = -(-1024 // cfg.val_batch_size)
    want = expected_launches(cfg, forwards=val_batches, steps=4)
    if counts != want or result.state.step != 4 or not np.isfinite(result.train_losses[-1]):
        raise AssertionError(f"branch train CLI launched {counts}, want {want}; step "
                             f"{result.state.step}, loss {result.train_losses}")
    print(f"branch train CLI: 4 steps + {val_batches} validation batches launched "
          f"{ {k: v for k, v in counts.items() if v} }; train loss "
          f"{result.train_losses[-1]:.4f}", flush=True)
    del result
    torch.cuda.empty_cache()
    times = _step_times("branch", cfg, kernels)
    bench = bench_cli.main(["--config", BRANCH_CONFIG, "--batch", "1024"])
    return counts, serving, {"forward_ms_b256": fwd_ms,
                             "train_step": {f"B={b}": v for b, v in times.items()},
                             "bench": bench}


def phase_gather_tm(kernels, parse_config):
    """The flagship with ``mix_impl="gather_tm"``: steps with a finite loss
    and exact launches (kernel 2 only), ms per step."""
    cfg = parse_config(CONFIG)
    cfg.mix_impl = "gather_tm"
    return {f"B={b}": v for b, v in _step_times("gather_tm", cfg, kernels, (256,)).items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 2
    # the port, imported only once a card is known to be there
    from spectre_tpu_torch.configs import parse_config
    from spectre_tpu_torch.models import build_model
    from spectre_tpu_torch.ops import kernels
    from spectre_tpu_torch.ops import hadamard_matrix
    from spectre_tpu_torch.ops import routing
    from spectre_tpu_torch.ops import structured_mix as structured_matrix
    from spectre_tpu_torch.ops.kernels import build
    from spectre_tpu_torch.repl import bench as bench_cli
    from spectre_tpu_torch.repl import eval as eval_cli
    from spectre_tpu_torch.repl import perf as perf_cli
    from spectre_tpu_torch.repl import serve
    from spectre_tpu_torch.repl import train as train_cli
    from spectre_tpu_torch.serving import SpectreClient
    from spectre_tpu_torch.utils import card_and_power_limit

    for path in (CONFIG, VIT_CONFIG, BRANCH_CONFIG):
        if not os.path.exists(path):
            raise FileNotFoundError(path)
    name = torch.cuda.get_device_name(0)
    smi = card_and_power_limit()
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
    k5 = phase_kernel5(kernels)
    k3, k4 = phase_gather_kernels(kernels, gen)
    k8, k9 = phase_attention(kernels)
    k6 = phase_fwht(kernels, hadamard_matrix)
    k7 = phase_structured_kernels(kernels, structured_matrix)
    model, cfg = phase_model(kernels, build_model, parse_config)
    serving = phase_serve(kernels, serve, SpectreClient, model, cfg)
    del model
    torch.cuda.empty_cache()
    step_times = {blk: phase_train(kernels, parse_config, blk) for blk in (64, 0)}
    with tempfile.TemporaryDirectory(prefix="spectre_smoke_") as tmp:
        phase_train_cli(kernels, train_cli, parse_config, 64, tmp)
        uniform_run = phase_train_cli(kernels, train_cli, parse_config, 0, tmp)
        trainer_run, trainer = phase_trainer(kernels, train_cli, parse_config, tmp)
        trainer["sigterm_saved_at_step"] = phase_sigterm(eval_cli, parse_config, tmp)
        torch.cuda.empty_cache()
        vit_run, vit_serving, vit = phase_vit(kernels, build_model, parse_config, serve,
                                              SpectreClient, train_cli, tmp)
        structured_run, entry_run, structured = phase_structured_model(
            kernels, build_model, parse_config, train_cli, perf_cli, tmp)
    torch.cuda.empty_cache()
    fused_run, fused_bwd = phase_fused_bwd_cli(kernels, perf_cli)
    bench = bench_cli.main(["--batch", "1024"])
    # the routed trainer, SpectreBranch and gather_tm; route tables go to a
    # directory of this run, so that the first build is cold
    with tempfile.TemporaryDirectory(prefix="spectre_smoke_") as tmp:
        routing.ROUTE_CACHE_DIR = os.path.join(tmp, "routes")
        k10 = phase_routed_kernel(kernels, routing, perf_cli)
        routed_run, routed = phase_routed_trainer(kernels, parse_config, train_cli, bench_cli,
                                                  tmp)
        branch_run, branch_serving, branch = phase_branch(
            kernels, build_model, parse_config, serve, SpectreClient, train_cli, bench_cli, tmp)
        gather_tm = phase_gather_tm(kernels, parse_config)

    # launches: the whole trainer's uninterrupted run (20 steps, 4 validation
    # batches); kernel 4 from the mix_block=0 CLI run, kernel 5 from its own
    # entry point, repl/perf.py fused-bwd
    k1["launches"] = trainer_run["block_scatter_rows"]
    k2["launches"] = trainer_run["fused_spectre_linear"]
    k3["launches"] = trainer_run["block_gather_sum"]
    k4["launches"] = uniform_run["inverse_gather_sum"]
    k5["launches"] = fused_run["fused_block_bwd"]
    k1["launches_serving"] = serving["block_scatter_rows"]
    k2["launches_serving"] = serving["fused_spectre_linear"]
    # this slice's paths: kernels 8 and 9 from the ViT trainer's uninterrupted
    # run (14 steps, 2 validation batches), kernel 7 from the structured
    # trainer run (3 steps, 2 validation batches), kernel 6 from
    # ops/hadamard.py's entry points (no model calls it, as in the JAX package)
    k8["launches"] = vit_run["flash_attention_fwd"]
    k9["launches"] = vit_run["flash_attention_bwd"]
    k8["launches_serving"] = vit_serving["flash_attention_fwd"]
    k7["launches"] = structured_run["structured_mix"]
    k7["backward_launches"] = structured_run["structured_mix_bwd"]
    k2["launches_structured"] = structured_run["fused_spectre_linear"]
    k6["launches"] = entry_run["fwht"]
    # B9 from the routed trainer's CLI run (4 steps, 2 validation batches);
    # the branch's CLI run (the same) and serving run for kernels 1 and 4
    k10["launches"] = routed_run["routed_gather_sum"]
    k1["launches_branch"] = branch_run["block_scatter_rows"]
    k1["launches_branch_serving"] = branch_serving["block_scatter_rows"]
    k4["launches_branch"] = branch_run["inverse_gather_sum"]
    result = {"kernels": [k1, k2, k3, k4, k5, k8, k9, k6, k7, k10],
              "train_step": {f"mix_block={blk}": {f"B={b}": v for b, v in t.items()}
                             for blk, t in step_times.items()},
              "trainer": trainer, "fused_bwd": fused_bwd, "bench": bench, "vit": vit,
              "structured": structured, "routed": routed, "branch": branch,
              "gather_tm": {"train_step": gather_tm}}
    print(smi, flush=True)
    print(json.dumps(result), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
