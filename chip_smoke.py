"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each raising on failure (nothing is caught):

1. device: require CUDA; print the card's name and power limit; TF32 off.
2. build: compile every kernel in spectre_tpu_torch/csrc/ with nvcc.
3. kernel 1 (block_scatter_rows) vs its plain version at the flagship mix
   shape (d=33,280, H=16) with a block table (blk=64) and a uniform one
   (blk=1, as mix_block=0 trains), B in {1, 3, 64, 256, 1024}, bf16 and f32:
   bitwise equal. Median times at B=256 for both tables.
4. kernel 2's forward, both of its kernels on the path
   (fused_spectre_linear_wgmma: bf16 on wgmma + TMA;
   fused_spectre_linear_cluster: f32, and bf16 where TMA cannot describe the
   operands, as the head's N = 100, its blocks splitting a row tile across a
   thread-block cluster), vs the plain version
   at the path's three shapes for B=256 and B=1024, at the structured and
   gather mixes' projection (16,640 x 8,192)·(8,192 x 512), f32 (<= 1e-4: only
   the summation order differs) and bf16 (<= 2e-2: one bf16 ulp is 7.8e-3 near
   1 and 1.6e-2 in [2, 4); <= 4e-2 at K=8,192, whose pre-LN values reach
   [4, 8)), and at the serving buckets' rows 65 x {1, 2, 7, 64, 256} and the
   head's rows {1, 2, 7, 64} in bf16, for the output and for the saved
   pre-LN ``h``; the kernel each call takes
   (``forward_kernel``) and its launches; two runs bitwise equal; the autograd
   Function's five gradients vs autograd of the plain version (limits at
   GRAD_REL); at the path's bf16 shapes and every head bucket, times of the
   call with and without ``h``, on the device, of the plain version and of
   the cuBLAS chain ``gelu(layer_norm(addmm(b, x, w)))`` (back to back and on
   the device), and at the wgmma shapes of the cluster kernel (its result
   held to the same limit). Then kernel 2's backward
   (fused_spectre_linear_bwd: the LayerNorm/GELU chain kernel and the two
   products) vs its plain version at the path's shapes for B=256 and
   B=1024 and at K=8,192, f32 (<= 1e-5 of each gradient's largest entry)
   and bf16 (one bf16 ulp of it, <= 2^-7), two runs bitwise equal; times
   back to back and on the device beside autograd of the plain version.
5. kernel 5 (fused_block_bwd: bf16 with blk=64 on the wgmma kernel; bf16
   with blk 32 and 16 and f32 with blk 64 and 16 on the token-grouped
   kernel) vs its plain version at the flagship mix shape (d=33,280, H=16,
   O=512) for B in {256, 1024, 250}, bf16 (<= 1e-2 of the largest entry:
   one bf16 ulp of an entry is 2^-8 of it) and f32 (<= 1e-4 of the largest
   entry: FMAs in another order), and against the chain it fuses (the dg4
   product, the signs, block_gather_sum) within 4 times that; the kernel
   ``block_bwd_kernel`` names, launched exactly; two runs bitwise equal;
   times of the kernel back to back and on the device, the plain version
   and the chain beside the bound, at every route.
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
   fused-linear kernels (8 of them the wgmma kernel, the head's the
   cluster kernel), give a finite loss and a finite gradient for every
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
   each run (4 + 4 + 9 per step and 9 of kernel 2's backward, kernel 5
   none); the resumed run must end with the uninterrupted run's step, loss,
   validation accuracy, parameters, AdamW moments and generator state, bit
   for bit. These are the ``launches`` of kernels 1-3 and of kernel 2's
   backward in the result line. Checkpoint save and
   restore seconds and the file's size.
12. a training subprocess gets SIGTERM after its second epoch: it must save
   and exit 0, and repl/eval.py must restore that checkpoint.
13. ``repl/perf.py fused-bwd`` (kernel 5's entry point: chain against kernel at
   B=256 and B=1024, with the flagship's blk=64 on the wgmma kernel and with
   blk=32 and 16 on the token-grouped kernel; its launch counts are the two
   kernels' ``launches``) and the ``repl/bench.py`` line (flagship step with
   augmentation at B=1024).
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
   [16,640, 1024], [4,160, 4,096], [520, 32,768], [4,160, 2,048], [1,040,
   16,384] and small ragged shapes, bf16 and f32, normalised and not:
   bitwise equal (the same float32 pairs added in the same order). Times at
   the first three, back to back and on the device, beside ``x @ H_n`` both
   ways; the block route (n > 1,024) at [4,160, 2,048], [4,160, 4,096],
   [1,040, 16,384] and [520, 32,768] bf16 and [4,160, 4,096] f32 beside its
   bound.
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

20. kernel 2 above N = 1,024 (C6: fused_spectre_linear_wide_cluster, bf16
   that TMA can describe; fused_spectre_linear_cluster, float32 and bf16 at
   N = 1,100; fused_spectre_linear_bwd_wide, the backward's chain) at
   (4,160 x 1,536)(1,536 x 1,536), K == N, and (4,160 x 768)(768 x 2,048)
   and (768 x 1,100), bf16 and f32: out and h against the plain version,
   the Function's gradients and the backward against theirs, under the
   limits of phases 4 and the backward's; two runs bitwise; the kernel
   ``forward_kernel`` names, launched exactly; times back to back and on
   the device beside the bound, the plain version and the cuBLAS chain,
   and the wide chain alone on the device beside its byte bound. Then the
   backward alone, both dtypes, at N = 4,096, N = 16,384 (beyond the wide
   chain's registers: the row walked) and 4,163 rows (a ragged last block),
   under the same checks and with the same times. Then, forward only in
   bf16, the wide cluster kernel at N = 4,096 (a cluster of 16 blocks) and
   the cluster kernel beyond its reach at N = 4,608. It runs after kernel
   2's backward, among the kernel phases.
21. distillation (configs/distill_cifar100.py: the flagship student at
   B=256, the ViT-S/16 teacher at 224 px with 201 tokens, seeded): both
   teacher views against float64 (VIEW_ATOL); the bf16 teacher against the
   f32 teacher (TEACHER_LOGIT_ATOL, TEACHER_TOKEN_ATOL); one step with the
   cached logits launches exactly 4 + 4 + 9 (8 wgmma) and 9 backwards and
   no teacher, every gradient finite; the loop with the cache and with
   recompute, 3 steps bit for bit; ``repl/distill.py`` through one epoch
   (16 steps, validation, checkpoint) and ``--resume`` to step 20 against
   one run to step 20, bit for bit, with exact launches; 2 steps with
   ``mix_routed=True mix_routed_impl=pallas`` (B9 on every layer, the route
   tables of phase 19's cache); step times with the cache and with
   recompute, the teacher's time, the cache pass and peak memory. It runs
   after phase 19.

22. deployment (after phase 8, on phase 7's flagship): a reference-layout
   state_dict of that model (``models/torch_import.py::reference_state_dict``,
   on the host as ``torch.load`` gives one) imported into a model of another
   seed must equal its source bit for bit; ``torch.export`` of it at batch
   64 in bf16, saved as ``.pt2`` and loaded in this process: the program
   holds 4 block-scatter and 9 fused-linear nodes, one call launches exactly
   4 block-scatter, 8 wgmma and 1 cluster kernels (``launches_export``),
   its logits are within EXPORT_ATOL of the live model and MODEL_ATOL of
   the plain path; export, save and load seconds, the file's size, and the
   program's forward beside the live model's (CUDA events). ``.stw`` at full
   width: written, read into a model of another seed, the logits bit for
   bit. ``repl/export.py`` (flagship, batch 2) and ``repl/infer.py
   --expect`` in fresh processes, exit 0, the runner without model code.
   The ViT and the structured mix (2 layers) exported: their programs
   launch B4's forward and B6 (``launches_export_vit``,
   ``launches_export_structured``) and match their live models within
   EXPORT_ATOL.
23. the serving pipeline: the serving CLI's server with 8 concurrent
   clients, 16 requests of batch 32 each: img/s, p50 and p99 per request,
   every reply within 1e-3 of a direct forward of its request (alone, or
   padded to a bucket the batcher could have coalesced it into), exact
   launches; then an A/B under a load generator in its own processes
   (8, then 16 clients, each in a process of its own, requests of batch 32
   back to back for AB_SECONDS) on the shipped server, on one that answers
   each bucket as it dispatches it (the batcher without the pipeline) and
   on one that dispatches without waiting for the pending bucket (the
   pipeline without coalescing), in turns (shipped, unpipelined, no-wait,
   no-wait, unpipelined, shipped): img/s, p50/p99 and images a bucket.
24. profile: ``profile.trace_step`` around 3 flagship train steps at B=256
   and ``ProfilerParser(...).remove_idle().add_percentages().sort_by_device()``:
   the table's device total within 5% of ``key_averages()``'s for the same
   trace (the annotations Kineto draws over the device's timeline left out
   of both), the kernels of B1, B2 and B3 (forward and backward chain) under
   their CUDA names with calls equal to the wrappers' launches over the
   traced window, which are exact; the 15 largest rows printed.
25. ``repl/perf.py latency``, ``linear``, ``mixer`` and ``encoder`` through
   its ``main`` at the JAX package's defaults (B=8, E=512, heads 4, 10 + 100
   calls, d up to 2^13, the gather mix): exact launches of each (latency
   8 x 110 x 13 of kernel 2's cluster kernel; linear 5 x 110 of it; mixer
   8 x 110 of kernel 7; encoder 6); one shape per mode against the plain
   versions (latency's logits within MODEL_ATOL, the encoder layer and
   kernel 2 at dims 256, 1,024, 2,048 and 4,096 within 1e-4 in float32,
   kernel 7 at d = 4,096 bit for bit); the cluster kernel's times at 8
   rows from dim 1,024 beside its bound, its plain version and the cuBLAS
   chain; the head's shape, kernel and cuBLAS chain on the device.
26. tools: ``repl/mnist_submission.py::write_submission`` on the card (3
   steps of the MNIST config, the validation pass and the submission split;
   exact launches; a row per image; logits within MODEL_ATOL of the plain
   path); ``deterministic_mode`` (a [4,096 x 4,096] float32 product within
   1e-5 of the largest entry of float64 where TF32 is not, and TF32 back
   after ``False``); ``enable_nan_checks`` naming the layer a NaN was fed
   to; ``model_summary`` of the flagship at full width, its FLOPs within 2%
   of ``repl/bench.py``'s count.

27. parallel (``spectre_tpu_torch/parallel/``), the flagship at full width as
   the config ships it (bf16, B=256): ``repl/train.py --multihost`` under
   torchrun on one rank (NCCL) with DDP and with ``--set fsdp=True``, 8
   steps and the validation pass, against the unwrapped CLI: exact
   launches of B1, B2, B3's forward (8 wgmma and the head a step) and
   backward; the per-step losses DDP's bit for bit, FSDP's bit for bit at
   step 1 and within FSDP_CURVE_REL after. Then 2 torchrun ranks on the one
   card over gloo (card tensors), DDP and FSDP at 128 rows a rank: exact
   launches, the audit's signature of each, the loss after 3 steps within
   GLOO_LOSS_REL of one process at batch 256. Then, at one rank in this
   process: ms per step of the unwrapped step, DDP and FSDP at B=256 and
   B=1,024 in turns, the step's peak memory and the collectives of a step.
   The torchrun ranks run this script (``--rank-train``, ``--rank-gloo``),
   which calls the CLI's ``main`` and writes the launches.

28. tensor parallelism (slice 16). Kernel B3's four column-shard entries
   (``fused_spectre_linear_shard_stats``, ``sharded_ln_gelu``,
   ``chain_shard_sums``, ``chain_shard_dh``; after phase 20) against their
   plain versions at the flagship's shard widths (384 and 192 columns of
   768) and linear3's whole rows (512), M = 16,640 and 66,560, bf16 and
   float32, two runs bit for bit, with times beside the plain versions and
   the byte bound; at M = 16,640 also ragged shards (25 and 50 columns of
   100) and shards cut into tiles (1,536 of 3,072), where entries 2, 3 and
   4 (``shard_ln_plan``, ``shard_chain_plan``) mask lanes or cut the row
   into tiles, and entry 2 on a whole row of 1,536 (three warps a row),
   each rank's merged statistics bit for bit the others'; in bf16 entry 1's
   kernel (``shard_stats_wgmma_kernel``, ``shard_stats_plan``) also at its
   widest shard (768 columns of 1,536, timed) and at M = 16,575 (a row
   tile of 128 cut short), entry 1's times beside ``torch.addmm``; the shards
   merged through the entries against the whole-row kernel (1e-5 of the
   largest entry in float32, one bf16 ulp of it in bf16). Then (after
   phase 27), every rank on the one card over gloo on card tensors: (a)
   ``repl/train.py --multihost --backend gloo --set model_parallel=2`` under torchrun, the flagship 1 x 2 at full width,
   TP_STEPS steps and the validation pass, exact launches a rank and the
   per-step losses within GLOO_LOSS_REL of phase 27's unwrapped CLI; (b)
   one float32 forward and backward against one process (loss within
   TP_F32_LOSS_REL, the split leaves' gradients gathered within
   TP_F32_GRAD_REL of their largest entries), the audit's TP signature, a
   traced bf16 step; (c) the ViT 1 x 2 against one process; (d) FSDP x TP
   2 x 2 on 4 ranks at TP_FSDP_LAYERS layers through the CLI against FSDP
   alone on the same 2 data ranks. (b) and (c) run ``--rank-tp``.

Prints the card line, one JSON line of per-kernel results, then
``{"ok": true, "device": {...}}`` as the last line. Exits non-zero, with no
result, when CUDA is missing or the port is not beside this script.
"""

from __future__ import annotations

import contextlib
import faulthandler
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from types import SimpleNamespace
from unittest import mock

import numpy as np
import torch

from spectre_tpu_torch.utils.timing import BF16_FLOPS, FP32_FLOPS, bound_ms as bound, \
    cuda_time_ms, device_time_ms, queued_time_ms

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
PLAIN_PATCHES = (
    ("spectre_tpu_torch.ops.fused_mix.block_scatter_rows", "block_scatter_rows_plain"),
    ("spectre_tpu_torch.ops.fused_mix.block_gather_sum", "block_gather_sum_plain"),
    ("spectre_tpu_torch.ops.fused_mix.inverse_gather_sum", "inverse_gather_sum_plain"),
    ("spectre_tpu_torch.ops.fused_mix.routed_gather_sum", "routed_gather_sum_plain"),
    ("spectre_tpu_torch.ops.fused_mix.fused_block_bwd", "fused_block_bwd_plain"),
    ("spectre_tpu_torch.ops.linear.fused_spectre_linear", "fused_spectre_linear_plain"),
    ("spectre_tpu_torch.ops.kernels.fused_linear.fused_spectre_linear",
     "fused_spectre_linear_plain"),
    ("spectre_tpu_torch.ops.kernels.fused_linear.fused_spectre_linear_bwd",
     "fused_spectre_linear_bwd_plain"),
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


# the serving path's buckets: a bucket of b images is 65 b rows of kernel 2
SERVING_BUCKETS = (1, 2, 7, 64, 256)


def phase_kernel2(kernels, gen):
    """Kernel 2's forward, both kernels of the path, against the plain
    version: the path's three shapes at B=256 and B=1024 and the mix
    projection at K=8,192 in bf16 and f32, and the serving buckets' rows in
    bf16 (the ragged edge), the head's among them. bf16 with N and K
    multiples of 8 must take the wgmma kernel, the head's N = 100 and every
    float32 call the cluster kernel; each must repeat itself bit for bit.
    Times of both kernels, the plain version and the cuBLAS chain at the
    path's bf16 shapes and at every head bucket."""
    import torch.nn.functional as F

    wgmma, cluster = kernels.fused_spectre_linear_wgmma, kernels.fused_spectre_linear_cluster
    path = [(rows, k, n) for b in (256, 1024)
            for rows, k, n in ((65 * b, 512, 768), (65 * b, 768, 512), (b, 512, 100))]
    path.append((65 * 256, 8192, 512))  # the mix projection under "gather" and "structured"
    serving = [(65 * b, k, n) for b in SERVING_BUCKETS for k, n in ((512, 768), (768, 512))
               if (65 * b, k, n) not in path]
    serving += [(b, 512, 100) for b in SERVING_BUCKETS if (b, 512, 100) not in path]
    limits = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    worst, worst_grad, times = {}, {}, {}
    for m, k, n in path + serving:
        on_path = (m, k, n) in path
        x = torch.randn(m, k, generator=gen)
        w = torch.empty(k, n).uniform_(-k ** -0.5, k ** -0.5, generator=gen)
        bias = torch.empty(n).uniform_(-k ** -0.5, k ** -0.5, generator=gen)
        gamma = 1.0 + 0.1 * torch.randn(n, generator=gen)
        beta = 0.1 * torch.randn(n, generator=gen)
        ct = torch.randn(m, n, generator=gen) if on_path else None
        for dtype, limit in limits.items():
            if not on_path and dtype == torch.float32:
                continue  # the server runs bf16
            if k > 1024 and dtype == torch.bfloat16:
                limit = 4e-2  # pre-LN values reach [4, 8): one bf16 ulp there is 3.1e-2
            route = kernels.forward_kernel(dtype, k, n)
            # every shape here but the head's N = 100 takes the wgmma kernel in bf16
            want_route = (wgmma.__name__ if dtype == torch.bfloat16 and n != 100
                          else cluster.__name__)
            if route != want_route:
                raise AssertionError(f"kernel 2 ({m}x{k})x({k}x{n}) {dtype} routed to {route}")
            args = [t.to("cuda", dtype) for t in (x, w, bias, gamma, beta)]
            n0 = kernels.launch_counts()[route]
            got = kernels.fused_spectre_linear(*args)
            got2, h = kernels.fused_spectre_linear(*args, save_h=True)
            got3, h3 = kernels.fused_spectre_linear(*args, save_h=True)
            ref, ref_h = kernels.fused_spectre_linear_plain(*args, save_h=True)
            torch.cuda.synchronize()
            if kernels.launch_counts()[route] != n0 + 3:
                raise AssertionError(f"kernel 2: three calls did not launch {route} three times")
            if not torch.equal(got, got2):
                raise AssertionError(f"{route}: writing h changed the output")
            if not (torch.equal(got2, got3) and torch.equal(h, h3)):
                raise AssertionError(f"{route} ({m}x{k})x({k}x{n}): two runs differ")
            err = max((got.float() - ref.float()).abs().max().item(),
                      (h.float() - ref_h.float()).abs().max().item())
            worst[route, dtype] = max(worst.get((route, dtype), 0.0), err)
            if not err <= limit:
                raise AssertionError(f"{route} ({m}x{k})x({k}x{n}) {dtype}: max abs err of out "
                                     f"and h {err} > {limit}")
            line = (f"kernel 2 {route} ({m}x{k})x({k}x{n}) {str(dtype)[6:]}: max abs err "
                    f"{err:.3g} (out and h, limit {limit}), two runs bitwise equal")
            if on_path:
                gerr = _grad_errors(kernels, args, ct.to("cuda", dtype))
                worst_grad[dtype] = max(worst_grad.get(dtype, 0.0), gerr)
                if not gerr <= GRAD_REL[dtype]:
                    raise AssertionError(f"fused_spectre_linear_grad ({m}x{k})x({k}x{n}) "
                                         f"{dtype}: gradient rel err {gerr} > {GRAD_REL[dtype]}")
                line += f", grads rel {gerr:.3g}"
            if dtype == torch.bfloat16 and (on_path or n == 100):
                it = 5 if k > 1024 else 20

                def chain():  # the cuBLAS chain for the same function, a yardstick the
                    # port never calls: addmm writes h, then LayerNorm and GELU (no
                    # K == N residual at these shapes)
                    return F.gelu(F.layer_norm(torch.addmm(args[2], args[0], args[1]), (n,),
                                               args[3], args[4]))

                t = {"ms": cuda_time_ms(lambda: kernels.fused_spectre_linear(*args, save_h=True),
                                        iters=it),
                     "ms_without_h": cuda_time_ms(lambda: kernels.fused_spectre_linear(*args),
                                                  iters=it),
                     "device_ms": device_time_ms(
                         lambda: kernels.fused_spectre_linear(*args, save_h=True), iters=5),
                     "plain_ms": cuda_time_ms(lambda: kernels.fused_spectre_linear_plain(*args),
                                              iters=it),
                     "library_ms": cuda_time_ms(chain, iters=it),
                     "library_device_ms": device_time_ms(chain, iters=5)}
                el = 2
                io = (m * k + k * n + 3 * n + 2 * m * n) * el  # x, W, b/gamma/beta, out, h
                t["bound_ms"], t["bound_by"] = bound(io, 2 * m * k * n)
                t["route"] = route
                times[m, k, n] = t
                line += (f"; {route} {t['ms']:.4f} ms with h (device {t['device_ms']:.4f}, "
                         f"{2 * m * k * n / t['device_ms'] / 1e9:.1f} TFLOP/s), "
                         f"{t['ms_without_h']:.4f} without; cuBLAS chain {t['library_ms']:.4f} "
                         f"(device {t['library_device_ms']:.4f}); plain {t['plain_ms']:.4f}; "
                         f"bound {t['bound_ms']:.4f} by {t['bound_by']}")
                if route == wgmma.__name__:
                    # the cluster kernel at the same shape, its bf16 result of its timed
                    # calls held at the same limit
                    out, hb = torch.empty_like(got), torch.empty_like(got)
                    t["cluster_ms"] = cuda_time_ms(lambda: cluster(*args, out, hb, 1e-5),
                                                   iters=it)
                    werr = max((out.float() - ref.float()).abs().max().item(),
                               (hb.float() - ref_h.float()).abs().max().item())
                    key = (cluster.__name__, dtype)
                    worst[key] = max(worst.get(key, 0.0), werr)
                    if not werr <= limit:
                        raise AssertionError(f"{cluster.__name__} ({m}x{k})x({k}x{n}) {dtype}: "
                                             f"max abs err of out and h {werr} > {limit}")
                    line += (f"; the cluster kernel {t['cluster_ms']:.4f} (max abs err "
                             f"{werr:.3g})")
            print(line, flush=True)
        del x, w, ct
        torch.cuda.empty_cache()

    def row(name, shape, extra):
        t = times[shape]
        m, k, n = shape
        if t["route"] != name:
            raise AssertionError(f"kernel 2: {shape} ran {t['route']}, not {name}")
        return {"name": name, "route": "cuda",
                "source": "spectre_tpu_torch/csrc/fused_spectre_linear.cu",
                "replaces": "spectre_tpu/ops/pallas/fused_linear.py:94",
                "max_abs_err": worst[name, torch.bfloat16], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"], "device_ms": t["device_ms"],
                "library_device_ms": t["library_device_ms"], "ms_without_h": t["ms_without_h"],
                "shape": f"({m}x{k})x({k}x{n}) bf16, writing h", **extra}

    main, wide = (65 * 256, 512, 768), (65 * 256, 8192, 512)
    keys = ("ms", "device_ms", "cluster_ms", "library_ms", "library_device_ms", "bound_ms")
    others = {f"{m}x{k}x{n}": {key: t[key] for key in keys if key in t}
              for (m, k, n), t in times.items() if (m, k, n) != main}
    new = row(wgmma.__name__, main, {
        "cluster_ms": times[main]["cluster_ms"],
        "times": {key: v for key, v in others.items() if not key.endswith("x100")},
        "grad_rel_err": worst_grad[torch.bfloat16],
        "grad_rel_err_f32": worst_grad[torch.float32]})
    head = row(cluster.__name__, (256, 512, 100), {
        "max_abs_err_f32": worst[cluster.__name__, torch.float32],
        "times": {key: v for key, v in others.items() if key.endswith("x100")}})
    print(f"kernel 2 forward at ({main[0]}x{main[1]})x({main[1]}x{main[2]}) bf16 with h: "
          f"wgmma {new['ms']:.4f} ms (device {new['device_ms']:.4f}), the cluster kernel "
          f"{new['cluster_ms']:.4f}, cuBLAS chain {new['library_ms']:.4f}, bound "
          f"{new['bound_ms']:.4f} by {new['bound_by']}; K=8,192: wgmma "
          f"{times[wide]['ms']:.4f}, the cluster kernel {times[wide]['cluster_ms']:.4f}; the "
          f"head at B=256 on the cluster kernel {head['ms']:.4f} (device {head['device_ms']:.4f}"
          f"), cuBLAS chain {head['library_ms']:.4f} (device {head['library_device_ms']:.4f})",
          flush=True)
    return new, head


# kernel 2's backward (the chain kernel and the two products) against its
# plain version, each gradient as a share of its largest entry. f32: the
# chain's row and column sums in another order. bf16: dh and the column sums
# are rounded once on both paths, so single entries differ by one bf16 ulp
# (2^-8 to 2^-7 of the largest entry).
LINEAR_BWD_REL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


def phase_linear_bwd(kernels, gen):
    """Kernel 2's backward, ``fused_spectre_linear_bwd``, at the path's
    shapes (B=256 and B=1024, and the structured mix's K=8,192) in bf16 and
    f32: against its plain version, and twice bitwise. Times at each bf16
    shape, back to back and on the device, beside autograd of the plain
    version and the same backward through the autograd Function."""
    shapes = [(65 * 256, 512, 768), (65 * 256, 768, 512), (256, 512, 100),
              (65 * 1024, 512, 768), (65 * 256, 8192, 512)]
    worst, worst_abs, res = {}, {}, {}
    for m, k, n in shapes:
        x = torch.randn(m, k, generator=gen)
        w = torch.empty(k, n).uniform_(-k ** -0.5, k ** -0.5, generator=gen)
        bias = torch.empty(n).uniform_(-k ** -0.5, k ** -0.5, generator=gen)
        gamma = 1.0 + 0.1 * torch.randn(n, generator=gen)
        beta = 0.1 * torch.randn(n, generator=gen)
        ct = torch.randn(m, n, generator=gen)
        for dtype, rel in LINEAR_BWD_REL.items():
            xd, wd, bd, gd, bed, cd = (t.to("cuda", dtype) for t in (x, w, bias, gamma, beta, ct))
            h = kernels.fused_spectre_linear(xd, wd, bd, gd, bed, save_h=True)[1]
            args = (xd, wd, gd, bed, h, cd)
            got = kernels.fused_spectre_linear_bwd(*args)
            again = kernels.fused_spectre_linear_bwd(*args)
            want = kernels.fused_spectre_linear_bwd_plain(*args)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"fused_spectre_linear_bwd ({m}x{k})x({k}x{n}) {dtype}: "
                                     f"two runs differ")
            err = max(rel_to_largest(a, b) for a, b in zip(got, want))
            worst[dtype] = max(worst.get(dtype, 0.0), err)
            worst_abs[dtype] = max([worst_abs.get(dtype, 0.0)] +
                                   [max_abs_diff(a, b) for a, b in zip(got, want)])
            if not err <= rel:
                raise AssertionError(f"fused_spectre_linear_bwd ({m}x{k})x({k}x{n}) {dtype}: "
                                     f"rel err {err} > {rel}")
            if dtype != torch.bfloat16:
                continue
            it = 5 if k > 1024 else 20
            req = [t.detach().clone().requires_grad_() for t in (xd, wd, bd, gd, bed)]
            out_k = kernels.fused_spectre_linear_grad(*req)
            out_p = kernels.fused_spectre_linear_plain(*req)
            t = {"ms": cuda_time_ms(lambda: kernels.fused_spectre_linear_bwd(*args), iters=it),
                 "device_ms": device_time_ms(lambda: kernels.fused_spectre_linear_bwd(*args),
                                             iters=it),
                 "plain_ms": cuda_time_ms(lambda: torch.autograd.grad(
                     out_p, req, cd, retain_graph=True), iters=5),
                 "autograd_ms": cuda_time_ms(lambda: torch.autograd.grad(
                     out_k, req, cd, retain_graph=True), iters=it)}
            # two products of 2 M K N; x, h, g, W, gamma, beta read and dx, dW
            # and the three [N] gradients written once
            t["bound_ms"], t["bound_by"] = bound((2 * m * k + 2 * m * n + 2 * k * n + 5 * n) * 2,
                                                 4 * m * k * n)
            res[m, k, n] = t
            print(f"kernel 2 backward ({m}x{k})x({k}x{n}) bf16: {t['ms']:.4f} ms back to back, "
                  f"{t['device_ms']:.4f} on the device, through autograd {t['autograd_ms']:.4f}; "
                  f"autograd of plain {t['plain_ms']:.4f}; bound {t['bound_ms']:.4f} ms by "
                  f"{t['bound_by']}; rel err {err:.3g}", flush=True)
            del req, out_k, out_p
        del x, w, ct, xd, wd, cd, h, got, again, want
        torch.cuda.empty_cache()
    main = res[65 * 256, 512, 768]
    extra = {f"{key}_{tag}": res[shape][key] for tag, shape in
             (("b1024", (65 * 1024, 512, 768)), ("k8192", (65 * 256, 8192, 512)),
              ("768x512", (65 * 256, 768, 512)), ("head", (256, 512, 100)))
             for key in ("ms", "device_ms", "plain_ms", "bound_ms")}
    print(f"kernel 2 backward: bf16 rel err {worst[torch.bfloat16]:.3g}, f32 "
          f"{worst[torch.float32]:.3g}; two runs bitwise equal at every shape", flush=True)
    return {"name": "fused_spectre_linear_bwd", "route": "cuda",
            "source": "spectre_tpu_torch/csrc/fused_spectre_linear_bwd.cu",
            "replaces": "spectre_tpu/ops/pallas/fused_linear.py:147",
            "max_abs_err": worst_abs[torch.bfloat16], "max_rel_err": worst[torch.bfloat16],
            "max_rel_err_f32": worst[torch.float32],
            "ms": main["ms"], "device_ms": main["device_ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "library_ms": None,
            "autograd_ms": main["autograd_ms"], **extra,
            "shape": "(16640x512)x(512x768) bf16: the chain kernel and both products; "
                     "max_rel_err: relative to each gradient's largest entry"}


# kernel 5 against its plain version, as a share of the result's largest
# entry. bf16: both add exact products in float32 and round once, so single
# entries differ by one bf16 ulp (2^-8 of the entry). f32: plain FMAs (no
# TF32) in another order than the plain version's float32 product.
FUSED_BWD_REL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def phase_kernel5(kernels):
    """Kernel 5 at the flagship mix backward's shape: dy [65, B, 512],
    w [8,192, 512], s4 [65, 8,192], binv [16, 33,280 / blk] -> dxt [33,280, B].
    bf16 with blk 64 takes the wgmma kernel, as the train step calls it: with
    the pool residual's cotangent dpool (a transposed [B, N, O] view) and
    grp = 16; bf16 with blk 32 and 16 and f32 with blk 64 and 16 the
    token-grouped kernel, without it. Each route launches the kernel
    ``block_bwd_kernel`` names, exactly, two runs bitwise equal, and is held
    to the plain version on the same inputs and to the chain it fuses; the
    pool term alone (dy = 0) equals the plain version's bit for bit. Times of
    the kernel (back to back and on the device), the plain version and the
    chain beside the bound. Returns the entries of both kernels."""
    d, heads, n_tok, o = 33_280, 16, 65, 512
    eh = heads * d // n_tok
    grp = eh // o
    gen = torch.Generator(device="cuda").manual_seed(5)
    routes = {(torch.bfloat16, 64): "fused_block_bwd_wgmma",
              (torch.float32, 64): "fused_block_bwd_grouped",
              (torch.bfloat16, 32): "fused_block_bwd_grouped",
              (torch.bfloat16, 16): "fused_block_bwd_grouped",
              (torch.float32, 16): "fused_block_bwd_grouped"}
    res = {}
    for (dtype, blk), want_route in routes.items():
        binv = torch.stack([torch.randperm(d // blk, generator=gen, device="cuda")
                            for _ in range(heads)]).to(torch.int32)
        w = torch.randn(eh, o, generator=gen, device="cuda").to(dtype)
        s4 = (torch.randint(0, 2, (n_tok, eh), generator=gen, device="cuda") * 2 - 1).to(dtype)
        bf = dtype == torch.bfloat16
        route = kernels.block_bwd_kernel(dtype, blk)
        if route != want_route:
            raise AssertionError(f"kernel 5 {dtype} blk={blk} routed to {route}")
        pool = route == "fused_block_bwd_wgmma"
        for b in (256, 1024, 250):
            dy = torch.randn(n_tok, b, o, generator=gen, device="cuda").to(dtype)
            # the pool's cotangent as the train step hands it over
            dpool = torch.randn(b, n_tok, o, generator=gen, device="cuda").to(dtype).transpose(
                0, 1) if pool else None
            extra = (dpool, grp) if pool else ()

            def chain():
                dg4 = torch.bmm(w.expand(n_tok, -1, -1), dy.transpose(1, 2))
                if pool:  # e = u * grp + v takes dpool[n, b, u] / grp
                    dg4.view(n_tok, o, grp, b).add_(dpool.transpose(1, 2)[:, :, None, :],
                                                    alpha=1 / grp)
                dg4.mul_(s4[:, :, None])
                return kernels.block_gather_sum(dg4.view(heads * d, b), binv, blk)

            def kernel(g=dy):
                return kernels.fused_block_bwd(g, w, s4, binv, blk, *extra)

            n0 = kernels.launch_counts()
            got, again = kernel(), kernel()
            torch.cuda.synchronize()
            n1 = kernels.launch_counts()
            if {k: n1[k] - n0[k] for k in n1 if n1[k] != n0[k]} != {route: 2, "fused_block_bwd": 2}:
                raise AssertionError(f"kernel 5: two calls did not launch {route} twice")
            if not torch.equal(got, again):
                raise AssertionError(f"{route} blk={blk} B={b}: two runs differ")
            want = kernels.fused_block_bwd_plain(dy, w, s4, binv, blk, *extra)
            scale = want.float().abs().max().item()
            err, err_chain = max_abs_diff(got, want), max_abs_diff(got, chain())
            limit = FUSED_BWD_REL[dtype] * scale
            # the chain rounds dg4 to the data type per head before it adds
            if tuple(got.shape) != (d, b) or not err <= limit or not err_chain <= 4 * limit:
                raise AssertionError(f"{route} blk={blk} B={b} {dtype}: max abs err {err} > "
                                     f"{limit} ({FUSED_BWD_REL[dtype]} of {scale}) or "
                                     f"{err_chain} from the chain")
            if pool:  # the pool term alone: exact float32 terms in head order, one rounding
                zero = torch.zeros_like(dy)
                pool_only, want_pool = kernel(zero), kernels.fused_block_bwd_plain(
                    zero, w, s4, binv, blk, *extra)
                if not torch.equal(pool_only, want_pool) or not pool_only.abs().max() > 0:
                    raise AssertionError(f"{route} blk={blk} B={b}: the pool term alone differs "
                                         f"from the plain version's by "
                                         f"{max_abs_diff(pool_only, want_pool)}")
                del zero, pool_only, want_pool
            ms_k = cuda_time_ms(kernel, iters=20 if bf else 3)
            ms_p = cuda_time_ms(lambda: kernels.fused_block_bwd_plain(dy, w, s4, binv, blk,
                                                                      *extra),
                                iters=2, reps=3)
            ms_c = cuda_time_ms(chain, iters=20 if bf else 3)
            dev = device_time_ms(kernel, iters=5 if bf else 2)
            flops = 2 * d * heads * o * b
            moved = (n_tok * b * o * (1 + pool) + eh * o + n_tok * eh + d * b) \
                * dy.element_size() + binv.numel() * 4
            bound_ms, by = bound(moved, flops, BF16_FLOPS if bf else FP32_FLOPS)
            r = dict(err=err, scale=scale, err_chain=err_chain, ms=ms_k, plain=ms_p, chain=ms_c,
                     device=dev, bound=bound_ms, by=by)
            print(f"kernel 5 {route} blk={blk} B={b} {str(dtype)[6:]}"
                  f"{f' with the pool term (grp {grp})' if pool else ''}: max abs err {err:.4g} "
                  f"({err / scale:.3g} of the largest entry {scale:.1f}, limit "
                  f"{FUSED_BWD_REL[dtype]}), to the chain {err_chain:.4g}, two runs bitwise "
                  f"equal{', the pool term alone bitwise equal' if pool else ''}; kernel "
                  f"{ms_k:.4f} ms (device {dev:.4f}, {flops / dev / 1e9:.1f} TFLOP/s), chain "
                  f"{ms_c:.4f} ms, plain {ms_p:.4f} ms; bound {bound_ms:.4f} ms by {by}",
                  flush=True)
            res[dtype, blk, b] = r
            del dy, dpool, got, again, want
            torch.cuda.empty_cache()

    def entry(name, key, others):
        r = res[key]
        return {"name": name, "route": "cuda", "source": "spectre_tpu_torch/csrc/fused_block_bwd.cu",
                "replaces": "spectre_tpu/ops/pallas/bwd_gather.py:426",
                "max_abs_err": max(res[k]["err"] for k in others), "ms": r["ms"],
                "plain_ms": r["plain"], "bound_ms": r["bound"], "bound_by": r["by"],
                "library_ms": None, "chain_ms": r["chain"], "device_ms": r["device"],
                "max_rel_err": max(res[k]["err"] / res[k]["scale"] for k in others),
                "max_abs_err_to_chain": max(res[k]["err_chain"] for k in others),
                "times": {f"{str(dt)[6:]}_blk{blk}_b{b}": {
                    key: v[src] for key, src in (("ms", "ms"), ("device_ms", "device"),
                                                 ("chain_ms", "chain"), ("plain_ms", "plain"),
                                                 ("bound_ms", "bound"), ("bound_by", "by"))}
                    for (dt, blk, b), v in res.items() if (dt, blk, b) in others}}

    bf, f32 = torch.bfloat16, torch.float32
    wgmma = [k for k in res if routes[k[:2]] == "fused_block_bwd_wgmma"]
    grouped = [k for k in res if routes[k[:2]] == "fused_block_bwd_grouped"]
    k5 = entry("fused_block_bwd_wgmma", (bf, 64, 256), wgmma)
    k5["shape"] = (f"dy[{n_tok},256,{o}] w[{eh},{o}] dpool[{n_tok},256,{o}] (a transposed view) "
                   f"bf16, blk 64, grp {grp} -> [{d},256]")
    k5g = entry("fused_block_bwd_grouped", (bf, 32, 256), grouped)
    k5g["shape"] = f"dy[{n_tok},256,{o}] w[{eh},{o}] bf16, blk 32 -> [{d},256]"
    return k5, k5g


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
                "fused_spectre_linear", "fused_spectre_linear_bwd", "fused_block_bwd",
                "flash_attention_fwd", "flash_attention_bwd", "fwht", "structured_mix",
                "structured_mix_bwd", "routed_gather_sum", "fused_spectre_linear_wgmma",
                "fused_spectre_linear_cluster", "fused_block_bwd_wgmma",
                "fused_block_bwd_grouped", "fused_spectre_linear_wide_cluster",
                "fused_spectre_linear_bwd_wide", "fused_spectre_linear_shard_stats",
                "sharded_ln_gelu", "chain_shard_sums", "chain_shard_dh",
                "fused_spectre_linear_shard_stats_wgmma")


def expected_launches(cfg, forwards: int = 0, steps: int = 0) -> dict[str, int]:
    """Launches of ``forwards`` inference forwards plus ``steps`` train steps
    (forward and backward) of the configured model."""
    layers, both = cfg.num_encoders, forwards + steps
    counts = dict.fromkeys(KERNEL_NAMES, 0)
    if cfg.model == "vit":  # Dense layers, no SpectreLinear
        counts.update(flash_attention_fwd=layers * both, flash_attention_bwd=layers * steps)
        return counts
    # linear1 and linear3 of each layer and the head, as (K, N); the branch's
    # are Denses
    shapes = [] if cfg.model == "spectre_branch" else (
        [(cfg.embed_dim, cfg.hidden_dim), (cfg.hidden_dim, cfg.embed_dim)] * layers
        + [(cfg.embed_dim, cfg.num_classes)])
    if cfg.method == "attention":
        counts.update(flash_attention_fwd=layers * both, flash_attention_bwd=layers * steps)
    elif cfg.method == "permut_mix" and cfg.mix_impl == "folded":
        # the routed backward takes precedence over the block tables
        routed = bool(getattr(cfg, "mix_routed", False))
        block = bool(getattr(cfg, "mix_block", 0)) and not routed
        # the mix projection takes in = E*H to O = E; where
        # fuses_mix_backward holds, the backward is one launch of kernel 5
        # with the pool term
        from spectre_tpu_torch.ops import fuses_mix_backward

        e_in, o = cfg.embed_dim * cfg.num_heads, cfg.embed_dim
        fused = block and fuses_mix_backward(getattr(torch, cfg.compute_dtype), cfg.mix_block,
                                             cfg.num_heads, e_in // o if e_in % o == 0 else 0,
                                             o, routed)
        counts.update(block_scatter_rows=layers * both,
                      block_gather_sum=layers * steps * (block and not fused),
                      fused_block_bwd=layers * steps * fused,
                      fused_block_bwd_wgmma=layers * steps * fused,
                      inverse_gather_sum=layers * steps * (not block and not routed),
                      routed_gather_sum=layers * steps * routed)
    elif cfg.method == "permut_mix" and cfg.mix_impl != "gather_tm":
        # the mix projection is a SpectreLinear at K = E*H
        shapes += [(cfg.embed_dim * cfg.num_heads, cfg.embed_dim)] * layers
        if cfg.mix_impl == "structured":
            counts.update(structured_mix=layers * both, structured_mix_bwd=layers * steps)
    counts["fused_spectre_linear"] = len(shapes) * both
    counts["fused_spectre_linear_bwd"] = len(shapes) * steps
    from spectre_tpu_torch.ops.kernels import forward_kernel

    dtype = getattr(torch, cfg.compute_dtype)
    for k, n in shapes:  # each forward on the kernel that kernel 2's dispatch picks
        counts[forward_kernel(dtype, k, n)] += both
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
    # 8 of the step's 9 forwards of kernel 2 on the wgmma kernel, the head's
    # N = 100 on the cluster kernel
    if (counts["fused_spectre_linear_wgmma"], counts["fused_spectre_linear_cluster"]) != (8, 1):
        raise AssertionError(f"{tag}: kernel 2's forwards split {counts}, want 8 wgmma, 1 head")
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
    """Kernel 5's entry point, as a user starts it: the flagship's blk=64
    (the wgmma kernel), then blk=32 and 16 (the token-grouped kernel)."""
    launches, out = {}, {}
    for blk, route in ((64, "fused_block_bwd_wgmma"), (32, "fused_block_bwd_grouped"),
                       (16, "fused_block_bwd_grouped")):
        kernels.reset_launch_counts()
        res = perf_cli.main(["fused-bwd", "--batch", "256", "1024", "--iters", "10",
                             "--blk", str(blk)])
        counts = kernels.launch_counts()
        if (counts["fused_block_bwd"] < 1 or counts["block_gather_sum"] < 1
                or counts[route] != counts["fused_block_bwd"]):
            raise AssertionError(f"perf fused-bwd --blk {blk} launched {counts}")
        for b, r in res["fused_bwd"].items():
            for name, q in (("kernel", r), ("pool", r.get("pool"))):
                if q is not None and not (q["max_abs_diff"]
                                          <= 4 * FUSED_BWD_REL[torch.bfloat16] * q["largest_entry"]):
                    raise AssertionError(f"perf fused-bwd blk={blk} B={b} ({name}): chain and "
                                         f"kernel differ by {q['max_abs_diff']} of "
                                         f"{q['largest_entry']}")
            if (blk == 64) != ("pool" in r):
                raise AssertionError(f"perf fused-bwd blk={blk} B={b}: the pool comparison "
                                     f"{'missing' if blk == 64 else 'where it does not apply'}")
        print(f"perf fused-bwd --blk {blk} launched {counts}", flush=True)
        launches[route] = launches.get(route, 0) + counts[route]
        out[f"blk{blk}"] = res["fused_bwd"]
    return launches, out


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
    pairs added in the same order; times beside x @ H_n and the bound, and
    the block route (n > 1,024) beside its bound."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    shapes = ((16_640, 512), (16_640, 1024), (4160, 4096), (520, 32_768), (7, 8), (5, 4), (3, 1),
              (33, 256), (9, 64), (65, 2048), (4160, 2048), (1040, 16_384), (33, 8192))
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
        # back to back from the host, as every kernel's "ms"; "device": the
        # calls queued ahead of the card, its own time
        t = {"ms": cuda_time_ms(lambda: kernels.fwht(x)),
             "device_ms": device_time_ms(lambda: kernels.fwht(x)),
             "plain_ms": cuda_time_ms(lambda: kernels.fwht_plain(x), iters=3, reps=3),
             "library_ms": cuda_time_ms(lambda: torch.matmul(x, h_n)),
             "library_device_ms": device_time_ms(lambda: torch.matmul(x, h_n))}
        t["bound_ms"], t["bound_by"] = bound(2 * m * n * 2)
        res[n] = t
        print(f"kernel 6 fwht at [{m}, {n}] bf16: kernel {t['ms']:.4f} ms back to back, "
              f"{t['device_ms']:.4f} on the device ({2 * m * n * 2 / t['device_ms'] / 1e6:.1f} "
              f"GB/s of read+write), plain {t['plain_ms']:.4f} ms, matmul with H_{n} "
              f"{t['library_ms']:.4f} / {t['library_device_ms']:.4f} ms "
              f"({2 * m * n * n / t['library_device_ms'] / 1e9:.1f} TFLOP/s, within "
              f"{err_lib:.3g} of the kernel), bound {t['bound_ms']:.4f} ms by {t['bound_by']}",
              flush=True)
        del x, h_n
    # n > 1,024, the block route, beside its bound (x read and written once)
    wide = {}
    for dtype, m, n in ((torch.bfloat16, 4160, 2048), (torch.bfloat16, 4160, 4096),
                        (torch.bfloat16, 1040, 16_384), (torch.bfloat16, 520, 32_768),
                        (torch.float32, 4160, 4096)):
        x = torch.randn(m, n, generator=gen, device="cuda").to(dtype)
        t = {"ms": cuda_time_ms(lambda: kernels.fwht(x)),
             "device_ms": device_time_ms(lambda: kernels.fwht(x))}
        t["bound_ms"] = bound(2 * m * n * x.element_size())[0]
        wide[f"{m}x{n}_{str(dtype)[6:]}"] = t
        print(f"kernel 6 fwht at [{m}, {n}] {str(dtype)[6:]}: {t['ms']:.4f} ms back to back, "
              f"{t['device_ms']:.4f} on the device, bound {t['bound_ms']:.4f} ms by bytes "
              f"({t['bound_ms'] / t['device_ms']:.0%} of it)", flush=True)
        del x
    return {"name": "fwht", "route": "cuda", "source": "spectre_tpu_torch/csrc/fwht.cu",
            "replaces": "spectre_tpu/ops/pallas/fwht.py:71", "max_abs_err": worst, **res[512],
            **{f"{key}_n{n}": res[n][key] for n in (1024, 4096)
               for key in ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms",
                           "library_device_ms")},
            "times_block_route": wide, "shape": "x [16640, 512] bf16"}


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


# kernel 2 above N = 1,024 (C6): K == N (the identity residual inside the
# kernel) and the pool's K != N, in bf16 and f32, and N = 1,100 (not a
# multiple of 8: bf16 on the WMMA product); rows of a B=64 batch
C6_SHAPES = ((4160, 1536, 1536), (4160, 768, 2048), (4160, 768, 1100))
# the wide cluster kernel at its reach (a cluster of 16 blocks) and the
# cluster kernel beyond it: bf16, forward only
C6_REACH_SHAPES = ((1040, 512, 4096), (1040, 512, 4608))
# the wide chain of the backward alone, both dtypes: N = 4,096 (two vectors
# a thread), 16,384 (beyond the registers' reach: the row walked), and a
# last block of rows shorter than the others (4,163 rows)
C6_BWD_SHAPES = ((4160, 768, 4096), (1040, 512, 16384), (4163, 256, 1536))


def _chain_times(kernels, h, g, gamma, beta) -> dict:
    """The wide chain with its column-sum pass alone on the device, and its
    byte bound: h and g read and dh written once; and with the blocks'
    float32 partial rows written and read once."""
    fl = kernels.fused_linear
    m, n = h.shape
    dev = h.get_device()
    plan = fl.wide_chain_plan(h.dtype, m, n, 16, fl._sm_count(dev),
                              lambda *a: fl._wide_occupancy(dev, h.dtype, *a))
    el = h.element_size()
    return {"chain_device_ms": device_time_ms(lambda: fl.backward_chain(h, g, gamma, beta),
                                              iters=10),
            "chain_bound_ms": bound((3 * m * n + 5 * n) * el)[0],
            "chain_bound_partial_ms": bound((3 * m * n + 5 * n) * el + 2 * plan.blocks * 3 * n * 4)[0],
            "chain_plan": plan._asdict()}


def phase_c6(kernels, gen):
    """Kernel 2 above N = 1,024 (the wide cluster kernel for bf16 that TMA
    can describe, the cluster kernel for float32 and N = 1,100) against the
    plain versions under the limits of the one-pass kernels' phases: out and
    h, the Function's gradients, and the backward with its wide chain; two
    runs bitwise; the kernel each call takes, launched exactly; times back
    to back and on the device beside the bound, the plain version and the
    cuBLAS chain, and the wide chain alone on the device beside its byte
    bound. Then the backward alone at C6_BWD_SHAPES (N = 4,096, N = 16,384
    beyond the wide chain's registers, a ragged last block of rows) under
    the same checks. Then, forward only, the wide cluster kernel at its reach
    (N = 4,096, a cluster of 16 blocks) and the cluster kernel beyond it.
    Returns the entries of the wide cluster kernel and the wide chain, and
    the cluster kernel's numbers here (for its entry of phase 4)."""
    import torch.nn.functional as F

    limits = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    worst, worst_bwd, worst_bwd_abs, times = {}, {}, {}, {}
    start = kernels.launch_counts()
    bwd_wide = kernels.fused_spectre_linear_bwd_wide
    for m, k, n in C6_SHAPES:
        x = torch.randn(m, k, generator=gen)
        w = torch.empty(k, n).uniform_(-k ** -0.5, k ** -0.5, generator=gen)
        bias = torch.empty(n).uniform_(-k ** -0.5, k ** -0.5, generator=gen)
        gamma = 1.0 + 0.1 * torch.randn(n, generator=gen)
        beta = 0.1 * torch.randn(n, generator=gen)
        ct = torch.randn(m, n, generator=gen)
        for dtype, limit in limits.items():
            if k > 1024 and dtype == torch.bfloat16:
                limit = 4e-2  # phase_kernel2's rule: pre-LN values and the residual reach [4, 8)
            route = kernels.forward_kernel(dtype, k, n)
            want_route = ("fused_spectre_linear_wide_cluster"
                          if dtype == torch.bfloat16 and n % 8 == 0
                          else "fused_spectre_linear_cluster")
            if route != want_route:
                raise AssertionError(f"C6 ({m}x{k})x({k}x{n}) {dtype} routed to {route}")
            args = [t.to("cuda", dtype) for t in (x, w, bias, gamma, beta)]
            cd = ct.to("cuda", dtype)
            n0 = kernels.launch_counts()
            got = kernels.fused_spectre_linear(*args)
            got2, h = kernels.fused_spectre_linear(*args, save_h=True)
            got3, h3 = kernels.fused_spectre_linear(*args, save_h=True)
            ref, ref_h = kernels.fused_spectre_linear_plain(*args, save_h=True)
            torch.cuda.synchronize()
            n1 = kernels.launch_counts()
            if {c: n1[c] - n0[c] for c in n1 if n1[c] != n0[c]} != {
                    route: 3, "fused_spectre_linear": 3}:
                raise AssertionError(f"C6: three calls did not launch {route} three times")
            if not (torch.equal(got, got2) and torch.equal(got2, got3) and torch.equal(h, h3)):
                raise AssertionError(f"C6 {route} ({m}x{k})x({k}x{n}) {dtype}: two runs differ")
            err = max(max_abs_diff(got, ref), max_abs_diff(h, ref_h))
            worst[route, dtype] = max(worst.get((route, dtype), 0.0), err)
            if not err <= limit:
                raise AssertionError(f"C6 {route} ({m}x{k})x({k}x{n}) {dtype}: max abs err of "
                                     f"out and h {err} > {limit}")
            gerr = _grad_errors(kernels, args, cd)
            if not gerr <= GRAD_REL[dtype]:
                raise AssertionError(f"C6 ({m}x{k})x({k}x{n}) {dtype}: Function gradient rel "
                                     f"err {gerr} > {GRAD_REL[dtype]}")
            bargs = (args[0], args[1], args[3], args[4], h, cd)
            b0 = bwd_wide.launches
            gb = kernels.fused_spectre_linear_bwd(*bargs)
            gb2 = kernels.fused_spectre_linear_bwd(*bargs)
            want_b = kernels.fused_spectre_linear_bwd_plain(*bargs)
            torch.cuda.synchronize()
            if bwd_wide.launches != b0 + 2:
                raise AssertionError("C6: two backwards did not launch the wide chain twice")
            if not all(torch.equal(a, b) for a, b in zip(gb, gb2)):
                raise AssertionError(f"C6 backward ({m}x{k})x({k}x{n}) {dtype}: two runs differ")
            berr = max(rel_to_largest(a, b) for a, b in zip(gb, want_b))
            worst_bwd[dtype] = max(worst_bwd.get(dtype, 0.0), berr)
            worst_bwd_abs[dtype] = max([worst_bwd_abs.get(dtype, 0.0)] +
                                       [max_abs_diff(a, b) for a, b in zip(gb, want_b)])
            if not berr <= LINEAR_BWD_REL[dtype]:
                raise AssertionError(f"C6 backward ({m}x{k})x({k}x{n}) {dtype}: rel err {berr} "
                                     f"> {LINEAR_BWD_REL[dtype]}")
            el = args[0].element_size()
            peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
            residual = (lambda y: y + args[0]) if k == n else (lambda y: y)
            t = {"ms": cuda_time_ms(lambda: kernels.fused_spectre_linear(*args, save_h=True),
                                    iters=10),
                 "device_ms": device_time_ms(
                     lambda: kernels.fused_spectre_linear(*args, save_h=True), iters=5),
                 "plain_ms": cuda_time_ms(lambda: kernels.fused_spectre_linear_plain(*args),
                                          iters=5),
                 # the cuBLAS chain for the same function, a yardstick the port never calls
                 "library_ms": cuda_time_ms(lambda: residual(F.gelu(F.layer_norm(
                     torch.addmm(args[2], args[0], args[1]), (n,), args[3], args[4]))),
                     iters=10),
                 "library_device_ms": device_time_ms(lambda: residual(F.gelu(F.layer_norm(
                     torch.addmm(args[2], args[0], args[1]), (n,), args[3], args[4]))),
                     iters=5),
                 "bwd_ms": cuda_time_ms(lambda: kernels.fused_spectre_linear_bwd(*bargs),
                                        iters=10),
                 "bwd_device_ms": device_time_ms(
                     lambda: kernels.fused_spectre_linear_bwd(*bargs), iters=5)}
            req = [a.detach().clone().requires_grad_() for a in args]
            out_p = kernels.fused_spectre_linear_plain(*req)
            t["bwd_plain_ms"] = cuda_time_ms(lambda: torch.autograd.grad(
                out_p, req, cd, retain_graph=True), iters=3)
            del req, out_p
            t.update(_chain_times(kernels, h, cd, args[3], args[4]))
            t["bound_ms"], t["bound_by"] = bound((m * k + k * n + 3 * n + 2 * m * n) * el,
                                                 2 * m * k * n, peak)
            t["bwd_bound_ms"], t["bwd_bound_by"] = bound(
                (2 * m * k + 2 * m * n + 2 * k * n + 5 * n) * el, 4 * m * k * n, peak)
            t.update(route=route, err=err, grad_rel_err=gerr, bwd_rel_err=berr)
            times[m, k, n, dtype] = t
            print(f"C6 {route} ({m}x{k})x({k}x{n}) {str(dtype)[6:]}: max abs err {err:.3g} "
                  f"(out and h, limit {limit}), Function grads rel {gerr:.3g}, backward rel "
                  f"{berr:.3g} (wide chain), two runs bitwise; forward {t['ms']:.4f} ms with h "
                  f"(device {t['device_ms']:.4f}), cuBLAS chain {t['library_ms']:.4f} (device "
                  f"{t['library_device_ms']:.4f}), plain "
                  f"{t['plain_ms']:.4f}, bound {t['bound_ms']:.4f} by {t['bound_by']}; backward "
                  f"{t['bwd_ms']:.4f} (device {t['bwd_device_ms']:.4f}), autograd of plain "
                  f"{t['bwd_plain_ms']:.4f}, bound {t['bwd_bound_ms']:.4f} by "
                  f"{t['bwd_bound_by']}; the wide chain alone on the device "
                  f"{t['chain_device_ms']:.4f}, bound {t['chain_bound_ms']:.4f} by bytes "
                  f"({t['chain_bound_partial_ms']:.4f} with the partial rows)", flush=True)
            del args, cd, got, got2, got3, h, h3, ref, ref_h, gb, gb2, want_b
        del x, w, ct
        torch.cuda.empty_cache()

    # the backward alone: the wide chain at N = 4,096, beyond its registers'
    # reach and with a ragged last block of rows, against the plain version
    for m, k, n in C6_BWD_SHAPES:
        g2 = torch.Generator().manual_seed(m + n)
        x = torch.randn(m, k, generator=g2)
        w = torch.empty(k, n).uniform_(-k ** -0.5, k ** -0.5, generator=g2)
        bias = 0.1 * torch.randn(n, generator=g2)
        gamma = 1.0 + 0.1 * torch.randn(n, generator=g2)
        beta = 0.1 * torch.randn(n, generator=g2)
        ct = torch.randn(m, n, generator=g2)
        for dtype in limits:
            bargs = [a.to("cuda", dtype) for a in (x, w, gamma, beta, x @ w + bias, ct)]
            b0 = bwd_wide.launches
            gb = kernels.fused_spectre_linear_bwd(*bargs)
            gb2 = kernels.fused_spectre_linear_bwd(*bargs)
            want_b = kernels.fused_spectre_linear_bwd_plain(*bargs)
            torch.cuda.synchronize()
            if bwd_wide.launches != b0 + 2:
                raise AssertionError("C6: two backwards did not launch the wide chain twice")
            if not all(torch.equal(a, b) for a, b in zip(gb, gb2)):
                raise AssertionError(f"C6 backward ({m}x{k})x({k}x{n}) {dtype}: two runs differ")
            berr = max(rel_to_largest(a, b) for a, b in zip(gb, want_b))
            worst_bwd[dtype] = max(worst_bwd.get(dtype, 0.0), berr)
            worst_bwd_abs[dtype] = max([worst_bwd_abs.get(dtype, 0.0)] +
                                       [max_abs_diff(a, b) for a, b in zip(gb, want_b)])
            if not berr <= LINEAR_BWD_REL[dtype]:
                raise AssertionError(f"C6 backward ({m}x{k})x({k}x{n}) {dtype}: rel err {berr} "
                                     f"> {LINEAR_BWD_REL[dtype]}")
            el = bargs[0].element_size()
            peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
            t = {"route": "backward only",
                 "bwd_ms": cuda_time_ms(lambda: kernels.fused_spectre_linear_bwd(*bargs), iters=10),
                 "bwd_device_ms": device_time_ms(
                     lambda: kernels.fused_spectre_linear_bwd(*bargs), iters=5),
                 "bwd_plain_ms": cuda_time_ms(
                     lambda: kernels.fused_spectre_linear_bwd_plain(*bargs), iters=3),
                 "bwd_rel_err": berr}
            t["bwd_bound_ms"], t["bwd_bound_by"] = bound(
                (2 * m * k + 2 * m * n + 2 * k * n + 5 * n) * el, 4 * m * k * n, peak)
            t.update(_chain_times(kernels, *bargs[4:], bargs[2], bargs[3]))
            times[m, k, n, dtype] = t
            print(f"C6 backward ({m}x{k})x({k}x{n}) {str(dtype)[6:]}: rel err {berr:.3g}, two runs "
                  f"bitwise, the wide chain launched once a backward ({t['chain_plan']}); backward "
                  f"{t['bwd_ms']:.4f} ms (device {t['bwd_device_ms']:.4f}), plain "
                  f"{t['bwd_plain_ms']:.4f}, bound {t['bwd_bound_ms']:.4f} by {t['bwd_bound_by']}; "
                  f"the wide chain alone on the device {t['chain_device_ms']:.4f}, bound "
                  f"{t['chain_bound_ms']:.4f} by bytes ({t['chain_bound_partial_ms']:.4f} with the "
                  f"partial rows)", flush=True)
            del bargs, gb, gb2, want_b
        del x, w, ct
        torch.cuda.empty_cache()

    # forward only: the wide cluster kernel at its reach and the cluster
    # kernel beyond it, bf16
    reach = kernels.fused_linear.wide_cluster_reach(torch.cuda.current_device())
    if reach != 4096:
        raise AssertionError(f"C6: the wide cluster kernel reaches N = {reach} on this card, "
                             "not 4,096 (a non-portable cluster of 16)")
    for m, k, n in C6_REACH_SHAPES:
        x = torch.randn(m, k, generator=gen)
        w = torch.empty(k, n).uniform_(-k ** -0.5, k ** -0.5, generator=gen)
        args = [t.to("cuda", torch.bfloat16) for t in (
            x, w, torch.empty(n).uniform_(-k ** -0.5, k ** -0.5, generator=gen),
            1.0 + 0.1 * torch.randn(n, generator=gen), 0.1 * torch.randn(n, generator=gen))]
        route = kernels.forward_kernel(torch.bfloat16, k, n)
        want_route = ("fused_spectre_linear_wide_cluster" if n <= reach
                      else "fused_spectre_linear_cluster")
        if route != want_route:
            raise AssertionError(f"C6 ({m}x{k})x({k}x{n}) bf16 routed to {route}")
        n0 = kernels.launch_counts()
        got, h = kernels.fused_spectre_linear(*args, save_h=True)
        got2, h2 = kernels.fused_spectre_linear(*args, save_h=True)
        ref, ref_h = kernels.fused_spectre_linear_plain(*args, save_h=True)
        torch.cuda.synchronize()
        n1 = kernels.launch_counts()
        if {c: n1[c] - n0[c] for c in n1 if n1[c] != n0[c]} != {route: 2,
                                                               "fused_spectre_linear": 2}:
            raise AssertionError(f"C6: two calls did not launch {route} twice")
        if not (torch.equal(got, got2) and torch.equal(h, h2)):
            raise AssertionError(f"C6 {route} ({m}x{k})x({k}x{n}): two runs differ")
        err = max(max_abs_diff(got, ref), max_abs_diff(h, ref_h))
        worst[route, torch.bfloat16] = max(worst.get((route, torch.bfloat16), 0.0), err)
        if not err <= limits[torch.bfloat16]:
            raise AssertionError(f"C6 {route} ({m}x{k})x({k}x{n}): max abs err {err}")
        t = {"ms": cuda_time_ms(lambda: kernels.fused_spectre_linear(*args, save_h=True), iters=10),
             "device_ms": device_time_ms(
                 lambda: kernels.fused_spectre_linear(*args, save_h=True), iters=5),
             "plain_ms": cuda_time_ms(lambda: kernels.fused_spectre_linear_plain(*args), iters=5),
             "library_ms": cuda_time_ms(lambda: F.gelu(F.layer_norm(
                 torch.addmm(args[2], args[0], args[1]), (n,), args[3], args[4])), iters=10),
             "library_device_ms": device_time_ms(lambda: F.gelu(F.layer_norm(
                 torch.addmm(args[2], args[0], args[1]), (n,), args[3], args[4])), iters=5)}
        t["bound_ms"], t["bound_by"] = bound((m * k + k * n + 3 * n + 2 * m * n) * 2,
                                             2 * m * k * n, BF16_FLOPS)
        t.update(route=route, err=err)
        times[m, k, n, torch.bfloat16] = t
        print(f"C6 {route} ({m}x{k})x({k}x{n}) bf16: max abs err {err:.3g} (out and h), two "
              f"runs bitwise; forward {t['ms']:.4f} ms with h (device {t['device_ms']:.4f}), "
              f"cuBLAS chain {t['library_ms']:.4f} (device {t['library_device_ms']:.4f}), plain "
              f"{t['plain_ms']:.4f}, bound {t['bound_ms']:.4f} by {t['bound_by']}", flush=True)
        del x, w, args, got, got2, h, h2, ref, ref_h
        torch.cuda.empty_cache()

    def entry(name, src, line, key, bwd=False):
        t = times[key]
        m, k, n, dtype = key
        p = "bwd_" if bwd else ""
        chain = ("chain_device_ms", "chain_bound_ms", "chain_bound_partial_ms") if bwd else ()
        others = {f"{mm}x{kk}x{nn}_{str(dt)[6:]}": {
            "ms": v[p + "ms"], "device_ms": v[p + "device_ms"], "bound_ms": v[p + "bound_ms"],
            **{c: v[c] for c in chain}}
            for (mm, kk, nn, dt), v in times.items()
            if (p + "ms" in v if bwd else v["route"] == name) and (mm, kk, nn, dt) != key}
        return {"name": name, "route": "cuda", "source": f"spectre_tpu_torch/csrc/{src}",
                "replaces": f"spectre_tpu/ops/pallas/fused_linear.py:{line}",
                "ms": t[p + "ms"],
                "device_ms": t[p + "device_ms"], "plain_ms": t[p + "plain_ms"],
                "bound_ms": t[p + "bound_ms"], "bound_by": t[p + "bound_by"],
                "library_ms": None if bwd else t["library_ms"], "times": others,
                **{c: t[c] for c in chain},
                "shape": f"({m}x{k})x({k}x{n}) {str(dtype)[6:]}" + (
                    ": the wide chain and both products" if bwd else ", writing h")}

    bf, f32 = torch.bfloat16, torch.float32
    wide_cluster = entry("fused_spectre_linear_wide_cluster", "fused_spectre_linear.cu", 94,
                         (4160, 1536, 1536, bf))
    wide_bwd = entry("fused_spectre_linear_bwd_wide", "fused_spectre_linear_bwd.cu", 147,
                     (4160, 1536, 1536, bf), bwd=True)
    wide_bwd["max_abs_err"] = worst_bwd_abs[bf]
    wide_bwd["max_rel_err"] = worst_bwd[bf]
    wide_bwd["max_rel_err_f32"] = worst_bwd[f32]
    wide_cluster["max_abs_err"] = worst[wide_cluster["name"], bf]
    name = "fused_spectre_linear_cluster"
    cluster = {"max_abs_err_c6": worst[name, f32], "max_abs_err_c6_bf16": worst[name, bf],
               "times_c6": {f"{m}x{k}x{n}_{str(dt)[6:]}": {
                   key: v[key] for key in ("ms", "device_ms", "plain_ms", "library_ms",
                                           "library_device_ms", "bound_ms", "bound_by")}
                   for (m, k, n, dt), v in times.items() if v["route"] == name}}
    end = kernels.launch_counts()
    for k in (wide_cluster, wide_bwd):
        k["launches_c6_phase"] = end[k["name"]] - start[k["name"]]
    cluster["launches_c6_phase"] = end[name] - start[name]
    print(f"C6: kernel 2 takes N = {', '.join(str(s[2]) for s in C6_SHAPES + C6_REACH_SHAPES)} "
          f"on the card; forward max abs err bf16 {wide_cluster['max_abs_err']:.3g} (wide "
          f"cluster), {cluster['max_abs_err_c6_bf16']:.3g} (cluster, N = 1,100 and "
          f"{C6_REACH_SHAPES[-1][2]}), f32 {cluster['max_abs_err_c6']:.3g} (cluster); backward rel err bf16 "
          f"{worst_bwd[bf]:.3g}, f32 {worst_bwd[f32]:.3g}", flush=True)
    return wide_cluster, wide_bwd, cluster


DISTILL_CONFIG = os.path.join(ROOT, "spectre_tpu_torch", "configs", "distill_cifar100.py")
# the teacher in bf16 against the same teacher in float32 on the card, at
# B=256. Logits: the decoder sums 384 features each carrying bf16 rounding
# (2^-8 relative) times weights of about 384^-1/2, so an error of about
# 2^-8 on O(1) logits; 0.05 is ten times that. Patch tokens: LayerNorm
# outputs up to about 4, where one bf16 ulp is 1.6e-2, after a few roundings.
TEACHER_LOGIT_ATOL = 0.05
TEACHER_TOKEN_ATOL = 0.1
# both views in float32 on the card against the same matrices in float64:
# float32 rounding of normalised values up to about 11 (4e-6 a rounding)
VIEW_ATOL = 1e-4


def phase_distill(kernels, parse_config, distill_cli, tmp: str):
    """Distillation at full width (configs/distill_cifar100.py: the flagship
    student at B=256, the ViT-S/16 teacher at 224 px, 201 tokens):
    the teacher views against float64, the bf16 teacher against the f32
    teacher, one step's exact launches with no teacher run when its logits
    are cached, cache on against recompute bit for bit, the CLI through an
    epoch and a resume bit for bit equal to an uninterrupted run, two routed
    steps through B9; step, teacher and cache times and peak memory."""
    import copy

    from spectre_tpu_torch.data import make_train_augment, synthetic_dataset
    from spectre_tpu_torch.distill import (
        distill_from_config,
        make_teacher_view,
        precompute_teacher_logits,
        teacher_from_config,
    )
    from spectre_tpu_torch.distill.loop import TEACHER_VIEWS
    from spectre_tpu_torch.train import make_distill_step
    from spectre_tpu_torch.train.loop import create_trainer, dataset_stats

    cfg = parse_config(DISTILL_CONFIG)
    b, t_size = int(cfg.batch_size), int(cfg.teacher_img_size)
    train_x, train_y = synthetic_dataset(cfg.dataset, "train")
    raw, y = torch.from_numpy(train_x[:b]).cuda(), torch.from_numpy(train_y[:b]).cuda()
    out = {}

    # 1. the views in float32 against float64, and the teacher bf16 against f32
    for mode in TEACHER_VIEWS:
        view = make_teacher_view(t_size, mode=mode)
        got = view(raw)
        err = max_abs_diff(got, view(raw.double()))
        if tuple(got.shape) != (b, 3, t_size, t_size) or not err <= VIEW_ATOL:
            raise AssertionError(f"distill: teacher view {mode!r} {tuple(got.shape)}, err {err} "
                                 f"against float64 > {VIEW_ATOL}")
        out[f"view_err_{mode}"] = err
    t0 = time.perf_counter()
    teacher = teacher_from_config(cfg, t_size, "cuda")
    torch.cuda.synchronize()
    out["teacher_build_s"] = time.perf_counter() - t0
    cfg32 = copy.copy(cfg)
    cfg32.compute_dtype = "float32"
    teacher32 = teacher_from_config(cfg32, t_size, "cuda")
    xv = make_teacher_view(t_size)(raw)
    with torch.inference_mode():
        feats, feats32 = teacher.backbone(xv), teacher32.backbone(xv)
        logits = teacher.decoder(feats["x_norm_clstoken"])
        logits32 = teacher32.decoder(feats32["x_norm_clstoken"])
    tokens = 1 + feats["x_norm_regtokens"].shape[1] + feats["x_norm_patchtokens"].shape[1]
    bb = teacher.backbone
    want_tokens = 1 + bb.num_registers + (bb.img_size // bb.patch_size) ** 2  # 201 at 224 px
    logit_err = max_abs_diff(logits, logits32)
    token_err = max_abs_diff(feats["x_norm_patchtokens"], feats32["x_norm_patchtokens"])
    if (tuple(logits.shape) != (b, cfg.num_classes) or tokens != want_tokens
            or logits.dtype != torch.float32 or not torch.isfinite(logits).all()
            or not logit_err <= TEACHER_LOGIT_ATOL or not token_err <= TEACHER_TOKEN_ATOL):
        raise AssertionError(f"distill: teacher logits {tuple(logits.shape)} {logits.dtype}, "
                             f"{tokens} tokens; bf16 vs f32: logits {logit_err} (limit "
                             f"{TEACHER_LOGIT_ATOL}), patch tokens {token_err} (limit "
                             f"{TEACHER_TOKEN_ATOL})")
    out.update(teacher_logit_err=logit_err, teacher_token_err=token_err)
    print(f"distill: teacher ViT-S/16 at {t_size} px, {tokens} tokens, "
          f"{sum(p.numel() for p in teacher.parameters()):,} parameters, built in "
          f"{out['teacher_build_s']:.2f} s; bf16 against f32 at B={b}: logits max abs err "
          f"{logit_err:.3g} (limit {TEACHER_LOGIT_ATOL}), patch tokens {token_err:.3g} (limit "
          f"{TEACHER_TOKEN_ATOL}); views against float64: "
          f"{ {m: round(out[f'view_err_{m}'], 9) for m in TEACHER_VIEWS} } (limit {VIEW_ATOL})",
          flush=True)
    del teacher32, feats, feats32, logits, logits32
    torch.cuda.empty_cache()

    # 2. one step with the cached logits: exact launches, no teacher call
    view = make_teacher_view(t_size)
    calls = [0]
    hook = teacher.register_forward_hook(lambda *_: calls.__setitem__(0, calls[0] + 1))

    def teacher_logits(r):
        with torch.inference_mode():
            logits = teacher(view(r))
        return logits.clone()

    t0 = time.perf_counter()
    cache = precompute_teacher_logits(teacher_logits, train_x, b, cfg.num_classes, "cuda")
    torch.cuda.synchronize()
    out["cache_s"] = time.perf_counter() - t0
    if calls[0] != -(-len(train_x) // b):
        raise AssertionError(f"distill: the cache pass called the teacher {calls[0]} times")
    state = create_trainer(cfg, "cuda", steps_per_epoch=len(train_x) // b)
    alpha = float(cfg.distill_alpha)
    step = make_distill_step(make_train_augment(*dataset_stats(cfg.dataset)),
                             float(cfg.distill_temperature), alpha, 1.0 - alpha,
                             cfg.grad_clip_norm)
    cached = cache[torch.arange(b, device="cuda")]
    calls[0] = 0
    kernels.reset_launch_counts()
    m = step(state, raw, cached, y)
    torch.cuda.synchronize()
    counts, want = kernels.launch_counts(), expected_launches(cfg, steps=1)
    if counts != want or calls[0]:
        raise AssertionError(f"distill: one cached step launched {counts} (want {want}) and "
                             f"called the teacher {calls[0]} times")
    if (counts["fused_spectre_linear_wgmma"], counts["fused_spectre_linear_cluster"]) != (8, 1):
        raise AssertionError(f"distill: kernel 2's forwards split {counts}")
    bad = [n for n, p in state.model.named_parameters()
           if p.grad is None or not torch.isfinite(p.grad).all()]
    if bad or not all(torch.isfinite(v) for v in m.values()):
        raise AssertionError(f"distill: metrics { {k: v.item() for k, v in m.items()} }, no "
                             f"finite gradient for {bad}")
    print(f"distill: one step with cached teacher logits launched "
          f"{ {k: v for k, v in counts.items() if v} } and no teacher; every parameter has a "
          f"finite gradient; loss {m['loss'].item():.4f} (kd {m['loss_dist'].item():.4f}, ce "
          f"{m['loss_ce'].item():.4f})", flush=True)
    torch.cuda.reset_peak_memory_stats()
    out["step_ms_cache"] = cuda_time_ms(lambda: step(state, raw, cached, y), iters=1, reps=5)
    out["peak_gb_cache"] = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    out["step_ms_recompute"] = cuda_time_ms(lambda: step(state, raw, teacher_logits(raw), y),
                                            iters=1, reps=5)
    out["peak_gb_recompute"] = torch.cuda.max_memory_allocated() / 1e9
    out["teacher_ms"] = cuda_time_ms(lambda: teacher_logits(raw), iters=3, reps=5)
    hook.remove()
    print(f"distill at B={b}: step {out['step_ms_cache']:.2f} ms with the cached logits, "
          f"{out['step_ms_recompute']:.2f} ms with the teacher in the step (CUDA events, median "
          f"of 5); teacher view and forward {out['teacher_ms']:.2f} ms; cache pass over "
          f"{len(train_x)} images {out['cache_s']:.2f} s; peak memory "
          f"{out['peak_gb_cache']:.2f} / {out['peak_gb_recompute']:.2f} GB", flush=True)
    del state, cache, cached, m
    torch.cuda.empty_cache()

    # 3. cache on against recompute through the loop: 3 steps bit for bit
    runs = {c: distill_from_config(cfg, device="cuda", max_steps=3, synthetic=True,
                                   teacher=teacher, checkpoint=False, write_metrics=False,
                                   cache_teacher=c) for c in (True, False)}
    if runs[True].batch_losses != runs[False].batch_losses or len(runs[True].batch_losses) != 3:
        raise AssertionError(f"distill: cached {runs[True].batch_losses} != recomputed "
                             f"{runs[False].batch_losses}")
    print(f"distill: cache on and recompute, 3 steps: loss, kd and ce bit for bit "
          f"{runs[True].batch_losses}", flush=True)
    del runs, teacher
    torch.cuda.empty_cache()

    # 4. the CLI through one epoch (16 steps, validation, a checkpoint) and
    # --resume to step 20, against one run to step 20
    val_batches = -(-1024 // cfg.val_batch_size)

    def run(name, steps, flags=(), sets=()):
        kernels.reset_launch_counts()
        result = distill_cli.main(["--config", DISTILL_CONFIG, "--synthetic", "--steps",
                                   str(steps), *flags, "--set", *sets,
                                   f"checkpoint_dir={os.path.join(tmp, 'distill_' + name)}"])
        return result, kernels.launch_counts()

    whole, whole_counts = run("whole", 20)
    want = expected_launches(cfg, forwards=2 * val_batches, steps=20)
    if whole_counts != want or whole.state.step != 20:
        raise AssertionError(f"distill CLI to step 20 launched {whole_counts}, want {want}")
    first, _ = run("parts", 16)
    resumed, _ = run("parts", 20, ["--resume"])
    bad = _same_state(whole.state, resumed.state)
    if (bad or first.state.step != 16 or whole.batch_losses[16:] != resumed.batch_losses
            or whole.last_val_accuracy != resumed.last_val_accuracy):
        raise AssertionError(f"distill: resumed run differs from the uninterrupted one: "
                             f"{bad[:8]} ({len(bad)} in all); losses {whole.batch_losses[16:]} "
                             f"vs {resumed.batch_losses}")
    for must in ("events.jsonl", os.path.join("ckpt", "index.json"),
                 os.path.join("ckpt", "step_00000016.pt"), os.path.join("ckpt", "step_00000020.pt")):
        if not os.path.exists(os.path.join(resumed.logdir, must)):
            raise AssertionError(f"distill CLI: {must} missing under {resumed.logdir}")
    out["cli_cache_s"] = whole.cache_seconds
    print(f"distill CLI: one epoch (16 steps, validation, checkpoint) then --resume to step 20 "
          f"== one run to step 20, bit for bit; to step 20 launched "
          f"{ {k: v for k, v in whole_counts.items() if v} }; val acc "
          f"{whole.last_val_accuracy:.4f}", flush=True)
    del whole, first, resumed
    torch.cuda.empty_cache()

    # 5. two steps with the routed backward: B9 on every layer (the route
    # tables from the routed trainer's cache)
    routed, routed_counts = run("routed", 2, ["--no-checkpoint"],
                                ["mix_routed=True", "mix_routed_impl=pallas"])
    cfg.mix_routed, cfg.mix_routed_impl = True, "pallas"
    want = expected_launches(cfg, forwards=val_batches, steps=2)
    if routed_counts != want or routed.state.step != 2 or not np.isfinite(routed.metrics["loss"]):
        raise AssertionError(f"distill routed CLI launched {routed_counts}, want {want}")
    print(f"distill routed CLI: 2 steps launched "
          f"{ {k: v for k, v in routed_counts.items() if v} }", flush=True)
    del routed
    torch.cuda.empty_cache()
    return whole_counts, out


EXPORT_BATCH = 64
# the exported program against the live model: the JAX package's replay
# limit for bf16 (repl/export.py), the summation order of the folded
# projection's product being the only difference
EXPORT_ATOL = 5e-2
PIPELINE_CLIENTS, PIPELINE_REQUESTS, PIPELINE_BATCH = 8, 16, 32
AB_SECONDS = 4.0  # each turn of the pipeline A/B
# one client of the A/B, in a process of its own: the port's client module
# loaded from its file (numpy and sockets only), four requests drawn once
# and sent in turn, back to back from a line on stdin for argv[5] seconds
_AB_CLIENT = r"""
import importlib.util, json, sys, time
import numpy as np
path, port, seed, batch, seconds = sys.argv[1:6]
spec = importlib.util.spec_from_file_location("spectre_client", path)
client = importlib.util.module_from_spec(spec)
spec.loader.exec_module(client)
rng = np.random.default_rng(int(seed))
xs = [rng.uniform(0, 1, (int(batch), 3, 32, 32)).astype(np.float32) for _ in range(4)]
with client.SpectreClient(port=int(port)) as c:
    for x in xs:
        c.infer(x)
    print("READY", flush=True)
    sys.stdin.readline()
    ms, t0 = [], time.perf_counter()
    while time.perf_counter() - t0 < float(seconds):
        t = time.perf_counter()
        c.infer(xs[len(ms) % 4])
        ms.append((time.perf_counter() - t) * 1e3)
    print(json.dumps({"elapsed": time.perf_counter() - t0, "ms": ms}), flush=True)
"""


def phase_export(kernels, build_model, parse_config, source, tmp: str):
    """The deployment path at full width in bf16: a reference-layout
    state_dict of ``source`` (the phase-7 flagship) imported into a model of
    another seed, ``torch.export`` of it at batch 64, saved and loaded in
    this process; the loaded program's launches per call, its logits
    against the live model and the plain path, and its times. Returns
    (the importer's model, launches of one call of the program, numbers)."""
    from spectre_tpu_torch.export import export_forward, exported_module, kernel_nodes, \
        load_exported, save_exported
    from spectre_tpu_torch.models import import_spectre_vit, reference_state_dict

    cfg = parse_config(CONFIG)
    # a reference checkpoint as torch.load gives one: keys and layouts of the
    # reference SpectreViT, tensors on the host
    sd = {k: v.cpu() for k, v in reference_state_dict(source).items()}
    model = build_model(SimpleNamespace(**{**vars(cfg), "random_seed": 7}), "cuda")
    t0 = time.perf_counter()
    import_spectre_vit(model, sd)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    bad = [k for k, t in source.state_dict().items() if not torch.equal(model.state_dict()[k], t)]
    if bad:
        raise AssertionError(f"export: the reference import differs from its source in {bad[:8]}")
    x = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 1, (EXPORT_BATCH, cfg.in_channels, cfg.img_size, cfg.img_size))
        .astype(np.float32)).cuda()
    t0 = time.perf_counter()
    program = export_forward(model, x)
    export_s = time.perf_counter() - t0
    path = os.path.join(tmp, "flagship.pt2")
    t0 = time.perf_counter()
    save_exported(program, path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = load_exported(path)
    fwd = exported_module(loaded)
    load_s = time.perf_counter() - t0
    nodes = kernel_nodes(loaded)
    if nodes != {"block_scatter_rows": cfg.num_encoders,
                 "fused_spectre_linear": 2 * cfg.num_encoders + 1}:
        raise AssertionError(f"export: the program's kernel nodes are {nodes}")
    fwd(x)  # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    got = fwd(x)
    torch.cuda.synchronize()
    counts, want = kernels.launch_counts(), expected_launches(cfg, forwards=1)
    if counts != want:
        raise AssertionError(f"export: one call of the loaded program launched {counts}, "
                             f"want {want}")
    with torch.no_grad():
        live = model(x)
        with plain_versions(kernels):
            plain = model(x)
    torch.cuda.synchronize()
    ok = tuple(got.shape) == (EXPORT_BATCH, cfg.num_classes) and bool(torch.isfinite(got).all())
    d_live, d_plain = max_abs_diff(got, live), max_abs_diff(got, plain)
    if not ok or not d_live <= EXPORT_ATOL or not d_plain <= MODEL_ATOL:
        raise AssertionError(f"export: logits {tuple(got.shape)} finite {ok}, program vs live "
                             f"{d_live} (limit {EXPORT_ATOL}), vs plain {d_plain} "
                             f"(limit {MODEL_ATOL})")

    def live_forward():
        with torch.inference_mode():
            return model(x)
    program_ms = cuda_time_ms(lambda: fwd(x), iters=5, reps=5)
    live_ms = cuda_time_ms(live_forward, iters=5, reps=5)
    # the device's own time and the host's to issue a call: 3 calls (a few
    # hundred launches) fit the launch queue behind the sleep
    program_dev, program_host = queued_time_ms(lambda: fwd(x), iters=3, reps=5)
    live_dev, live_host = queued_time_ms(live_forward, iters=3, reps=5)
    mb = os.path.getsize(path) / 1e6
    print(f"export: reference state_dict ({len(sd)} keys) imported in {import_s:.3f} s, equal "
          f"to its source bit for bit; torch.export at batch {EXPORT_BATCH} in {export_s:.2f} s, "
          f"saved in {save_s:.2f} s ({mb:.1f} MB .pt2), loaded in {load_s:.2f} s; kernel "
          f"nodes {nodes}; one call launched { {k: v for k, v in counts.items() if v} }; "
          f"program vs live {d_live:.4g} (limit {EXPORT_ATOL}), vs plain {d_plain:.4g} "
          f"(limit {MODEL_ATOL}); forward {program_ms:.3f} ms exported, {live_ms:.3f} ms "
          f"live (CUDA events, median of 5 runs of 5 calls); on the device {program_dev:.3f} "
          f"and {live_dev:.3f} ms, the host's issue {program_host:.3f} and {live_host:.3f} ms",
          flush=True)
    return model, counts, {
        "import_s": import_s, "export_s": export_s, "save_s": save_s, "load_s": load_s,
        "pt2_mb": mb, "kernel_nodes": nodes, "max_abs_vs_live": d_live,
        "max_abs_vs_plain": d_plain, "program_ms_b64": program_ms, "live_ms_b64": live_ms,
        "program_device_ms_b64": program_dev, "live_device_ms_b64": live_dev,
        "program_host_ms_b64": program_host, "live_host_ms_b64": live_host}


def phase_export_clis(tmp: str) -> dict:
    """``repl/export.py`` (flagship, batch 2, on the card) and then
    ``repl/infer.py --expect`` on what it wrote, each a fresh process that
    must exit 0; the runner must not import the port's model code."""
    out = os.path.join(tmp, "export_cli")
    runs = {}
    for name, args in (
            ("export", ["-m", "spectre_tpu_torch.repl.export", "--outdir", out, "--batch", "2"]),
            ("infer", ["-m", "spectre_tpu_torch.repl.infer", "--artifact",
                       os.path.join(out, "model.pt2"), "--input",
                       os.path.join(out, "example_input.f32"), "--batch", "2", "--channels",
                       "3", "--size", "32", "--expect",
                       os.path.join(out, "example_logits.f32")])):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, *args], cwd=ROOT, capture_output=True, text=True,
                           timeout=600)
        runs[name] = time.perf_counter() - t0
        if r.returncode != 0:
            raise AssertionError(f"export CLIs: {name} exited {r.returncode}:\n"
                                 f"{r.stdout[-2000:]}\n{r.stderr[-3000:]}")
        for line in r.stdout.strip().splitlines():
            print(f"export CLIs: {name}: {line}", flush=True)
    if "model code imported: none" not in r.stdout:
        raise AssertionError("export CLIs: repl/infer.py imported the port's model code")
    print(f"export CLIs: export {runs['export']:.1f} s, infer {runs['infer']:.1f} s "
          f"(fresh processes, wall clock)", flush=True)
    return {f"{k}_s": v for k, v in runs.items()}


def phase_stw(build_model, parse_config, model, tmp: str) -> dict:
    """``.stw`` at full width: ``model`` written, read into a model of
    another seed on the card, and the two give the same logits bit for
    bit."""
    from spectre_tpu_torch.export import load_stw_into, save_stw

    cfg = parse_config(CONFIG)
    path = os.path.join(tmp, "weights.stw")
    t0 = time.perf_counter()
    save_stw(model, path)
    save_s = time.perf_counter() - t0
    fresh = build_model(SimpleNamespace(**{**vars(cfg), "random_seed": 11}), "cuda")
    t0 = time.perf_counter()
    load_stw_into(fresh, path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    x = torch.from_numpy(np.random.default_rng(6).uniform(
        0, 1, (EXPORT_BATCH, cfg.in_channels, cfg.img_size, cfg.img_size))
        .astype(np.float32)).cuda()
    with torch.inference_mode():
        a, b = model(x), fresh(x)
    if not torch.equal(a, b):
        raise AssertionError(f".stw: logits after the round trip differ by {max_abs_diff(a, b)}")
    mb = os.path.getsize(path) / 1e6
    print(f".stw: flagship written in {save_s:.2f} s ({mb:.1f} MB), read into a model of "
          f"another seed in {load_s:.2f} s; batch-{EXPORT_BATCH} logits equal bit for bit",
          flush=True)
    del fresh
    return {"save_s": save_s, "load_s": load_s, "stw_mb": mb}


def phase_export_families(kernels, build_model, parse_config, tmp: str):
    """The ViT and the structured mix exported at full width (2 layers):
    their loaded programs launch B4's forward and B6, and match their live
    models within EXPORT_ATOL. Returns {family: launches of one call}."""
    from spectre_tpu_torch.export import export_forward, exported_module, load_exported, \
        save_exported

    launches = {}
    for tag, config, over, kernel in (
            ("vit", VIT_CONFIG, {}, "flash_attention_fwd"),
            ("structured", CONFIG, {"mix_impl": "structured"}, "structured_mix")):
        cfg = SimpleNamespace(**{**vars(parse_config(config)), "num_encoders": 2, **over})
        model = build_model(cfg, "cuda")
        x = torch.from_numpy(np.random.default_rng(7).uniform(
            0, 1, (EXPORT_BATCH, cfg.in_channels, cfg.img_size, cfg.img_size))
            .astype(np.float32)).cuda()
        path = save_exported(export_forward(model, x), os.path.join(tmp, f"{tag}.pt2"))
        fwd = exported_module(load_exported(path))
        fwd(x)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        got = fwd(x)
        torch.cuda.synchronize()
        counts, want = kernels.launch_counts(), expected_launches(cfg, forwards=1)
        with torch.no_grad():
            live = model(x)
        diff = max_abs_diff(got, live)
        if counts != want or not counts[kernel] > 0 or not diff <= EXPORT_ATOL:
            raise AssertionError(f"export {tag}: one call launched {counts}, want {want}; "
                                 f"program vs live {diff} (limit {EXPORT_ATOL})")
        print(f"export {tag}: 2 layers at full width, batch {EXPORT_BATCH}: one call of the "
              f"loaded program launched { {k: v for k, v in counts.items() if v} }, program vs "
              f"live {diff:.4g} (limit {EXPORT_ATOL})", flush=True)
        launches[tag] = counts
        del model
    torch.cuda.empty_cache()
    return launches


def _load(port: int, seed: int, clients: int = PIPELINE_CLIENTS,
          requests: int = PIPELINE_REQUESTS) -> tuple[float, list, list]:
    """``clients`` clients, each on its own connection, each sending
    ``requests`` requests of PIPELINE_BATCH images back to back. Returns
    (wall seconds, per-request ms, (images, reply) pairs)."""
    from spectre_tpu_torch.serving import SpectreClient

    results, errors = [[] for _ in range(clients)], []

    def client(i):
        rng = np.random.default_rng(seed + i)
        try:
            with SpectreClient(port=port) as c:
                for _ in range(requests):
                    x = rng.uniform(0, 1, (PIPELINE_BATCH, 3, 32, 32)).astype(np.float32)
                    t0 = time.perf_counter()
                    got = c.infer(x)
                    results[i].append(((time.perf_counter() - t0) * 1e3, x, got))
        except Exception as e:  # noqa: BLE001 -- raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    flat = [r for rs in results for r in rs]
    return wall, [ms for ms, _, _ in flat], [(x, got) for _, x, got in flat]


def _load_numbers(wall: float, ms: list) -> dict:
    images = len(ms) * PIPELINE_BATCH
    return {"img_per_s": images / wall, "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)), "wall_s": wall}


def _load_processes(srv, port: int, clients: int, seed: int) -> dict:
    """``clients`` client processes on ``port`` (``_AB_CLIENT``), started
    together once all are connected and warm: img/s over the slowest
    client's window, p50/p99 per request, and the server's buckets and
    images a bucket in the window."""
    path = os.path.join(ROOT, "spectre_tpu_torch", "serving", "client.py")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _AB_CLIENT, path, str(port), str(seed + i), str(PIPELINE_BATCH),
         str(AB_SECONDS)], stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        for i in range(clients)]
    out = []
    try:
        for p in procs:
            if p.stdout.readline().strip() != "READY":
                raise AssertionError(f"pipeline A/B: a client failed (exit {p.wait()})")
        before = srv.forwards
        for p in procs:
            p.stdin.write("\n")
            p.stdin.flush()
        out = [json.loads(p.stdout.readline()) for p in procs]
        buckets = srv.forwards - before
    finally:
        for p in procs:
            if len(out) < clients:
                p.kill()
            p.stdin.close()
            p.wait(timeout=60)
    if any(p.returncode for p in procs):
        raise AssertionError(f"pipeline A/B: client exits {[p.returncode for p in procs]}")
    ms = [m for o in out for m in o["ms"]]
    images = len(ms) * PIPELINE_BATCH
    return {"img_per_s": images / max(o["elapsed"] for o in out),
            "p50_ms": float(np.percentile(ms, 50)), "p99_ms": float(np.percentile(ms, 99)),
            "requests": len(ms), "buckets": buckets, "images_per_bucket": images / buckets}


def phase_pipeline(kernels, serve, model, cfg):
    """The serving CLI's server under load: 8 concurrent clients, 16 requests
    of batch 32 each. Every reply within 1e-3 of a direct forward of the
    request at a bucket the batcher could have put it in (the request alone
    first); exact launches. Then the A/B of the shipped server against the
    batcher without the pipeline and the pipeline without coalescing, all
    on ``model``, under 8 and 16 client processes."""
    from spectre_tpu_torch.serving import TorchServer

    shape = (cfg.in_channels, cfg.img_size, cfg.img_size)
    kernels.reset_launch_counts()
    srv, port = serve.start(["--config", CONFIG, "--device", "cuda", "--port", "0"])
    try:
        _load(port, seed=90, requests=2)  # warm-up: the buckets' first forwards
        wall, ms, replies = _load(port, seed=100)
    finally:
        srv.close()
    counts, want = kernels.launch_counts(), expected_launches(cfg, forwards=srv.forwards)
    if counts != want:
        raise AssertionError(f"pipeline: {srv.forwards} forwards launched {counts}, want {want}")
    served = _load_numbers(wall, ms)
    alone, worst = 0, 0.0
    with torch.inference_mode():
        for x, got in replies:
            for bucket in (32, 64, 128, 256):
                xp = np.concatenate([x, np.zeros((bucket - len(x), *shape), np.float32)])
                diff = float(np.abs(got - model(torch.from_numpy(xp).cuda())[:len(x)]
                                    .float().cpu().numpy()).max())
                if diff <= 1e-3:
                    alone += bucket == 32
                    worst = max(worst, diff)
                    break
            else:
                raise AssertionError(f"pipeline: a reply differs from every bucket's direct "
                                     f"forward (last {diff})")
    print(f"pipeline: {PIPELINE_CLIENTS} clients x {PIPELINE_REQUESTS} requests of batch "
          f"{PIPELINE_BATCH} through the serving CLI: {served['img_per_s']:.0f} img/s, "
          f"p50 {served['p50_ms']:.2f} ms, p99 {served['p99_ms']:.2f} ms per request, "
          f"{srv.forwards} buckets; {len(replies)} replies within 1e-3 of direct forwards "
          f"({alone} of the request alone, the rest at a larger bucket; worst {worst:.3g}); "
          f"launches { {k: v for k, v in counts.items() if v} }", flush=True)

    class Unpipelined(TorchServer):
        """Each bucket answered as soon as it is dispatched, as the batcher
        worked before the pipeline."""

        def _dispatch(self, x, parts):
            self._resolve(super()._dispatch(x, parts))
            return [], [], []

        @staticmethod
        def _resolve(pending):
            if pending[0]:
                TorchServer._resolve(pending)

    class NoWait(TorchServer):
        """The pipeline dispatching as soon as the queue is empty, without
        coalescing while the card runs the pending bucket."""

        @staticmethod
        def _running(pending):
            return False

    # 8 clients of batch 32 never queue more than one bucket of 256; 16 do
    runs = []
    for clients in (PIPELINE_CLIENTS, 16):
        for name, cls in (("pipelined", TorchServer), ("unpipelined", Unpipelined),
                          ("no_wait", NoWait), ("no_wait", NoWait),
                          ("unpipelined", Unpipelined), ("pipelined", TorchServer)):
            s = cls(model, shape, "cuda")
            port = s.listen_tcp()
            try:
                runs.append({"server": name, "clients": clients,
                             **_load_processes(s, port, clients, seed=300)})
            finally:
                s.close()
            r = runs[-1]
            print(f"pipeline A/B: {clients} client processes, {name}: {r['img_per_s']:.0f} "
                  f"img/s, p50 {r['p50_ms']:.2f} ms, p99 {r['p99_ms']:.2f} ms, "
                  f"{r['requests']} requests in {r['buckets']} buckets "
                  f"({r['images_per_bucket']:.1f} images a bucket)", flush=True)

    def bucket256():
        with torch.inference_mode():
            return model(torch.zeros((256, *shape), device="cuda"))
    dev, host = queued_time_ms(bucket256, iters=3, reps=5)
    print(f"pipeline: a bucket-256 forward takes the device {dev:.3f} ms and the host "
          f"{host:.3f} ms to issue", flush=True)
    return {"served": served, "buckets": srv.forwards, "replies_alone": alone,
            "a_b": runs, "bucket256_device_ms": dev, "bucket256_host_ms": host}


# -- slice 11: the tools around the model -----------------------------------

PROFILE_BATCH, PROFILE_STEPS = 256, 3
# torch.profiler's own device total against the parser's sum of the same
# trace's kernel, copy and fill events: they read one trace, so only the
# rows the two count differently can part them
PROFILE_TOTAL_REL = 0.05
# the CUDA names of the kernels a flagship step launches, by wrapper count
PROFILE_KERNELS = (("block_scatter_rows_kernel", "block_scatter_rows"),
                   ("fused_block_bwd_wgmma_kernel", "fused_block_bwd_wgmma"),
                   ("fused_linear_wgmma_kernel", "fused_spectre_linear_wgmma"),
                   ("fused_linear_cluster_kernel", "fused_spectre_linear_cluster"),
                   ("chain_kernel", "fused_spectre_linear_bwd"))


def phase_profile(kernels, parse_config, tmp: str) -> dict:
    """``trace_step`` around 3 flagship train steps at B=256 and the table of
    ``ProfilerParser``: its device total against ``key_averages()``'s, the
    kernels of B1, B8 and B3 under their CUDA names with the wrappers'
    launches, and the 15 largest rows."""
    from torch.autograd import DeviceType

    from spectre_tpu_torch.profile import ProfilerParser, trace_step, tracer
    from spectre_tpu_torch.train.loop import build_step

    cfg = parse_config(CONFIG)
    state, step = build_step(cfg, "cuda")
    x, y = _train_batch(cfg, PROFILE_BATCH)
    for _ in range(2):
        step(state, x, y)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with trace_step(os.path.join(tmp, "profile"), "cuda") as t:
        for _ in range(PROFILE_STEPS):
            step(state, x, y)
        torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = expected_launches(cfg, steps=PROFILE_STEPS)
    if {k: v for k, v in counts.items() if v} != {k: v for k, v in want.items() if v}:
        raise AssertionError(f"profile: {PROFILE_STEPS} steps launched {counts}, not {want}")
    with open(t.trace_file) as f:
        annotations = {e["name"] for e in json.load(f)["traceEvents"]
                       if e.get("cat") == "gpu_user_annotation"}
    ka_ms = sum(e.self_device_time_total for e in t.profiler.key_averages()
                if e.device_type == DeviceType.CUDA and e.key not in annotations) / 1e3
    table = ProfilerParser(t.trace_file).remove_idle().add_percentages().sort_by_device()
    rows = table.rows
    total_ms = sum(r["device_total_ms"] for r in rows)
    if not abs(total_ms - ka_ms) <= PROFILE_TOTAL_REL * ka_ms:
        raise AssertionError(f"profile: the parser's device total {total_ms:.3f} ms is not within "
                             f"{PROFILE_TOTAL_REL:.0%} of key_averages' {ka_ms:.3f} ms")
    seen = {}
    for needle, counter in PROFILE_KERNELS:
        calls = sum(r["calls"] for r in rows if needle in r["name"]
                    and not (needle == "chain_kernel" and "chain_wide_kernel" in r["name"]))
        seen[needle] = calls
        if calls != counts[counter] or not calls:
            raise AssertionError(f"profile: {needle} has {calls} calls in the trace, the "
                                 f"{counter} wrapper counted {counts[counter]}")
    # short windows, unpadded and padded: how many of their kernels the
    # trace keeps, against the launches the host recorded
    a = torch.randn(512, 512, generator=torch.Generator().manual_seed(0)).cuda()
    windows = {}
    for pad in (0.0, tracer.PAD_S) * 3:
        with mock.patch.object(tracer, "PAD_S", pad), \
                trace_step(os.path.join(tmp, f"window_{pad}"), "cuda") as w:
            for _ in range(20):
                (a @ a).relu_()
            torch.cuda.synchronize()
        wrows = ProfilerParser(w.trace_file).rows
        kept = sum(r["calls"] for r in wrows if r["device_total_ms"] > 0)
        launched = sum(r["calls"] for r in wrows if "Launch" in r["name"])
        windows.setdefault("padded" if pad else "unpadded", []).append((kept, launched))
    if any(k != n or not n for k, n in windows["padded"]):
        raise AssertionError(f"profile: padded windows kept (kernels, launches) "
                             f"{windows['padded']}")
    print(f"profile: (kernels kept, launched) by short windows, unpadded {windows['unpadded']}, "
          f"padded by {tracer.PAD_S} s {windows['padded']}", flush=True)
    print(f"profile: {PROFILE_STEPS} flagship steps at B={PROFILE_BATCH}: {total_ms:.3f} ms on "
          f"the device by the parser, {ka_ms:.3f} by key_averages; kernels by CUDA name and "
          f"calls {seen} equal to the wrappers' launches; {len(rows)} rows; top 15:",
          flush=True)
    table.head(15).show(name_width=200)
    return {"batch": PROFILE_BATCH, "steps": PROFILE_STEPS, "device_ms": total_ms,
            "key_averages_device_ms": ka_ms, "kernel_calls": seen, "launches": counts,
            "short_windows_kept_launched": windows,
            "top": [dict(r, name=r["name"][:300]) for r in rows[:15]]}


# the JAX package's defaults for repl/perf.py latency|linear|mixer|encoder
PERF_WARMUP, PERF_ITERS, PERF_EMBED, PERF_HEADS, PERF_BATCH = 10, 100, 512, 4, 8
F32_LINEAR_ATOL = 1e-4  # phase_kernel2 and phase_c6: float32, another summation order


def _only(counts: dict, want: dict, tag: str) -> None:
    got = {k: v for k, v in counts.items() if v}
    if got != want:
        raise AssertionError(f"{tag} launched {got}, not {want}")


def phase_perf_modes(kernels, perf_cli, gen) -> dict:
    """``repl/perf.py latency|linear|mixer|encoder`` through its ``main`` at
    the JAX package's defaults: exact launches each, then one shape per mode
    against the plain versions, and the cluster kernel's times at 8 rows."""
    import torch.nn.functional as F

    from spectre_tpu_torch.models import SpectreEncoderLayer, SpectreLinear, SpectreViT
    from spectre_tpu_torch.ops import make_structured_tables

    calls = PERF_WARMUP + PERF_ITERS
    fwd, cluster = "fused_spectre_linear", "fused_spectre_linear_cluster"
    res, launches = {}, {}
    for mode, want in (
            # 8 SpectreViTs (patch x heads), 4 layers of 3 SpectreLinears and
            # the head, float32: all on the cluster kernel; the gather mix is
            # torch ops, as the JAX function is jnp
            ("latency", {fwd: 8 * calls * 13, cluster: 8 * calls * 13}),
            # dims 256 to 4,096, float32: all on the cluster kernel
            ("linear", {fwd: 5 * calls, cluster: 5 * calls}),
            # the structured-mix kernel at every d = 2^6 .. 2^13
            ("mixer", {"structured_mix": 8 * calls}),
            # 3 SpectreLinears, one forward outside the trace and one in it
            ("encoder", {fwd: 6, cluster: 6})):
        kernels.reset_launch_counts()
        res[mode] = perf_cli.main([mode])[mode]
        torch.cuda.synchronize()
        launches[mode] = kernels.launch_counts()
        _only(launches[mode], want, f"perf {mode}")
    if len(res["mixer"]) != 8 or any(not r["structured_kernel_ms"] > 0 for r in res["mixer"]):
        raise AssertionError(f"perf mixer: rows {res['mixer']}")

    checks = {}
    seed = torch.Generator().manual_seed(0)
    # latency: one SpectreViT (patch 4, heads 4) against the plain path
    vit = SpectreViT(img_size=32, patch_size=4, in_channels=3, num_classes=100,
                     embed_dim=PERF_EMBED, num_encoders=4, num_heads=PERF_HEADS,
                     hidden_dim=PERF_EMBED, dropout=0.0, mix_impl="gather", device="cuda")
    perf_cli._seeded(vit)
    xi = torch.rand(PERF_BATCH, 3, 32, 32, generator=seed).cuda()
    with torch.no_grad():
        got = vit(xi)
        with plain_versions(kernels):
            ref = vit(xi)
    checks["latency_logits"] = max_abs_diff(got, ref)
    # encoder: the layer against the plain path
    layer = perf_cli._seeded(SpectreEncoderLayer(
        seq_length=65, d_model=PERF_EMBED, nhead=PERF_HEADS, dim_feedforward=PERF_EMBED,
        dropout=0.0, mix_impl="gather", device="cuda"))
    xe = torch.randn(PERF_BATCH, 65, PERF_EMBED, generator=seed).cuda()
    with torch.no_grad():
        got = layer(xe)
        with plain_versions(kernels):
            ref = layer(xe)
    checks["encoder_out"] = max_abs_diff(got, ref)
    del vit, layer
    # linear: kernel 2 (the cluster kernel) at dims 256 to 4,096, 8 rows;
    # times from 1,024
    wide_times = {}
    for dim in (256, 1024, 2048, 4096):
        sl = perf_cli._seeded(SpectreLinear(dim, dim, device="cuda"))
        xl = torch.randn(PERF_BATCH, dim, generator=seed).cuda()
        args = (xl, sl.kernel.detach(), sl.bias.detach(), sl.ln_scale.detach(),
                sl.ln_bias.detach())
        got = kernels.fused_spectre_linear(*args)
        checks[f"linear_{dim}"] = max_abs_diff(got, kernels.fused_spectre_linear_plain(*args))
        if dim == 256:
            continue
        t = {"ms": cuda_time_ms(lambda: kernels.fused_spectre_linear(*args), iters=20),
             "device_ms": device_time_ms(lambda: kernels.fused_spectre_linear(*args), iters=10),
             "plain_ms": cuda_time_ms(lambda: kernels.fused_spectre_linear_plain(*args),
                                      iters=10),
             "library_ms": cuda_time_ms(lambda: F.gelu(F.layer_norm(
                 torch.addmm(args[2], xl, args[1]), (dim,), args[3], args[4])) + xl, iters=20),
             "library_device_ms": device_time_ms(lambda: F.gelu(F.layer_norm(
                 torch.addmm(args[2], xl, args[1]), (dim,), args[3], args[4])) + xl, iters=10)}
        t["bound_ms"], t["bound_by"] = bound(
            (2 * PERF_BATCH * dim + dim * dim + 3 * dim) * 4, 2 * PERF_BATCH * dim * dim,
            FP32_FLOPS)
        wide_times[f"{PERF_BATCH}x{dim}x{dim}_float32"] = t
        print(f"perf linear's cluster kernel ({PERF_BATCH}x{dim})x({dim}x{dim}) f32: "
              f"{t['ms']:.4f} ms back to back, device {t['device_ms']:.4f}, bound "
              f"{t['bound_ms']:.4f} by {t['bound_by']}; plain {t['plain_ms']:.4f}; cuBLAS "
              f"chain {t['library_ms']:.4f} (device {t['library_device_ms']:.4f})", flush=True)
        del sl, xl, args, got
    # mixer: kernel 7 at d = 4,096 bit for bit
    d, n = 4096, 8
    tperms, ssigns = (t.cuda() for t in make_structured_tables(seed, PERF_HEADS, d))
    xm = torch.randn(PERF_BATCH, n, d // n, generator=seed).cuda()
    got = kernels.structured_mix(xm, tperms, ssigns, n)
    if not torch.equal(got, kernels.structured_mix_plain(xm, tperms, ssigns, n)):
        raise AssertionError("perf mixer: kernel 7 at d=4,096 differs from its plain version")
    checks["mixer_4096"] = 0.0
    for key, err in checks.items():
        limit = 0.0 if key.startswith("mixer") else (
            MODEL_ATOL if key == "latency_logits" else F32_LINEAR_ATOL)
        if not err <= limit:
            raise AssertionError(f"perf modes: {key} max abs err {err} > {limit}")
    print(f"perf modes against plain (float32): {checks}; launches exact in all four "
          f"({ {m: {k: v for k, v in c.items() if v} for m, c in launches.items()} })",
          flush=True)
    return {"rows": res, "launches": launches, "max_abs_err": checks, "wide": wide_times}


def phase_head_chain(kernels, gen) -> dict:
    """The head's shape, (256 x 512)(512 x 100) bf16: kernel 2 (its cluster
    kernel) and the cuBLAS chain, each back to back and on the device."""
    import torch.nn.functional as F

    m, k, n = 256, 512, 100
    x = torch.randn(m, k, generator=gen).to("cuda", torch.bfloat16)
    w = (torch.rand(k, n, generator=gen) * 2 - 1).mul_(k ** -0.5).to("cuda", torch.bfloat16)
    b, beta = (0.1 * torch.randn(n, generator=gen).to("cuda", torch.bfloat16) for _ in range(2))
    gamma = (1.0 + 0.1 * torch.randn(n, generator=gen)).to("cuda", torch.bfloat16)

    def chain():
        return F.gelu(F.layer_norm(torch.addmm(b, x, w), (n,), gamma, beta))

    def kernel():
        return kernels.fused_spectre_linear(x, w, b, gamma, beta)

    out = {}
    for name, fn in (("kernel", kernel), ("chain", chain), ("chain", chain), ("kernel", kernel)):
        for key, v in ((name + "_ms", cuda_time_ms(fn, iters=20)),
                       (name + "_device_ms", device_time_ms(fn, iters=10))):
            out[key] = min(v, out.get(key, v))  # the lower of two turns
    print(f"head (256x512)(512x100) bf16: kernel {out['kernel_ms']:.4f} ms back to back, "
          f"device {out['kernel_device_ms']:.4f}; cuBLAS chain {out['chain_ms']:.4f}, device "
          f"{out['chain_device_ms']:.4f}", flush=True)
    return out


MNIST_CONFIG = os.path.join(ROOT, "spectre_tpu_torch", "configs", "spectre_vit_mnist.py")
SUBMISSION_STEPS = 3
DETERMINISTIC_REL = 1e-5  # a float32 product of depth 4,096 against float64
FLOPS_REL = 0.02  # FlopCounterMode on the plain path against repl/bench.py's count


def phase_tools(kernels, parse_config, build_model, tmp: str) -> dict:
    """``write_submission`` on the card (exact launches, the CSV's rows, the
    logits against the plain path), ``deterministic_mode`` (a [4,096 x
    4,096] float32 product against float64, TF32 restored after),
    ``enable_nan_checks`` (a NaN fed to one layer is named) and
    ``model_summary`` of the flagship at full width against the bench's
    FLOP count."""
    from spectre_tpu_torch.data import DATASET_STATS, make_eval_transform
    from spectre_tpu_torch.models import example_input
    from spectre_tpu_torch.repl.bench import forward_flops_per_image
    from spectre_tpu_torch.repl.mnist_submission import write_submission
    from spectre_tpu_torch.utils.debug import deterministic_mode, enable_nan_checks
    from spectre_tpu_torch.utils.summary import format_summary, model_summary

    out = {}
    cfg = parse_config(MNIST_CONFIG)
    path = os.path.join(tmp, "submission.csv")
    kernels.reset_launch_counts()
    sub = write_submission(cfg, path, device="cuda", steps=SUBMISSION_STEPS, synthetic=True)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    val_batches = -(-1024 // int(cfg.val_batch_size))  # the synthetic test and submission sets
    want = expected_launches(cfg, forwards=2 * val_batches, steps=SUBMISSION_STEPS)
    _only(counts, {k: v for k, v in want.items() if v}, "write_submission")
    with open(path) as f:
        lines = f.read().strip().splitlines()
    if lines[0] != "ImageId,Label" or len(lines) - 1 != len(sub.images):
        raise AssertionError(f"submission: {len(lines) - 1} rows for {len(sub.images)} images")
    xs = make_eval_transform(*DATASET_STATS["mnist"])(torch.from_numpy(sub.images[:512]).cuda())
    with torch.no_grad(), plain_versions(kernels):
        ref = sub.model(xs).float().cpu()
    err = max_abs_diff(sub.logits[:512], ref)
    if not err <= MODEL_ATOL:
        raise AssertionError(f"submission logits differ from the plain path by {err}")
    out["submission"] = {"rows": len(lines) - 1, "launches": counts, "max_abs_err": err}
    print(f"tools: write_submission on the card, {SUBMISSION_STEPS} steps: {len(lines) - 1} "
          f"rows, logits within {err:.4g} of the plain path, launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    del sub

    a, b = (torch.randn(4096, 4096, generator=torch.Generator().manual_seed(i)).cuda()
            for i in (1, 2))
    ref = (a.double() @ b.double())
    scale = ref.abs().max().item()
    torch.set_float32_matmul_precision("high")  # TF32 on, as a user may have it
    tf32 = ((a @ b).double() - ref).abs().max().item() / scale
    deterministic_mode(True)
    exact = ((a @ b).double() - ref).abs().max().item() / scale
    deterministic_mode(False)
    restored = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32)
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    if not (exact <= DETERMINISTIC_REL < tf32 and restored == ("high", True)):
        raise AssertionError(f"deterministic_mode: rel err {exact} (TF32 {tf32}), state after "
                             f"off {restored}")
    out["deterministic"] = {"rel_err": exact, "rel_err_tf32": tf32}
    print(f"tools: deterministic_mode: [4096 x 4096] f32 product within {exact:.3g} of the "
          f"largest entry of float64 (TF32: {tf32:.3g}); TF32 back on after off", flush=True)
    del a, b, ref

    small = parse_config(CONFIG)
    small.num_encoders = 2
    model = build_model(small, "cuda")
    poisoned = model.encoder_blocks.layer_1.linear1

    def poison(module, args):
        y = args[0].clone()
        y[0, 0, 0] = float("nan")
        return (y,)

    handle = poisoned.register_forward_pre_hook(poison)
    enable_nan_checks(True)
    try:
        with torch.no_grad():
            model(example_input(small, 4, "cuda").uniform_())
        raise AssertionError("enable_nan_checks: a NaN fed to layer_1.linear1 did not raise")
    except FloatingPointError as e:
        named = str(e)
    finally:
        enable_nan_checks(False)
        handle.remove()
    if not named.endswith("SpectreViT.encoder_blocks.layer_1.linear1"):
        raise AssertionError(f"enable_nan_checks named {named!r}")
    out["nan_checks"] = named
    print(f"tools: enable_nan_checks: {named}", flush=True)
    del model

    cfg = parse_config(CONFIG)
    model = build_model(cfg, "cuda")
    t0 = time.perf_counter()
    summary = model_summary(model, example_input(cfg, 2, "cuda"))
    analytic = 2 * forward_flops_per_image(cfg)
    rel = summary["flops"] / analytic - 1.0
    if not abs(rel) <= FLOPS_REL:
        raise AssertionError(f"model_summary: {summary['flops']:.4g} FLOPs against the bench's "
                             f"{analytic:.4g}")
    out["summary"] = dict(summary, analytic_flops=analytic, rel=rel,
                          seconds=time.perf_counter() - t0)
    print(f"tools: {format_summary('flagship', summary)}; the bench counts {analytic / 1e9:.4f} "
          f"GFLOP for 2 images ({rel:+.3%}); {out['summary']['seconds']:.1f} s on a CPU copy",
          flush=True)
    return out


# -- slice 16: tensor parallelism on the card ---------------------------------

# kernel B3's column-shard entries against their plain versions, each result
# (and each column of the statistics) as a share of its largest entry. f32:
# float32 sums in another order. bf16: h, dh, the column sums and out are
# rounded to bf16 once on both paths, so single entries differ by one bf16
# ulp (2^-8 to 2^-7 of the largest entry) where a sum order moved a value
# across a rounding boundary.
TP_ENTRY_REL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6}
TP_ENTRY_NAMES = ("fused_spectre_linear_shard_stats", "sharded_ln_gelu", "chain_shard_sums",
                  "chain_shard_dh")
# float32 operations an element of entries 2, 3 and 4 (LayerNorm, erf GELU,
# its derivative): for their bound, which is the bytes' at every shape here
TP_ELEMENT_FLOPS = {"sharded_ln_gelu": 20, "chain_shard_sums": 35, "chain_shard_dh": 40}
# entries 3 and 4 beyond the flagship's shards: (N, ranks) whose shards are
# ragged (25 and 50 columns: lanes past n masked) or cut into tiles (1,536)
TP_CHAIN_SHAPES = ((100, 4), (100, 2), (3072, 2))
# entry 1's kernel at its widest shard: N over 2 ranks, 768 columns a rank
TP_STATS_WIDE = 1536


def _bf16_ulp(x: float) -> float:
    """One bf16 ulp at magnitude ``x`` (8 bits of significand)."""
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def _tp_entry_bounds(m: int, k: int, n: int, size: int, el: int, whole: bool = False) -> dict:
    """(bound ms, bound by) of each entry at m rows, this rank's n of size * n
    columns, el bytes an element: every input read once, every output
    written once. ``whole``: entry 2 on linear3's whole rows (the float32
    sum and pool read, h and out written in el)."""
    fp = FP32_FLOPS
    if whole:
        return {"sharded_ln_gelu": bound(m * 2 * n * 4 + 3 * n * el + 2 * m * n * el + m * 8,
                                         TP_ELEMENT_FLOPS["sharded_ln_gelu"] * m * n, fp)}
    return {
        "fused_spectre_linear_shard_stats": bound((m * k + k * n + n + m * n) * el + m * 8,
                                                  2 * m * k * n,
                                                  BF16_FLOPS if el == 2 else FP32_FLOPS),
        "sharded_ln_gelu": bound(3 * m * n * el + 2 * n * el + size * m * 8 + m * 8,
                                 TP_ELEMENT_FLOPS["sharded_ln_gelu"] * m * n, fp),
        "chain_shard_sums": bound(2 * m * n * el + 2 * n * el + 2 * m * 8 + 2 * n * el,
                                  TP_ELEMENT_FLOPS["chain_shard_sums"] * m * n, fp),
        "chain_shard_dh": bound(3 * m * n * el + 2 * n * el + (size + 1) * m * 8 + n * el,
                                TP_ELEMENT_FLOPS["chain_shard_dh"] * m * n, fp)}


def phase_tp_entries(kernels, gen):
    """Kernel B3's four column-shard entries (slice 16) on the card: at the
    flagship's shard widths (linear1's 768 columns over 2 and 4 ranks: 384,
    192) at M = 16,640 and 66,560 rows (B = 256, 1,024), and entry 2 on
    linear3's whole rows (N = 512, the all-reduced float32 sum), bf16 and
    float32, each entry against its plain version on the same inputs; the
    shards merged through the entries against the whole-row kernel
    (``fused_spectre_linear``: wgmma in bf16, the cluster kernel in
    float32) within 1e-5 of the largest entry in float32 and one bf16 ulp
    of it in bf16; two runs of each entry bit for bit, and each rank's copy
    of the gathered row sums merged by entry 4 to the same bits. At B = 256
    also the shards of TP_CHAIN_SHAPES (ragged: 25 and 50 columns; cut into
    tiles: 1,536), entries 2, 3 and 4 timed there, and entry 2 on a whole
    row of 1,536 (three warps of a block share it); in bf16 entry 1's
    widest shard (N = 1,536 over 2 ranks, the whole row on the wide
    cluster kernel; timed) and rows that end inside a row tile of its
    kernel (B = 255). Times (bf16, 2 ranks, B = 256 is the main row; every
    shape's beside) back to back, on the device and of the plain version,
    with each entry's byte bound; entry 1's beside ``torch.addmm``."""
    e, f = 512, 768
    worst = {name: {} for name in TP_ENTRY_NAMES}
    rows, merge = {}, {}

    def held(name, dtype, got, want, tag):
        err = max(rel_to_largest(a.float(), b.float()) for a, b in zip(got, want))
        absd = max(max_abs_diff(a.float(), b.float()) for a, b in zip(got, want))
        w = worst[name].setdefault(dtype, [0.0, 0.0])
        w[0], w[1] = max(w[0], err), max(w[1], absd)
        if not err <= TP_ENTRY_REL[dtype]:
            raise AssertionError(f"{name} {tag} {dtype}: rel err {err} > {TP_ENTRY_REL[dtype]}")

    def timed(name, fn, plain, tag, bounds, library=None):
        fn()
        again = fn()
        first = fn()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(first, again) if a is not None):
            raise AssertionError(f"{name} {tag}: two runs differ")
        dev, host = queued_time_ms(fn, iters=10, reps=5)
        t = {"ms": cuda_time_ms(fn, iters=10, reps=5), "device_ms": dev, "host_ms": host,
             "plain_ms": cuda_time_ms(plain, iters=5, reps=3)}
        if library is not None:
            t["library_ms"] = cuda_time_ms(library, iters=10, reps=5)
            t["library_device_ms"] = device_time_ms(library, iters=10, reps=5)
        t["bound_ms"], t["bound_by"] = bounds[name]
        rows.setdefault(name, {})[tag] = t
        return t

    def shard_tag(dtype, batch, f, size, time_entries):
        """The four entries on ``size`` ranks' shards of a [65 batch, e] x
        [e, f] layer against their plain versions, the shards merged
        against the whole-row kernel, and the entries named in
        ``time_entries`` timed on rank 0's shard."""
        el, m, n = dtype.itemsize, 65 * batch, f // size
        tag = f"{'bf16' if dtype == torch.bfloat16 else 'f32'}_B{batch}_n{n}"
        x = torch.randn(m, e, generator=gen).to("cuda", dtype)
        w = (torch.randn(e, f, generator=gen) * e ** -0.5).to("cuda", dtype)
        b, beta = ((torch.randn(f, generator=gen) * 0.1).to("cuda", dtype) for _ in range(2))
        gamma = (1 + torch.randn(f, generator=gen) * 0.1).to("cuda", dtype)
        pool = torch.randn(m, f, generator=gen).to("cuda", dtype)
        gy = torch.randn(m, f, generator=gen).to("cuda", dtype)
        whole = kernels.fused_spectre_linear(x, w, b, gamma, beta)
        bounds = _tp_entry_bounds(m, e, n, size, el)
        cols = [slice(r * n, (r + 1) * n) for r in range(size)]
        ws = [w[:, c].contiguous() for c in cols]
        bs, gs, bes = ([t[c].contiguous() for c in cols] for t in (b, gamma, beta))
        pools = [pool[:, c] for c in cols]
        gys = [gy[:, c].contiguous() for c in cols]
        firsts = [kernels.fused_spectre_linear_shard_stats(x, ws[r], bs[r]) for r in range(size)]
        for r in range(size):
            hp, sp = kernels.shard_stats_plain(x, ws[r], bs[r])
            held("fused_spectre_linear_shard_stats", dtype,
                 [firsts[r][0], firsts[r][1][:, 0], firsts[r][1][:, 1]],
                 [hp, sp[:, 0], sp[:, 1]], tag)
        stats = torch.stack([st for _, st in firsts])
        outs = [kernels.sharded_ln_gelu(firsts[r][0], stats, gs[r], bes[r], f,
                                        residual=pools[r]) for r in range(size)]
        for r in range(size):
            want = kernels.sharded_ln_gelu_plain(firsts[r][0], stats, gs[r], bes[r], f,
                                                 residual=pools[r])
            held("sharded_ln_gelu", dtype, outs[r][:2], want[:2], tag)
            if not torch.equal(outs[r][1], outs[0][1]):
                raise AssertionError(f"sharded_ln_gelu {tag}: rank {r}'s merged "
                                     "statistics differ from rank 0's")
        sums = [kernels.chain_shard_sums(firsts[r][0], gys[r], gs[r], bes[r], outs[r][1])
                for r in range(size)]
        for r in range(size):
            want = kernels.chain_shard_sums_plain(firsts[r][0], gys[r], gs[r], bes[r],
                                                  outs[r][1])
            held("chain_shard_sums", dtype, sums[r], want, tag)
        rowsums = torch.stack([rs for rs, _ in sums])
        for r in range(size):
            got = kernels.chain_shard_dh(firsts[r][0], gys[r], gs[r], bes[r], outs[r][1],
                                         rowsums, f)
            want = kernels.chain_shard_dh_plain(firsts[r][0], gys[r], gs[r], bes[r],
                                                outs[r][1], rowsums, f)
            held("chain_shard_dh", dtype, got, want, tag)
            # each rank merges its own copy of the gathered row sums (as an
            # all-gather hands them out) to the same bits
            mine = kernels.chain_shard_dh(firsts[r][0], gys[r], gs[r], bes[r], outs[r][1],
                                          rowsums.clone(), f)
            if not all(torch.equal(a, c) for a, c in zip(got, mine)):
                raise AssertionError(f"chain_shard_dh {tag}: rank {r}'s copy of the row "
                                     "sums merges to other bits")
        # the shards merged against the whole row (no residual there)
        bare = [kernels.sharded_ln_gelu(firsts[r][0], stats, gs[r], bes[r], f)[0]
                for r in range(size)]
        merged = torch.cat(bare, 1)
        top = float(whole.float().abs().max())
        diff = max_abs_diff(merged.float(), whole.float())
        limit = 1e-5 * top if dtype == torch.float32 else _bf16_ulp(top)
        merge[tag] = {"max_abs_diff": diff, "limit": limit, "largest": top}
        if not diff <= limit:
            raise AssertionError(f"shards {tag} merged vs the whole-row kernel: "
                                 f"{diff} > {limit}")
        h0, ms0 = firsts[0][0], outs[0][1]
        calls = {
            "fused_spectre_linear_shard_stats": (
                lambda: kernels.fused_spectre_linear_shard_stats(x, ws[0], bs[0]),
                lambda: kernels.shard_stats_plain(x, ws[0], bs[0])),
            "sharded_ln_gelu": (
                lambda: kernels.sharded_ln_gelu(h0, stats, gs[0], bes[0], f, residual=pools[0]),
                lambda: kernels.sharded_ln_gelu_plain(h0, stats, gs[0], bes[0], f,
                                                      residual=pools[0])),
            "chain_shard_sums": (
                lambda: kernels.chain_shard_sums(h0, gys[0], gs[0], bes[0], ms0),
                lambda: kernels.chain_shard_sums_plain(h0, gys[0], gs[0], bes[0], ms0)),
            "chain_shard_dh": (
                lambda: kernels.chain_shard_dh(h0, gys[0], gs[0], bes[0], ms0, rowsums, f),
                lambda: kernels.chain_shard_dh_plain(h0, gys[0], gs[0], bes[0], ms0, rowsums,
                                                     f))}
        for name in TP_ENTRY_NAMES:
            if name in time_entries:
                # entry 1 beside torch.addmm(b, x, w), h alone without the statistics
                library = ((lambda: torch.addmm(bs[0], x, ws[0])) if name == TP_ENTRY_NAMES[0]
                           else None)
                timed(name, *calls[name], tag, bounds, library)
            else:  # two runs bit for bit all the same
                fn = calls[name][0]
                first, again = fn(), fn()
                if not all(torch.equal(a, c) for a, c in zip(first, again) if a is not None):
                    raise AssertionError(f"{name} {tag}: two runs differ")

    def whole_rows(dtype, batch, n):
        """Entry 2 on linear3's whole rows: [65 batch, f] x [f, n] summed in
        float32 beside the pool's partials, against its plain version."""
        m = 65 * batch
        w3 = (torch.randn(f, n, generator=gen) * f ** -0.5).to("cuda", dtype)
        b3, be3 = ((torch.randn(n, generator=gen) * 0.1).to("cuda", dtype) for _ in range(2))
        g3 = (1 + torch.randn(n, generator=gen) * 0.1).to("cuda", dtype)
        hin = torch.randn(m, f, generator=gen).to("cuda", dtype)
        s2 = torch.cat([kernels.matmul_f32(hin, w3), torch.randn(m, n, generator=gen)
                        .to("cuda")], 1)
        tag = f"{'bf16' if dtype == torch.bfloat16 else 'f32'}_B{batch}_rows{n}"
        got = kernels.sharded_ln_gelu(s2[:, :n], None, g3, be3, n, bias=b3, residual=s2[:, n:])
        want = kernels.sharded_ln_gelu_plain(s2[:, :n], None, g3, be3, n, bias=b3,
                                             residual=s2[:, n:])
        held("sharded_ln_gelu", dtype, got, want, tag)
        timed("sharded_ln_gelu",
              lambda: kernels.sharded_ln_gelu(s2[:, :n], None, g3, be3, n, bias=b3,
                                              residual=s2[:, n:]),
              lambda: kernels.sharded_ln_gelu_plain(s2[:, :n], None, g3, be3, n, bias=b3,
                                                    residual=s2[:, n:]),
              tag, _tp_entry_bounds(m, f, n, 1, dtype.itemsize, whole=True))
        del hin, s2, got, want
        torch.cuda.empty_cache()

    for dtype in (torch.bfloat16, torch.float32):
        for batch in (256, 1024):
            for size in (2, 4):
                shard_tag(dtype, batch, f, size,
                          TP_ENTRY_NAMES if dtype == torch.bfloat16 or batch == 256 else ())
                torch.cuda.empty_cache()
            if batch == 256:
                # entries 2, 3 and 4 where the plan masks lanes past a
                # ragged shard (the head's N = 100 over 4 and 2 ranks) and
                # where it cuts a row into tiles (N = 3,072 over 2 ranks)
                for n_full, size in TP_CHAIN_SHAPES:
                    shard_tag(dtype, batch, n_full, size, TP_ENTRY_NAMES[1:])
                    torch.cuda.empty_cache()
            if batch == 256 and dtype == torch.bfloat16:
                # entry 1's kernel at four column tiles a row tile (N = 1,536
                # over 2 ranks, timed) and at rows that end inside a row
                # tile of 128 (B = 255: 16,575 rows)
                shard_tag(dtype, batch, TP_STATS_WIDE, 2, TP_ENTRY_NAMES[:1])
                shard_tag(dtype, 255, f, 2, ())
                torch.cuda.empty_cache()
            # linear3: entry 2 on whole rows of the all-reduced float32 sum [M, 2N]
            # (the product's and the pool's partials side by side); at B = 256
            # also a whole row wider than a warp's registers
            for n in (e, 1536) if batch == 256 else (e,):
                whole_rows(dtype, batch, n)
    main_tag = "bf16_B256_n384"
    out = []
    for name in TP_ENTRY_NAMES:
        main = rows[name][main_tag]
        for tag, t in rows[name].items():
            print(f"tp entry {name} {tag}: {t['ms']:.4f} ms back to back, {t['device_ms']:.4f} "
                  f"on the device ({t['device_ms'] and t['bound_ms'] / t['device_ms']:.2f} of "
                  f"the bound {t['bound_ms']:.4f} ms by {t['bound_by']}); plain "
                  f"{t['plain_ms']:.4f} ms", flush=True)
        src = "fused_spectre_linear" if name in TP_ENTRY_NAMES[:2] else "fused_spectre_linear_bwd"
        out.append({"name": name, "route": "cuda", "source": f"spectre_tpu_torch/csrc/{src}.cu",
                    "replaces": "spectre_tpu/ops/pallas/fused_linear.py:"
                                + ("94" if name in TP_ENTRY_NAMES[:2] else "147"),
                    "max_abs_err": worst[name][torch.bfloat16][1],
                    "max_rel_err": worst[name][torch.bfloat16][0],
                    "max_rel_err_f32": worst[name][torch.float32][0],
                    "ms": main["ms"], "device_ms": main["device_ms"],
                    "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                    "bound_by": main["bound_by"], "library_ms": main.get("library_ms"),
                    "library": "none: the plain version's torch ops",
                    "times": rows[name],
                    "shape": "x [16640, 512] bf16, this rank's 384 of 768 columns (2 ranks); "
                             "max_rel_err: relative to each result's largest entry"})
    # entry 1 in bf16 runs its own kernel; addmm computes h alone, without the
    # statistics
    out[0].update(kernel="shard_stats_wgmma_kernel",
                  library="torch.addmm(b, x, w): h alone, no statistics",
                  library_device_ms=rows[TP_ENTRY_NAMES[0]][main_tag]["library_device_ms"])
    for tag, mg in merge.items():
        print(f"tp entries: shards {tag} merged against the whole-row kernel: max abs diff "
              f"{mg['max_abs_diff']:.3g} (limit {mg['limit']:.3g}, largest entry "
              f"{mg['largest']:.3g})", flush=True)
    out[1]["shard_merge"] = merge
    return out


# phase 27: parallelism
PARALLEL_STEPS = 8
GLOO_STEPS = 3
GLOO_BATCH = 256  # global: 128 a rank
# FSDP's loss curve at one rank against the unwrapped trainer's: the forward
# and AdamW are bitwise the same (measured), and so is every gradient except
# those of cls_token and position_embeddings, which sum the encoder's global
# residual and the layers' path: FSDP2's hooks on each layer's input make
# autograd add those in another order. The last bits so moved grow through
# AdamW; the limit is a quarter of one bf16 ulp (2^-8) of the loss, about 25
# times the largest difference measured over 8 steps.
FSDP_CURVE_REL = 2.0 ** -10
# the 2-rank loss against one process at the same global batch: each rank
# draws its own dropout masks (p = 0.001), and the gradient's sum runs in
# another order; the train phase's gradient limit
GLOO_LOSS_REL = TRAIN_GRAD_REL


LAYOUT_TRACE_STEPS = 3


def _layout_trace(step, state, x, y, logdir: str) -> dict:
    """One layout's step under ``trace_step``, after 2 untraced ones: ms a
    step by CUDA events, the card's busy ms a step (the union of its
    kernels, copies and fills in the trace), its idle share, and the
    trace's rows by name (``ProfilerParser``)."""
    from spectre_tpu_torch.profile import ProfilerParser, trace_step
    from spectre_tpu_torch.profile.parser import DEVICE_CATEGORIES

    for _ in range(2):
        step(state, x, y)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with trace_step(logdir, "cuda") as t:
        start.record()
        for _ in range(LAYOUT_TRACE_STEPS):
            step(state, x, y)
        end.record()
        torch.cuda.synchronize()
    with open(t.trace_file) as f:
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in json.load(f)["traceEvents"]
                       if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES)
    busy_us, reach = 0.0, float("-inf")
    for a, b in spans:
        if b > reach:
            busy_us += b - max(a, reach)
            reach = b
    ms = start.elapsed_time(end) / LAYOUT_TRACE_STEPS
    busy = busy_us / 1e3 / LAYOUT_TRACE_STEPS
    return {"ms": ms, "busy_ms": busy, "idle": 1.0 - busy / ms, "kernels": len(spans)
            / LAYOUT_TRACE_STEPS, "rows": {r["name"]: r for r in ProfilerParser(t.trace_file).rows}}


def _trace_diff(base: dict, other: dict, key: str, top: int = 8) -> list:
    """The ``top`` rows whose ``key`` (ms) grew most a step from ``base`` to
    ``other``: (ms a step, calls a step, name)."""
    grown = []
    for name in set(base["rows"]) | set(other["rows"]):
        a, b = base["rows"].get(name, {}), other["rows"].get(name, {})
        d = (b.get(key, 0.0) - a.get(key, 0.0)) / LAYOUT_TRACE_STEPS
        if d > 0:
            grown.append((round(d, 4), (b.get("calls", 0) - a.get("calls", 0))
                          / LAYOUT_TRACE_STEPS, name[:120]))
    return sorted(grown, reverse=True)[:top]


def _step_losses(logdir: str) -> list[float]:
    """The per-step training losses a run wrote to its events file."""
    with open(os.path.join(logdir, "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    return [e["value"] for e in events if e["tag"] == "Loss/Train"]


def _torchrun(nproc: int, args: list, timeout: int = 300) -> None:
    """Run this script under torchrun on ``nproc`` ranks; raise with the
    ranks' output when it fails."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), os.path.abspath(__file__), *args]
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    if r.returncode != 0:
        raise AssertionError(f"torchrun {' '.join(args[:2])} exited {r.returncode}:\n"
                             f"{r.stdout[-4000:]}\n{r.stderr[-6000:]}")


def rank_train(out: str, argv: list) -> None:
    """One torchrun rank of phase 27's CLI legs: ``repl/train.py``'s main with
    ``argv`` (which holds ``--multihost``); rank 0 writes its launches."""
    from spectre_tpu_torch.ops import kernels
    from spectre_tpu_torch.repl import train as train_cli

    kernels.reset_launch_counts()
    result = train_cli.main(argv)
    if int(os.environ.get("RANK", 0)) == 0:
        with open(out, "w") as f:
            json.dump({"launches": kernels.launch_counts(), "step": result.state.step,
                       "logdir": result.logdir, "layout": result.state.layout.kind}, f)


def rank_gloo(out: str) -> None:
    """One of 2 torchrun ranks on the one card over gloo: the flagship's
    step under DDP, then under FSDP, on this rank's half of a global batch,
    exact launches, the audit's signature; rank 0 writes the losses."""
    import torch.distributed as dist

    from spectre_tpu_torch.configs import parse_config
    from spectre_tpu_torch.data import make_eval_transform
    from spectre_tpu_torch.ops import kernels
    from spectre_tpu_torch.parallel import (assert_dp_signature, assert_fsdp_signature,
                                            collective_counts, create_mesh, init_distributed,
                                            local_rows, parallelize)
    from spectre_tpu_torch.train import make_train_step
    from spectre_tpu_torch.train.loop import create_trainer, dataset_stats

    init_distributed(device="cuda", backend="gloo", local_rank=0)
    cfg = parse_config(CONFIG)
    mesh = create_mesh(device_type="cuda")
    raw, y = _train_batch(cfg, GLOO_BATCH)
    rows = local_rows(mesh, GLOO_BATCH)
    x, y = make_eval_transform(*dataset_stats(cfg.dataset))(raw)[rows], y[rows]
    step = make_train_step(grad_clip_norm=cfg.grad_clip_norm)
    result = {}
    for kind in ("ddp", "fsdp"):
        state = parallelize(create_trainer(cfg, "cuda", steps_per_epoch=16), mesh,
                            fsdp=kind == "fsdp", seed=cfg.random_seed)
        t0 = time.perf_counter()
        kernels.reset_launch_counts()
        losses = [step(state, x, y)["loss"].item() for _ in range(GLOO_STEPS)]
        counts = kernels.launch_counts()
        audit = collective_counts(step, state, x, y)
        (assert_fsdp_signature if kind == "fsdp" else assert_dp_signature)(audit)
        result[kind] = {"losses": losses, "launches": counts, "audit": audit,
                        "rows": rows.stop - rows.start,
                        "s_per_step_host": (time.perf_counter() - t0) / (GLOO_STEPS + 1)}
        del state
    if dist.get_rank() == 0:
        with open(out, "w") as f:
            json.dump(result, f)
    dist.destroy_process_group()


def phase_parallel(kernels, train_cli, parse_config, tmp: str) -> dict:
    """The flagship through the parallel layouts: the training CLI under
    torchrun (one rank, NCCL) with DDP and with FSDP against the unwrapped
    CLI, per-step losses and exact launches; 2 ranks on the one card over
    gloo, DDP and FSDP, against one process; then ms per step, peak memory
    and the audit's counts of the three layouts in this process."""
    from spectre_tpu_torch.data import make_eval_transform
    from spectre_tpu_torch.parallel import collective_counts, create_mesh, init_distributed, \
        parallelize
    from spectre_tpu_torch.train import make_train_step
    from spectre_tpu_torch.train.loop import create_trainer, dataset_stats

    cfg = parse_config(CONFIG)
    val_batches = -(-1024 // cfg.val_batch_size)
    want = expected_launches(cfg, forwards=val_batches, steps=PARALLEL_STEPS)
    common = ["--config", CONFIG, "--synthetic", "--steps", str(PARALLEL_STEPS),
              "--no-checkpoint", "--set", "epochs=1", "log_every=1"]
    out = {"launches": {}, "losses": {}}

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    plain = train_cli.main(common + [f"checkpoint_dir={os.path.join(tmp, 'par_none')}"])
    out["cli_s"] = {"none": time.perf_counter() - t0}
    out["launches"]["none"] = kernels.launch_counts()
    out["losses"]["none"] = _step_losses(plain.logdir)
    for kind, extra in (("ddp", []), ("fsdp", ["fsdp=True"])):
        path = os.path.join(tmp, f"par_{kind}.json")
        t0 = time.perf_counter()
        _torchrun(1, ["--rank-train", path, "--multihost", *common, *extra,
                      f"checkpoint_dir={os.path.join(tmp, 'par_' + kind)}"])
        out["cli_s"][kind] = time.perf_counter() - t0
        with open(path) as f:
            rank0 = json.load(f)
        layout = {"ddp": "dp"}.get(kind, kind)
        if rank0["layout"] != layout or rank0["step"] != PARALLEL_STEPS:
            raise AssertionError(f"parallel {kind}: ran {rank0}")
        out["launches"][kind] = rank0["launches"]
        out["losses"][kind] = _step_losses(rank0["logdir"])
    for kind, counts in out["launches"].items():
        if counts != want:
            raise AssertionError(f"parallel {kind}: {PARALLEL_STEPS} steps + {val_batches} "
                                 f"validation batches launched {counts}, want {want}")
    plain_curve = np.asarray(out["losses"]["none"])
    for kind in ("ddp", "fsdp"):
        curve = np.asarray(out["losses"][kind])
        rel = np.abs(curve - plain_curve) / np.abs(plain_curve) if len(curve) == \
            PARALLEL_STEPS else np.array([np.inf])
        out[f"curve_rel_{kind}"] = float(rel.max())
        # DDP bit for bit; FSDP bit for bit at step 1 (the same weights) and
        # within FSDP_CURVE_REL after
        ok = rel.max() == 0 if kind == "ddp" else \
            (rel[0] == 0 and rel.max() <= FSDP_CURVE_REL)
        if not ok:
            raise AssertionError(f"parallel {kind}: loss curve {curve.tolist()} against the "
                                 f"unwrapped trainer's {plain_curve.tolist()}: rel {rel}")
    print(f"parallel: repl/train.py --multihost under torchrun (1 rank, NCCL), DDP and "
          f"FSDP: {PARALLEL_STEPS} steps + {val_batches} validation batches launched "
          f"exactly {want} each; the unwrapped CLI's per-step losses {plain_curve.tolist()}, "
          f"DDP's bit for bit, FSDP's {out['losses']['fsdp']} (step 1 bit for bit, worst "
          f"rel {out['curve_rel_fsdp']:.3g}, limit {FSDP_CURVE_REL:.3g}); wall s "
          f"{out['cli_s']}", flush=True)

    # 2 ranks on the one card, gloo on card tensors
    normalize = make_eval_transform(*dataset_stats(cfg.dataset))
    state = create_trainer(cfg, "cuda", steps_per_epoch=16)
    raw, y = _train_batch(cfg, GLOO_BATCH)
    x = normalize(raw)
    step = make_train_step(grad_clip_norm=cfg.grad_clip_norm)
    single = [step(state, x, y)["loss"].item() for _ in range(GLOO_STEPS)]
    del state
    out["gloo"] = {"single_losses": single}
    path = os.path.join(tmp, "gloo.json")
    t0 = time.perf_counter()
    _torchrun(2, ["--rank-gloo", path])
    out["gloo"]["wall_s"] = time.perf_counter() - t0
    with open(path) as f:
        legs = json.load(f)
    for kind in ("ddp", "fsdp"):
        r = legs[kind]
        rel = abs(r["losses"][-1] - single[-1]) / abs(single[-1])
        rank_want = expected_launches(cfg, steps=GLOO_STEPS)
        if r["launches"] != rank_want or not rel <= GLOO_LOSS_REL:
            raise AssertionError(f"gloo {kind}: launches {r['launches']} (want {rank_want}), "
                                 f"loss {r['losses']} vs one process {single}: rel {rel}")
        r["loss_rel"] = rel
        out["gloo"][kind] = r
        print(f"parallel: 2 ranks on one card over gloo, {kind}, {r['rows']} rows a rank: "
              f"losses {r['losses']} vs one process at batch {GLOO_BATCH} {single} (step "
              f"{GLOO_STEPS} rel {rel:.3g}, limit {GLOO_LOSS_REL}); launches a rank "
              f"{r['launches']}; audit of a step {r['audit']} (signature held); "
              f"{r['s_per_step_host']:.3f} s a step (host clock)", flush=True)

    # ms per step, peak memory and collectives of the three layouts, one rank
    # (NCCL) in this process
    init_distributed(device="cuda")
    try:
        states = {}
        for kind in ("none", "ddp", "fsdp"):
            st = create_trainer(cfg, "cuda", steps_per_epoch=16)
            if kind != "none":
                parallelize(st, create_mesh(device_type="cuda"), fsdp=kind == "fsdp",
                            seed=cfg.random_seed)
            states[kind] = st
        timings, audits = {}, {}
        for batch in (256, 1024):
            rawb, yb = _train_batch(cfg, batch)
            xb = normalize(rawb)
            ms = {k: [] for k in states}
            for kind in ("none", "ddp", "fsdp", "fsdp", "ddp", "none"):
                ms[kind].append(cuda_time_ms(lambda: step(states[kind], xb, yb), iters=1,
                                             reps=5))
            peak = {}
            for kind, st in states.items():
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                step(st, xb, yb)
                torch.cuda.synchronize()
                peak[kind] = (torch.cuda.max_memory_allocated() - base) / 1e9
            timings[batch] = {k: {"ms": min(v), "ms_turns": v, "step_peak_gb": peak[k]}
                              for k, v in ms.items()}
            for kind in ("ddp", "fsdp"):
                timings[batch][kind]["overhead_ms"] = min(ms[kind]) - min(ms["none"])
            print(f"parallel: B={batch} ms/step (CUDA events, median of 5, the lesser of two "
                  f"turns none/ddp/fsdp/fsdp/ddp/none): "
                  + ", ".join(f"{k} {min(v):.3f}" for k, v in ms.items())
                  + "; step's peak above the resident state GB: "
                  + ", ".join(f"{k} {v:.3f}" for k, v in peak.items()), flush=True)
            del rawb, xb, yb
        xs, ys = _train_batch(cfg, 256)
        xs = normalize(xs)
        for kind in ("ddp", "fsdp"):
            audits[kind] = collective_counts(step, states[kind], xs, ys)
        print(f"parallel: one rank, collectives of a step: {audits} (FSDP2 issues none at one "
              "rank; the 2-rank gloo legs show its all-gathers and reduce-scatters)",
              flush=True)
        # where a layout's cost goes: each step traced at B=256
        traces = {k: _layout_trace(step, st, xs, ys, os.path.join(tmp, f"trace_{k}"))
                  for k, st in states.items()}
        for kind in ("ddp", "fsdp"):
            tr = traces[kind]
            tr["device_grown"] = _trace_diff(traces["none"], tr, "device_total_ms")
            tr["host_grown"] = _trace_diff(traces["none"], tr, "host_total_ms", top=12)
        for kind, tr in traces.items():
            # the profiler's own host cost idles the card in every layout:
            # the untraced step's idle share takes its busy time over the
            # untraced ms/step above
            tr["idle_untraced"] = 1.0 - tr["busy_ms"] / timings[256][kind]["ms"]
            print(f"parallel: traced B=256 step, {kind}: {tr['ms']:.3f} ms (CUDA events, "
                  f"{LAYOUT_TRACE_STEPS} steps under the profiler), the card busy "
                  f"{tr['busy_ms']:.3f} ms in {tr['kernels']:.0f} kernels/copies, idle "
                  f"{tr['idle']:.3f} traced, {tr['idle_untraced']:.3f} against the untraced "
                  f"{timings[256][kind]['ms']:.3f} ms", flush=True)
            if kind != "none":
                print(f"parallel: {kind} over none, device rows grown (ms, calls a step, "
                      f"name): {tr['device_grown']}", flush=True)
                print(f"parallel: {kind} over none, host rows grown (nested spans; ms, calls "
                      f"a step, name): {tr['host_grown']}", flush=True)
        out["traces"] = {k: {n: v for n, v in tr.items() if n != "rows"}
                         for k, tr in traces.items()}
        out["timings"], out["audit_one_rank"] = timings, audits
        del states
    finally:
        torch.distributed.destroy_process_group()
    torch.cuda.empty_cache()
    return out


# phase 28: tensor parallelism on the card (slice 16), model axis of 2 (4
# ranks with FSDP), every rank on the one card over gloo on card tensors
TP_STEPS = 3
TP_FSDP_LAYERS = 2
# (b): one float32 forward and backward of the flagship, 1 x 2 against one
# process, the same dropout masks: sums in another order only (the partial
# products, the statistics' merge, the gradients' products)
TP_F32_LOSS_REL = 1e-5
TP_F32_GRAD_REL = 1e-4


def expected_tp_launches(cfg, forwards: int = 0, steps: int = 0, size: int = 2) -> dict:
    """Launches a rank of ``forwards`` inference forwards plus ``steps`` train
    steps of the configured model (SpectreViT with the folded block mix, or
    the ViT) under tensor parallelism over ``size`` ranks: each layer's
    linear1 on the column-shard entries (entry 1 on its own bf16 kernel
    where it takes the shard), its linear3 on entry 2 and kernel 2's backward, the
    head whole; the ViT's attention on this rank's heads."""
    from spectre_tpu_torch.ops.kernels import forward_kernel, shard_stats_kernel

    layers, both = cfg.num_encoders, forwards + steps
    counts = dict.fromkeys(KERNEL_NAMES, 0)
    if cfg.model == "vit":
        counts.update(flash_attention_fwd=layers * both, flash_attention_bwd=layers * steps)
        return counts
    dtype = getattr(torch, cfg.compute_dtype)
    counts.update(block_scatter_rows=layers * both, block_gather_sum=layers * steps,
                  fused_spectre_linear_shard_stats=layers * both,
                  sharded_ln_gelu=2 * layers * both, chain_shard_sums=layers * steps,
                  chain_shard_dh=layers * steps, fused_spectre_linear=both,
                  fused_spectre_linear_bwd=(layers + 1) * steps)
    counts[shard_stats_kernel(dtype, cfg.embed_dim, cfg.hidden_dim // size)] += layers * both
    counts[forward_kernel(dtype, cfg.embed_dim, cfg.num_classes)] += both
    return counts


def rank_tp(out: str) -> None:
    """One of 2 torchrun ranks on the one card over gloo, tensor parallelism
    1 x 2: (b) one float32 forward and backward of the flagship against the
    same in one process (loss, every leaf's gradient, the split ones
    gathered), the audit of a bf16 step; the bf16 flagship's step traced at
    B=256 (ms a step, the card's busy share); (c) the ViT at full width,
    TP_STEPS steps against one process. Rank 0 writes the results."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from spectre_tpu_torch.configs import parse_config
    from spectre_tpu_torch.data import make_eval_transform
    from spectre_tpu_torch.ops import kernels
    from spectre_tpu_torch.parallel import (SPECTRE_TP_RULES, VIT_TP_RULES, collective_counts,
                                            create_mesh, init_distributed, parallelize)
    from spectre_tpu_torch.train import make_train_step
    from spectre_tpu_torch.train.loop import create_trainer, dataset_stats

    faulthandler.enable()  # a crash in a rank prints its Python stack
    init_distributed(device="cuda", backend="gloo", local_rank=0)
    mesh = create_mesh(1, 2, device_type="cuda")
    result = {}

    def stage(what):
        print(f"rank {dist.get_rank()}: {what}", file=sys.stderr, flush=True)

    def tp_state(cfg, rules):
        return parallelize(create_trainer(cfg, "cuda", steps_per_epoch=16), mesh,
                           tp_rules=rules, seed=cfg.random_seed)

    stage("(b) float32, one process")
    cfg = parse_config(CONFIG)
    cfg.compute_dtype = "float32"
    raw, y = _train_batch(cfg, GLOO_BATCH)
    x = make_eval_transform(*dataset_stats(cfg.dataset))(raw)
    single = create_trainer(cfg, "cuda", steps_per_epoch=16)
    loss1, grads1 = _backward_once(single, x, y, seed=5)
    del single
    stage("(b) float32, 1 x 2")
    state = tp_state(cfg, SPECTRE_TP_RULES)
    kernels.reset_launch_counts()
    loss2, grads2 = _backward_once(state, x, y, seed=5)
    counts = kernels.launch_counts()
    def gathered(g):
        """A split gradient whole: the ranks' shards by ``dist.all_gather``
        (``DTensor.full_tensor``'s functional collectives crash under gloo
        on card tensors)."""
        loc = g.to_local().contiguous()
        parts = [torch.empty_like(loc) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, loc)
        return torch.cat(parts, next(p.dim for p in g.placements if p.is_shard()))

    errs = {}
    for name, g in grads2.items():
        split = isinstance(g, DTensor) and any(p.is_shard() for p in g.placements)
        g = gathered(g) if split else g
        errs[name] = (rel_to_largest(g, grads1[name]), split)
    result["f32"] = {"loss_single": loss1, "loss_tp": loss2,
                     "loss_rel": abs(loss2 - loss1) / abs(loss1), "launches": counts,
                     "grad_rel_split": max(e for e, sp in errs.values() if sp),
                     "grad_rel_whole": max(e for e, sp in errs.values() if not sp),
                     "split_leaves": sum(sp for _, sp in errs.values()),
                     "worst": max(errs, key=lambda n: errs[n][0])}
    del state, grads1, grads2
    stage("bf16: the audit and the traced step")
    cfg = parse_config(CONFIG)
    x = make_eval_transform(*dataset_stats(cfg.dataset))(raw)
    state = tp_state(cfg, SPECTRE_TP_RULES)
    step = make_train_step(grad_clip_norm=cfg.grad_clip_norm)
    result["audit"] = collective_counts(step, state, x, y)
    stage("bf16: traced")
    tmp = os.path.dirname(out)
    result["trace"] = {k: v for k, v in _layout_trace(
        step, state, x, y, os.path.join(tmp, f"trace_tp{dist.get_rank()}")).items()
        if k != "rows"}
    del state
    stage("(c) the ViT")
    cfg = parse_config(VIT_CONFIG)
    x = make_eval_transform(*dataset_stats(cfg.dataset))(raw)
    step = make_train_step(grad_clip_norm=cfg.grad_clip_norm)
    single = create_trainer(cfg, "cuda", steps_per_epoch=16)
    losses1 = [step(single, x, y)["loss"].item() for _ in range(TP_STEPS)]
    del single
    state = tp_state(cfg, VIT_TP_RULES)
    kernels.reset_launch_counts()
    losses2 = [step(state, x, y)["loss"].item() for _ in range(TP_STEPS)]
    result["vit"] = {"losses_single": losses1, "losses_tp": losses2,
                     "launches": kernels.launch_counts(),
                     "audit": collective_counts(step, state, x, y)}
    if dist.get_rank() == 0:
        with open(out, "w") as f:
            json.dump(result, f)
    dist.destroy_process_group()


def phase_tp(parse_config, tmp: str, parallel: dict) -> dict:
    """Tensor parallelism on the card, every rank on the one H100 over gloo
    on card tensors: (a) the flagship 1 x 2 at full width through
    ``repl/train.py --multihost --backend gloo --set model_parallel=2`` under
    torchrun, TP_STEPS steps and the validation pass: exact launches a rank
    (the four shard entries among them), the per-step losses within
    GLOO_LOSS_REL of the unwrapped CLI's (phase 27) with dropout as the
    config ships it; (b) one float32 step against one process and the
    audit's TP signature, (c) the ViT 1 x 2 (``--rank-tp``); (d) FSDP x TP
    2 x 2 on 4 ranks at TP_FSDP_LAYERS layers through the CLI against FSDP
    alone on the same 2 data ranks (the same slices and dropout seeds)."""
    from spectre_tpu_torch.parallel import assert_tp_signature

    cfg = parse_config(CONFIG)
    val_batches = -(-1024 // cfg.val_batch_size)
    common = ["--config", CONFIG, "--synthetic", "--steps", str(TP_STEPS), "--no-checkpoint",
              "--set", "epochs=1", "log_every=1"]
    out = {}

    def cli(name, nproc, extra, want):
        path = os.path.join(tmp, f"tp_{name}.json")
        t0 = time.perf_counter()
        _torchrun(nproc, ["--rank-train", path, "--multihost", "--backend", "gloo", *common,
                          *extra, f"checkpoint_dir={os.path.join(tmp, 'tp_' + name)}"],
                  timeout=600)
        wall = time.perf_counter() - t0
        with open(path) as f:
            rank0 = json.load(f)
        if rank0["step"] != TP_STEPS or rank0["launches"] != want:
            raise AssertionError(f"tp {name}: ran to step {rank0['step']}, layout "
                                 f"{rank0['layout']}, launches {rank0['launches']}, want {want}")
        return {"layout": rank0["layout"], "launches": rank0["launches"], "wall_s": wall,
                "losses": _step_losses(rank0["logdir"])}

    def against(name, losses, ref):
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
        if len(losses) != TP_STEPS or not max(rel) <= GLOO_LOSS_REL:
            raise AssertionError(f"tp {name}: losses {losses} against one process {ref}: "
                                 f"rel {rel} (limit {GLOO_LOSS_REL})")
        return max(rel)

    # (a) the flagship 1 x 2
    want = expected_tp_launches(cfg, forwards=val_batches, steps=TP_STEPS)
    a = cli("flagship", 2, ["model_parallel=2"], want)
    ref = parallel["losses"]["none"][:TP_STEPS]
    a["loss_rel"] = against("flagship", a["losses"], ref)
    out["flagship"] = a
    print(f"tp (a): repl/train.py --multihost --backend gloo, model_parallel=2, 2 ranks on "
          f"one card, the flagship at full width (bf16, B={cfg.batch_size}): {TP_STEPS} steps "
          f"+ {val_batches} validation batches launched exactly {want} a rank; losses "
          f"{a['losses']} against the unwrapped CLI's {ref} (worst rel {a['loss_rel']:.3g}, "
          f"limit {GLOO_LOSS_REL}); wall {a['wall_s']:.1f} s", flush=True)

    # (b), (c) and the trace: the step functions on 2 ranks
    path = os.path.join(tmp, "tp_ranks.json")
    t0 = time.perf_counter()
    _torchrun(2, ["--rank-tp", path], timeout=600)
    with open(path) as f:
        ranks = json.load(f)
    ranks["wall_s"] = time.perf_counter() - t0
    f32 = ranks["f32"]
    cfg32 = parse_config(CONFIG)
    cfg32.compute_dtype = "float32"
    want32 = expected_tp_launches(cfg32, steps=1)
    if f32["launches"] != want32 or not f32["loss_rel"] <= TP_F32_LOSS_REL \
            or not f32["grad_rel_split"] <= TP_F32_GRAD_REL or f32["split_leaves"] == 0:
        raise AssertionError(f"tp (b) float32: {f32} (launches want {want32}; loss rel limit "
                             f"{TP_F32_LOSS_REL}, split gradients {TP_F32_GRAD_REL})")
    assert_tp_signature(ranks["audit"], parallel["gloo"]["ddp"]["audit"],
                        column_layers=cfg.num_encoders)
    print(f"tp (b): one float32 forward and backward of the flagship, 1 x 2 against one "
          f"process: loss {f32['loss_tp']} vs {f32['loss_single']} (rel {f32['loss_rel']:.3g}, "
          f"limit {TP_F32_LOSS_REL}); the {f32['split_leaves']} split leaves' gradients "
          f"gathered within {f32['grad_rel_split']:.3g} of their largest entries (limit "
          f"{TP_F32_GRAD_REL}), the whole leaves' within {f32['grad_rel_whole']:.3g} (worst "
          f"{f32['worst']}); launches {f32['launches']}; audit of a bf16 step "
          f"{ranks['audit']} against the 2-rank DDP step's "
          f"{parallel['gloo']['ddp']['audit']} (TP signature held)", flush=True)
    tr = ranks["trace"]
    print(f"tp: traced B={GLOO_BATCH} bf16 step, 1 x 2 on one card, rank 0: {tr['ms']:.3f} ms "
          f"a step (CUDA events, {LAYOUT_TRACE_STEPS} steps under the profiler; both ranks' "
          f"work shares the card), rank 0's kernels busy {tr['busy_ms']:.3f} ms in "
          f"{tr['kernels']:.0f} kernels/copies, idle {tr['idle']:.3f}", flush=True)
    vit_cfg = parse_config(VIT_CONFIG)
    v = ranks["vit"]
    v_want = expected_tp_launches(vit_cfg, steps=TP_STEPS)
    v["loss_rel"] = against("vit", v["losses_tp"], v["losses_single"])
    if v["launches"] != v_want:
        raise AssertionError(f"tp (c) vit: launches {v['launches']}, want {v_want}")
    assert_tp_signature(v["audit"], parallel["gloo"]["ddp"]["audit"])
    print(f"tp (c): the ViT at full width, 1 x 2 (B4 on each rank's {vit_cfg.num_heads // 2} "
          f"heads): losses {v['losses_tp']} against one process {v['losses_single']} (worst rel "
          f"{v['loss_rel']:.3g}); launches a rank {v['launches']}; audit {v['audit']}; "
          f"wall {ranks['wall_s']:.1f} s for (b), (c) and the trace", flush=True)
    out["ranks"] = ranks

    # (d) FSDP x TP, 2 x 2 on 4 ranks, at TP_FSDP_LAYERS layers, against FSDP
    # alone on the same 2 data ranks: the same data slices and dropout seeds
    cfg_d = parse_config(CONFIG)
    cfg_d.num_encoders = TP_FSDP_LAYERS
    depth = [f"num_encoders={TP_FSDP_LAYERS}"]
    # each data rank validates its half of the set in batches of half the size
    ref = cli("fsdp", 2, ["fsdp=True", *depth],
              expected_launches(cfg_d, forwards=val_batches, steps=TP_STEPS))
    want = expected_tp_launches(cfg_d, forwards=val_batches, steps=TP_STEPS)
    d = cli("fsdp_tp", 4, ["fsdp=True", "model_parallel=2", *depth], want)
    if d["layout"] != "fsdp" or ref["layout"] != "fsdp":
        raise AssertionError(f"tp (d): layouts {d['layout']}, {ref['layout']}")
    d["loss_rel"] = against("fsdp_tp", d["losses"], ref["losses"])
    d["fsdp_losses"], d["fsdp_wall_s"] = ref["losses"], ref["wall_s"]
    out["fsdp_tp"] = d
    print(f"tp (d): FSDP x TP 2 x 2 on 4 ranks on one card through the CLI, "
          f"{TP_FSDP_LAYERS} layers: launches a rank {d['launches']} (exact); losses "
          f"{d['losses']} against FSDP alone on the same 2 data ranks {ref['losses']} (worst "
          f"rel {d['loss_rel']:.3g}, limit {GLOO_LOSS_REL}); wall {d['wall_s']:.1f} s "
          f"({ref['wall_s']:.1f} s the FSDP run)", flush=True)
    return out


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
    from spectre_tpu_torch.repl import distill as distill_cli
    from spectre_tpu_torch.repl import eval as eval_cli
    from spectre_tpu_torch.repl import perf as perf_cli
    from spectre_tpu_torch.repl import serve
    from spectre_tpu_torch.repl import train as train_cli
    from spectre_tpu_torch.serving import SpectreClient
    from spectre_tpu_torch.utils import card_and_power_limit

    for path in (CONFIG, VIT_CONFIG, BRANCH_CONFIG, DISTILL_CONFIG):
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
    k2, k2_head = phase_kernel2(kernels, gen)
    k11 = phase_linear_bwd(kernels, gen)
    k12, k14, c6_cluster = phase_c6(kernels, gen)
    tp_entries = phase_tp_entries(kernels, gen)
    k2_head.update(c6_cluster)
    k5, k5g = phase_kernel5(kernels)
    k3, k4 = phase_gather_kernels(kernels, gen)
    k8, k9 = phase_attention(kernels)
    k6 = phase_fwht(kernels, hadamard_matrix)
    k7 = phase_structured_kernels(kernels, structured_matrix)
    model, cfg = phase_model(kernels, build_model, parse_config)
    serving = phase_serve(kernels, serve, SpectreClient, model, cfg)
    with tempfile.TemporaryDirectory(prefix="spectre_smoke_") as tmp:
        imported, export_run, export = phase_export(kernels, build_model, parse_config, model,
                                                    tmp)
        export["stw"] = phase_stw(build_model, parse_config, imported, tmp)
        del imported
        torch.cuda.empty_cache()
        export["clis"] = phase_export_clis(tmp)
        export_families = phase_export_families(kernels, build_model, parse_config, tmp)
    pipeline = phase_pipeline(kernels, serve, model, cfg)
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
        distill_run, distill = phase_distill(kernels, parse_config, distill_cli, tmp)
    # this slice: profile/, the repl/perf.py sweeps of the JAX package, the
    # submission CLI and utils/{debug,summary}.py
    with tempfile.TemporaryDirectory(prefix="spectre_smoke_") as tmp:
        profile = phase_profile(kernels, parse_config, tmp)
        torch.cuda.empty_cache()
        perf_modes = phase_perf_modes(kernels, perf_cli, gen)
        perf_modes["head"] = phase_head_chain(kernels, gen)
        torch.cuda.empty_cache()
        tools = phase_tools(kernels, parse_config, build_model, tmp)
    # this slice: the parallel layouts (phase 27)
    with tempfile.TemporaryDirectory(prefix="spectre_smoke_") as tmp:
        parallel = phase_parallel(kernels, train_cli, parse_config, tmp)
        # this slice: tensor parallelism on the card (phase 28)
        tp = phase_tp(parse_config, tmp, parallel)

    # launches: the whole trainer's uninterrupted run (20 steps, 4 validation
    # batches); kernel 4 from the mix_block=0 CLI run, kernel 5 from its own
    # entry point, repl/perf.py fused-bwd
    k1["launches"] = trainer_run["block_scatter_rows"]
    k2["launches"] = trainer_run["fused_spectre_linear_wgmma"]
    k2_head["launches"] = trainer_run["fused_spectre_linear_cluster"]
    k11["launches"] = trainer_run["fused_spectre_linear_bwd"]
    k3["launches"] = trainer_run["block_gather_sum"]
    k4["launches"] = uniform_run["inverse_gather_sum"]
    k5["launches"] = trainer_run["fused_block_bwd_wgmma"]
    k5["launches_fused_bwd_cli"] = fused_run["fused_block_bwd_wgmma"]
    k5g["launches"] = fused_run["fused_block_bwd_grouped"]
    k1["launches_serving"] = serving["block_scatter_rows"]
    k2["launches_serving"] = serving["fused_spectre_linear_wgmma"]
    k2_head["launches_serving"] = serving["fused_spectre_linear_cluster"]
    # this slice's paths: kernels 8 and 9 from the ViT trainer's uninterrupted
    # run (14 steps, 2 validation batches), kernel 7 from the structured
    # trainer run (3 steps, 2 validation batches), kernel 6 from
    # ops/hadamard.py's entry points (no model calls it, as in the JAX package)
    k8["launches"] = vit_run["flash_attention_fwd"]
    k9["launches"] = vit_run["flash_attention_bwd"]
    k8["launches_serving"] = vit_serving["flash_attention_fwd"]
    k7["launches"] = structured_run["structured_mix"]
    k7["backward_launches"] = structured_run["structured_mix_bwd"]
    k2["launches_structured"] = structured_run["fused_spectre_linear_wgmma"]
    k6["launches"] = entry_run["fwht"]
    # B9 from the routed trainer's CLI run (4 steps, 2 validation batches);
    # the branch's CLI run (the same) and serving run for kernels 1 and 4
    k10["launches"] = routed_run["routed_gather_sum"]
    k1["launches_branch"] = branch_run["block_scatter_rows"]
    k1["launches_branch_serving"] = branch_serving["block_scatter_rows"]
    k4["launches_branch"] = branch_run["inverse_gather_sum"]
    # the distill CLI's uninterrupted run (20 steps, 2 validation passes)
    for k, counter in ((k1, "block_scatter_rows"), (k2, "fused_spectre_linear_wgmma"),
                       (k2_head, "fused_spectre_linear_cluster"),
                       (k11, "fused_spectre_linear_bwd"), (k3, "block_gather_sum"),
                       (k5, "fused_block_bwd_wgmma")):
        k["launches_distill"] = distill_run[counter]
    # the deployment path: one call of the loaded flagship program (batch 64),
    # of the ViT's and of the structured mix's (2 layers each)
    k1["launches_export"] = export_run["block_scatter_rows"]
    k2["launches_export"] = export_run["fused_spectre_linear_wgmma"]
    k2_head["launches_export"] = export_run["fused_spectre_linear_cluster"]
    k8["launches_export_vit"] = export_families["vit"]["flash_attention_fwd"]
    k7["launches_export_structured"] = export_families["structured"]["structured_mix"]
    # kernel 2 above N = 1,024 in bf16 that TMA can describe: the trainer
    # launches neither wide kernel (no shipped config has N > 1,024); the C6
    # phase's own launches are beside. repl/perf.py linear's 8-row float32
    # rows run the cluster kernel at every dim
    for k in (k12, k14):
        k["launches"] = k["launches_trainer"] = trainer_run[k["name"]]
    k2_head["times_perf_linear"] = perf_modes["wide"]
    # this slice's paths: the four sweeps, the profiled steps and the
    # submission CLI's run
    for k, counter in ((k2_head, "fused_spectre_linear_cluster"), (k7, "structured_mix")):
        for mode, c in perf_modes["launches"].items():
            if c[counter]:
                k[f"launches_perf_{mode}"] = c[counter]
    for k, counter in ((k1, "block_scatter_rows"), (k3, "block_gather_sum"),
                       (k5, "fused_block_bwd_wgmma"), (k2, "fused_spectre_linear_wgmma"),
                       (k2_head, "fused_spectre_linear_cluster"),
                       (k11, "fused_spectre_linear_bwd")):
        k["launches_profile"] = profile["launches"][counter]
    for k, counter in ((k1, "block_scatter_rows"), (k4, "inverse_gather_sum"),
                       (k2, "fused_spectre_linear_wgmma"),
                       (k2_head, "fused_spectre_linear_cluster"),
                       (k11, "fused_spectre_linear_bwd")):
        k["launches_mnist_submission"] = tools["submission"]["launches"][counter]
    # phase 27: the CLI's runs under torchrun with DDP and FSDP (8 steps, 2
    # validation batches each)
    for k, counter in ((k1, "block_scatter_rows"), (k3, "block_gather_sum"),
                       (k5, "fused_block_bwd_wgmma"), (k2, "fused_spectre_linear_wgmma"),
                       (k2_head, "fused_spectre_linear_cluster"),
                       (k11, "fused_spectre_linear_bwd")):
        for kind in ("ddp", "fsdp"):
            k[f"launches_parallel_{kind}"] = parallel["launches"][kind][counter]
            k[f"launches_parallel_gloo_{kind}_rank0"] = parallel["gloo"][kind]["launches"][counter]
    k2_head["library_device_ms"] = perf_modes["head"]["chain_device_ms"]
    k2_head["head_times_again"] = perf_modes["head"]
    # phase 28: the four shard entries on the flagship's TP leg (a) (3 steps
    # and 2 validation batches, a rank), (b)'s float32 step and (d)'s FSDP x TP
    tp_entries[0]["launches_kernel"] = tp["flagship"]["launches"][
        "fused_spectre_linear_shard_stats_wgmma"]
    for k in tp_entries:
        k["launches"] = tp["flagship"]["launches"][k["name"]]
        k["launches_tp_f32_step"] = tp["ranks"]["f32"]["launches"][k["name"]]
        k["launches_fsdp_tp"] = tp["fsdp_tp"]["launches"][k["name"]]
    for k, counter in ((k1, "block_scatter_rows"), (k3, "block_gather_sum"),
                       (k2, "fused_spectre_linear_wgmma"),
                       (k2_head, "fused_spectre_linear_cluster"),
                       (k11, "fused_spectre_linear_bwd")):
        k["launches_tp"] = tp["flagship"]["launches"][counter]
    k8["launches_tp_vit"] = tp["ranks"]["vit"]["launches"]["flash_attention_fwd"]
    k9["launches_tp_vit"] = tp["ranks"]["vit"]["launches"]["flash_attention_bwd"]
    result = {"kernels": [k1, k2, k2_head, k11, k3, k4, k5, k5g, k8, k9, k6, k7, k10, k12, k14,
                          *tp_entries],
              "train_step": {f"mix_block={blk}": {f"B={b}": v for b, v in t.items()}
                             for blk, t in step_times.items()},
              "trainer": trainer, "fused_bwd": fused_bwd, "bench": bench, "vit": vit,
              "structured": structured, "routed": routed, "branch": branch,
              "gather_tm": {"train_step": gather_tm}, "distill": distill, "export": export,
              "pipeline": pipeline, "profile": profile,
              "perf_modes": {k: v for k, v in perf_modes.items() if k != "launches"},
              "tools": tools, "parallel": parallel, "tp": tp}
    print(smi, flush=True)
    print(json.dumps(result), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-train"]:  # a torchrun rank of phase 27
        rank_train(sys.argv[2], sys.argv[3:])
    elif sys.argv[1:2] == ["--rank-gloo"]:
        rank_gloo(sys.argv[2])
    elif sys.argv[1:2] == ["--rank-tp"]:
        rank_tp(sys.argv[2])
    else:
        sys.exit(main())
