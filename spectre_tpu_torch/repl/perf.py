"""Where a train step spends its time on the card (the flagship's by default,
any config with ``--config``), and single kernels beside what they replace.

    python -m spectre_tpu_torch.repl.perf [--config <config.py>] [--batch 256 1024]
        [--mix-block 64] [--out build/perf.json]
    python -m spectre_tpu_torch.repl.perf fused-bwd [--batch 256 1024] [--heads 16]
        [--tokens 65] [--embed 512] [--out-dim 512] [--blk 64] [--iters 30]
    python -m spectre_tpu_torch.repl.perf attention [--batch 256 1024] [--heads 16]
        [--tokens 65] [--head-dim 32] [--iters 30]
    python -m spectre_tpu_torch.repl.perf structured [--batch 256 1024] [--heads 16]
        [--tokens 65] [--embed 512] [--iters 30]
    python -m spectre_tpu_torch.repl.perf routed [--batch 256 1024] [--heads 16]
        [--tokens 65] [--embed 512] [--iters 30]
    python -m spectre_tpu_torch.repl.perf fwht [--iters 30]
    python -m spectre_tpu_torch.repl.perf linear-bwd [--batch 256 1024] [--iters 30]
    python -m spectre_tpu_torch.repl.perf linear-fwd [--batch 256 1024] [--iters 30]
    python -m spectre_tpu_torch.repl.perf distill --config spectre_tpu_torch/configs/distill_cifar100.py
        [--batch 256] [--out build/perf_distill.json]
    python -m spectre_tpu_torch.repl.perf latency|linear|mixer|encoder [--batch 8]
        [--embed-dim 512] [--heads 4] [--warmup 10] [--iters 100] [--max-pow 13]
        [--mix-impl gather] [--use-pallas] [--device cuda]

``latency``, ``linear``, ``mixer`` and ``encoder`` are the JAX package's
sweeps with its flags, defaults and rows, on the card unless ``--device
cpu``: SpectreViT forwards over patch {4, 8} x heads {1, 2, 4, 8};
SpectreLinear beside a dense layer at square dims 256 to 4,096 on 8 rows in
float32 (kernel 2's cluster kernel at every dim); the gather mix, the structured mix's matrix form, the 2-D DFT by
products and the structured-mix kernel at d = 2^6 .. 2^13 (the kernel at
every d: it has no fallback); one SpectreEncoderLayer forward through
``profile.trace_step`` and ``ProfilerParser`` into plots/encoder_layer.csv.
Times are CUDA events over ``--iters`` calls after ``--warmup``; a time at or
below 1.5x one trivial launch's is marked dispatch-bound. ``--use-pallas``
has no effect (the port has no second path on the card) and says so.

The other modes need a CUDA card. ``attention`` and ``structured`` (the counterparts of the
JAX package's ``repl/perf.py attention`` and ``mixer``) time the attention
kernels and the structured-mix kernels in bf16 against their plain versions,
forward and forward + backward, and print their largest difference; beside
the attention stands ``scaled_dot_product_attention`` and beside the
structured mix its matrix form, as yardsticks that the port does not call.
``routed`` (the counterpart of the JAX package's
``benchmarks/bwd_gather_variants.py --routed``) times the mix backward
through the Clos route tables, kernel B9 ``routed_gather_sum``, beside
kernel 4 ``inverse_gather_sum`` on the same inverse permutations, B9's
plain version and ``index_add_`` (the scatter form, as a yardstick), in
bf16, with the bytes bound, and prints B9's largest difference from its
plain version (none: they are bitwise equal) and from kernel 4 (the bf16
chain against one rounding). ``fused-bwd`` (the counterpart of the JAX package's
``benchmarks/fused_bwd_bench.py``) runs the mix backward at one layer's
shapes in bf16 both ways, the chain (``_FoldedProj``'s ``dg4`` product and
signs, then ``block_gather_sum``) and the one-launch kernel
``fused_block_bwd``, and prints their largest difference, both times,
GFLOP/s and the ratio. Where ``fuses_mix_backward`` holds for the shape
(``--blk`` a multiple of 64, grp = in / O a multiple of 16) it then times the folded
mix's whole input cotangent with its pool residual both ways: the chain
(autograd through ``perm_rows_t``, ``folded_proj`` and the pool ``einsum``:
the dg4 product and signs, the pool's product, the add, the copy and
``block_gather_sum``) against ``folded_mix_pool``'s backward (one launch of
``fused_block_bwd`` with the pool term), the pool's cotangent a transposed
[B, N, O] view as in the train step. ``fwht`` times the Walsh-Hadamard kernel in bf16 at
[16,640, 512], [16,640, 1024] and [4,160, 4,096] beside ``x @ H_n`` (the
TPU kernel's form, as a yardstick), each back to back from the host and on
the device alone (``utils/timing.py``), with the bytes bound. ``linear-bwd``
times the SpectreLinear block's backward in bf16 at the path's shapes for
each batch (65 B rows; 512 -> 768, 768 -> 512, the head's 512 -> 100) and at
the structured mix's K = 8,192: ``fused_spectre_linear_bwd`` on a saved h
(the chain kernel and the two products; device time by kernel from
``torch.profiler``), the same through kernel 2's autograd Function, and
autograd of the plain version, both ways, with the bound of its two
products. ``linear-fwd`` times the block's forward in bf16 at the same
shapes, writing h as the trainer does: the kernel ``forward_kernel`` picks
(the wgmma kernel; the cluster kernel for the head's N = 100) beside the
cluster kernel and the cuBLAS chain ``gelu(layer_norm(addmm(b, x, w)))``
(a yardstick the port does not call), both ways, with its bound, and prints
the kernel's largest difference from the plain version. ``distill`` (with a
distillation config) times the teacher's view and forward, the distill step
with the cached teacher logits and the step with the teacher inside, each by
CUDA events with its device time by group and by kernel.

The default mode builds, for each batch size, the config's trainer (synthetic
data, the trainer's augmentation for the config's dataset inside the step,
the port's seeded init) and prints:

1. ms per step over 10 steps after 3 warm-up steps, by CUDA events (median)
   and on the host clock (synchronised), img/s, peak device memory;
2. device time of one step (``torch.profiler`` over 3 steps, kernel events
   only) by group of kernels and for the largest kernels by name, and the
   idle share (1 - kernel time / step time), against the profiled step and
   against the unprofiled one of item 1;
3. which cotangents reach the two mix Functions' backwards non-contiguous
   (those are copied once, by ``.contiguous()``), and how many bytes;
4. for the folded permutation mix only: the folded projection's forward +
   backward by itself at the layer's
   shapes, in two forms: the port's (fold ``s4 * w`` into [N, in, O] weights
   every step, reassociated backward) and signs applied to the activations
   with ``w`` shared over tokens (plain autograd).

The card's name and power limit head the output; all results also go to
``--out`` as JSON.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import time
from unittest import mock

import numpy as np
import torch

from spectre_tpu_torch.configs import FLAGSHIP, parse_config
from spectre_tpu_torch.data import synthetic_batch
from spectre_tpu_torch.ops import (
    MixTables,
    folded_mix_pool,
    folded_proj,
    fused_mix,
    fuses_mix_backward,
    grouped_pool,
    grouped_pool_weights,
    perm_rows_t,
)
from spectre_tpu_torch.ops import structured_mix as structured_mix_matrix
from spectre_tpu_torch.ops import hadamard_matrix
from spectre_tpu_torch.ops.kernels import (
    block_gather_sum,
    flash_attention,
    flash_attention_plain,
    forward_kernel,
    fused_block_bwd,
    fused_spectre_linear,
    fused_spectre_linear_bwd,
    fused_spectre_linear_grad,
    fused_spectre_linear_plain,
    fused_spectre_linear_cluster,
    fwht,
    inverse_gather_sum,
    invert_tile_perms,
    routed_gather_sum,
    routed_gather_sum_plain,
    structured_mix_grad,
    structured_mix_plain,
)
from spectre_tpu_torch.ops.routing import build_route_tables_cached
from spectre_tpu_torch.train.loop import build_step
from spectre_tpu_torch.utils import card_and_power_limit, cli_device
from spectre_tpu_torch.utils.timing import (
    HBM_BYTES_PER_S,
    bound_ms,
    cuda_time_ms,
    queued_time_ms,
)


def _events_ms(fn, reps: int) -> list[float]:
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return out


def _spy(cls, log: list):
    """Record whether each cotangent reaching ``cls.backward`` is contiguous."""
    orig = cls.backward

    def backward(ctx, g):
        log.append((cls.__name__, g.is_contiguous(), g.numel() * g.element_size()))
        return orig(ctx, g)

    return mock.patch.object(cls, "backward", staticmethod(backward))


_GROUPS = (
    ("block_scatter_rows_kernel", "kernel 1 block_scatter_rows"),
    ("gather_sum_kernel", "kernels 3/4 gather_sum"),
    ("fused_linear_cluster_kernel", "kernel 2 fused_spectre_linear_fwd"),
    ("fused_linear_wgmma_kernel", "kernel 2 fused_spectre_linear_fwd"),
    ("fused_linear_wide_cluster_kernel", "kernel 2 fused_spectre_linear_fwd"),
    ("chain_kernel", "kernel 2's backward chain (fused_spectre_linear_bwd)"),
    ("chain_wide_kernel", "kernel 2's backward chain (fused_spectre_linear_bwd)"),
    ("chain_walk_kernel", "kernel 2's backward chain (fused_spectre_linear_bwd)"),
    ("column_sum_kernel", "kernel 2's backward chain (fused_spectre_linear_bwd)"),
    ("flash_attention_fwd_kernel", "kernel 8 flash_attention_fwd"),
    ("flash_attention_bwd_kernel", "kernel 9 flash_attention_bwd"),
    ("structured_mix_kernel", "kernel 7 structured_mix (forward and backward)"),
    ("fwht_", "kernel 6 fwht"),
    ("f32f32", "matrix products, f32"), ("simt_sgemm", "matrix products, f32"),
    ("gemm", "matrix products, bf16"), ("nvjet", "matrix products, bf16"),
    ("cutlass", "matrix products, bf16"), ("gemv", "matrix products, bf16"),
    ("multi_tensor_apply", "optimizer (foreach)"),
    ("layer_norm", "LayerNorm"), ("LayerNorm", "LayerNorm"),
    ("reduce_kernel", "reductions"), ("SoftMax", "softmax"),
    ("elementwise", "elementwise (casts, signs, adds, GELU chain, dropout)"),
)


def _group(kernel_name: str) -> str:
    for needle, group in _GROUPS:
        if needle in kernel_name:
            return group
    return "other"


def kernel_rows(fn, n: int) -> tuple[list, float]:
    """``torch.profiler`` over ``n`` calls of ``fn``: (name, launches, ms) of
    every kernel, largest first, and the span of the calls in ms (CUDA
    events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        span = _events_ms(lambda: [fn() for _ in range(n)], 1)[0]
    # kernel events only: an operator's row repeats the time of its kernels,
    # and so does the range torch.optim records around a step on the device's
    # timeline ("Optimizer.step#AdamW.step"), which is no kernel
    rows = [(e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not e.key.startswith("Optimizer.")]
    rows.sort(key=lambda r: -r[2])
    return rows, span


def profile_steps(cfg, batch: int) -> dict:
    state, step = build_step(cfg, "cuda")
    x, y = (torch.from_numpy(a).cuda() for a in synthetic_batch(cfg.dataset, batch))
    for _ in range(3):
        step(state, x, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev = _events_ms(lambda: step(state, x, y), 10)
    t0 = time.perf_counter()
    for _ in range(10):
        step(state, x, y)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 100
    res = {"batch": batch, "events_ms_median": statistics.median(ev), "events_ms_min": min(ev),
           "events_ms_max": max(ev), "host_ms": host_ms,
           "img_per_s": batch / statistics.median(ev) * 1e3,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}

    log: list = []
    with _spy(fused_mix._FoldedProj, log), _spy(fused_mix._PermRowsT, log):
        step(state, x, y)
    torch.cuda.synchronize()
    res["noncontiguous_cotangents"] = [e for e in log if not e[1]]
    res["cotangents_seen"] = len(log)

    res.update(device_breakdown(lambda: step(state, x, y), res["events_ms_median"]))
    return res


def device_breakdown(fn, events_ms: float, n: int = 3) -> dict:
    """``torch.profiler`` over ``n`` calls of ``fn``: kernel time a call by
    group and for the largest kernels by name, and the idle share against
    the profiled span and against ``events_ms``, the unprofiled call."""
    rows, span = kernel_rows(fn, n)
    device_ms = sum(r[2] for r in rows)
    groups: dict[str, list] = {}
    for key, count, ms in rows:
        g = groups.setdefault(_group(key), [0, 0.0])
        g[0] += count
        g[1] += ms
    return dict(profiled_span_ms_per_step=span / n, device_ms_per_step=device_ms / n,
                idle_share_profiled=1.0 - device_ms / span,
                # the profiler slows the host: against the unprofiled call's time.
                # Not clamped: a negative share means the kernel rows were miscounted
                idle_share=1.0 - device_ms / n / events_ms,
                by_group={k: {"launches_per_step": c / n, "ms_per_step": ms / n}
                          for k, (c, ms) in sorted(groups.items(), key=lambda kv: -kv[1][1])},
                by_kernel=[{"name": k[:110], "launches_per_step": c / n, "ms_per_step": ms / n}
                           for k, c, ms in rows[:14]])


def distill_profile(cfg, batch: int) -> dict:
    """The distill config's teacher (its view and forward) and its step, with
    the cached logits and with the teacher in the step: CUDA-event times
    (median of 5 after 2 warm-up calls) and each one's device breakdown."""
    from spectre_tpu_torch.data import make_train_augment
    from spectre_tpu_torch.distill import make_teacher_view, teacher_from_config
    from spectre_tpu_torch.train import make_distill_step
    from spectre_tpu_torch.train.loop import create_trainer, dataset_stats

    t_size = int(getattr(cfg, "teacher_img_size", 224))
    teacher = teacher_from_config(cfg, t_size, "cuda")
    view = make_teacher_view(t_size, in_ch=int(cfg.in_channels),
                             mode=str(getattr(cfg, "teacher_view", "imagenet")))
    x, y = (torch.from_numpy(a).cuda() for a in synthetic_batch(cfg.dataset, batch))

    def teacher_logits():
        with torch.inference_mode():
            return teacher(view(x))

    state = create_trainer(cfg, "cuda", steps_per_epoch=16)
    alpha = float(getattr(cfg, "distill_alpha", 0.25))
    step = make_distill_step(
        make_train_augment(*dataset_stats(cfg.dataset), jitter=int(cfg.in_channels) == 3),
        float(getattr(cfg, "distill_temperature", 2.0)), alpha, 1.0 - alpha,
        getattr(cfg, "grad_clip_norm", None))
    cached = teacher_logits().clone()
    res = {"batch": batch}
    for name, fn in (("teacher", teacher_logits),
                     ("step_cached", lambda: step(state, x, cached, y)),
                     ("step_recompute", lambda: step(state, x, teacher_logits().clone(), y))):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ev = statistics.median(_events_ms(fn, 5))
        res[name] = {"events_ms_median": ev, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                     **device_breakdown(fn, ev)}
    return res


def fold_variants(cfg, batch: int) -> dict:
    """Forward + backward of the folded projection alone, one layer's shapes."""
    n, e, o = (cfg.img_size // cfg.patch_size) ** 2 + 1, cfg.embed_dim * cfg.num_heads, \
        cfg.embed_dim
    gen = torch.Generator(device="cuda").manual_seed(0)
    kw = dict(device="cuda", dtype=torch.bfloat16)
    g4 = torch.randn(n, e, batch, generator=gen, **kw).requires_grad_()
    w = (torch.randn(e, o, generator=gen, **kw) * e ** -0.5).requires_grad_()
    s4 = (torch.randint(0, 2, (n, e), generator=gen, device="cuda") * 2 - 1).to(torch.bfloat16)
    dy = torch.randn(n, batch, o, generator=gen, **kw)

    def fold_weights():
        fused_mix.folded_proj(g4, w, s4).backward(dy)

    def sign_activations():
        sg = g4 * s4[:, :, None]
        torch.bmm(sg.transpose(1, 2), w.expand(n, -1, -1)).backward(dy)

    out = {}
    for name, fn in (("fold_weights", fold_weights), ("sign_activations", sign_activations),
                     ("fold_weights_again", fold_weights)):
        fn()
        g4.grad = w.grad = None
        out[name + "_ms"] = statistics.median(_events_ms(fn, 7))
        g4.grad = w.grad = None
    return out


def _pool_cotangent_chain_and_fused(dy, w, s4, binv, blk: int, grp: int, iters: int) -> dict:
    """The folded mix's input cotangent with the pool residual, bf16: the
    chain (autograd of ``perm_rows_t``, ``folded_proj`` and the pool
    ``einsum``) against ``folded_mix_pool``'s backward; w takes no gradient
    in either, so both time dxt alone. Returns their times, largest
    difference and entry."""
    n, b, o = dy.shape
    d = binv.shape[1] * blk
    gen = torch.Generator(device="cuda").manual_seed(1)
    bsrc = torch.argsort(binv.long(), dim=1).to(torch.int32)
    tables = MixTables(blk, bsrc, binv)
    pool_w = grouped_pool_weights(s4, grp)
    xt = torch.randn(d, b, generator=gen, device="cuda", dtype=dy.dtype).requires_grad_()
    dpool = torch.randn(b, n, o, generator=gen, device="cuda", dtype=dy.dtype).transpose(0, 1)

    def chain_graph():
        g4 = perm_rows_t(xt, tables).view(n, -1, b)
        return folded_proj(g4, w, s4), grouped_pool(g4, pool_w, grp)

    graphs = {"chain": chain_graph(),
              "fused": folded_mix_pool(xt, w, s4, tables, grp)}
    grads = {k: torch.autograd.grad(v, xt, (dy, dpool), retain_graph=True)[0]
             for k, v in graphs.items()}
    t = {}
    for name in ("chain", "fused", "fused_again", "chain_again"):
        outs = graphs[name.removesuffix("_again")]

        def run():
            for _ in range(iters):
                torch.autograd.grad(outs, xt, (dy, dpool), retain_graph=True)
        run()
        t[name] = statistics.median(_events_ms(run, 5)) / iters
    diff = (grads["chain"].float() - grads["fused"].float()).abs().max().item()
    peak = grads["chain"].float().abs().max().item()
    del graphs, grads
    return dict(t, max_abs_diff=diff, largest_entry=peak, grp=grp)


def fused_bwd(args) -> dict:
    """The mix backward at one layer's shapes, bf16: chain against kernel,
    and with blk % 64 == 0 the input cotangent with the pool residual."""
    h, n, e, o, blk = args.heads, args.tokens, args.embed, args.out_dim, args.blk
    d, eh = n * e, e * h
    gen = torch.Generator(device="cuda").manual_seed(0)
    kw = dict(device="cuda", dtype=torch.bfloat16)
    binv = torch.stack([torch.randperm(d // blk, generator=gen, device="cuda")
                        for _ in range(h)]).to(torch.int32)
    w = torch.randn(eh, o, generator=gen, **kw)
    s4 = (torch.randint(0, 2, (n, eh), generator=gen, device="cuda") * 2 - 1).to(torch.bfloat16)
    out = {}
    for b in args.batch:
        dy = torch.randn(n, b, o, generator=gen, **kw)

        def chain():
            dg4 = torch.bmm(w.expand(n, -1, -1), dy.transpose(1, 2))
            dg4.mul_(s4[:, :, None])
            return block_gather_sum(dg4.view(h * d, b), binv, blk)

        def fused():
            return fused_block_bwd(dy, w, s4, binv, blk)

        diff = (chain().float() - fused().float()).abs().max().item()
        peak = chain().float().abs().max().item()
        t = {}
        for name, fn in (("chain", chain), ("fused", fused), ("fused_again", fused),
                         ("chain_again", chain)):
            fn()
            t[name] = statistics.median(
                _events_ms(lambda: [fn() for _ in range(args.iters)], 5)) / args.iters
        gflop = 2 * d * h * o * b / 1e9
        t1, t2 = min(t["chain"], t["chain_again"]), min(t["fused"], t["fused_again"])
        out[str(b)] = dict(t, max_abs_diff=diff, largest_entry=peak, gflop=gflop)
        print(f"shape: d={d} H={h} B={b} O={o} blk={blk}; max|chain-fused|={diff:.4f} of a "
              f"largest entry {peak:.1f} (bf16 outputs)\n"
              f"  chain (bmm + signs + block_gather_sum): {t1:8.3f} ms  ({gflop / t1:6.1f} "
              f"TFLOP/s)\n"
              f"  fused kernel:                           {t2:8.3f} ms  ({gflop / t2:6.1f} "
              f"TFLOP/s)\n"
              f"  chain / fused: {t1 / t2:.2f}x", flush=True)
        grp = eh // o if eh % o == 0 else 0
        if fuses_mix_backward(torch.bfloat16, blk, h, grp, o, routed=False):
            pool = _pool_cotangent_chain_and_fused(dy, w, s4, binv, blk, grp, args.iters)
            out[str(b)]["pool"] = pool
            t1, t2 = min(pool["chain"], pool["chain_again"]), min(pool["fused"],
                                                                  pool["fused_again"])
            print(f"  with the pool residual's cotangent (grp={grp}): max|chain-fused|="
                  f"{pool['max_abs_diff']:.4f} of a largest entry {pool['largest_entry']:.1f}\n"
                  f"  chain (autograd: bmm, signs, pool product, add, copy, "
                  f"block_gather_sum): {t1:8.3f} ms\n"
                  f"  folded_mix_pool backward (one fused_block_bwd launch):        "
                  f"{t2:8.3f} ms\n"
                  f"  chain / fused: {t1 / t2:.2f}x", flush=True)
        del dy
        torch.cuda.empty_cache()
    return out


def _fwd_and_bwd(name: str, fns: dict, make_inputs, cot, iters: int) -> dict:
    """Median ms of each function's forward and forward + backward, in the
    order given and again in reverse; ``make_inputs()`` gives fresh leaves."""
    t = {}
    order = list(fns) + [k + "_again" for k in reversed(list(fns))]
    for key in order:
        fn = fns[key.removesuffix("_again")]
        leaves = make_inputs()

        def fwd():
            with torch.no_grad():
                return fn(*leaves)

        def fwd_bwd():
            torch.autograd.grad(fn(*leaves), leaves, cot)

        fwd(), fwd_bwd()
        t[key + "_fwd"] = statistics.median(
            _events_ms(lambda: [fwd() for _ in range(iters)], 5)) / iters
        t[key + "_fwd_bwd"] = statistics.median(
            _events_ms(lambda: [fwd_bwd() for _ in range(iters)], 5)) / iters
    for key in fns:
        for what in ("fwd", "fwd_bwd"):
            t[f"{key}_{what}"] = min(t[f"{key}_{what}"], t.pop(f"{key}_again_{what}"))
    print(f"  {name}: " + "; ".join(
        f"{key} fwd {t[key + '_fwd']:.4f} ms, fwd+bwd {t[key + '_fwd_bwd']:.4f} ms"
        for key in fns), flush=True)
    return t


def attention(args) -> dict:
    """The attention kernels at one layer's shapes, bf16: kernel against
    plain version, forward and forward + backward."""
    h, n, d = args.heads, args.tokens, args.head_dim
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for b in args.batch:
        # [B, H, N, D] views of [B, N, H, D] memory, as the mixer passes them
        q, k, v, cot = (torch.randn(b, n, h, d, generator=gen, device="cuda")
                        .to(torch.bfloat16).permute(0, 2, 1, 3) for _ in range(4))

        def leaves():
            return [t.detach().clone().requires_grad_() for t in (q, k, v)]

        got, want = flash_attention(q, k, v), flash_attention_plain(q, k, v)
        diff = (got.float() - want.float()).abs().max().item()
        print(f"attention B={b} H={h} N={n} D={d} bf16: max|kernel - plain| = {diff:.4g} of a "
              f"largest entry {want.float().abs().max().item():.3f}", flush=True)
        t = _fwd_and_bwd("times", {
            "kernel": flash_attention, "plain": flash_attention_plain,
            "sdpa": torch.nn.functional.scaled_dot_product_attention}, leaves, cot, args.iters)
        out[str(b)] = dict(t, max_abs_diff=diff)
        torch.cuda.empty_cache()
    return out


def structured(args) -> dict:
    """The structured-mix kernels at one layer's shapes, bf16: kernel against
    plain version (and the matrix form), forward and forward + backward."""
    heads, n, e = args.heads, args.tokens, args.embed
    d = n * e
    gen = torch.Generator().manual_seed(0)
    from spectre_tpu_torch.ops import make_structured_tables

    tile_perms, signs = make_structured_tables(gen, heads, d)
    tile_perms, signs = tile_perms.cuda(), signs.cuda().to(torch.bfloat16)
    inv = invert_tile_perms(tile_perms)
    dev_gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for b in args.batch:
        x = torch.randn(b, n, e, generator=dev_gen, device="cuda").to(torch.bfloat16)
        cot = torch.randn(b, n, e * heads, generator=dev_gen, device="cuda").to(torch.bfloat16)

        def leaves():
            return [x.detach().clone().requires_grad_()]

        got = structured_mix_grad(x, tile_perms, signs, n, inv)
        want = structured_mix_plain(x, tile_perms, signs, n)
        diff = (got.float() - want.float()).abs().max().item()
        print(f"structured mix B={b} H={heads} d={d} tile={d // tile_perms.shape[1]} bf16: "
              f"max|kernel - plain| = {diff:.4g}", flush=True)
        t = _fwd_and_bwd("times", {
            "kernel": lambda a: structured_mix_grad(a, tile_perms, signs, n, inv),
            "plain": lambda a: structured_mix_plain(a, tile_perms, signs, n),
            "matrix": lambda a: structured_mix_matrix(a, tile_perms, signs, n)},
            leaves, cot, max(1, args.iters // 10))
        out[str(b)] = dict(t, max_abs_diff=diff)
        del x, cot, got, want
        torch.cuda.empty_cache()
    return out


def _both_ways(fns: dict, iters: int, device_iters: int | None = None) -> dict:
    """Each function back to back (``_ms``, ``iters`` calls), on the device
    alone (``_device_ms``) and the host's time to issue it (``_host_ms``),
    the last two from ``device_iters`` calls (few enough that their launches
    fit the launch queue while the card sleeps), in the order given and
    again in reverse; the lower of the two turns."""
    t = {}
    for key in list(fns) + list(reversed(list(fns))):
        ms = cuda_time_ms(fns[key], iters=iters)
        dev, host = queued_time_ms(fns[key], iters=device_iters or iters)
        for way, v in (("ms", ms), ("device_ms", dev), ("host_ms", host)):
            t[f"{key}_{way}"] = min(v, t.get(f"{key}_{way}", v))
    return t


def fwht_times(args) -> dict:
    """The Walsh-Hadamard kernel in bf16 beside ``x @ H_n``."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for m, n in ((16_640, 512), (16_640, 1024), (4160, 4096)):
        x = torch.randn(m, n, generator=gen, device="cuda").to(torch.bfloat16)
        h_n = hadamard_matrix(n, normalize=False).to("cuda", torch.bfloat16)
        t = _both_ways({"kernel": lambda: fwht(x), "matmul": lambda: torch.matmul(x, h_n)},
                       args.iters)
        bound, by = bound_ms(2 * m * n * 2)
        out[str(n)] = dict(t, bound_ms=bound, bound_by=by, rows=m)
        print(f"fwht [{m}, {n}] bf16: kernel {t['kernel_ms']:.4f} ms back to back, "
              f"{t['kernel_device_ms']:.4f} on the device, {t['kernel_host_ms']:.4f} to issue; "
              f"x @ H_{n} {t['matmul_ms']:.4f} / {t['matmul_device_ms']:.4f} / "
              f"{t['matmul_host_ms']:.4f} ms; bound {bound:.4f} ms by {by} (device "
              f"{bound / t['kernel_device_ms']:.0%} of it)", flush=True)
        del x, h_n
    return out


def linear_bwd(args) -> dict:
    """Kernel 2's backward in bf16 beside autograd of the plain version."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(65 * b, k, n) for b in args.batch
              for k, n in ((512, 768), (768, 512))] + [(b, 512, 100) for b in args.batch]
    shapes.append((65 * 256, 8192, 512))
    out = {}
    for m, k, n in shapes:
        kw = dict(device="cuda", dtype=torch.bfloat16)
        x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.rand(k, n, generator=gen, device="cuda") * 2 - 1).mul_(k ** -0.5).to(**kw)
        bias, beta = (0.1 * torch.randn(n, generator=gen, **kw) for _ in range(2))
        gamma = 1.0 + 0.1 * torch.randn(n, generator=gen, **kw)
        cot = torch.randn(m, n, generator=gen, **kw)
        leaves = [t.requires_grad_() for t in (x, w, bias, gamma, beta)]
        y_k, y_p = fused_spectre_linear_grad(*leaves), fused_spectre_linear_plain(*leaves)
        got = torch.autograd.grad(y_k, leaves, cot, retain_graph=True)
        want = torch.autograd.grad(y_p, leaves, cot, retain_graph=True)
        rel = max(((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
                  for a, b in zip(got, want))
        iters = max(1, args.iters // 6) if k > 1024 else args.iters
        saved = [t.detach() for t in (x, w, gamma, beta)]
        h = fused_spectre_linear(*saved[:2], bias.detach(), *saved[2:], save_h=True)[1]
        t = _both_ways({
            "kernel": lambda: fused_spectre_linear_bwd(*saved, h, cot),
            "backward": lambda: torch.autograd.grad(y_k, leaves, cot, retain_graph=True),
            "plain_autograd": lambda: torch.autograd.grad(y_p, leaves, cot, retain_graph=True)},
            iters, device_iters=min(iters, 5))
        rows, _ = kernel_rows(lambda: fused_spectre_linear_bwd(*saved, h, cot), 5)
        t["kernels"] = {name[:80]: ms / 5 for name, _, ms in rows}
        # the two products, 2 M K N operations each; x, h, g, W, gamma, beta
        # read and dx, dW and the three [N] gradients written once, in bf16
        bound, by = bound_ms((2 * m * k + 2 * m * n + 2 * k * n + 5 * n) * 2, 4 * m * k * n)
        out[f"{m}x{k}x{n}"] = dict(t, bound_ms=bound, bound_by=by, max_rel_diff=rel)
        print(f"backward ({m}x{k})x({k}x{n}) bf16: fused_spectre_linear_bwd "
              f"{t['kernel_ms']:.4f} ms back to back, {t['kernel_device_ms']:.4f} on the device, "
              f"{t['kernel_host_ms']:.4f} to issue "
              f"(by kernel: " + ", ".join(f"{key[:40]} {ms:.4f}" for key, ms in
                                          t["kernels"].items()) + "); through autograd "
              f"{t['backward_ms']:.4f} / {t['backward_device_ms']:.4f} ms; autograd of plain "
              f"{t['plain_autograd_ms']:.4f} / {t['plain_autograd_device_ms']:.4f} ms; bound "
              f"{bound:.4f} ms by {by}; gradients within {rel:.3g} of the largest entry",
              flush=True)
        del x, w, cot, leaves, y_k, y_p, got, want
        torch.cuda.empty_cache()
    return out


def linear_fwd(args) -> dict:
    """Kernel 2's forward in bf16 beside the cluster kernel and the cuBLAS
    chain."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(65 * b, k, n) for b in args.batch
              for k, n in ((512, 768), (768, 512))] + [(b, 512, 100) for b in args.batch]
    shapes.append((65 * 256, 8192, 512))
    out = {}
    for m, k, n in shapes:
        kw = dict(device="cuda", dtype=torch.bfloat16)
        x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.rand(k, n, generator=gen, device="cuda") * 2 - 1).mul_(k ** -0.5).to(**kw)
        bias, beta = (0.1 * torch.randn(n, generator=gen, **kw) for _ in range(2))
        gamma = 1.0 + 0.1 * torch.randn(n, generator=gen, **kw)
        args5 = (x, w, bias, gamma, beta)
        y, h = torch.empty(m, n, **kw), torch.empty(m, n, **kw)
        got = fused_spectre_linear(*args5, save_h=True)
        want = fused_spectre_linear_plain(*args5, save_h=True)
        diff = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
        iters = max(1, args.iters // 6) if k > 1024 else args.iters
        t = _both_ways({
            "kernel": lambda: fused_spectre_linear(*args5, save_h=True),
            "cluster": lambda: fused_spectre_linear_cluster(*args5, y, h, 1e-5),
            "chain": lambda: F.gelu(F.layer_norm(torch.addmm(bias, x, w), (n,), gamma, beta))},
            iters, device_iters=min(iters, 10))
        # x, W, b, gamma and beta read, out and h written once, in bf16
        bound, by = bound_ms((m * k + k * n + 3 * n + 2 * m * n) * 2, 2 * m * k * n)
        route = forward_kernel(torch.bfloat16, k, n)
        out[f"{m}x{k}x{n}"] = dict(t, kernel_name=route, bound_ms=bound, bound_by=by,
                                   max_abs_diff=diff)
        print(f"forward ({m}x{k})x({k}x{n}) bf16 with h: {route} {t['kernel_ms']:.4f} ms back to "
              f"back, {t['kernel_device_ms']:.4f} on the device ({bound / t['kernel_device_ms']:.0%} "
              f"of the bound), {t['kernel_host_ms']:.4f} to issue; fused_spectre_linear_cluster "
              f"{t['cluster_ms']:.4f} / {t['cluster_device_ms']:.4f} ms; cuBLAS chain "
              f"{t['chain_ms']:.4f} / {t['chain_device_ms']:.4f} ms; bound {bound:.4f} ms by {by}; "
              f"max |kernel - plain| {diff:.4g}", flush=True)
        del x, w, y, h, got, want
        torch.cuda.empty_cache()
    return out


def routed(args) -> dict:
    """The mix backward through the route at one layer's shape, bf16:
    kernel B9 beside kernel 4, B9's plain version and ``index_add_``."""
    h, n, e = args.heads, args.tokens, args.embed
    d = n * e
    gen = torch.Generator().manual_seed(0)
    perms = torch.stack([torch.randperm(d, generator=gen) for _ in range(h)])
    inv = torch.argsort(perms, dim=1).to(torch.int32)
    t0 = time.perf_counter()
    rt = build_route_tables_cached(inv.numpy())
    print(f"route tables for H={h} d={d} (r={rt.r}, c={rt.c}): "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    tables = [torch.from_numpy(t).cuda() for t in (rt.a_idx, rt.b_idx, rt.c_idx)]
    inv, flat = inv.cuda(), perms.reshape(-1).cuda()
    dev_gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for b in args.batch:
        g = torch.randn(h * d, b, generator=dev_gen, device="cuda").to(torch.bfloat16)
        got = routed_gather_sum(g, *tables)
        diff_plain = (got.float() - routed_gather_sum_plain(g, *tables).float()).abs().max().item()
        diff_k4 = (got.float() - inverse_gather_sum(g, inv).float()).abs().max().item()
        acc = torch.zeros(d, b, dtype=torch.bfloat16, device="cuda")
        fns = {"kernel": lambda: routed_gather_sum(g, *tables),
               "inverse_gather_sum": lambda: inverse_gather_sum(g, inv),
               "plain": lambda: routed_gather_sum_plain(g, *tables),
               "index_add": lambda: acc.index_add_(0, flat, g)}
        t = {}
        for key in list(fns) + [k + "_again" for k in reversed(list(fns))]:
            fn = fns[key.removesuffix("_again")]
            iters = max(1, args.iters // 10) if key.startswith("plain") else args.iters
            fn()
            t[key] = statistics.median(
                _events_ms(lambda: [fn() for _ in range(iters)], 5)) / iters
        for key in fns:
            t[key] = min(t[key], t.pop(key + "_again"))
        moved = (h * d * b + d * b) * 2 + 3 * h * d * 4
        bound = moved / HBM_BYTES_PER_S * 1e3
        out[str(b)] = dict(t, max_abs_diff=diff_plain, max_abs_diff_to_inverse_gather=diff_k4,
                           bound_ms=bound, bytes=moved)
        print(f"routed B={b} H={h} d={d} bf16: max|kernel - plain| = {diff_plain}, "
              f"max|kernel - inverse_gather_sum| = {diff_k4:.4g}; kernel {t['kernel']:.4f} ms "
              f"({moved / t['kernel'] / 1e6:.1f} GB/s), inverse_gather_sum "
              f"{t['inverse_gather_sum']:.4f} ms, plain {t['plain']:.4f} ms, index_add_ "
              f"{t['index_add']:.4f} ms, bound {bound:.4f} ms by bytes", flush=True)
        del g, acc
        torch.cuda.empty_cache()
    return out


# -- the JAX package's sweeps: latency, linear, mixer, encoder ---------------


def _time_fn(fn, device: torch.device, warmup: int = 5, iters: int = 50) -> float:
    """Seconds a call: ``iters`` calls back to back after ``warmup`` calls,
    by CUDA events on a card (the host clock on the CPU)."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def _dispatch_floor(device: torch.device, iters: int = 200) -> float:
    """Seconds of one trivial launch issued back to back (an in-place add on
    [8, 128]): a time at or below it measures the issue, not the work."""
    x = torch.zeros(8, 128, device=device)
    return _time_fn(lambda: x.add_(1.0), device, warmup=10, iters=iters)


def _fmt(dt: float, floor: float) -> str:
    ms = dt * 1e3
    return f"<= {ms:.3f} ms (dispatch-bound)" if dt <= floor * 1.5 else f"{ms:.3f} ms"


def _seeded(module: torch.nn.Module) -> torch.nn.Module:
    """``module`` with the port's init from seed 0, its mixes derived, in
    eval mode."""
    from spectre_tpu_torch.models import refresh_mixes
    from spectre_tpu_torch.models.init import init_weights

    init_weights(module, torch.Generator().manual_seed(0))
    refresh_mixes(module)
    return module.eval()


def _normal(device: torch.device, *shape: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(0).standard_normal(shape).astype(
        np.float32)).to(device)


def cmd_latency(args, device: torch.device) -> list[dict]:
    """SpectreViT forwards over patch x heads (the JAX package's sweep)."""
    from spectre_tpu_torch.models import SpectreViT

    b = args.batch[0]
    print(f"SpectreViT forward latency on {device} (B={b}, {args.warmup} warmup + "
          f"{args.iters} iters)", flush=True)
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (b, 3, 32, 32)).astype(np.float32)).to(device)
    out = []
    for patch, heads in itertools.product([4, 8], [1, 2, 4, 8]):
        model = _seeded(SpectreViT(
            img_size=32, patch_size=patch, in_channels=3, num_classes=100,
            embed_dim=args.embed_dim, num_encoders=4, num_heads=heads,
            hidden_dim=args.embed_dim, dropout=0.0, mix_impl=args.mix_impl, device=device))
        with torch.no_grad():
            dt = _time_fn(lambda: model(x), device, warmup=args.warmup, iters=args.iters)
        print(f"  patch={patch} heads={heads}: {dt * 1e3:.3f} ms/iter ({b / dt:.0f} img/s)",
              flush=True)
        out.append({"patch": patch, "heads": heads, "ms": dt * 1e3, "img_per_s": b / dt})
        del model
    return out


def cmd_linear(args, device: torch.device) -> list[dict]:
    """SpectreLinear against a dense layer at square dims 2^8 .. 2^12."""
    from spectre_tpu_torch.models import Dense, SpectreLinear

    floor = _dispatch_floor(device)
    print(f"SpectreLinear vs Dense on {device} (square dims, {args.batch[0]} rows, float32), "
          f"avg ms/iter (dispatch floor {floor * 1e3:.3f} ms)", flush=True)
    out = []
    for p in range(8, 13):
        dim = 2 ** p
        x = _normal(device, args.batch[0], dim)
        sl = _seeded(SpectreLinear(dim, dim, device=device))
        dense = _seeded(Dense(dim, dim, device=device))
        n_sl = sum(t.numel() for t in sl.parameters())
        n_d = sum(t.numel() for t in dense.parameters())
        with torch.no_grad():
            t_sl = _time_fn(lambda: sl(x), device, warmup=args.warmup, iters=args.iters)
            t_d = _time_fn(lambda: dense(x), device, warmup=args.warmup, iters=args.iters)
        print(f"  dim={dim}: spectre {_fmt(t_sl, floor)} ({n_sl:,} params) | "
              f"dense {_fmt(t_d, floor)} ({n_d:,} params)", flush=True)
        out.append({"dim": dim, "spectre_ms": t_sl * 1e3, "dense_ms": t_d * 1e3,
                    "spectre_params": n_sl, "dense_params": n_d,
                    "kernel": forward_kernel(torch.float32, dim, dim)})
    return out


def mixer_sweep(device: torch.device, batch: int = 8, heads: int = 4, max_pow: int = 13,
                warmup: int = 10, iters: int = 100) -> list[dict]:
    """The mixing transforms across d = 2^6 .. 2^max_pow on 8 tokens: the
    gather mix, the structured mix's matrix form, the 2-D DFT by products
    and the structured-mix kernel (kernel 7, on a card; on the CPU its
    wrapper runs the plain version). Every d goes through the kernel: it
    takes every shape the tables give or raises. Prints a row per d and
    returns the rows (ms)."""
    from spectre_tpu_torch.ops import (
        fft2_real_matmul,
        make_mix_tables,
        make_structured_tables,
        permut_mix,
    )
    from spectre_tpu_torch.ops import structured_mix as structured_matrix
    from spectre_tpu_torch.ops.kernels import structured_mix as structured_kernel

    floor = _dispatch_floor(device)
    print(f"mixing time on {device}, H={heads}, avg ms/iter (dims 2^6..2^{max_pow}; "
          f"dispatch floor {floor * 1e3:.3f} ms)", flush=True)
    tag = "structured-kernel" if device.type == "cuda" else "structured-kernel(plain on cpu)"
    out = []
    n = 8  # tokens; embed = d // n
    for p in range(6, max_pow + 1):
        d = 2 ** p
        if d // n < 8:
            continue
        x = _normal(device, batch, n, d // n)
        perms, signs = (t.to(device) for t in make_mix_tables(
            torch.Generator().manual_seed(0), heads, d))
        tperms, ssigns = (t.to(device) for t in make_structured_tables(
            torch.Generator().manual_seed(0), heads, d))
        runs = {"gather": lambda: permut_mix(x, perms, signs, n),
                "structured": lambda: structured_matrix(x, tperms, ssigns, n),
                "fft2": lambda: fft2_real_matmul(x),
                tag: lambda: structured_kernel(x, tperms, ssigns, n)}
        t = {k: _time_fn(fn, device, warmup=warmup, iters=iters) for k, fn in runs.items()}
        print(f"  d={d}: " + " | ".join(f"{k} {_fmt(v, floor)}" for k, v in t.items()),
              flush=True)
        out.append({"d": d, "tile": d // tperms.shape[1], "gather_ms": t["gather"] * 1e3,
                    "structured_ms": t["structured"] * 1e3, "fft2_ms": t["fft2"] * 1e3,
                    "structured_kernel_ms": t[tag] * 1e3})
    return out


def cmd_mixer(args, device: torch.device) -> list[dict]:
    return mixer_sweep(device, args.batch[0], args.heads, args.max_pow, args.warmup, args.iters)


def cmd_encoder(args, device: torch.device) -> list[dict]:
    """One SpectreEncoderLayer forward under ``trace_step``, through
    ``ProfilerParser`` into plots/encoder_layer.csv."""
    from spectre_tpu_torch.models import SpectreEncoderLayer
    from spectre_tpu_torch.profile import ProfilerParser, trace_step

    layer = _seeded(SpectreEncoderLayer(
        seq_length=65, d_model=args.embed_dim, nhead=args.heads,
        dim_feedforward=args.embed_dim, dropout=0.0, mix_impl=args.mix_impl, device=device))
    x = _normal(device, args.batch[0], 65, args.embed_dim)
    with torch.no_grad():
        layer(x)  # first call outside the trace
        with trace_step("plots/encoder_trace", device) as t:
            layer(x)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    table = (ProfilerParser(t.trace_file).remove_idle().add_percentages().round()
             .sort_by_device().head(25).show().to_csv("plots/encoder_layer.csv"))
    print("wrote plots/encoder_layer.csv", flush=True)
    return table.rows


JAX_MODES = {"latency": cmd_latency, "linear": cmd_linear, "mixer": cmd_mixer,
             "encoder": cmd_encoder}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("mode", nargs="?", default="train",
                   choices=("train", "fused-bwd", "attention", "structured", "routed", "fwht",
                            "linear-bwd", "linear-fwd", "distill", *JAX_MODES))
    p.add_argument("--config", default=FLAGSHIP)
    p.add_argument("--batch", type=int, nargs="*", default=None,
                   help="default 256 1024; 8 for latency, linear, mixer and encoder")
    p.add_argument("--mix-block", type=int, default=None, help="override the config's mix_block")
    p.add_argument("--out", default=os.path.join("build", "perf.json"))
    for flag, default in (("--tokens", 65), ("--embed", 512), ("--out-dim", 512), ("--blk", 64),
                          ("--head-dim", 32)):
        p.add_argument(flag, type=int, default=default, help="kernel modes only")
    p.add_argument("--heads", type=int, default=None,
                   help="default 16; 4 for latency, linear, mixer and encoder")
    p.add_argument("--iters", type=int, default=None,
                   help="default 30; 100 for latency, linear, mixer and encoder")
    # the JAX package's sweeps: its flags and defaults
    p.add_argument("--warmup", type=int, default=10)
    p.add_argument("--embed-dim", dest="embed_dim", type=int, default=512)
    p.add_argument("--max-pow", dest="max_pow", type=int, default=13)
    p.add_argument("--mix-impl", dest="mix_impl", default="gather")
    p.add_argument("--use-pallas", dest="use_pallas", action="store_true",
                   help="accepted for the JAX package's command lines; no effect here")
    p.add_argument("--device", default="cuda",
                   help="latency, linear, mixer and encoder only (the others need a card)")
    args = p.parse_args(argv)
    sweep = args.mode in JAX_MODES
    args.batch = args.batch or ([8] if sweep else [256, 1024])
    args.heads = args.heads or (4 if sweep else 16)
    args.iters = args.iters or (100 if sweep else 30)
    if sweep:
        device = cli_device(args.device)
        card = card_and_power_limit() if device.type == "cuda" else "cpu"
        print(f"card: {card}; torch {torch.__version__}", flush=True)
        if args.use_pallas:
            print("--use-pallas has no effect: on a card the port always runs its kernels",
                  flush=True)
        if device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
        return {"card": card, args.mode: JAX_MODES[args.mode](args, device)}
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this measures on a CUDA card")
    cfg = parse_config(args.config)
    if args.mix_block is not None:
        cfg.mix_block = args.mix_block
    card = card_and_power_limit()
    print(f"card: {card}; torch {torch.__version__}; model={cfg.model} method={cfg.method} "
          f"mix_block={getattr(cfg, 'mix_block', 0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.mode == "fused-bwd":
        return {"card": card, "fused_bwd": fused_bwd(args)}
    if args.mode == "attention":
        return {"card": card, "attention": attention(args)}
    if args.mode == "structured":
        return {"card": card, "structured": structured(args)}
    if args.mode == "routed":
        return {"card": card, "routed": routed(args)}
    if args.mode == "fwht":
        return {"card": card, "fwht": fwht_times(args)}
    if args.mode == "linear-bwd":
        return {"card": card, "linear_bwd": linear_bwd(args)}
    if args.mode == "linear-fwd":
        return {"card": card, "linear_fwd": linear_fwd(args)}
    if args.mode == "distill":
        out = {"card": card, "distill": [distill_profile(cfg, b) for b in args.batch]}
        for r in out["distill"]:
            for name in ("teacher", "step_cached", "step_recompute"):
                t = r[name]
                print(f"distill B={r['batch']} {name}: {t['events_ms_median']:.2f} ms by CUDA "
                      f"events, {t['device_ms_per_step']:.2f} ms of kernels (idle share "
                      f"{t['idle_share']:.3f}), peak {t['peak_gb']:.2f} GB", flush=True)
                for group, g in t["by_group"].items():
                    print(f"  {g['ms_per_step']:8.3f} ms  x{g['launches_per_step']:6.1f}  "
                          f"{group}", flush=True)
                for row in t["by_kernel"][:8]:
                    print(f"    {row['ms_per_step']:8.3f} ms  x{row['launches_per_step']:6.1f}  "
                          f"{row['name']}", flush=True)
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
        return out
    folded = (getattr(cfg, "model", "spectre_vit") == "spectre_vit"
              and getattr(cfg, "method", "permut_mix") == "permut_mix"
              and getattr(cfg, "mix_impl", "gather") == "folded")
    results = {"card": card, "model": cfg.model, "method": cfg.method,
               "mix_block": getattr(cfg, "mix_block", 0), "steps": [], "fold": {}}
    for batch in args.batch:
        r = profile_steps(cfg, batch)
        results["steps"].append(r)
        print(f"B={batch}: {r['events_ms_median']:.2f} ms/step by CUDA events "
              f"({r['events_ms_min']:.2f}-{r['events_ms_max']:.2f}), host clock "
              f"{r['host_ms']:.2f} ms, {r['img_per_s']:.0f} img/s, peak {r['peak_gb']:.2f} GB; "
              f"profiled: {r['device_ms_per_step']:.2f} ms of kernels in a "
              f"{r['profiled_span_ms_per_step']:.2f} ms profiled step (idle share "
              f"{r['idle_share_profiled']:.3f}); idle share of the unprofiled step "
              f"{r['idle_share']:.3f}; "
              f"non-contiguous cotangents {r['noncontiguous_cotangents']} of "
              f"{r['cotangents_seen']}", flush=True)
        for group, g in r["by_group"].items():
            print(f"  {g['ms_per_step']:8.3f} ms  x{g['launches_per_step']:6.1f}  {group}",
                  flush=True)
        for row in r["by_kernel"]:
            print(f"    {row['ms_per_step']:8.3f} ms  x{row['launches_per_step']:6.1f}  "
                  f"{row['name']}", flush=True)
        torch.cuda.empty_cache()
        if not folded:
            continue
        f = fold_variants(cfg, batch)
        results["fold"][str(batch)] = f
        print(f"B={batch} folded projection fwd+bwd, one layer: fold weights "
              f"{f['fold_weights_ms']:.3f} ms, signs on activations "
              f"{f['sign_activations_ms']:.3f} ms, fold weights again "
              f"{f['fold_weights_again_ms']:.3f} ms", flush=True)
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(results, fh, indent=1)
    return results


if __name__ == "__main__":
    main()
