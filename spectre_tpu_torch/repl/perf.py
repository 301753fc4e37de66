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

Needs a CUDA card. ``attention`` and ``structured`` (the counterparts of the
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
shapes in bf16 both ways, the chain of the train step (``_FoldedProj``'s
``dg4`` product and signs, then ``block_gather_sum``) and the one-launch
kernel ``fused_block_bwd``, and prints their largest difference, both times,
GFLOP/s and the ratio.

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
import json
import os
import statistics
import time
from unittest import mock

import torch

from spectre_tpu_torch.configs import FLAGSHIP, parse_config
from spectre_tpu_torch.data import synthetic_batch
from spectre_tpu_torch.ops import fused_mix
from spectre_tpu_torch.ops import structured_mix as structured_mix_matrix
from spectre_tpu_torch.ops.kernels import (
    block_gather_sum,
    flash_attention,
    flash_attention_plain,
    fused_block_bwd,
    inverse_gather_sum,
    invert_tile_perms,
    routed_gather_sum,
    routed_gather_sum_plain,
    structured_mix_grad,
    structured_mix_plain,
)
from spectre_tpu_torch.ops.routing import build_route_tables_cached
from spectre_tpu_torch.train.loop import build_step
from spectre_tpu_torch.utils import card_and_power_limit


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
    ("fused_spectre_linear_kernel", "kernel 2 fused_spectre_linear_fwd"),
    ("flash_attention_fwd_kernel", "kernel 8 flash_attention_fwd"),
    ("flash_attention_bwd_kernel", "kernel 9 flash_attention_bwd"),
    ("structured_mix_kernel", "kernel 7 structured_mix (forward and backward)"),
    ("fwht_kernel", "kernel 6 fwht"),
    ("f32f32", "matrix products, f32"), ("simt_sgemm", "matrix products, f32"),
    ("gemm", "matrix products, bf16"), ("nvjet", "matrix products, bf16"),
    ("cutlass", "matrix products, bf16"), ("gemv", "matrix products, bf16"),
    ("multi_tensor_apply", "optimizer (foreach)"),
    ("layer_norm", "LayerNorm"), ("LayerNorm", "LayerNorm"),
    ("reduce_kernel", "reductions"),
    ("elementwise", "elementwise (casts, signs, adds, GELU chain, dropout)"),
)


def _group(kernel_name: str) -> str:
    for needle, group in _GROUPS:
        if needle in kernel_name:
            return group
    return "other"


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

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        span = _events_ms(lambda: [step(state, x, y) for _ in range(n)], 1)[0]
    # kernel events only: an operator's row repeats the time of its kernels,
    # and so does the range torch.optim records around a step on the device's
    # timeline ("Optimizer.step#AdamW.step"), which is no kernel
    rows = [(e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not e.key.startswith("Optimizer.")]
    rows.sort(key=lambda r: -r[2])
    device_ms = sum(r[2] for r in rows)
    groups: dict[str, list] = {}
    for key, count, ms in rows:
        g = groups.setdefault(_group(key), [0, 0.0])
        g[0] += count
        g[1] += ms
    res.update(profiled_span_ms_per_step=span / n, device_ms_per_step=device_ms / n,
               idle_share_profiled=1.0 - device_ms / span,
               # the profiler slows the host: against the unprofiled step time.
               # Not clamped: a negative share means the kernel rows were miscounted
               idle_share=1.0 - device_ms / n / res["events_ms_median"],
               by_group={k: {"launches_per_step": c / n, "ms_per_step": ms / n}
                         for k, (c, ms) in sorted(groups.items(), key=lambda kv: -kv[1][1])},
               by_kernel=[{"name": k[:110], "launches_per_step": c / n, "ms_per_step": ms / n}
                          for k, c, ms in rows[:14]])
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


def fused_bwd(args) -> dict:
    """The mix backward at one layer's shapes, bf16: chain against kernel."""
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


HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published


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


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("mode", nargs="?", default="train",
                   choices=("train", "fused-bwd", "attention", "structured", "routed"))
    p.add_argument("--config", default=FLAGSHIP)
    p.add_argument("--batch", type=int, nargs="*", default=[256, 1024])
    p.add_argument("--mix-block", type=int, default=None, help="override the config's mix_block")
    p.add_argument("--out", default=os.path.join("build", "perf.json"))
    for flag, default in (("--heads", 16), ("--tokens", 65), ("--embed", 512),
                          ("--out-dim", 512), ("--blk", 64), ("--iters", 30),
                          ("--head-dim", 32)):
        p.add_argument(flag, type=int, default=default, help="kernel modes only")
    args = p.parse_args(argv)
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
