"""Where a flagship train step spends its time on the card.

    python -m spectre_tpu_torch.repl.perf [--batch 256 1024] [--mix-block 64]
        [--out build/perf.json]

Needs a CUDA card. For each batch size it builds the flagship trainer
(synthetic data, the port's seeded init) and prints:

1. ms per step over 10 steps after 3 warm-up steps, by CUDA events (median)
   and on the host clock (synchronised), img/s, peak device memory;
2. device time of one step (``torch.profiler`` over 3 steps, kernel events
   only) by group of kernels and for the largest kernels by name, and the
   idle share (1 - kernel time / step time), against the profiled step and
   against the unprofiled one of item 1;
3. which cotangents reach the two mix Functions' backwards non-contiguous
   (those are copied once, by ``.contiguous()``), and how many bytes;
4. the folded projection's forward + backward by itself at the layer's
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
import subprocess
import time
from unittest import mock

import torch

from spectre_tpu_torch.configs import FLAGSHIP, parse_config
from spectre_tpu_torch.data import synthetic_dataset
from spectre_tpu_torch.ops import fused_mix
from spectre_tpu_torch.train import make_train_step
from spectre_tpu_torch.train.loop import create_trainer, make_normalize


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
    state = create_trainer(cfg, "cuda", steps_per_epoch=16)
    step = make_train_step(grad_clip_norm=cfg.grad_clip_norm)
    x, y = synthetic_dataset(cfg.dataset, "train")
    reps = -(-batch // len(x))
    x = torch.from_numpy(x).repeat(reps, 1, 1, 1)[:batch].cuda()
    y = torch.from_numpy(y).repeat(reps)[:batch].cuda()
    x = make_normalize(cfg.dataset, x.device)(x)
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
    # kernel events only: an operator's row repeats the time of its kernels
    rows = [(e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
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


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default=FLAGSHIP)
    p.add_argument("--batch", type=int, nargs="*", default=[256, 1024])
    p.add_argument("--mix-block", type=int, default=None, help="override the config's mix_block")
    p.add_argument("--out", default=os.path.join("build", "perf.json"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this measures on a CUDA card")
    cfg = parse_config(args.config)
    if args.mix_block is not None:
        cfg.mix_block = args.mix_block
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}; mix_block={cfg.mix_block}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    results = {"card": card, "mix_block": cfg.mix_block, "steps": [], "fold": {}}
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
