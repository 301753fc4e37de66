"""The headline number of the port: images per second of the flagship train
step on one NVIDIA GPU.

    python -m spectre_tpu_torch.repl.bench [--batch 1024] [--config <config.py>]

Prints one JSON line: img/s, ms per step, peak device memory, model FLOP
utilisation, and the card's name and power limit. The step is the one the
trainer runs: the dataset's device-side augmentation, forward, backward,
clipping when configured, AdamW; on one fixed synthetic batch of raw pixels.

Timing is a two-point slope: the loop is timed on the host clock, with a
device synchronise before and after, at two iteration counts (best of a few
runs each), and the time per step is the slope between them, which cancels
whatever constant a run carries. A slope that is not positive, or an implied
constant well below zero (time not linear in the step count), fails hard.

FLOPs are counted from the config, because the hand-written kernels are
launched through ctypes and ``torch.utils.flop_counter`` does not see them.
Per image, the forward is the sum of 2*M*N*K over its products: the patch
embedding (Np x C*P*P x E), per layer the mix projection (N x E*H x E), its
pool residual (N*E*H additions as a grouped mean, a product when E does not
divide E*H), ``linear1`` (N x E x hidden) and ``linear3`` (N x hidden x E), each with
its pool-residual product when the widths neither match nor divide, and the
head (E x classes, likewise); with N = Np + 1 tokens. The backward counts
twice the forward, so a step is 3 * forward * batch. Elementwise work,
LayerNorm and the optimizer are not counted. The utilisation is against the
published dense bf16 tensor-core peak of the card, looked up by its name; an
unknown card raises, and a utilisation above 100% fails hard.
"""

from __future__ import annotations

import argparse
import json
import time
from types import SimpleNamespace

import torch

from spectre_tpu_torch.configs import FLAGSHIP

# published dense bf16 tensor-core peaks (NVIDIA data sheets), by the name
# torch.cuda.get_device_name gives
PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,  # H100 SXM
    "NVIDIA H100 PCIe": 756e12,
}
WARMUP, ITERS_SHORT, ITERS_LONG, REPS = 3, 5, 15, 3


def _linear_flops(rows: int, k: int, n: int) -> int:
    """A SpectreLinear over ``rows`` rows: the product, and the pool residual
    (nothing when k == n, a grouped mean when n divides k, else a product)."""
    pool = 0 if k == n else (rows * k if k % n == 0 else 2 * rows * k * n)
    return 2 * rows * k * n + pool


def forward_flops_per_image(config: SimpleNamespace) -> int:
    e, hd, heads = int(config.embed_dim), int(config.hidden_dim), int(config.num_heads)
    p, c = int(config.patch_size), int(config.in_channels)
    n_patches = (int(config.img_size) // p) ** 2
    n = n_patches + 1
    embed = 2 * n_patches * (c * p * p) * e
    layer = _linear_flops(n, e * heads, e) + _linear_flops(n, e, hd) + _linear_flops(n, hd, e)
    head = _linear_flops(1, e, int(config.num_classes))
    return embed + int(config.num_encoders) * layer + head


def train_flops_per_step(config: SimpleNamespace, batch: int) -> int:
    return 3 * forward_flops_per_image(config) * batch


def peak_flops(device_name: str) -> float:
    try:
        return PEAK_BF16_FLOPS[device_name]
    except KeyError:
        raise RuntimeError(
            f"no published bf16 peak on record for {device_name!r}; add it to "
            f"PEAK_BF16_FLOPS (known: {sorted(PEAK_BF16_FLOPS)})") from None


def slope_seconds(dt_short: float, dt_long: float, n_short: int, n_long: int) -> tuple[float, float]:
    """(seconds per step, implied constant) from two timed runs; raises when
    the two do not lie on a rising line."""
    slope = (dt_long - dt_short) / (n_long - n_short)
    const = dt_short - n_short * slope
    if slope <= 0 or const < -0.15 * dt_long:
        raise RuntimeError(
            f"non-linear timing: {n_long} steps took {dt_long:.3f} s but {n_short} steps took "
            f"{dt_short:.3f} s (slope {slope:.4f} s, implied constant {const:.3f} s): the "
            "clock is not measuring the device's work")
    return slope, const


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default=FLAGSHIP)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--set", nargs="*", default=[], help="config overrides key=value")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: the bench runs on a CUDA card")

    from spectre_tpu_torch.configs import apply_overrides, parse_config
    from spectre_tpu_torch.data import synthetic_batch
    from spectre_tpu_torch.train import make_train_step
    from spectre_tpu_torch.train.loop import create_trainer, default_augment
    from spectre_tpu_torch.utils import card_and_power_limit

    cfg = apply_overrides(parse_config(args.config), args.set)
    batch = args.batch
    kind = torch.cuda.get_device_name(0)
    peak = peak_flops(kind)
    card = card_and_power_limit()
    state = create_trainer(cfg, "cuda", steps_per_epoch=16)
    step = make_train_step(default_augment(cfg.dataset, cfg.in_channels),
                           grad_accum_steps=int(getattr(cfg, "grad_accum_steps", 1)),
                           grad_clip_norm=getattr(cfg, "grad_clip_norm", None))
    x, y = (torch.from_numpy(a).cuda() for a in synthetic_batch(cfg.dataset, batch))

    def timed(iters: int) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            metrics = step(state, x, y)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if not torch.isfinite(metrics["loss"]):
            raise RuntimeError(f"non-finite loss in the bench: {metrics['loss'].item()}")
        return dt

    timed(WARMUP)
    torch.cuda.reset_peak_memory_stats()
    dt_short = min(timed(ITERS_SHORT) for _ in range(REPS))
    dt_long = min(timed(ITERS_LONG) for _ in range(REPS))
    slope, const = slope_seconds(dt_short, dt_long, ITERS_SHORT, ITERS_LONG)
    flops = train_flops_per_step(cfg, batch)
    mfu = flops / slope / peak
    if mfu > 1.0:
        raise RuntimeError(f"the bench reports {mfu * 100:.1f}% MFU ({flops / 1e12:.2f} TFLOP a "
                           f"step in {slope * 1e3:.3f} ms against {peak / 1e12:.0f} TFLOP/s): "
                           "impossible, refusing to report")
    result = {
        "metric": f"{cfg.model}_{cfg.dataset}_train_images_per_sec",
        "value": batch / slope, "unit": "images/sec on one card",
        "ms_per_step": slope * 1e3, "batch": batch, "augmentation": True,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "flops_per_step": flops, "mfu_pct": mfu * 100, "peak_bf16_tflops": peak / 1e12,
        "constant_ms": const * 1e3, "device_kind": kind, "card": card,
        "compute_dtype": cfg.compute_dtype, "mix_block": int(getattr(cfg, "mix_block", 0)),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
