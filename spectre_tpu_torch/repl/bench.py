"""The headline number of the port: images per second of a train step (the
flagship's by default) on one NVIDIA GPU.

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
twice the forward, so a step is 3 * forward * batch. For ``model = "vit"`` a
layer is instead the four attention projections (N x E x E each), the
attention itself (per head N x N x D for q k^T and again for P v: 4*N*N*E in
all) and the two Dense layers (N x E x hidden, N x hidden x E), and the head a
plain product. For ``model = "spectre_branch"`` (with ``permut_mix``) a layer
is the mix projection (N x E*H x E) and its grouped-mean pool (N*E*H),
``linear1``, ``linear2``, ``linear3`` (N x E x hidden, N x hidden x hidden,
N x hidden x E) and the fusion (N x 2E x E); each stage of the frequency
branch its 3x3 convolution (H'W' x 9I x 3I), its 1x1 projection
(H'W' x 3I x E) and its pool to N tokens (a product E x H'W' x N, a grouped
mean, or nothing); once per image the DFT products of the log-magnitude
spectrum; the head a plain product. Any other model or mixer is refused by
name: no utilisation is printed from a count that does not describe the
model. Elementwise work,
LayerNorm, the Hadamard butterflies and the optimizer are not counted. The utilisation is against the
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


def _pool_flops(rows: int, length: int, out_len: int) -> int:
    """adaptive_avg_pool1d of ``rows`` rows from ``length`` to ``out_len``."""
    if length == out_len:
        return 0
    return rows * length if length % out_len == 0 else 2 * rows * length * out_len


def _branch_flops_per_image(config: SimpleNamespace) -> int:
    """The frequency branch of SpectreBranch: the DFT products of
    log1p(|rfft2|) once, then per stage both convolutions and the pool."""
    c, size, e = int(config.in_channels), int(config.img_size), int(config.embed_dim)
    n = (size // int(config.patch_size)) ** 2 + 1
    f = size // 2 + 1
    flops = 2 * (2 * c * size * size * size) + 4 * (2 * c * size * size * f)
    height, width = size, f
    for _ in range(int(config.num_encoders)):
        height, width = height - 2, width - 2
        spatial = height * width
        flops += 2 * spatial * (9 * c) * (3 * c)  # the 3x3 convolution, c -> 3c
        c *= 3
        flops += 2 * spatial * c * e + _pool_flops(e, spatial, n)
    return flops


def forward_flops_per_image(config: SimpleNamespace) -> int:
    e, hd, heads = int(config.embed_dim), int(config.hidden_dim), int(config.num_heads)
    p, c = int(config.patch_size), int(config.in_channels)
    n_patches = (int(config.img_size) // p) ** 2
    n = n_patches + 1
    embed = 2 * n_patches * (c * p * p) * e
    model = getattr(config, "model", "spectre_vit")
    method = getattr(config, "method", "permut_mix")
    if model == "vit":
        layer = 4 * (2 * n * e * e) + 4 * n * n * e + 2 * n * e * hd + 2 * n * hd * e
        head = 2 * e * int(config.num_classes)
    elif model == "spectre_vit" and method == "permut_mix":
        layer = _linear_flops(n, e * heads, e) + _linear_flops(n, e, hd) \
            + _linear_flops(n, hd, e)
        head = _linear_flops(1, e, int(config.num_classes))
    elif model == "spectre_branch" and method == "permut_mix":
        layer = 2 * n * (e * heads) * e + _pool_flops(n, e * heads, e) \
            + 2 * n * e * hd + 2 * n * hd * hd + 2 * n * hd * e + 2 * n * (2 * e) * e
        head = 2 * e * int(config.num_classes)
        embed += _branch_flops_per_image(config)
    else:
        raise NotImplementedError(
            f"no FLOP count for model={model!r} with method={method!r}: the bench counts "
            "'vit', and 'spectre_vit' and 'spectre_branch' with method "
            "'permut_mix' only")
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
    train_flops_per_step(cfg, 1)  # refuse a model the count does not describe, up front
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
