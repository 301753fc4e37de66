"""Real-data reproduction harness (port of spectre_tpu/repl/reproduce.py):
the reference recipe (side A) against the port's trainer (side B).

    python -m spectre_tpu_torch.repl.reproduce --config spectre_tpu_torch/configs/spectre_vit_cifar100.py \\
        --reference-root <checkout of the reference>
    python -m spectre_tpu_torch.repl.reproduce --skip-torch --synthetic --steps 3   # side B only

Side A trains the reference's own ``SpectreViT``, imported from the
reference checkout that ``--reference-root`` (or ``$SPECTRE_REFERENCE_ROOT``)
names, with the reference recipe: eager torch with AMP and GradScaler on a
card, cross-entropy, AdamW with CosineAnnealingLR over the total steps, the
reference augmentation (torchvision when installed, else a plain-torch
subset that the report names), and the best per-epoch top-1 on the
validation split. Without a reference checkout side A is refused by name.

Side B is the port: ``train_from_config`` on the config unchanged (the
augmentation inside the step on the card, the port's kernels), reporting
the best validation top-1 and img/s. A config with ``mix_block > 0`` (block
permutation tables, another distribution than the reference samples) also
trains a uniform leg with ``mix_block=0`` unless ``--no-uniform-leg``.

Output: one line per side and one JSON line with both top-1s, their
difference, the within-0.2% verdict and the throughput ratio.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

import numpy as np
import torch

from spectre_tpu_torch.configs import FLAGSHIP, apply_overrides, parse_config
from spectre_tpu_torch.train import train_from_config
from spectre_tpu_torch.train.loop import dataset_stats, load_sized_dataset
from spectre_tpu_torch.utils import cli_device


def _torch_augment_factory(dataset: str, mean, std, report: dict):
    """Per-batch train augmentation of the reference recipe: for CIFAR-100
    RandomHorizontalFlip, ColorJitter, RandomGrayscale, RandomAffine(30),
    GaussianBlur, Normalize and RandomErasing; for MNIST RandomRotation(15)
    and Normalize. With torchvision the transforms themselves; without it
    flip, rotation, normalisation and erasing in plain torch, which the
    report records."""
    try:
        import torchvision.transforms.v2 as T
    except ImportError:
        T = None
    report["torch_aug"] = ("torchvision" if T is not None else
                           "plain-torch subset (hflip/rotate/normalize/erasing; "
                           "no jitter/grayscale/blur)")
    mean_t = torch.tensor(mean).view(1, -1, 1, 1)
    std_t = torch.tensor(std).view(1, -1, 1, 1)
    degrees = 15.0 if dataset == "mnist" else 30.0

    if T is not None:
        if dataset == "mnist":
            return T.Compose([T.RandomRotation(degrees), T.Normalize(list(mean), list(std))])
        return T.Compose([
            T.RandomHorizontalFlip(), T.ColorJitter(0.4, 0.4, 0.4, 0.1),
            T.RandomGrayscale(p=0.2), T.RandomAffine(degrees), T.GaussianBlur(3),
            T.Normalize(list(mean), list(std)), T.RandomErasing(p=0.25)])

    def rotate(x):
        b = x.shape[0]
        ang = (torch.rand(b, device=x.device) * 2 - 1) * np.deg2rad(degrees)
        cos, sin = torch.cos(ang), torch.sin(ang)
        theta = torch.zeros(b, 2, 3, device=x.device)
        theta[:, 0, 0], theta[:, 0, 1] = cos, -sin
        theta[:, 1, 0], theta[:, 1, 1] = sin, cos
        grid = torch.nn.functional.affine_grid(theta, list(x.shape), align_corners=False)
        return torch.nn.functional.grid_sample(x, grid, align_corners=False)

    def augment(x):
        if dataset != "mnist":
            flip = torch.rand(x.shape[0], device=x.device) < 0.5
            x = torch.where(flip.view(-1, 1, 1, 1), torch.flip(x, [-1]), x)
        x = (rotate(x) - mean_t.to(x.device)) / std_t.to(x.device)
        if dataset != "mnist":
            h, w = x.shape[-2:]
            eh, ew = max(1, h // 4), max(1, w // 4)
            for i in torch.nonzero(torch.rand(x.shape[0]) < 0.25).flatten().tolist():
                y0 = int(torch.randint(0, h - eh + 1, (1,)))
                x0 = int(torch.randint(0, w - ew + 1, (1,)))
                x[i, :, y0:y0 + eh, x0:x0 + ew] = 0.0
        return x

    return augment


def run_torch_reference(config, data, reference_root: str | None, device: torch.device, *,
                        max_steps: int | None = None, report: dict | None = None):
    """Train the reference checkout's SpectreViT with the reference recipe;
    (best top-1, img/s). Raises when ``reference_root`` is not a
    directory."""
    if not reference_root or not os.path.isdir(reference_root):
        raise FileNotFoundError(
            "side A (the reference recipe) needs a checkout of the reference SpectreViT: "
            f"--reference-root / $SPECTRE_REFERENCE_ROOT is {reference_root!r}; pass "
            "--skip-torch to run side B only")
    sys.path.insert(0, reference_root)
    from spectre_vit.models.spectre.spectre import SpectreViT as RefSpectreViT

    (xtr, ytr), (xva, yva) = data
    dataset = getattr(config, "dataset", "cifar100")
    report = report if report is not None else {}
    use_amp = device.type == "cuda"  # the reference's AMP is CUDA-only
    torch.manual_seed(getattr(config, "random_seed", 42))
    model = RefSpectreViT(
        img_size=int(config.img_size), patch_size=int(config.patch_size),
        in_channels=int(config.in_channels), num_classes=int(config.num_classes),
        embed_dim=int(config.embed_dim), num_encoders=int(config.num_encoders),
        num_heads=int(config.num_heads), hidden_dim=int(config.hidden_dim),
        dropout=float(config.dropout), activation="gelu").to(device)
    batch, epochs = int(config.batch_size), int(config.epochs)
    opt = torch.optim.AdamW(model.parameters(), lr=float(config.learning_rate),
                            betas=tuple(getattr(config, "adam_betas", (0.9, 0.999))),
                            weight_decay=float(getattr(config, "adam_weight_decay", 0.01)))
    sched = torch.optim.lr_scheduler.CosineAnnealingLR(
        opt, T_max=max(1, len(xtr) // batch) * epochs)
    scaler = torch.amp.GradScaler(enabled=use_amp)
    crit = torch.nn.CrossEntropyLoss()
    mean, std = dataset_stats(dataset)
    augment = _torch_augment_factory(dataset, mean, std, report)
    mean_t = torch.tensor(mean, device=device).view(1, -1, 1, 1)
    std_t = torch.tensor(std, device=device).view(1, -1, 1, 1)
    rng = np.random.default_rng(getattr(config, "random_seed", 42))
    best, total_steps, n_images, done = -1.0, 0, 0, False
    t0 = time.perf_counter()
    for _ in range(epochs):
        if done:
            break
        model.train()
        idx = rng.permutation(len(xtr))
        for i in range(0, len(xtr) - batch + 1, batch):
            sel = idx[i:i + batch]
            img = augment(torch.from_numpy(xtr[sel]).to(device))
            label = torch.from_numpy(ytr[sel].astype(np.int64)).to(device)
            with torch.autocast(device_type=device.type, enabled=use_amp):
                loss = crit(model(img), label)
            opt.zero_grad(set_to_none=True)
            scaler.scale(loss).backward()
            scaler.step(opt)
            scaler.update()
            sched.step()
            total_steps += 1
            n_images += batch
            if max_steps is not None and total_steps >= max_steps:
                done = True
                break
        model.eval()
        correct = 0
        vb = int(getattr(config, "val_batch_size", batch))
        with torch.no_grad():
            for i in range(0, len(xva), vb):
                img = (torch.from_numpy(xva[i:i + vb]).to(device) - mean_t) / std_t
                correct += int((model(img).argmax(1).cpu().numpy() == yva[i:i + vb]).sum())
        best = max(best, correct / len(xva))
    dt = time.perf_counter() - t0
    return best, n_images / dt if dt > 0 else 0.0


def run_port(config, device: torch.device, *, max_steps: int | None, synthetic: bool):
    """Side B: (best top-1, img/s) of the port's trainer on ``config``."""
    result = train_from_config(config, device=device, max_steps=max_steps, synthetic=synthetic,
                               write_metrics=False, checkpoint=False)
    return result.best_val_accuracy, result.images_per_sec


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default=FLAGSHIP)
    p.add_argument("--synthetic", action="store_true",
                   help="the synthetic set (a smoke run; the real one reads $SPECTRE_DATA_DIR)")
    p.add_argument("--steps", type=int, default=None, help="cap the steps of both sides")
    p.add_argument("--skip-torch", action="store_true", help="no side A")
    p.add_argument("--skip-port", action="store_true", help="no side B")
    p.add_argument("--no-uniform-leg", action="store_true",
                   help="no second side-B run with mix_block=0")
    p.add_argument("--reference-root", default=os.environ.get("SPECTRE_REFERENCE_ROOT"),
                   help="checkout of the reference (default $SPECTRE_REFERENCE_ROOT)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--out", default=None, help="write the JSON report here")
    p.add_argument("--set", nargs="*", default=[])
    args = p.parse_args(argv)
    device = cli_device(args.device)
    config = apply_overrides(parse_config(args.config), args.set)
    report = {"config": args.config, "dataset": getattr(config, "dataset", "?"),
              "synthetic": bool(args.synthetic), "device": str(device)}
    # one dataset load feeds both sides
    data = (load_sized_dataset(config, "train", args.synthetic),
            load_sized_dataset(config, "test", args.synthetic))

    if not args.skip_torch:
        t_top1, t_ips = run_torch_reference(config, data, args.reference_root, device,
                                            max_steps=args.steps, report=report)
        report["torch_top1"], report["torch_img_per_sec"] = round(t_top1, 4), round(t_ips, 2)
        print(f"reference torch: best top-1 {t_top1:.4f} ({t_ips:.1f} img/s)", flush=True)

    if not args.skip_port:
        legs = [("", config)]
        mix_block = int(getattr(config, "mix_block", 0))
        if mix_block and not args.no_uniform_leg:
            uniform = copy.deepcopy(config)
            uniform.mix_block = 0
            legs.append(("_uniform", uniform))
        report["port_mix_block"] = mix_block
        for suffix, cfg in legs:
            top1, ips = run_port(cfg, device, max_steps=args.steps, synthetic=args.synthetic)
            report["port_top1" + suffix] = round(top1, 4)
            report["port_img_per_sec" + suffix] = round(ips, 2)
            print(f"spectre_tpu_torch (mix_block={int(getattr(cfg, 'mix_block', 0))}): best "
                  f"top-1 {top1:.4f} ({ips:.1f} img/s)", flush=True)

    if "torch_top1" in report and "port_top1" in report:
        for suffix in ("", "_uniform"):
            if "port_top1" + suffix not in report:
                continue
            delta = report["port_top1" + suffix] - report["torch_top1"]
            report["top1_delta" + suffix] = round(delta, 4)
            report["within_0.2pct" + suffix] = bool(abs(delta) <= 0.002)
            print(f"top-1 delta{suffix.replace('_', ' ')} {delta:+.4f} "
                  f"({'WITHIN' if abs(delta) <= 0.002 else 'OUTSIDE'} 0.2%)", flush=True)
        if report["torch_img_per_sec"] > 0:
            report["throughput_ratio"] = round(
                report["port_img_per_sec"] / report["torch_img_per_sec"], 2)
    print(json.dumps(report), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
