"""Train SpectreViT with the port.

    python -m spectre_tpu_torch.repl.train --synthetic --steps 20 --no-checkpoint
    python -m spectre_tpu_torch.repl.train --config <config.py> --synthetic \\
        --no-checkpoint --set epochs=1 batch_size=1024
    python -m spectre_tpu_torch.repl.train ... --device cpu     # tests, smoke

``--config`` defaults to the port's flagship, ``spectre_tpu_torch/configs/
spectre_vit_cifar100.py``. ``--device cuda`` (the default) refuses to start
when no CUDA device is present. Dataset files and checkpoints are not ported
yet, so ``--synthetic`` and ``--no-checkpoint`` are required; ``--resume``
and ``--multihost`` raise with a pointer to ROADMAP.md.
"""

from __future__ import annotations

import argparse

import torch

from spectre_tpu_torch.configs import FLAGSHIP


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default=FLAGSHIP, help="path to a python config file")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--steps", type=int, default=None, help="cap total train steps")
    p.add_argument("--synthetic", action="store_true", help="train on the synthetic dataset")
    p.add_argument("--no-checkpoint", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--multihost", action="store_true")
    p.add_argument("--set", nargs="*", default=[], help="config overrides key=value")
    args = p.parse_args(argv)

    for flag, on in (("--resume", args.resume), ("--multihost", args.multihost)):
        if on:
            raise NotImplementedError(f"{flag} is not ported yet (ROADMAP.md, queue A7)")
    if not args.no_checkpoint:
        raise NotImplementedError("checkpoints are not ported yet (ROADMAP.md, queue A7): "
                                  "pass --no-checkpoint")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asked, but torch.cuda.is_available() is "
                           "False; pass --device cpu to train on the CPU")

    from spectre_tpu_torch.configs import apply_overrides, parse_config
    from spectre_tpu_torch.train import train_from_config

    config = apply_overrides(parse_config(args.config), args.set)
    result = train_from_config(config, device=device, max_steps=args.steps,
                               synthetic=args.synthetic)
    print(f"done: {result.state.step} steps, last train loss {result.train_losses[-1]:.4f}, "
          f"best val acc {result.best_val_accuracy:.4f} ({result.steps_per_sec:.2f} steps/s, "
          f"{result.images_per_sec:.1f} img/s)", flush=True)
    return result


if __name__ == "__main__":
    main()
