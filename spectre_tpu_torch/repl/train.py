"""Train SpectreViT with the port.

    python -m spectre_tpu_torch.repl.train --synthetic --steps 20
    python -m spectre_tpu_torch.repl.train --config <config.py> --set epochs=1 batch_size=1024
    python -m spectre_tpu_torch.repl.train ... --resume           # exact resume
    python -m spectre_tpu_torch.repl.train ... --device cpu       # tests, smoke

``--config`` defaults to the port's flagship, ``spectre_tpu_torch/configs/
spectre_vit_cifar100.py``. ``--device cuda`` (the default) refuses to start
when no CUDA device is present. The dataset is read from ``data_dir``,
``$SPECTRE_DATA_DIR`` or ``./data`` (the synthetic set when no file is found,
or always with ``--synthetic``). Metric files and a checkpoint per epoch go
under ``<checkpoint_dir>/<experiment name>/`` unless ``--no-checkpoint``;
``--resume`` continues from the latest checkpoint there, and a SIGTERM or
SIGINT finishes the current step, saves and stops. A config with
``use_distillation = True`` runs the distill loop
(``distill/loop.py::distill_from_config``, as ``repl/distill.py`` does).

``--multihost`` joins the process group that torchrun describes
(``parallel.init_distributed``: NCCL on the card this rank's LOCAL_RANK
names, gloo with ``--device cpu``; ``--backend gloo`` on the card lets ranks
share a card, as NCCL does not) and trains on the ("data", "model") mesh
over every rank: DDP, or FSDP with ``--set fsdp=True``, or tensor
parallelism with ``--set model_parallel=2`` (with ``fsdp=True``, both);
``batch_size`` is the global batch:

    torchrun --standalone --nproc_per_node 8 -m spectre_tpu_torch.repl.train \
        --multihost --synthetic --steps 20 [--set fsdp=True] [--set model_parallel=2]
    torchrun --standalone --nproc_per_node 2 -m spectre_tpu_torch.repl.train \
        --multihost --backend gloo --synthetic --steps 20 --set model_parallel=2
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
    p.add_argument("--resume", action="store_true", help="resume from the latest checkpoint")
    p.add_argument("--no-checkpoint", action="store_true")
    p.add_argument("--multihost", action="store_true",
                   help="join torchrun's process group and train on a mesh over its ranks")
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                   help="with --multihost: the collectives' backend (default NCCL on the "
                        "card, gloo on the CPU); gloo on the card lets ranks share a card")
    p.add_argument("--set", nargs="*", default=[], help="config overrides key=value")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asked, but torch.cuda.is_available() is "
                           "False; pass --device cpu to train on the CPU")
    if args.multihost:
        from spectre_tpu_torch.parallel import init_distributed

        init_distributed(device=device.type, backend=args.backend)

    from spectre_tpu_torch.configs import apply_overrides, parse_config
    from spectre_tpu_torch.train import train_from_config

    config = apply_overrides(parse_config(args.config), args.set)
    if getattr(config, "use_distillation", False):
        from spectre_tpu_torch.distill import distill_from_config

        result = distill_from_config(
            config, device=device, max_steps=args.steps, synthetic=args.synthetic,
            teacher_img_size=int(getattr(config, "teacher_img_size", 224)), resume=args.resume,
            checkpoint=not args.no_checkpoint)
        print(f"distill done: step {result.state.step} loss {result.metrics['loss']:.4f} -> "
              f"{result.logdir}", flush=True)
        return result
    result = train_from_config(config, device=device, max_steps=args.steps,
                               synthetic=args.synthetic, resume=args.resume,
                               checkpoint=not args.no_checkpoint)
    last = f"{result.train_losses[-1]:.4f}" if result.train_losses else "n/a"
    if args.multihost:
        main_rank = result.state.layout is None or result.state.layout.is_main
        torch.distributed.destroy_process_group()
        if not main_rank:
            return result
    print(f"done: {result.state.step} steps, last train loss {last}, "
          f"best val acc {result.best_val_accuracy:.4f} ({result.steps_per_sec:.2f} steps/s, "
          f"{result.images_per_sec:.1f} img/s) -> {result.logdir}", flush=True)
    return result


if __name__ == "__main__":
    main()
