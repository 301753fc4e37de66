"""Distil the DINOv3 teacher into SpectreViT with the port.

    python -m spectre_tpu_torch.repl.distill --config spectre_tpu_torch/configs/distill_cifar100.py --synthetic
    python -m spectre_tpu_torch.repl.distill ... --steps 3                # smoke
    python -m spectre_tpu_torch.repl.distill ... --resume                 # exact resume
    python -m spectre_tpu_torch.repl.distill ... --device cpu             # tests

``--device cuda`` (the default) refuses to start when no CUDA device is
present. Real DINOv3 weights load from the config's ``teacher_checkpoint``
or ``$SPECTRE_TEACHER_WEIGHTS`` (an ``.npz`` of the torch ``state_dict``,
see ``distill/teacher.py``); otherwise the teacher is a seeded random
ViT-S/16. ``--set teacher_depth=... teacher_embed_dim=...`` (also
``teacher_num_heads``, ``teacher_num_registers``, ``teacher_patch_size``)
shrinks it, and ``--teacher-size`` sets its input size. Metric files and a
checkpoint per epoch go under ``<checkpoint_dir>/distill_<experiment>/``
unless ``--no-checkpoint``; a SIGTERM or SIGINT finishes the step, saves and
stops. ``--multihost`` trains the student on a mesh over torchrun's ranks,
as ``repl/train.py --multihost`` does (``--set fsdp=True`` for FSDP,
``model_parallel=2`` for tensor parallelism, ``--backend gloo`` for ranks
that share a card).
"""

from __future__ import annotations

import argparse

import torch


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", required=True, help="path to a python config file")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--steps", type=int, default=None, help="cap total train steps")
    p.add_argument("--synthetic", action="store_true", help="train on the synthetic dataset")
    p.add_argument("--teacher-size", type=int, default=224, help="the teacher's input size")
    p.add_argument("--no-checkpoint", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest distill checkpoint")
    p.add_argument("--no-teacher-cache", action="store_true",
                   help="run the teacher every step instead of caching its logits once")
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
                           "False; pass --device cpu to run on the CPU")
    if args.multihost:
        from spectre_tpu_torch.parallel import init_distributed

        init_distributed(device=device.type, backend=args.backend)

    from spectre_tpu_torch.configs import apply_overrides, parse_config
    from spectre_tpu_torch.distill import distill_from_config

    config = apply_overrides(parse_config(args.config), args.set)
    result = distill_from_config(
        config, device=device, max_steps=args.steps, synthetic=args.synthetic,
        teacher_img_size=args.teacher_size, checkpoint=not args.no_checkpoint,
        resume=args.resume, cache_teacher=False if args.no_teacher_cache else None)
    if args.multihost:
        main_rank = result.state.layout is None or result.state.layout.is_main
        torch.distributed.destroy_process_group()
        if not main_rank:
            return result
    m = result.metrics
    print(f"distill done: step {result.state.step} loss {m['loss']:.4f} (kd "
          f"{m['loss_dist']:.4f} / ce {m['loss_ce']:.4f}) -> {result.logdir}", flush=True)
    return result


if __name__ == "__main__":
    main()
