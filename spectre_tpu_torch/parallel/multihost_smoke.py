"""Multi-process smoke worker (port of spectre_tpu/parallel/multihost_smoke.py).

Runs in each of ``--num-processes`` processes, which meet through
``--init-method`` (``file:///path`` or ``tcp://host:port``), NCCL on the
card by default (one card per process) or gloo with ``--device cpu``. Four
legs, as in the JAX package:

- the bare step: a tiny SpectreViT under DDP, one train step on this
  rank's slice of a global batch, then a checkpoint save and restore
  through ``train/checkpoint.py`` (``--ckpt-dir``) that must give back every
  parameter bit for bit;
- ``--fsdp``: the same with parameters and AdamW moments sharded over the
  data axis (``min_size=256``), checking that each rank holds only its
  shard;
- ``--train-loop``: ``train_from_config`` across the processes (per-rank data
  slices, masked validation, metrics on rank 0);
- ``--distill-loop``: ``distill_from_config`` with a tiny teacher and its
  logit cache over each rank's slice.

Each process prints one JSON line with the JAX worker's keys, one line a
leg; ``--all`` runs the four legs in one start of the processes:

    python -m spectre_tpu_torch.parallel.multihost_smoke \\
        --init-method file:///tmp/rdv --num-processes 2 --process-id 0 --ckpt-dir /tmp/ckpt

(``--device cpu`` for the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
from types import SimpleNamespace


def _config(**over) -> SimpleNamespace:
    cfg = SimpleNamespace(
        model="spectre_vit", method="permut_mix", dataset="mnist", img_size=8,
        patch_size=4, in_channels=1, num_classes=10, embed_dim=16, num_encoders=1,
        num_heads=2, hidden_dim=24, dropout=0.0, batch_size=8, val_batch_size=8, epochs=1,
        learning_rate=1e-3, random_seed=0, compute_dtype="float32", mix_impl="folded")
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


def _bare_step(args, device, world, fsdp: bool, ckpt_dir: str) -> dict:
    import numpy as np
    import torch
    from torch.distributed.tensor import DTensor

    from spectre_tpu_torch.parallel import DATA_AXIS, create_mesh, local_rows, parallelize
    from spectre_tpu_torch.train.loop import create_trainer
    from spectre_tpu_torch.train.step import make_train_step

    cfg = _config(in_channels=3, num_classes=5)
    mesh = create_mesh(device_type=device.type)
    state = parallelize(create_trainer(cfg, device, steps_per_epoch=1), mesh, fsdp=fsdp,
                        min_size=256, seed=0)
    rng = np.random.default_rng(0)  # the same global batch everywhere
    x = torch.from_numpy(rng.uniform(0, 1, (8, 3, 8, 8)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 5, 8).astype(np.int64))
    rows = local_rows(mesh, 8)
    metrics = make_train_step()(state, x[rows].to(device), y[rows].to(device))
    out = {"loss": float(metrics["loss"]), "step": state.step}
    if fsdp:
        dp = mesh.size(mesh.mesh_dim_names.index(DATA_AXIS))
        big = [p for p in state.model.parameters() if p.numel() >= 256]
        moments = [state.optimizer.state[p] for p in big]
        out["fsdp_sharded"] = bool(big) and all(
            isinstance(t, DTensor) and t.to_local().numel() == t.numel() // dp
            for p, m in zip(big, moments) for t in (p, m["exp_avg"], m["exp_avg_sq"]))
    restored = None
    if ckpt_dir:
        from spectre_tpu_torch.train.checkpoint import CheckpointManager

        def whole():
            return {k: (v.full_tensor() if isinstance(v, DTensor) else v).clone()
                    for k, v in state.model.state_dict().items()}

        before = whole()
        ckpt = CheckpointManager(ckpt_dir, max_to_keep=1)
        ckpt.save(state, {"accuracy": 0.0})
        with torch.no_grad():
            for p in state.model.parameters():
                p.zero_()
        ckpt.restore(state)
        after = whole()
        restored = all(torch.equal(before[k], after[k]) for k in before)
    out["restore_exact"] = restored
    return out


def _train_loop(args, device, world) -> dict:
    from spectre_tpu_torch.train.loop import train_from_config

    cfg = _config(batch_size=4 * world, val_batch_size=4 * world,
                  checkpoint_dir=args.ckpt_dir or "runs")
    result = train_from_config(cfg, device=device, synthetic=True, max_steps=2,
                               checkpoint=False, write_metrics=False)
    return {"loss": result.train_losses[-1], "step": result.state.step,
            "val_accuracy": result.last_val_accuracy, "restore_exact": None}


def _distill_loop(args, device, world) -> dict:
    import torch

    from spectre_tpu_torch.distill import DinoClassifier, DinoVisionTransformer
    from spectre_tpu_torch.distill.loop import distill_from_config
    from spectre_tpu_torch.distill.teacher import init_teacher

    # batches of 64 a rank: the logit table of a rank's 2,048 samples takes
    # 32 teacher calls
    cfg = _config(batch_size=64 * world, val_batch_size=64 * world,
                  checkpoint_dir=args.ckpt_dir or "runs")
    teacher = DinoClassifier(DinoVisionTransformer(
        img_size=16, patch_size=16, embed_dim=32, depth=2, num_heads=2, num_registers=2,
        variant="v3", device=device), 10)
    init_teacher(teacher, torch.Generator().manual_seed(1))
    result = distill_from_config(cfg, device=device, synthetic=True, max_steps=2,
                                 teacher=teacher, write_metrics=False, checkpoint=False,
                                 cache_teacher=True)
    return {"loss": result.metrics["loss"], "step": result.state.step, "restore_exact": None}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--init-method", required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--ckpt-dir", default="")
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"],
                   help="cuda (NCCL, a card per process; the default) or cpu (gloo)")
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="gloo with --device cuda: gloo's collectives on card tensors, "
                        "every process on card 0")
    p.add_argument("--train-loop", action="store_true",
                   help="run train_from_config across the processes")
    p.add_argument("--distill-loop", action="store_true",
                   help="run distill_from_config with the per-rank teacher-logit cache")
    p.add_argument("--fsdp", action="store_true",
                   help="the bare step with parameters and moments sharded (FSDP2)")
    p.add_argument("--all", action="store_true",
                   help="the four legs in turn: the bare step, --fsdp, --train-loop, "
                        "--distill-loop (checkpoints under <ckpt-dir>/<leg>)")
    args = p.parse_args(argv)

    import torch
    import torch.distributed as dist

    from spectre_tpu_torch.parallel import init_distributed

    shared_card = args.backend == "gloo" and args.device == "cuda"
    rank, world = init_distributed(args.init_method, rank=args.process_id,
                                   world_size=args.num_processes,
                                   local_rank=0 if shared_card else args.process_id,
                                   device=args.device, backend=args.backend)
    device = torch.device("cuda", torch.cuda.current_device()) if args.device == "cuda" \
        else torch.device("cpu")
    if args.all:
        legs = ["step", "fsdp", "train-loop", "distill-loop"]
    else:
        legs = ["train-loop" if args.train_loop else "distill-loop" if args.distill_loop
                else "fsdp" if args.fsdp else "step"]
    for leg in legs:
        ckpt = args.ckpt_dir and (os.path.join(args.ckpt_dir, leg) if args.all
                                  else args.ckpt_dir)
        if leg in ("step", "fsdp"):
            out = _bare_step(args, device, world, leg == "fsdp", ckpt)
        elif leg == "train-loop":
            out = _train_loop(args, device, world)
        else:
            out = _distill_loop(args, device, world)
        print(json.dumps({"leg": leg, "process_id": rank, "process_count": world,
                          "global_devices": world, **out}), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
