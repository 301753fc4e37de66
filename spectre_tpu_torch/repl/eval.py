"""Evaluate a checkpoint: restore a trained state and report the validation
loss and top-1 accuracy.

    python -m spectre_tpu_torch.repl.eval --config <config.py> \\
        --checkpoint runs/<experiment>/ckpt [--best] [--synthetic] [--device cpu]

Without ``--checkpoint`` it evaluates the seeded initial weights.
"""

from __future__ import annotations

import argparse
from types import SimpleNamespace

import torch

from spectre_tpu_torch.configs import FLAGSHIP


def evaluate(config: SimpleNamespace, checkpoint: str | None = None, best: bool = False,
             synthetic: bool = False,
             device: torch.device | str = "cuda") -> tuple[float, float]:
    """(validation loss, top-1 accuracy) of the latest (or ``best``) step
    under ``checkpoint``."""
    from spectre_tpu_torch.data import BatchIterator, make_eval_transform
    from spectre_tpu_torch.train.checkpoint import CheckpointManager
    from spectre_tpu_torch.train.loop import (
        create_trainer,
        dataset_stats,
        evaluate_state,
        load_sized_dataset,
    )
    from spectre_tpu_torch.train.step import make_eval_step

    device = torch.device(device)
    val_x, val_y = load_sized_dataset(config, "test", synthetic)
    state = create_trainer(config, device, steps_per_epoch=1)
    if checkpoint:
        mgr = CheckpointManager(checkpoint)
        mgr.restore(state, step=mgr.best_step if best else None)
        print(f"restored step {state.step} from {checkpoint}"
              f"{' (best)' if best else ' (latest)'}", flush=True)
    transform = make_eval_transform(*dataset_stats(getattr(config, "dataset", "mnist")))
    batches = BatchIterator(val_x, val_y, int(getattr(config, "val_batch_size", 256)),
                            shuffle=False)
    loss, acc, count = evaluate_state(state, make_eval_step(state.model), transform, batches,
                                      device)
    print(f"val: loss {loss:.4f} top-1 {acc:.4f} ({count} examples)", flush=True)
    return loss, acc


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default=FLAGSHIP, help="path to a python config file")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--checkpoint", default=None, help="a run's ckpt directory")
    p.add_argument("--best", action="store_true",
                   help="restore the step with the best validation accuracy, not the latest")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--set", nargs="*", default=[], help="config overrides key=value")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asked, but torch.cuda.is_available() is "
                           "False; pass --device cpu to evaluate on the CPU")

    from spectre_tpu_torch.configs import apply_overrides, parse_config

    config = apply_overrides(parse_config(args.config), args.set)
    return evaluate(config, args.checkpoint, args.best, args.synthetic, device)


if __name__ == "__main__":
    main()
