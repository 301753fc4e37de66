"""Convert a JAX trainer's orbax checkpoint into the flat ``.npz`` that the
PyTorch port reads.

    python tools/orbax_to_npz.py --config spectre_tpu/configs/spectre_vit_cifar100.py \\
        --checkpoint runs/<experiment>/ckpt --out weights.npz [--step N] [--set key=value ...]

It rebuilds the JAX model and train state from ``--config`` (the shapes the
restore needs), restores the checkpoint through
``spectre_tpu.train.checkpoint.CheckpointManager`` at ``--step``, else its
best-metric step, else its latest, and writes ``{"params", "buffers"}`` with
``spectre_tpu_torch.models.save_npz``. The port then serves, exports or
fine-tunes the weights without JAX:

    python -m spectre_tpu_torch.repl.serve --ckpt weights.npz
    python -m spectre_tpu_torch.repl.export --checkpoint weights.npz

This is the one file outside the JAX package's tests that imports both
packages; it needs JAX and runs on the machine where the checkpoint was
written.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def convert(config, checkpoint: str, out: str, step: int | None = None) -> int:
    """Write the checkpoint's variables to ``out``; returns the step."""
    import jax
    import numpy as np

    from spectre_tpu.models import build_model
    from spectre_tpu.train.checkpoint import CheckpointManager
    from spectre_tpu.train.optim import make_optimizer
    from spectre_tpu.train.state import create_train_state
    from spectre_tpu_torch.models import save_npz

    model = build_model(config)
    x = jax.numpy.zeros((1, config.in_channels, config.img_size, config.img_size))
    state = create_train_state(model, make_optimizer(config, steps_per_epoch=1), x)
    mgr = CheckpointManager(checkpoint)
    if step is None:
        step = mgr.best_step if mgr.best_step is not None else mgr.latest_step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {checkpoint!r}")
    state = mgr.restore(state, step=step)
    save_npz(out, jax.tree.map(np.asarray, state.variables()))
    return step


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", required=True, help="the JAX package's config file")
    p.add_argument("--checkpoint", required=True, help="the orbax checkpoint directory")
    p.add_argument("--out", required=True, help="the .npz to write")
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--set", nargs="*", default=[], help="config overrides key=value")
    args = p.parse_args(argv)

    from spectre_tpu.configs import parse_config
    from spectre_tpu.repl.train import apply_overrides

    config = apply_overrides(parse_config(args.config), args.set)
    step = convert(config, args.checkpoint, args.out, args.step)
    print(f"wrote step {step} of {args.checkpoint} to {args.out}", flush=True)
    return step


if __name__ == "__main__":
    main()
