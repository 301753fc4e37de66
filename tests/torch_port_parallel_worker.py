"""One rank of the port's parallel tests (tests/test_torch_port_parallel.py,
tests/test_torch_port_multihost.py): started once per rank with

    python tests/torch_port_parallel_worker.py <leg> <rank> <world> <dir>

The ranks meet through a ``file://`` store in ``<dir>``, over gloo on the
CPU. Inputs (flax weights saved by the test, checkpoints) are read from
``<dir>`` and rank 0 writes what the test holds to ``<dir>/<leg>.pt``.

- ``parity2`` (2 ranks): 2 AdamW steps of the tiny SpectreViT under DDP,
  FSDP and FSDP with clipping, DDP and FSDP with 2 microbatches, and of SpectreViT and the ViT under tensor
  parallelism (mesh 1 x 2), and SpectreBranch (its linear1 split by
  columns and gathered for the whole linear2); losses, every parameter whole, the AdamW
  moments whole after the first step, the placement of each leaf and of the
  moments, the collectives of a step; the FSDP
  model's validation logits before and after a further step, with the
  number of weight folds.
- ``parity4`` (4 ranks): FSDP x TP on a 2 x 2 mesh.
- ``loop`` (2 ranks): ``train_from_config`` with ``fsdp=True`` to step 6 in
  one run, and to step 3 then ``resume`` to 6 in another; a single-device
  checkpoint restored into FSDP.
- ``dropout2`` (2 ranks): 2 AdamW steps of SpectreViT and the ViT under
  tensor parallelism (mesh 1 x 2) with dropout, on the port's own seeded
  weights: losses, parameters and every rank's dropout masks
  (``recorded_masks``), for tests/test_torch_tp_dropout.py to hold against
  the same steps in one process (``dropout_steps``).
"""

from __future__ import annotations

import contextlib
import os
import sys
from types import SimpleNamespace

import numpy as np

STEPS_PER_EPOCH = 6
BATCH = 8
MIN_SIZE = 1024  # the tiny models' kernels are under FSDP's default 2**14
CLIP = 0.05      # under the first gradient's norm: the clip is active


def config(kind: str, **over) -> SimpleNamespace:
    """The tiny configs of the parity tests: 2 layers, E = 32, f32, no dropout."""
    cfg = SimpleNamespace(
        model={"vit": "vit", "branch": "spectre_branch"}.get(kind, "spectre_vit"),
        method="permut_mix",
        dataset="mnist", img_size=8, patch_size=4, in_channels=3, num_classes=10,
        embed_dim=32, num_encoders=2, num_heads=2, hidden_dim=64, dropout=0.0,
        batch_size=BATCH, epochs=2, learning_rate=1e-3, random_seed=0,
        compute_dtype="float32", param_dtype="float32", mix_impl="folded", mix_block=8)
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


def batch(seed: int = 0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (BATCH, 3, 8, 8)).astype(np.float32),
            rng.integers(0, 10, BATCH).astype(np.int32))


def _whole(t):
    from torch.distributed.tensor import DTensor

    return (t.full_tensor() if isinstance(t, DTensor) else t).detach().clone()


def _spec(t) -> tuple:
    """A tensor's layout as a JAX spec: the mesh axis name on each split dim."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return ()
    spec = [None] * t.dim()
    for mesh_dim, pl in enumerate(t.placements):
        if pl.is_shard():
            spec[pl.dim] = t.device_mesh.mesh_dim_names[mesh_dim]
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def _state(kind: str, d: str, **over):
    import torch

    from spectre_tpu_torch.models import build_model, load_flax_variables, load_npz
    from spectre_tpu_torch.train import create_train_state, make_optimizer

    cfg = config(kind, **over)
    model = build_model(cfg, "cpu", train=True)
    weights = os.path.join(d, f"{kind}.npz")
    if os.path.exists(weights):  # else the port's own seeded init
        load_flax_variables(model, load_npz(weights))
    optimizer, scheduler = make_optimizer(cfg, model.parameters(), STEPS_PER_EPOCH)
    return create_train_state(model, optimizer, scheduler, seed=0), torch


def run_leg(kind: str, d: str, dp: int, mp: int, *, fsdp: bool = False, clip=None,
            evaluate: bool = False, accum: int = 1) -> dict:
    """2 steps on ``dp`` x ``mp``; what the test holds of them."""
    from spectre_tpu_torch.models import FoldedMixLinear
    from spectre_tpu_torch.models import layers as layers_mod
    from spectre_tpu_torch.parallel import (SPECTRE_TP_RULES, VIT_TP_RULES, collective_counts,
                                            create_mesh, local_rows, parallelize)
    from spectre_tpu_torch.train import make_train_step

    state, torch = _state(kind, d)
    mesh = create_mesh(dp, mp)
    rules = VIT_TP_RULES if kind == "vit" else SPECTRE_TP_RULES
    parallelize(state, mesh, fsdp=fsdp, min_size=MIN_SIZE, tp_rules=rules, seed=0)
    specs_before = {n: _spec(p) for n, p in state.model.named_parameters()}
    step = make_train_step(grad_clip_norm=clip, grad_accum_steps=accum)
    x, y = (torch.from_numpy(a) for a in batch())
    rows = local_rows(mesh, BATCH)
    losses = [float(step(state, x[rows], y[rows].long())["loss"])]
    # the moments after the first step scale with the gradient, where AdamW's
    # update does not
    moments = {n: {k: _whole(state.optimizer.state[p][k]) for k in ("exp_avg", "exp_avg_sq")}
               for n, p in state.model.named_parameters()}
    losses.append(float(step(state, x[rows], y[rows].long())["loss"]))
    out = {"losses": losses, "moments": moments,
           "params": {n: _whole(p) for n, p in state.model.named_parameters()},
           "specs": {n: _spec(p) for n, p in state.model.named_parameters()},
           "specs_before": specs_before,
           "moment_specs": {n: _spec(state.optimizer.state[p]["exp_avg"])
                            for n, p in state.model.named_parameters()},
           "moment_fraction": {
               n: state.optimizer.state[p]["exp_avg"].to_local().numel() / p.numel()
               for n, p in state.model.named_parameters()
               if hasattr(state.optimizer.state[p]["exp_avg"], "to_local")}}
    if evaluate:
        # validation after the steps: three batches fold each mix's weights
        # once; a step later the fold follows the new weights
        folds = [0]
        real = layers_mod.fold_weights

        def counting(*a):
            folds[0] += 1
            return real(*a)

        layers_mod.fold_weights = counting
        n_mix = sum(isinstance(m, FoldedMixLinear) for m in state.model.modules())
        try:
            state.model.eval()
            with torch.no_grad():
                logits = [state.model(x) for _ in range(3)]
            out["eval_logits"] = logits[0]
            out["eval_repeat_equal"] = all(torch.equal(logits[0], t) for t in logits[1:])
            out["eval_folds"] = folds[0] / n_mix
            state.model.train()
            step(state, x[rows], y[rows].long())
            state.model.eval()
            with torch.no_grad():
                out["eval_logits_after"] = state.model(x)
            out["eval_folds_after"] = folds[0] / n_mix
            out["params_after"] = {n: _whole(p) for n, p in state.model.named_parameters()}
            state.model.train()
        finally:
            layers_mod.fold_weights = real
    out["audit"] = collective_counts(step, state, x[rows], y[rows].long())
    return out


DROPOUT = 0.1


@contextlib.contextmanager
def recorded_masks():
    """Every Dropout's keep-mask in call order (uint8: 1 kept, 0 dropped),
    read back from each call's input and output."""
    import torch

    from spectre_tpu_torch.models.layers import Dropout

    masks, real = [], Dropout.forward

    def forward(self, x, *args, **kwargs):
        y = real(self, x, *args, **kwargs)
        if y is not x:
            keep = torch.where(x != 0, y / x * (1.0 - self.p), torch.ones_like(x))
            masks.append(keep.round().to(torch.uint8))
        return y

    Dropout.forward = forward
    try:
        yield masks
    finally:
        Dropout.forward = real


def dropout_steps(kind: str, d: str, mp: int = 1) -> dict:
    """2 steps of ``kind`` with dropout, unwrapped (``mp`` = 1, no process
    group needed) or under tensor parallelism over ``mp`` ranks: losses,
    parameters whole, this rank's masks."""
    from spectre_tpu_torch.parallel import SPECTRE_TP_RULES, VIT_TP_RULES, create_mesh, \
        parallelize
    from spectre_tpu_torch.train import make_train_step

    state, torch = _state(kind, d, dropout=DROPOUT)
    if mp > 1:
        parallelize(state, create_mesh(1, mp), tp_rules=VIT_TP_RULES if kind == "vit"
                    else SPECTRE_TP_RULES, seed=0)
    step = make_train_step()
    x, y = (torch.from_numpy(a) for a in batch())
    with recorded_masks() as masks:
        losses = [float(step(state, x, y.long())["loss"]) for _ in range(2)]
    return {"losses": losses, "masks": masks,
            "params": {n: _whole(p) for n, p in state.model.named_parameters()}}


def leg_dropout2(d: str) -> dict:
    import torch.distributed as dist

    out = {}
    for kind in ("spectre", "vit"):
        r = dropout_steps(kind, d, mp=2)
        masks = [None] * dist.get_world_size()
        dist.all_gather_object(masks, r["masks"])
        out[kind] = {**r, "masks": masks}
    return out


def leg_parity2(d: str) -> dict:
    return {"dp": run_leg("spectre", d, 2, 1),
            "fsdp": run_leg("spectre", d, 2, 1, fsdp=True, evaluate=True),
            "fsdp_clip": run_leg("spectre", d, 2, 1, fsdp=True, clip=CLIP),
            "dp_accum": run_leg("spectre", d, 2, 1, accum=2),
            "fsdp_accum": run_leg("spectre", d, 2, 1, fsdp=True, accum=2),
            "tp_spectre": run_leg("spectre", d, 1, 2),
            "tp_vit": run_leg("vit", d, 1, 2),
            "tp_branch": run_leg("branch", d, 1, 2)}


def leg_parity4(d: str) -> dict:
    return {"fsdp_tp": run_leg("spectre", d, 2, 2, fsdp=True)}


def leg_loop(d: str) -> dict:
    """The FSDP train loop: uninterrupted to step 6, and to step 3 then
    resumed to 6; then a single-device checkpoint (written by the test)
    restored into FSDP."""
    import torch.distributed as dist

    from spectre_tpu_torch.parallel import create_mesh, parallelize
    from spectre_tpu_torch.train import CheckpointManager, train_from_config

    def cfg(name):
        return config("spectre", fsdp=True, fsdp_min_size=MIN_SIZE, batch_size=512,
                      val_batch_size=512, epochs=1, num_encoders=1, dataset="mnist",
                      in_channels=1, checkpoint_dir=os.path.join(d, name))

    whole = train_from_config(cfg("whole"), device="cpu", synthetic=True, max_steps=6,
                              write_metrics=False)
    cut = train_from_config(cfg("cut"), device="cpu", synthetic=True, max_steps=3,
                            write_metrics=False)
    cut_params = {n: _whole(p) for n, p in cut.state.model.named_parameters()}
    resumed = train_from_config(cfg("cut"), device="cpu", synthetic=True, max_steps=6,
                                resume=True, write_metrics=False)

    def full(state):
        """Step, parameters, AdamW state by the unwrapped model's parameter
        index (a single-device optimizer's), rank 0's generator."""
        return {"step": state.step,
                "params": {n: _whole(p) for n, p in state.model.named_parameters()},
                "moments": {i: {k: _whole(v) for k, v in state.optimizer.state[p].items()}
                            for i, p in enumerate(state.model.parameters())},
                "generator": state.dropout_generator.get_state()}

    out = {"whole": full(whole.state), "resumed": full(resumed.state), "cut": cut_params,
           "logdir": cut.logdir, "world": dist.get_world_size()}
    # a checkpoint written by one device, restored into FSDP
    single = os.path.join(d, "single_ckpt")
    if os.path.isdir(single):
        state, _ = _state("spectre", d)
        parallelize(state, create_mesh(), fsdp=True, min_size=MIN_SIZE, seed=0)
        CheckpointManager(single).restore(state)
        out["single_into_fsdp"] = full(state)
    return out


def main(argv):
    leg, rank, world, d = argv[0], int(argv[1]), int(argv[2]), argv[3]
    import torch

    from spectre_tpu_torch.parallel import init_distributed

    init_distributed(f"file://{os.path.join(d, f'rendezvous_{leg}')}", rank=rank,
                     world_size=world, device="cpu", timeout_s=120)
    torch.manual_seed(0)
    result = {"parity2": leg_parity2, "parity4": leg_parity4, "loop": leg_loop,
              "dropout2": leg_dropout2}[leg](d)
    if rank == 0:
        torch.save(result, os.path.join(d, f"{leg}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
