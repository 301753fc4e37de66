"""The runner of ``"kind": "train"`` traffic: the trainer's step
(``train/loop.py::build_step``) fed by the trainer's input path
(``data/pipeline.py``: ``BatchIterator`` over an in-memory dataset,
``prefetch_to_device`` through pinned buffers), as ``train_from_config``
runs them.

Set-up builds the step, loads the benchmark's weights, and drives the first
``check_steps`` steps and ``warmup_steps`` more through the same call and
feed; the first three are the ones the reference follows. The window then
runs steps back to back, dispatched ahead as the trainer dispatches them,
until ``seconds`` have passed on the host's clock, and ends with a device
synchronise: ``train_img_s`` is the images of every step issued in the
window over the window's length.

Traffic parameters: ``batch_size``; ``dataset_images``, u8 pixels made from
the seed and scaled to float32 in [0, 1] as the program's CIFAR loader scales
them; ``check_steps`` (3); ``warmup_steps``; ``trace_s``, about how long the
traced steps of a ``--trace 1`` run last.
"""

from __future__ import annotations

import gc
import math
import sys
import time

import numpy as np
import torch

from portbench import correct
from portbench.common import (derive_seeds, device_record, end_to_end, launches,
                              port_config, print_launches)
from portbench.manifest import read_per_layer
from portbench.reference.common import make_params
from portbench.reference.steps import family, train_steps


def make_dataset(n: int, m: dict, seed: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    shape = (n, m["in_channels"], m["img_size"], m["img_size"])
    pixels = rng.integers(0, 256, size=shape, dtype=np.uint8)
    labels = rng.integers(0, m["num_classes"], size=n, dtype=np.int64).astype(np.int32)
    return pixels.astype(np.float32) / np.float32(255.0), labels


class Trainer:
    """The program's step and feed on the benchmark's data and weights."""

    def __init__(self, cell, seed: int, device: torch.device):
        from spectre_tpu_torch.data import BatchIterator, prefetch_to_device
        from spectre_tpu_torch.models.registry import refresh_mixes
        from spectre_tpu_torch.train.loop import build_step

        self.seeds = sd = derive_seeds(seed)
        self.m = cell.config["model"]
        self.batch = int(cell.traffic["batch_size"])
        self.phases = phases = {}
        t = time.perf_counter()
        cfg = port_config(cell.config)
        cfg.random_seed, cfg.batch_size = sd.program, self.batch
        self.images, self.labels = make_dataset(int(cell.traffic["dataset_images"]), self.m,
                                                sd.data)
        batches = BatchIterator(self.images, self.labels, self.batch, shuffle=True,
                                seed=sd.shuffle)
        self.steps_per_epoch = len(batches)
        phases["data"], t = time.perf_counter() - t, time.perf_counter()
        self.state, self.step = build_step(cfg, device, steps_per_epoch=self.steps_per_epoch)
        phases["program"], t = time.perf_counter() - t, time.perf_counter()
        self.params = make_params(family(cell.config["reference"]).spec(self.m), sd.weights,
                                  device)
        self.state.model.load_state_dict(self.params, strict=True)
        refresh_mixes(self.state.model)
        phases["weights"] = time.perf_counter() - t

        def forever():
            while True:
                yield from batches

        self.feed = prefetch_to_device(forever(), device,
                                       prefetch=int(getattr(cfg, "prefetch_depth", 2)))
        self.beta1 = float(cfg.adam_betas[0])

    def one(self) -> dict:
        batch = next(self.feed)
        return self.step(self.state, batch["image"], batch["label"])

    def first_steps(self, n: int) -> tuple[list[float], dict, dict]:
        """(losses, first gradient, change of every leaf) of the next ``n``
        steps, which must be the run's first: the gradient as AdamW holds it
        after step 1, the change as the parameters stand after step n."""
        model, opt = self.state.model, self.state.optimizer
        start = {k: p.detach().clone() for k, p in model.named_parameters()}
        losses, grad = [], None
        for i in range(n):
            losses.append(self.one()["loss"].detach().clone())
            if i == 0:
                grad = {}
                for k, p in model.named_parameters():
                    st = opt.state.get(p, {})
                    grad[k] = st["exp_avg"] / (1 - self.beta1) if "exp_avg" in st \
                        else torch.zeros_like(p)
        delta = {k: p.detach() - start[k] for k, p in model.named_parameters()}
        return [float(v) for v in losses], grad, delta

    def close(self) -> None:
        """Drop the program's state, so that the reference has the card."""
        self.feed.close()
        del self.state, self.step, self.feed
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def reference(cell, trainer: Trainer, device, precision: str = "float32",
              half_batch: bool = False, steps: int = 3, frozen: bool = False):
    """The reference's (losses, first gradient, change) over the batches the
    trainer's first ``steps`` steps took, from the same weights and draws."""
    from portbench.reference.common import shuffled_batches

    rows = shuffled_batches(len(trainer.images), trainer.batch, trainer.seeds.shuffle)
    batches = [next(rows) for _ in range(steps)]
    losses, grad, after = train_steps(cell.config, trainer.params, trainer.images,
                                      trainer.labels, batches, trainer.seeds.program,
                                      trainer.steps_per_epoch, device, precision, half_batch,
                                      frozen)
    delta = {k: after[k] - trainer.params[k] for k in after}
    return losses, grad, delta


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float) -> tuple[dict, dict]:
    traffic = cell.traffic
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    built = time.perf_counter()
    trainer = Trainer(cell, seed, device)
    ready = time.perf_counter()
    prog = trainer.first_steps(int(traffic["check_steps"]))
    for _ in range(int(traffic["warmup_steps"])):
        trainer.one()
    sync()
    phases = {"to_runner": built - t_start, **trainer.phases,
              "first_steps": time.perf_counter() - ready}
    print("set-up s: " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()), file=sys.stderr)

    steps, wait_s, issue_s = 0, 0.0, 0.0
    before = launches()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    while True:
        a = time.perf_counter()
        batch = next(trainer.feed)
        b = time.perf_counter()
        trainer.step(trainer.state, batch["image"], batch["label"])
        c = time.perf_counter()
        wait_s += b - a
        issue_s += c - b
        steps += 1
        if c - t0 >= seconds:
            break
    sync()
    window_s = time.perf_counter() - t0
    print_launches(before, launches(), steps, "step")

    record = {"kind": "train", "model": trainer.m, "batch": trainer.batch, "steps": steps,
              "window_s": window_s, "input_wait_s": wait_s, "issue_s": issue_s}
    if trace:
        from portbench.tracing import traced

        k = max(3, math.ceil(float(traffic["trace_s"]) * steps / window_s))
        with traced(sync) as holder:
            for _ in range(k):
                trainer.one()
        record.update(trace=holder["trace"], trace_steps=k)
    device_rec = device_record(device, cell.chips)
    trainer.close()

    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ref = reference(cell, trainer, device, steps=int(traffic["check_steps"]))
    numbers = correct.train_numbers(prog[0], ref[0], prog[1], ref[1], prog[2], ref[2])
    checks = correct.judge(numbers, cell.config["limits"]["train"])

    if trace:
        metrics = read_per_layer(cell, record)
    else:
        metrics = end_to_end(cell, {"train_img_s": steps * trainer.batch / window_s,
                                    "setup_s": setup_s})
    result = {"correct": all(c["ok"] for c in checks.values()), "attempted": steps, "failed": 0,
              "metrics": metrics, "device": device_rec}
    if trace:
        t = record["trace"]
        result["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    return result, checks
