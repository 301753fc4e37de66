"""The runner of ``"kind": "distill"`` traffic: the distiller's step with its
teacher online, as ``distill/loop.py::distill_from_config`` builds them and
runs a batch without the teacher-logit table (the first epoch of a run, and
every run shorter than one): the frozen teacher (``teacher_from_config``)
on its view of the raw batch (``make_teacher_view``) under
``inference_mode``, then ``make_distill_step`` on the student's state,
with the CIFAR augmentation inside it.

Set-up, feed, window, trace and result line are the train runner's
(``drive_train.py``): the student's state, weights and feed come from its
``Trainer``; the teacher's weights from ``make_params`` over the teacher
family's ``spec`` (``reference/<family>.py``), loaded into the program's
teacher by its own names and strictly, so that a leaf missing, extra or of
another shape stops the run; the configuration's ``teacher`` group names
the family and the program's ``variant`` it follows. The first
``check_steps`` steps are the ones the reference follows (the student's
loss, first gradient and change, and the teacher's logits of those
batches); a step of the window is the teacher's forward and the student's
update, and ``host_issue_ms`` counts both.

Traffic parameters are the train runner's.
"""

from __future__ import annotations

import math
import sys
import time

import torch

from portbench import correct
from portbench.common import device_record, end_to_end, launches, port_config, print_launches
from portbench.drive_train import Trainer
from portbench.manifest import read_per_layer
from portbench.reference.common import make_params, shuffled_batches
from portbench.reference.distill import distill_steps
from portbench.reference.steps import family

# the teacher group's keys that the program's backbone holds under the same names:
# its sizes, and the program's variant that the family's reference follows
TEACHER_SIZES = ("img_size", "patch_size", "in_channels", "embed_dim", "depth", "num_heads",
                 "num_registers", "variant")
TEACHER_STREAM = 0x7EAC4E5  # the teacher's weights: the student's seed with these bits flipped


def _differ(cfg, config: dict, teacher) -> list[str]:
    """What the program's distiller states otherwise than the benchmark's
    file: the distillation keys, and the sizes and variant of the teacher it
    built. The widths of its layers are held by the strict load of the
    teacher family's ``spec``, which refuses a missing or extra leaf and any
    shape that differs."""
    t, bb = config["teacher"], teacher.backbone
    out = [f"{k}: program {getattr(cfg, k, None)!r}, benchmark {v!r}"
           for k, v in config["distill"].items() if getattr(cfg, k, None) != v]
    out += [f"teacher {k}: program {getattr(bb, k)!r}, benchmark {t.get(k)!r}"
            for k in TEACHER_SIZES if getattr(bb, k) != t.get(k)]
    if teacher.num_classes != t["num_classes"]:
        out.append(f"teacher num_classes: program {teacher.num_classes}")
    return out


class Distiller(Trainer):
    """The trainer's student, feed and weights with the program's frozen
    teacher and distillation step in place of the train step."""

    def __init__(self, cell, seed: int, device: torch.device):
        from spectre_tpu_torch.data import make_train_augment
        from spectre_tpu_torch.distill.loop import make_teacher_view, teacher_from_config
        from spectre_tpu_torch.distill.teacher import freeze
        from spectre_tpu_torch.train.loop import dataset_stats
        from spectre_tpu_torch.train.step import make_distill_step

        super().__init__(cell, seed, device)
        t = time.perf_counter()
        cfg = port_config(cell.config)
        cfg.random_seed, cfg.batch_size = self.seeds.program, self.batch
        tc = cell.config["teacher"]
        teacher = freeze(teacher_from_config(cfg, int(cfg.teacher_img_size), device).to(device))
        differ = _differ(cfg, cell.config, teacher)
        if differ:
            raise RuntimeError("the program's distiller differs from the benchmark's: "
                               + "; ".join(differ))
        self.teacher_params = make_params(family(tc["reference"]).spec(tc),
                                          self.seeds.weights ^ TEACHER_STREAM, device)
        teacher.load_state_dict(self.teacher_params, strict=True)
        in_ch = int(cfg.in_channels)
        view = make_teacher_view(teacher.backbone.img_size, in_ch=in_ch,
                                 mode=str(cfg.teacher_view))

        def teacher_logits_fn(raw: torch.Tensor) -> torch.Tensor:
            with torch.inference_mode():
                logits = teacher(view(raw))
            return logits.clone()

        mean, std = dataset_stats(cfg.dataset)
        augment = make_train_augment(mean, std, jitter=(in_ch == 3))
        alpha = float(cfg.distill_alpha)
        self.step = make_distill_step(augment_fn=augment,
                                      temperature=float(cfg.distill_temperature),
                                      kd_weight=alpha, ce_weight=1.0 - alpha,
                                      grad_clip_norm=getattr(cfg, "grad_clip_norm", None))
        self.teacher, self.teacher_logits_fn = teacher, teacher_logits_fn
        self.kept: list[torch.Tensor] | None = None
        self.phases["teacher"] = time.perf_counter() - t

    def issue(self, batch: dict) -> dict:
        logits = self.teacher_logits_fn(batch["image"])
        if self.kept is not None:
            self.kept.append(logits.detach().float().clone())
        return self.step(self.state, batch["image"], logits, batch["label"])

    def one(self) -> dict:
        return self.issue(next(self.feed))

    def first_steps(self, n: int) -> tuple[list[float], dict, dict, list[torch.Tensor]]:
        """The train runner's readings of the first ``n`` steps and the
        teacher's logits of their batches."""
        self.kept = []
        out = super().first_steps(n)
        kept, self.kept = self.kept, None
        return (*out, kept)

    def close(self) -> None:
        del self.teacher, self.teacher_logits_fn
        super().close()


def reference(cell, run: Distiller, device, precision: str = "float32", half_batch: bool = False,
              steps: int = 3, frozen: bool = False, teacher_fault: str | None = None):
    """The reference's (losses, first gradient, change, teacher logits) over
    the batches the first ``steps`` steps took, from the same weights and
    draws."""
    rows = shuffled_batches(len(run.images), run.batch, run.seeds.shuffle)
    batches = [next(rows) for _ in range(steps)]
    losses, grad, after, kept = distill_steps(
        cell.config, run.params, run.teacher_params, run.images, run.labels, batches,
        run.seeds.program, run.steps_per_epoch, device, precision, half_batch, frozen,
        teacher_fault)
    return losses, grad, {k: after[k] - run.params[k] for k in after}, kept


def numbers(prog, ref) -> dict:
    """The student's numbers (``correct.train_numbers``) and the teacher's:
    ``teacher_logits``, ``correct.logit_numbers`` of the logits of every
    checked batch; ``teacher_err``, their difference over the reference's
    norm, all logits as one vector."""
    out = correct.train_numbers(prog[0], ref[0], prog[1], ref[1], prog[2], ref[2])
    p_t = torch.cat([t.to(ref[3][0].device) for t in prog[3]])
    r_t = torch.cat(ref[3])
    out["teacher_logits"] = correct.logit_numbers(p_t, r_t)["logits"]
    out["teacher_err"] = correct.difference({"t": p_t}, {"t": r_t}, ["t"])
    return out


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float) -> tuple[dict, dict]:
    traffic = cell.traffic
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    built = time.perf_counter()
    d = Distiller(cell, seed, device)
    ready = time.perf_counter()
    prog = d.first_steps(int(traffic["check_steps"]))
    for _ in range(int(traffic["warmup_steps"])):
        d.one()
    sync()
    phases = {"to_runner": built - t_start, **d.phases, "first_steps": time.perf_counter() - ready}
    print("set-up s: " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()), file=sys.stderr)

    steps, wait_s, issue_s = 0, 0.0, 0.0
    before = launches()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    while True:
        a = time.perf_counter()
        batch = next(d.feed)
        b = time.perf_counter()
        d.issue(batch)
        c = time.perf_counter()
        wait_s += b - a
        issue_s += c - b
        steps += 1
        if c - t0 >= seconds:
            break
    sync()
    window_s = time.perf_counter() - t0
    print_launches(before, launches(), steps, "step")

    record = {"kind": "distill", "model": d.m, "teacher": cell.config["teacher"],
              "batch": d.batch, "steps": steps, "window_s": window_s, "input_wait_s": wait_s,
              "issue_s": issue_s}
    if trace:
        from portbench.tracing import traced

        k = max(3, math.ceil(float(traffic["trace_s"]) * steps / window_s))
        with traced(sync) as holder:
            for _ in range(k):
                d.one()
        record.update(trace=holder["trace"], trace_steps=k)
    device_rec = device_record(device, cell.chips)
    d.close()

    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ref = reference(cell, d, device, steps=int(traffic["check_steps"]))
    checks = correct.judge(numbers(prog, ref), cell.config["limits"]["distill"])

    if trace:
        metrics = read_per_layer(cell, record)
    else:
        metrics = end_to_end(cell, {"train_img_s": steps * d.batch / window_s,
                                    "setup_s": setup_s})
    result = {"correct": all(c["ok"] for c in checks.values()), "attempted": steps, "failed": 0,
              "metrics": metrics, "device": device_rec}
    if trace:
        t = record["trace"]
        result["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    return result, checks
