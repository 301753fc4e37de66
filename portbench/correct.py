"""The numbers that decide ``correct``, each held to the limit the
configuration's file states (``limits``; PERF.md gives the readings each
limit was set from).

Training, over the first three steps that the timed call and feed ran:

- ``loss``: the largest relative gap of a step's loss to the reference's;
- ``grad``: the first step's gradient, by the worst leaf: the gap between the
  program's norm of a leaf (read from AdamW's first moment after step 1,
  exp_avg / (1 - beta1)) and the reference's, over the larger of the
  reference's norm of that leaf and of the median leaf;
- ``update``: the parameters' change over the three steps, by the worst leaf
  the same way, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (a gradient nought to rounding, as a key's
  bias has under softmax, moves its leaf under Adam by round-off alone);
- ``grad_err``: the first gradient's difference to the reference's, over
  the reference's norm, all those leaves as one vector. The gaps of norms
  see an unbiased rounding error only to second order; this sees it to the
  first, and is the number that tells fp8 products from bf16.

Serving, over the replies sampled from the window:

- ``logits``: the largest absolute gap of a served logit to the reference's,
  over the root mean square of the reference's logits.
"""

from __future__ import annotations

import math
import statistics

import torch


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def leaf_gaps(prog: dict, ref: dict, names: list[str]) -> dict:
    """Each leaf's gap of norms over the larger of its reference norm and the
    median leaf's."""
    pn, rn = _norms({k: prog[k] for k in names}), _norms({k: ref[k] for k in names})
    median = statistics.median(rn.values())
    return {k: abs(pn[k] - rn[k]) / max(rn[k], median) for k in names}


def _worst(gaps: dict) -> float:
    worst = max(gaps.values())
    return worst if math.isfinite(worst) else math.inf


def difference(prog: dict, ref: dict, names: list[str]) -> float:
    """The norm of the difference over the norm of the reference, all leaves
    as one vector."""
    num = sum(float(torch.linalg.vector_norm((prog[k] - ref[k]).double())) ** 2 for k in names)
    den = sum(float(torch.linalg.vector_norm(ref[k].double())) ** 2 for k in names)
    err = math.sqrt(num / den)
    return err if math.isfinite(err) else math.inf


def train_numbers(prog_losses, ref_losses, prog_grad, ref_grad, prog_delta, ref_delta) -> dict:
    names = sorted(ref_grad)
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog_losses, ref_losses))
    rn = _norms(ref_grad)
    median = statistics.median(rn.values())
    moved = [k for k in names if rn[k] >= 1e-3 * median]
    grads = leaf_gaps(prog_grad, ref_grad, names)
    return {"loss": loss if math.isfinite(loss) else math.inf,
            "grad": _worst(grads),
            "update": _worst(leaf_gaps(prog_delta, ref_delta, moved)),
            "grad_err": difference(prog_grad, ref_grad, moved),
            "grad_worst_leaf": max(grads, key=grads.get)}


def logit_numbers(prog: torch.Tensor, ref: torch.Tensor) -> dict:
    """``logits``: no sampled reply is a wrong answer (inf)."""
    if not len(prog):
        return {"logits": math.inf}
    prog, ref = prog.double().to(ref.device), ref.double()
    gap = float((prog - ref).abs().max()) / float(ref.pow(2).mean().sqrt())
    return {"logits": gap if math.isfinite(gap) else math.inf}


def judge(numbers: dict, limits: dict) -> dict:
    """{name: {value, limit, ok}} for every limited number."""
    return {k: {"value": numbers[k], "limit": limits[k], "ok": numbers[k] <= limits[k]}
            for k in limits}
