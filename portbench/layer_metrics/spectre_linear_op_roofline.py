"""SpectreLinear as an op, whatever kernels implement it: the least time of
its whole work in the traced train steps over the device time of
everything launched under the program's ``op/spectre_linear`` span
(``ops/linear.py::spectre_linear_apply``), forward and backward
(``portbench/spans.py``).

The least time (``op_step_s``) is the bound arithmetic of
``portbench/roofline.py`` (each input read once and each output written
once, bytes at the memory rate, operations at the bf16 tensor-core rate,
the larger of the two) summed over the work the op's code does for each
SpectreLinear outside the mix, counted from the code:

- the forward kernel and the backward chain, as ``spectre_linear_step_s``
  counts them;
- the backward's two products, dx = dh W^T and dW = x^T dh, 2 M K N
  operations each; dW is written in float32 and cast once to the weight's
  dtype;
- the residual when K != N: the pool matrix's product x P (K % N != 0;
  2 M K N operations) or the grouped mean (K % N == 0), and its sum with
  the kernel's output; backward, the product g P^T and the sum of the two
  parts of dx.
"""

from portbench.roofline import _tokens, bound_s, spectre_linear_step_s
from portbench.spans import summary

F32 = 4


def op_step_s(m: dict, batch: int, elem: int = 2) -> float:
    """Least seconds of every SpectreLinear outside the mix in one train
    step: ``spectre_linear_step_s`` and the backward products, casts and
    residual it leaves out."""
    e, hd, c = int(m["embed_dim"]), int(m["hidden_dim"]), int(m["num_classes"])
    rows = batch * _tokens(m)
    calls = [(rows, e, hd), (rows, hd, e)] * int(m["num_encoders"]) + [(batch, e, c)]
    total = spectre_linear_step_s(m, batch, elem)
    for mm, k, n in calls:
        products = 2.0 * mm * k * n
        total += bound_s(elem * (mm * k + mm * n) + F32 * k * n, products)  # dW, float32
        total += bound_s(F32 * k * n + elem * k * n, 0.0)                    # its cast
        total += bound_s(elem * (mm * n + k * n + mm * k), products)         # dx
        if k == n:
            continue
        if k % n:  # the pool matrix: x P forward, g P^T backward
            total += bound_s(elem * (mm * k + k * n + mm * n), products)
            total += bound_s(elem * (mm * n + k * n + mm * k), products)
        else:      # the grouped mean; its backward spreads g back over the groups
            total += bound_s(elem * (mm * k + mm * n), mm * k)
            total += bound_s(elem * (mm * n + mm * k), mm * k)
        total += bound_s(elem * 3 * mm * n, mm * n)  # out + residual
        total += bound_s(elem * 3 * mm * k, mm * k)  # dx + the residual's part
    return total


def read(record: dict):
    s = summary(record, "train")
    row = s["spans"].get("op/spectre_linear") if s else None
    if not row or row["device_s"] <= 0.0:
        return None
    least = op_step_s(record["model"], record["batch"]) * record["trace_steps"]
    return 100.0 * least / row["device_s"]
