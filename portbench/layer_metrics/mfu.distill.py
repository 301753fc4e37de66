"""The distiller's whole step's share of the card's bf16 peak: the model
FLOPs of the window's steps over the window, over 989 TFLOP/s. A step is the
student's train step (the frozen count of ``portbench/flops.py``) and the
teacher's forward of the batch (its family's ``forward_flops_per_image``,
``portbench/reference/<family>.py``)."""

from portbench.flops import PEAK_BF16_FLOPS, train_flops_per_step
from portbench.reference.steps import family


def read(record: dict):
    if record["kind"] != "distill" or record.get("window_s", 0.0) <= 0.0:
        return None
    t = record["teacher"]
    step = train_flops_per_step(record["model"], record["batch"]) \
        + family(t["reference"]).forward_flops_per_image(t) * record["batch"]
    return 100.0 * step * record["steps"] / record["window_s"] / PEAK_BF16_FLOPS
