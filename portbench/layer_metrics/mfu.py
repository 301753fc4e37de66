"""The whole step's share of the card's bf16 peak: model FLOPs (the frozen
count of ``portbench/flops.py``) of the work completed in the measured
window, over the window, over 989 TFLOP/s. Training counts the window's
optimizer steps, serving the forwards of the images answered (padding not
counted)."""

from portbench.flops import PEAK_BF16_FLOPS, forward_flops_per_image, train_flops_per_step


def read(record: dict, kind: str):
    if record["kind"] != kind or record.get("window_s", 0.0) <= 0.0:
        return None
    if kind == "train":
        flops = train_flops_per_step(record["model"], record["batch"]) * record["steps"]
    else:
        flops = forward_flops_per_image(record["model"]) * record["images"]
    return 100.0 * flops / record["window_s"] / PEAK_BF16_FLOPS
