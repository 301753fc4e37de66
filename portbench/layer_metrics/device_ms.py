"""Device milliseconds a step of the work launched under one of the
program's spans (``portbench/spans.py``), spans inside it included:
``augment``, ``step/augment`` (the on-device augmentation); ``mix``,
``op/mix`` (``MHPermutMix``, forward and backward); ``optimizer``,
``step/optimizer`` (reduction, clipping, AdamW, the schedule)."""

from portbench.spans import summary

SPANS = {"augment": "step/augment", "mix": "op/mix", "optimizer": "step/optimizer"}


def read(record: dict, kind: str, what: str):
    s = summary(record, kind)
    row = s["spans"].get(SPANS[what]) if s else None
    if not row:
        return None
    return 1e3 * row["device_s"] / record["trace_steps"]
