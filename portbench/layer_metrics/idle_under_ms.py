"""Device idle milliseconds a step while the host was inside a layer's
program spans (``portbench/spans.py``): ``input``, the input pipeline's
``data/*`` spans; ``step``, the trainer's ``step`` span and those inside it
(the host issuing slower than the card runs)."""

from portbench.spans import summary

GROUPS = {"input": "data", "step": "step"}


def read(record: dict, kind: str, where: str):
    s = summary(record, kind)
    found = s["groups"].get(GROUPS[where]) if s else None
    if not found:
        return None
    return 1e3 * found["idle_s"] / record["trace_steps"]
