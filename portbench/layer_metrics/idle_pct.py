"""The share of the traced window in which no device event runs: one minus the
union of kernel, copy and fill intervals over the window."""


def read(record: dict, kind: str):
    trace = record.get("trace")
    if record["kind"] != kind or not trace or trace["window_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
