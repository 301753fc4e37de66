"""Device milliseconds a step in PyTorch's own elementwise, reduction, copy and
normalisation kernels (``kernel_names.classify`` == "pytorch"), from the
traced steps."""


def read(record: dict, kind: str):
    trace = record.get("trace")
    if record["kind"] != kind or not trace or not record.get("trace_steps"):
        return None
    return 1e3 * trace["classes"].get("pytorch", 0.0) / record["trace_steps"]
