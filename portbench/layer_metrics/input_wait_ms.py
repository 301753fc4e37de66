"""Mean host time a train step waits in ``next()`` of the prefetch iterator
(``data/pipeline.py``) over the measured window, on the benchmark's clock."""


def read(record: dict, kind: str):
    if record["kind"] != kind or not record.get("steps"):
        return None
    return 1e3 * record["input_wait_s"] / record["steps"]
