"""Mean host time from entering the train step to its return, unsynchronised,
over the measured window: how long the host takes to issue a step's work."""


def read(record: dict, kind: str):
    if record["kind"] != kind or not record.get("steps"):
        return None
    return 1e3 * record["issue_s"] / record["steps"]
