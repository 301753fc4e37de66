"""Images answered in the measured window over the buckets the server ran
through the model in it (``TorchServer.forwards``): how full a bucket is."""


def read(record: dict):
    if record["kind"] != "serve" or not record.get("forwards"):
        return None
    return record["images"] / record["forwards"]
