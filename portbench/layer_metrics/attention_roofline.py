"""B4: the attention's forward and backward kernels: the least time the traced train steps' shapes
need (``portbench/roofline.py``) over these kernels' device time."""

from portbench.roofline import share


def read(record: dict):
    return share(record, "attention")
