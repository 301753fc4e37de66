"""Data of the port: the synthetic datasets and the batch iterator."""

from spectre_tpu_torch.data.datasets import synthetic_dataset
from spectre_tpu_torch.data.pipeline import BatchIterator

# per-channel statistics the inputs are normalised with
DATASET_STATS = {
    "cifar100": ((0.5071, 0.4865, 0.4409), (0.2673, 0.2564, 0.2762)),
    "mnist": ((0.1307,), (0.3081,)),
}

__all__ = ["BatchIterator", "DATASET_STATS", "synthetic_dataset"]
