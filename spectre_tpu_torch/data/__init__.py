"""Data of the port: dataset files and the synthetic datasets, the batch
iterator with its prefetch queue, and the device-side augmentation."""

from spectre_tpu_torch.data.augment import (
    RowWindow,
    center_crop,
    color_jitter_apply,
    erasing_apply,
    gaussian_blur_apply,
    grayscale_apply,
    hflip_apply,
    make_eval_transform,
    make_train_augment,
    normalize,
    random_color_jitter,
    random_erasing,
    random_gaussian_blur,
    random_grayscale,
    random_hflip,
    random_rotate,
    resize_bicubic_pil,
    resize_bilinear,
    resize_matrix,
    resize_separable,
    rotate_apply,
)
from spectre_tpu_torch.data.datasets import load_dataset, synthetic_batch, synthetic_dataset
from spectre_tpu_torch.data.pipeline import BatchIterator, prefetch_to_device, rank_slice

# per-channel statistics the inputs are normalised with
DATASET_STATS = {
    "cifar100": ((0.5071, 0.4865, 0.4409), (0.2673, 0.2564, 0.2762)),
    "mnist": ((0.1307,), (0.3081,)),
}

__all__ = [
    "RowWindow",
    "BatchIterator",
    "DATASET_STATS",
    "center_crop",
    "color_jitter_apply",
    "erasing_apply",
    "gaussian_blur_apply",
    "grayscale_apply",
    "hflip_apply",
    "load_dataset",
    "make_eval_transform",
    "make_train_augment",
    "normalize",
    "prefetch_to_device",
    "rank_slice",
    "random_color_jitter",
    "random_erasing",
    "random_gaussian_blur",
    "random_grayscale",
    "random_hflip",
    "random_rotate",
    "resize_bicubic_pil",
    "resize_bilinear",
    "resize_matrix",
    "resize_separable",
    "rotate_apply",
    "synthetic_batch",
    "synthetic_dataset",
]
