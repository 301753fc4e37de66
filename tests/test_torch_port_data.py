"""The port's data layer (spectre_tpu_torch/data) against the JAX package's:
dataset files in the standard formats (tiny ones, written here), the search
order, the batch iterator with ``skip_epoch`` and its keys, the prefetch
queue, and the resize to the model's input size."""

import pickle
import struct
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from spectre_tpu.data import datasets as jdata
from spectre_tpu.data.pipeline import BatchIterator as JaxBatchIterator
from spectre_tpu.train.loop import _resize_to as jax_resize_to
from spectre_tpu_torch.data import BatchIterator, load_dataset, prefetch_to_device
from spectre_tpu_torch.data import datasets as pdata
from spectre_tpu_torch.train.loop import load_sized_dataset


def _write_cifar_pickle(root, n=7, seed=0):
    rng = np.random.default_rng(seed)
    d = root / "cifar-100-python"
    d.mkdir(parents=True)
    for name in ("train", "test"):
        with open(d / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                         b"fine_labels": [int(v) for v in rng.integers(0, 100, n)],
                         b"coarse_labels": [int(v) for v in rng.integers(0, 20, n)]}, f)


def _write_cifar_binary(root, n=7, seed=1):
    rng = np.random.default_rng(seed)
    d = root / "cifar-100-binary"
    d.mkdir(parents=True)
    for name in ("train", "test"):
        rec = rng.integers(0, 256, (n, 2 + 3072), dtype=np.uint8)
        rec[:, 0] %= 20
        rec[:, 1] %= 100
        rec.tofile(d / f"{name}.bin")


def _write_mnist_idx(root, n=9, seed=2):
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    for prefix in ("train", "t10k"):
        with open(root / f"{prefix}-images-idx3-ubyte", "wb") as f:
            f.write(struct.pack(">IIII", 2051, n, 28, 28))
            f.write(rng.integers(0, 256, (n, 28, 28), dtype=np.uint8).tobytes())
        with open(root / f"{prefix}-labels-idx1-ubyte", "wb") as f:
            f.write(struct.pack(">II", 2049, n))
            f.write(rng.integers(0, 10, n, dtype=np.uint8).tobytes())


def _write_mnist_csv(root, n=23, seed=3):
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    px = ",".join(f"pixel{i}" for i in range(784))
    rows = np.concatenate([rng.integers(0, 10, (n, 1)), rng.integers(0, 256, (n, 784))], axis=1)
    np.savetxt(root / "train.csv", rows, fmt="%d", delimiter=",", header="label," + px,
               comments="")
    np.savetxt(root / "test.csv", rng.integers(0, 256, (5, 784)), fmt="%d", delimiter=",",
               header=px, comments="")


@pytest.mark.parametrize("name,writer,splits", [
    ("cifar100", _write_cifar_pickle, ("train", "test")),
    ("cifar100", _write_cifar_binary, ("train", "test")),
    ("mnist", _write_mnist_idx, ("train", "test")),
    ("mnist", _write_mnist_csv, ("train", "test", "submission")),
])
def test_dataset_files_load_as_in_the_jax_package(tmp_path, monkeypatch, name, writer, splits):
    """Exactly equal arrays from both packages' loaders; the JAX package's
    optional native decoder is switched off, so that its numpy reading is
    what the port is held to."""
    writer(tmp_path / "d")
    monkeypatch.delenv("SPECTRE_DATA_DIR", raising=False)
    monkeypatch.setattr("spectre_tpu.data.native_loader.available", lambda: False,
                        raising=False)
    for split in splits:
        x, y = load_dataset(name, split, data_dir=str(tmp_path / "d"), allow_synthetic=False)
        jx, jy = jdata.load_dataset(name, split, data_dir=str(tmp_path / "d"),
                                    allow_synthetic=False)
        assert x.dtype == jx.dtype == np.float32 and y.dtype == jy.dtype == np.int32
        assert x.shape == jx.shape and x.shape[1:] == ((3, 32, 32) if name == "cifar100"
                                                       else (1, 28, 28))
        assert np.array_equal(x, jx) and np.array_equal(y, jy)
        assert 0.0 <= x.min() and x.max() <= 1.0
    if writer is _write_mnist_csv:  # 90/10 holdout of train.csv; test.csv has no labels
        assert len(load_dataset(name, "train", str(tmp_path / "d"))[1]) == 21
        assert len(load_dataset(name, "test", str(tmp_path / "d"))[1]) == 2
        assert (load_dataset(name, "submission", str(tmp_path / "d"))[1] == -1).all()
    if writer is _write_cifar_binary:  # the fine label is the second byte
        raw = np.fromfile(tmp_path / "d" / "cifar-100-binary" / "test.bin", np.uint8)
        assert np.array_equal(load_dataset(name, "test", str(tmp_path / "d"))[1],
                              raw.reshape(-1, 3074)[:, 1])


def test_search_order_and_synthetic_fallback(tmp_path, monkeypatch):
    """data_dir, then $SPECTRE_DATA_DIR, then ./data, then the synthetic set
    unless it is not allowed; ``synthetic=True`` never looks at the disk."""
    _write_mnist_idx(tmp_path / "explicit", n=3, seed=10)
    _write_mnist_idx(tmp_path / "env", n=4, seed=11)
    _write_mnist_idx(tmp_path / "cwd" / "data", n=5, seed=12)
    monkeypatch.chdir(tmp_path / "cwd")
    monkeypatch.setenv("SPECTRE_DATA_DIR", str(tmp_path / "env"))
    assert len(load_dataset("mnist", "train", str(tmp_path / "explicit"))[1]) == 3
    assert len(load_dataset("mnist", "train", str(tmp_path / "nowhere"))[1]) == 4
    assert len(load_dataset("mnist", "train")[1]) == 4
    monkeypatch.delenv("SPECTRE_DATA_DIR")
    assert len(load_dataset("mnist", "train", str(tmp_path / "nowhere"))[1]) == 5
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match="not found"):
        load_dataset("cifar100", "train", str(tmp_path / "nowhere"), allow_synthetic=False)
    x, y = load_dataset("cifar100", "test", str(tmp_path / "nowhere"))
    sx, sy = pdata.synthetic_dataset("cifar100", "test")
    assert np.array_equal(x, sx) and np.array_equal(y, sy)
    # hermetic: real files are on the search path, the synthetic set comes back
    monkeypatch.setenv("SPECTRE_DATA_DIR", str(tmp_path / "env"))
    cfg = SimpleNamespace(dataset="mnist", img_size=28, data_dir=str(tmp_path / "explicit"))
    assert len(load_sized_dataset(cfg, "train", synthetic=True)[1]) == 4096
    assert len(load_sized_dataset(cfg, "train", synthetic=False)[1]) == 3


def test_batch_iterator_matches_jax_after_skip_epoch_with_all_keys():
    x, y = pdata.synthetic_dataset("mnist", "test")
    x, y = x[:100], y[:100]
    for shuffle in (True, False):
        ours = BatchIterator(x, y, 32, shuffle=shuffle, seed=3)
        theirs = JaxBatchIterator(x, y, 32, shuffle=shuffle, seed=3)
        ours.skip_epoch()
        theirs.skip_epoch()
        for _ in range(2):
            for a, b in zip(ours, theirs, strict=True):
                assert set(a) == set(b) == {"image", "label", "mask", "index", "valid"}
                for k in a:
                    assert np.array_equal(a[k], b[k]) and np.asarray(a[k]).dtype == \
                        np.asarray(b[k]).dtype, k
                assert np.array_equal(a["image"][:a["valid"]], x[a["index"][:a["valid"]]])
    # skip_epoch consumes exactly the stream one epoch of batches would
    skipped, walked = (BatchIterator(x, y, 32, shuffle=True, seed=9) for _ in range(2))
    skipped.skip_epoch()
    list(walked)
    assert all(np.array_equal(a["index"], b["index"]) for a, b in zip(skipped, walked))
    last = list(BatchIterator(x, y, 32, shuffle=False))[-1]
    assert last["valid"] == 4 and last["mask"].sum() == 4


@pytest.mark.parametrize("prefetch", [1, 2, 5])
def test_prefetch_queue_yields_the_batches_of_plain_iteration(prefetch):
    """The same batches in the same order, as tensors; host scalars pass
    through. On the CPU the queue is a pass-through; on a card the same
    contract is held by tests/test_torch_port_cuda.py."""
    x, y = pdata.synthetic_dataset("mnist", "test")
    make = lambda: BatchIterator(x[:200], y[:200], 32, shuffle=True, seed=1)  # noqa: E731
    staged = list(prefetch_to_device(make(), "cpu", prefetch=prefetch))
    plain = list(make())
    assert len(staged) == len(plain) == 6
    for a, b in zip(staged, plain):
        for k in ("image", "label", "mask", "index"):
            assert isinstance(a[k], torch.Tensor) and np.array_equal(a[k].numpy(), b[k]), k
        assert a["valid"] == b["valid"] and not isinstance(a["valid"], torch.Tensor)
    assert list(prefetch_to_device(iter(()), "cpu")) == []


def test_resize_to_the_model_input_size_matches_jax():
    """28 -> 32 (MNIST under a 32-pixel config): bilinear with half-pixel
    centres in both packages, edge taps renormalised; 1e-5 covers the
    different order of the two separable passes."""
    cfg = SimpleNamespace(dataset="mnist", img_size=32)
    x, y = load_sized_dataset(cfg, "test", synthetic=True)
    raw, ry = pdata.synthetic_dataset("mnist", "test")
    assert x.shape == (1024, 1, 32, 32) and x.dtype == np.float32 and np.array_equal(y, ry)
    want = jax_resize_to(32, raw[:64])
    np.testing.assert_allclose(x[:64], want, rtol=0, atol=1e-5)
    cfg.img_size = 28
    assert np.array_equal(load_sized_dataset(cfg, "test", synthetic=True)[0], raw)
