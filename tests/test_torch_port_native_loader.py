"""The port's native data loader (spectre_tpu_torch/data/native_loader.py):
the port's bindings, the JAX package's and the numpy loaders decode the same
tiny CIFAR-100 binary and MNIST IDX files, written here: labels equal, pixels
of the port's bindings bit for bit numpy's (they divide by 255 as numpy does)
and within one float32 ulp of the JAX bindings' (the library's multiply by
1/255, which the JAX package returns as it is); ``gather_batch`` equal to
both; ``data/datasets.py`` takes the library when it is there, loads without
it, and reads the same array either way."""

import struct

import numpy as np
import pytest

from spectre_tpu.data import native_loader as jax_native
from spectre_tpu_torch.data import load_dataset
from spectre_tpu_torch.data import datasets as pdata
from spectre_tpu_torch.data import native_loader

ULP = dict(rtol=0, atol=np.finfo(np.float32).eps)  # a pixel in [0, 1]: one ulp at most


@pytest.fixture(scope="module")
def lib(native_build):
    assert native_loader.available() and jax_native.available()
    return native_build


def _write_cifar_binary(root, n=6, seed=0):
    rng = np.random.default_rng(seed)
    d = root / "cifar-100-binary"
    d.mkdir(parents=True)
    for name in ("train", "test"):
        rec = rng.integers(0, 256, (n, 2 + 3072), dtype=np.uint8)
        rec[:, 0] %= 20
        rec[:, 1] %= 100
        (d / f"{name}.bin").write_bytes(rec.tobytes())
    return d / "train.bin"


def _write_mnist_idx(root, n=7, seed=1):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (n, 28, 28), dtype=np.uint8)
    lab = rng.integers(0, 10, n, dtype=np.uint8)
    ip, lp = root / "train-images-idx3-ubyte", root / "train-labels-idx1-ubyte"
    ip.write_bytes(struct.pack(">IIII", 0x803, n, 28, 28) + img.tobytes())
    lp.write_bytes(struct.pack(">II", 0x801, n) + lab.tobytes())
    return ip, lp


def test_cifar_binary_three_ways(lib, tmp_path):
    path = _write_cifar_binary(tmp_path)
    got_x, got_y = native_loader.load_cifar100_bin(str(path))
    jax_x, jax_y = jax_native.load_cifar100_bin(str(path))
    raw = np.fromfile(path, np.uint8).reshape(-1, 3074)
    np.testing.assert_array_equal(got_y, jax_y)
    np.testing.assert_array_equal(got_y, raw[:, 1].astype(np.int32))
    assert got_x.shape == (6, 3, 32, 32) and got_x.dtype == np.float32
    np.testing.assert_array_equal(got_x, raw[:, 2:].reshape(-1, 3, 32, 32).astype(np.float32)
                                  / 255.0)
    np.testing.assert_allclose(got_x, jax_x, **ULP)
    assert (got_x != jax_x).any()  # the library's own scaling, which the JAX bindings keep
    assert native_loader.load_cifar100_bin(str(path), max_n=4)[0].shape[0] == 4


def test_mnist_idx_three_ways(lib, tmp_path):
    ip, lp = _write_mnist_idx(tmp_path)
    got_x, got_y = native_loader.load_mnist_idx(str(ip), str(lp))
    jax_x, jax_y = jax_native.load_mnist_idx(str(ip), str(lp))
    py_x, py_y = pdata._load_mnist_idx(str(tmp_path), "train")
    np.testing.assert_array_equal(got_y, jax_y)
    np.testing.assert_array_equal(got_y, py_y)
    np.testing.assert_array_equal(got_x, py_x)
    np.testing.assert_allclose(got_x, jax_x, **ULP)
    bad = tmp_path / "bad-idx3-ubyte"
    bad.write_bytes(struct.pack(">IIII", 0x803, 1, 30, 30) + bytes(900))
    with pytest.raises(ValueError, match="28 x 28"):
        native_loader.load_mnist_idx(str(bad), str(lp))
    with pytest.raises(OSError, match="native decode failed"):
        native_loader.load_mnist_idx(str(ip), str(tmp_path / "missing"))


def test_gather_batch_equals_jaxs_and_numpy(lib):
    rng = np.random.default_rng(2)
    images = rng.normal(size=(10, 1, 4, 4)).astype(np.float32)
    labels = np.arange(10, dtype=np.int32)
    perm = np.asarray([7, 2, 9, 0, 7], np.int64)
    got_x, got_y = native_loader.gather_batch(images, labels, perm)
    jax_x, jax_y = jax_native.gather_batch(images, labels, perm)
    for a, b in ((got_x, jax_x), (got_y, jax_y), (got_x, images[perm]), (got_y, labels[perm])):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(IndexError):
        native_loader.gather_batch(images, labels, np.asarray([10]))


def test_load_dataset_takes_the_library_and_loads_without_it(lib, tmp_path, monkeypatch):
    _write_cifar_binary(tmp_path)
    calls = []
    real = native_loader.load_cifar100_bin
    monkeypatch.setattr(native_loader, "load_cifar100_bin",
                        lambda p, *a: calls.append(p) or real(p, *a))
    with_lib = load_dataset("cifar100", "train", data_dir=str(tmp_path), allow_synthetic=False)
    assert len(calls) == 1
    monkeypatch.setenv("SPECTRE_DATAIO_LIB", str(tmp_path / "nowhere.so"))
    monkeypatch.setattr(native_loader, "_DEFAULT_LIB", str(tmp_path / "hidden.so"))
    assert not native_loader.available()
    with pytest.raises(RuntimeError, match="not built"):
        native_loader.gather_batch(np.zeros((1, 1)), np.zeros(1), np.zeros(1))
    without = load_dataset("cifar100", "train", data_dir=str(tmp_path), allow_synthetic=False)
    assert len(calls) == 1
    np.testing.assert_array_equal(with_lib[1], without[1])
    np.testing.assert_array_equal(with_lib[0], without[0])


def test_env_override_is_read_first(lib, tmp_path, monkeypatch):
    import shutil

    copy = tmp_path / "libcopy.so"
    shutil.copy(native_loader._DEFAULT_LIB, copy)
    monkeypatch.setenv("SPECTRE_DATAIO_LIB", str(copy))
    assert native_loader._lib_path() == str(copy)
    assert native_loader.available()
