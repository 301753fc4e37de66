"""ctypes bindings for the native data-loading library (port of
spectre_tpu/data/native_loader.py).

``native/dataio/dataio.cc``, built by ``make -C native`` into
``native/build/libspectre_dataio.so``, decodes CIFAR-100 binary and MNIST IDX
files straight into float32 buffers and assembles shuffled batches on
threads. ``$SPECTRE_DATAIO_LIB`` names another build and is read first, at
each call. Without the library ``available()`` is False and
``data/datasets.py`` reads the same files with numpy. The library is host
code: no device and no kernel is involved.

The library scales a byte by a multiply with 1/255, where numpy (and both
packages' Python readers) divide by 255: half the pixel values then differ
by one float32 ulp. The loaders here take the byte back (``rint(x * 255)``
is exact) and divide as numpy does, so that a dataset reads to the same
array with and without the library; the JAX package's bindings return the
library's values as they are.
"""

from __future__ import annotations

import ctypes
import os
import struct

import numpy as np

_DEFAULT_LIB = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "native",
                            "build", "libspectre_dataio.so")
_f32, _i32, _i64 = (ctypes.POINTER(t) for t in (ctypes.c_float, ctypes.c_int32, ctypes.c_int64))
_libs: dict[str, ctypes.CDLL] = {}


def _lib_path() -> str | None:
    """The first library that exists: ``$SPECTRE_DATAIO_LIB``, then the
    default build."""
    for p in (os.environ.get("SPECTRE_DATAIO_LIB", ""), _DEFAULT_LIB):
        if p and os.path.exists(p):
            return os.path.abspath(p)
    return None


def _load() -> ctypes.CDLL | None:
    path = _lib_path()
    if path is None:
        return None
    if path not in _libs:
        lib = ctypes.CDLL(path)
        lib.dataio_load_cifar100_bin.argtypes = [ctypes.c_char_p, _f32, _i32, ctypes.c_int64]
        lib.dataio_load_cifar100_bin.restype = ctypes.c_int64
        lib.dataio_load_mnist_idx.argtypes = [ctypes.c_char_p, ctypes.c_char_p, _f32, _i32,
                                              ctypes.c_int64]
        lib.dataio_load_mnist_idx.restype = ctypes.c_int64
        lib.dataio_gather_batch.argtypes = [_f32, _i32, _i64, ctypes.c_int64, ctypes.c_int64,
                                            _f32, _i32]
        lib.dataio_gather_batch.restype = None
        _libs[path] = lib
    return _libs[path]


def available() -> bool:
    return _load() is not None


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("the native dataio library is not built (make -C native) and "
                           "$SPECTRE_DATAIO_LIB names no file")
    return lib


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def _as_numpy_scales(images: np.ndarray) -> np.ndarray:
    """The library's byte * (1/255) as numpy's float32(byte) / 255."""
    return np.rint(images * np.float32(255.0)) / np.float32(255.0)


def load_cifar100_bin(path: str, max_n: int = 60000) -> tuple[np.ndarray, np.ndarray]:
    """(images [N, 3, 32, 32] float32 in [0, 1], fine labels [N] int32) of a
    CIFAR-100 binary file of at most ``max_n`` records."""
    lib = _require()
    images = np.empty((max_n, 3, 32, 32), np.float32)
    labels = np.empty((max_n,), np.int32)
    n = lib.dataio_load_cifar100_bin(path.encode(), _ptr(images, ctypes.c_float),
                                     _ptr(labels, ctypes.c_int32), max_n)
    if n < 0:
        raise OSError(f"native decode failed for {path}")
    return _as_numpy_scales(images[:n]), labels[:n]


def load_mnist_idx(images_path: str, labels_path: str,
                   max_n: int = 70000) -> tuple[np.ndarray, np.ndarray]:
    """(images [N, 1, 28, 28] float32 in [0, 1], labels [N] int32) of an MNIST
    IDX image and label file pair."""
    lib = _require()
    with open(images_path, "rb") as f:
        header = f.read(16)
    if len(header) < 16 or struct.unpack(">II", header[8:])[0:2] != (28, 28):
        raise ValueError(f"{images_path} is not an IDX file of 28 x 28 images")
    images = np.empty((max_n, 1, 28, 28), np.float32)
    labels = np.empty((max_n,), np.int32)
    n = lib.dataio_load_mnist_idx(images_path.encode(), labels_path.encode(),
                                  _ptr(images, ctypes.c_float), _ptr(labels, ctypes.c_int32),
                                  max_n)
    if n < 0:
        raise OSError(f"native decode failed for {images_path}")
    return _as_numpy_scales(images[:n]), labels[:n]


def gather_batch(images: np.ndarray, labels: np.ndarray,
                 perm: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(images[perm], labels[perm]) assembled on the library's threads."""
    lib = _require()
    images = np.ascontiguousarray(images, np.float32)
    labels = np.ascontiguousarray(labels, np.int32)
    perm = np.ascontiguousarray(perm, np.int64)
    if labels.shape != images.shape[:1]:
        raise ValueError(f"{images.shape[0]} images but labels of shape {labels.shape}")
    if perm.size and (perm.min() < 0 or perm.max() >= images.shape[0]):
        raise IndexError(f"perm holds indices outside [0, {images.shape[0]})")
    b = perm.shape[0]
    out_i = np.empty((b,) + images.shape[1:], np.float32)
    out_l = np.empty((b,), np.int32)
    lib.dataio_gather_batch(_ptr(images, ctypes.c_float), _ptr(labels, ctypes.c_int32),
                            _ptr(perm, ctypes.c_int64), b, int(np.prod(images.shape[1:])),
                            _ptr(out_i, ctypes.c_float), _ptr(out_l, ctypes.c_int32))
    return out_i, out_l
