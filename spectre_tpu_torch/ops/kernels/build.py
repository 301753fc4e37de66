"""Build the hand-written CUDA kernels and load them through ctypes.

One ``nvcc`` command compiles every ``*.cu`` file in ``spectre_tpu_torch/csrc/``
into one shared library with a plain C interface, the sources side by side
(``--threads 0``: one compilation thread per core; without it they compile one
after another):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC \
         --threads 0 -o build/kernels/libspectre_kernels_<hash>.so csrc/*.cu

The build runs at first use, into ``build/kernels/`` at the repository root
(ignored by git), and the file name carries a hash of the sources and flags,
so an edited source never loads a stale library. Nothing here runs at import
time: the CPU tests import every module on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--threads", "0")

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
# C entry points and their argument types (pointers and the stream as void*)
_SIGNATURES = {
    "block_scatter_rows": (_P, _P, _P, _LL, _LL, _LL, _LL, ctypes.c_int, _P),
    "block_gather_sum": (_P, _P, _P, _LL, _LL, _LL, _LL, ctypes.c_int, _P),
    "inverse_gather_sum": (_P, _P, _P, _LL, _LL, _LL, ctypes.c_int, _P),
    "routed_gather_sum": (_P, _P, _P, _P, _P, _LL, _LL, _LL, _LL, ctypes.c_int, _P),
    "fused_spectre_linear_cluster": (ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, _LL, _LL, _LL,
                                     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_float, _P),
    "fused_spectre_linear_bwd_chain": (ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                       _LL, _LL, _LL, ctypes.c_float, _P),
    "fused_spectre_linear_wgmma": (_P, _P, _P, _P, _P, _P, _P, _LL, _LL, _LL, ctypes.c_float, _P),
    "fused_spectre_linear_wide_cluster": (_P, _P, _P, _P, _P, _P, _P, _LL, _LL, _LL,
                                          ctypes.c_float, _P),
    "fused_spectre_linear_wide_cluster_reach": (ctypes.POINTER(ctypes.c_int),),
    "fused_spectre_linear_shard_stats": (ctypes.c_int, _P, _P, _P, _P, _P, _LL, _LL, _LL,
                                         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, _P),
    "fused_spectre_linear_shard_stats_wgmma": (_P, _P, _P, _P, _P, _LL, _LL, _LL, ctypes.c_int,
                                               ctypes.c_int, _P),
    "fused_spectre_linear_shard_ln": (ctypes.c_int, ctypes.c_int, _P, _LL, _P, ctypes.c_int, _P,
                                      _P, _P, _P, _LL, _P, _P, _P, _LL, _LL, _LL,
                                      ctypes.c_float, _LL, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int, _P),
    "fused_spectre_linear_shard_ln_occupancy": (ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                                ctypes.POINTER(ctypes.c_int)),
    "fused_spectre_linear_shard_sums": (ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _LL,
                                        _LL, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P),
    "fused_spectre_linear_shard_dh": (ctypes.c_int, _P, _P, _P, _P, _P, _P, ctypes.c_int, _P, _P,
                                      _P, _LL, _LL, _LL, _LL, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, _P),
    "fused_spectre_linear_shard_occupancy": (ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                             ctypes.c_int, ctypes.POINTER(ctypes.c_int)),
    "fused_spectre_linear_bwd_wide": (ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                      _LL, _LL, _LL, ctypes.c_float, _P, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int),
    "fused_spectre_linear_bwd_wide_occupancy": (ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                                ctypes.c_int, ctypes.POINTER(ctypes.c_int)),
    "fused_block_bwd_grouped": (ctypes.c_int, _P, _P, _P, _P, _P, _LL, _LL, _LL, _LL, _LL, _LL,
                                _LL, ctypes.c_int, ctypes.c_int, _P),
    "fused_block_bwd_wgmma": (_P, _P, _P, _P, _P, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _P, _LL, _LL,
                              _LL, _P),
    "fwht": (_P, _P, _LL, _LL, ctypes.c_float, ctypes.c_int, _P),
    "structured_mix_fwd": (ctypes.c_int, _P, _P, _P, _P, _LL, _LL, _LL, _LL, ctypes.c_float, _P),
    "structured_mix_bwd": (ctypes.c_int, _P, _P, _P, _P, _LL, _LL, _LL, _LL, ctypes.c_float, _P),
    # the strides argument is a host array of long long
    "flash_attention_fwd": (ctypes.c_int, _P, _P, _P, _P, _P, _P, _LL, _LL, _LL, _LL, _P,
                            ctypes.c_float, _P),
    "flash_attention_bwd": (ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _LL, _LL,
                            _LL, _P, ctypes.c_float, _P),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels cannot be built on this machine")


def _sources() -> list[str]:
    names = sorted(n for n in os.listdir(CSRC) if n.endswith((".cu", ".cuh")))
    return [os.path.join(CSRC, n) for n in names]


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libspectre_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile csrc/*.cu into the shared library unless it is already built.
    Returns the library path; raises with nvcc's output when the build fails."""
    so = library_path()
    if os.path.exists(so):
        return so
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    cu = [s for s in _sources() if s.endswith(".cu")]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *cu]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{' '.join(cmd)}\n"
                           f"{r.stdout}\n{r.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return so


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    lib = ctypes.CDLL(build())
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def current_stream(device_index: int) -> int:
    """The raw handle of a device's current CUDA stream, the int a C entry
    point takes: ``torch.cuda.current_stream(i).cuda_stream`` without
    building a Stream object at every launch."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def check(err: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
