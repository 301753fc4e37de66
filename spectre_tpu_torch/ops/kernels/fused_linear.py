"""Kernel 2: the SpectreLinear block's product, LayerNorm and GELU in one pass.

``out = GELU(LN(x @ W + b) * gamma + beta)`` plus ``x`` when K == N, with
x [..., K] and W [K, N] in the JAX [in, out] layout. The K != N pool residual
stays with the caller (``ops/linear.py``), as in the JAX package. The CUDA
kernel is ``csrc/fused_spectre_linear.cu`` (it replaces the forward of the
TPU kernel ``spectre_tpu/ops/pallas/fused_linear.py::fused_spectre_linear``).

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. There is no fallback from a CUDA tensor to the plain path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from spectre_tpu_torch.ops.kernels.build import check, load_library

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_N = 1024  # one block owns a whole output row (csrc/fused_spectre_linear.cu)


def fused_spectre_linear_plain(x, w, b, gamma, beta, eps: float = 1e-5):
    """Plain PyTorch version: the kernel's math in float32, cast once."""
    K, N = w.shape
    h = torch.matmul(x.float(), w.float()) + b.float()
    y = F.gelu(F.layer_norm(h, (N,), gamma.float(), beta.float(), eps))
    if K == N:
        y = y + x.float()
    return y.to(x.dtype)


def _validate(x, w, b, gamma, beta) -> None:
    if w.dim() != 2 or x.dim() < 1 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"want x [..., K] and w [K, N]; got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    n = w.shape[1]
    for name, t in (("b", b), ("gamma", gamma), ("beta", beta)):
        if tuple(t.shape) != (n,):
            raise ValueError(f"{name} must be [{n}], got {tuple(t.shape)}")
    for t in (x, w, b, gamma, beta):
        if t.dtype != x.dtype:
            raise TypeError(f"all operands must share x's dtype {x.dtype}; got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"all operands must be on {x.device}; got {t.device}")
        if not t.is_contiguous():
            raise ValueError("fused_spectre_linear needs contiguous operands")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_spectre_linear takes float32 or bfloat16, not {x.dtype}")


def fused_spectre_linear(x, w, b, gamma, beta, eps: float = 1e-5):
    """GELU(LN(x @ w + b)) (+ x when K == N); leading axes of x are rows."""
    _validate(x, w, b, gamma, beta)
    if x.device.type == "cpu":
        return fused_spectre_linear_plain(x, w, b, gamma, beta, eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_spectre_linear: no kernel for device {x.device}")
    K, N = w.shape
    if N > MAX_N:
        raise ValueError(f"fused_spectre_linear kernel takes N <= {MAX_N}, got {N}")
    lib = load_library()
    m = x.numel() // K
    out = torch.empty((*x.shape[:-1], N), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.fused_spectre_linear_fwd(
            _DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(), b.data_ptr(),
            gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), m, K, N, eps,
            torch.cuda.current_stream().cuda_stream)
    check(err, "fused_spectre_linear_fwd launch")
    fused_spectre_linear.launches += 1
    return out


fused_spectre_linear.launches = 0
