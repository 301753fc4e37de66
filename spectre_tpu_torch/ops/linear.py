"""Linear-layer building blocks (port of spectre_tpu/ops/linear.py).

- ``adaptive_avg_pool1d``: torch ``nn.AdaptiveAvgPool1d`` semantics over the
  last axis; a grouped mean when the width divides evenly, else a product
  with the precomputed [L, Lo] averaging matrix (the SpectreLinear residual).
- ``gelu_exact``: the erf form of GELU (torch's default).
- ``spectre_linear_apply``: GELU(LN(x @ w + b)) + pool(x), w in the JAX
  [in, out] layout. On CUDA tensors the product, LayerNorm and GELU run in
  the hand-written kernel (ops/kernels/fused_linear.py), through its
  autograd Function when a gradient is wanted; the pool residual for K != N
  is added here in plain torch, as the JAX package adds it outside its
  kernel, and autograd differentiates it.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from spectre_tpu_torch.ops.kernels import fused_spectre_linear, fused_spectre_linear_grad, library
from spectre_tpu_torch.profile.spans import span


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)


@lru_cache(maxsize=None)
def _adaptive_pool_matrix_np(in_len: int, out_len: int) -> np.ndarray:
    """[in_len, out_len] matrix M with pool(x) = x @ M.

    torch AdaptiveAvgPool1d: out[i] = mean(x[floor(i*L/Lo) : ceil((i+1)*L/Lo)]).
    """
    m = np.zeros((in_len, out_len), dtype=np.float32)
    for i in range(out_len):
        start = (i * in_len) // out_len
        end = -((-(i + 1) * in_len) // out_len)  # ceil
        m[start:end, i] = 1.0 / (end - start)
    m.setflags(write=False)
    return m


def adaptive_pool_matrix(in_len: int, out_len: int, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    return torch.tensor(_adaptive_pool_matrix_np(in_len, out_len), dtype=dtype,
                        device=device)


def adaptive_avg_pool1d(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """Pool the last axis of x to ``out_len`` with torch-adaptive semantics.

    Identity when the widths match; a grouped mean in x's dtype when they
    divide evenly (the JAX package's shortcut); else the pool-matrix product.
    """
    in_len = x.shape[-1]
    if in_len == out_len:
        return x
    if in_len % out_len == 0:
        g = in_len // out_len
        return x.reshape(*x.shape[:-1], out_len, g).mean(dim=-1)
    m = adaptive_pool_matrix(in_len, out_len, x.dtype, x.device)
    return torch.matmul(x, m)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, torch eps=1e-5."""
    return F.layer_norm(x, x.shape[-1:], gamma, beta, eps)


def spectre_linear_apply(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-5,
                         pool_matrix: torch.Tensor | None = None) -> torch.Tensor:
    """GELU(LayerNorm(x @ w + b)) + adaptive_avg_pool(x), w: [in, out].

    Every operand must share x's dtype and device. The identity residual
    (K == N) is part of the kernel; the pool residual (K != N) is added here,
    through ``pool_matrix`` ([K, N], ``adaptive_pool_matrix``) when the
    caller holds one. While ``torch.export`` traces, the kernel is the custom
    op ``kernels.library.fused_spectre_linear`` (the forward without h).
    """
    operands = (x, w, b, gamma, beta)
    with span("op/spectre_linear"):
        if torch.compiler.is_exporting():
            out = library.fused_spectre_linear(*operands, eps)
        elif torch.is_grad_enabled() and any(t.requires_grad for t in operands):
            out = fused_spectre_linear_grad(*operands, eps)
        else:  # nothing to differentiate: the kernel does not write its saved h
            out = fused_spectre_linear(*operands, eps)
        if pool_matrix is not None:
            return out + torch.matmul(x, pool_matrix)
        if w.shape[0] != w.shape[1]:
            out = out + adaptive_avg_pool1d(x, w.shape[1])
        return out
