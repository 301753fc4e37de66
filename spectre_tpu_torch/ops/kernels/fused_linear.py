"""Kernel 2: the SpectreLinear block's product, LayerNorm and GELU in one pass.

``out = GELU(LN(x @ W + b) * gamma + beta)`` plus ``x`` when K == N, with
x [..., K] and W [K, N] in the JAX [in, out] layout. The K != N pool residual
stays with the caller (``ops/linear.py``), as in the JAX package. The CUDA
kernel is ``csrc/fused_spectre_linear.cu`` (it replaces the forward of the
TPU kernel ``spectre_tpu/ops/pallas/fused_linear.py::fused_spectre_linear``).

With ``save_h`` the kernel also writes the pre-LayerNorm activation
``h = x @ W + b`` in x's dtype. ``fused_spectre_linear_grad`` is the
differentiable form: a ``torch.autograd.Function`` whose forward is the
kernel with ``save_h`` and whose backward is the analytic LayerNorm/GELU
chain and two products on the saved ``h`` (the JAX package's ``_bwd``, which
is jnp outside any kernel there and torch ops here). The forward product is
not run again in the backward.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. There is no fallback from a CUDA tensor to the plain path.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from spectre_tpu_torch.ops.kernels.build import check, load_library

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_N = 1024  # one block owns a whole output row (csrc/fused_spectre_linear.cu)


def fused_spectre_linear_plain(x, w, b, gamma, beta, eps: float = 1e-5,
                               save_h: bool = False):
    """Plain PyTorch version: the kernel's math in float32, cast once. With
    ``save_h`` returns ``(out, h)``, h the pre-LN activation in x's dtype."""
    K, N = w.shape
    h = torch.matmul(x.float(), w.float()) + b.float()
    y = F.gelu(F.layer_norm(h, (N,), gamma.float(), beta.float(), eps))
    if K == N:
        y = y + x.float()
    y = y.to(x.dtype)
    return (y, h.to(x.dtype)) if save_h else y


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


def fused_spectre_linear(x, w, b, gamma, beta, eps: float = 1e-5, save_h: bool = False):
    """GELU(LN(x @ w + b)) (+ x when K == N); leading axes of x are rows.
    With ``save_h`` returns ``(out, h)``, h = x @ w + b in x's dtype. Not
    differentiable: ``fused_spectre_linear_grad`` is."""
    _validate(x, w, b, gamma, beta)
    if x.device.type == "cpu":
        return fused_spectre_linear_plain(x, w, b, gamma, beta, eps, save_h)
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_spectre_linear: no kernel for device {x.device}")
    K, N = w.shape
    if N > MAX_N:
        raise ValueError(f"fused_spectre_linear kernel takes N <= {MAX_N}, got {N}")
    lib = load_library()
    m = x.numel() // K
    out = torch.empty((*x.shape[:-1], N), dtype=x.dtype, device=x.device)
    h = torch.empty_like(out) if save_h else None
    with torch.cuda.device(x.device):
        err = lib.fused_spectre_linear_fwd(
            _DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(), b.data_ptr(),
            gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
            h.data_ptr() if save_h else None, m, K, N, eps,
            torch.cuda.current_stream().cuda_stream)
    check(err, "fused_spectre_linear_fwd launch")
    fused_spectre_linear.launches += 1
    return (out, h) if save_h else out


fused_spectre_linear.launches = 0

_INV_SQRT2 = 2.0 ** -0.5
_INV_SQRT_2PI = (2.0 * math.pi) ** -0.5


class _FusedSpectreLinear(torch.autograd.Function):
    """Forward: the kernel, saving the pre-LN ``h``. Backward: float32
    throughout, each gradient cast to the dtype of what it is the gradient
    of. LayerNorm statistics come from the saved (rounded) ``h``."""

    @staticmethod
    def forward(ctx, x, w, b, gamma, beta, eps):
        out, h = fused_spectre_linear(x, w, b, gamma, beta, eps, save_h=True)
        ctx.save_for_backward(x, w, gamma, beta, h)
        ctx.eps = eps
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, gamma, beta, h = ctx.saved_tensors
        K, N = w.shape
        hf = h.float().reshape(-1, N)
        gy = g.float().reshape(-1, N)
        gam = gamma.float()

        var, mu = torch.var_mean(hf, dim=-1, keepdim=True, correction=0)
        rsig = torch.rsqrt(var + ctx.eps)
        u = (hf - mu) * rsig
        z = u * gam + beta.float()
        # gelu'(z) = Phi(z) + z * phi(z), the exact erf form
        dgelu = 0.5 * (1.0 + torch.erf(z * _INV_SQRT2)) \
            + z * torch.exp(-0.5 * z * z) * _INV_SQRT_2PI
        dz = gy * dgelu
        dgamma = (dz * u).sum(0)
        dbeta = dz.sum(0)
        du = dz * gam
        dh = rsig * (du - du.mean(-1, keepdim=True) - u * (du * u).mean(-1, keepdim=True))
        db = dh.sum(0)
        x2 = x.float().reshape(-1, K)
        dw = torch.matmul(x2.t(), dh)
        dx = torch.matmul(dh, w.float().t())
        if K == N:
            dx = dx + gy
        return (dx.reshape(x.shape).to(x.dtype), dw.to(w.dtype), db.to(w.dtype),
                dgamma.to(gamma.dtype), dbeta.to(beta.dtype), None)


def fused_spectre_linear_grad(x, w, b, gamma, beta, eps: float = 1e-5):
    """``fused_spectre_linear`` with gradients for x, w, b, gamma and beta."""
    return _FusedSpectreLinear.apply(x, w, b, gamma, beta, eps)
