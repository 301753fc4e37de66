"""The backward of the port's SpectreLinear block (kernel 2's backward,
``fused_spectre_linear_bwd``) on the CPU, where it runs its plain version
``fused_spectre_linear_bwd_plain``: in bf16 against an explicit numpy
formula of the arithmetic the CUDA chain kernel and the bf16 products state,
and against ``jax.vjp`` of the JAX package's Pallas kernel (interpret mode)
fed the same bf16 inputs; in float32 against autograd of the plain forward.
tests/test_torch_port_cuda.py holds the kernel to the plain version on the
card.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectre_tpu.ops.pallas import fused_spectre_linear as jax_fused_spectre_linear
from spectre_tpu_torch.ops import spectre_linear_apply
from spectre_tpu_torch.ops.kernels import (
    fused_spectre_linear_bwd,
    fused_spectre_linear_bwd_plain,
    fused_spectre_linear_plain,
)
from spectre_tpu_torch.ops.kernels.fused_linear import BWD_BLOCKS_PER_SM

EPS = 1e-5
# (M, K, N): K > N (the 768 -> 512 pool), K < N (512 -> 768), K == N (the
# identity residual joins the product), the head's N = 100; M odd, even,
# a multiple of the chain kernel's 4 warps a block and not
SHAPES = [(130, 48, 32), (70, 16, 40), (65, 32, 32), (9, 64, 100), (128, 24, 16)]


def _bf16(x):
    """float32 values rounded to the nearest bfloat16 (ties to even), as float32."""
    u = np.asarray(x, np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def _case(m, k, n, seed, rounded=True):
    """x, w, b, gamma, beta, the cotangent g, as float32 arrays, rounded to
    bf16 when ``rounded``."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((m, k)), rng.uniform(-k ** -0.5, k ** -0.5, (k, n)),
              0.1 * rng.standard_normal(n), rng.uniform(0.5, 1.5, n),
              0.1 * rng.standard_normal(n), rng.standard_normal((m, n))]
    arrays = [a.astype(np.float32) for a in arrays]
    return [_bf16(a) for a in arrays] if rounded else arrays


def _formula(x, w, gamma, beta, h, g, round_dh):
    """(dx, dw, db, dgamma, dbeta) in float64 from float32 inputs: the chain,
    then dh rounded to bf16 (``round_dh``) before the two products; the
    identity residual added to dx when K == N."""
    x, w, gamma, beta, h, g = (a.astype(np.float64) for a in (x, w, gamma, beta, h, g))
    mu = h.mean(-1, keepdims=True)
    rsig = 1.0 / np.sqrt(((h - mu) ** 2).mean(-1, keepdims=True) + EPS)
    u = (h - mu) * rsig
    z = u * gamma + beta
    erf = np.vectorize(math.erf)
    dz = g * (0.5 * (1.0 + erf(z / math.sqrt(2.0))) + z * np.exp(-0.5 * z * z)
              / math.sqrt(2.0 * math.pi))
    du = dz * gamma
    dh = rsig * (du - du.mean(-1, keepdims=True) - u * (du * u).mean(-1, keepdims=True))
    dh_op = _bf16(dh.astype(np.float32)).astype(np.float64) if round_dh else dh
    dx = dh_op @ w.T
    if w.shape[0] == w.shape[1]:
        dx = dx + g
    return dx, x.T @ dh_op, dh.sum(0), (dz * u).sum(0), dz.sum(0)


def _bf16_bwd_inputs(m, k, n, seed):
    """bf16 tensors x, w, gamma, beta, h (the forward's saved h: x @ w + b in
    float32, rounded once) and g; and the same values as float32 arrays."""
    x, w, b, gamma, beta, g = _case(m, k, n, seed)
    h = _bf16(x @ w + b)
    arrays = [x, w, gamma, beta, h, g]
    return [torch.from_numpy(a).to(torch.bfloat16) for a in arrays], arrays


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_bf16_plain_backward_is_the_stated_arithmetic(m, k, n):
    """At least 99% of the entries of every gradient equal the formula's
    (float64, rounded to bf16 once at the end) bit for bit; the rest differ
    where a float32 sum order moved a value across a bf16 rounding boundary,
    within 2^-8 of the largest entry. Without rounding dh the formula
    matches only about 55-72% of the entries of dx and dw: the rounding is
    part of the arithmetic."""
    tensors, arrays = _bf16_bwd_inputs(m, k, n, seed=m + k + n)
    got = [t.double().numpy() for t in fused_spectre_linear_bwd_plain(*tensors, EPS)]
    assert all(t.dtype == torch.bfloat16 for t in fused_spectre_linear_bwd_plain(*tensors))
    want = _formula(*arrays, round_dh=True)
    for name, a, w in zip(("dx", "dw", "db", "dgamma", "dbeta"), got, want):
        wb = _bf16(w.astype(np.float32))
        assert a.shape == w.shape, name
        assert float((a == wb).mean()) >= 0.99, name
        assert np.abs(a - wb).max() <= 2.0 ** -8 * np.abs(w).max(), name
    unrounded = _formula(*arrays, round_dh=False)
    for name, a, w in zip(("dx", "dw"), got, unrounded):
        assert float((a == _bf16(w.astype(np.float32))).mean()) <= 0.8, name


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_bf16_backward_matches_the_pallas_kernels_vjp_in_bf16(m, k, n):
    """bf16 inputs fed to both: the port's block (the plain forward and,
    through the autograd Function, the plain backward, with the pool
    residual for K != N) against ``jax.vjp`` of the Pallas kernel in
    interpret mode, whose backward keeps dh in float32 and multiplies
    float32 operands: each gradient within 2^-6 of its largest entry."""
    arrays = _case(m, k, n, seed=10 + m + k + n)
    jargs = [jnp.asarray(a, dtype=jnp.bfloat16) for a in arrays]
    _, vjp = jax.vjp(lambda *a: jax_fused_spectre_linear(*a, interpret=True), *jargs[:5])
    want_grads = vjp(jargs[5])
    ts = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_() for a in arrays[:5]]
    spectre_linear_apply(*ts).backward(torch.from_numpy(arrays[5]).to(torch.bfloat16))
    for name, t, wg in zip(("dx", "dw", "db", "dgamma", "dbeta"), ts, want_grads):
        want = np.asarray(wg.astype(jnp.float32))
        assert t.grad.dtype == torch.bfloat16, name
        err = float(np.abs(t.grad.float().numpy() - want).max())
        assert err <= 2.0 ** -6 * float(np.abs(want).max()), (name, err)


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_float32_backward_matches_autograd_of_the_plain_forward(m, k, n):
    """float32 throughout: the plain backward on the saved h against autograd
    of ``fused_spectre_linear_plain``, each gradient within 1e-5 of its
    largest entry."""
    x, w, b, gamma, beta, g = (torch.from_numpy(a)
                               for a in _case(m, k, n, seed=m, rounded=False))
    leaves = [t.clone().requires_grad_() for t in (x, w, b, gamma, beta)]
    fused_spectre_linear_plain(*leaves).backward(g)
    _, h = fused_spectre_linear_plain(x, w, b, gamma, beta, save_h=True)
    got = fused_spectre_linear_bwd(x, w, gamma, beta, h, g)
    for name, a, t in zip(("dx", "dw", "db", "dgamma", "dbeta"), got, leaves):
        assert a.dtype == torch.float32 and a.shape == t.shape, name
        scale = t.grad.abs().max().item()
        assert (a - t.grad).abs().max().item() <= 1e-5 * scale, name


def test_grid_matches_the_chain_kernels_launch_bounds():
    """The wrapper's grid (blocks an SM) is the one the kernel's launch
    bounds promise to keep resident (csrc/fused_spectre_linear_bwd.cu)."""
    import pathlib

    src = pathlib.Path(__file__).parents[1] / "spectre_tpu_torch" / "csrc" \
        / "fused_spectre_linear_bwd.cu"
    assert f"constexpr int kBlocksPerSM = {BWD_BLOCKS_PER_SM};" in src.read_text()
