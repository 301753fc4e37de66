"""Kernel 2 above N = 1,024 on the CPU: which CUDA kernels a call on the card
takes (for bf16 that TMA can describe, the wide cluster kernel up to its
reach on the card; the cluster kernel beyond it and for the rest; the wide
chain of the backward), the wide cluster kernel's size
and its split-row LayerNorm statistics emulated in plain torch, and the
plain forward and backward at such N against the JAX package's Pallas
kernel in interpret mode and its VJP, in float32, with the JAX package's
own tolerances (tests/test_pallas.py: 1e-5 forward, 1e-4 gradients).
tests/test_torch_port_cuda.py holds the kernels to the plain versions on
the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from spectre_tpu.ops.pallas import fused_spectre_linear as jax_fused_spectre_linear
from spectre_tpu.ops.linear import adaptive_avg_pool1d
from spectre_tpu.ops.pallas.fused_linear import _forward as jax_forward
from spectre_tpu_torch.ops import spectre_linear_apply
from spectre_tpu_torch.ops.kernels import fused_linear
from spectre_tpu_torch.ops.kernels import (
    backward_kernel,
    forward_kernel,
    fused_spectre_linear_plain,
    wide_cluster_size,
)

WIDE_CLUSTER, CLUSTER = "fused_spectre_linear_wide_cluster", "fused_spectre_linear_cluster"


def _card_reach(monkeypatch, reach):
    """Stand in for the card's answer to ``wide_cluster_reach`` (4,096 on
    the H100), which needs a card; returns the devices it is asked about."""
    asked = []
    monkeypatch.setattr(fused_linear, "wide_cluster_reach",
                        lambda device: asked.append(device) or reach)
    return asked


@pytest.mark.parametrize("n", [1100, 1536, 2048])
@pytest.mark.parametrize("k", [768, 1536])
def test_n_above_1024_names_a_wide_kernel(monkeypatch, k, n):
    """bf16 that TMA can describe (N a multiple of 8) on the wide cluster
    kernel; N = 1,100 in bf16, unaligned operands and every float32 call on
    the cluster kernel, which splits the row across its blocks; no call
    raises."""
    _card_reach(monkeypatch, 4096)
    assert forward_kernel(torch.bfloat16, k, n, device=0) == (
        WIDE_CLUSTER if n % 8 == 0 else CLUSTER)
    assert forward_kernel(torch.float32, k, n) == CLUSTER
    assert forward_kernel(torch.bfloat16, k, n, aligned=False) == CLUSTER
    assert backward_kernel(n) == "fused_spectre_linear_bwd_wide"


@pytest.mark.parametrize("n,size", [(1032, 5), (1536, 6), (2048, 8), (4096, 16)])
def test_the_wide_cluster_takes_n_up_to_its_reach(monkeypatch, n, size):
    """A cluster of one block for every 256 columns; the kernel takes N up
    to 256 times the largest cluster the card holds (16 blocks, N = 4,096,
    where the card allows non-portable clusters; 8, N = 2,048, where it
    does not), which ``forward_kernel`` asks of the card it was given, and
    the cluster kernel takes the N beyond."""
    assert wide_cluster_size(n) == size
    asked = _card_reach(monkeypatch, 4096)
    assert forward_kernel(torch.bfloat16, 768, n, device=3) == WIDE_CLUSTER
    assert forward_kernel(torch.bfloat16, 768, 4104, device=3) == CLUSTER
    assert asked == [3, 3]
    assert forward_kernel(torch.bfloat16, 768, 768, device=3) == "fused_spectre_linear_wgmma"
    assert forward_kernel(torch.float32, 768, n, device=3) == CLUSTER
    assert asked == [3, 3]  # asked only for bf16 that TMA can describe above N = 768
    _card_reach(monkeypatch, 256 * size)
    assert forward_kernel(torch.bfloat16, 768, n, device=0) == WIDE_CLUSTER
    _card_reach(monkeypatch, n - 8)
    assert forward_kernel(torch.bfloat16, 768, n, device=0) == CLUSTER
    _card_reach(monkeypatch, 2048)
    assert forward_kernel(torch.bfloat16, 768, 2056, device=0) == CLUSTER


@pytest.mark.parametrize("n", [100, 512, 768, 1024])
def test_n_up_to_1024_keeps_its_kernels(monkeypatch, n):
    """At N <= 1,024 bf16 that TMA can describe stays on the wgmma kernel up
    to N = 768 and goes to the wide cluster kernel above (N = 1,024: a
    cluster of four); the rest goes to the cluster kernel."""
    _card_reach(monkeypatch, 4096)
    assert forward_kernel(torch.float32, 512, n, device=0) == CLUSTER
    assert forward_kernel(torch.bfloat16, 512, n, device=0) == (
        CLUSTER if n % 8 else "fused_spectre_linear_wgmma" if n <= 768 else WIDE_CLUSTER)
    assert backward_kernel(n) == "fused_spectre_linear_bwd_chain"


def _wide_stats(h, cn):
    """The wide cluster kernel's LayerNorm statistics in plain torch,
    float32: each block's (mean, M2) over its 256 columns by two passes, the
    second also summing the deviations from the first mean to correct it,
    then the cn partials combined in rank order by Chan's formula; the
    divisor is N."""
    parts = []
    for j in range(cn):
        v = h[:, 256 * j:256 * (j + 1)]
        nb = float(v.shape[-1])
        mean1 = v.sum(-1) / nb
        d = v - mean1[:, None]
        dsum = d.sum(-1)
        parts.append((nb, mean1 + dsum / nb, (d * d).sum(-1) - dsum * dsum / nb))
    na, mean, m2 = parts[0]
    for nb, mean_b, m2_b in parts[1:]:
        tot = na + nb
        d = mean_b - mean
        mean = mean + d * (nb / tot)
        m2 = m2 + m2_b + d * d * (na * nb / tot)
        na = tot
    return mean, m2 / h.shape[-1]


# N = 1,536 and 2,048 (clusters of 6 and 8), K == N (the identity residual)
# and K != N (the pool residual, the caller's), 8 rows
@pytest.mark.parametrize("k,n", [(1536, 1536), (256, 1536), (2048, 2048), (512, 2048)])
def test_split_row_chan_combine_matches_the_pallas_kernel(k, n):
    """From the Pallas kernel's own float32 h (interpret mode): the combined
    mean and variance within 1e-6 of the kernel's (jnp.mean of h and of the
    squared deviations; the mean relative to |mean| + std), and the output
    built on them (exact erf GELU, the identity residual) within 1e-6 of the
    largest entry of the kernel's (A&S erf, within 1.5e-7)."""
    cn = wide_cluster_size(n)
    arrays = _case(8, k, n, seed=k + n)[:5]
    out, h = jax_forward(*map(jnp.asarray, arrays), 1e-5, True)
    if k != n:  # the kernel's own output, without the caller's pool residual
        out = out - adaptive_avg_pool1d(jnp.asarray(arrays[0]), n)
    hj = jnp.asarray(h)
    want_mean = jnp.mean(hj, axis=-1)
    want_var = jnp.mean((hj - want_mean[:, None]) ** 2, axis=-1)
    ht = torch.from_numpy(np.array(h))
    mean, var = _wide_stats(ht, cn)
    want_mean, want_var = (torch.from_numpy(np.array(a)) for a in (want_mean, want_var))
    scale = want_mean.abs() + want_var.sqrt()
    assert ((mean - want_mean).abs() / scale).max().item() <= 1e-6
    assert ((var - want_var).abs() / want_var).max().item() <= 1e-6
    gamma, beta = torch.from_numpy(arrays[3]), torch.from_numpy(arrays[4])
    y = F.gelu((ht - mean[:, None]) * torch.rsqrt(var[:, None] + 1e-5) * gamma + beta)
    if k == n:
        y = y + torch.from_numpy(arrays[0])
    want = torch.from_numpy(np.array(out))
    assert (y - want).abs().max().item() <= 1e-6 * want.abs().max().item()


def _case(m, k, n, seed):
    rng = np.random.default_rng(seed)
    return [a.astype(np.float32) for a in (
        rng.standard_normal((m, k)), rng.uniform(-k ** -0.5, k ** -0.5, (k, n)),
        0.1 * rng.standard_normal(n), rng.uniform(0.5, 1.5, n), 0.1 * rng.standard_normal(n),
        rng.standard_normal((m, n)))]


# K == N (the identity residual inside the kernel's function), K < N with
# N = 1,100 (a pool residual that does not divide evenly), K > N; ragged rows
@pytest.mark.parametrize("m,k,n", [(65, 1536, 1536), (33, 64, 1100), (9, 2048, 1100)])
def test_plain_forward_and_backward_match_the_pallas_kernel(m, k, n):
    arrays = _case(m, k, n, seed=m + k + n)
    jargs = [jnp.asarray(a) for a in arrays]
    want, vjp = jax.vjp(lambda *a: jax_fused_spectre_linear(*a, interpret=True), *jargs[:5])
    want_grads = vjp(jargs[5])
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays[:5]]
    got = spectre_linear_apply(*leaves)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    got.backward(torch.from_numpy(arrays[5]))
    for name, t, wg in zip(("dx", "dw", "db", "dgamma", "dbeta"), leaves, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(wg), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    # the kernel's own function and its saved h: the pre-LN float32 product
    out, h = fused_spectre_linear_plain(*map(torch.from_numpy, arrays[:5]), save_h=True)
    want_out, want_h = jax_forward(*jargs[:5], 1e-5, True)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), rtol=1e-5, atol=1e-5)
    if k == n:
        np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=1e-5, atol=1e-5)
