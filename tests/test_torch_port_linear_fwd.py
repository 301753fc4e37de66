"""Kernel 2's forward and kernel 5 on the CPU: which CUDA kernel a call on
the card takes, the cluster kernel's launch plan (``cluster_plan``) and its
rank-ordered LayerNorm statistics emulated in plain torch, and the plain
version of the forward against the JAX package's Pallas kernel (interpret
mode) at the bf16 wgmma kernel's shape class with ragged rows and at the
cluster kernel's head shapes.

The dispatch and plan functions are pure: they see the dtype, the shapes,
the alignment and the card's SM count, as the wrappers do before a launch.
"""

import math


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectre_tpu.ops.pallas import fused_spectre_linear as jax_fused_spectre_linear
from spectre_tpu.ops.pallas.fused_linear import _forward as jax_forward
from spectre_tpu_torch.ops import spectre_linear_apply
from spectre_tpu_torch.ops.kernels import fused_linear
from spectre_tpu_torch.ops.kernels import (
    block_bwd_kernel,
    cluster_plan,
    forward_kernel,
    fused_spectre_linear,
    fused_spectre_linear_plain,
    launch_counts,
)

WGMMA, CLUSTER = "fused_spectre_linear_wgmma", "fused_spectre_linear_cluster"


# (rows, K, N): the flagship's linear1 and linear3 at B=256 and B=1024, the
# mix projection of "gather" and "structured" at K=8,192, and the serving
# buckets' rows 65 x {1, 2, 7, 64, 256}
@pytest.mark.parametrize("m,k,n", [(65 * 256, 512, 768), (65 * 256, 768, 512),
                                   (65 * 1024, 512, 768), (65 * 1024, 768, 512),
                                   (65 * 256, 8192, 512)]
                         + [(65 * b, k, n) for b in (1, 2, 7, 64, 256)
                            for k, n in ((512, 768), (768, 512))])
def test_the_flagships_bf16_shapes_take_the_wgmma_kernel(m, k, n):
    assert forward_kernel(torch.bfloat16, k, n) == WGMMA


@pytest.mark.parametrize("dtype,k,n,aligned", [
    (torch.float32, 512, 768, True),   # float32 stays exact float32 on the FP32 pipes
    (torch.bfloat16, 512, 100, True),  # the head: W's 200-byte rows break TMA's 16-byte strides
    (torch.bfloat16, 36, 768, True),   # K not a multiple of 8
    (torch.bfloat16, 512, 772, True),  # N not a multiple of 8
    (torch.bfloat16, 512, 1024, True),  # N > 768: 64 x N float32 sums outgrow the registers
    (torch.bfloat16, 512, 768, False),  # x or W not 16-byte aligned
])
def test_what_tma_or_the_registers_cannot_take_stays_on_the_wmma_fma_kernel(monkeypatch, dtype,
                                                                            k, n, aligned):
    """What the wgmma kernel cannot take, the float32/WMMA kernel took; the
    cluster kernel has replaced it at each of these shapes but N = 1,024 in
    bf16 that TMA can describe, which the wide cluster kernel takes (a
    cluster of four blocks of 256 columns)."""
    tma = dtype == torch.bfloat16 and aligned and k % 8 == 0 and n % 8 == 0
    # the card's reach of the wide cluster kernel, as the H100 gives it
    monkeypatch.setattr(fused_linear, "wide_cluster_reach", lambda device: 4096)
    assert forward_kernel(dtype, k, n, aligned, device=0) == (
        "fused_spectre_linear_wide_cluster" if tma and n > 768 else CLUSTER)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_no_kernel_takes_n_above_1024(monkeypatch, dtype):
    """No kernel whose block holds a whole output row takes N > 1,024: bf16
    that TMA can describe goes to the wide cluster kernel, float32 to the
    cluster kernel, whose blocks split the row between them."""
    monkeypatch.setattr(fused_linear, "wide_cluster_reach", lambda device: 4096)  # the H100's
    want = "fused_spectre_linear_wide_cluster" if dtype == torch.bfloat16 else CLUSTER
    assert forward_kernel(dtype, 512, 1032, device=0) == want
    assert forward_kernel(dtype, 512, 1032, device=0) != WGMMA


def test_the_cpu_takes_the_plain_version_at_any_n():
    """N > 1024 raises only where a kernel would run: the CPU path is plain."""
    rng = np.random.default_rng(0)
    x, w = torch.randn(3, 16), torch.from_numpy(rng.standard_normal((16, 1032)).astype(np.float32))
    b, g, be = torch.zeros(1032), torch.ones(1032), torch.zeros(1032)
    before = launch_counts()
    assert torch.equal(fused_spectre_linear(x, w, b, g, be), fused_spectre_linear_plain(x, w, b, g, be))
    assert launch_counts() == before


@pytest.mark.parametrize("dtype,blk,want", [
    (torch.bfloat16, 64, "fused_block_bwd_wgmma"),   # the flagship's tables
    (torch.bfloat16, 128, "fused_block_bwd_wgmma"),
    (torch.bfloat16, 32, "fused_block_bwd_grouped"),  # a 64-row tile would straddle tokens
    (torch.bfloat16, 16, "fused_block_bwd_grouped"),
    (torch.float32, 64, "fused_block_bwd_grouped"),   # float32 on the FP32 pipes
])
def test_kernel_5_dispatch(dtype, blk, want):
    assert block_bwd_kernel(dtype, blk) == want


def _case(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.uniform(-k ** -0.5, k ** -0.5, (k, n)).astype(np.float32)
    b = (rng.standard_normal(n) * 0.1).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, n).astype(np.float32)
    beta = (rng.standard_normal(n) * 0.1).astype(np.float32)
    return x, w, b, gamma, beta


# rows 65 x 3 (a ragged last tile of 64 rows) at the wgmma kernel's shape
# class (K and N multiples of 8, N not a multiple of its 256-wide warpgroup
# tile), K != N (the pool residual) and K == N (the identity residual).
# float32: 1e-5 covers the Pallas kernel's A&S erf (within 1.5e-7) and the
# order of the sums.
@pytest.mark.parametrize("m,k,n", [(195, 128, 192), (195, 192, 192), (65, 64, 136)])
def test_plain_forward_matches_the_pallas_kernel_at_ragged_rows(m, k, n):
    arrays = _case(m, k, n, seed=m + k + n)
    want_out, want_h = (np.asarray(t) for t in jax_forward(*map(jnp.asarray, arrays), 1e-5, True))
    out, h = fused_spectre_linear_plain(*map(torch.from_numpy, arrays), save_h=True)
    np.testing.assert_allclose(h.numpy(), want_h, rtol=1e-5, atol=1e-5)
    got = spectre_linear_apply(*map(torch.from_numpy, arrays)).numpy()
    np.testing.assert_allclose(got, want_out, rtol=1e-5, atol=1e-5)
    if k == n:  # the identity residual is inside the kernel's function itself
        np.testing.assert_allclose(out.numpy(), want_out, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got, np.asarray(jax_fused_spectre_linear(*map(jnp.asarray, arrays), interpret=True)),
        rtol=1e-5, atol=1e-5)


SMS = 132  # the H100's SMs
# (rows, K, N): the head at every batch a server or trainer gives it, the
# MNIST head (K 16, N 10) at its train and validation batches, `perf
# linear`'s 8-row square dims, and the C6 shapes
PLAN_SHAPES = ([(m, 512, 100) for m in (1, 2, 7, 33, 64, 65, 130, 256, 1024)]
               + [(64, 16, 10), (512, 16, 10)]
               + [(8, d, d) for d in (256, 512, 1024, 2048, 4096)]
               + [(4160, 1536, 1536), (4160, 768, 1100), (4160, 768, 2048)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
def test_cluster_plan_covers_the_shape_and_fills_the_card(dtype, m, k, n):
    """Every block of a cluster owns ceil(N / cn) columns rounded up to the
    MMA width and a K share of whole stages, each with at least one column
    and one stage inside the matrix; a cluster has at most 16 blocks and a
    block fits its shared memory; at least 132 blocks wherever the rows, N
    and K allow that many (16-row tiles, 16 blocks a cluster, 8 columns and
    32 of K a block at the least); below that the plan may take fewer,
    larger blocks (``cluster_plan``'s cost)."""
    p = cluster_plan(dtype, m, k, n, SMS)
    assert p.bm in ((16, 32) if dtype == torch.float32 else (16, 64)) and 1 <= p.cluster <= 16
    assert p.bn % 8 == 0 and p.bn == -(-(-(-n // p.cn)) // 8) * 8
    assert p.cn * p.bn >= n > (p.cn - 1) * p.bn
    assert p.kc % 32 == 0 and p.ck * p.kc >= k > (p.ck - 1) * p.kc
    assert p.blocks == -(-m // p.bm) * p.cluster
    assert p.smem <= 232448
    possible = -(-m // 16) * min(16, -(-n // 8) * -(-k // 32))
    if possible >= SMS:
        assert p.blocks >= SMS


def test_cluster_plan_refuses_what_no_plan_launches():
    with pytest.raises(ValueError):
        cluster_plan(torch.float32, 0, 512, 100, SMS)
    with pytest.raises(ValueError):  # 16 blocks' shared memory cannot hold a row
        cluster_plan(torch.float32, 8, 64, 60000, SMS)
    with pytest.raises(TypeError):
        cluster_plan(torch.float16, 8, 64, 64, SMS)


def _cluster_stats(h, bn, cn):
    """The cluster kernel's LayerNorm statistics in plain torch, float32:
    each column block's (mean, M2) of its columns by two passes, the second
    also summing the deviations from the first mean to correct it, then the
    cn partials combined in rank order by Chan's formula; the divisor is N."""
    n = h.shape[-1]
    parts = []
    for j in range(cn):
        v = h[:, j * bn:(j + 1) * bn]
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
    return mean, m2 / n


# the head, the 8-row dims, C6's N = 1,536 and 1,100 (a ragged last column
# block); rows of mean 0 and of a mean 30 times their spread, where a
# one-pass sum of squares would lose the variance in float32
@pytest.mark.parametrize("offset", [0.0, 30.0])
@pytest.mark.parametrize("dtype,m,k,n", [(torch.bfloat16, 256, 512, 100),
                                         (torch.float32, 8, 4096, 4096),
                                         (torch.float32, 4160, 1536, 1536),
                                         (torch.bfloat16, 4160, 768, 1100)])
def test_rank_ordered_chan_combine_matches_two_pass_statistics(dtype, m, k, n, offset):
    """In float32, within 1e-6 of the two-pass mean and variance of the whole
    row (the mean relative to |mean| + std), at the plan's column blocks."""
    p = cluster_plan(dtype, m, k, n, SMS)
    rng = np.random.default_rng(n)
    h = torch.from_numpy((rng.standard_normal((64, n)) + offset).astype(np.float32))
    mean, var = _cluster_stats(h, p.bn, p.cn)
    want_var, want_mean = torch.var_mean(h, dim=-1, correction=0)
    assert p.cn > 1
    scale = want_mean.abs() + want_var.sqrt()
    assert ((mean - want_mean).abs() / scale).max().item() <= 1e-6
    assert ((var - want_var).abs() / want_var).max().item() <= 1e-6


# the head's N = 100 (W's 200-byte rows) with ragged rows, and the MNIST
# head, K 16 and N 10; float32 within 1e-5 (the Pallas kernel's A&S erf and
# the order of the sums), the JAX package's own forward tolerance
@pytest.mark.parametrize("m,k,n", [(33, 512, 100), (7, 512, 100), (65, 16, 10)])
def test_plain_forward_matches_the_pallas_kernel_at_the_cluster_kernels_heads(m, k, n):
    arrays = _case(m, k, n, seed=m + k + n)
    assert forward_kernel(torch.bfloat16, k, n) == CLUSTER
    want_out, want_h = (np.asarray(t) for t in jax_forward(*map(jnp.asarray, arrays), 1e-5, True))
    out, h = fused_spectre_linear_plain(*map(torch.from_numpy, arrays), save_h=True)
    np.testing.assert_allclose(h.numpy(), want_h, rtol=1e-5, atol=1e-5)
    got = spectre_linear_apply(*map(torch.from_numpy, arrays)).numpy()
    np.testing.assert_allclose(got, want_out, rtol=1e-5, atol=1e-5)
