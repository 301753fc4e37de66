"""Kernel 2's forward and kernel 5 on the CPU: which CUDA kernel a call on
the card takes, and the plain version of the forward against the JAX
package's Pallas kernel (interpret mode) at the bf16 wgmma kernel's shape
class with ragged rows.

The dispatch functions are pure: they see the dtype, the shapes and the
alignment, as the wrappers do before a launch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectre_tpu.ops.pallas import fused_spectre_linear as jax_fused_spectre_linear
from spectre_tpu.ops.pallas.fused_linear import _forward as jax_forward
from spectre_tpu_torch.ops import spectre_linear_apply
from spectre_tpu_torch.ops.kernels import (
    block_bwd_kernel,
    forward_kernel,
    fused_spectre_linear,
    fused_spectre_linear_plain,
    launch_counts,
)

WGMMA, WMMA_FMA = "fused_spectre_linear_wgmma", "fused_spectre_linear_wmma_fma"


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
def test_what_tma_or_the_registers_cannot_take_stays_on_the_wmma_fma_kernel(dtype, k, n,
                                                                            aligned):
    assert forward_kernel(dtype, k, n, aligned) == WMMA_FMA


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_no_kernel_takes_n_above_1024(dtype):
    """No one-pass kernel takes N > 1,024 (a block holds a whole output
    row): the two-pass wide kernels do, in both dtypes."""
    want = ("fused_spectre_linear_wide_wgmma" if dtype == torch.bfloat16
            else "fused_spectre_linear_wide_wmma_fma")
    assert forward_kernel(dtype, 512, 1032) == want
    assert forward_kernel(dtype, 512, 1032) not in (WGMMA, WMMA_FMA)


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
    (torch.bfloat16, 32, "fused_block_bwd_wmma_fma"),  # a 64-row tile would straddle tokens
    (torch.bfloat16, 16, "fused_block_bwd_wmma_fma"),
    (torch.float32, 64, "fused_block_bwd_wmma_fma"),   # float32 on the FP32 pipes
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
