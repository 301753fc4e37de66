"""The port's four kernels (spectre_tpu_torch/ops/kernels) against the JAX
package's Pallas kernels they replace, on the CPU.

On a CPU tensor each wrapper runs its plain PyTorch version; the Pallas
kernels run in interpret mode, as tests/test_block_mix.py and
tests/test_pallas.py run them. The CUDA kernels themselves are tested on
the card by tests/test_torch_port_cuda.py and ``python3 chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectre_tpu.ops.pallas import fused_spectre_linear as jax_fused_spectre_linear
from spectre_tpu.ops.pallas.bwd_gather import (
    block_gather_sum_pallas,
    block_gather_sum_reference,
    block_scatter_rows_pallas,
    inverse_gather_sum_pallas,
    inverse_gather_sum_reference,
)
from spectre_tpu_torch.ops import perm_rows_t_plain, spectre_linear_apply
from spectre_tpu_torch.ops.kernels import (
    block_gather_sum,
    block_gather_sum_plain,
    block_scatter_rows,
    block_scatter_rows_plain,
    fused_spectre_linear,
    fused_spectre_linear_plain,
    inverse_gather_sum,
    inverse_gather_sum_plain,
    launch_counts,
)


def _block_case(h, nb, blk, b, seed=0):
    rng = np.random.default_rng(seed)
    xt = rng.standard_normal((nb * blk, b)).astype(np.float32)
    bsrc = np.stack([rng.permutation(nb) for _ in range(h)]).astype(np.int32)
    return xt, bsrc


# the cases of tests/test_block_mix.py::test_block_scatter_pallas_matches_take
@pytest.mark.parametrize("h,nb,blk,b", [(4, 16, 8, 128), (3, 8, 16, 128), (2, 4, 64, 256)])
def test_block_scatter_matches_pallas_bitwise(h, nb, blk, b):
    xt, bsrc = _block_case(h, nb, blk, b)
    want = np.asarray(block_scatter_rows_pallas(jnp.asarray(xt), jnp.asarray(bsrc), blk,
                                                interpret=True))
    got = block_scatter_rows(torch.from_numpy(xt), torch.from_numpy(bsrc), blk).numpy()
    assert got.shape == (h * nb * blk, b)
    assert (got == want).all()


@pytest.mark.parametrize("b", [1, 3, 5])
@pytest.mark.parametrize("blk", [1, 8])
def test_block_scatter_is_the_row_gather_at_any_batch(b, blk):
    """Any batch goes through the block copy (no TPU lane gate), and the
    block form equals the plain row gather of the full permutation."""
    h, nb = 3, 12
    xt, bsrc = _block_case(h, nb, blk, b, seed=b)
    perms = (bsrc[:, :, None] * blk + np.arange(blk)).reshape(h, nb * blk)
    got = block_scatter_rows(torch.from_numpy(xt), torch.from_numpy(bsrc), blk)
    want = perm_rows_t_plain(torch.from_numpy(xt), torch.from_numpy(perms))
    assert torch.equal(got, want)


def _gather_case(h, nb, blk, b, seed=0):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((h * nb * blk, b)).astype(np.float32)
    binv = np.stack([rng.permutation(nb) for _ in range(h)]).astype(np.int32)
    return g, binv


# the cases of tests/test_block_mix.py::test_block_gather_pallas_matches_reference.
# 1e-6: the three sum the same float32 values over heads, in orders that
# may differ
@pytest.mark.parametrize("h,nb,blk,b", [(4, 16, 8, 128), (3, 8, 16, 128), (2, 4, 64, 256)])
def test_block_gather_sum_matches_pallas_and_reference(h, nb, blk, b):
    g, binv = _gather_case(h, nb, blk, b)
    got = block_gather_sum(torch.from_numpy(g), torch.from_numpy(binv), blk).numpy()
    assert got.shape == (nb * blk, b)
    pallas = block_gather_sum_pallas(jnp.asarray(g), jnp.asarray(binv), blk, interpret=True)
    ref = block_gather_sum_reference(jnp.asarray(g), jnp.asarray(binv), blk)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-6)


@pytest.mark.parametrize("h,nb,blk,b", [(4, 16, 8, 128), (3, 12, 1, 5), (2, 4, 64, 3)])
def test_block_gather_sum_is_the_vjp_of_block_scatter(h, nb, blk, b):
    """<scatter(x), g> = <x, gather_sum(g)> with binv = argsort(bsrc)."""
    xt, bsrc = _block_case(h, nb, blk, b, seed=1)
    g, _ = _gather_case(h, nb, blk, b, seed=2)
    binv = np.argsort(bsrc, axis=1).astype(np.int32)
    y = block_scatter_rows_plain(torch.from_numpy(xt), torch.from_numpy(bsrc), blk)
    dx = block_gather_sum_plain(torch.from_numpy(g), torch.from_numpy(binv), blk)
    lhs, rhs = (y.double() * torch.from_numpy(g)).sum(), (torch.from_numpy(xt).double() * dx).sum()
    assert abs(float(lhs - rhs)) <= 1e-5 * max(1.0, abs(float(lhs)))


@pytest.mark.parametrize("h,d,b", [(4, 64, 128), (3, 40, 256), (2, 24, 5)])
def test_inverse_gather_sum_matches_pallas_reference_and_the_block_form(h, d, b):
    g, inv = _gather_case(h, d, 1, b, seed=d)
    tg, tinv = torch.from_numpy(g), torch.from_numpy(inv)
    got = inverse_gather_sum(tg, tinv)
    assert got.shape == (d, b)
    ref = inverse_gather_sum_reference(jnp.asarray(g), jnp.asarray(inv))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    if b % 128 == 0:  # the Pallas kernel's own lane-aligned shapes
        pallas = inverse_gather_sum_pallas(jnp.asarray(g), jnp.asarray(inv), interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=0, atol=1e-6)
    assert torch.equal(got, block_gather_sum(tg, tinv, 1))


def _linear_case(m, k, n, lead=(), seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*lead, m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(n) * 0.1).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, n).astype(np.float32)
    beta = (rng.standard_normal(n) * 0.1).astype(np.float32)
    return x, w, b, gamma, beta


# the cases of tests/test_pallas.py (K == N, K != N both ways) plus a 3-D
# batch. 1e-5: the Pallas kernel's A&S erf is within 1.5e-7, plus ordering.
@pytest.mark.parametrize("m,k,n,lead", [(16, 32, 32, ()), (10, 48, 24, ()),
                                        (64, 16, 40, ()), (5, 16, 16, (2,)),
                                        (5, 24, 12, (3,))])
def test_fused_spectre_linear_matches_pallas(m, k, n, lead):
    arrays = _linear_case(m, k, n, lead)
    want = np.asarray(jax_fused_spectre_linear(*map(jnp.asarray, arrays), interpret=True))
    got = spectre_linear_apply(*map(torch.from_numpy, arrays)).numpy()
    assert got.shape == (*lead, m, n)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_cpu_tensors_take_the_plain_versions_without_launching():
    before = launch_counts()
    xt, bsrc = _block_case(2, 4, 8, 3)
    x, w, b, g, be = map(torch.from_numpy, _linear_case(6, 8, 8))
    assert torch.equal(block_scatter_rows(torch.from_numpy(xt), torch.from_numpy(bsrc), 8),
                       block_scatter_rows_plain(torch.from_numpy(xt), torch.from_numpy(bsrc), 8))
    assert torch.equal(fused_spectre_linear(x, w, b, g, be),
                       fused_spectre_linear_plain(x, w, b, g, be))
    out, h = fused_spectre_linear(x, w, b, g, be, save_h=True)
    assert torch.equal(h, x @ w + b) and torch.equal(out, fused_spectre_linear(x, w, b, g, be))
    gs, binv = map(torch.from_numpy, _gather_case(2, 4, 8, 3))
    assert torch.equal(block_gather_sum(gs, binv, 8), block_gather_sum_plain(gs, binv, 8))
    gs, inv = map(torch.from_numpy, _gather_case(2, 12, 1, 3))
    assert torch.equal(inverse_gather_sum(gs, inv), inverse_gather_sum_plain(gs, inv))
    assert launch_counts() == before
    assert list(before) == ["block_scatter_rows", "block_gather_sum", "inverse_gather_sum",
                            "fused_spectre_linear"]


def test_wrappers_raise_instead_of_falling_back():
    """A tensor on a device with no kernel raises (no silent plain path);
    dtype, shape and contiguity are checked before any launch."""
    xt = torch.zeros(16, 4, device="meta")
    bsrc = torch.zeros(2, 2, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        block_scatter_rows(xt, bsrc, 8)
    x, w, b, g, be = (torch.zeros(s, device="meta") for s in ((4, 8), (8, 8), 8, 8, 8))
    with pytest.raises(RuntimeError, match="no kernel"):
        fused_spectre_linear(x, w, b, g, be)
    cpu = torch.zeros(16, 4)
    with pytest.raises(TypeError):
        block_scatter_rows(cpu.half(), torch.zeros(2, 2, dtype=torch.int32), 8)
    with pytest.raises(TypeError):
        block_scatter_rows(cpu, torch.zeros(2, 2, dtype=torch.int64), 8)
    with pytest.raises(ValueError):
        block_scatter_rows(cpu, torch.zeros(2, 3, dtype=torch.int32), 8)
    with pytest.raises(ValueError):
        block_scatter_rows(torch.zeros(4, 16).t(), torch.zeros(2, 2, dtype=torch.int32), 8)
    g = torch.zeros(2 * 16, 4)
    i32 = dict(dtype=torch.int32)
    for fn, table, extra in ((block_gather_sum, torch.zeros(2, 2, **i32), (8,)),
                             (inverse_gather_sum, torch.zeros(2, 16, **i32), ())):
        with pytest.raises(RuntimeError, match="no kernel"):
            fn(g.to("meta"), table.to("meta"), *extra)
        with pytest.raises(TypeError):
            fn(g.half(), table, *extra)
        with pytest.raises(TypeError):
            fn(g, table.long(), *extra)
        with pytest.raises(ValueError):
            fn(g[:-1], table, *extra)
        with pytest.raises(ValueError):
            fn(torch.zeros(4, 32).t(), table, *extra)
    xs, ws, bs, gs, bes = (torch.zeros(s) for s in ((4, 8), (8, 6), 6, 6, 6))
    with pytest.raises(TypeError):
        fused_spectre_linear(xs, ws.double(), bs, gs, bes)
    with pytest.raises(ValueError):
        fused_spectre_linear(xs, ws, torch.zeros(5), gs, bes)
    with pytest.raises(ValueError):
        fused_spectre_linear(torch.zeros(8, 4).t(), ws, bs, gs, bes)
