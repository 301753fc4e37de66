"""The port's five kernels (spectre_tpu_torch/ops/kernels) against the JAX
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
    fused_block_bwd_pallas,
    fused_block_bwd_reference,
    inverse_gather_sum_pallas,
    inverse_gather_sum_reference,
)
from spectre_tpu_torch.ops import perm_rows_t_plain, spectre_linear_apply
from spectre_tpu_torch.ops.fused_mix import folded_proj
from spectre_tpu_torch.ops.kernels import (
    block_gather_sum,
    block_gather_sum_plain,
    block_scatter_rows,
    block_scatter_rows_plain,
    fused_block_bwd,
    fused_block_bwd_plain,
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


def _fused_bwd_case(h, blk, e, n, b, o, seed=3):
    """dy [N, B, O], w [E*H, O], s4 [N, E*H] of +-1, binv [H, N*E/blk]."""
    rng = np.random.default_rng(seed)
    binv = np.stack([rng.permutation(n * e // blk) for _ in range(h)]).astype(np.int32)
    dy = rng.standard_normal((n, b, o)).astype(np.float32)
    w = rng.standard_normal((e * h, o)).astype(np.float32)
    s4 = rng.choice([-1.0, 1.0], (n, e * h)).astype(np.float32)
    return dy, w, s4, binv


# the shapes of tests/test_block_mix.py::test_fused_block_bwd_kernel_matches_chain_oracle
# and its tolerance: the three add the same float32 products in other orders.
# b=5 goes to the oracle alone, as does a blk the kernel would take (16)
@pytest.mark.parametrize("blk,b,pallas", [(8, 24, True), (8, 5, False), (16, 24, True)])
def test_fused_block_bwd_plain_matches_pallas_and_reference(blk, b, pallas):
    arrays = _fused_bwd_case(4, blk, 32, 5, b, 16)
    got = fused_block_bwd_plain(*map(torch.from_numpy, arrays), blk).numpy()
    assert got.shape == (5 * 32, b)
    want = fused_block_bwd_reference(*map(jnp.asarray, arrays), blk)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-4)
    if pallas:
        kern = fused_block_bwd_pallas(*map(jnp.asarray, arrays), blk, interpret=True)
        np.testing.assert_allclose(got, np.asarray(kern), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("b", [5, 24, 250])
def test_fused_block_bwd_is_the_ports_own_backward_chain(b):
    """block_gather_sum of the dg4 that folded_proj's backward makes (by
    autograd, through _FoldedProj and the wrapper on CPU tensors), at batches
    that a halving chunk search would not divide."""
    h, blk, e, n, o = 4, 16, 32, 5, 16
    dy, w, s4, binv = map(torch.from_numpy, _fused_bwd_case(h, blk, e, n, b, o, seed=b))
    g4 = torch.zeros(n, e * h, b, requires_grad=True)
    folded_proj(g4, w, s4).backward(dy)
    chain = block_gather_sum_plain(g4.grad.reshape(h * n * e, b), binv, blk)
    got = fused_block_bwd(dy, w, s4, binv, blk)
    assert torch.equal(got, fused_block_bwd_plain(dy, w, s4, binv, blk))
    np.testing.assert_allclose(got.numpy(), chain.numpy(), rtol=1e-5, atol=1e-4)


def test_fused_block_bwd_wrapper_raises_on_what_the_kernel_does_not_take():
    dy, w, s4, binv = map(torch.from_numpy, _fused_bwd_case(4, 16, 32, 5, 6, 16))
    with pytest.raises(ValueError, match="uniform"):
        fused_block_bwd(dy, w, s4, torch.zeros(4, 160, dtype=torch.int32), 1)
    with pytest.raises(ValueError, match="multiple of 16"):
        fused_block_bwd(dy, w, s4, torch.zeros(4, 20, dtype=torch.int32), 8)
    with pytest.raises(ValueError, match="straddle"):
        fused_block_bwd(dy, w[:120], s4[:, :120], binv, 16)
    with pytest.raises(ValueError, match="multiple of 8"):
        fused_block_bwd(dy[:, :, :12].contiguous(), w[:, :12].contiguous(), s4, binv, 16)
    with pytest.raises(ValueError, match="shapes disagree"):
        fused_block_bwd(dy, w, s4, binv[:, :-1].contiguous(), 16)
    with pytest.raises(ValueError, match="contiguous"):
        fused_block_bwd(dy.transpose(0, 1).contiguous().transpose(0, 1), w, s4, binv, 16)
    with pytest.raises(TypeError):
        fused_block_bwd(dy.half(), w.half(), s4.half(), binv, 16)
    with pytest.raises(TypeError):
        fused_block_bwd(dy, w, s4.double(), binv, 16)
    with pytest.raises(TypeError):
        fused_block_bwd(dy, w, s4, binv.long(), 16)
    with pytest.raises(RuntimeError, match="no kernel"):
        fused_block_bwd(*(t.to("meta") for t in (dy, w, s4, binv)), 16)


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
    args = [torch.from_numpy(a) for a in _fused_bwd_case(2, 16, 16, 3, 4, 8)]
    assert torch.equal(fused_block_bwd(*args, 16), fused_block_bwd_plain(*args, 16))
    from spectre_tpu_torch.ops import kernels as K
    q = torch.randn(2, 2, 5, 4)
    o, lse = K.flash_attention_fwd(q, q, q)
    assert torch.equal(o, K.flash_attention_fwd_plain(q, q, q)[0])
    for got, want in zip(K.flash_attention_bwd(q, q, q, o, lse, q),
                         K.flash_attention_bwd_plain(q, q, q, o, lse, q)):
        assert torch.equal(got, want)
    assert torch.equal(K.fwht(x), K.fwht_plain(x))
    tile_perms = torch.tensor([[1, 0, 2], [2, 1, 0]], dtype=torch.int32)
    signs = torch.ones(1, 2, 24)
    xs, gm = torch.randn(3, 24), torch.randn(3, 48)
    assert torch.equal(K.structured_mix(xs, tile_perms, signs, 1),
                       K.structured_mix_plain(xs, tile_perms, signs, 1))
    assert torch.equal(K.structured_mix_bwd(gm, tile_perms, signs),
                       K.structured_mix_bwd_plain(gm, tile_perms, signs))
    assert launch_counts() == before
    assert list(before) == ["block_scatter_rows", "block_gather_sum", "inverse_gather_sum",
                            "fused_spectre_linear", "fused_block_bwd", "flash_attention_fwd",
                            "flash_attention_bwd", "fwht", "structured_mix",
                            "structured_mix_bwd"]


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
    from spectre_tpu_torch.ops import kernels as K
    qm = torch.zeros(2, 2, 5, 4, device="meta")
    tables = (torch.zeros(2, 3, dtype=torch.int32, device="meta"),
              torch.ones(1, 2, 24, device="meta"))
    for call in (lambda: K.flash_attention_fwd(qm, qm, qm),
                 lambda: K.flash_attention_bwd(qm, qm, qm, qm,
                                               torch.zeros(2, 2, 5, 1, device="meta"), qm),
                 lambda: K.fwht(torch.zeros(4, 8, device="meta")),
                 lambda: K.structured_mix(torch.zeros(3, 24, device="meta"), *tables, 1),
                 lambda: K.structured_mix_bwd(torch.zeros(3, 48, device="meta"), *tables)):
        with pytest.raises(RuntimeError, match="no kernel"):
            call()
    xs, ws, bs, gs, bes = (torch.zeros(s) for s in ((4, 8), (8, 6), 6, 6, 6))
    with pytest.raises(TypeError):
        fused_spectre_linear(xs, ws.double(), bs, gs, bes)
    with pytest.raises(ValueError):
        fused_spectre_linear(xs, ws, torch.zeros(5), gs, bes)
    with pytest.raises(ValueError):
        fused_spectre_linear(torch.zeros(8, 4).t(), ws, bs, gs, bes)
