"""The port's Walsh-Hadamard transforms and tile-structured mix
(spectre_tpu_torch/ops/{hadamard,permute}.py, ops/kernels/{fwht,structured_mix}.py)
against the JAX package: its jnp functions and its Pallas kernels in interpret
mode, on the CPU in float32, with inputs made from numpy seeds and fed to
both. On a CPU tensor the wrappers run their plain PyTorch versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectre_tpu.ops import hadamard as jax_hadamard
from spectre_tpu.ops import permute as jax_permute
from spectre_tpu.ops.fused_mix import permut_mix_fused as jax_permut_mix_fused
from spectre_tpu.ops.pallas import fwht_pallas, structured_mix_pallas
from spectre_tpu_torch.ops import (
    fwht,
    fwht_interleaved,
    hadamard_matrix,
    hadamard_transform,
    invert_permutation,
    learnable_hadamard,
    make_structured_tables,
    next_pow2,
    permut_mix,
    permut_mix_fused,
    pick_tile,
    structured_mix,
)
from spectre_tpu_torch.ops.kernels import (
    fwht_plain,
    invert_tile_perms,
    structured_mix_bwd,
    structured_mix_bwd_plain,
    structured_mix_grad,
    structured_mix_plain,
)
from spectre_tpu_torch.ops.kernels import fwht as fwht_last_axis
from spectre_tpu_torch.ops.kernels import structured_mix as structured_mix_kernel


def _jit(fn, *static, **static_kw):
    """``fn`` of the JAX package compiled once with its non-array arguments
    bound: one program, not one per primitive."""
    return jax.jit(lambda *arrays: fn(*arrays, *static, **static_kw))


def _close(got, want, tol, what=""):
    """Within ``tol`` of the largest entry of the reference (at least 1)."""
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    assert got.shape == want.shape, what
    assert float(np.abs(np.asarray(got) - want).max()) <= tol * scale, what


# ---- the Walsh-Hadamard transform ---------------------------------------------------


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("n", [8, 64, 128, 256, 1024])
def test_fwht_is_bitwise_the_jnp_butterfly_and_matches_the_pallas_kernel(n, normalize):
    """The plain version and the port's ``fwht`` add the same float32 pairs
    in the same order as ``spectre_tpu.ops.hadamard.fwht``: bitwise equal.
    The Pallas kernel takes one product with H_128 instead, so it sums in
    another order: 1e-6 of the largest entry."""
    x = np.random.default_rng(n).standard_normal((6, n)).astype(np.float32)
    want = np.asarray(_jit(jax_hadamard.fwht, normalize=normalize)(jnp.asarray(x)))
    pallas = np.asarray(_jit(fwht_pallas, normalize, True)(jnp.asarray(x)))
    for fn in (fwht_plain, fwht_last_axis,
               lambda t, nrm: fwht(t, axis=-1, normalize=nrm)):
        got = fn(torch.from_numpy(x), normalize).numpy()
        np.testing.assert_array_equal(got, want)
        _close(got, pallas, 1e-6)


def test_fwht_along_any_axis_and_the_small_sizes():
    x = np.random.default_rng(0).standard_normal((8, 3, 16)).astype(np.float32)
    for axis in (0, 2, -1, -3):
        got = fwht(torch.from_numpy(x), axis=axis).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(_jit(jax_hadamard.fwht, axis)(jnp.asarray(x))))
    got = fwht(torch.from_numpy(x.transpose(1, 0, 2).copy()), axis=1, normalize=False).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(_jit(jax_hadamard.fwht, 1, False)(jnp.asarray(x.transpose(1, 0, 2)))))
    for n in (1, 2, 4):
        y = np.random.default_rng(n).standard_normal((5, n)).astype(np.float32)
        np.testing.assert_array_equal(fwht_plain(torch.from_numpy(y)).numpy(),
                                      np.asarray(_jit(jax_hadamard.fwht)(jnp.asarray(y))))
    # H_n is orthonormal when normalised: the transform is its own inverse
    t = torch.from_numpy(x)
    torch.testing.assert_close(fwht(fwht(t)), t, rtol=1e-5, atol=1e-5)
    b = torch.from_numpy(x).to(torch.bfloat16)
    assert fwht_plain(b).dtype == torch.bfloat16
    torch.testing.assert_close(fwht_plain(b).float(), fwht_plain(b.float()), rtol=0, atol=2e-2)
    for bad in (3, 12, 0):
        with pytest.raises(ValueError, match="power of 2"):
            fwht(torch.zeros(2, bad))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fwht_last_axis(torch.zeros(2, 8, dtype=torch.float64))
    assert [next_pow2(n) for n in (1, 2, 3, 33_280, 65)] == \
        [jax_hadamard.next_pow2(n) for n in (1, 2, 3, 33_280, 65)] == [1, 2, 4, 65_536, 128]


@pytest.mark.parametrize("n", [8, 64])
def test_fwht_gradient_is_the_same_transform_of_the_cotangent(n):
    """d/dx sum(fwht(x)^3) through the Function (whose backward runs fwht on
    the cotangent) and through autograd of the plain version, against
    jax.grad through the Pallas kernel."""
    x = np.random.default_rng(n).standard_normal((2, n)).astype(np.float32)
    want = jax.jit(jax.grad(lambda a: jnp.sum(fwht_pallas(a, True, True) ** 3)))(jnp.asarray(x))
    for fn in (fwht, fwht_plain):
        t = torch.from_numpy(x).requires_grad_()
        (fn(t) ** 3).sum().backward()
        _close(t.grad.numpy(), want, 1e-4, fn.__name__)


@pytest.mark.parametrize("n", [8, 64, 256])
def test_interleaved_and_normalised_variants_match_jax(n):
    x = np.random.default_rng(n).standard_normal((3, 2, n)).astype(np.float32)
    np.testing.assert_array_equal(
        fwht_interleaved(torch.from_numpy(x)).numpy(),
        np.asarray(_jit(jax_hadamard.fwht_interleaved)(jnp.asarray(x))))
    for v in (x[0], x[0, 0]):
        np.testing.assert_array_equal(
            hadamard_transform(torch.from_numpy(v)).numpy(),
            np.asarray(_jit(jax_hadamard.hadamard_transform)(jnp.asarray(v))))
    with pytest.raises(ValueError, match="either 1 or 2"):
        hadamard_transform(torch.from_numpy(x))


@pytest.mark.parametrize("dim", [16, 24, 65])
def test_learnable_hadamard_matches_jax_value_and_gradients(dim):
    rng = np.random.default_rng(dim)
    x = rng.standard_normal((2, 5, dim)).astype(np.float32)
    scales = [rng.uniform(0.5, 1.5, next_pow2(dim)).astype(np.float32) * 0.1 for _ in range(2)]
    want = _jit(jax_hadamard.learnable_hadamard)(jnp.asarray(x), [jnp.asarray(s) for s in scales])
    tx = torch.from_numpy(x).requires_grad_()
    ts = [torch.from_numpy(s).requires_grad_() for s in scales]
    got = learnable_hadamard(tx, ts)
    _close(got.detach().numpy(), want, 1e-6)
    gx, gs = jax.jit(jax.grad(lambda a, s: jnp.sum(jax_hadamard.learnable_hadamard(a, s) ** 2),
                              argnums=(0, 1)))(jnp.asarray(x), [jnp.asarray(s) for s in scales])
    (got ** 2).sum().backward()
    _close(tx.grad.numpy(), gx, 1e-5)
    for t, g in zip(ts, gs):
        _close(t.grad.numpy(), g, 1e-5)


# ---- the permutation and structured mixes -----------------------------------------------


def test_table_helpers_match_jax():
    for d in (33_280, 320, 80, 120, 7, 256):
        assert pick_tile(d) == jax_permute.pick_tile(d)
    assert pick_tile(33_280) == 128 and pick_tile(80) == 16 and pick_tile(7) == 1
    for n in (1, 2, 8, 128):
        for normalize in (True, False):
            np.testing.assert_array_equal(
                hadamard_matrix(n, normalize=normalize).numpy(),
                np.asarray(jax_permute.hadamard_matrix(n, normalize=normalize)))
    tile_perms, signs = make_structured_tables(torch.Generator().manual_seed(0), 3, 320)
    assert tile_perms.dtype == torch.int32 and tuple(tile_perms.shape) == (3, 5)
    assert tuple(signs.shape) == (1, 3, 320) and set(signs.unique().tolist()) == {-1.0, 1.0}
    np.testing.assert_array_equal(np.sort(tile_perms.numpy(), axis=1),
                                  np.broadcast_to(np.arange(5), (3, 5)))
    assert tuple(make_structured_tables(torch.Generator().manual_seed(0), 2, 64, tile=8)[0]
                 .shape) == (2, 8)
    perm = np.stack([np.random.default_rng(i).permutation(12) for i in range(3)]).astype(np.int32)
    for p in (perm, perm[0]):
        np.testing.assert_array_equal(invert_permutation(torch.from_numpy(p)).numpy(),
                                      np.asarray(jax_permute.invert_permutation(jnp.asarray(p))))
    np.testing.assert_array_equal(invert_tile_perms(torch.from_numpy(perm)).numpy(),
                                  np.argsort(perm, axis=1))


def _structured_case(b, n, e, h, seed=0):
    d = n * e
    tile_perms, signs = jax_permute.make_structured_tables(jax.random.key(seed), h, d)
    x = np.random.default_rng(seed).standard_normal((b, n, e)).astype(np.float32)
    return x, np.array(tile_perms), np.array(signs)


# test_pallas.py's two shapes (t = 64 and 16), and one with t = 8 < 128 at a
# batch that is no multiple of 8
@pytest.mark.parametrize("b,n,e,h", [(4, 5, 64, 2), (2, 5, 16, 3), (3, 5, 24, 2)])
def test_structured_mix_matches_the_pallas_kernel_and_the_jnp_reference(b, n, e, h):
    x, tile_perms, signs = _structured_case(b, n, e, h)
    jx, jt, js = jnp.asarray(x), jnp.asarray(tile_perms), jnp.asarray(signs)
    want = np.asarray(_jit(structured_mix_pallas, n, True)(jx, jt, js))
    ref = np.asarray(_jit(jax_permute.structured_mix, n)(jx, jt, js))
    tx, tt, ts = torch.from_numpy(x), torch.from_numpy(tile_perms), torch.from_numpy(signs)
    outs = {"plain": structured_mix_plain(tx, tt, ts, n),
            "wrapper": structured_mix_kernel(tx, tt, ts, n),
            "function": structured_mix_grad(tx, tt, ts, n),
            "matrix form": structured_mix(tx, tt, ts, n)}
    for name, got in outs.items():
        assert got.shape == (b, n, e * h), name
        _close(got.numpy(), want, 1e-5, name)
        _close(got.numpy(), ref, 1e-5, name)
    assert torch.equal(outs["plain"], outs["wrapper"]) and torch.equal(outs["plain"],
                                                                       outs["function"])


@pytest.mark.parametrize("b,n,e,h", [(2, 4, 32, 2), (3, 5, 24, 2), (5, 2, 8, 3)])
def test_structured_mix_gradient_matches_jax(b, n, e, h):
    """The Function's backward (signs, head sum, one transform) and autograd
    of the matrix form, against jax.grad through the Pallas custom VJP and
    through the jnp reference."""
    x, tile_perms, signs = _structured_case(b, n, e, h, seed=1)
    jt, js = jnp.asarray(tile_perms), jnp.asarray(signs)
    want = jax.jit(jax.grad(lambda a: jnp.sum(structured_mix_pallas(a, jt, js, n, True) ** 2)))(
        jnp.asarray(x))
    ref = jax.jit(jax.grad(lambda a: jnp.sum(jax_permute.structured_mix(a, jt, js, n) ** 2)))(
        jnp.asarray(x))
    tt, ts = torch.from_numpy(tile_perms), torch.from_numpy(signs)
    for fn in (structured_mix_grad, structured_mix):
        tx = torch.from_numpy(x).requires_grad_()
        (fn(tx, tt, ts, n) ** 2).sum().backward()
        assert tx.grad.shape == x.shape
        _close(tx.grad.numpy(), want, 1e-4, fn.__name__)
        _close(tx.grad.numpy(), ref, 1e-4, fn.__name__)
    g = torch.from_numpy(np.random.default_rng(2).standard_normal((b, n, e * h))
                         .astype(np.float32))
    assert torch.equal(structured_mix_bwd(g, tt, ts), structured_mix_bwd_plain(g, tt, ts))
    # the backward is the transpose of the forward: <mix(x), g> == <x, mix^T(g)>
    tx = torch.from_numpy(x)
    lhs = (structured_mix_plain(tx, tt, ts, n) * g).sum()
    rhs = (tx.reshape(b, -1) * structured_mix_bwd_plain(g, tt, ts)).sum()
    torch.testing.assert_close(lhs, rhs, rtol=1e-4, atol=1e-4)


def test_structured_mix_refuses_bad_tables():
    x = torch.zeros(2, 24)
    tile_perms = torch.zeros(2, 3, dtype=torch.int32)
    signs = torch.ones(1, 2, 24)
    with pytest.raises(TypeError, match="int32"):
        structured_mix_kernel(x, tile_perms.long(), signs, 1)
    with pytest.raises(ValueError, match="do not fit"):
        structured_mix_kernel(x, tile_perms, torch.ones(1, 2, 25), 1)
    with pytest.raises(ValueError, match="power of two"):
        structured_mix_kernel(torch.zeros(2, 18), tile_perms, torch.ones(1, 2, 18), 1)
    with pytest.raises(ValueError, match="values per row"):
        structured_mix_kernel(torch.zeros(2, 48), tile_perms, signs, 1)
    with pytest.raises(ValueError, match="values per row"):
        structured_mix_bwd(torch.zeros(2, 24), tile_perms, signs)


@pytest.mark.parametrize("b,n,e,h", [(3, 5, 8, 2), (2, 4, 6, 3)])
def test_permut_mix_and_its_fused_backward_match_jax(b, n, e, h):
    d = n * e
    perms, signs = jax_permute.make_mix_tables(jax.random.key(0), h, d)
    perms, signs = np.array(perms), np.array(signs)
    rng = np.random.default_rng(b)
    x = rng.standard_normal((b, n, e)).astype(np.float32)
    ct = rng.standard_normal((b, h, d)).astype(np.float32)
    want = np.asarray(_jit(jax_permute.permut_mix, n)(jnp.asarray(x), jnp.asarray(perms),
                                                      jnp.asarray(signs)))
    tp, ts = torch.from_numpy(perms), torch.from_numpy(signs)
    np.testing.assert_array_equal(permut_mix(torch.from_numpy(x), tp, ts, n).numpy(), want)
    fused, vjp = jax.vjp(lambda a: jax_permut_mix_fused(a, jnp.asarray(perms),
                                                        jnp.asarray(signs[0])),
                         jnp.asarray(x.reshape(b, d)))
    tx = torch.from_numpy(x.reshape(b, d)).requires_grad_()
    got = permut_mix_fused(tx, tp, ts[0])
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(fused))
    got.backward(torch.from_numpy(ct))
    _close(tx.grad.numpy(), vjp(jnp.asarray(ct))[0], 1e-6)
    # the gather left to autograd (a scatter-add) gives the same gradient
    ux = torch.from_numpy(x).requires_grad_()
    permut_mix(ux, tp, ts, n).backward(torch.from_numpy(ct).reshape(b, n, -1))
    _close(ux.grad.reshape(b, d).numpy(), tx.grad.numpy(), 1e-6)
