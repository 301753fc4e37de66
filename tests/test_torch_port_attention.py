"""The port's attention (spectre_tpu_torch/ops/kernels/attention.py) against
the JAX package's Pallas kernels in interpret mode and its einsum reference,
on the CPU in float32 and bfloat16, with inputs made from numpy seeds and fed
to both.

On a CPU tensor the wrappers run their plain PyTorch versions, the analytic
backward included, so these tests hold the arithmetic the CUDA kernels state;
tests/test_torch_port_cuda.py holds the kernels to the plain versions on the
card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectre_tpu.ops.pallas import flash_attention as jax_flash_attention
from spectre_tpu.ops.pallas.attention import _forward as jax_forward
from spectre_tpu.ops.pallas.attention import _reference as jax_reference
from spectre_tpu_torch.ops.kernels import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_fwd,
    flash_attention_fwd_plain,
    flash_attention_plain,
)
from spectre_tpu_torch.ops.kernels.attention import (
    backward_shared_bytes,
    rows_aligned,
    score_columns,
)

# vit_cifar100's geometry at a small batch, vit_mnist's, and a ragged tiny one
SHAPES = [(2, 4, 65, 32), (3, 2, 50, 16), (1, 1, 7, 8)]


def _qkvw(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _close(got, want, tol, what=""):
    """Within ``tol`` of the largest entry of the reference (at least 1)."""
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    assert got.shape == want.shape, what
    assert float(np.abs(np.asarray(got) - want).max()) <= tol * scale, what


@pytest.mark.parametrize("shape", SHAPES)
def test_flash_attention_output_and_lse_match_pallas_and_reference(shape):
    q, k, v, _ = _qkvw(shape, seed=shape[2])
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want, want_lse = jax_forward(jq, jk, jv, True)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for fn in (flash_attention_plain, flash_attention):
        got = fn(tq, tk, tv).numpy()
        _close(got, want, 1e-5, fn.__name__)
        _close(got, jax_reference(jq, jk, jv), 1e-5, fn.__name__)
    o, lse = flash_attention_fwd(tq, tk, tv)
    assert lse.shape == (*shape[:3], 1) and lse.dtype == torch.float32
    _close(lse.numpy(), want_lse, 1e-5, "lse")
    # what is saved reproduces the softmax rows: exp(s - lse) sums to one
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(shape[3])
    np.testing.assert_allclose(np.exp(s - lse.numpy()).sum(-1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_flash_attention_gradients_match_jax_grad_through_the_pallas_kernel(shape):
    """dQ, dK, dV for a cotangent that is not symmetric in q and k: the
    Function's analytic backward (from the saved O and LSE) and autograd of
    the plain version, both against jax.grad through the Pallas backward."""
    q, k, v, w = _qkvw(shape, seed=1 + shape[2])
    want = jax.grad(lambda a, b, c: jnp.sum(jnp.asarray(w) * jax_flash_attention(a, b, c, True)),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for fn in (flash_attention, flash_attention_plain):
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        (fn(*ts) * torch.from_numpy(w)).sum().backward()
        for name, t, wg in zip("qkv", ts, want):
            _close(t.grad.numpy(), wg, 1e-4, f"{fn.__name__} d{name}")


@pytest.mark.parametrize("shape", SHAPES)
def test_flash_attention_with_a_probability_multiplier_matches_the_jnp_formula(shape):
    """pm (a dropout keep-mask over its keep-probability, one [N, N] for all
    batches and heads) has no injection point in the Pallas kernel: the
    reference is (softmax(s) * pm) @ v written in jnp, and its jax.grad."""
    q, k, v, w = _qkvw(shape, seed=2 + shape[2])
    n, d = shape[2], shape[3]
    rng = np.random.default_rng(5)
    pm = ((rng.uniform(size=(n, n)) < 0.8) / 0.8).astype(np.float32)

    def ref(a, b, c):
        s = jnp.einsum("bhqd,bhkd->bhqk", a, b) * (d ** -0.5)
        return jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(s, axis=-1) * jnp.asarray(pm), c)

    jargs = tuple(map(jnp.asarray, (q, k, v)))
    want = ref(*jargs)
    want_grads = jax.grad(lambda *a: jnp.sum(jnp.asarray(w) * ref(*a)), argnums=(0, 1, 2))(*jargs)
    for fn in (flash_attention, flash_attention_plain):
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        got = fn(*ts, torch.from_numpy(pm))
        _close(got.detach().numpy(), want, 1e-5, fn.__name__)
        (got * torch.from_numpy(w)).sum().backward()
        for name, t, wg in zip("qkv", ts, want_grads):
            _close(t.grad.numpy(), wg, 1e-4, f"{fn.__name__} d{name}")
    # a multiplier of ones is no multiplier
    ts = [torch.from_numpy(a) for a in (q, k, v)]
    assert torch.equal(flash_attention(*ts, torch.ones(n, n)), flash_attention(*ts))


def test_flash_attention_backward_uses_the_saved_statistics():
    """The backward rebuilds P from the LSE it is given and reads delta from
    the O it is given: with an LSE moved by log 2 every P halves, so dV
    halves, and dQ, dK follow P * (dP - delta) with that P."""
    shape = (2, 2, 9, 8)
    q, k, v, g = map(torch.from_numpy, _qkvw(shape, seed=7))
    o, lse = flash_attention_fwd(q, k, v)
    dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, g)
    _, _, dv_half = flash_attention_bwd(q, k, v, o, lse + np.log(2.0), g)
    torch.testing.assert_close(dv_half, dv / 2, rtol=1e-5, atol=1e-6)
    want = flash_attention_bwd_plain(q, k, v, o, lse, g)
    for got, ref in zip((dq, dk, dv), want):
        assert torch.equal(got, ref)


def test_flash_attention_takes_strided_views_and_an_expanded_cotangent():
    """Views of [B, N, H, D] projections go in without a copy and give what
    contiguous copies give; sum() hands the backward a stride-0 cotangent."""
    b, h, n, d = 2, 3, 11, 8
    rng = np.random.default_rng(3)
    base = [torch.from_numpy(rng.standard_normal((b, n, h, d)).astype(np.float32))
            for _ in range(3)]
    views = [t.permute(0, 2, 1, 3).requires_grad_() for t in base]
    copies = [t.permute(0, 2, 1, 3).contiguous().requires_grad_() for t in base]
    assert not views[0].is_contiguous()
    out_v, out_c = flash_attention(*views), flash_attention(*copies)
    assert torch.equal(out_v, out_c)
    out_v.sum().backward()
    out_c.sum().backward()
    for tv, tc in zip(views, copies):
        assert torch.equal(tv.grad, tc.grad)


def test_flash_attention_refuses_what_it_cannot_take():
    q = torch.zeros(2, 2, 5, 4)
    with pytest.raises(ValueError, match=r"\[B, H, N, D\]"):
        flash_attention_fwd(q[0], q[0], q[0])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention_fwd(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="share q's shape"):
        flash_attention_fwd(q, q[:, :, :4], q)
    with pytest.raises(ValueError, match="pm must be float32"):
        flash_attention_fwd(q, q, q, torch.ones(4, 5))
    with pytest.raises(ValueError, match="lse must be float32"):
        flash_attention_bwd(q, q, q, q, torch.zeros(2, 2, 5), q)
    # the kernels' budget: the backward of vit_cifar100's and vit_mnist's
    # geometry fits one block's shared memory, [128, 64] does not
    assert backward_shared_bytes(65, 32) == 94_464 < 227 * 1024
    assert backward_shared_bytes(50, 16) < backward_shared_bytes(128, 32) < 227 * 1024
    assert backward_shared_bytes(128, 64) > 227 * 1024
    # the instances built: the configs' two shapes, and the widest for the rest
    assert [score_columns(n, d) for n, d in ((50, 16), (7, 8), (65, 32), (96, 32), (97, 32),
                                             (65, 64), (7, 40))] == [64, 64, 96, 96, 128, 128, 128]
    # the loader takes 16-byte vectors: whole, aligned rows
    base = torch.zeros(2, 5, 2, 8)
    assert rows_aligned(base) and rows_aligned(base.permute(0, 2, 1, 3))
    assert rows_aligned(base.to(torch.bfloat16))
    assert not rows_aligned(base[..., :4].to(torch.bfloat16).contiguous())  # 8-byte rows
    assert not rows_aligned(base[..., 1:5])  # starts 4 bytes in
    assert not rows_aligned(base.expand(3, 2, 5, 2, 8)[0].transpose(-1, -2))  # last axis strided
    assert not rows_aligned(torch.zeros(2, 2, 5, 6))  # 24-byte rows
    out, lse = flash_attention_fwd_plain(q, q, q)
    assert out.shape == q.shape and torch.allclose(lse, torch.full_like(lse, np.log(5.0)))


# ---- bfloat16: the tensor-core kernels' arithmetic ------------------------------------

def _bf16(x):
    """float32 values rounded to the nearest bfloat16 (ties to even), as float32."""
    u = np.asarray(x, np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def _formula(q, k, v, g, o, lse, pm, rounded):
    """O, dQ, dK, dV in float64 from the forward's O and LSE; ``rounded``:
    P * pm and dS rounded to bf16 before their products, as the tensor-core
    kernels do."""
    r = (lambda x: _bf16(x).astype(np.float64)) if rounded else (lambda x: x)
    scale = q.shape[-1] ** -0.5
    s = q @ np.swapaxes(k, -1, -2) * scale
    e = np.exp(s - s.max(-1, keepdims=True))
    p = e / e.sum(-1, keepdims=True)
    out = r(p if pm is None else p * pm) @ v
    p = np.exp(s - lse)
    delta = (g * o).sum(-1, keepdims=True)
    dp = g @ np.swapaxes(v, -1, -2)
    pp = p
    if pm is not None:
        pp, dp = p * pm, dp * pm
    ds = r(p * (dp - delta))
    return (out, ds @ k * scale, np.swapaxes(ds, -1, -2) @ q * scale,
            np.swapaxes(r(pp), -1, -2) @ g)


def _bf16_case(shape, use_pm, seed):
    rng = np.random.default_rng(seed)
    arrays = [_bf16(rng.standard_normal(shape).astype(np.float32)) for _ in range(4)]
    n = shape[2]
    pm = ((rng.uniform(size=(n, n)) < 0.8) / 0.8).astype(np.float32) if use_pm else None
    tensors = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]
    return arrays, pm, tensors, None if pm is None else torch.from_numpy(pm)


@pytest.mark.parametrize("use_pm", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_plain_versions_round_p_and_ds_where_the_kernels_do(shape, use_pm):
    """In bf16 the plain forward and backward are the explicit formula with
    P * pm and dS rounded to bf16 before their products and everything else
    in float32: at least 99% of the entries of O, dQ, dK and dV equal the
    formula's (float64 here, rounded to bf16 once at the end) bit for bit,
    the rest differ where a float32 sum order moved a value across a bf16
    rounding boundary, within 2^-8 of the largest entry. Without the two
    roundings the formula matches only about 60% of the entries."""
    arrays, pm, (q, k, v, g), tpm = _bf16_case(shape, use_pm, seed=shape[2])
    o, lse = flash_attention_fwd_plain(q, k, v, tpm)
    grads = flash_attention_bwd_plain(q, k, v, o, lse, g, tpm)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    f64 = [a.astype(np.float64) for a in arrays]
    pm64 = None if pm is None else pm.astype(np.float64)
    got = [t.double().numpy() for t in (o, *grads)]
    for rounded in (True, False):
        want = _formula(*f64, got[0], lse.double().numpy(), pm64, rounded)
        for name, a, w in zip(("o", "dq", "dk", "dv"), got, want):
            wb = _bf16(w.astype(np.float32))
            equal = float((a == wb).mean())
            if rounded:
                assert equal >= 0.99, name
                assert np.abs(a - wb).max() <= 2.0 ** -8 * np.abs(w).max(), name
            else:
                assert equal <= 0.8, name


@pytest.mark.parametrize("use_pm", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_arithmetic_stays_near_the_float32_arithmetic(shape, use_pm):
    """The distance of the bf16 plain versions (the tensor-core kernels'
    arithmetic) from the float32 arithmetic on the same bf16 inputs, as a
    share of the largest entry: P * pm, dS and the outputs each rounded once
    to bf16 (2^-9 of a value each). Over these shapes and seeds it is at most
    0.0056 (O; the gradients 0.0039-0.0049); the bound is 2^-6. LSE is
    float32 in both."""
    _, _, (q, k, v, g), tpm = _bf16_case(shape, use_pm, seed=10 + shape[2])
    o, lse = flash_attention_fwd_plain(q, k, v, tpm)
    grads = flash_attention_bwd_plain(q, k, v, o, lse, g, tpm)
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    o32, lse32 = flash_attention_fwd_plain(qf, kf, vf, tpm)
    grads32 = flash_attention_bwd_plain(qf, kf, vf, o.float(), lse, gf, tpm)
    assert torch.equal(lse, lse32)
    for name, a, w in zip(("o", "dq", "dk", "dv"), (o, *grads), (o32, *grads32)):
        err = float((a.float() - w).abs().max() / w.abs().max())
        assert 0.0 < err <= 2.0 ** -6, (name, err)


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_plain_versions_match_the_pallas_kernels_in_bf16(shape):
    """bf16 inputs, fed to both: the port's bf16 plain versions (P * pm and dS
    rounded to bf16) against the Pallas forward in interpret mode and the VJP
    through its custom backward (P and dS kept in float32), within 2^-6 of
    the largest entry of the JAX result (at most 0.0088 over these shapes:
    dK at [1, 1, 7, 8]); the LSE, float32 in both, within 1e-5."""
    arrays = [_bf16(a) for a in _qkvw(shape, seed=20 + shape[2])]
    jq, jk, jv, jg = (jnp.asarray(a, dtype=jnp.bfloat16) for a in arrays)
    want_o, want_lse = jax_forward(jq, jk, jv, True)
    _, vjp = jax.vjp(lambda a, b, c: jax_flash_attention(a, b, c, True), jq, jk, jv)
    want_grads = vjp(jg)
    q, k, v, g = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    o, lse = flash_attention_fwd_plain(q, k, v)
    grads = flash_attention_bwd_plain(q, k, v, o, lse, g)
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*ts)
    out.backward(g)
    assert torch.equal(out.detach(), o)
    assert float(np.abs(lse.numpy() - np.asarray(want_lse)).max()) <= 1e-5
    for name, got, want in (("o", o, want_o), *zip(("dq", "dk", "dv"), grads, want_grads),
                            *zip(("dq autograd", "dk autograd", "dv autograd"),
                                 (t.grad for t in ts), want_grads)):
        want = np.asarray(want.astype(jnp.float32))
        err = float(np.abs(got.float().numpy() - want).max())
        assert err <= 2.0 ** -6 * float(np.abs(want).max()), (name, err)
