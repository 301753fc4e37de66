"""The folded mix's one-launch backward on the CPU: ``folded_mix_pool``
(``perm_rows_t``, ``folded_proj`` and the grouped sign-mean pool as one
autograd Function) and kernel 5's plain version with the pool residual's
cotangent, against autograd of the plain composition and ``jax.vjp`` of
JAX's ``perm_rows_t`` followed by ``folded_proj_pool``; and which training
forwards of ``MHPermutMix`` take it (``FoldedMixLinear.forward_paths``),
the rest held bit for bit to the chain they ran before.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectre_tpu.ops.fused_mix import folded_proj_pool as jax_folded_proj_pool
from spectre_tpu.ops.fused_mix import perm_rows_t as jax_perm_rows_t
from spectre_tpu_torch.models.layers import FoldedMixLinear, MHPermutMix
from spectre_tpu_torch.ops import (
    derive_mix_tables,
    fold_weights,
    folded_bmm,
    folded_mix_pool,
    folded_proj,
    fuses_mix_backward,
    gelu_exact,
    grouped_pool,
    grouped_pool_weights,
    layer_norm,
    make_block_mix_tables,
    perm_rows_t,
    perm_rows_t_plain,
    routing,
)
from spectre_tpu_torch.ops.kernels import block_gather_sum_plain, fused_block_bwd, \
    fused_block_bwd_plain

# E = 8 over N = 24 tokens (d = 192: three 64-row blocks a head), H = 16:
# in = 128, O = 8, grp = 16
E, N, H, BLK = 8, 24, 16, 64


def _case(dtype, b, seed=0):
    gen = torch.Generator().manual_seed(seed)
    d = N * E
    perms, signs = make_block_mix_tables(gen, H, d, BLK)
    tables = derive_mix_tables(perms)
    eh, o = E * H, E
    grp = eh // o
    s4 = signs.reshape(N, eh).to(dtype)
    pool_w = (s4.reshape(N, o, grp) / grp).contiguous()
    xt = (torch.randn(d, b, generator=gen) * 0.5).to(dtype)
    w = (torch.randn(eh, o, generator=gen) * 0.2).to(dtype)
    dy = (torch.randn(N, b, o, generator=gen) * 0.5).to(dtype)
    # the pool's cotangent arrives as a transposed [B, N, O] view, as in the step
    dpool = torch.randn(b, N, o, generator=gen).to(dtype).transpose(0, 1)
    return perms, tables, s4, pool_w, grp, xt, w, dy, dpool


def _plain_composition(xt, w, perms, s4, pool_w, grp):
    g4 = perm_rows_t_plain(xt, perms).view(N, -1, xt.shape[1])
    y = folded_bmm(g4, fold_weights(w, s4))
    pool = torch.einsum("nuvb,nuv->nbu", g4.reshape(N, w.shape[1], grp, -1), pool_w)
    return y, pool


def test_plain_pool_term_is_the_head_sum_of_the_signed_cotangent():
    """fused_block_bwd_plain with dpool against block_gather_sum of s4 * (w
    dy^T + P dpool^T) in float64; without dpool, the result it always gave."""
    _, tables, s4, _, grp, _, w, dy, dpool = _case(torch.float32, 7)
    got = fused_block_bwd_plain(dy, w, s4, tables.binv, BLK, dpool, grp)
    dg4 = torch.bmm(w.double().expand(N, -1, -1), dy.double().transpose(1, 2))
    dg4 += dpool.double().permute(0, 2, 1).repeat_interleave(grp, dim=1) / grp
    want = block_gather_sum_plain((dg4 * s4.double()[:, :, None]).reshape(-1, 7),
                                  tables.binv, BLK)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    no_pool = fused_block_bwd_plain(dy, w, s4, tables.binv, BLK)
    dg4 = torch.bmm(w.double().expand(N, -1, -1), dy.double().transpose(1, 2))
    want = block_gather_sum_plain((dg4 * s4.double()[:, :, None]).reshape(-1, 7),
                                  tables.binv, BLK)
    np.testing.assert_allclose(no_pool.numpy(), want.numpy(), atol=1e-5, rtol=0)
    assert torch.equal(fused_block_bwd(dy, w, s4, tables.binv, BLK, dpool, grp), got)
    with pytest.raises(ValueError):
        fused_block_bwd(dy, w, s4, tables.binv, BLK, dpool, grp // 2)
    with pytest.raises(ValueError):
        fused_block_bwd(dy, w, s4, tables.binv, BLK, dpool[:, :-1], grp)


# bf16: both sides round the inputs alike; the chain rounds dg4, the pool's
# cotangent and their sum to bf16 where the kernel's arithmetic keeps float32
# and rounds once, so entries differ by about one bf16 ulp (2^-8 of an entry)
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -6)])
@pytest.mark.parametrize("b", [5, 33])
def test_folded_mix_pool_matches_autograd_of_the_plain_composition(dtype, rel, b):
    perms, tables, s4, pool_w, grp, xt, w, dy, dpool = _case(dtype, b, seed=b)
    xa, wa = xt.clone().requires_grad_(), w.clone().requires_grad_()
    y, pool = folded_mix_pool(xa, wa, s4, tables, grp)
    xb, wb = xt.clone().requires_grad_(), w.clone().requires_grad_()
    want_y, want_pool = _plain_composition(xb, wb, perms, s4, pool_w, grp)
    assert torch.equal(y, want_y) and torch.equal(pool, want_pool)
    torch.autograd.backward((y, pool), (dy, dpool))
    torch.autograd.backward((want_y, want_pool), (dy, dpool))
    for got, want in ((xa.grad, xb.grad), (wa.grad, wb.grad)):
        assert got.dtype == dtype and got.shape == want.shape
        scale = want.float().abs().max().item()
        assert (got.float() - want.float()).abs().max().item() <= rel * scale
    # dW is folded_proj's, op for op
    wc = w.clone().requires_grad_()
    g4 = perm_rows_t_plain(xt, perms).view(N, -1, b)
    folded_proj(g4, wc, s4).backward(dy)
    assert torch.equal(wa.grad, wc.grad)


@pytest.mark.parametrize("b", [5, 8])
def test_folded_mix_pool_matches_jax_vjp_of_perm_rows_t_and_folded_proj_pool(b):
    perms, tables, s4, pool_w, grp, xt, w, dy, dpool = _case(torch.float32, b, seed=10 + b)
    jperms, js4 = jnp.asarray(perms.numpy()), jnp.asarray(s4.numpy())

    def jax_fn(xt_, w_):
        g4 = jax_perm_rows_t(xt_, jperms).reshape(N, -1, b)
        return jax_folded_proj_pool(g4, w_, js4, grp)

    (want_y, want_pool), vjp = jax.vjp(jax_fn, jnp.asarray(xt.numpy()), jnp.asarray(w.numpy()))
    want_dx, want_dw = vjp((jnp.asarray(dy.numpy()), jnp.asarray(dpool.contiguous().numpy())))
    xa, wa = xt.clone().requires_grad_(), w.clone().requires_grad_()
    y, pool = folded_mix_pool(xa, wa, s4, tables, grp)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), atol=1e-5, rtol=0)
    np.testing.assert_allclose(pool.detach().numpy(), np.asarray(want_pool), atol=1e-5, rtol=0)
    torch.autograd.backward((y, pool), (dy, dpool))
    np.testing.assert_allclose(xa.grad.numpy(), np.asarray(want_dx), atol=1e-5, rtol=0)
    np.testing.assert_allclose(wa.grad.numpy(), np.asarray(want_dw), atol=1e-5, rtol=0)


def _mix(dtype, *, mix_block=BLK, heads=H, out=E, route=None):
    m = MHPermutMix(E, N, heads, out, mix_block=mix_block, dtype=dtype)
    gen = torch.Generator().manual_seed(3)
    m.init_parameters(gen)
    m.linear.init_parameters(gen)
    if route is not None:
        assert m.set_mix_route(route)
    return m


def _chain(m, x):
    """The mix's forward as it ran before the one-launch backward: the
    permutation, folded_proj (or the folded weights without a gradient), the
    pool, LN, GELU."""
    mix, lin, dt = m.refresh(), m.linear, m.dtype
    b = x.shape[0]
    xt = x.to(dt).reshape(b, -1).t().contiguous()
    g4 = perm_rows_t(xt, mix.tables, mix.route).view(N, -1, b)
    if torch.is_grad_enabled():
        y = folded_proj(g4, lin.kernel.to(dt), mix.s4)
    else:
        y = folded_bmm(g4, fold_weights(lin.kernel.to(dt), mix.s4))
    y = y + lin.bias.to(dt)
    if mix.grp:
        pool = torch.einsum("nuvb,nuv->nbu", g4.reshape(N, lin.features, mix.grp, b),
                            mix.pool_w)
    else:
        pool = folded_bmm(g4, mix.pool_w)
    h = gelu_exact(layer_norm(y, lin.ln_scale.to(dt), lin.ln_bias.to(dt))) + pool
    return h.transpose(0, 1)


def _grads(m, x, fn):
    x = x.clone().requires_grad_()
    for p in m.parameters():
        p.grad = None
    out = fn(x)
    out.backward(torch.linspace(-1, 1, out.numel()).reshape(out.shape).to(out.dtype))
    return out.detach(), x.grad, {k: p.grad.clone() for k, p in m.named_parameters()}


@pytest.mark.parametrize("case", [
    "float32", "blk32", "blk16", "mix_block0", "routed", "grp0", "grp8", "no_grad"])
def test_bypassing_mixes_keep_the_chain_bit_for_bit(case, tmp_path, monkeypatch):
    """Every mix the one-launch backward does not take counts as the chain
    (nothing for a forward without a gradient) and gives the forward and
    gradients of the chain it ran before, bit for bit."""
    monkeypatch.setattr(routing, "ROUTE_CACHE_DIR", str(tmp_path / "routes"))
    kw = {"float32": dict(dtype=torch.float32), "blk32": dict(mix_block=32),
          "blk16": dict(mix_block=16), "mix_block0": dict(mix_block=0),
          "routed": dict(route="takes"), "grp0": dict(out=24), "grp8": dict(heads=8),
          "no_grad": {}}[case]
    m = _mix(kw.pop("dtype", torch.bfloat16), **kw)
    mix = m.refresh()
    assert not fuses_mix_backward(m.dtype, mix.tables.blk, mix.tables.binv.shape[0], mix.grp,
                                  m.linear.features, mix.route is not None) or case == "no_grad"
    x = torch.randn(5, N, E, generator=torch.Generator().manual_seed(4))
    before = dict(FoldedMixLinear.forward_paths)
    if case == "no_grad":
        with torch.no_grad():
            got, want = m(x), _chain(m, x)
        assert torch.equal(got, want)
        assert FoldedMixLinear.forward_paths == before
        return
    got = _grads(m, x, m)
    assert FoldedMixLinear.forward_paths == dict(before, chain=before["chain"] + 1)
    want = _grads(m, x, lambda t: _chain(m, t))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[2].keys() == want[2].keys()
    assert all(torch.equal(got[2][k], want[2][k]) for k in got[2])


def test_the_flagship_shaped_mix_takes_the_one_launch_backward():
    """bf16, 64-row blocks, grp 16: one count on the fused path; the same
    forward bits as the chain, the same dW (the same ops), and dx within a
    bf16 ulp of the chain's, which rounds per op."""
    m = _mix(torch.bfloat16)
    mix = m.refresh()
    assert (mix.tables.blk, mix.grp) == (BLK, 16)
    assert fuses_mix_backward(m.dtype, mix.tables.blk, mix.tables.binv.shape[0], mix.grp,
                              m.linear.features, mix.route is not None)
    x = torch.randn(7, N, E, generator=torch.Generator().manual_seed(5))
    before = dict(FoldedMixLinear.forward_paths)
    got = _grads(m, x, m)
    assert FoldedMixLinear.forward_paths == dict(before, fused=before["fused"] + 1)
    want = _grads(m, x, lambda t: _chain(m, t))
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(got[2][k], want[2][k]) for k in got[2])
    scale = want[1].float().abs().max().item()
    assert (got[1].float() - want[1].float()).abs().max().item() <= 2.0 ** -6 * scale
    with torch.no_grad():  # serving's path: no count, the chain's bits
        assert torch.equal(m(x), _chain(m, x))
    assert FoldedMixLinear.forward_paths == dict(before, fused=before["fused"] + 1)


def test_grouped_pool_is_the_einsum_it_names():
    g4 = torch.randn(3, 32, 5)
    pool_w = torch.randn(3, 2, 16)
    want = torch.einsum("nuvb,nuv->nbu", g4.reshape(3, 2, 16, 5), pool_w)
    assert torch.equal(grouped_pool(g4, pool_w, 16), want)
    # the weights folded_mix_pool makes from s4 are the mix's own, bit for bit
    mix = _mix(torch.bfloat16).refresh()
    assert torch.equal(grouped_pool_weights(mix.s4, mix.grp), mix.pool_w)
    assert torch.equal(mix.pool_w, (mix.s4.reshape(N, E, mix.grp) / mix.grp))
