"""Gradients of the port (spectre_tpu_torch) against ``jax.vjp`` /
``jax.value_and_grad`` of the JAX package, on the CPU in float32, with
inputs made from numpy seeds and fed to both.

On a CPU tensor each kernel wrapper runs its plain PyTorch version; the
Pallas kernels run in interpret mode, as tests/test_block_mix.py and
tests/test_pallas.py run them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_export_cfg
from spectre_tpu.models import build_model as jax_build_model
from spectre_tpu.ops.fused_mix import (
    clear_mix_routes,
    register_block_mix_routes,
)
from spectre_tpu.ops.fused_mix import folded_proj as jax_folded_proj
from spectre_tpu.ops.pallas import fused_spectre_linear as jax_fused_spectre_linear
from spectre_tpu.train.step import cross_entropy_loss as jax_cross_entropy_loss
from spectre_tpu_torch.models import build_model, flax_state_dict, load_flax_variables
from spectre_tpu_torch.ops import (
    derive_mix_tables,
    folded_proj,
    perm_rows_t,
    perm_rows_t_plain,
    spectre_linear_apply,
)
from spectre_tpu_torch.ops.kernels import fused_spectre_linear_grad, fused_spectre_linear_plain
from spectre_tpu_torch.train import cross_entropy_loss


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_grad_close(got, want, rel=1e-4, what=""):
    """Within ``rel`` of the largest entry of the reference tensor."""
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert got.shape == want.shape, what
    assert float(np.abs(np.asarray(got) - want).max()) <= rel * scale, what


def _linear_case(m, k, n, lead=(), seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*lead, m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(n) * 0.1).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, n).astype(np.float32)
    beta = (rng.standard_normal(n) * 0.1).astype(np.float32)
    ct = rng.standard_normal((*lead, m, n)).astype(np.float32)
    return (x, w, b, gamma, beta), ct


# K == N, K % N == 0 (grouped mean), the pool matrix shrinking (48 -> 24
# style is the grouped case above; 24 -> 16 is the 768 -> 512 ratio) and
# growing (upsampling), with and without leading axes
@pytest.mark.parametrize("m,k,n,lead", [(16, 32, 32, ()), (10, 48, 24, ()), (7, 24, 16, ()),
                                        (64, 16, 40, ()), (5, 16, 16, (2,)),
                                        (5, 24, 16, (3,)), (4, 16, 24, (2, 3))])
def test_fused_spectre_linear_value_and_five_gradients_match_jax_vjp(m, k, n, lead):
    arrays, ct = _linear_case(m, k, n, lead, seed=m + k + n)
    want, vjp = jax.vjp(lambda *a: jax_fused_spectre_linear(*a, interpret=True),
                        *map(jnp.asarray, arrays))
    want_grads = vjp(jnp.asarray(ct))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    got = spectre_linear_apply(*ts)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4, rtol=0)
    got.backward(torch.from_numpy(ct))
    for name, t, wg in zip(("dx", "dw", "db", "dgamma", "dbeta"), ts, want_grads):
        _assert_grad_close(t.grad.numpy(), wg, what=name)


@pytest.mark.parametrize("m,k,n", [(16, 32, 32), (10, 48, 24), (9, 16, 40)])
def test_fused_spectre_linear_backward_matches_autograd_of_the_plain_expression(m, k, n):
    arrays, ct = _linear_case(m, k, n, seed=3)
    a = [torch.from_numpy(v).requires_grad_() for v in arrays]
    b = [torch.from_numpy(v).requires_grad_() for v in arrays]
    fused_spectre_linear_grad(*a).backward(torch.from_numpy(ct))
    fused_spectre_linear_plain(*b).backward(torch.from_numpy(ct))
    for name, ta, tb in zip(("dx", "dw", "db", "dgamma", "dbeta"), a, b):
        _assert_grad_close(ta.grad.numpy(), tb.grad.numpy(), what=name)


def test_spectre_linear_apply_saves_h_only_when_a_gradient_is_wanted(monkeypatch):
    from spectre_tpu_torch.ops import linear

    calls = []
    monkeypatch.setattr(linear, "fused_spectre_linear_grad",
                        lambda *a: calls.append("grad") or fused_spectre_linear_plain(*a))
    monkeypatch.setattr(linear, "fused_spectre_linear",
                        lambda *a: calls.append("plain") or fused_spectre_linear_plain(*a))
    arrays, _ = _linear_case(4, 8, 8)
    ts = [torch.from_numpy(v) for v in arrays]
    spectre_linear_apply(*ts)
    ts[1].requires_grad_()
    spectre_linear_apply(*ts)
    with torch.no_grad():
        spectre_linear_apply(*ts)
    assert calls == ["plain", "grad", "plain"]


@pytest.mark.parametrize("n,e,o,b", [(5, 16, 4, 8), (3, 24, 16, 5)])
def test_folded_proj_value_and_gradients_match_jax_vjp(n, e, o, b):
    rng = np.random.default_rng(n * e)
    g4 = rng.standard_normal((n, e, b)).astype(np.float32)
    w = (rng.standard_normal((e, o)) * 0.2).astype(np.float32)
    s4 = rng.choice([-1.0, 1.0], (n, e)).astype(np.float32)
    dy = rng.standard_normal((n, b, o)).astype(np.float32)
    want, vjp = jax.vjp(jax_folded_proj, jnp.asarray(g4), jnp.asarray(w), jnp.asarray(s4))
    want_dg4, want_dw, _ = vjp(jnp.asarray(dy))
    tg, tw, ts = (torch.from_numpy(a).requires_grad_() for a in (g4, w, s4))
    got = folded_proj(tg, tw, ts)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    # the cotangent arrives as a transposed view, as in FoldedMixLinear
    got.backward(torch.from_numpy(dy.transpose(1, 0, 2).copy()).transpose(0, 1))
    np.testing.assert_allclose(tg.grad.numpy(), np.asarray(want_dg4), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want_dw), atol=1e-5, rtol=0)
    assert ts.grad is None


@pytest.mark.parametrize("blk", [1, 8])
def test_perm_rows_t_function_matches_autograd_of_the_plain_gather(blk):
    """Forward through the block copy, backward through the head-summed
    inverse gather (the block kernel's plain version for blk = 8, the row
    kernel's for a uniform table), against index_select and its autograd."""
    rng = np.random.default_rng(blk)
    h, nb, b = 3, 6, 5
    bsrc = np.stack([rng.permutation(nb) for _ in range(h)])
    if blk == 1:
        perms = bsrc
    else:
        perms = (bsrc[:, :, None] * blk + np.arange(blk)).reshape(h, nb * blk)
    perms = torch.from_numpy(perms.astype(np.int32))
    tables = derive_mix_tables(perms)
    assert tables.blk == blk
    xt = rng.standard_normal((perms.shape[1], b)).astype(np.float32)
    ct = torch.from_numpy(rng.standard_normal((h * perms.shape[1], b)).astype(np.float32))
    x1, x2 = (torch.from_numpy(xt).requires_grad_() for _ in range(2))
    y1, y2 = perm_rows_t(x1, tables), perm_rows_t_plain(x2, perms)
    assert torch.equal(y1, y2)
    # a non-contiguous cotangent is made contiguous inside the Function
    y1.backward(ct.t().contiguous().t())
    y2.backward(ct)
    np.testing.assert_allclose(x1.grad.numpy(), x2.grad.numpy(), atol=1e-5, rtol=0)


def test_derive_mix_tables_refuses_a_non_permutation():
    perms = torch.tensor([[0, 1, 2, 3], [1, 1, 2, 3]], dtype=torch.int32)
    with pytest.raises(ValueError, match="permutation"):
        derive_mix_tables(perms)


# ---- the whole model ---------------------------------------------------------


@pytest.mark.parametrize("mix_block", [8, 0])
def test_flagship_topology_loss_and_every_gradient_match_jax(mix_block):
    """Init in JAX, bridge into the port, one batch through cross-entropy:
    loss within 1e-5, every parameter's gradient within 1e-4 of the largest
    entry of its JAX counterpart. The JAX side registers its block routes
    as its train loop does, so mix_block=8 differentiates through the Pallas
    block gather (interpret mode) and mix_block=0 through the per-head
    chain; the port takes its block and row backward respectively."""
    cfg = tiny_export_cfg(mix_impl="folded", mix_block=mix_block)
    jm = jax_build_model(cfg)
    v = jm.init(jax.random.key(1), jnp.zeros((1, 3, 8, 8)))
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (8, 3, 8, 8)).astype(np.float32)
    y = rng.integers(0, cfg.num_classes, 8).astype(np.int32)
    if mix_block:
        assert len(register_block_mix_routes(v)) == cfg.num_encoders
    else:
        clear_mix_routes()
    try:
        def loss_fn(params):
            logits = jm.apply({"params": params, "buffers": v["buffers"]}, jnp.asarray(x))
            return jax_cross_entropy_loss(logits, jnp.asarray(y))

        want_loss, want_grads = jax.value_and_grad(loss_fn)(v["params"])
    finally:
        clear_mix_routes()

    model = load_flax_variables(build_model(cfg, "cpu", train=True), _np(v))
    mixes = [m for m in model.modules() if hasattr(m, "table_derivations")]
    assert {m.refresh().tables.blk >= 8 for m in mixes} == {bool(mix_block)}
    loss = cross_entropy_loss(model(torch.from_numpy(x)), torch.from_numpy(y))
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5
    want = flax_state_dict(model, {"params": _np(want_grads)})
    params = dict(model.named_parameters())
    assert set(want) == set(params)
    for name, p in params.items():
        assert p.grad is not None and p.grad.dtype == p.dtype, name
        _assert_grad_close(p.grad.numpy(), want[name], what=name)


def test_train_and_eval_modes_give_the_same_logits():
    """Train mode projects through folded_proj (so the kernel gets its
    gradient), eval mode through the cached folded weights; at dropout 0
    they are the same function."""
    cfg = tiny_export_cfg(mix_impl="folded", mix_block=8)
    model = build_model(cfg, "cpu", train=True)
    x = torch.from_numpy(np.random.default_rng(6).uniform(0, 1, (8, 3, 8, 8))
                         .astype(np.float32))
    trained = model(x)
    assert trained.requires_grad
    assert model.encoder_blocks.layer_0.mix_layer.linear._wp is None
    model.eval()
    with torch.no_grad():
        served = model(x)
    assert model.encoder_blocks.layer_0.mix_layer.linear._wp is not None
    np.testing.assert_allclose(trained.detach().numpy(), served.numpy(), atol=1e-5, rtol=0)
