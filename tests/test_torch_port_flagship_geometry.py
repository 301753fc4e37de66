"""The port's plain path against the JAX package at the flagship's own
geometry (configs/spectre_vit_cifar100.py): 32 x 32 x 3 images in patches of
4 (65 tokens), E=512, H=16 (the mix at E*H = 8,192), FF 768 (the 768 -> 512
adaptive pool that does not divide), block tables of 64 rows, 100 classes.
One layer, float32, B=2, on the CPU: the tiny topology of the other tests
has no non-divisible pool and no 64-row table.

The JAX side registers its block routes as its train loop does, so its
gradients go through the Pallas block gather in interpret mode; the port
runs every kernel's plain version (CPU tensors).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_export_cfg
from spectre_tpu.models import build_model as jax_build_model
from spectre_tpu.ops.fused_mix import clear_mix_routes, register_block_mix_routes
from spectre_tpu.train.step import cross_entropy_loss as jax_cross_entropy_loss
from spectre_tpu_torch.models import build_model, flax_state_dict, load_flax_variables
from spectre_tpu_torch.train import cross_entropy_loss

B = 2


def _flagship_cfg():
    return tiny_export_cfg(dataset="cifar100", img_size=32, num_classes=100, embed_dim=512,
                           num_heads=16, hidden_dim=768, num_encoders=1, mix_impl="folded",
                           mix_block=64)


@pytest.fixture(scope="module")
def flagship():
    """The JAX init, a batch, the JAX logits, loss and gradients."""
    cfg = _flagship_cfg()
    jm = jax_build_model(cfg)
    v = jax.tree.map(np.asarray, jm.init(jax.random.key(1), jnp.zeros((1, 3, 32, 32))))
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 1, (B, 3, 32, 32)).astype(np.float32)
    y = rng.integers(0, cfg.num_classes, B).astype(np.int32)
    logits = np.asarray(jm.apply(v, jnp.asarray(x)))
    assert len(register_block_mix_routes(v)) == cfg.num_encoders
    try:
        def loss_fn(params):
            out = jm.apply({"params": params, "buffers": v["buffers"]}, jnp.asarray(x))
            return jax_cross_entropy_loss(out, jnp.asarray(y))

        loss, grads = jax.value_and_grad(loss_fn)(v["params"])
    finally:
        clear_mix_routes()
    return cfg, v, x, y, logits, float(loss), jax.tree.map(np.asarray, grads)


def test_flagship_geometry_logits_match_jax(flagship):
    """Logits of the served model (folded weights cached) within 1e-4, and
    the mix's tables taken as 64-row blocks."""
    cfg, v, x, _, want, _, _ = flagship
    model = load_flax_variables(build_model(cfg, "cpu"), v)
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert model.encoder_blocks.layer_0.mix_layer.refresh().tables.blk == 64
    assert got.shape == (B, 100)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_flagship_geometry_loss_and_every_gradient_match_jax(flagship):
    """The train-mode model through cross-entropy: loss within 1e-5, every
    parameter's gradient within 1e-4 of the largest entry of its JAX
    counterpart."""
    cfg, v, x, y, _, want_loss, want_grads = flagship
    model = load_flax_variables(build_model(cfg, "cpu", train=True), v)
    loss = cross_entropy_loss(model(torch.from_numpy(x)), torch.from_numpy(y))
    loss.backward()
    assert abs(float(loss.detach()) - want_loss) <= 1e-5
    want = flax_state_dict(model, {"params": want_grads})
    params = dict(model.named_parameters())
    assert set(want) == set(params)
    for name, p in params.items():
        assert p.grad is not None and p.grad.dtype == p.dtype, name
        w = np.asarray(want[name])
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(p.grad.numpy() - w).max()) <= 1e-4 * scale, name
