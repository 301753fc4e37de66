"""The other model families of the port as a whole (spectre_tpu_torch): the
baseline attention ViT, and SpectreViT with every mixer and mix impl, against
the JAX package on the CPU in float32: the same weights (initialised in JAX,
carried over by the weight bridge), the same numpy batches, dropout 0, no
augmentation, ``fast_rng=False``. Then the entry points, on synthetic data.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import REPO_ROOT, tiny_export_cfg
from spectre_tpu.models import build_model as jax_build_model
from spectre_tpu.train.optim import make_optimizer as jax_make_optimizer
from spectre_tpu.train.state import create_train_state as jax_create_train_state
from spectre_tpu.train.step import cross_entropy_loss as jax_cross_entropy_loss
from spectre_tpu.train.step import make_train_step as jax_make_train_step
from spectre_tpu_torch.configs import CONFIG_DIR, parse_config
from spectre_tpu_torch.models import (
    MHPermutMix,
    ViT,
    build_model,
    flax_state_dict,
    load_flax_variables,
    load_npz,
    save_npz,
)
from spectre_tpu_torch.repl import bench
from spectre_tpu_torch.repl import train as train_cli
from spectre_tpu_torch.serving import SpectreClient, from_config
from spectre_tpu_torch.train import (
    create_train_state,
    cross_entropy_loss,
    make_optimizer,
    make_train_step,
)

STEPS_PER_EPOCH = 6


def _np(tree):
    return jax.tree.map(np.array, tree)


def _vit_cfg(**over):
    """vit_cifar100's topology, shrunk: 2 post-norm layers, E=32, 4 heads of
    8, FF 48, 8x8x3 images in 4x4 patches (5 tokens)."""
    return tiny_export_cfg(**(dict(model="vit", method="attention", embed_dim=32, num_heads=4,
                                   hidden_dim=48, epochs=2) | over))


def _spectre_cfg(**over):
    """SpectreViT with one layer at the ViT tests' widths, so that the JAX
    side reuses their small programs."""
    return tiny_export_cfg(**(dict(mix_impl="folded", embed_dim=32, num_heads=4, hidden_dim=48,
                                   num_encoders=1) | over))


def _batches(cfg, n, b=8, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(0, 1, (b, 3, 8, 8)).astype(np.float32),
             rng.integers(0, cfg.num_classes, b).astype(np.int32)) for _ in range(n)]


_JAX_MODELS = {}


def _jax_and_port(cfg, seed=1):
    """The JAX model with its initialised variables (made once per config
    for the whole file) and a new port model carrying them. The JAX side runs
    op by op: these models share their small programs, which one jitted
    program per model would compile anew."""
    key = (seed, *sorted(vars(cfg).items()))
    if key not in _JAX_MODELS:
        jm = jax_build_model(cfg)
        _JAX_MODELS[key] = jm, _np(jm.init(jax.random.key(seed), jnp.zeros((1, 3, 8, 8))))
    jm, v = _JAX_MODELS[key]
    return jm, v, load_flax_variables(build_model(cfg, "cpu"), v)


def test_vit_logits_and_features_match_jax():
    cfg = _vit_cfg()
    jm, v, model = _jax_and_port(cfg)
    assert isinstance(model, ViT)
    (x, _), = _batches(cfg, 1)
    want, want_feat = jm.apply(v, jnp.asarray(x), return_features=True)
    with torch.inference_mode():
        got, feat = model(torch.from_numpy(x), return_features=True)
    assert got.dtype == torch.float32 and got.shape == (8, cfg.num_classes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    np.testing.assert_allclose(feat.numpy(), np.asarray(want_feat), atol=1e-4, rtol=0)


def test_vit_loss_and_every_gradient_match_jax_by_name():
    cfg = _vit_cfg()
    jm, v, model = _jax_and_port(cfg)
    model.train()
    (x, y), = _batches(cfg, 1, seed=3)

    def loss_fn(params):
        logits = jm.apply({"params": params}, jnp.asarray(x))
        return jax_cross_entropy_loss(logits, jnp.asarray(y))

    want_loss, want_grads = jax.value_and_grad(loss_fn)(v["params"])
    loss = cross_entropy_loss(model(torch.from_numpy(x)), torch.from_numpy(y))
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= 1e-5
    want = flax_state_dict(model, {"params": _np(want_grads)})
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(want) and len(names) == 4 + 2 * 16 + 2
    # each gradient within 1e-4 of its tensor's largest entry. The key bias
    # adds one constant to every score of a row, which softmax ignores: its
    # gradient is zero in exact arithmetic and rounding noise (1e-9) in both
    # packages, so a tensor's scale is floored at 1e-3 of the largest
    # gradient entry of the whole model
    floor = 1e-3 * max(float(np.abs(np.asarray(a)).max()) for a in want.values())
    for name, p in model.named_parameters():
        ref = np.asarray(want[name])
        scale = max(float(np.abs(ref).max()), floor)
        assert p.grad.shape == ref.shape, name
        assert float(np.abs(p.grad.numpy() - ref).max()) <= 1e-4 * scale, name
    key_bias = model.encoder_0.self_attn.mhsa.key.bias.grad
    assert float(key_bias.abs().max()) <= 1e-4 * floor


def test_vit_adamw_step_and_loss_curve_match_jax():
    """Parameters after one AdamW step within 1e-6, the loss at each of 5
    steps within 1e-4. The key bias is left out of the first: its gradient is
    rounding noise around an exact zero (softmax ignores a constant added to
    a row of scores), Adam scales that noise to a full step of the learning
    rate in either package, and the step moves no output."""
    cfg = _vit_cfg()
    jm = jax_build_model(cfg)
    jstate = jax_create_train_state(jm, jax_make_optimizer(cfg, STEPS_PER_EPOCH),
                                    jnp.zeros((1, 3, 8, 8)), seed=0)
    model = build_model(cfg, "cpu", train=True)
    load_flax_variables(model, _np({"params": jstate.params}))
    optimizer, scheduler = make_optimizer(cfg, model.parameters(), STEPS_PER_EPOCH)
    state = create_train_state(model, optimizer, scheduler, seed=0)
    jstep = jax_make_train_step(jm, augment_fn=None, fast_rng=False)
    step = make_train_step()
    for i, (x, y) in enumerate(_batches(cfg, 5)):
        jstate, jmetrics = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        metrics = step(state, torch.from_numpy(x), torch.from_numpy(y))
        assert abs(float(metrics["loss"]) - float(jmetrics["loss"])) <= 1e-4, i
        if i == 0:
            want = flax_state_dict(model, {"params": _np(jstate.params)})
            for name, p in model.named_parameters():
                diff = float(np.abs(p.detach().numpy() - want[name]).max())
                limit = 2.0 * cfg.learning_rate if name.endswith("mhsa.key.bias") else 1e-6
                assert diff <= limit, (name, diff)
    assert state.step == int(jstate.step) == 5


@pytest.mark.parametrize("over", [
    dict(method="attention"), dict(method="fft_bare"), dict(method="fft_mh"),
    dict(method="dwt_token"), dict(method="dwt_embed"),
    dict(mix_impl="gather"), dict(mix_impl="gather_unfused"), dict(mix_impl="structured"),
], ids=lambda o: "-".join(o.values()))
def test_spectre_vit_with_every_mixer_matches_jax_logits_and_loss(over):
    cfg = _spectre_cfg(**over)
    jm, v, model = _jax_and_port(cfg)
    (x, y), = _batches(cfg, 1, seed=5)
    want = jm.apply(v, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    want_loss = float(jax_cross_entropy_loss(want, jnp.asarray(y)))
    assert abs(cross_entropy_loss(got, torch.from_numpy(y)).item() - want_loss) <= 1e-4
    # the port's own seeded init has the flax tree's names and shapes
    fresh = build_model(cfg, "cpu")
    assert {k: tuple(t.shape) for k, t in fresh.state_dict().items()} == \
        {k: tuple(np.shape(a)) for k, a in flax_state_dict(fresh, v).items()}


def test_npz_round_trip_of_the_vit_and_structured_trees(tmp_path):
    for name, cfg in (("vit", _vit_cfg()),
                      ("structured", _spectre_cfg(mix_impl="structured"))):
        jm, v, _ = _jax_and_port(cfg)
        path = str(tmp_path / f"{name}.npz")
        save_npz(path, v)
        model = load_flax_variables(build_model(cfg, "cpu"), load_npz(path))
        (x, _), = _batches(cfg, 1, seed=2)
        with torch.inference_mode():
            got = model(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(jm.apply(v, jnp.asarray(x))), atol=1e-4,
                                   rtol=0)


def test_a_vit_or_structured_train_step_derives_no_table_and_attention_init():
    """Three optimizer steps leave the structured mix at its one derivation
    (which reads the tile table on the host); the attention's init is the
    packed-xavier bound for q/k/v, 1/sqrt(E) for out, zero biases."""
    cfg = tiny_export_cfg(mix_impl="structured", epochs=2)
    model = build_model(cfg, "cpu", train=True)
    optimizer, scheduler = make_optimizer(cfg, model.parameters(), STEPS_PER_EPOCH)
    state = create_train_state(model, optimizer, scheduler)
    step = make_train_step()
    losses = [float(step(state, torch.from_numpy(x), torch.from_numpy(y))["loss"])
              for x, y in _batches(cfg, 3)]
    assert all(np.isfinite(losses))
    mixes = [m for m in model.modules() if isinstance(m, MHPermutMix)]
    assert [m.table_derivations for m in mixes] == [1, 1]
    vit = build_model(_vit_cfg(), "cpu")
    attn = vit.encoder_0.self_attn.mhsa
    e = 32
    for proj in (attn.query, attn.key, attn.value):
        assert proj.kernel.abs().max() <= (1.5 / e) ** 0.5
        assert proj.kernel.abs().max() > 0.8 * (1.5 / e) ** 0.5
        assert not proj.bias.any()
    assert e ** -0.5 * 0.8 < attn.out.kernel.abs().max() <= e ** -0.5 and not attn.out.bias.any()
    assert not torch.equal(attn.query.kernel, attn.key.kernel)
    again = build_model(_vit_cfg(), "cpu")
    for (name, a), b in zip(vit.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), name


def test_bench_counts_flops_for_the_vit_and_refuses_what_it_does_not_count():
    """vit_cifar100's products per image, written out: the patch embedding,
    four layers of (four projections, q k^T and P v over 16 heads of 32, two
    Dense layers), the head."""
    cfg = parse_config(os.path.join(CONFIG_DIR, "vit_cifar100.py"))
    n, e, hd, heads, d = 65, 512, 768, 16, 32
    attention = heads * (2 * n * n * d * 2)
    layer = 4 * (2 * n * e * e) + attention + 2 * (2 * n * e * hd)
    want = 2 * 64 * 48 * e + 4 * layer + 2 * e * 100
    assert bench.forward_flops_per_image(cfg) == want == 992_063_488
    assert bench.train_flops_per_step(cfg, 256) == 3 * 256 * want
    for name in ("fnet_cifar100.py", "dwt_cifar100.py"):
        with pytest.raises(NotImplementedError, match="no FLOP count"):
            bench.forward_flops_per_image(parse_config(os.path.join(CONFIG_DIR, name)))
    cfg.model = "spectre_branch"
    with pytest.raises(NotImplementedError, match="spectre_branch"):
        bench.train_flops_per_step(cfg, 8)


# ---- through the entry points, on the CPU ---------------------------------------------------


@pytest.mark.parametrize("name", ["vit_mnist", "fnet_mnist"])
def test_train_cli_takes_two_steps_and_the_server_answers(name, tmp_path, capsys):
    """``repl/train.py``'s ``main`` at the config's own width with one layer
    (tests/test_torch_port_train.py starts the same entry point as a process)."""
    config = os.path.join(REPO_ROOT, "spectre_tpu_torch", "configs", f"{name}.py")
    result = train_cli.main([
        "--device", "cpu", "--config", config, "--synthetic", "--steps", "2", "--set",
        "num_encoders=1", "batch_size=16", "val_batch_size=512", f"checkpoint_dir={tmp_path}"])
    out = capsys.readouterr().out
    assert result.state.step == 2
    assert "epoch 1/5 step 2 train loss" in out
    assert np.isfinite(float(out.split("last train loss ")[1].split(",")[0]))
    logdir = out.strip().rsplit("-> ", 1)[1]
    assert os.path.exists(os.path.join(logdir, "ckpt", "step_00000002.pt"))

    cfg = parse_config(config)
    cfg.num_encoders = 1
    srv = from_config(cfg, "cpu", max_batch=8)
    try:
        port = srv.listen_tcp()
        x = np.random.default_rng(0).uniform(0, 1, (3, 1, 28, 28)).astype(np.float32)
        with SpectreClient(port=port) as c:
            got = c.infer(x)
        with torch.inference_mode():
            want = build_model(cfg, "cpu")(torch.from_numpy(
                np.concatenate([x, np.zeros((1, 1, 28, 28), np.float32)])))[:3].float().numpy()
    finally:
        srv.close()
    assert got.shape == (3, 10) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
