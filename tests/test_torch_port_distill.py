"""Distillation in the port (spectre_tpu_torch.distill, the teacher views in
.data.augment, distill_loss / make_distill_step in .train.step and
repl/distill.py) against the JAX package's, on the CPU in float32: the
same numpy inputs from a seed through both, the JAX teacher's variables
carried into the port's teacher by the weight bridge."""

import os
import signal
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import REPO_ROOT, tiny_export_cfg
from spectre_tpu.data import augment as jax_augment
from spectre_tpu.distill.loop import make_teacher_view as jax_make_teacher_view
from spectre_tpu.distill.teacher import DinoClassifier as JaxDinoClassifier
from spectre_tpu.distill.teacher import DinoVisionTransformer as JaxDinoViT
from spectre_tpu.distill.teacher import apply_rope as jax_apply_rope
from spectre_tpu.distill.teacher import import_torch_state_dict as jax_import_state_dict
from spectre_tpu.distill.teacher import rope_2d_angles as jax_rope_2d_angles
from spectre_tpu.models import build_model as jax_build_model
from spectre_tpu.ops.fused_mix import clear_mix_routes, register_block_mix_routes
from spectre_tpu.train.optim import make_optimizer as jax_make_optimizer
from spectre_tpu.train.state import create_train_state as jax_create_train_state
from spectre_tpu.train.step import distill_loss as jax_distill_loss
from spectre_tpu.train.step import make_distill_step as jax_make_distill_step
from spectre_tpu_torch import data
from spectre_tpu_torch.distill import (
    DinoClassifier,
    DinoVisionTransformer,
    distill_from_config,
    import_torch_state_dict,
    load_teacher,
    make_teacher_view,
    precompute_teacher_logits,
)
from spectre_tpu_torch.distill import loop as distill_loop
from spectre_tpu_torch.distill.teacher import apply_rope, rope_2d_angles
from spectre_tpu_torch.models import build_model, load_flax_variables
from spectre_tpu_torch.train import create_train_state, distill_loss, make_distill_step
from spectre_tpu_torch.train import make_optimizer

STEPS_PER_EPOCH = 6


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------- the views

@pytest.mark.parametrize("method,jax_method", [("bilinear", "linear"), ("bicubic", "cubic")])
@pytest.mark.parametrize("n_in,n_out", [(32, 224), (32, 256), (28, 32), (64, 32)])
def test_resize_matrices_are_jax_image_resize_of_the_identity(method, jax_method, n_in, n_out):
    want = np.asarray(jax.image.resize(jnp.eye(n_in), (n_out, n_in), method=jax_method))
    got = data.resize_matrix(n_in, n_out, method)
    assert got.shape == (n_out, n_in) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_resizes_and_center_crop_match_jax(rng):
    x = rng.uniform(0, 1, (2, 3, 32, 32)).astype(np.float32)
    xt = torch.from_numpy(x)
    pairs = [
        (data.resize_bilinear(xt, 224), jax_augment.resize_bilinear(jnp.asarray(x), 224)),
        (data.resize_separable(xt, 48, "bicubic"),
         jax_augment.resize_separable(jnp.asarray(x), 48, method="bicubic")),
        (data.resize_bicubic_pil(xt, 256), jax_augment.resize_bicubic_pil(jnp.asarray(x), 256)),
        (data.center_crop(data.resize_bicubic_pil(xt, 256), 224),
         jax_augment.center_crop(jax_augment.resize_bicubic_pil(jnp.asarray(x), 256), 224)),
        (data.center_crop(xt, 7), jax_augment.center_crop(jnp.asarray(x), 7)),  # odd margin
    ]
    for got, want in pairs:
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert data.resize_bilinear(xt, 32) is xt  # no resize at the input's own size


@pytest.mark.parametrize("mode", ["imagenet", "reference"])
@pytest.mark.parametrize("channels", [3, 1])
def test_teacher_views_match_jax(rng, mode, channels):
    x = rng.uniform(0, 1, (2, channels, 32, 32)).astype(np.float32)
    want = np.asarray(jax_make_teacher_view(224, in_ch=channels, mode=mode)(jnp.asarray(x)))
    got = make_teacher_view(224, in_ch=channels, mode=mode)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 3, 224, 224)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_teacher_view_refuses_what_it_does_not_take():
    with pytest.raises(ValueError, match="square"):
        make_teacher_view(224, mode="reference")(torch.zeros(1, 3, 32, 24))
    with pytest.raises(ValueError, match="teacher_view"):
        make_teacher_view(224, mode="bicubic")


# -------------------------------------------------------------- the teacher

@pytest.mark.parametrize("n_side,head_dim,periods", [(2, 16, None), (14, 64, None),
                                                     (3, 8, (0.5, 7.0))])
def test_rope_tables_and_rotation_match_jax(rng, n_side, head_dim, periods):
    jp = None if periods is None else jnp.asarray(periods, jnp.float32)
    want_cos, want_sin = jax_rope_2d_angles(n_side, head_dim, periods=jp)
    cos, sin = rope_2d_angles(n_side, head_dim, periods=periods)
    np.testing.assert_allclose(cos.numpy(), np.asarray(want_cos), rtol=0, atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(want_sin), rtol=0, atol=1e-6)
    t = rng.standard_normal((2, n_side * n_side, 3, head_dim)).astype(np.float32)
    want = jax_apply_rope(jnp.asarray(t), want_cos, want_sin)
    np.testing.assert_allclose(apply_rope(torch.from_numpy(t), cos, sin).numpy(),
                               np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_modules_rope_is_bitwise_apply_rope_on_the_patch_tokens(rng, dtype):
    """The attention rotates all tokens at once through tables that hold
    cos 1, sin 0 for the prefix and the pair signs in sin: the prefix comes
    out as it went in, the patches as ``apply_rope`` gives them, bit for bit."""
    from spectre_tpu_torch.distill.teacher import _rope_swapped, _rope_tables

    t = torch.from_numpy(rng.standard_normal((2, 5 + 16, 3, 8)).astype(np.float32)).to(dtype)
    cos, sin = rope_2d_angles(4, 8)
    c, s = _rope_tables(5, 4, 8, None, torch.device("cpu"), dtype)
    got = _rope_swapped(t, c, s)
    assert torch.equal(got[:, :5], t[:, :5])
    assert torch.equal(got[:, 5:], apply_rope(t[:, 5:], cos.to(dtype), sin.to(dtype)))


def _teachers(variant="v3", img_size=32, patch_size=16, embed_dim=32, depth=2, num_heads=2,
              num_registers=2, num_classes=7, seed=1):
    """(JAX classifier, its variables as numpy, the port's classifier holding
    them) for the same sizes; LayerScale raised to 0.5 so that the blocks
    matter."""
    sizes = dict(img_size=img_size, patch_size=patch_size, embed_dim=embed_dim, depth=depth,
                 num_heads=num_heads, num_registers=num_registers, variant=variant)
    jm = JaxDinoClassifier(backbone=JaxDinoViT(**sizes), num_classes=num_classes)
    variables = _np(jm.init(jax.random.key(seed), jnp.zeros((1, 3, img_size, img_size))))
    for i in range(depth):
        blk = variables["params"]["backbone"][f"block_{i}"]
        blk["ls1_gamma"] = np.full_like(blk["ls1_gamma"], 0.5)
        blk["ls2_gamma"] = np.full_like(blk["ls2_gamma"], 0.5)
    port = load_flax_variables(DinoClassifier(DinoVisionTransformer(**sizes), num_classes),
                               variables)
    return jm, variables, port.eval()


def _features_match(jm, variables, port, x, atol):
    want_logits, want_feats = jm.apply(variables, jnp.asarray(x), return_features=True)
    want = jm.backbone.apply({"params": variables["params"]["backbone"]}, jnp.asarray(x))
    with torch.no_grad():
        logits, feats = port(torch.from_numpy(x), return_features=True)
        got = port.backbone.forward_features(torch.from_numpy(x))
    assert set(got) == set(want) == {"x_norm_clstoken", "x_norm_regtokens",
                                     "x_norm_patchtokens"}
    for key in want:
        assert tuple(got[key].shape) == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=atol)
    np.testing.assert_allclose(feats.numpy(), np.asarray(want_feats), rtol=0, atol=atol)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=0, atol=atol)


@pytest.mark.parametrize("variant", ["v3", "v2"])
def test_tiny_teacher_matches_jax(rng, variant):
    """The JAX tests' tiny teacher: img 32, patch 16, E=32, depth 2, 2 heads,
    2 registers (4 patches + 3 prefix tokens)."""
    jm, variables, port = _teachers(variant)
    _features_match(jm, variables, port, rng.standard_normal((2, 3, 32, 32)).astype(np.float32),
                    1e-5)


def test_full_width_teacher_at_reduced_depth_matches_jax(rng):
    """ViT-S/16's widths at 224 px (E=384, 6 heads of 64, 4 registers, 201
    tokens), two blocks, B=2: features and logits within 1e-4."""
    jm, variables, port = _teachers("v3", img_size=224, embed_dim=384, depth=2, num_heads=6,
                                    num_registers=4, num_classes=100)
    x = rng.standard_normal((2, 3, 224, 224)).astype(np.float32)
    _features_match(jm, variables, port, x, 1e-4)


def test_port_teacher_init_draws_the_flax_distributions():
    """Seeded: the same seed gives the same teacher; kernels are lecun-normal
    over their fan-in, biases zero, tokens normal(0, 0.02), LayerScale 1e-5."""
    a = load_teacher(10, img_size=32, seed=3, embed_dim=64, depth=2, num_heads=4,
                     device="cpu")
    b = load_teacher(10, img_size=32, seed=3, embed_dim=64, depth=2, num_heads=4,
                     device="cpu")
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    assert not a.training and not any(p.requires_grad for p in a.parameters())
    bb = a.backbone
    assert torch.equal(bb.block_0.ls1_gamma, torch.full((64,), 1e-5))
    assert torch.equal(bb.block_1.attn.query.bias, torch.zeros(4, 16))
    for kernel, fan_in in ((bb.block_0.mlp.fc1.kernel, 64), (bb.block_1.attn.out.kernel, 64),
                           (bb.patch_embed.kernel, 3 * 16 * 16)):
        assert abs(kernel.std().item() * fan_in ** 0.5 - 1.0) < 0.1
        assert kernel.abs().max().item() <= 2.0 * fan_in ** -0.5 / 0.8796 + 1e-6
    assert abs(bb.cls_token.std().item() - 0.02) < 0.01


def _dinov3_state_dict(rng, depth, e, heads, regs, patch, periods=None):
    """A synthetic state_dict with dinov3_vits16's key names: fused qkv,
    storage_tokens, mask_token, ls{1,2}.gamma, rope_embed.periods, no
    pos_embed; every tensor distinct (the out projection not symmetric)."""
    def t(*shape):
        return rng.standard_normal(shape).astype(np.float32) * 0.05

    dh = e // heads
    if periods is None:
        periods = 100.0 ** (np.arange(dh // 4, dtype=np.float32) * 2.0 / (dh // 2))
    sd = {"cls_token": t(1, 1, e), "storage_tokens": t(1, regs, e), "mask_token": t(1, e),
          "rope_embed.periods": np.asarray(periods, np.float32),
          "patch_embed.proj.weight": t(e, 3, patch, patch), "patch_embed.proj.bias": t(e),
          "norm.weight": 1 + t(e), "norm.bias": t(e)}
    for i in range(depth):
        sd.update({
            f"blocks.{i}.norm1.weight": 1 + t(e), f"blocks.{i}.norm1.bias": t(e),
            f"blocks.{i}.norm2.weight": 1 + t(e), f"blocks.{i}.norm2.bias": t(e),
            f"blocks.{i}.attn.qkv.weight": t(3 * e, e), f"blocks.{i}.attn.qkv.bias": t(3 * e),
            f"blocks.{i}.attn.proj.weight": t(e, e), f"blocks.{i}.attn.proj.bias": t(e),
            f"blocks.{i}.mlp.fc1.weight": t(4 * e, e), f"blocks.{i}.mlp.fc1.bias": t(4 * e),
            f"blocks.{i}.mlp.fc2.weight": t(e, 4 * e), f"blocks.{i}.mlp.fc2.bias": t(e),
            f"blocks.{i}.ls1.gamma": t(e), f"blocks.{i}.ls2.gamma": t(e)})
    return sd


def test_state_dict_import_matches_the_jax_import_value_by_value(rng):
    """The port's import against the bridge of the JAX import of the same
    DINOv3-layout state_dict: every parameter equal (the out projection's
    values too, which a transposed square matrix would pass by shape), no
    key unused, and the same forward."""
    sd = _dinov3_state_dict(rng, depth=2, e=48, heads=4, regs=4, patch=8)
    sizes = dict(img_size=16, patch_size=8, embed_dim=48, depth=2, num_heads=4,
                 num_registers=4, variant="v3")
    jbb = JaxDinoViT(**sizes)
    params = jbb.init(jax.random.key(0), jnp.zeros((1, 3, 16, 16)))["params"]
    jparams, junused = jax_import_state_dict(jbb, params, sd)
    want = load_flax_variables(DinoVisionTransformer(**sizes), {"params": _np(jparams)})
    port = DinoVisionTransformer(**sizes)
    assert import_torch_state_dict(port, sd) == junused == []
    for (name, got), ref in zip(port.state_dict().items(), want.state_dict().values()):
        assert torch.equal(got, ref), name
    w = sd["blocks.1.attn.proj.weight"]
    assert torch.equal(port.block_1.attn.out.kernel, torch.from_numpy(w.T.reshape(4, 12, 48)))
    x = rng.standard_normal((2, 3, 16, 16)).astype(np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(x))["x_norm_clstoken"].numpy()
    np.testing.assert_allclose(
        got, np.asarray(jbb.apply({"params": jparams}, jnp.asarray(x))["x_norm_clstoken"]),
        rtol=0, atol=1e-5)


def test_state_dict_import_checks_rope_periods_and_reports_unused_keys(rng, tmp_path):
    sd = _dinov3_state_dict(rng, depth=1, e=48, heads=4, regs=4, patch=8,
                            periods=np.geomspace(0.3, 7.0, 3))
    port = load_teacher(10, img_size=16, patch_size=8, embed_dim=48, depth=1,
                        num_heads=4, device="cpu").backbone
    before = {k: v.clone() for k, v in port.state_dict().items()}
    with pytest.raises(ValueError, match="rope_embed.periods"):
        import_torch_state_dict(port, sd)
    for k, v in port.state_dict().items():  # nothing was loaded
        assert torch.equal(v, before[k]), k
    extra = dict(sd, **{"head.weight": np.zeros((3, 48), np.float32),
                        "blocks.0.mlp.fc1.bias": np.zeros(7, np.float32)})  # wrong shape
    del extra["rope_embed.periods"]
    assert import_torch_state_dict(port, extra) == ["blocks.0.mlp.fc1.bias", "head.weight"]
    # load_teacher builds the model around the checkpoint's periods
    path = str(tmp_path / "teacher.npz")
    np.savez(path, **sd)
    clf = load_teacher(10, img_size=16, weights_path=path, patch_size=8, embed_dim=48, depth=1,
                       num_heads=4, device="cpu")
    np.testing.assert_allclose(clf.backbone.rope_periods, sd["rope_embed.periods"], rtol=1e-6)
    assert torch.equal(clf.backbone.norm.weight, torch.from_numpy(sd["norm.weight"]))


# ----------------------------------------------------------- loss and step

def test_distill_loss_matches_jax(rng):
    s = rng.standard_normal((16, 10)).astype(np.float32) * 3
    t = rng.standard_normal((16, 10)).astype(np.float32) * 3
    y = rng.integers(0, 10, 16).astype(np.int32)
    for temp, kd_w, ce_w in ((2.0, 0.25, 0.75), (4.0, 0.5, 0.5)):
        want, wparts = jax_distill_loss(jnp.asarray(s), jnp.asarray(t), jnp.asarray(y), temp,
                                        kd_w, ce_w)
        got, parts = distill_loss(torch.from_numpy(s), torch.from_numpy(t),
                                  torch.from_numpy(y), temp, kd_w, ce_w)
        assert abs(float(got) - float(want)) <= 1e-6
        for k in ("loss_dist", "loss_ce"):
            assert abs(float(parts[k]) - float(wparts[k])) <= 1e-6, k
    # bf16 logits: the softmaxes still run in float32
    got, _ = distill_loss(torch.from_numpy(s).bfloat16(), torch.from_numpy(t).bfloat16(),
                          torch.from_numpy(y))
    assert got.dtype == torch.float32


def test_distill_steps_match_jax():
    """Parameters after one step within 1e-6, the loss (and KD, CE) at each
    of 5 steps within 1e-4: the same weights, batches and teacher logits,
    dropout 0, no augmentation, fast_rng off, a global-norm clip."""
    cfg = tiny_export_cfg(mix_impl="folded", mix_block=8, epochs=2, grad_clip_norm=0.05)
    jm = jax_build_model(cfg)
    jstate = jax_create_train_state(jm, jax_make_optimizer(cfg, STEPS_PER_EPOCH),
                                    jnp.zeros((1, 3, 8, 8)), seed=0)
    model = build_model(cfg, "cpu", train=True)
    load_flax_variables(model, _np({"params": jstate.params, "buffers": jstate.buffers}))
    state = create_train_state(model, *make_optimizer(cfg, model.parameters(), STEPS_PER_EPOCH),
                               seed=0)
    rng = np.random.default_rng(0)
    register_block_mix_routes(jstate.variables())
    try:
        jstep = jax_make_distill_step(jm, fast_rng=False)
        step = make_distill_step(grad_clip_norm=cfg.grad_clip_norm)
        for i in range(5):
            x = rng.uniform(0, 1, (8, 3, 8, 8)).astype(np.float32)
            t = rng.standard_normal((8, 10)).astype(np.float32) * 2
            y = rng.integers(0, 10, 8).astype(np.int32)
            jstate, jm_ = jstep(jstate, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y))
            m = step(state, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y))
            for k in ("loss", "loss_dist", "loss_ce"):
                assert abs(float(m[k]) - float(jm_[k])) <= 1e-4, (i, k)
            assert float(m["accuracy"]) == float(jm_["accuracy"])
            if i == 0:
                want = dict(load_flax_variables(
                    build_model(cfg, "cpu"),
                    _np({"params": jstate.params, "buffers": jstate.buffers})).named_parameters())
                for name, p in state.model.named_parameters():
                    diff = (p.detach() - want[name].detach()).abs().max().item()
                    assert diff <= 1e-6, (name, diff)
    finally:
        clear_mix_routes()
    assert state.step == int(jstate.step) == 5


# ----------------------------------------------------------------- the loop

def _distill_cfg(tmp_path, **over):
    cfg = SimpleNamespace(
        model="spectre_vit", method="permut_mix", mix_impl="folded", mix_block=8,
        dataset="mnist", img_size=8, patch_size=4, in_channels=1, num_classes=10,
        embed_dim=16, num_encoders=1, num_heads=2, hidden_dim=32, dropout=0.0, batch_size=8,
        val_batch_size=128, epochs=1, learning_rate=1e-3, random_seed=0,
        compute_dtype="float32", param_dtype="float32", checkpoint_dir=str(tmp_path),
        log_every=2)
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


def _tiny_teacher():
    return load_teacher(10, img_size=16, seed=1, embed_dim=32, depth=2, num_heads=2,
                        num_registers=2, device="cpu")


def test_precompute_teacher_logits_pads_the_last_chunk_and_equals_the_direct_call(rng):
    teacher = _tiny_teacher()
    x = rng.uniform(0, 1, (10, 3, 16, 16)).astype(np.float32)
    shapes = []

    def fn(raw):
        shapes.append(tuple(raw.shape))
        with torch.inference_mode():
            return teacher(raw).clone()

    cached = precompute_teacher_logits(fn, x, 4, 10, "cpu")
    assert shapes == [(4, 3, 16, 16)] * 3  # 4 + 4 + 2 rows padded to 4
    direct = torch.cat([fn(torch.from_numpy(x[i:i + 4]))[:len(x[i:i + 4])]
                        for i in range(0, 10, 4)])
    assert cached.dtype == torch.float32 and torch.equal(cached, direct)


def test_the_loop_runs_the_jax_teacher_it_is_given(tmp_path):
    """``teacher_variables`` (the JAX teacher's) go into the port's teacher:
    the cached logits are the JAX teacher's on the same view."""
    jm, variables, port = _teachers("v3", img_size=16, num_classes=10)
    cfg = _distill_cfg(tmp_path, batch_size=64)
    captured = {}
    real = distill_loop.precompute_teacher_logits

    def spy(fn, images, *args):
        out = real(fn, images, *args)
        captured["x"], captured["out"] = images[:8], out[:8]  # a chunk's first rows
        return out

    distill_loop.precompute_teacher_logits = spy
    try:
        r = distill_from_config(cfg, device="cpu", max_steps=2, synthetic=True,
                                teacher=DinoClassifier(DinoVisionTransformer(
                                    img_size=16, patch_size=16, embed_dim=32, depth=2,
                                    num_heads=2, num_registers=2), 10),
                                teacher_variables=variables, checkpoint=False,
                                write_metrics=False, cache_teacher=True)
    finally:
        distill_loop.precompute_teacher_logits = real
    assert r.state.step == 2 and np.isfinite(r.metrics["loss"])
    view = jax_make_teacher_view(16, in_ch=1)
    want = jm.apply(variables, view(jnp.asarray(captured["x"])))
    np.testing.assert_allclose(captured["out"].numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_cache_on_and_recompute_give_the_same_loss_sequence_bit_for_bit(tmp_path):
    runs = {}
    for cache in (True, False):
        runs[cache] = distill_from_config(
            _distill_cfg(tmp_path / str(cache)), device="cpu", max_steps=3, synthetic=True,
            teacher=_tiny_teacher(), checkpoint=False, write_metrics=False, cache_teacher=cache)
    assert (runs[True].cache_seconds is not None) and runs[False].cache_seconds is None
    assert [s for s, *_ in runs[True].batch_losses] == [1, 2, 3]
    assert runs[True].batch_losses == runs[False].batch_losses
    assert runs[True].metrics == runs[False].metrics


def _assert_states_bitwise_equal(a, b):
    assert a.step == b.step
    for (k, va), vb in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(va, vb), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    for i, moments in oa["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(moments[k], ob["state"][i][k]), (i, k)
    assert a.scheduler.state_dict() == b.scheduler.state_dict()
    assert torch.equal(a.dropout_generator.get_state(), b.dropout_generator.get_state())


def test_mid_epoch_resume_is_bitwise_the_uninterrupted_run(tmp_path):
    """A run stopped at step 3 (mid-epoch; validated and checkpointed there)
    and resumed to step 6 against one run to step 6, the dataset's
    augmentation and the teacher cache on: the same state and the same
    losses for steps 4 to 6, bit for bit."""
    over = dict(batch_size=256, epochs=2)  # 16 steps an epoch
    kw = dict(device="cpu", synthetic=True, write_metrics=False, cache_teacher=True)
    whole = distill_from_config(_distill_cfg(tmp_path / "whole", **over), max_steps=6,
                                teacher=_tiny_teacher(), checkpoint=False, **kw)
    cfg = _distill_cfg(tmp_path / "parts", **over)
    first = distill_from_config(cfg, max_steps=3, teacher=_tiny_teacher(), **kw)
    assert first.state.step == 3
    second = distill_from_config(cfg, max_steps=6, teacher=_tiny_teacher(), resume=True, **kw)
    _assert_states_bitwise_equal(second.state, whole.state)
    assert second.batch_losses == whole.batch_losses[3:]


def test_sigterm_saves_without_validating_and_the_checkpoint_resumes(tmp_path, monkeypatch):
    real = distill_loop.prefetch_to_device
    seen = []

    def previous_handler(signum, frame):
        seen.append(signum)

    def prefetch_and_preempt(it, device, **kw):
        for i, b in enumerate(real(it, device, **kw)):
            yield b
            if i == 1:
                os.kill(os.getpid(), signal.SIGTERM)

    cfg = _distill_cfg(tmp_path, epochs=50, batch_size=64)
    old = signal.signal(signal.SIGTERM, previous_handler)
    try:
        monkeypatch.setattr(distill_loop, "prefetch_to_device", prefetch_and_preempt)
        r = distill_from_config(cfg, device="cpu", synthetic=True, teacher=_tiny_teacher(),
                                write_metrics=False)
        monkeypatch.setattr(distill_loop, "prefetch_to_device", real)
        assert signal.getsignal(signal.SIGTERM) is previous_handler
        assert seen == []
    finally:
        signal.signal(signal.SIGTERM, old)
    # the flag is seen after the step that follows the signal; no validation pass
    assert r.state.step == 3 and r.last_val_accuracy == -1.0
    again = distill_from_config(cfg, device="cpu", synthetic=True, teacher=_tiny_teacher(),
                                write_metrics=False, resume=True, max_steps=4)
    assert again.state.step == 4


def test_fsdp_is_refused_with_a_pointer(tmp_path):
    """``fsdp=True`` is no longer refused (parallel/ is ported): in a plain
    process the loop makes a process group of its own, shards the student
    over its one rank, and leaves no group behind; the losses equal the
    unwrapped run's, bit for bit (one rank issues no collective)."""
    runs = [distill_from_config(_distill_cfg(tmp_path / str(fsdp), fsdp=fsdp), device="cpu",
                                synthetic=True, teacher=_tiny_teacher(), max_steps=2,
                                write_metrics=False, checkpoint=False)
            for fsdp in (True, False)]
    assert runs[0].state.layout.kind == "fsdp" and runs[1].state.layout is None
    assert not torch.distributed.is_initialized()
    assert runs[0].batch_losses == runs[1].batch_losses


# ------------------------------------------------------------------ the CLIs

TINY = ["--config", "spectre_tpu_torch/configs/distill_cifar100.py", "--synthetic",
        "--steps", "2", "--teacher-size", "32", "--set", "num_encoders=1", "embed_dim=64",
        "num_heads=2", "hidden_dim=64", "batch_size=16", "val_batch_size=512",
        "teacher_depth=1", "teacher_embed_dim=32", "teacher_num_heads=2",
        "teacher_num_registers=2"]


def test_distill_cli_runs_on_the_cpu_and_refuses_cuda_without_a_card(tmp_path):
    def cli(*args):
        return subprocess.run([sys.executable, "-m", "spectre_tpu_torch.repl.distill", *args,
                               f"checkpoint_dir={tmp_path}"], cwd=REPO_ROOT,
                              capture_output=True, text=True, timeout=300)

    r = cli("--device", "cpu", *TINY)
    assert r.returncode == 0, r.stderr
    assert "distill epoch 1/100 step 2" in r.stdout and "distill done: step 2" in r.stdout
    assert os.path.isdir(os.path.join(r.stdout.split("-> ")[-1].strip(), "ckpt"))
    if not torch.cuda.is_available():
        r = cli("--device", "cuda", *TINY)
        assert r.returncode != 0 and "torch.cuda.is_available() is False" in r.stderr
