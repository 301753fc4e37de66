"""SpectreBranch in the port (spectre_tpu_torch/models/spectre_branch.py, its
config, the registry, the init, the weight bridge, the bench's FLOP count)
against the JAX package on the CPU in float32: the same weights
(initialised in JAX, carried over by the weight bridge), the same numpy
batches, dropout 0, no augmentation, ``fast_rng=False``. Then the entry
points, on synthetic data. The topology is shrunk: 16x16x3 images in 4x4
patches (17 tokens), E=24, 2 heads, hidden 16, 2 encoders.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_export_cfg
from spectre_tpu.configs import parse_config as jax_parse_config
from spectre_tpu.models import build_model as jax_build_model
from spectre_tpu.models.spectre_branch import (
    rfft2_log_magnitude_matmul as jax_rfft2_log_magnitude,
)
from spectre_tpu.train.optim import make_optimizer as jax_make_optimizer
from spectre_tpu.train.state import TrainState as JaxTrainState
from spectre_tpu.train.step import cross_entropy_loss as jax_cross_entropy_loss
from spectre_tpu.train.step import make_train_step as jax_make_train_step
from spectre_tpu_torch.configs import CONFIG_DIR, parse_config
from spectre_tpu_torch.models import (
    Conv,
    SpectreBranch,
    build_model,
    flax_state_dict,
    load_flax_variables,
    rfft2_log_magnitude_matmul,
)
from spectre_tpu_torch.ops.kernels import launch_counts
from spectre_tpu_torch.repl import bench
from spectre_tpu_torch.repl import train as train_cli
from spectre_tpu_torch.serving import SpectreClient, from_config
from spectre_tpu_torch.train import (
    create_train_state,
    cross_entropy_loss,
    make_optimizer,
    make_train_step,
)

JAX_CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "spectre_tpu", "configs")
STEPS_PER_EPOCH = 6


def _np(tree):
    return jax.tree.map(np.array, tree)


def _cfg(**over):
    return tiny_export_cfg(**(dict(model="spectre_branch", img_size=16, patch_size=4,
                                   embed_dim=24, num_heads=2, hidden_dim=16, num_encoders=2,
                                   mix_impl="folded", epochs=2) | over))


def _batches(cfg, n, b=8, seed=0):
    rng = np.random.default_rng(seed)
    size = cfg.img_size
    return [(rng.uniform(0, 1, (b, 3, size, size)).astype(np.float32),
             rng.integers(0, cfg.num_classes, b).astype(np.int32)) for _ in range(n)]


_JAX_MODELS = {}


def _jax_and_port(cfg, seed=1):
    """The JAX model with its variables (made once per config for the file)
    and a new port model carrying them. The JAX side is jitted: op by op,
    this model's init alone takes some 25 s of this CPU."""
    key = (seed, *sorted(vars(cfg).items(), key=lambda kv: kv[0]))
    if key not in _JAX_MODELS:
        jm = jax_build_model(cfg)
        size = cfg.img_size
        v = jax.jit(jm.init)(jax.random.key(seed), jnp.zeros((1, 3, size, size)))
        _JAX_MODELS[key] = jm, _np(v)
    jm, v = _JAX_MODELS[key]
    return jm, v, load_flax_variables(build_model(cfg, "cpu"), v)


def _jax_logits(jm, v, x, **kw):
    return jax.jit(lambda vv, xx: jm.apply(vv, xx, **kw))(v, jnp.asarray(x))


@pytest.mark.parametrize("over", [dict(), dict(mix_impl="gather"), dict(method=None)],
                         ids=["folded", "gather", "no-mix"])
def test_branch_logits_and_features_match_jax(over):
    cfg = _cfg(**over)
    jm, v, model = _jax_and_port(cfg)
    assert isinstance(model, SpectreBranch)
    assert (over.get("method", "permut_mix") is None) == \
        ("mix_layer" not in v["params"]["encoder_blocks"]["layer_0"])
    (x, _), = _batches(cfg, 1)
    want, want_feat = _jax_logits(jm, v, x, return_features=True)
    with torch.inference_mode():
        got, feat = model(torch.from_numpy(x), return_features=True)
    assert got.dtype == torch.float32 and got.shape == (8, cfg.num_classes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    np.testing.assert_allclose(feat.numpy(), np.asarray(want_feat), atol=1e-4, rtol=0)


def test_log_magnitude_spectrum_and_features_match_jax():
    """The DFT-product spectrum (against JAX's and against torch.fft) and the
    feature extractor's per-stage features and last activations (NHWC)."""
    x = np.random.default_rng(4).uniform(0, 1, (3, 3, 16, 12)).astype(np.float32)
    got = rfft2_log_magnitude_matmul(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_rfft2_log_magnitude(jnp.asarray(x))),
                               atol=1e-5, rtol=0)
    want = torch.log1p(torch.fft.rfft2(torch.from_numpy(x)).abs())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    cfg = _cfg()
    jm, v, model = _jax_and_port(cfg)
    from spectre_tpu.models.spectre_branch import SpectreFeatExtractor as JaxFeat
    jf = JaxFeat(in_channels=3, embed_dim=24, num_tokens=17, num_stages=2)
    fv = {"params": v["params"]["encoder_blocks"]["spectre_branch"]}
    (img, _), = _batches(cfg, 1, b=3)
    want_h, want_feats = jax.jit(jf.apply)(fv, jnp.asarray(img))
    with torch.no_grad():
        h, feats = model.encoder_blocks.spectre_branch(torch.from_numpy(img))
    assert h.shape == want_h.shape == (3, 12, 5, 27) and len(feats) == 2
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=1e-5, rtol=0)
    for a, b in zip(feats, want_feats):
        assert a.shape == b.shape == (3, 17, 24)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)


def test_branch_loss_and_every_gradient_match_jax_by_name():
    cfg = _cfg()
    jm, v, model = _jax_and_port(cfg)
    model.train()
    (x, y), = _batches(cfg, 1, seed=3)

    def loss_fn(params):
        logits = jm.apply({"params": params, "buffers": v["buffers"]}, jnp.asarray(x))
        return jax_cross_entropy_loss(logits, jnp.asarray(y))

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(v["params"])
    loss = cross_entropy_loss(model(torch.from_numpy(x)), torch.from_numpy(y))
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= 1e-5
    want = flax_state_dict(model, {"params": _np(want_grads)})
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(want)
    assert "encoder_blocks.spectre_branch.stage_1.kernel" in names
    for name, p in model.named_parameters():
        ref = np.asarray(want[name])
        scale = max(float(np.abs(ref).max()), 1e-30)
        assert p.grad.shape == ref.shape, name
        assert float(np.abs(p.grad.numpy() - ref).max()) <= 1e-4 * scale, name


def test_branch_adamw_step_and_loss_curve_match_jax():
    """Parameters after one AdamW step within 1e-6, the loss at each of 10
    steps within 1e-4 (the tolerances of the ViT tests)."""
    cfg = _cfg()
    jm, v, _ = _jax_and_port(cfg)
    tx = jax_make_optimizer(cfg, STEPS_PER_EPOCH)
    # spectre_tpu.train.state.create_train_state, with the jitted init's
    # variables in place of its op-by-op init
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                           buffers=v["buffers"], opt_state=tx.init(v["params"]),
                           rng=jax.random.key(0), tx=tx)
    model = build_model(cfg, "cpu", train=True)
    load_flax_variables(model, _np({"params": jstate.params, "buffers": jstate.buffers}))
    optimizer, scheduler = make_optimizer(cfg, model.parameters(), STEPS_PER_EPOCH)
    state = create_train_state(model, optimizer, scheduler, seed=0)
    jstep = jax_make_train_step(jm, augment_fn=None, fast_rng=False)
    step = make_train_step()
    for i, (x, y) in enumerate(_batches(cfg, 10)):
        jstate, jmetrics = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        metrics = step(state, torch.from_numpy(x), torch.from_numpy(y))
        assert abs(float(metrics["loss"]) - float(jmetrics["loss"])) <= 1e-4, i
        if i == 0:
            want = flax_state_dict(model, {"params": _np(jstate.params)})
            for name, p in model.named_parameters():
                diff = float(np.abs(p.detach().numpy() - want[name]).max())
                assert diff <= 1e-6, (name, diff)
    assert state.step == int(jstate.step) == 10


def test_bridge_maps_every_leaf_of_the_branch_tree_by_value():
    """Every flax leaf lands, unchanged, on the port tensor of the same name:
    the conv kernels in their [kH, kW, I, O] layout, the Denses' [in, out],
    LayerNorm scale -> weight, the mix tables -> perms and signs. A conv
    kernel with its spatial axes swapped, or a transposed square Dense
    (linear2 is [16, 16]), passes every shape check and changes the logits."""
    cfg = _cfg()
    jm, v, model = _jax_and_port(cfg)
    sd = model.state_dict()
    mapped = flax_state_dict(model, v)
    assert sorted(mapped) == sorted(sd)
    for name, leaf in mapped.items():
        np.testing.assert_array_equal(sd[name].numpy(), np.asarray(leaf), err_msg=name)
    enc = "encoder_blocks."
    assert sd[enc + "spectre_branch.stage_0.kernel"].shape == (3, 3, 3, 9)
    assert sd[enc + "spectre_branch.project_1.kernel"].shape == (1, 1, 27, 24)
    assert sd[enc + "layer_1.norm2.weight"].shape == (24,)
    assert sd[enc + "layer_0.mix_layer.perms"].dtype == torch.int32
    assert sd[enc + "spectre_project_0.kernel"].shape == (48, 24)
    (x, _), = _batches(cfg, 1, seed=6)
    want = np.asarray(_jax_logits(jm, v, x))
    with torch.no_grad():
        np.testing.assert_allclose(model(torch.from_numpy(x)).numpy(), want, atol=1e-4, rtol=0)
    for path, change in (
            (("encoder_blocks", "spectre_branch", "stage_0", "kernel"),
             lambda k: k.transpose(1, 0, 2, 3).copy()),
            (("encoder_blocks", "layer_0", "linear2", "kernel"), lambda k: k.T.copy())):
        bad = _np(v)
        node = bad["params"]
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = change(node[path[-1]])
        with torch.no_grad():
            got = load_flax_variables(build_model(cfg, "cpu"), bad)(torch.from_numpy(x))
        assert np.abs(got.numpy() - want).max() > 1e-3, path


def test_conv_init_bounds_and_a_seeded_build():
    """The conv kernels draw U(+-1/sqrt(kH*kW*I)), the biases U(+-1/sqrt of the
    fan-in JAX passes: I*9 for a 3x3 stage, I for a 1x1 projection); the
    same seed builds the same weights."""
    cfg = parse_config(os.path.join(CONFIG_DIR, "spectre_branch.py"))
    cfg.num_encoders, cfg.compute_dtype = 2, "float32"
    model = build_model(cfg, "cpu")
    convs = {n: m for n, m in model.named_modules() if isinstance(m, Conv)}
    assert sorted(convs) == ["encoder_blocks.spectre_branch.project_0",
                             "encoder_blocks.spectre_branch.project_1",
                             "encoder_blocks.spectre_branch.stage_0",
                             "encoder_blocks.spectre_branch.stage_1"]
    for name, conv in convs.items():
        kh, kw, i, o = conv.kernel.shape
        bound = (kh * kw * i) ** -0.5
        assert 0.9 * bound < conv.kernel.abs().max() <= bound, name
        assert conv.bias.abs().max() <= conv.bias_fan_in ** -0.5, name
        assert conv.bias_fan_in == kh * kw * i, name
    again = build_model(cfg, "cpu")
    for (name, a), b in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), name


def test_branch_config_parses_to_the_jax_namespace_and_builds_at_full_width():
    want = vars(jax_parse_config(os.path.join(JAX_CONFIGS, "spectre_branch.py")))
    got = vars(parse_config(os.path.join(CONFIG_DIR, "spectre_branch.py")))
    assert got == want
    assert (got["embed_dim"], got["num_heads"], got["hidden_dim"], got["num_encoders"]) == \
        (768, 8, 256, 4)
    assert "mix_routed" not in got and got["mix_impl"] == "folded"


def test_bench_counts_the_branchs_flops():
    """spectre_branch.py's products per image, written out: the patch
    embedding; per layer the folded mix product and its grouped pool,
    linear1/2/3 and the fusion; per stage both convolutions and the pool to
    65 tokens (a product: 450, 364, 286, 216 positions); the DFT products;
    the head."""
    cfg = parse_config(os.path.join(CONFIG_DIR, "spectre_branch.py"))
    n, e, h, hd = 65, 768, 8, 256
    layer = 2 * n * (e * h) * e + n * e * h + 2 * n * e * hd + 2 * n * hd * hd \
        + 2 * n * hd * e + 2 * n * 2 * e * e
    stages, c = 0, 3
    for hw in (30 * 15, 28 * 13, 26 * 11, 24 * 9):
        stages += 2 * hw * 9 * c * 3 * c + 2 * hw * 3 * c * e + 2 * e * hw * n
        c *= 3
    dft = 2 * (2 * 3 * 32 * 32 * 32) + 4 * (2 * 3 * 32 * 32 * 17)
    want = 2 * 64 * 48 * e + 4 * layer + stages + dft + 2 * e * 100
    assert bench.forward_flops_per_image(cfg) == want
    assert bench.train_flops_per_step(cfg, 256) == 3 * 256 * want
    cfg.method = "attention"
    with pytest.raises(NotImplementedError, match="no FLOP count"):
        bench.forward_flops_per_image(cfg)


def test_train_cli_takes_two_steps_and_the_server_answers(tmp_path, capsys, monkeypatch):
    """``repl/train.py``'s ``main`` on spectre_branch.py, narrowed on the
    command line to one layer of E=48 with 2 heads (d = 65 x 48 = 3,120:
    c = 16), with the routed mix backward, then the server on the same
    config: replies within 1e-4 of a direct forward of the padded bucket."""
    from spectre_tpu_torch.ops import routing
    monkeypatch.setattr(routing, "ROUTE_CACHE_DIR", str(tmp_path / "routes"))
    config = os.path.join(CONFIG_DIR, "spectre_branch.py")
    narrow = ["num_encoders=1", "embed_dim=48", "num_heads=2", "hidden_dim=32"]
    before = launch_counts()
    result = train_cli.main([
        "--device", "cpu", "--config", config, "--synthetic", "--steps", "2", "--set",
        *narrow, "batch_size=16", "val_batch_size=512", f"checkpoint_dir={tmp_path}",
        "mix_routed=True", "mix_routed_impl=pallas"])
    out = capsys.readouterr().out
    assert result.state.step == 2 and "mix routes registered: 1" in out
    assert "model=spectre_branch" in out
    assert np.isfinite(float(out.split("last train loss ")[1].split(",")[0]))
    assert launch_counts() == before  # the CPU runs the plain versions

    from spectre_tpu_torch.configs import apply_overrides
    cfg = apply_overrides(parse_config(config), narrow)
    srv = from_config(cfg, "cpu", max_batch=8)
    try:
        port = srv.listen_tcp()
        x = np.random.default_rng(0).uniform(0, 1, (3, 3, 32, 32)).astype(np.float32)
        with SpectreClient(port=port) as c:
            got = c.infer(x)
        with torch.inference_mode():
            want = build_model(cfg, "cpu")(torch.from_numpy(
                np.concatenate([x, np.zeros((1, 3, 32, 32), np.float32)])))[:3].float().numpy()
    finally:
        srv.close()
    assert got.shape == (3, 100) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
