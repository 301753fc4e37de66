"""The port's shared helpers and utilities against the JAX package's:
``configs.config_to_dict``, ``models.registry.example_input`` and
``ops.fft.patch_rfft2_real`` for every config copy; ``utils/debug.py``
(``deterministic_mode``, ``enable_nan_checks``, ``check_finite``) and
``utils/summary.py`` (``model_summary``'s parameter and buffer counts for
the 8 trainable configs at a small width, its FLOP count, ``format_summary``)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectre_tpu.configs import config_to_dict as jax_config_to_dict
from spectre_tpu.configs import parse_config as jax_parse_config
from spectre_tpu.models import build_model as jax_build_model
from spectre_tpu.models.registry import example_input as jax_example_input
from spectre_tpu.ops.fft import patch_rfft2_real as jax_patch_rfft2_real
from spectre_tpu.utils import format_summary as jax_format_summary
from spectre_tpu.utils import model_summary as jax_model_summary
from spectre_tpu_torch.configs import CONFIG_DIR, apply_overrides, config_to_dict, parse_config
from spectre_tpu_torch.models import build_model, example_input
from spectre_tpu_torch.ops import patch_rfft2_real
from spectre_tpu_torch.repl.bench import forward_flops_per_image
from spectre_tpu_torch.utils.debug import check_finite, deterministic_mode, enable_nan_checks
from spectre_tpu_torch.utils.summary import format_summary, model_summary

JAX_CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "spectre_tpu", "configs")
CONFIG_FILES = sorted(n for n in os.listdir(CONFIG_DIR)
                      if n.endswith(".py") and n not in ("__init__.py", "parser.py"))
TRAINABLE = ("spectre_vit_cifar100", "spectre_vit_mnist", "vit_cifar100", "vit_mnist",
             "fnet_cifar100", "fnet_mnist", "dwt_cifar100", "spectre_branch")
SMALL = ["num_encoders=2", "embed_dim=32", "num_heads=2", "hidden_dim=48", "mix_block=8",
         "compute_dtype='float32'"]


@pytest.mark.parametrize("name", CONFIG_FILES)
def test_config_to_dict_and_example_input_equal_jaxs(name):
    port = parse_config(os.path.join(CONFIG_DIR, name))
    ref = jax_parse_config(os.path.join(JAX_CONFIG_DIR, name))
    got, want = config_to_dict(port), jax_config_to_dict(ref)
    assert got == want
    got["learning_rate"] = -1  # a copy, not the namespace's own dict
    assert port.learning_rate == want["learning_rate"]
    if not hasattr(port, "img_size"):  # default.py holds no model
        return
    for b in (None, 3):
        x = example_input(port, b, device="cpu")
        want_x = np.asarray(jax_example_input(ref, b))
        assert x.dtype == torch.float32 and x.device.type == "cpu"
        assert tuple(x.shape) == want_x.shape
        np.testing.assert_array_equal(x.numpy(), want_x)


@pytest.mark.parametrize("patch", [2, 4, 8])
def test_patch_rfft2_real_matches_jax(patch):
    x = np.random.default_rng(patch).standard_normal((2, 3, 16, 16)).astype(np.float32)
    got = patch_rfft2_real(torch.from_numpy(x), patch).numpy()
    want = np.asarray(jax_patch_rfft2_real(jnp.asarray(x), patch))
    assert got.shape == want.shape == (2, 3, (16 // patch) ** 2, patch, patch // 2 + 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_deterministic_mode_pins_precision_and_restores_it():
    before = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    try:
        torch.set_float32_matmul_precision("high")
        torch.backends.cudnn.allow_tf32 = True
        deterministic_mode(True)
        assert torch.get_float32_matmul_precision() == "highest"
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        deterministic_mode(True)  # twice on, once off: the first state comes back
        deterministic_mode(False)
        assert torch.get_float32_matmul_precision() == "high"
        assert torch.backends.cudnn.allow_tf32
        deterministic_mode(False)  # nothing saved: no change
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(before[0])
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before[1:]


def test_nan_checks_name_the_module_then_remove_themselves():
    cfg = apply_overrides(parse_config(os.path.join(CONFIG_DIR, "spectre_vit_cifar100.py")),
                          SMALL + ["img_size=8"])
    model = build_model(cfg, "cpu")
    x = example_input(cfg, 2, device="cpu").uniform_()

    def poison(module, args):
        y = args[0].clone()
        y[0, 0, 0] = float("nan")
        return (y,)

    target = model.encoder_blocks.layer_1.linear1
    handle = target.register_forward_pre_hook(poison)
    try:
        enable_nan_checks(True)
        assert torch.is_anomaly_enabled()
        with torch.no_grad(), pytest.raises(FloatingPointError,
                                            match=r"SpectreViT\.encoder_blocks\.layer_1\.linear1$"):
            model(x)
        with torch.no_grad():  # a clean input after a raise: no stale path, no raise
            handle.remove()
            assert torch.isfinite(model(x)).all()
            handle = target.register_forward_pre_hook(poison)
    finally:
        enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()
    with torch.no_grad():
        assert torch.isnan(model(x)).any()  # the hooks are gone: NaNs pass through
    handle.remove()


def test_check_finite_flags_the_bad_leaf_without_reading_the_device(monkeypatch, capsys):
    tree = {"a": torch.ones(3), "b": [torch.zeros(2), torch.tensor([1.0, float("inf")])],
            "steps": torch.arange(4)}

    def no_host_read(*args, **kwargs):
        raise AssertionError("check_finite read a value on the host")

    with monkeypatch.context() as m:  # the call itself reads nothing back
        for name in ("item", "tolist", "__bool__", "numpy", "cpu"):
            m.setattr(torch.Tensor, name, no_host_read)
        ok = check_finite(tree, "grads")
    assert isinstance(ok, torch.Tensor) and ok.dim() == 0 and ok.dtype == torch.bool
    assert capsys.readouterr().out == ""
    assert not bool(ok)
    assert capsys.readouterr().out == "NON-FINITE values in grads['b'][1]\n"
    assert bool(check_finite({"x": torch.ones(2)}, "x"))
    assert capsys.readouterr().out == ""
    assert not check_finite(tree).item()
    assert "tree['b'][1]" in capsys.readouterr().out
    assert (ok & torch.tensor(True)).dtype == torch.bool  # arithmetic gives plain tensors


def _jax_counts(cfg) -> tuple[int, int]:
    shapes = jax.eval_shape(jax_build_model(cfg).init, jax.random.key(0),
                            jnp.zeros((1, cfg.in_channels, cfg.img_size, cfg.img_size)))
    return tuple(sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes.get(c, {})))
                 for c in ("params", "buffers"))


@pytest.mark.parametrize("name", TRAINABLE)
def test_model_summary_counts_equal_jaxs(name):
    """params and buffer_elems equal the JAX model's init tree, which is what
    JAX's model_summary counts (taken here by ``jax.eval_shape``, without
    compiling; JAX's own function is run on one config below)."""
    cfg = apply_overrides(parse_config(os.path.join(CONFIG_DIR, f"{name}.py")), SMALL)
    s = model_summary(build_model(cfg, "cpu"), example_input(cfg, 2, device="cpu"))
    assert (s["params"], s["buffer_elems"]) == _jax_counts(cfg)
    assert s["flops"] > 0


def test_model_summary_against_jaxs_function_and_the_analytic_flop_count():
    """vit_mnist through JAX's own model_summary; the flagship topology's
    FLOPs (the plain path on the CPU, counted by FlopCounterMode) within 10%
    of repl/bench.py's analytic forward count at this small width: the
    count adds the spectral patch fold, a product of weights made once a
    forward (5% of this tiny forward, 0.02% of the flagship's), and counts
    the grouped pool as 2 operations an element where the bench counts 1."""
    cfg = apply_overrides(parse_config(os.path.join(CONFIG_DIR, "vit_mnist.py")), SMALL)
    ref = jax_model_summary(jax_build_model(cfg), jax_example_input(cfg, 2))
    got = model_summary(build_model(cfg, "cpu"), example_input(cfg, 2, device="cpu"))
    assert (got["params"], got["buffer_elems"]) == (ref["params"], ref["buffer_elems"])
    cfg = apply_overrides(parse_config(os.path.join(CONFIG_DIR, "spectre_vit_cifar100.py")),
                          SMALL + ["img_size=16"])
    got = model_summary(build_model(cfg, "cpu"), example_input(cfg, 2, device="cpu"))
    analytic = 2 * forward_flops_per_image(cfg)
    assert 1.0 <= got["flops"] / analytic < 1.1, (got["flops"], analytic)
    text = format_summary("flagship", got)
    assert text == jax_format_summary("flagship", got)
    assert "params" in text and "GFLOP/fwd" in text
