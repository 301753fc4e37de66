"""The port's deployment path on the CPU: ``torch.export`` of the eval forward
with the kernels as custom ops (spectre_tpu_torch/export/program.py,
ops/kernels/library.py), the export CLI and the AOT runner.

- Each of the 8 trainable configs, cut to a small width and initialised in
  JAX, exports, saves, loads and replays within 1e-5 of the live port model
  and of the JAX model's logits in float32, on two inputs; the flagship in
  bf16 within 5e-2 of the live model, JAX's limits.
- The program holds one ``spectre_tpu_torch::block_scatter_rows`` node per
  folded mix layer and one ``spectre_tpu_torch::fused_spectre_linear`` node
  per SpectreLinear, and never the [N, in, O] folded weights.
- Eager forwards never go through the custom ops.
- ``verify_export`` raises on a perturbed program.
- ``repl/export.py`` then ``repl/infer.py --device cpu --expect`` pass in
  subprocesses, and the runner imports no model code.
- ``meta.txt`` is byte-equal to the JAX package's for the same config.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import REPO_ROOT, tiny_export_cfg
from spectre_tpu.models import build_model as jax_build_model
from spectre_tpu_torch.configs import CONFIG_DIR, apply_overrides, parse_config
from spectre_tpu_torch.export import (
    EXPORT_ATOL,
    export_forward,
    exported_module,
    kernel_nodes,
    load_exported,
    program_compute_dtype,
    save_exported,
    verify_export,
)
from spectre_tpu_torch.models import MHPermutMix, SpectreLinear, build_model, load_flax_variables
from spectre_tpu_torch.ops.kernels import library
from spectre_tpu_torch.repl.export import write_meta

CONFIGS = ("spectre_vit_cifar100", "spectre_vit_mnist", "vit_cifar100", "vit_mnist",
           "fnet_cifar100", "fnet_mnist", "dwt_cifar100", "spectre_branch")
SMALL = ["num_encoders=2", "embed_dim=32", "num_heads=2", "hidden_dim=48", "mix_block=8",
         "compute_dtype='float32'"]


def _config(name, *extra):
    return apply_overrides(parse_config(os.path.join(CONFIG_DIR, f"{name}.py")),
                           SMALL + list(extra))


def _example(cfg, b=2, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        0, 1, (b, cfg.in_channels, cfg.img_size, cfg.img_size)).astype(np.float32))


@pytest.mark.parametrize("name", CONFIGS)
def test_every_trainable_config_exports_saves_loads_and_replays(name, tmp_path):
    """The loaded program within 1e-5 (float32) of the live port model and
    of the JAX model with the same variables, at the traced input and a
    second one."""
    cfg = _config(name)
    jm = jax_build_model(cfg)
    v = jax.tree.map(np.asarray, jm.init(
        jax.random.key(5), jnp.zeros((1, cfg.in_channels, cfg.img_size, cfg.img_size))))
    model = load_flax_variables(build_model(cfg, "cpu"), v)
    x = _example(cfg)
    program = export_forward(model, x)
    path = save_exported(program, str(tmp_path / "model.pt2"))
    assert program_compute_dtype(program) == "float32"
    err = verify_export(path, model, x, atol=EXPORT_ATOL["float32"])
    assert err <= 1e-5
    # the loaded program at a second input, not only the traced one
    run = exported_module(load_exported(path))
    x2 = _example(cfg, seed=7)
    for xi in (x, x2):
        got = run(xi).numpy()
        with torch.no_grad():
            np.testing.assert_allclose(got, model(xi).numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(got, np.asarray(jm.apply(v, jnp.asarray(xi.numpy()))),
                                   atol=1e-5, rtol=0)

    folded = [m for m in model.modules() if isinstance(m, MHPermutMix) and m.impl == "folded"]
    linears = [m for m in model.modules() if isinstance(m, SpectreLinear)]
    nodes = kernel_nodes(program)
    assert nodes.get("block_scatter_rows", 0) == len(folded)
    assert nodes.get("fused_spectre_linear", 0) == len(linears)
    attention = cfg.num_encoders if cfg.model == "vit" or cfg.method == "attention" else 0
    assert nodes.get("flash_attention_fwd", 0) == attention
    assert nodes.get("structured_mix", 0) == 0


def test_structured_mix_and_attention_mixer_export_as_their_ops(tmp_path):
    for extra, op in ((["mix_impl='structured'"], "structured_mix"),
                      (["method='attention'"], "flash_attention_fwd")):
        cfg = _config("spectre_vit_cifar100", *extra)
        model = build_model(cfg, "cpu")
        x = _example(cfg)
        program = export_forward(model, x)
        assert kernel_nodes(program)[op] == cfg.num_encoders
        assert verify_export(program, model, x, atol=1e-5) <= 1e-5


def test_the_folded_program_holds_no_folded_weights():
    cfg = _config("spectre_vit_cifar100")
    model = build_model(cfg, "cpu")
    x = _example(cfg)
    with torch.no_grad():
        model(x)  # eager serving folds and keeps [N, in, O] weights
    mix = model.encoder_blocks.layer_0.mix_layer
    folded_shape = tuple(mix.linear._wp[1].shape)
    program = export_forward(model, x)
    held = list(program.state_dict.values()) + list(program.constants.values())
    assert folded_shape == (65, 64, 32)  # [N, E*H, E]
    assert all(tuple(t.shape) != folded_shape for t in held if isinstance(t, torch.Tensor))


def test_bf16_flagship_exports_within_the_bf16_limit(tmp_path):
    cfg = _config("spectre_vit_cifar100", "compute_dtype='bfloat16'")
    model = build_model(cfg, "cpu")
    x = _example(cfg, b=3)
    program = export_forward(model, x)
    assert program_compute_dtype(program) == "bfloat16"
    path = save_exported(program, str(tmp_path / "model.pt2"))
    assert verify_export(path, model, x, atol=EXPORT_ATOL["bfloat16"]) <= 5e-2


def test_eager_forwards_never_go_through_the_custom_ops(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("an eager forward went through a custom op")

    for op in ("block_scatter_rows", "fused_spectre_linear", "flash_attention_fwd",
               "structured_mix"):
        monkeypatch.setattr(library, op, refuse)
    for extra in ([], ["mix_impl='structured'"], ["method='attention'"]):
        cfg = _config("spectre_vit_cifar100", *extra)
        model = build_model(cfg, "cpu")
        with torch.no_grad():
            model(_example(cfg))
        model.train()
        model(_example(cfg)).sum().backward()


def test_verify_export_raises_on_a_perturbed_program():
    cfg = _config("spectre_vit_mnist")
    model = build_model(cfg, "cpu")
    x = _example(cfg)
    program = export_forward(model, x)
    name = next(k for k in program.state_dict if k.endswith("mlp_head.ln_bias"))
    # a new tensor: the program shares its parameters' storage with the model
    program.state_dict[name] = torch.nn.Parameter(program.state_dict[name].detach() + 1.0)
    with pytest.raises(AssertionError, match="export parity check failed"):
        verify_export(program, model, x, atol=1e-5)


def test_export_refuses_a_model_in_train_mode():
    cfg = _config("spectre_vit_mnist")
    model = build_model(cfg, "cpu", train=True)
    with pytest.raises(ValueError, match="eval"):
        export_forward(model, _example(cfg))


def _run(*args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    return subprocess.run([sys.executable, *args], capture_output=True, text=True, cwd=cwd,
                          env=env, timeout=600)


def test_export_cli_then_infer_cli_run_without_model_code(tmp_path):
    config = os.path.join(CONFIG_DIR, "spectre_vit_mnist.py")
    r = _run("-m", "spectre_tpu_torch.repl.export", "--device", "cpu", "--config", config,
             "--outdir", "out", "--batch", "3", "--set", *SMALL, cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    out = tmp_path / "out"
    assert sorted(os.listdir(out)) == ["example_input.f32", "example_logits.f32", "meta.txt",
                                       "model.pt2", "weights.stw"]
    r = _run("-m", "spectre_tpu_torch.repl.infer", "--device", "cpu", "--artifact",
             str(out / "model.pt2"), "--input", str(out / "example_input.f32"), "--batch", "3",
             "--channels", "1", "--size", "28", "--expect", str(out / "example_logits.f32"),
             cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    assert "model code imported: none" in r.stdout
    assert r.stdout.count("sample ") == 3 and "parity vs" in r.stdout
    # a wrong expectation fails the run
    np.zeros(30, np.float32).tofile(out / "zeros.f32")
    r = _run("-m", "spectre_tpu_torch.repl.infer", "--device", "cpu", "--artifact",
             str(out / "model.pt2"), "--input", str(out / "example_input.f32"), "--batch", "3",
             "--channels", "1", "--size", "28", "--expect", str(out / "zeros.f32"),
             cwd=tmp_path)
    assert r.returncode != 0 and "parity check failed" in r.stderr


def test_onnx_is_refused_and_nothing_is_written(tmp_path):
    r = _run("-m", "spectre_tpu_torch.repl.export", "--device", "cpu", "--onnx",
             "--outdir", "out", cwd=tmp_path)
    assert r.returncode != 0 and "'onnx' package" in r.stderr
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("over", [dict(), dict(mix_impl="structured"), dict(model="vit")])
def test_meta_txt_is_byte_equal_to_the_jax_package(over, tmp_path):
    from spectre_tpu.repl.export import _META_KEYS as JAX_META_KEYS
    from spectre_tpu.repl.export import export_from_config as jax_export_from_config

    cfg = tiny_export_cfg(**over)
    jax_export_from_config(cfg, outdir=str(tmp_path / "jax"), batch=1)
    write_meta(cfg, str(tmp_path / "meta.txt"))
    assert (tmp_path / "meta.txt").read_bytes() == (tmp_path / "jax" / "meta.txt").read_bytes()
    assert JAX_META_KEYS == tuple(line.split("=")[0] for line in
                                  (tmp_path / "meta.txt").read_text().splitlines()[:8])
