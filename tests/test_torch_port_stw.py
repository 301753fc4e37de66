"""The port's ``.stw`` container (spectre_tpu_torch/export/weights.py) against
the JAX package's (spectre_tpu/export/weights.py), and the native runner on
an export the port wrote.

- The same weights give byte-identical files from both writers.
- The port reads a JAX-written file into its model and matches JAX's logits
  within 1e-5 (float32 on both sides; summation order differs).
- ``native/build/spectre_infer`` on a port-written export matches the port's
  logits within test_native.py's 1e-4.
"""

import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_export_cfg
from spectre_tpu.export import save_weights_bin
from spectre_tpu.models import build_model as jax_build_model
from spectre_tpu_torch.export import load_stw, load_stw_into, save_stw, stw_names
from spectre_tpu_torch.models import build_model, load_flax_variables
from spectre_tpu_torch.repl.export import export_from_config

LOGITS_ATOL = 1e-5  # f32 on both sides
NATIVE_ATOL = 1e-4  # tests/test_native.py's limit for the C++ runner

CASES = {
    "folded_blk8": dict(mix_impl="folded", mix_block=8),
    "gather": dict(mix_impl="gather"),
    "structured": dict(mix_impl="structured"),
    "vit": dict(model="vit"),
    "branch": dict(model="spectre_branch", method="none"),
}


def _jax_variables(cfg):
    jm = jax_build_model(cfg)
    v = jm.init(jax.random.key(3), jnp.zeros((1, cfg.in_channels, cfg.img_size, cfg.img_size)))
    return jm, jax.tree.map(np.asarray, v)


def _x(b=3, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (b, 3, 8, 8)).astype(np.float32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_and_jax_write_byte_identical_files(case, tmp_path):
    cfg = tiny_export_cfg(**CASES[case])
    _, v = _jax_variables(cfg)
    model = load_flax_variables(build_model(cfg, "cpu"), v)
    save_weights_bin(v, str(tmp_path / "jax.stw"))
    save_stw(model, str(tmp_path / "port.stw"))
    assert (tmp_path / "jax.stw").read_bytes() == (tmp_path / "port.stw").read_bytes()


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_loads_a_jax_written_file_and_matches_jax_logits(case, tmp_path):
    cfg = tiny_export_cfg(**CASES[case])
    jm, v = _jax_variables(cfg)
    path = str(tmp_path / "jax.stw")
    save_weights_bin(v, path)
    model = load_stw_into(build_model(cfg, "cpu"), path)
    x = _x()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, jnp.asarray(x))),
                               atol=LOGITS_ATOL, rtol=0)


def test_names_are_the_jax_flattened_names():
    cfg = tiny_export_cfg(mix_impl="folded", mix_block=8)
    names = stw_names(build_model(cfg, "cpu"))
    assert names["params.encoder_blocks.layer_0.norm1.scale"] == \
        "encoder_blocks.layer_0.norm1.weight"
    assert names["buffers.encoder_blocks.layer_1.mix_layer.mix_tables.0"] == \
        "encoder_blocks.layer_1.mix_layer.perms"
    assert names["buffers.encoder_blocks.layer_1.mix_layer.mix_tables.1"] == \
        "encoder_blocks.layer_1.mix_layer.signs"
    structured = stw_names(build_model(tiny_export_cfg(mix_impl="structured"), "cpu"))
    assert structured["buffers.encoder_blocks.layer_0.mix_layer.mix_tables.0"] == \
        "encoder_blocks.layer_0.mix_layer.tile_perms"


def test_load_stw_into_raises_on_missing_extra_or_misshaped(tmp_path):
    from spectre_tpu_torch.export import write_stw

    cfg = tiny_export_cfg(mix_impl="folded", mix_block=8)
    model = build_model(cfg, "cpu")
    path = str(tmp_path / "w.stw")
    save_stw(model, path)
    flat = dict(load_stw(path))
    for name, edit in (("missing", lambda f: f.pop("params.mlp_head.bias")),
                       ("extra", lambda f: f.__setitem__("params.extra", np.zeros(1, np.float32))),
                       ("shape", lambda f: f.__setitem__("params.mlp_head.bias",
                                                         np.zeros(3, np.float32)))):
        bad = dict(flat)
        edit(bad)
        write_stw(bad, str(tmp_path / f"{name}.stw"))
        with pytest.raises((KeyError, ValueError)):
            load_stw_into(build_model(cfg, "cpu"), str(tmp_path / f"{name}.stw"))


def test_round_trip_restores_every_tensor_and_the_mix_tables(tmp_path):
    cfg = tiny_export_cfg(mix_impl="folded", mix_block=8)
    src = build_model(cfg, "cpu")
    save_stw(src, str(tmp_path / "w.stw"))
    dst = load_stw_into(build_model(tiny_export_cfg(mix_impl="folded", mix_block=8,
                                                    random_seed=5), "cpu"),
                        str(tmp_path / "w.stw"))
    for name, t in src.state_dict().items():
        assert torch.equal(dst.state_dict()[name], t), name
    x = torch.from_numpy(_x())
    with torch.no_grad():
        assert torch.equal(dst(x), src(x))


@pytest.mark.parametrize("mix_impl,mix_block", [
    ("gather", 0), ("structured", 0), ("gather", 8), ("folded", 0)])
def test_native_runner_matches_the_port_on_a_port_written_export(native_build, tmp_path,
                                                                mix_impl, mix_block):
    outdir = str(tmp_path / "export")
    cfg = tiny_export_cfg(mix_impl=mix_impl, mix_block=mix_block)
    export_from_config(cfg, outdir=outdir, batch=3, device="cpu")
    r = subprocess.run(
        [os.path.join(native_build, "spectre_infer"), "--weights", f"{outdir}/weights.stw",
         "--meta", f"{outdir}/meta.txt", "--input", f"{outdir}/example_input.f32",
         "--batch", "3", "--out", f"{outdir}/native_logits.f32"],
        capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    got = np.fromfile(f"{outdir}/native_logits.f32", np.float32).reshape(3, 10)
    want = np.fromfile(f"{outdir}/example_logits.f32", np.float32).reshape(3, 10)
    np.testing.assert_allclose(got, want, rtol=NATIVE_ATOL, atol=NATIVE_ATOL)
    assert (got.argmax(-1) == want.argmax(-1)).all()
