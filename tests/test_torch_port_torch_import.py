"""The port's importer of reference checkpoints
(spectre_tpu_torch/models/torch_import.py) against the JAX package's
(spectre_tpu/models/torch_import.py).

For each family a seeded synthetic reference ``state_dict`` (the keys and
shapes the importers read, numpy values from a seed, the mix tables real
permutations and signs) goes through both: the port's import must equal
``load_flax_variables(model, spectre_tpu.models.import_*(variables, sd))``
tensor for tensor, exactly. Missing, extra and mis-shaped keys raise.

The last source of the weight bridge, a JAX trainer's orbax checkpoint,
goes through tools/orbax_to_npz.py into the port.
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
from spectre_tpu.models import torch_import as jax_torch_import
from spectre_tpu.train.checkpoint import CheckpointManager
from spectre_tpu.train.optim import make_optimizer
from spectre_tpu.train.state import create_train_state
from spectre_tpu_torch.models import (
    build_model,
    import_spectre_branch,
    import_spectre_vit,
    import_vit,
    load_flax_variables,
    load_npz,
    reference_state_dict,
)

FAMILIES = {
    "spectre_vit": (dict(mix_impl="folded", mix_block=8), import_spectre_vit,
                    lambda v, sd, c: jax_torch_import.import_spectre_vit(v, sd, c.num_encoders)),
    "spectre_vit_gather": (dict(mix_impl="gather"), import_spectre_vit,
                           lambda v, sd, c: jax_torch_import.import_spectre_vit(
                               v, sd, c.num_encoders)),
    "vit": (dict(model="vit"), import_vit,
            lambda v, sd, c: jax_torch_import.import_vit(v, sd, c.num_encoders, c.num_heads)),
    "spectre_branch": (dict(model="spectre_branch", method="none"), import_spectre_branch,
                       lambda v, sd, c: jax_torch_import.import_spectre_branch(
                           v, sd, c.num_encoders)),
}


def synthetic_reference(cfg, seed=0) -> dict[str, np.ndarray]:
    """A reference-layout state_dict of the config's geometry with seeded
    values: keys and shapes from the layout rules (``reference_state_dict``
    of a port model), values drawn anew."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, t in reference_state_dict(build_model(cfg, "cpu")).items():
        if k.endswith(".perms"):
            out[k] = np.stack([rng.permutation(t.shape[1]) for _ in range(t.shape[0])])
        elif k.endswith(".signs"):
            out[k] = rng.choice([-1.0, 1.0], t.shape).astype(np.float32)
        else:
            out[k] = rng.normal(size=tuple(t.shape)).astype(np.float32)
    return out


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_port_import_equals_the_jax_import_through_the_bridge(family):
    over, port_import, jax_import = FAMILIES[family]
    cfg = tiny_export_cfg(**over)
    sd = synthetic_reference(cfg, seed=len(family))
    jm = jax_build_model(cfg)
    v = jm.init(jax.random.key(0), jnp.zeros((1, 3, 8, 8)))
    want = load_flax_variables(build_model(cfg, "cpu"),
                               jax.tree.map(np.asarray, jax_import(v, sd, cfg)))
    got = port_import(build_model(cfg, "cpu"), {k: torch.from_numpy(a) for k, a in sd.items()})
    for name, t in want.state_dict().items():
        assert torch.equal(got.state_dict()[name], t), name
    x = np.random.default_rng(1).uniform(0, 1, (2, 3, 8, 8)).astype(np.float32)
    with torch.no_grad():
        logits = got(torch.from_numpy(x)).numpy()
    # and the imported port model computes the JAX model's logits (f32)
    np.testing.assert_allclose(logits, np.asarray(jm.apply(jax_import(v, sd, cfg),
                                                           jnp.asarray(x))),
                               atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_missing_extra_and_misshaped_keys_raise(family):
    over, port_import, _ = FAMILIES[family]
    cfg = tiny_export_cfg(**over)
    sd = synthetic_reference(cfg)
    missing = dict(sd)
    missing.pop(sorted(sd)[0])
    with pytest.raises(KeyError):
        port_import(build_model(cfg, "cpu"), missing)
    with pytest.raises(KeyError):
        port_import(build_model(cfg, "cpu"), {**sd, "head.extra.weight": np.zeros(2)})
    key = next(k for k in sorted(sd) if k.endswith("norm1.weight"))
    with pytest.raises(ValueError):
        port_import(build_model(cfg, "cpu"), {**sd, key: np.zeros(3, np.float32)})


def test_branch_drops_the_dead_mix_layer_weights():
    cfg = tiny_export_cfg(model="spectre_branch", method="none")
    sd = synthetic_reference(cfg)
    dead = {"encoder_blocks.layers.0.mix_layer.linear.weight": np.zeros((16, 16), np.float32)}
    a = import_spectre_branch(build_model(cfg, "cpu"), sd)
    b = import_spectre_branch(build_model(cfg, "cpu"), {**sd, **dead})
    for name, t in a.state_dict().items():
        assert torch.equal(b.state_dict()[name], t), name


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_reference_state_dict_round_trips_through_the_import(family):
    over, port_import, _ = FAMILIES[family]
    src = build_model(tiny_export_cfg(**over, random_seed=1), "cpu")
    dst = port_import(build_model(tiny_export_cfg(**over, random_seed=2), "cpu"),
                      reference_state_dict(src))
    for name, t in src.state_dict().items():
        assert torch.equal(dst.state_dict()[name], t), name


def test_orbax_checkpoint_converts_to_npz_and_the_port_matches_jax(tmp_path):
    """A JAX trainer checkpoint -> tools/orbax_to_npz.py -> the port's
    logits within 1e-5 of the restored JAX model's (f32 on both sides)."""
    cfg = tiny_export_cfg(mix_impl="folded", mix_block=8)
    config = tmp_path / "tiny.py"
    config.write_text("".join(f"{k} = {v!r}\n" for k, v in vars(cfg).items()))
    jm = jax_build_model(cfg)
    state = create_train_state(jm, make_optimizer(cfg, steps_per_epoch=1),
                               jnp.zeros((1, 3, 8, 8)), seed=7)
    # a state the converter's own init cannot reproduce
    state = state.replace(step=state.step + 3, params=jax.tree.map(
        lambda p: p + 0.01 * jnp.cos(jnp.arange(p.size).reshape(p.shape)), state.params))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(state, {"accuracy": 0.5})
    mgr.wait()
    mgr.close()

    out = tmp_path / "weights.npz"
    r = subprocess.run([sys.executable, os.path.join(REPO_ROOT, "tools", "orbax_to_npz.py"),
                        "--config", str(config), "--checkpoint", str(tmp_path / "ckpt"),
                        "--out", str(out)], capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr
    assert "wrote step 3" in r.stdout
    model = load_flax_variables(build_model(cfg, "cpu"), load_npz(str(out)))
    x = np.random.default_rng(2).uniform(0, 1, (3, 3, 8, 8)).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want = np.asarray(jm.apply(state.variables(), jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
