"""The port's ops, weight bridge and model (spectre_tpu_torch) against the
JAX package, on the CPU in float32, with inputs made from numpy seeds and
fed to both packages."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import REPO_ROOT, tiny_export_cfg
from spectre_tpu.configs import parse_config as jax_parse_config
from spectre_tpu.models import SpectreViT as JaxSpectreViT
from spectre_tpu.models import build_model as jax_build_model
from spectre_tpu.models.layers import SpectreLinear as JaxSpectreLinear
from spectre_tpu.ops import adaptive_avg_pool1d as jax_pool
from spectre_tpu.ops import detect_block_size as jax_detect_block_size
from spectre_tpu.ops import flatten_patches_cjk as jax_flatten
from spectre_tpu.ops import make_block_mix_tables as jax_block_tables
from spectre_tpu.ops import spectral_patch_matrix as jax_spm
from spectre_tpu_torch.configs import CONFIG_DIR, FLAGSHIP, parse_config
from spectre_tpu_torch.models import (
    MIXERS,
    MHPermutMix,
    SpectreLinear,
    build_model,
    load_flax_variables,
    load_npz,
    save_npz,
)
from spectre_tpu_torch.ops import (
    adaptive_avg_pool1d,
    detect_block_size,
    flatten_patches_cjk,
    make_block_mix_tables,
    perm_rows_t_plain,
    spectral_patch_matrix,
)

JAX_CONFIGS = os.path.join(REPO_ROOT, "spectre_tpu", "configs")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---- ops ---------------------------------------------------------------------


def test_spectral_patch_embed_ops_match_jax():
    rng = np.random.default_rng(0)
    P, C, E = 4, 3, 16
    F = P // 2 + 1
    proj = rng.standard_normal((C * P * F, E)).astype(np.float32)
    fh = rng.uniform(0.5, 1.5, P).astype(np.float32)
    fw = rng.uniform(0.5, 1.5, F).astype(np.float32)
    want = np.asarray(jax_spm(jnp.asarray(proj), jnp.asarray(fh), jnp.asarray(fw), P, C))
    got = spectral_patch_matrix(torch.from_numpy(proj), torch.from_numpy(fh),
                                torch.from_numpy(fw), P, C).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    x = rng.standard_normal((2, C, 8, 12)).astype(np.float32)
    np.testing.assert_array_equal(flatten_patches_cjk(torch.from_numpy(x), P).numpy(),
                                  np.asarray(jax_flatten(jnp.asarray(x), P)))


# the residual kinds: identity, grouped mean (8192 -> 512 on the flagship)
# and the pool matrix, both shrinking (768 -> 512, 512 -> 100) and growing
# (512 -> 768)
@pytest.mark.parametrize("l,lo", [(24, 24), (64, 16), (24, 16), (32, 10), (16, 24)])
def test_adaptive_avg_pool1d_matches_jax(l, lo):
    x = np.random.default_rng(l * lo).standard_normal((3, 5, l)).astype(np.float32)
    np.testing.assert_allclose(adaptive_avg_pool1d(torch.from_numpy(x), lo).numpy(),
                               np.asarray(jax_pool(jnp.asarray(x), lo)), rtol=1e-6, atol=1e-6)


def test_detect_block_size_matches_jax_and_tables_are_block_permutations():
    for h, d, blk in ((4, 64, 8), (3, 96, 16), (2, 128, 128)):
        jp = np.asarray(jax_block_tables(jax.random.key(0), h, d, blk)[0])
        perms, signs = make_block_mix_tables(torch.Generator().manual_seed(0), h, d, blk)
        p = perms.numpy()
        assert perms.dtype == torch.int32 and signs.shape == (1, h, d)
        assert set(np.unique(signs.numpy())) <= {-1.0, 1.0}
        np.testing.assert_array_equal(np.sort(p, axis=1), np.broadcast_to(np.arange(d), (h, d)))
        for table in (jp, p):
            assert detect_block_size(table) == jax_detect_block_size(table) >= blk
    uniform = np.stack([np.random.default_rng(i).permutation(96) for i in range(3)])
    assert detect_block_size(uniform) == jax_detect_block_size(uniform) == 0
    assert detect_block_size(uniform, min_blk=1) == 1


def test_port_parses_the_jax_config_files_identically():
    """The port's parser on the JAX package's files, and the port's own
    copies of them (which it reads at run time), give the JAX namespaces."""
    for name in ("default.py", "spectre_vit_cifar100.py", "spectre_vit_mnist.py",
                 "vit_cifar100.py", "vit_mnist.py", "fnet_cifar100.py", "fnet_mnist.py",
                 "dwt_cifar100.py"):
        want = vars(jax_parse_config(os.path.join(JAX_CONFIGS, name)))
        assert vars(parse_config(os.path.join(JAX_CONFIGS, name))) == want
        assert vars(parse_config(os.path.join(CONFIG_DIR, name))) == want
    got = vars(parse_config(FLAGSHIP))
    assert os.path.dirname(FLAGSHIP) == CONFIG_DIR != JAX_CONFIGS
    assert (got["embed_dim"], got["num_heads"], got["mix_block"]) == (512, 16, 64)


# ---- weight bridge -------------------------------------------------------------


@pytest.mark.parametrize("k,n", [(16, 16), (12, 20)])
def test_bridge_keeps_the_in_out_layout(k, n):
    """Value-level: a transposed square kernel passes any shape check, but
    not this one."""
    rng = np.random.default_rng(k + n)
    jm = JaxSpectreLinear(n)
    x = rng.standard_normal((4, 7, k)).astype(np.float32)
    v = jm.init(jax.random.key(k), jnp.asarray(x))
    v = _np(v)
    v["params"]["ln_scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
    v["params"]["ln_bias"] = (0.1 * rng.standard_normal(n)).astype(np.float32)
    pm = load_flax_variables(SpectreLinear(k, n), v)
    np.testing.assert_array_equal(pm.kernel.detach().numpy(), v["params"]["kernel"])
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    got = pm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if k == n:  # the transposed kernel gives other values
        v["params"]["kernel"] = v["params"]["kernel"].T.copy()
        bad = load_flax_variables(SpectreLinear(k, n), v)(torch.from_numpy(x))
        assert np.abs(bad.detach().numpy() - want).max() > 1e-2


@pytest.fixture(scope="module")
def tiny_flax():
    """A 2-layer flagship topology (folded mix, block tables) initialised
    in JAX: (config, flax model, numpy variables)."""
    cfg = tiny_export_cfg(mix_impl="folded", mix_block=8)
    jm = jax_build_model(cfg)
    v = jm.init(jax.random.key(0), jnp.zeros((1, 3, 8, 8)))
    return cfg, jm, _np(v)


def test_bridge_rejects_missing_extra_and_misshaped(tiny_flax):
    cfg, _, v = tiny_flax
    model = build_model(cfg, "cpu")
    missing = jax.tree.map(lambda a: a, v)
    del missing["params"]["mlp_head"]["bias"]
    with pytest.raises(KeyError, match="mlp_head.bias"):
        load_flax_variables(model, missing)
    extra = jax.tree.map(lambda a: a, v)
    extra["params"]["mlp_head"]["stray"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="stray"):
        load_flax_variables(model, extra)
    shaped = jax.tree.map(lambda a: a, v)
    shaped["params"]["mlp_head"]["kernel"] = np.zeros((16, 11), np.float32)
    with pytest.raises(ValueError, match="mlp_head.kernel"):
        load_flax_variables(model, shaped)


# ---- the slice -------------------------------------------------------------------


@pytest.mark.parametrize("mix_block", [8, 0])
def test_flagship_topology_logits_match_jax(mix_block):
    """Init in JAX, bridge into the port, compare logits (and the CLS
    features) at B=8 within 1e-4. mix_block=0 is the reference's uniform
    table distribution; the port runs it through the same block kernel
    with blk=1."""
    cfg = tiny_export_cfg(mix_impl="folded", mix_block=mix_block)
    jm = jax_build_model(cfg)
    v = jm.init(jax.random.key(1), jnp.zeros((1, 3, 8, 8)))
    x = np.random.default_rng(2).uniform(0, 1, (8, 3, 8, 8)).astype(np.float32)
    want, want_feat = jm.apply(v, jnp.asarray(x), return_features=True)
    model = load_flax_variables(build_model(cfg, "cpu"), _np(v))
    with torch.inference_mode():
        got, feat = model(torch.from_numpy(x), return_features=True)
    assert got.dtype == torch.float32 and got.shape == (8, cfg.num_classes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    np.testing.assert_allclose(feat.numpy(), np.asarray(want_feat), atol=1e-4, rtol=0)
    mix = model.encoder_blocks.layer_0.mix_layer.refresh()
    assert mix.tables.blk == detect_block_size(v["buffers"]["encoder_blocks"]["layer_0"]
                                        ["mix_layer"]["mix_tables"][0], min_blk=1)


def test_npz_round_trip_serves_the_same_logits(tiny_flax, tmp_path):
    cfg, jm, v = tiny_flax
    path = str(tmp_path / "w.npz")
    save_npz(path, v)
    x = np.random.default_rng(3).uniform(0, 1, (4, 3, 8, 8)).astype(np.float32)
    model = load_flax_variables(build_model(cfg, "cpu"), load_npz(path))
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, jnp.asarray(x))), atol=1e-4, rtol=0)


def test_mix_derives_its_tables_from_live_buffers():
    """No stale block table: after a new permutation is copied into the
    buffers, the next forward uses it; a non-permutation is refused."""
    torch.manual_seed(0)
    mix = MHPermutMix(4, 6, 2, 4, mix_block=8)
    gen = torch.Generator().manual_seed(0)
    mix.init_parameters(gen)
    mix.linear.init_parameters(gen)
    x = torch.randn(3, 6, 4)

    def reference():
        xt = x.reshape(3, -1).t().contiguous()
        g4 = perm_rows_t_plain(xt, mix.perms).view(6, -1, 3)  # [N, in, B]
        s4 = mix.signs.reshape(6, -1)
        y = torch.einsum("neb,ne,eo->nbo", g4, s4, mix.linear.kernel) + mix.linear.bias
        pool = (g4 * s4[:, :, None]).reshape(6, 4, 2, 3).mean(2).permute(0, 2, 1)
        h = torch.nn.functional.layer_norm(y, (4,), mix.linear.ln_scale, mix.linear.ln_bias)
        return (torch.nn.functional.gelu(h) + pool).transpose(0, 1)

    with torch.no_grad():
        assert mix.refresh().tables.blk >= 8
        torch.testing.assert_close(mix(x), reference())
        mix.perms.copy_(torch.stack([torch.randperm(24, generator=gen) for _ in range(2)]))
        torch.testing.assert_close(mix(x), reference())
        mix.linear.kernel.mul_(-2.0)
        torch.testing.assert_close(mix(x), reference())
        mix.perms[0, 0] = mix.perms[0, 1]
        with pytest.raises(ValueError, match="permutation"):
            mix(x)


def test_model_built_and_bridged_under_inference_mode(tiny_flax):
    """Tensors made under inference_mode carry no version counter; building
    and bridging there still derives the mix from the copied tables."""
    cfg, jm, v = tiny_flax
    x = np.random.default_rng(5).uniform(0, 1, (2, 3, 8, 8)).astype(np.float32)
    with torch.inference_mode():
        model = build_model(cfg, "cpu")
        model(torch.from_numpy(x))  # derives from the port's own init
        got = load_flax_variables(model, v)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, jnp.asarray(x))), atol=1e-4, rtol=0)


def test_unported_variants_raise_with_a_pointer():
    """What is still to port raises by name with a pointer to ROADMAP.md:
    the token-major gather and SpectreBranch. Everything else builds: both
    models, every mixer, every other mix impl."""
    with pytest.raises(NotImplementedError, match="gather_tm.*ROADMAP"):
        MHPermutMix(4, 6, 2, 4, impl="gather_tm")
    for over, what in ((dict(model="spectre_branch"), "spectre_branch"),
                       (dict(mix_impl="gather_tm"), "gather_tm")):
        with pytest.raises(NotImplementedError, match=f"{what}.*ROADMAP"):
            build_model(tiny_export_cfg(**over), "cpu")
    with pytest.raises(ValueError, match="unknown model"):
        build_model(tiny_export_cfg(model="resnet"), "cpu")
    x = torch.zeros(2, 3, 8, 8)
    built = [dict(model="vit", method="attention")]
    built += [dict(method=m, mix_impl="folded") for m in MIXERS]
    built += [dict(mix_impl=i) for i in ("folded", "gather", "gather_unfused", "structured")]
    for over in built:
        with torch.no_grad():
            assert build_model(tiny_export_cfg(**over), "cpu")(x).shape == (2, 10), over


def test_seeded_init_distributions_and_determinism():
    cfg = tiny_export_cfg(mix_impl="folded", mix_block=8, num_encoders=1)
    a, b = build_model(cfg, "cpu"), build_model(cfg, "cpu")
    for (name, ta), tb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(ta, tb), name
    lin = a.encoder_blocks.layer_0.linear1
    bound = 16 ** -0.5
    assert lin.kernel.abs().max() <= bound and lin.kernel.std() > bound / 3
    assert torch.equal(lin.ln_scale, torch.ones(32)) and torch.equal(lin.ln_bias, torch.zeros(32))
    assert torch.equal(a.embeddings_block.freq_weight_h, torch.ones(4))
    assert 0.5 < a.embeddings_block.position_embeddings.std() < 1.5
    assert a.encoder_blocks.layer_0.mix_layer.refresh().tables.blk >= 8
    jax_tree = JaxSpectreViT(img_size=8, patch_size=4, in_channels=3, num_classes=10,
                             embed_dim=16, num_encoders=1, num_heads=2, hidden_dim=32,
                             mix_impl="folded", mix_block=8).init(
        jax.random.key(0), jnp.zeros((1, 3, 8, 8)))
    load_flax_variables(a, _np(jax_tree))  # same names and shapes as the flax init


def test_port_imports_no_jax():
    code = (
        "import sys, pkgutil, importlib, spectre_tpu_torch\n"
        "for m in pkgutil.walk_packages(spectre_tpu_torch.__path__, 'spectre_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'spectre_tpu.')))\n"
        "assert not bad, bad\n"
        "print(*[k for k in sys.modules if k.startswith('spectre_tpu_torch')])\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    names = r.stdout.split()
    for sub in ("train.loop", "train.step", "data.pipeline", "repl.train", "data.augment",
                "data.datasets", "train.checkpoint", "utils.metrics", "repl.eval", "repl.bench",
                "repl.perf", "ops.kernels.fused_block_bwd", "ops.kernels.attention",
                "ops.kernels.fwht", "ops.kernels.structured_mix", "ops.hadamard", "ops.dwt",
                "models.mixers", "models.vit"):
        assert f"spectre_tpu_torch.{sub}" in names
    assert len(names) >= 45
