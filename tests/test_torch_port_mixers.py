"""The port's mixers, layers and the ops under them (spectre_tpu_torch/models/
{mixers,layers,patch_embed,vit}.py, ops/{fft,dwt}.py) against their flax
modules and jnp functions, on the CPU in float32. Weights are initialised in
JAX (and perturbed with numpy where the init is constant), carried over by
the weight bridge, and the same numpy inputs go through both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectre_tpu.models import layers as jl
from spectre_tpu.models import mixers as jm
from spectre_tpu.models.patch_embed import PatchEmbedding as JaxPatchEmbedding
from spectre_tpu.models.vit import TransformerEncoderLayer as JaxTransformerEncoderLayer
from spectre_tpu.ops import dwt as jax_dwt
from spectre_tpu.ops import fft as jax_fft
from spectre_tpu_torch import ops
from spectre_tpu_torch.models import (
    MIXERS,
    AttentionMixer,
    BinaryLinear,
    DWTMixer,
    FFTApproximator,
    FFTLayer,
    FNetMixer,
    LearnableHadamard,
    LearnedSigmoid,
    MHFFTMixer,
    MHPermutMix,
    NormalMask,
    PatchEmbedding,
    SignPermuteMix,
    TransformerEncoderLayer,
    flax_state_dict,
    load_flax_variables,
    load_npz,
    make_mixer,
    save_npz,
)

ATOL = 1e-5


def _np(tree):
    return jax.tree.map(np.array, tree)


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _init(module, x, seed=0, perturb=True, **kw):
    """flax variables as numpy; constant inits (zero biases, unit scales)
    are replaced by seeded noise so that no term is trivially absent."""
    v = _np(module.init(jax.random.key(seed), jnp.asarray(x), **kw))
    if perturb and "params" in v:
        rng = np.random.default_rng(seed + 1)

        def noisy(a):
            if a.size > 1 and np.all(a == a.flat[0]):
                return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
            return a

        v["params"] = jax.tree.map(noisy, v["params"])
    return v


def _check(port, flax_module, v, x, atol=ATOL, **kw):
    load_flax_variables(port, v)
    want = np.asarray(flax_module.apply(v, jnp.asarray(x), **kw))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    return got


# ---- mixers ------------------------------------------------------------------------


@pytest.mark.parametrize("b,n,e,h", [(2, 65, 32, 4), (3, 50, 16, 2)])
def test_attention_mixer_matches_flax(b, n, e, h):
    x = _x(b, n, e, seed=n)
    flax_mod = jm.AttentionMixer(embed_dim=e, num_heads=h)
    v = _init(flax_mod, x)
    port = AttentionMixer(e, h)
    _check(port, flax_mod, v, x)
    # the flax module's Pallas route (the kernel in interpret mode off the TPU)
    _check(port, jm.AttentionMixer(embed_dim=e, num_heads=h, use_pallas=True), v, x)
    q = np.einsum("bne,ehd->bhnd", x, v["params"]["mhsa"]["query"]["kernel"]) \
        + v["params"]["mhsa"]["query"]["bias"][None, :, None, :]
    got_q = port.mhsa.query(torch.from_numpy(x)).permute(0, 2, 1, 3)
    np.testing.assert_allclose(got_q.detach().numpy(), q, atol=ATOL, rtol=0)


def test_attention_weights_keep_the_flax_layouts():
    """query/key/value kernels are [E, H, D] and the out kernel [H, D, E];
    E x E is square once reshaped, so a transposed copy passes every shape
    check but not this value check."""
    e, h = 16, 4
    x = _x(2, 7, e)
    flax_mod = jm.AttentionMixer(embed_dim=e, num_heads=h)
    v = _init(flax_mod, x)
    want = _check(AttentionMixer(e, h), flax_mod, v, x)
    sd = flax_state_dict(AttentionMixer(e, h), v)
    assert sd["mhsa.query.kernel"].shape == (e, h, e // h)
    assert sd["mhsa.query.bias"].shape == (h, e // h)
    assert sd["mhsa.out.kernel"].shape == (h, e // h, e) and sd["mhsa.out.bias"].shape == (e,)
    for name in ("query", "out"):
        bad = _np(v)
        k = bad["params"]["mhsa"][name]["kernel"]
        bad["params"]["mhsa"][name]["kernel"] = k.reshape(e, e).T.copy().reshape(k.shape)
        port = load_flax_variables(AttentionMixer(e, h), bad)
        with torch.no_grad():
            assert np.abs(port(torch.from_numpy(x)).numpy() - want).max() > 1e-2, name


def test_attention_dropout_draws_one_mask_for_all_batches_and_heads():
    """Train mode with dropout: the mask comes from the module's generator
    (the train state's), is [N, N] for every batch and head, and reaches the
    probabilities: the output equals the formula with that mask."""
    e, h, n, p = 16, 2, 9, 0.5
    x = torch.from_numpy(_x(3, n, e))
    port = AttentionMixer(e, h, dropout=p)
    gen = torch.Generator().manual_seed(3)
    from spectre_tpu_torch.models.init import init_weights
    init_weights(port, gen)
    port.train()
    port.mhsa.attn_dropout.generator = torch.Generator().manual_seed(11)
    got = port(x)
    keep = torch.empty(n, n).bernoulli_(1 - p, generator=torch.Generator().manual_seed(11))
    pm = keep / (1 - p)
    mh = port.mhsa
    q, k, v = (proj(x).permute(0, 2, 1, 3) for proj in (mh.query, mh.key, mh.value))
    probs = torch.softmax(q @ k.transpose(-1, -2) * (e // h) ** -0.5, dim=-1) * pm
    want = mh.out((probs @ v).permute(0, 2, 1, 3))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert 0 < (keep == 0).sum() < n * n
    port.eval()
    assert not torch.allclose(port(x), got)  # no mask in eval mode


@pytest.mark.parametrize("use_fft", [True, False])
def test_mh_fft_mixer_matches_flax(use_fft):
    x = _x(2, 9, 16)
    flax_mod = jm.MHFFTMixer(embed_dim=16, num_heads=3, use_fft=use_fft)
    _check(MHFFTMixer(16, 3, use_fft=use_fft), flax_mod, _init(flax_mod, x), x, atol=1e-4)


def test_fnet_mixer_and_fft_ops_match_jax():
    x = _x(2, 9, 16)
    _check(FNetMixer(), jm.FNetMixer(), {}, x, atol=1e-4)
    t, j = torch.from_numpy(x), jnp.asarray(x)
    for name in ("fft2_real", "fft2_real_matmul", "log_magnitude_rfft2"):
        np.testing.assert_allclose(getattr(ops, name)(t).numpy(),
                                   np.asarray(getattr(jax_fft, name)(j)), atol=1e-4, rtol=0)
    for axis in (-1, 1):
        np.testing.assert_allclose(ops.rfft_real(t, axis).numpy(),
                                   np.asarray(jax_fft.rfft_real(j, axis)), atol=1e-5, rtol=0)
    for got, want in zip(ops.dft_matrices(9), jax_fft.dft_matrices(9)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ops.dft_matrices(9)[0] is ops.dft_matrices(9)[0]  # made once per size


@pytest.mark.parametrize("axis", [-1, -2])
@pytest.mark.parametrize("n,e", [(8, 6), (7, 5)])
def test_dwt_mixer_matches_flax_on_even_and_odd_lengths(n, e, axis):
    x = _x(3, n, e, seed=n)
    _check(DWTMixer(axis), jm.DWTMixer(axis=axis), {}, x, atol=1e-6)


def test_haar_transforms_match_jax_and_invert():
    x = _x(2, 3, 8, 12)
    t, j = torch.from_numpy(x), jnp.asarray(x)
    for axis in (-1, -2, 1):
        if x.shape[axis] % 2:
            continue
        for got, want in zip(ops.haar_dwt1d(t, axis), jax_dwt.haar_dwt1d(j, axis)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
        a, d = ops.haar_dwt1d(t, axis)
        torch.testing.assert_close(ops.haar_idwt1d(a, d, axis), t, rtol=1e-5, atol=1e-6)
    ll, highs = ops.haar_dwt2d(t)
    jll, jhighs = jax_dwt.haar_dwt2d(j)
    for got, want in zip((ll, *highs), (jll, *jhighs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    torch.testing.assert_close(ops.haar_idwt2d(ll, highs), t, rtol=1e-5, atol=1e-6)
    ll2, all_highs = ops.haar_dwt2d_multilevel(t, 2)
    jll2, jall = jax_dwt.haar_dwt2d_multilevel(j, 2)
    np.testing.assert_allclose(ll2.numpy(), np.asarray(jll2), atol=1e-6, rtol=0)
    assert len(all_highs) == len(jall) == 2 and all_highs[1][2].shape == jall[1][2].shape
    with pytest.raises(ValueError, match="even length"):
        ops.haar_dwt1d(torch.zeros(2, 5))


def test_make_mixer_builds_every_method_and_refuses_unknown_ones():
    for method in MIXERS:
        mixer = make_mixer(method, embed_dim=8, seq_length=5, num_heads=2, mix_impl="gather")
        from spectre_tpu_torch.models.init import init_weights
        init_weights(mixer, torch.Generator().manual_seed(0))
        assert mixer(torch.zeros(2, 5, 8)).shape == (2, 5, 8), method
    assert MIXERS == jm.MIXERS
    with pytest.raises(ValueError, match="unknown mixer method"):
        make_mixer("conv", embed_dim=8, seq_length=5, num_heads=2)


# ---- the permutation mix in its other impls -------------------------------------------


@pytest.mark.parametrize("impl", ["gather", "gather_unfused", "structured"])
def test_mh_permut_mix_impls_match_flax_value_and_gradient(impl):
    b, n, e, h = 3, 5, 16, 2
    x = _x(b, n, e)
    flax_mod = jl.MHPermutMix(embed_dim=e, token_dim=n, num_heads=h, out_channels=e, impl=impl)
    v = _init(flax_mod, x)
    port = MHPermutMix(e, n, h, e, impl=impl)
    _check(port, flax_mod, v, x)
    want = jax.grad(lambda a: jnp.sum(flax_mod.apply(v, a) ** 2))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    (port(tx) ** 2).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    if impl == "structured":
        assert tuple(port.tile_perms.shape) == (h, 5) and port.table_derivations == 1
        assert not hasattr(port, "perms")


def test_structured_tables_map_by_the_owners_impl_and_shapes_still_raise(tmp_path):
    """``mix_tables`` is (perms [H, d], signs) under a permutation mix and
    (tile_perms [H, T], signs) under a structured one: the bridge names them
    by the owner, refuses the other shape, and the .npz round trip keeps
    both."""
    b, n, e, h = 2, 5, 16, 2
    x = _x(b, n, e)
    trees = {}
    for impl in ("gather", "structured"):
        flax_mod = jl.MHPermutMix(embed_dim=e, token_dim=n, num_heads=h, out_channels=e,
                                  impl=impl)
        trees[impl] = (flax_mod, _init(flax_mod, x))
    sd = flax_state_dict(MHPermutMix(e, n, h, e, impl="structured"), trees["structured"][1])
    assert sd["tile_perms"].shape == (h, 5) and sd["signs"].shape == (1, h, n * e)
    assert "perms" not in sd
    assert flax_state_dict(MHPermutMix(e, n, h, e, impl="gather"),
                           trees["gather"][1])["perms"].shape == (h, n * e)
    with pytest.raises(ValueError, match="tile_perms"):
        load_flax_variables(MHPermutMix(e, n, h, e, impl="structured"), trees["gather"][1])
    with pytest.raises(ValueError, match="perms"):
        load_flax_variables(MHPermutMix(e, n, h, e, impl="gather"), trees["structured"][1])
    for impl, (flax_mod, v) in trees.items():
        path = str(tmp_path / f"{impl}.npz")
        save_npz(path, v)
        port = load_flax_variables(MHPermutMix(e, n, h, e, impl=impl), load_npz(path))
        with torch.no_grad():
            np.testing.assert_allclose(port(torch.from_numpy(x)).numpy(),
                                       np.asarray(flax_mod.apply(v, jnp.asarray(x))),
                                       atol=ATOL, rtol=0)


def test_structured_mix_derives_its_inverse_table_once_per_buffer_change():
    mix = MHPermutMix(8, 5, 2, 8, impl="structured")  # d = 40: five tiles of 8
    gen = torch.Generator().manual_seed(0)
    mix.init_parameters(gen)
    mix.linear.init_parameters(gen)
    x = torch.randn(3, 5, 8)
    with torch.no_grad():
        first = mix(x)
        mix(x)
        mix.linear.kernel.mul_(2.0)  # a trained parameter: nothing to derive
        mix(x)
        assert mix.table_derivations == 1
        assert torch.equal(mix.refresh().inv, torch.argsort(mix.tile_perms.long(), 1).int())
        mix.linear.kernel.div_(2.0)
        mix.tile_perms.copy_(mix.tile_perms.flip(1))
        assert not torch.equal(mix(x), first) and mix.table_derivations == 2
        mix.tile_perms[0, 0] = mix.tile_perms[0, 1]
        with pytest.raises(ValueError, match="permutation"):
            mix(x)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MHPermutMix(8, 4, 2, 8, impl="gather_tm")
    with pytest.raises(ValueError, match="unknown MHPermutMix impl"):
        MHPermutMix(8, 4, 2, 8, impl="scatter")


# ---- embeddings, the encoder layer, the experimental layers -----------------------------


def test_patch_embedding_matches_flax():
    x = np.random.default_rng(0).uniform(0, 1, (3, 3, 8, 12)).astype(np.float32)
    flax_mod = JaxPatchEmbedding(embed_dim=16, patch_size=4, num_patches=6, dropout=0.0)
    _check(PatchEmbedding(16, 4, 6, 3), flax_mod, _init(flax_mod, x), x)


def test_transformer_encoder_layer_matches_flax():
    x = _x(2, 9, 16)
    flax_mod = JaxTransformerEncoderLayer(d_model=16, nhead=4, dim_feedforward=24, dropout=0.0)
    _check(TransformerEncoderLayer(16, 4, 24, 0.0), flax_mod, _init(flax_mod, x), x)


def test_sign_permute_mix_matches_flax():
    x = _x(3, 5, 8)
    flax_mod = jl.SignPermuteMix(embed_dim=8, token_dim=5)
    v = _init(flax_mod, x)
    assert v["buffers"]["mix_tables"][0].shape == (1, 40)
    _check(SignPermuteMix(8, 5), flax_mod, v, x, atol=0)


@pytest.mark.parametrize("trainable", [True, False])
def test_binary_linear_matches_flax(trainable):
    x = _x(4, 12)
    flax_mod = jl.BinaryLinear(features=7, trainable=trainable)
    v = _init(flax_mod, x, perturb=False)
    v["params"]["scale"] = np.asarray([0.7], np.float32)
    if not trainable:  # a buffer of ones: give it signs worth checking
        v["buffers"]["weight"] = _x(7, 12, seed=5)
    port = BinaryLinear(12, 7, trainable=trainable)
    _check(port, flax_mod, v, x)
    assert ("weight" in dict(port.named_parameters())) == trainable


def test_fft_approximator_learned_sigmoid_normal_mask_and_fft_layer_match_flax():
    x = _x(3, 5, 16)
    flax_mod = jl.FFTApproximator(dim=16)
    _check(FFTApproximator(16), flax_mod, _init(flax_mod, x), x)
    flax_mod = jl.LearnedSigmoid(threshold=0.3, sharpness=50.0)
    v = _init(flax_mod, x)
    assert v["params"]["threshold"].shape == ()
    _check(LearnedSigmoid(0.3, 50.0), flax_mod, v, x * 0.1)
    flax_mod = jl.NormalMask(n_bins=16)
    v = _init(flax_mod, x)
    v["params"]["mean"], v["params"]["std"] = np.float32(6.5), np.float32(3.0)
    _check(NormalMask(16), flax_mod, v, x)
    _check(FFTLayer(), jl.FFTLayer(), {}, x)
    assert FFTLayer()(torch.from_numpy(x)).shape == (3, 5, 9)


@pytest.mark.parametrize("dim", [16, 24])
def test_learnable_hadamard_layer_matches_flax(dim):
    x = _x(2, 5, dim)
    flax_mod = jl.LearnableHadamard(dim=dim, num_blocks=2)
    v = _init(flax_mod, x)
    for i in range(2):
        v["params"][f"scale_{i}"] = (0.1 * v["params"][f"scale_{i}"]).astype(np.float32)
    _check(LearnableHadamard(dim, 2), flax_mod, v, x)
