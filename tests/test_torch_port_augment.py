"""The port's device-side augmentation (spectre_tpu_torch/data/augment.py)
against the JAX package's, on the CPU in float32.

The random streams of the two packages differ, the arithmetic must not: each
``*_apply`` gets the draws that the JAX op makes from its key (recomputed here
with the same ``jax.random`` calls) and is held to the JAX op's output within
1e-5 (the two evaluate the same float32 expressions; sums of three channels
and the 3x3 colour products may associate differently). Each ``random_*`` has
a test of its draws' distribution at a fixed seed.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectre_tpu.data import augment as jaug
from spectre_tpu_torch.data import augment as aug

ATOL = 1e-5
CIFAR = ((0.5071, 0.4865, 0.4409), (0.2673, 0.2564, 0.2762))
MNIST = ((0.1307,), (0.3081,))


def _images(b, c, size=12, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (b, c, size, size)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def _jitter_draws(key, b, brightness, contrast, saturation, hue):
    kb, kc, ks, kh = jax.random.split(key, 4)
    one = (b, 1, 1, 1)
    fb = jax.random.uniform(kb, one, minval=1 - brightness, maxval=1 + brightness)
    fc = jax.random.uniform(kc, one, minval=1 - contrast, maxval=1 + contrast)
    fs = jax.random.uniform(ks, one, minval=1 - saturation, maxval=1 + saturation)
    theta = jax.random.uniform(kh, (b, 1, 1), minval=-hue, maxval=hue) * 2 * jnp.pi
    return [_t(v).reshape(b) for v in (fb, fc, fs, theta)]


def _erasing_draws(key, b, p, scale, ratio):
    kon, ka, kr, ky, kx = jax.random.split(key, 5)
    on = jax.random.uniform(kon, (b,)) < p
    area = jax.random.uniform(ka, (b,), minval=scale[0], maxval=scale[1])
    log_r = jax.random.uniform(kr, (b,), minval=jnp.log(ratio[0]), maxval=jnp.log(ratio[1]))
    return [_t(v) for v in (on, area, log_r, jax.random.uniform(ky, (b,)),
                            jax.random.uniform(kx, (b,)))]


@pytest.mark.parametrize("c", [1, 3])
def test_normalize_flip_and_grayscale_match_jax(c):
    x = _images(8, c)
    mean, std = CIFAR if c == 3 else MNIST
    _close(aug.normalize(_t(x), mean, std), jaug.normalize(jnp.asarray(x), mean, std))
    _close(aug.make_eval_transform(mean, std)(_t(x)),
           jaug.make_eval_transform(mean, std)(jnp.asarray(x)))
    key = jax.random.key(1)
    flip = jax.random.bernoulli(key, 0.5, (8, 1, 1, 1))
    assert 0 < int(flip.sum()) < 8
    _close(aug.hflip_apply(_t(x), _t(flip).reshape(8)), jaug.random_hflip(key, jnp.asarray(x)))
    on = jax.random.bernoulli(key, 0.4, (8, 1, 1, 1))
    _close(aug.grayscale_apply(_t(x), _t(on).reshape(8)),
           jaug.random_grayscale(key, jnp.asarray(x), 0.4))


@pytest.mark.parametrize("c,hue", [(3, 0.1), (3, 0.0), (1, 0.1)])
def test_color_jitter_matches_jax(c, hue):
    x = _images(6, c, seed=2)
    key = jax.random.key(2)
    fb, fc, fs, theta = _jitter_draws(key, 6, 0.4, 0.4, 0.4, hue)
    got = aug.color_jitter_apply(_t(x), fb, fc, fs, theta if hue > 0 else None)
    want = jaug.color_jitter(key, jnp.asarray(x), 0.4, 0.4, 0.4, hue)
    _close(got, want)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("interpolation", ["nearest", "bilinear"])
def test_rotate_matches_jax(c, interpolation):
    """Nearest: a source coordinate that falls exactly on a half may round to
    the other side where one package fuses the multiply-add; under 0.1% of the
    pixels may differ for that reason (none is expected at this size)."""
    x = _images(16, c, size=16, seed=3)
    key = jax.random.key(3)
    angles = jax.random.uniform(key, (16,), minval=-30.0, maxval=30.0) * (jnp.pi / 180.0)
    got = aug.rotate_apply(_t(x), _t(angles), interpolation).numpy()
    want = np.asarray(jaug.random_rotate(key, jnp.asarray(x), 30.0, interpolation))
    if interpolation == "nearest":
        differing = (np.abs(got - want) > ATOL).mean()
        assert differing <= 1e-3, differing
        assert (got == 0).mean() > 0.02  # corners rotated in from outside are zero-filled
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("c,p", [(3, 0.5), (1, 0.5), (3, 1.0)])
def test_gaussian_blur_matches_jax(c, p):
    x = _images(8, c, seed=4)
    key = jax.random.key(4)
    ks, kp = jax.random.split(key)
    sigma = jax.random.uniform(ks, (), minval=0.1, maxval=2.0)
    on = _t(jax.random.bernoulli(kp, p, (8, 1, 1, 1))).reshape(8) if p < 1 else None
    got = aug.gaussian_blur_apply(_t(x), _t(sigma), on)
    _close(got, jaug.gaussian_blur(key, jnp.asarray(x), p=p))
    # zero padding: a border pixel of an all-ones image loses weight
    ones = aug.gaussian_blur_apply(torch.ones(1, 1, 5, 5), torch.tensor(1.0))
    assert float(ones[0, 0, 0, 0]) < float(ones[0, 0, 2, 2]) == pytest.approx(1.0, abs=1e-6)


@pytest.mark.parametrize("c", [1, 3])
def test_random_erasing_matches_jax(c):
    x = _images(32, c, seed=5) + 0.5  # no zero in the input
    key = jax.random.key(5)
    draws = _erasing_draws(key, 32, 0.5, (0.02, 0.33), (0.3, 3.3))
    got = aug.erasing_apply(_t(x), *draws)
    want = jaug.random_erasing(key, jnp.asarray(x))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert 0 < int((got == 0).any(dim=(1, 2, 3)).sum()) < 32


class _Replay:
    """Stands in for the port's two draw helpers: hands out, in call order,
    the draws the JAX composition makes from its keys."""

    def __init__(self, draws):
        self.draws = list(draws)

    def uniform(self, generator, shape, lo, hi, like):
        value = self.draws.pop(0)
        assert value.dtype == torch.float32 and tuple(value.shape) == tuple(shape)
        assert float(value.min()) >= lo - 1e-6 and float(value.max()) <= hi + 1e-6
        return value

    def bernoulli(self, generator, shape, p, like):
        value = self.draws.pop(0)
        assert value.dtype == torch.bool and tuple(value.shape) == tuple(shape)
        return value


@pytest.mark.parametrize("recipe", ["cifar100", "mnist", "cifar100_one_channel"])
def test_make_train_augment_composition_matches_jax(recipe, monkeypatch):
    """The same knobs, defaults and order of operations: the trainer's CIFAR
    recipe (3 channels; 1 channel without the colour jitter) and its MNIST
    recipe, fed the draws the JAX pipeline makes from its six keys."""
    b = 16
    if recipe == "mnist":
        stats, kw, c = MNIST, dict(hflip=False, jitter=False, grayscale_p=0.0, degrees=15.0,
                                   blur_p=0.0, erasing_p=0.0), 1
    else:
        c = 3 if recipe == "cifar100" else 1
        stats, kw = (CIFAR if c == 3 else MNIST), dict(jitter=(c == 3))
    x = _images(b, c, size=16, seed=6)
    key = jax.random.key(6)
    want = np.asarray(jaug.make_train_augment(*stats, **kw)(key, jnp.asarray(x)))

    keys = jax.random.split(key, 6)
    draws = []
    if recipe != "mnist":
        draws.append(_t(jax.random.bernoulli(keys[0], 0.5, (b, 1, 1, 1))).reshape(b))
        if c == 3:
            fb, fc, fs, theta = _jitter_draws(keys[1], b, 0.4, 0.4, 0.4, 0.1)
            draws += [fb, fc, fs, theta / (2 * math.pi)]
        draws.append(_t(jax.random.bernoulli(keys[2], 0.2, (b, 1, 1, 1))).reshape(b))
    degrees = 15.0 if recipe == "mnist" else 30.0
    draws.append(_t(jax.random.uniform(keys[3], (b,), minval=-degrees, maxval=degrees)))
    if recipe != "mnist":
        ks, kp = jax.random.split(keys[4])
        draws.append(_t(jax.random.uniform(ks, (), minval=0.1, maxval=2.0)))
        draws.append(_t(jax.random.bernoulli(kp, 0.5, (b, 1, 1, 1))).reshape(b))
        draws += _erasing_draws(keys[5], b, 0.5, (0.02, 0.33), (0.3, 3.3))
    replay = _Replay(draws)
    monkeypatch.setattr(aug, "_uniform", replay.uniform)
    monkeypatch.setattr(aug, "_bernoulli", replay.bernoulli)
    got = aug.make_train_augment(*stats, **kw)(None, _t(x)).numpy()
    assert not replay.draws  # every draw was asked for, in this order
    # the hue angle goes through one more float32 product here
    # (u * (2 pi) for (u * 2) * pi); a rotated pixel may differ as above
    assert (np.abs(got - want) > 1e-4).mean() <= 1e-3
    assert got.shape == x.shape and got.dtype == np.float32


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_random_hflip_and_grayscale_draw_their_share():
    n = 4000
    x = torch.zeros(n, 3, 1, 2)
    x[..., 1] = 1.0
    x[:, 1] *= 0.5
    flipped = (aug.random_hflip(_gen(), x, 0.3)[:, 0, 0, 0] == 1.0).float().mean().item()
    assert abs(flipped - 0.3) <= 3 * (0.3 * 0.7 / n) ** 0.5
    out = aug.random_grayscale(_gen(1), x, 0.2)
    gray = (out[:, 0] == out[:, 1]).all(dim=(1, 2)).float().mean().item()
    assert abs(gray - 0.2) <= 3 * (0.2 * 0.8 / n) ** 0.5
    a, b = aug.random_hflip(_gen(5), x), aug.random_hflip(_gen(5), x)
    assert torch.equal(a, b) and not torch.equal(a, aug.random_hflip(_gen(6), x))


def test_random_color_jitter_draws_factors_in_range(monkeypatch):
    """A constant gray image keeps only the brightness factor (contrast,
    saturation and hue leave gray alone); the other draws are read off the
    call to ``color_jitter_apply``."""
    n = 2000
    out = aug.random_color_jitter(_gen(), torch.full((n, 3, 2, 2), 0.5), 0.4, 0.4, 0.4, 0.1)
    fb = out[:, 0, 0, 0] / 0.5
    assert (out - out[:, :1, :1, :1]).abs().max().item() <= 1e-6
    assert 0.6 <= fb.min().item() < 0.62 and 1.38 < fb.max().item() <= 1.4
    assert abs(fb.mean().item() - 1.0) <= 3 * (0.8 / 12 ** 0.5) / n ** 0.5
    seen = {}
    monkeypatch.setattr(aug, "color_jitter_apply",
                        lambda x, *draws: seen.update(draws=draws) or x)
    aug.random_color_jitter(_gen(1), torch.zeros(n, 3, 2, 2), 0.2, 0.3, 0.4, 0.05)
    for draw, half in zip(seen["draws"][:3], (0.2, 0.3, 0.4)):
        assert tuple(draw.shape) == (n,) and abs(draw.mean().item() - 1.0) <= 0.02
        assert 1 - half <= draw.min().item() < 1 - 0.9 * half
        assert 1 + 0.9 * half < draw.max().item() <= 1 + half
    theta = seen["draws"][3]
    assert 0.9 * 0.05 * 2 * math.pi < theta.abs().max().item() <= 0.05 * 2 * math.pi
    aug.random_color_jitter(_gen(1), torch.zeros(n, 1, 2, 2))
    assert seen["draws"][2:] == (None, None)  # one channel: no saturation, no hue


def test_random_rotate_draws_angles_uniformly(monkeypatch):
    n = 4000
    seen = {}
    monkeypatch.setattr(aug, "rotate_apply",
                        lambda x, angles, interpolation: seen.update(a=angles) or x)
    aug.random_rotate(_gen(), torch.zeros(n, 1, 4, 4), 15.0)
    deg = seen["a"] * (180.0 / math.pi)
    assert tuple(deg.shape) == (n,)
    assert -15.0 <= deg.min().item() < -14.5 and 14.5 < deg.max().item() <= 15.0
    assert abs(deg.mean().item()) <= 3 * (30 / 12 ** 0.5) / n ** 0.5
    assert abs(deg.std().item() - 30 / 12 ** 0.5) <= 0.3


def test_random_gaussian_blur_draws_one_sigma_per_batch(monkeypatch):
    n = 4000
    calls = []
    monkeypatch.setattr(aug, "gaussian_blur_apply",
                        lambda x, sigma, on, kernel_size: calls.append((sigma, on)) or x)
    gen = _gen()
    for _ in range(50):
        aug.random_gaussian_blur(gen, torch.zeros(n, 1, 4, 4), p=0.5)
    sigmas = torch.stack([s for s, _ in calls])
    assert all(s.dim() == 0 for s, _ in calls)  # one per batch, not per sample
    assert 0.1 <= sigmas.min().item() and sigmas.max().item() <= 2.0
    assert sigmas.unique().numel() == 50 and abs(sigmas.mean().item() - 1.05) <= 0.25
    on = calls[0][1]
    assert abs(on.float().mean().item() - 0.5) <= 3 * (0.25 / n) ** 0.5
    aug.random_gaussian_blur(gen, torch.zeros(4, 1, 4, 4), p=1.0)
    assert calls[-1][1] is None


def test_random_erasing_erases_its_share_within_scale():
    n, h, w = 4000, 32, 32
    out = aug.random_erasing(_gen(), torch.ones(n, 3, h, w), 0.5, (0.02, 0.33), (0.3, 3.3))
    zero = out[:, 0] == 0
    assert torch.equal(zero, out[:, 2] == 0)  # the same rectangle in every channel
    area = zero.sum(dim=(1, 2))
    erased = area > 0
    assert abs(erased.float().mean().item() - 0.5) <= 3 * (0.25 / n) ** 0.5
    # a rectangle: rows x columns touched equals the area
    rect = zero.any(dim=2).sum(dim=1) * zero.any(dim=1).sum(dim=1)
    assert torch.equal(rect, area)
    share = area[erased].float() / (h * w)
    # truncation to whole pixels only shrinks the drawn area
    assert share.max().item() <= 0.33 and share.min().item() >= 0.02 * 0.6
    assert abs(share.mean().item() - 0.175) <= 0.02
