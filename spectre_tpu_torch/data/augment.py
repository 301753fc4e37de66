"""Device-side augmentation (port of spectre_tpu/data/augment.py).

Every transform is a function of the whole [B, C, H, W] batch in torch ops on
the batch's device, run inside the train step, so the host moves raw pixels
only. Each op comes in two parts: ``<op>_apply(x, draws...)``, a
deterministic function of the batch and of explicit random draws (the same
arithmetic as the JAX op, held to it by the tests on the same draws), and
``random_<op>(generator, x, ...)``, which makes the draws from a
``torch.Generator`` on the batch's device and calls it. The random streams of
the two packages differ; the arithmetic does not.

No op synchronises with the host: no ``.item()``, no Python branch on a drawn
value, no boolean-mask indexing; a per-sample choice is a ``torch.where``
over the whole batch. Constant tensors (channel statistics, colour matrices)
are made once per device and kept. The blur is written as shifted adds, not
as a convolution call: a float32 convolution would run in TF32 on the card.

The resize and crop functions serve the distillation teacher's view
(``distill/loop.py``): ``resize_separable`` (bilinear or Keys-cubic, as two
products with 1-D resize matrices), ``resize_bilinear``,
``resize_bicubic_pil`` (PIL's pass order with a [0, 1] clip after each
pass) and ``center_crop`` (torchvision's offsets). The matrices are
``jax.image.resize``'s operators, built here in numpy: half-pixel centres,
the triangle kernel or Keys' cubic with a = -0.5, taps outside the image
dropped and the rest renormalised, and on a downscale the kernel widened by
the scale (antialias). ``F.interpolate(mode="bicubic")`` is another operator
(a = -0.75, edge pixels clamped) and is not used.
"""

from __future__ import annotations

import functools
import math
from collections.abc import Callable, Sequence
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

# ITU-R 601 luma weights (torchvision's rgb_to_grayscale convention).
_LUMA = (0.299, 0.587, 0.114)
_TO_YIQ = ((0.299, 0.587, 0.114), (0.5959, -0.2746, -0.3213), (0.2115, -0.5227, 0.3112))


@functools.lru_cache(maxsize=None)
def _constant(values: tuple, shape: tuple, device: torch.device, dtype: torch.dtype):
    """A constant tensor, copied to ``device`` once."""
    return torch.tensor(values, dtype=dtype).reshape(shape).to(device)


def _channel_stat(values: Sequence[float], like: torch.Tensor) -> torch.Tensor:
    return _constant(tuple(float(v) for v in values), (1, -1, 1, 1), like.device, like.dtype)


def _yiq_matrices(like: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    inv = np.linalg.inv(np.asarray(_TO_YIQ, np.float32))
    return (_constant(_TO_YIQ, (3, 3), like.device, like.dtype),
            _constant(tuple(map(tuple, inv.tolist())), (3, 3), like.device, like.dtype))


class RowWindow(NamedTuple):
    """A generator seen by one slice of a larger batch: each per-sample draw
    is made for all ``rows`` samples and this slice keeps its ``start``..
    rows, so that the draws do not depend on how the batch is split over
    ranks (``parallel/layout.py``). Per-batch draws are made whole."""
    generator: torch.Generator
    rows: int
    start: int


def _rand(generator, shape: tuple, like: torch.Tensor) -> torch.Tensor:
    if isinstance(generator, RowWindow):
        if shape and shape[0] == like.shape[0]:
            full = torch.rand((generator.rows, *shape[1:]), generator=generator.generator,
                              device=like.device, dtype=like.dtype)
            return full[generator.start:generator.start + shape[0]]
        generator = generator.generator
    return torch.rand(shape, generator=generator, device=like.device, dtype=like.dtype)


def _uniform(generator, shape: tuple, lo: float, hi: float,
             like: torch.Tensor) -> torch.Tensor:
    return _rand(generator, shape, like) * (hi - lo) + lo


def _bernoulli(generator, shape: tuple, p: float, like: torch.Tensor) -> torch.Tensor:
    return _rand(generator, shape, like) < p


def normalize(x: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    """Channel-wise (x - mean) / std, NCHW."""
    return (x - _channel_stat(mean, x)) / _channel_stat(std, x)


def hflip_apply(x: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Mirror the samples whose ``flip`` ([B] bool) is set."""
    return torch.where(flip.view(-1, 1, 1, 1), x.flip(-1), x)


def random_hflip(generator: torch.Generator, x: torch.Tensor, p: float = 0.5) -> torch.Tensor:
    return hflip_apply(x, _bernoulli(generator, (x.shape[0],), p, x))


def _grayscale(x: torch.Tensor) -> torch.Tensor:
    if x.shape[1] != 3:
        return x
    w = _constant(_LUMA, (1, 3, 1, 1), x.device, x.dtype)
    return (x * w).sum(dim=1, keepdim=True).expand(-1, 3, -1, -1)


def grayscale_apply(x: torch.Tensor, on: torch.Tensor) -> torch.Tensor:
    """Replace the samples whose ``on`` ([B] bool) is set by their luma."""
    return torch.where(on.view(-1, 1, 1, 1), _grayscale(x), x)


def random_grayscale(generator: torch.Generator, x: torch.Tensor, p: float = 0.1) -> torch.Tensor:
    return grayscale_apply(x, _bernoulli(generator, (x.shape[0],), p, x))


def color_jitter_apply(x: torch.Tensor, fb: torch.Tensor, fc: torch.Tensor,
                       fs: torch.Tensor | None = None,
                       theta: torch.Tensor | None = None) -> torch.Tensor:
    """Brightness factor ``fb``, contrast factor ``fc`` about the mean gray,
    and for 3 channels saturation factor ``fs`` about the luma and hue as a
    rotation of the YIQ plane by ``theta`` radians (None: no hue shift); all
    [B]. Clipped to [0, 1]."""
    col = (-1, 1, 1, 1)
    x = x * fb.view(col)
    mean_gray = _grayscale(x).mean(dim=(1, 2, 3), keepdim=True)
    x = mean_gray + fc.view(col) * (x - mean_gray)
    if x.shape[1] == 3:
        gray = _grayscale(x)
        x = gray + fs.view(col) * (x - gray)
        if theta is not None:
            to_yiq, to_rgb = _yiq_matrices(x)
            yiq = torch.einsum("dc,bchw->bdhw", to_yiq, x)
            cos, sin = torch.cos(theta).view(-1, 1, 1), torch.sin(theta).view(-1, 1, 1)
            i, q = yiq[:, 1], yiq[:, 2]
            yiq = torch.stack([yiq[:, 0], cos * i - sin * q, sin * i + cos * q], dim=1)
            x = torch.einsum("cd,bdhw->bchw", to_rgb, yiq)
    return x.clamp(0.0, 1.0)


def random_color_jitter(generator: torch.Generator, x: torch.Tensor, brightness: float = 0.2,
                        contrast: float = 0.2, saturation: float = 0.2,
                        hue: float = 0.02) -> torch.Tensor:
    b = (x.shape[0],)
    fb = _uniform(generator, b, 1 - brightness, 1 + brightness, x)
    fc = _uniform(generator, b, 1 - contrast, 1 + contrast, x)
    fs = theta = None
    if x.shape[1] == 3:
        fs = _uniform(generator, b, 1 - saturation, 1 + saturation, x)
        if hue > 0:
            theta = _uniform(generator, b, -hue, hue, x) * (2 * math.pi)
    return color_jitter_apply(x, fb, fc, fs, theta)


def _src_coords(x: torch.Tensor, angles: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse-map source coordinates [B, H, W] for rotating each image of
    ``x`` about its centre by its angle (radians)."""
    h, w = x.shape[-2:]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ys = torch.arange(h, dtype=x.dtype, device=x.device)[:, None] - cy
    xs = torch.arange(w, dtype=x.dtype, device=x.device)[None, :] - cx
    cos, sin = torch.cos(angles).view(-1, 1, 1), torch.sin(angles).view(-1, 1, 1)
    return cos * ys + sin * xs + cy, -sin * ys + cos * xs + cx


def _gather_px(x: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """x[b, :, yi[b], xi[b]] with zeros where the coordinate is outside."""
    b, c, h, w = x.shape
    valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
    idx = yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
    out = x.reshape(b, c, h * w).gather(2, idx.reshape(b, 1, h * w).expand(b, c, h * w))
    return torch.where(valid[:, None], out.reshape(b, c, h, w), 0.0)


def rotate_apply(x: torch.Tensor, angles: torch.Tensor,
                 interpolation: str = "nearest") -> torch.Tensor:
    """Rotate each image by its angle ([B], radians) about the centre, zero
    fill. ``nearest`` rounds the source coordinate half to even, one gather
    per image; ``bilinear`` blends four."""
    src_y, src_x = _src_coords(x, angles.to(x.dtype))
    if interpolation == "nearest":
        return _gather_px(x, torch.round(src_y), torch.round(src_x))
    y0, x0 = torch.floor(src_y), torch.floor(src_x)
    wy, wx = (src_y - y0)[:, None], (src_x - x0)[:, None]
    return (_gather_px(x, y0, x0) * (1 - wy) * (1 - wx)
            + _gather_px(x, y0, x0 + 1) * (1 - wy) * wx
            + _gather_px(x, y0 + 1, x0) * wy * (1 - wx)
            + _gather_px(x, y0 + 1, x0 + 1) * wy * wx)


def random_rotate(generator: torch.Generator, x: torch.Tensor, degrees: float = 30.0,
                  interpolation: str = "nearest") -> torch.Tensor:
    """Per-sample uniform rotation in [-degrees, degrees]."""
    angles = _uniform(generator, (x.shape[0],), -degrees, degrees, x) * (math.pi / 180.0)
    return rotate_apply(x, angles, interpolation)


def gaussian_blur_apply(x: torch.Tensor, sigma: torch.Tensor, on: torch.Tensor | None = None,
                        kernel_size: int = 3) -> torch.Tensor:
    """Separable Gaussian blur with one ``sigma`` (0-d tensor) for the whole
    batch: two depthwise 1-D passes with zero padding, kept for the samples
    whose ``on`` ([B] bool) is set (None: all)."""
    r = kernel_size // 2
    grid = torch.arange(-r, r + 1, dtype=x.dtype, device=x.device)
    k1d = torch.exp(-0.5 * (grid / sigma) ** 2)
    k1d = k1d / k1d.sum()
    h, w = x.shape[-2:]
    xp = F.pad(x, (r, r))
    blurred = sum(k1d[i] * xp[..., i:i + w] for i in range(kernel_size))
    xp = F.pad(blurred, (0, 0, r, r))
    blurred = sum(k1d[i] * xp[..., i:i + h, :] for i in range(kernel_size))
    if on is None:
        return blurred
    return torch.where(on.view(-1, 1, 1, 1), blurred, x)


def random_gaussian_blur(generator: torch.Generator, x: torch.Tensor, kernel_size: int = 3,
                         sigma_range: tuple[float, float] = (0.1, 2.0),
                         p: float = 1.0) -> torch.Tensor:
    sigma = _uniform(generator, (), sigma_range[0], sigma_range[1], x)
    on = None if p >= 1.0 else _bernoulli(generator, (x.shape[0],), p, x)
    return gaussian_blur_apply(x, sigma, on, kernel_size)


def erasing_apply(x: torch.Tensor, on: torch.Tensor, area: torch.Tensor, log_ratio: torch.Tensor,
                  uy: torch.Tensor, ux: torch.Tensor) -> torch.Tensor:
    """Zero one rectangle in each sample whose ``on`` is set: ``area`` is its
    share of the image, ``log_ratio`` the log of height over width, ``uy`` and
    ``ux`` in [0, 1) place it; all [B]."""
    h, w = x.shape[-2:]
    target = area * h * w
    r = torch.exp(log_ratio)
    eh = torch.sqrt(target * r).clamp(1, h).to(torch.int32)
    ew = torch.sqrt(target / r).clamp(1, w).to(torch.int32)
    y0 = (uy * (h - eh + 1)).to(torch.int32)
    x0 = (ux * (w - ew + 1)).to(torch.int32)
    rows = torch.arange(h, device=x.device)[None, :, None]
    cols = torch.arange(w, device=x.device)[None, None, :]
    b3 = (-1, 1, 1)
    mask = ((rows >= y0.view(b3)) & (rows < (y0 + eh).view(b3))
            & (cols >= x0.view(b3)) & (cols < (x0 + ew).view(b3)) & on.view(b3))
    return torch.where(mask[:, None], 0.0, x)


def random_erasing(generator: torch.Generator, x: torch.Tensor, p: float = 0.5,
                   scale: tuple[float, float] = (0.02, 0.33),
                   ratio: tuple[float, float] = (0.3, 3.3)) -> torch.Tensor:
    """Zero out a random rectangle per sample with probability ``p``; the
    on/off draw and the area draw are separate."""
    b = (x.shape[0],)
    on = _bernoulli(generator, b, p, x)
    area = _uniform(generator, b, scale[0], scale[1], x)
    log_ratio = _uniform(generator, b, math.log(ratio[0]), math.log(ratio[1]), x)
    uy, ux = _uniform(generator, b, 0.0, 1.0, x), _uniform(generator, b, 0.0, 1.0, x)
    return erasing_apply(x, on, area, log_ratio, uy, ux)


def make_train_augment(mean: Sequence[float], std: Sequence[float], *, hflip: bool = True,
                       jitter: bool = True, grayscale_p: float = 0.2, degrees: float = 30.0,
                       blur_p: float = 0.5, erasing_p: float = 0.5) -> Callable:
    """The CIFAR-100 training pipeline as one ``(generator, batch) -> batch``
    function: flip, ColorJitter(0.4, 0.4, 0.4, 0.1), grayscale, rotation
    (nearest), blur with probability ``blur_p``, normalise, erasing; a knob at
    0 or False drops its op. The generator lies on the batch's device."""

    def augment(generator: torch.Generator, x: torch.Tensor) -> torch.Tensor:
        if hflip:
            x = random_hflip(generator, x)
        if jitter:
            x = random_color_jitter(generator, x, 0.4, 0.4, 0.4, 0.1)
        if grayscale_p > 0:
            x = random_grayscale(generator, x, grayscale_p)
        if degrees > 0:
            x = random_rotate(generator, x, degrees)
        if blur_p > 0:
            x = random_gaussian_blur(generator, x, p=blur_p)
        x = normalize(x, mean, std)
        if erasing_p > 0:
            x = random_erasing(generator, x, erasing_p)
        return x

    return augment


def make_eval_transform(mean: Sequence[float], std: Sequence[float]) -> Callable:
    """The eval path: normalise only."""
    return lambda x: normalize(x, mean, std)


def _fma(a, b, c) -> np.ndarray:
    """a * b + c in float32 with one rounding, as a fused multiply-add: the
    product and sum are exact in float64 for float32 operands of these
    magnitudes."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel with a = -0.5 at |x|, float32."""
    f = np.float32
    inner = _fma(_fma(f(1.5), x, f(-2.5)) * x, x, f(1.0))
    outer = _fma(_fma(_fma(f(-0.5), x, f(2.5)), x, f(-4.0)), x, f(2.0))
    return np.where(x >= 2.0, f(0.0), np.where(x >= 1.0, outer, inner)).astype(f)


_RESIZE_KERNELS = {"bilinear": lambda x: np.maximum(np.float32(0.0), np.float32(1.0) - x),
                   "bicubic": _keys_cubic}


@functools.lru_cache(maxsize=None)
def resize_matrix(in_size: int, out_size: int, method: str = "bilinear") -> np.ndarray:
    """The [out_size, in_size] float32 operator of a 1-D resize: output i
    samples the input at (i + 0.5) / scale - 0.5; the kernel is widened by
    1 / scale on a downscale; each output's weights over the input's taps
    are renormalised to sum to one (taps past the edge are dropped). In
    float32, with the multiply-adds fused, as the compiled
    ``jax.image.resize`` computes it (within 2.4e-7 of it)."""
    f32 = np.float32
    kernel = _RESIZE_KERNELS[method]
    inv_scale = f32(1.0 / (out_size / in_size))  # in float64 first, as JAX takes it
    sample = _fma(np.arange(out_size, dtype=f32) + f32(0.5), inv_scale, f32(-0.5))
    dist = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None])
    w = kernel(dist / max(inv_scale, f32(1.0)))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0) * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    m = np.ascontiguousarray(np.where(inside[None, :], w, f32(0.0)).T.astype(f32))
    m.setflags(write=False)
    return m


@functools.lru_cache(maxsize=None)
def _resize_tensor(in_size: int, out_size: int, method: str, device: torch.device,
                   dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(resize_matrix(in_size, out_size, method).copy()).to(device, dtype)


def _resize_operator(in_size: int, out_size: int, method: str,
                     like: torch.Tensor) -> torch.Tensor:
    """``resize_matrix`` on ``like``'s device and dtype, copied there once."""
    return _resize_tensor(in_size, out_size, method, like.device, like.dtype)


def resize_separable(x: torch.Tensor, size: int, method: str = "bilinear") -> torch.Tensor:
    """Resize [B, C, H, W] to [B, C, size, size] as two products with 1-D
    operators (``resize_matrix``): rows (H) first, then columns (W)."""
    h, w = x.shape[-2:]
    if (h, w) == (size, size):
        return x
    rh = _resize_operator(h, size, method, x)
    rw = _resize_operator(w, size, method, x)
    return torch.matmul(torch.matmul(rh, x), rw.t())


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    return resize_separable(x, size, "bilinear")


def resize_bicubic_pil(x: torch.Tensor, size: int) -> torch.Tensor:
    """Bicubic resize of [0, 1] pixels in PIL's pass order: columns (W)
    first, then rows (H), with a [0, 1] clip after each pass, as PIL stores
    each pass as uint8. Square inputs (the caller checks)."""
    h, w = x.shape[-2:]
    if (h, w) == (size, size):
        return x
    rw = _resize_operator(w, size, "bicubic", x)
    rh = _resize_operator(h, size, "bicubic", x)
    x = torch.matmul(x, rw.t()).clamp(0.0, 1.0)
    return torch.matmul(rh, x).clamp(0.0, 1.0)


def center_crop(x: torch.Tensor, size: int) -> torch.Tensor:
    """torchvision ``CenterCrop(size)`` of [B, C, H, W]: offsets
    ``int(round((H - size) / 2))`` per axis (round half to even)."""
    h, w = x.shape[-2:]
    top, left = int(round((h - size) / 2.0)), int(round((w - size) / 2.0))
    return x[..., top:top + size, left:left + size]
