"""What the plain references of every model family share: the weights made
from the seed, the CIFAR training augmentation, the dropout draws, the
SpectreLinear block, the products in float32 (or, for the control, in fp8),
cross-entropy, the cosine schedule and AdamW.

Everything here is plain PyTorch on float32 and is written from the
configuration's stated semantics (``portbench/configs/<config>.json``). It
imports nothing of the program under test. Random draws that the program
makes inside its step (the augmentation's and the dropout masks) are made
again here from a generator seeded alike, in the order the configuration's
forward makes them, so that both sides see the same draws.
"""

from __future__ import annotations

import math
from collections.abc import Callable, Iterator

import numpy as np
import torch
import torch.nn.functional as F

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}

# (format, largest finite value) of the fp8 control: e4m3 for activations
# and weights, e5m2 for gradients, each scaled per tensor to its amax
FP8_FORWARD = (torch.float8_e4m3fn, 448.0)
FP8_BACKWARD = (torch.float8_e5m2, 57344.0)


# -- weights -----------------------------------------------------------------

def make_params(spec: list[tuple], seed: int, device: torch.device | str) -> dict:
    """The leaves of ``spec`` ([(name, shape, kind, arg)]) made on ``device``
    from ``seed`` in a few large calls: one uniform draw for every
    ``uniform`` leaf (bound ``arg``), one normal draw for every ``normal``
    leaf (std ``arg``), one for the +-1 ``signs``, one for the block
    permutations (``block_perm``, block ``arg``: whole blocks move); ``ones``
    and ``zeros`` are constants. Trainable leaves are float32, permutations
    int32."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out: dict[str, torch.Tensor] = {}

    def numel(kind):
        return sum(math.prod(s) for _, s, k, _ in spec if k == kind)

    draws = {
        "uniform": torch.rand(numel("uniform"), generator=gen, device=device),
        "normal": torch.randn(numel("normal"), generator=gen, device=device),
        "signs": torch.rand(numel("signs"), generator=gen, device=device),
    }
    rows = [(s[-2], s[-1] // a) for _, s, k, a in spec if k == "block_perm"]
    if rows:
        heads, blocks = sum(h for h, _ in rows), rows[0][1]
        if any(b != blocks for _, b in rows):
            raise ValueError("block permutations of one spec must share their block count")
        keys = torch.rand(heads, blocks, generator=gen, device=device)
        draws["block_perm"] = torch.argsort(keys, dim=1).to(torch.int32)
    taken = {"uniform": 0, "normal": 0, "signs": 0, "block_perm": 0}
    for name, shape, kind, arg in spec:
        n = math.prod(shape)
        if kind in ("uniform", "normal", "signs"):
            flat = draws[kind][taken[kind]:taken[kind] + n]
            taken[kind] += n
            if kind == "uniform":
                leaf = (flat * 2.0 - 1.0) * arg
            elif kind == "normal":
                leaf = flat * arg
            else:
                leaf = torch.where(flat < 0.5, -1.0, 1.0)
            out[name] = leaf.reshape(shape).contiguous()
        elif kind == "block_perm":
            h, d = shape[-2], shape[-1]
            bperm = draws["block_perm"][taken[kind]:taken[kind] + h]
            taken[kind] += h
            t = torch.arange(arg, device=device, dtype=torch.int32)
            out[name] = (bperm[:, :, None] * arg + t).reshape(shape).contiguous()
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
        elif kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            raise ValueError(f"unknown leaf kind {kind!r} of {name}")
    return out


def trainable(spec: list[tuple]) -> list[str]:
    """The names of the leaves the optimizer updates (not the mix tables)."""
    return [name for name, _, kind, _ in spec if kind not in ("block_perm", "signs")]


# -- products ----------------------------------------------------------------

def _fp8(x: torch.Tensor, fmt: tuple) -> torch.Tensor:
    """x rounded to the fp8 format ``fmt`` with one scale for the tensor."""
    dtype, top = fmt
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = top / amax
    return (x * scale).to(dtype).to(torch.float32) / scale


class _Fp8Matmul(torch.autograd.Function):
    """a @ b with both operands rounded to e4m3 and the incoming gradient to
    e5m2, the products themselves in float32: what fp8 training computes."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a, FP8_FORWARD), _fp8(b, FP8_FORWARD)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fp8(g, FP8_BACKWARD)
        da = torch.matmul(qg, qb.transpose(-1, -2))
        db = torch.matmul(qa.transpose(-1, -2), qg)
        # undo broadcasting over leading dims (a weight shared by a batch)
        while db.dim() > qb.dim():
            db = db.sum(0)
        while da.dim() > qa.dim():
            da = da.sum(0)
        return da, db


def make_matmul(precision: str) -> Callable:
    """The product every reference layer calls: float32 (``"float32"``), or
    the control's fp8 operands (``"fp8"``)."""
    if precision == "float32":
        return torch.matmul
    if precision == "fp8":
        return _Fp8Matmul.apply
    raise ValueError(f"unknown reference precision {precision!r}")


# -- layers --------------------------------------------------------------------

def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], scale, bias, 1e-5)


def adaptive_pool(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """torch's AdaptiveAvgPool1d over the last axis (identity at equal
    widths)."""
    if x.shape[-1] == out_len:
        return x
    lead = x.shape[:-1]
    return F.adaptive_avg_pool1d(x.reshape(-1, 1, x.shape[-1]), out_len).reshape(*lead, out_len)


def spectre_linear(mm, x: torch.Tensor, p: dict, prefix: str) -> torch.Tensor:
    """GELU(LayerNorm(x W + b)) + AdaptiveAvgPool(x) to the output width
    (the identity when the widths match), the research repo's SpectreLinear."""
    w = p[prefix + ".kernel"]
    y = mm(x, w) + p[prefix + ".bias"]
    h = F.gelu(layer_norm(y, p[prefix + ".ln_scale"], p[prefix + ".ln_bias"]))
    return h + adaptive_pool(x, w.shape[1])


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Sum of the softmax cross-entropy over the rows (the caller divides)."""
    return F.cross_entropy(logits, labels.long(), reduction="sum")


# -- random draws of the step --------------------------------------------------

class Draws:
    """A generator on the device seeded as the program's train state seeds
    its own (the configuration's random seed); each draw here is made with
    the same call, shape and type as the configuration's step makes it."""

    def __init__(self, seed: int, device):
        self.gen = torch.Generator(device=device).manual_seed(int(seed))
        self.device = device

    def rand(self, shape: tuple) -> torch.Tensor:
        return torch.rand(shape, generator=self.gen, device=self.device, dtype=torch.float32)

    def uniform(self, shape: tuple, lo: float, hi: float) -> torch.Tensor:
        return self.rand(shape) * (hi - lo) + lo

    def keep_mask(self, shape: tuple, p: float, dtype: torch.dtype) -> torch.Tensor:
        """Inverted dropout's keep mask scaled by 1 / (1 - p), drawn as
        bernoulli(1 - p) over a tensor of ``dtype`` (the type the layer's
        activations have in the configuration), returned in float32."""
        keep = torch.empty(shape, dtype=dtype, device=self.device)
        keep.bernoulli_(1.0 - p, generator=self.gen)
        return keep.float() * (1.0 / (1.0 - p))


# -- the CIFAR training augmentation -----------------------------------------

_LUMA = (0.299, 0.587, 0.114)
_TO_YIQ = ((0.299, 0.587, 0.114), (0.5959, -0.2746, -0.3213), (0.2115, -0.5227, 0.3112))


def _gray(x: torch.Tensor) -> torch.Tensor:
    w = torch.tensor(_LUMA, device=x.device).view(1, 3, 1, 1)
    return (x * w).sum(dim=1, keepdim=True).expand(-1, 3, -1, -1)


def augment(draws: Draws, x: torch.Tensor, aug: dict, stats: dict) -> torch.Tensor:
    """The configuration's recipe on a float32 batch [B, 3, H, W] in [0, 1]:
    horizontal flip, colour jitter (brightness, contrast about the mean gray,
    saturation about the luma, hue as a rotation of the YIQ plane; clipped to
    [0, 1]), grayscale, rotation about the centre with the nearest source
    pixel (rounded half to even) and zero fill, a 3-tap Gaussian blur with
    one sigma a batch and zero padding, normalisation, random erasing."""
    b, _, h, w = x.shape
    col = (-1, 1, 1, 1)
    flip = draws.rand((b,)) < aug["hflip_p"]
    x = torch.where(flip.view(col), x.flip(-1), x)

    j = aug["jitter"]
    fb = draws.uniform((b,), 1 - j[0], 1 + j[0])
    fc = draws.uniform((b,), 1 - j[1], 1 + j[1])
    fs = draws.uniform((b,), 1 - j[2], 1 + j[2])
    theta = draws.uniform((b,), -j[3], j[3]) * (2 * math.pi)
    x = x * fb.view(col)
    mean_gray = _gray(x).mean(dim=(1, 2, 3), keepdim=True)
    x = mean_gray + fc.view(col) * (x - mean_gray)
    gray = _gray(x)
    x = gray + fs.view(col) * (x - gray)
    to_yiq = torch.tensor(_TO_YIQ, device=x.device)
    to_rgb = torch.linalg.inv(to_yiq.double()).float()
    yiq = torch.einsum("dc,bchw->bdhw", to_yiq, x)
    cos, sin = torch.cos(theta).view(-1, 1, 1), torch.sin(theta).view(-1, 1, 1)
    i, q = yiq[:, 1], yiq[:, 2]
    yiq = torch.stack([yiq[:, 0], cos * i - sin * q, sin * i + cos * q], dim=1)
    x = torch.einsum("cd,bdhw->bchw", to_rgb, yiq).clamp(0.0, 1.0)

    on = draws.rand((b,)) < aug["grayscale_p"]
    x = torch.where(on.view(col), _gray(x), x)

    angles = draws.uniform((b,), -aug["degrees"], aug["degrees"]) * (math.pi / 180.0)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ys = torch.arange(h, device=x.device, dtype=x.dtype)[:, None] - cy
    xs = torch.arange(w, device=x.device, dtype=x.dtype)[None, :] - cx
    cos, sin = torch.cos(angles).view(-1, 1, 1), torch.sin(angles).view(-1, 1, 1)
    sy = torch.round(cos * ys + sin * xs + cy)
    sx = torch.round(-sin * ys + cos * xs + cx)
    inside = (sy >= 0) & (sy < h) & (sx >= 0) & (sx < w)
    src = (sy.clamp(0, h - 1) * w + sx.clamp(0, w - 1)).long().reshape(b, 1, h * w)
    moved = x.reshape(b, 3, h * w).gather(2, src.expand(b, 3, h * w)).reshape(b, 3, h, w)
    x = torch.where(inside[:, None], moved, 0.0)

    lo, hi = aug["blur_sigma"]
    sigma = draws.uniform((), lo, hi)
    on = draws.rand((b,)) < aug["blur_p"]
    r = aug["blur_kernel"] // 2
    grid = torch.arange(-r, r + 1, device=x.device, dtype=x.dtype)
    k1d = torch.exp(-0.5 * (grid / sigma) ** 2)
    k1d = k1d / k1d.sum()
    kernel = (k1d[:, None] * k1d[None, :]).expand(3, 1, -1, -1)
    blurred = F.conv2d(x, kernel, padding=r, groups=3)
    x = torch.where(on.view(col), blurred, x)

    mean = torch.tensor(stats["mean"], device=x.device).view(1, -1, 1, 1)
    std = torch.tensor(stats["std"], device=x.device).view(1, -1, 1, 1)
    x = (x - mean) / std

    lo, hi = aug["erasing_scale"]
    rlo, rhi = aug["erasing_ratio"]
    on = draws.rand((b,)) < aug["erasing_p"]
    area = draws.uniform((b,), lo, hi)
    log_ratio = draws.uniform((b,), math.log(rlo), math.log(rhi))
    uy, ux = draws.uniform((b,), 0.0, 1.0), draws.uniform((b,), 0.0, 1.0)
    target = area * h * w
    ratio = torch.exp(log_ratio)
    eh = torch.sqrt(target * ratio).clamp(1, h).to(torch.int32)
    ew = torch.sqrt(target / ratio).clamp(1, w).to(torch.int32)
    y0 = (uy * (h - eh + 1)).to(torch.int32)
    x0 = (ux * (w - ew + 1)).to(torch.int32)
    rows = torch.arange(h, device=x.device)[None, :, None]
    cols = torch.arange(w, device=x.device)[None, None, :]
    b3 = (-1, 1, 1)
    box = ((rows >= y0.view(b3)) & (rows < (y0 + eh).view(b3)) & (cols >= x0.view(b3))
           & (cols < (x0 + ew).view(b3)) & on.view(b3))
    return torch.where(box[:, None], 0.0, x)


# -- the optimizer ---------------------------------------------------------------

def cosine_lr(opt: dict, step: int, steps_per_epoch: int) -> float:
    """The learning rate of the 0-based ``step``: linear warm-up, then a
    cosine from ``learning_rate`` down to ``eta_min`` over the run's steps."""
    lr = opt["learning_rate"]
    total = max(1, opt["epochs"] * steps_per_epoch)
    warm = opt["warmup_steps"]
    if step < warm:
        return lr * step / warm
    alpha = opt["eta_min"] / lr
    t = min(step - warm, total - warm) / (total - warm)
    return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t)) + alpha)


class AdamW:
    """Decoupled weight decay, then the bias-corrected Adam step:
    p <- p (1 - lr wd);  p <- p - lr m_hat / (sqrt(v_hat) + eps)."""

    def __init__(self, opt: dict):
        self.b1, self.b2 = opt["adam_betas"]
        self.wd, self.eps = opt["adam_weight_decay"], opt["eps"]
        self.m: dict[str, torch.Tensor] = {}
        self.v: dict[str, torch.Tensor] = {}
        self.t = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict, lr: float) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for name, g in grads.items():
            p = params[name]
            m = self.m.setdefault(name, torch.zeros_like(p))
            v = self.v.setdefault(name, torch.zeros_like(p))
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.mul_(1 - lr * self.wd)
            p.sub_(lr * (m / c1) / ((v / c2).sqrt() + self.eps))


# -- batches ---------------------------------------------------------------------

def shuffled_batches(n: int, batch: int, seed: int) -> Iterator[np.ndarray]:
    """The row indices of each training batch: every epoch a permutation of
    range(n) from numpy's PCG64 stream seeded ``seed`` (one shuffle an
    epoch), cut into full batches, the remainder dropped."""
    rng = np.random.default_rng(seed)
    while True:
        idx = np.arange(n)
        rng.shuffle(idx)
        for start in range(0, n - batch + 1, batch):
            yield idx[start:start + batch]
