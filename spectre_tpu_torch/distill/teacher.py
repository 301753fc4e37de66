"""The distillation teacher (port of spectre_tpu/distill/teacher.py): a
DINO-family ViT-S/16 and its linear classifier, frozen.

- ``DinoVisionTransformer``: patchify as reshape + ``Dense``, a CLS and
  ``num_registers`` register tokens, pre-norm blocks (LayerNorm eps 1e-6,
  attention with q, k and v biases, LayerScale, exact-GELU MLP) and a final
  LayerNorm; ``forward_features`` returns the DINO dict
  (``x_norm_clstoken``, ``x_norm_regtokens``, ``x_norm_patchtokens``).
  ``variant="v3"`` (DINOv3, the default): no absolute position embedding,
  axial 2D RoPE on q and k of the patch tokens only (CLS and registers stay
  unrotated). ``variant="v2"``: a learned ``pos_embed`` on CLS and patches.
- ``DinoClassifier``: ``decoder(backbone(x)["x_norm_clstoken"])``.
- ``import_torch_state_dict``: a DINOv2/v3 ``state_dict`` (numpy arrays)
  into the port's modules: the fused ``qkv`` split into query, key and
  value, ``storage_tokens`` / ``reg_tokens`` as the registers, ``mask_token``
  dropped, ``rope_embed.periods`` checked, unused keys reported.
- ``load_teacher``: seeded random weights, or a ``state_dict`` dumped to
  ``.npz`` (``teacher_checkpoint`` or ``$SPECTRE_TEACHER_WEIGHTS``).

The modules and parameters carry the flax names and layouts (Dense kernels
[in, out]; query, key, value [E, H, D]; out [H, D, E]), so the weight
bridge (``models/jax_import.py``) loads the JAX teacher's variables as they
are. No TPU kernel lies here, and the JAX teacher's attention is a plain
einsum and softmax: so is this one (not SDPA, and not kernel B4, which
takes N <= 128; the teacher has 201 tokens at 224 px).

Arithmetic in a bf16 compute dtype follows the flax modules': the residual
stream stays in the float32 of the parameters (the CLS token and LayerScale
promote it), LayerNorm statistics are float32 and its output is cast to
the compute dtype, every projection runs in the compute dtype, the softmax
in float32 cast back, and the classifier's decoder in float32.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from spectre_tpu_torch.models.init import lecun_normal_, normal_
from spectre_tpu_torch.models.layers import Dense
from spectre_tpu_torch.models.mixers import _HeadsDense, _HeadsOut

VARIANTS = ("v3", "v2")


def rope_periods_from_base(head_dim: int, base: float = 100.0) -> torch.Tensor:
    """The base-spaced rotation periods [D/4], float32:
    ``base ** (2i / (D/2))``. A real DINOv3 checkpoint ships its own in
    ``rope_embed.periods``, which win."""
    dh = head_dim // 2
    return base ** (torch.arange(dh // 2, dtype=torch.float32) * 2.0 / dh)


def rope_2d_angles(n_side: int, head_dim: int, base: float = 100.0,
                   periods=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Axial 2D RoPE tables (cos, sin), each [N, D] float32, for an
    n_side x n_side patch grid: patch centres normalised to [-1, 1] per
    axis, the head dim split into an x half and a y half, and within each
    half the pair (2i, 2i + 1) rotated by ``coord / periods[i]``."""
    coords = (torch.arange(n_side, dtype=torch.float32) + 0.5) / n_side * 2.0 - 1.0
    yy, xx = torch.meshgrid(coords, coords, indexing="ij")
    pos = torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1)  # [N, 2]
    if periods is None:
        periods = rope_periods_from_base(head_dim, base)
    freqs = 1.0 / torch.as_tensor(periods, dtype=torch.float32)  # [D/4]
    ang = (pos[:, :, None] * freqs[None, None, :]).repeat_interleave(2, dim=-1)
    ang = ang.reshape(ang.shape[0], head_dim)  # x half, then y half
    return torch.cos(ang), torch.sin(ang)


@functools.lru_cache(maxsize=None)
def _rope_tables(n_prefix: int, n_side: int, head_dim: int, periods: tuple | None,
                 device: torch.device, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """``rope_2d_angles`` in ``dtype`` on ``device``, made once, for all the
    tokens: the ``n_prefix`` unrotated ones first (cos 1, sin 0, which
    leave them exactly as they are), and sin with the pair rotation's signs
    folded in (-sin on even features, +sin on odd), for ``_rope_swapped``."""
    cos, sin = rope_2d_angles(n_side, head_dim, periods=periods)
    cos, sin = cos.to(dtype), sin.to(dtype)
    sign = torch.tensor([-1.0, 1.0], dtype=dtype).repeat(head_dim // 2)
    cos = torch.cat([torch.ones(n_prefix, head_dim, dtype=dtype), cos])
    sin = torch.cat([torch.zeros(n_prefix, head_dim, dtype=dtype), sin * sign])
    return cos.to(device), sin.to(device)


def _rope_swapped(t: torch.Tensor, cos: torch.Tensor, signed_sin: torch.Tensor) -> torch.Tensor:
    """``apply_rope`` with the pair rotation as a swap of each pair and the
    signs in the table: (x0, x1) -> (x0 c - x1 s, x1 c + x0 s), the same
    products and sums in the same order."""
    swapped = t.unflatten(-1, (-1, 2)).flip(-1).flatten(-2)
    return t * cos[None, :, None, :] + swapped * signed_sin[None, :, None, :]


def _rotate_pairs(t: torch.Tensor) -> torch.Tensor:
    """(x0, x1, x2, x3, ...) -> (-x1, x0, -x3, x2, ...) on the last axis."""
    t2 = t.reshape(*t.shape[:-1], t.shape[-1] // 2, 2)
    return torch.stack([-t2[..., 1], t2[..., 0]], dim=-1).reshape(t.shape)


def apply_rope(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """t [B, N, H, D] rotated by the tables cos, sin [N, D]."""
    return t * cos[None, :, None, :] + _rotate_pairs(t) * sin[None, :, None, :]


class _LayerNorm(nn.LayerNorm):
    """flax ``LayerNorm(epsilon=1e-6, dtype)``: float32 statistics, the
    result cast to the compute ``dtype``."""

    def __init__(self, dim: int, *, dtype, param_dtype, device):
        super().__init__(dim, eps=1e-6, dtype=param_dtype, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(self.compute_dtype)


class _Attention(nn.Module):
    """Self-attention with separate ``query``, ``key``, ``value`` and ``out``
    projections in flax's layouts. With ``num_prefix`` set (v3), axial 2D
    RoPE rotates q and k of the tokens after the first ``num_prefix`` and the
    scores are scaled after the product; without (v2, flax's
    ``MultiHeadDotProductAttention``) q is scaled before it."""

    def __init__(self, dim: int, num_heads: int, *, use_rope: bool, num_prefix: int,
                 rope_periods: tuple | None, dtype, param_dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.query = _HeadsDense(dim, num_heads, **kw)
        self.key = _HeadsDense(dim, num_heads, **kw)
        self.value = _HeadsDense(dim, num_heads, **kw)
        self.out = _HeadsOut(dim, num_heads, **kw)
        self.dtype, self.head_dim = dtype, dim // num_heads
        self.use_rope, self.num_prefix, self.rope_periods = use_rope, num_prefix, rope_periods

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        q, k, v = self.query(x), self.key(x), self.value(x)  # [B, N, H, D]
        scale = self.head_dim ** 0.5
        if self.use_rope:
            p = self.num_prefix
            n_side = int(round((x.shape[1] - p) ** 0.5))
            cos, sin = _rope_tables(p, n_side, self.head_dim, self.rope_periods, x.device,
                                    q.dtype)
            q, k = _rope_swapped(q, cos, sin), _rope_swapped(k, cos, sin)
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / scale
        else:
            scores = torch.einsum("bqhd,bkhd->bhqk", q / scale, k)
        attn = torch.softmax(scores, dim=-1, dtype=torch.float32).to(v.dtype)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", attn, v))


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, *, dtype, param_dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.fc1 = Dense(dim, hidden, **kw)
        self.fc2 = Dense(hidden, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class _Block(nn.Module):
    """Pre-norm block with LayerScale: x + ls1 * attn(norm1(x)), then
    x + ls2 * mlp(norm2(x))."""

    def __init__(self, dim: int, num_heads: int, *, use_rope: bool, num_prefix: int,
                 rope_periods: tuple | None, dtype, param_dtype, device, mlp_ratio: float = 4.0,
                 layerscale_init: float = 1e-5):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.norm1 = _LayerNorm(dim, **kw)
        self.attn = _Attention(dim, num_heads, use_rope=use_rope, num_prefix=num_prefix,
                               rope_periods=rope_periods, **kw)
        self.ls1_gamma = nn.Parameter(torch.full((dim,), layerscale_init, dtype=param_dtype,
                                                 device=device))
        self.norm2 = _LayerNorm(dim, **kw)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio), **kw)
        self.ls2_gamma = nn.Parameter(torch.full((dim,), layerscale_init, dtype=param_dtype,
                                                 device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x)) * self.ls1_gamma
        return x + self.mlp(self.norm2(x)) * self.ls2_gamma


class DinoVisionTransformer(nn.Module):
    """The DINO ViT backbone; the defaults are ViT-S/16 at 224 px (E=384, 6
    heads of 64, 12 blocks, 4 registers: 196 + 1 + 4 = 201 tokens)."""

    def __init__(self, img_size: int = 224, patch_size: int = 16, in_channels: int = 3,
                 embed_dim: int = 384, depth: int = 12, num_heads: int = 6,
                 num_registers: int = 4, variant: str = "v3",
                 rope_periods: tuple | None = None, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
        self.img_size, self.patch_size, self.in_channels = img_size, patch_size, in_channels
        self.embed_dim, self.depth, self.num_heads = embed_dim, depth, num_heads
        self.num_registers, self.variant = num_registers, variant
        self.rope_periods = None if rope_periods is None else tuple(map(float, rope_periods))
        n = (img_size // patch_size) ** 2
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        pw = dict(dtype=param_dtype, device=device)
        self.patch_embed = Dense(in_channels * patch_size * patch_size, embed_dim, **kw)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim, **pw))
        self.register_tokens = nn.Parameter(torch.zeros(1, num_registers, embed_dim, **pw))
        if variant == "v2":
            self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, embed_dim, **pw))
        for i in range(depth):
            self.add_module(f"block_{i}", _Block(
                embed_dim, num_heads, use_rope=variant == "v3", num_prefix=1 + num_registers,
                rope_periods=self.rope_periods, **kw))
        self.norm = _LayerNorm(embed_dim, **kw)

    def blocks(self) -> list[_Block]:
        return [getattr(self, f"block_{i}") for i in range(self.depth)]

    def forward_features(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        """x [B, C, img, img] -> the DINO feature dict."""
        b, p, s = x.shape[0], self.patch_size, self.img_size // self.patch_size
        xp = x.reshape(b, self.in_channels, s, p, s, p).permute(0, 2, 4, 1, 3, 5)
        tokens = self.patch_embed(xp.reshape(b, s * s, self.in_channels * p * p))
        e = self.embed_dim
        cls = self.cls_token.expand(b, 1, e)
        if self.variant == "v2":
            cls = cls + self.pos_embed[:, :1]
            tokens = tokens + self.pos_embed[:, 1:]
        # the parameters' float32 promotes the stream, as in the flax module
        tokens = torch.cat([cls, self.register_tokens.expand(b, self.num_registers, e),
                            tokens], dim=1)
        for block in self.blocks():
            tokens = block(tokens)
        tokens = self.norm(tokens)
        r = self.num_registers
        return {"x_norm_clstoken": tokens[:, 0], "x_norm_regtokens": tokens[:, 1:1 + r],
                "x_norm_patchtokens": tokens[:, 1 + r:]}

    forward = forward_features


class DinoClassifier(nn.Module):
    """``decoder(backbone.forward_features(x)["x_norm_clstoken"])``, the
    decoder a float32 ``Dense``."""

    def __init__(self, backbone: DinoVisionTransformer, num_classes: int):
        super().__init__()
        self.backbone = backbone
        self.num_classes = num_classes
        self.decoder = Dense(backbone.embed_dim, num_classes, dtype=backbone.cls_token.dtype,
                             param_dtype=backbone.cls_token.dtype,
                             device=backbone.cls_token.device)

    def forward(self, x: torch.Tensor, return_features: bool = False):
        feats = self.backbone(x)["x_norm_clstoken"]
        logits = self.decoder(feats)
        return (logits, feats) if return_features else logits


@torch.no_grad()
def init_teacher(model: DinoClassifier, gen: torch.Generator) -> None:
    """The flax teacher's distributions, drawn in module order: every
    projection kernel lecun-normal over its fan-in (truncated at two
    standard deviations) and its bias zero; the CLS and register tokens and
    ``pos_embed`` normal(0, 0.02); LayerScale 1e-5 and LayerNorm ones /
    zeros as constructed."""
    for m in model.modules():
        if isinstance(m, (Dense, _HeadsDense, _HeadsOut)):
            fan_in = m.kernel.shape[0] * (m.kernel.shape[1] if isinstance(m, _HeadsOut) else 1)
            lecun_normal_(m.kernel, fan_in, gen)
            m.bias.zero_()
    bb = model.backbone
    for p in (bb.cls_token, bb.register_tokens, getattr(bb, "pos_embed", None)):
        if p is not None:
            normal_(p, gen, std=0.02)


def _torch_key_map(model: DinoVisionTransformer, sd: dict) -> tuple[dict, set]:
    """{port parameter name: array} for the keys of a DINOv2/v3 torch
    ``state_dict`` that map, and the keys used. A torch Linear weight
    [out, in] becomes a kernel [in, out]; the fused qkv is split into
    query, key and value [E, H, D]; the out projection [E_out, E_in] is
    transposed before its input splits into heads ([H, D, E]). A tensor
    whose shape does not match its parameter is left out (and reported)."""
    e, heads = model.embed_dim, model.num_heads
    hd = e // heads
    state = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    out: dict[str, np.ndarray] = {}
    used: set[str] = set()

    def put(name, arr):
        if state.get(name) == tuple(arr.shape):
            out[name] = arr
            return True
        return False

    simple = {"norm1.weight": "norm1.weight", "norm1.bias": "norm1.bias",
              "norm2.weight": "norm2.weight", "norm2.bias": "norm2.bias",
              "mlp.fc1.bias": "mlp.fc1.bias", "mlp.fc2.bias": "mlp.fc2.bias",
              "ls1.gamma": "ls1_gamma", "ls2.gamma": "ls2_gamma",
              "attn.proj.bias": "attn.out.bias"}
    for tk, arr in sd.items():
        arr = np.asarray(arr)
        name = None
        if tk == "cls_token":
            name, arr = "cls_token", arr.reshape(1, 1, -1)
        elif tk in ("register_tokens", "reg_tokens", "storage_tokens"):
            name = "register_tokens"  # DINOv3 names them storage_tokens
        elif tk == "pos_embed":
            name = "pos_embed"
        elif tk == "patch_embed.proj.weight":  # conv [E, C, P, P] -> [C*P*P, E]
            name, arr = "patch_embed.kernel", arr.reshape(arr.shape[0], -1).T
        elif tk == "patch_embed.proj.bias":
            name = "patch_embed.bias"
        elif tk in ("norm.weight", "norm.bias"):
            name = tk
        elif tk.startswith("blocks.") or ".blocks." in tk:
            parts = tk.split(".")
            at = parts.index("blocks")
            base, rest = f"block_{parts[at + 1]}", ".".join(parts[at + 2:])
            if rest in simple:
                name = f"{base}.{simple[rest]}"
            elif rest in ("mlp.fc1.weight", "mlp.fc2.weight"):
                name, arr = f"{base}.{rest[:-len('weight')]}kernel", arr.T
            elif rest == "attn.proj.weight":
                # kernel[h, d, o] = W[o, h * D + d]: transpose first. A
                # square matrix passes every shape check either way
                name = f"{base}.attn.out.kernel"
                arr = np.ascontiguousarray(arr.T).reshape(heads, hd, arr.shape[0])
            elif rest in ("attn.qkv.weight", "attn.qkv.bias"):
                parts3 = arr.reshape(3, e, e) if rest.endswith("weight") else arr.reshape(3, e)
                for proj, mat in zip(("query", "key", "value"), parts3):
                    if rest.endswith("weight"):
                        put(f"{base}.attn.{proj}.kernel", mat.T.reshape(e, heads, hd))
                    else:
                        put(f"{base}.attn.{proj}.bias", mat.reshape(heads, hd))
                used.add(tk)
                continue
        if name is not None and put(name, np.ascontiguousarray(arr)):
            used.add(tk)
    return out, used


@torch.no_grad()
def import_torch_state_dict(model: DinoVisionTransformer, sd: dict) -> list[str]:
    """Load a DINOv2/v3 torch ``state_dict`` (numpy arrays) into ``model``
    in place; returns the keys it did not use. ``mask_token`` (masked
    modelling only) is dropped on purpose. ``rope_embed.periods`` is checked
    against the model's periods and raises on a mismatch before anything is
    loaded (``load_teacher`` builds the model around the checkpoint's)."""
    used = set()
    if "rope_embed.periods" in sd:
        got = np.asarray(sd["rope_embed.periods"], np.float32).reshape(-1)
        dh = model.embed_dim // model.num_heads
        have = (np.asarray(model.rope_periods, np.float32) if model.rope_periods is not None
                else rope_periods_from_base(dh).numpy())
        if got.shape != have.shape or not np.allclose(got, have, rtol=1e-5):
            raise ValueError(
                f"checkpoint rope_embed.periods differ from the model's (checkpoint "
                f"{got.shape}, model {have.shape}); build the backbone with "
                "rope_periods=tuple(checkpoint periods), as load_teacher does")
        used.add("rope_embed.periods")
    if "mask_token" in sd:
        used.add("mask_token")
    arrays, mapped = _torch_key_map(model, sd)
    params = model.state_dict()
    for name, arr in arrays.items():
        params[name].copy_(torch.from_numpy(np.asarray(arr, np.float32)))
    return sorted(set(sd) - used - mapped)


def load_teacher(num_classes: int, img_size: int = 224, seed: int = 0, variant: str = "v3",
                 weights_path: str | None = None, dtype=torch.float32,
                 device: torch.device | str = "cuda", **backbone) -> DinoClassifier:
    """The frozen teacher (eval mode, no gradients) on ``device`` (the card
    by default, as every entry point of the port; pass "cpu"): ViT-S/16
    unless ``backbone`` overrides its sizes (``patch_size``, ``embed_dim``,
    ``depth``, ``num_heads``, ``num_registers``). ``dtype`` is the compute
    dtype; the parameters stay float32. Weights come from ``weights_path``
    or ``$SPECTRE_TEACHER_WEIGHTS`` (an ``.npz`` of a torch ``state_dict``,
    its ``rope_embed.periods`` taken as the model's), else from a generator
    seeded with ``seed``."""
    path = weights_path or os.environ.get("SPECTRE_TEACHER_WEIGHTS")
    sd = None
    rope_periods = None
    if path and os.path.exists(path):
        with np.load(path) as z:
            sd = {k: z[k] for k in z.files}
        if "rope_embed.periods" in sd:
            rope_periods = tuple(np.asarray(sd["rope_embed.periods"], np.float32)
                                 .reshape(-1).tolist())
    bb = DinoVisionTransformer(img_size=img_size, variant=variant, rope_periods=rope_periods,
                               dtype=dtype, device=device, **backbone)
    model = DinoClassifier(bb, num_classes)
    init_teacher(model, torch.Generator().manual_seed(int(seed)))
    if sd is not None:
        unused = import_torch_state_dict(bb, sd)
        if unused:
            print(f"teacher import: {len(unused)} unused torch keys (e.g. {unused[:3]})",
                  flush=True)
    return freeze(model)


def freeze(model: nn.Module) -> nn.Module:
    """Eval mode and no gradients: the teacher only ever runs inference."""
    return model.eval().requires_grad_(False)
