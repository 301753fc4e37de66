"""Plain float32 reference of the DINOv3 ViT teacher family (Simeoni et al.,
arXiv:2508.10104; github.com/facebookresearch/dinov3, ``dinov3_vits16``),
frozen, with a linear decoder on its CLS token, as the distiller uses it.

    view   : bilinear resize of [0, 1] pixels to ``img_size`` (half-pixel
             centres, the edge pixel repeated), then ImageNet's statistics
    embed  : P x P patches flattened (c, i, j), projected to E (the patch
             convolution); [CLS, R storage tokens, patches]; no absolute
             position embedding
    rope   : axial 2D RoPE on q and k of the patch tokens only. Patch centres
             (i + 0.5) / side * 2 - 1 in [-1, 1], rows (h) then columns (w);
             periods base ** (2 k / (D / 2)) for k < D / 4; angles
             2 pi coord / period, [h: D/4 | w: D/4] tiled twice over the head
             dim; x cos + rotate_half(x) sin, rotate_half(x1 | x2) = (-x2 | x1)
    block  : pre-norm; x += ls1 * out(softmax(rope(q) rope(k)^T / sqrt(D)) v);
             x += ls2 * fc2(gelu(fc1(LayerNorm(x)))), exact GELU; the key
             projection has no bias (DINOv3's ``mask_k_bias``)
    head   : the final LayerNorm, then Dense(E -> classes) of the CLS token

LayerNorm has eps ``layer_norm_eps`` (DINOv3's ``layernormbf16``: 1e-5).
Two faults can be planted, each a departure from the family that the
correctness check has to catch: ``"no_rope"`` leaves q and k unrotated,
``"no_registers"`` drops the storage tokens.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
FAULTS = ("no_rope", "no_registers")


def _block(i: int) -> str:
    return f"backbone.block_{i}."


def spec(t: dict) -> list[tuple]:
    """(name, shape, kind, arg) of every leaf under the names and layouts the
    port's teacher gives them: Dense kernels [in, out]; query, key, value
    [E, H, D]; out [H, D, E]."""
    e, heads, c, p = t["embed_dim"], t["num_heads"], t["in_channels"], t["patch_size"]
    hd, ff, r = e // heads, t["mlp_hidden_dim"], t["num_registers"]
    patch = c * p * p
    out = [("backbone.cls_token", (1, 1, e), "normal", 0.02),
           ("backbone.register_tokens", (1, r, e), "normal", 0.02),
           ("backbone.patch_embed.kernel", (patch, e), "uniform", patch ** -0.5),
           ("backbone.patch_embed.bias", (e,), "uniform", patch ** -0.5)]
    for i in range(t["depth"]):
        b = _block(i)
        out += [(b + "ls1_gamma", (e,), t["layerscale"], None),
                (b + "ls2_gamma", (e,), t["layerscale"], None)]
        for norm in ("norm1", "norm2"):
            out += [(b + norm + ".weight", (e,), "ones", None),
                    (b + norm + ".bias", (e,), "zeros", None)]
        for proj in ("query", "key", "value"):
            out += [(b + f"attn.{proj}.kernel", (e, heads, hd), "normal", e ** -0.5),
                    (b + f"attn.{proj}.bias", (heads, hd),
                     "zeros" if proj == "key" else "uniform", e ** -0.5)]
        out += [(b + "attn.out.kernel", (heads, hd, e), "normal", e ** -0.5),
                (b + "attn.out.bias", (e,), "uniform", e ** -0.5),
                (b + "mlp.fc1.kernel", (e, ff), "normal", e ** -0.5),
                (b + "mlp.fc1.bias", (ff,), "uniform", e ** -0.5),
                (b + "mlp.fc2.kernel", (ff, e), "normal", ff ** -0.5),
                (b + "mlp.fc2.bias", (e,), "uniform", ff ** -0.5)]
    return out + [("backbone.norm.weight", (e,), "ones", None),
                  ("backbone.norm.bias", (e,), "zeros", None),
                  ("decoder.kernel", (e, t["num_classes"]), "uniform", e ** -0.5),
                  ("decoder.bias", (t["num_classes"],), "uniform", e ** -0.5)]


def view(raw: torch.Tensor, t: dict) -> torch.Tensor:
    """The teacher's ``imagenet`` view of raw [B, C, H, W] pixels in [0, 1]."""
    x = F.interpolate(raw, size=(t["img_size"], t["img_size"]), mode="bilinear",
                      align_corners=False, antialias=False)
    mean = torch.tensor(IMAGENET_MEAN, device=x.device).view(1, -1, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=x.device).view(1, -1, 1, 1)
    return (x - mean) / std


def rope_tables(side: int, head_dim: int, base: float, device=None) -> tuple:
    """(cos, sin), each [side * side, head_dim] float32, of the patch grid."""
    coords = (torch.arange(side, dtype=torch.float64, device=device) + 0.5) / side * 2.0 - 1.0
    hh, ww = torch.meshgrid(coords, coords, indexing="ij")
    pos = torch.stack([hh.reshape(-1), ww.reshape(-1)], dim=-1)  # [N, 2]: h, w
    periods = base ** (2.0 * torch.arange(head_dim // 4, dtype=torch.float64, device=device)
                       / (head_dim // 2))
    angles = 2.0 * math.pi * pos[:, :, None] / periods[None, None, :]  # [N, 2, D/4]
    angles = angles.reshape(pos.shape[0], head_dim // 2).tile(1, 2)
    return torch.cos(angles).float(), torch.sin(angles).float()


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, prefix: int) -> torch.Tensor:
    """x [B, H, N, D] with its tokens after the first ``prefix`` rotated."""
    patches = x[:, :, prefix:]
    return torch.cat([x[:, :, :prefix], patches * cos + rotate_half(patches) * sin], dim=2)


def forward(mm, p: dict, x: torch.Tensor, t: dict, fault: str | None = None) -> torch.Tensor:
    """Logits [B, classes] of the teacher's view x [B, C, img, img]."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown teacher fault {fault!r}")
    tokens = embed(mm, p, x, t)
    b, e = x.shape[0], t["embed_dim"]
    prefix = [p["backbone.cls_token"].expand(b, 1, e)]
    if fault != "no_registers":
        prefix.append(p["backbone.register_tokens"].expand(b, -1, e))
    x = torch.cat(prefix + [tokens], dim=1)
    n_prefix, side = x.shape[1] - tokens.shape[1], t["img_size"] // t["patch_size"]
    cos, sin = rope_tables(side, e // t["num_heads"], t["rope_base"], x.device)

    def rotate(v):
        return v if fault == "no_rope" else rope(v, cos, sin, n_prefix)

    return head(mm, p, blocks(mm, p, x, t, rotate), t)


def embed(mm, p: dict, x: torch.Tensor, t: dict) -> torch.Tensor:
    """The patch tokens [B, Np, E] of x [B, C, img, img]."""
    b, c = x.shape[:2]
    ps, side = t["patch_size"], t["img_size"] // t["patch_size"]
    patches = x.reshape(b, c, side, ps, side, ps).permute(0, 2, 4, 1, 3, 5)
    return mm(patches.reshape(b, side * side, c * ps * ps), p["backbone.patch_embed.kernel"]) \
        + p["backbone.patch_embed.bias"]


def _norm(p: dict, v: torch.Tensor, name: str, t: dict) -> torch.Tensor:
    return F.layer_norm(v, v.shape[-1:], p[name + ".weight"], p[name + ".bias"],
                        t["layer_norm_eps"])


def blocks(mm, p: dict, x: torch.Tensor, t: dict, rotate) -> torch.Tensor:
    """The pre-norm blocks over the tokens x [B, N, E]; ``rotate`` takes q
    and k [B, H, N, D] to what the scores see."""
    b, n, e = x.shape
    heads = t["num_heads"]
    hd = e // heads
    for i in range(t["depth"]):
        blk = _block(i)
        h = _norm(p, x, blk + "norm1", t)

        def heads_of(proj):
            w = p[blk + f"attn.{proj}.kernel"].reshape(e, e)
            y = mm(h, w) + p[blk + f"attn.{proj}.bias"].reshape(e)
            return y.reshape(b, n, heads, hd).transpose(1, 2)  # [B, H, N, D]

        q, k, v = rotate(heads_of("query")), rotate(heads_of("key")), heads_of("value")
        attn = torch.softmax(mm(q, k.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
        o = mm(attn, v).transpose(1, 2).reshape(b, n, e)
        o = mm(o, p[blk + "attn.out.kernel"].reshape(e, e)) + p[blk + "attn.out.bias"]
        x = x + p[blk + "ls1_gamma"] * o
        hidden = F.gelu(mm(_norm(p, x, blk + "norm2", t), p[blk + "mlp.fc1.kernel"])
                        + p[blk + "mlp.fc1.bias"])
        y = mm(hidden, p[blk + "mlp.fc2.kernel"]) + p[blk + "mlp.fc2.bias"]
        x = x + p[blk + "ls2_gamma"] * y
    return x


def head(mm, p: dict, x: torch.Tensor, t: dict) -> torch.Tensor:
    """The final LayerNorm and the decoder of the CLS token."""
    cls = _norm(p, x, "backbone.norm", t)[:, 0]
    return mm(cls, p["decoder.kernel"]) + p["decoder.bias"]


def forward_flops_per_image(t: dict) -> int:
    """Model FLOPs of one image's forward, 2*M*N*K over its products: the
    patch projection (Np x C*P*P x E), per block the q, k, v and out
    projections (N x E x E each), the scores and their sum over v (2*N*N*E
    each) and the MLP (N x E x F twice), and the decoder; N = Np + 1 + R.
    The view, LayerNorm, RoPE, softmax and GELU are not counted."""
    e, ps, c = t["embed_dim"], t["patch_size"], t["in_channels"]
    n_patches = (t["img_size"] // ps) ** 2
    n = n_patches + 1 + t["num_registers"]
    block = 4 * 2 * n * e * e + 2 * 2 * n * n * e + 2 * 2 * n * e * t["mlp_hidden_dim"]
    return 2 * n_patches * c * ps * ps * e + t["depth"] * block + 2 * e * t["num_classes"]
