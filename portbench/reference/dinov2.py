"""Plain float32 reference of the DINOv2 ViT teacher family with registers
(Oquab et al., arXiv:2304.07193; Darcet et al., arXiv:2309.16588;
github.com/facebookresearch/dinov2, ``dinov2_vits14_reg``), frozen, with a
linear decoder on its CLS token. What it shares with DINOv3
(``reference/dinov3.py``: the view, the patch projection, the pre-norm
blocks with LayerScale and exact GELU, the head) is imported from there.

    embed : the patch tokens; CLS first; a learned position embedding
            [1, 1 + Np, E] added to CLS and the patches; then the R register
            tokens after CLS, without position: [CLS, registers, patches]
    block : as DINOv3's, with no rotation of q and k and a key bias

LayerNorm has eps ``layer_norm_eps`` (DINOv2's: 1e-6). Faults that can be
planted: ``"no_pos_embed"`` leaves the position embedding out,
``"no_registers"`` drops the register tokens.
"""

from __future__ import annotations

import torch

from portbench.reference.dinov3 import blocks, embed, forward_flops_per_image, head, view
from portbench.reference.dinov3 import spec as _dinov3_spec

FAULTS = ("no_pos_embed", "no_registers")
__all__ = ["FAULTS", "forward", "forward_flops_per_image", "spec", "view"]


def spec(t: dict) -> list[tuple]:
    """DINOv3's leaves with a key bias drawn like the others and the
    position embedding, normal(0, 0.02) as DINOv2 initialises it."""
    n = (t["img_size"] // t["patch_size"]) ** 2 + 1
    out = [(name, shape, "uniform", t["embed_dim"] ** -0.5)
           if name.endswith("attn.key.bias") else (name, shape, kind, arg)
           for name, shape, kind, arg in _dinov3_spec(t)]
    return out + [("backbone.pos_embed", (1, n, t["embed_dim"]), "normal", 0.02)]


def forward(mm, p: dict, x: torch.Tensor, t: dict, fault: str | None = None) -> torch.Tensor:
    """Logits [B, classes] of the teacher's view x [B, C, img, img]."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown teacher fault {fault!r}")
    tokens = embed(mm, p, x, t)
    b, e = x.shape[0], t["embed_dim"]
    x = torch.cat([p["backbone.cls_token"].expand(b, 1, e), tokens], dim=1)
    if fault != "no_pos_embed":
        x = x + p["backbone.pos_embed"]
    if fault != "no_registers":
        x = torch.cat([x[:, :1], p["backbone.register_tokens"].expand(b, -1, e), x[:, 1:]],
                      dim=1)
    return head(mm, p, blocks(mm, p, x, t, lambda v: v), t)
