"""Plain float32 reference of the baseline ViT (the research repo's ``vit``
config as the configuration states it: attention over the tokens of each
image, post-norm layers with torch's default topology).

    embed : 4x4 patches flattened (c, j, k), projected to E; CLS token
            first; position embeddings; dropout
    layer : a = softmax(q k^T / sqrt(D)) * pm, then a v, projected back to E
            (q, k, v from [E, H, D] kernels; pm the attention dropout's keep
            mask [N, N], one for every image and head);
            x = norm1(x + dropout(attention(x)));
            x = norm2(x + dropout(linear2(dropout(gelu(linear1(x))))))
    head  : Dense(E -> classes) of the CLS token

Dropout sites in forward order: the embedding; per layer the attention
mask, after the attention, after the GELU and after ``linear2``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.common import layer_norm


def spec(m: dict) -> list[tuple]:
    e, heads, ff, c, p = m["embed_dim"], m["num_heads"], m["hidden_dim"], m["in_channels"], \
        m["patch_size"]
    hd = e // heads
    n = (m["img_size"] // p) ** 2 + 1
    out = [("embeddings_block.cls_token", (1, 1, e), "normal", 1.0),
           ("embeddings_block.position_embeddings", (1, n, e), "normal", 1.0),
           ("embeddings_block.patcher.kernel", (c * p * p, e), "uniform", (c * p * p) ** -0.5),
           ("embeddings_block.patcher.bias", (e,), "uniform", (c * p * p) ** -0.5)]
    for i in range(m["num_encoders"]):
        lp = f"encoder_{i}."
        att = lp + "self_attn.mhsa."
        for proj in ("query", "key", "value"):
            out += [(att + proj + ".kernel", (e, heads, hd), "uniform", (1.5 / e) ** 0.5),
                    (att + proj + ".bias", (heads, hd), "zeros", None)]
        out += [(att + "out.kernel", (heads, hd, e), "uniform", e ** -0.5),
                (att + "out.bias", (e,), "zeros", None)]
        for norm in ("norm1", "norm2"):
            out += [(lp + norm + ".weight", (e,), "ones", None),
                    (lp + norm + ".bias", (e,), "zeros", None)]
        out += [(lp + "linear1.kernel", (e, ff), "uniform", e ** -0.5),
                (lp + "linear1.bias", (ff,), "uniform", e ** -0.5),
                (lp + "linear2.kernel", (ff, e), "uniform", ff ** -0.5),
                (lp + "linear2.bias", (e,), "uniform", ff ** -0.5)]
    return out + [("mlp_head.kernel", (e, m["num_classes"]), "uniform", e ** -0.5),
                  ("mlp_head.bias", (m["num_classes"],), "uniform", e ** -0.5)]


def dropout_sites(m: dict, batch: int) -> list[tuple]:
    if m["dropout"] == 0.0:
        return []
    n = (m["img_size"] // m["patch_size"]) ** 2 + 1
    e, ff, dt = m["embed_dim"], m["hidden_dim"], m["compute_dtype"]
    sites = [((batch, n, e), dt, True)]
    for _ in range(m["num_encoders"]):
        sites += [((n, n), "float32", False), ((batch, n, e), dt, True),
                  ((batch, n, ff), dt, True), ((batch, n, e), dt, True)]
    return sites


def forward(mm, p: dict, x: torch.Tensor, m: dict, masks: list | None = None) -> torch.Tensor:
    masks = iter(masks or ())

    def drop(t):
        mask = next(masks, None)
        return t if mask is None else t * mask

    b, c, h, w = x.shape
    ps, e, heads = m["patch_size"], m["embed_dim"], m["num_heads"]
    hd = e // heads
    patches = x.reshape(b, c, h // ps, ps, w // ps, ps).permute(0, 2, 4, 1, 3, 5)
    patches = patches.reshape(b, -1, c * ps * ps)
    eb = "embeddings_block."
    tokens = mm(patches, p[eb + "patcher.kernel"]) + p[eb + "patcher.bias"]
    tokens = torch.cat([p[eb + "cls_token"].expand(b, 1, e), tokens], dim=1)
    x = drop(tokens + p[eb + "position_embeddings"])
    n = x.shape[1]
    for i in range(m["num_encoders"]):
        lp = f"encoder_{i}."
        att = lp + "self_attn.mhsa."

        def heads_of(name):
            y = mm(x, p[att + name + ".kernel"].reshape(e, e)) + p[att + name + ".bias"].reshape(e)
            return y.reshape(b, n, heads, hd).permute(0, 2, 1, 3)

        q, k, v = heads_of("query"), heads_of("key"), heads_of("value")
        probs = F.softmax(mm(q, k.transpose(-1, -2)) * hd ** -0.5, dim=-1)
        pm = next(masks, None)
        if pm is not None:
            probs = probs * pm
        o = mm(probs, v).permute(0, 2, 1, 3).reshape(b, n, e)
        a = mm(o, p[att + "out.kernel"].reshape(e, e)) + p[att + "out.bias"]
        x = layer_norm(x + drop(a), p[lp + "norm1.weight"], p[lp + "norm1.bias"])
        hidden = drop(F.gelu(mm(x, p[lp + "linear1.kernel"]) + p[lp + "linear1.bias"]))
        y = drop(mm(hidden, p[lp + "linear2.kernel"]) + p[lp + "linear2.bias"])
        x = layer_norm(x + y, p[lp + "norm2.weight"], p[lp + "norm2.bias"])
    return mm(x[:, 0, :], p["mlp_head.kernel"]) + p["mlp_head.bias"]
