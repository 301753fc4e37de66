"""Plain float32 reference of SpectreViT (the research repo's
``spectre_vit``: spectral patch embedding, encoder layers whose token mixer
is the multi-head sign-flip and permutation mix, a SpectreLinear head).

    embed  : per 4x4 patch Re(rfft2(patch, "ortho")) weighted by
             freq_weight_h[u] * freq_weight_w[v], flattened (c, u, v),
             projected to E; CLS token first; position embeddings; dropout
    mix    : flatten [B, N, E] to d = N*E values; head h takes
             x[perms[h, j]] * signs[h, j]; the H copies read as [B, N, E*H];
             SpectreLinear(E*H -> E), whose residual is the average pool
    layer  : x = norm1(mix(x)) + x;
             x = norm2(x + dropout(SL3(dropout(SL1(x)))))
    encoder: layers, then + its input
    head   : SpectreLinear(E -> classes) of the CLS token

The mix is the gather itself: nothing here folds the signs into weights or
derives block tables. Dropout sites in forward order: the embedding, then
per layer after ``linear1`` and after ``linear3``.
"""

from __future__ import annotations

import torch

from portbench.reference.common import layer_norm, spectre_linear


def spec(m: dict) -> list[tuple]:
    """(name, shape, kind, arg) of every leaf, under the names the research
    model's parameter tree gives them."""
    e, heads, ff, c, p = m["embed_dim"], m["num_heads"], m["hidden_dim"], m["in_channels"], \
        m["patch_size"]
    f = p // 2 + 1
    n = (m["img_size"] // p) ** 2 + 1
    d = n * e
    out = [("embeddings_block.freq_weight_h", (p,), "ones", None),
           ("embeddings_block.freq_weight_w", (f,), "ones", None),
           ("embeddings_block.proj_kernel", (c * p * f, e), "uniform", (c * p * f) ** -0.5),
           ("embeddings_block.proj_bias", (e,), "uniform", (c * p * f) ** -0.5),
           ("embeddings_block.cls_token", (1, 1, e), "normal", 1.0),
           ("embeddings_block.position_embeddings", (1, n, e), "normal", 1.0)]

    def sl(prefix, k, o):
        return [(prefix + ".kernel", (k, o), "uniform", k ** -0.5),
                (prefix + ".bias", (o,), "uniform", k ** -0.5),
                (prefix + ".ln_scale", (o,), "ones", None),
                (prefix + ".ln_bias", (o,), "zeros", None)]

    for i in range(m["num_encoders"]):
        lp = f"encoder_blocks.layer_{i}."
        out += [(lp + "mix_layer.perms", (heads, d), "block_perm", m["mix_block"]),
                (lp + "mix_layer.signs", (1, heads, d), "signs", None)]
        out += sl(lp + "mix_layer.linear", e * heads, e)
        for norm in ("norm1", "norm2"):
            out += [(lp + norm + ".weight", (e,), "ones", None),
                    (lp + norm + ".bias", (e,), "zeros", None)]
        out += sl(lp + "linear1", e, ff) + sl(lp + "linear3", ff, e)
    return out + sl("mlp_head", e, m["num_classes"])


def dropout_sites(m: dict, batch: int) -> list[tuple]:
    """(shape, draw dtype name, whether its first axis is the batch) of every
    dropout mask of a train forward, in the order the forward draws them."""
    if m["dropout"] == 0.0:
        return []
    n = (m["img_size"] // m["patch_size"]) ** 2 + 1
    e, ff, dt = m["embed_dim"], m["hidden_dim"], m["compute_dtype"]
    sites = [((batch, n, e), dt, True)]
    for _ in range(m["num_encoders"]):
        sites += [((batch, n, ff), dt, True), ((batch, n, e), dt, True)]
    return sites


def forward(mm, p: dict, x: torch.Tensor, m: dict, masks: list | None = None) -> torch.Tensor:
    """Logits [B, classes] of normalised images x [B, C, H, W]; ``masks``
    (those of ``dropout_sites``, each already scaled, rows matching x) in
    train mode, None in eval mode."""
    masks = iter(masks or ())

    def drop(t):
        mask = next(masks, None)
        return t if mask is None else t * mask

    b, c, h, w = x.shape
    ps = m["patch_size"]
    e, heads = m["embed_dim"], m["num_heads"]
    patches = x.reshape(b, c, h // ps, ps, w // ps, ps).permute(0, 2, 4, 1, 3, 5)
    patches = patches.reshape(b, -1, c, ps, ps)
    spec_ = torch.fft.rfft2(patches, norm="ortho").real  # [B, Np, C, P, F]
    eb = "embeddings_block."
    spec_ = spec_ * p[eb + "freq_weight_h"][:, None] * p[eb + "freq_weight_w"][None, :]
    tokens = mm(spec_.reshape(b, spec_.shape[1], -1), p[eb + "proj_kernel"]) + p[eb + "proj_bias"]
    tokens = torch.cat([p[eb + "cls_token"].expand(b, 1, e), tokens], dim=1)
    x = drop(tokens + p[eb + "position_embeddings"])
    n = x.shape[1]
    src = x
    for i in range(m["num_encoders"]):
        lp = f"encoder_blocks.layer_{i}."
        perms, signs = p[lp + "mix_layer.perms"], p[lp + "mix_layer.signs"]
        flat = x.reshape(b, -1)
        mixed = flat.index_select(1, perms.reshape(-1).long()).view(b, heads, -1) * signs
        mixed = spectre_linear(mm, mixed.reshape(b, n, -1), p, lp + "mix_layer.linear")
        x = layer_norm(mixed, p[lp + "norm1.weight"], p[lp + "norm1.bias"]) + x
        ff = drop(spectre_linear(mm, drop(spectre_linear(mm, x, p, lp + "linear1")), p,
                                 lp + "linear3"))
        x = layer_norm(x + ff, p[lp + "norm2.weight"], p[lp + "norm2.bias"])
    x = x + src
    return spectre_linear(mm, x[:, 0, :], p, "mlp_head")
