"""Model FLOPs of a step, counted from the configuration: a frozen copy of
the program's count (``spectre_tpu_torch/repl/bench.py``,
``forward_flops_per_image`` and ``train_flops_per_step``, for the models the
benchmark runs), kept here so that a change to the program cannot move the
yardstick. A test holds the copy to the original.

Per image the forward is the sum of 2*M*N*K over its products: the patch
embedding (Np x C*P*P x E), and per layer for ``spectre_vit`` with
``permut_mix`` the mix projection (N x E*H x E) with its grouped-mean pool
(N*E*H additions), ``linear1`` (N x E x hidden) and ``linear3`` (N x hidden x
E), each with its pool-residual product when the widths neither match nor
divide; the head likewise. For ``vit`` a layer is the four attention
projections (N x E x E each), the attention (4*N*N*E) and the two Dense
layers; the head a plain product. N = Np + 1 tokens. A train step is three
forwards (the backward counts twice). Elementwise work, LayerNorm and the
optimizer are not counted.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12  # one H100 SXM, dense bf16 tensor cores (data sheet)


def _linear_flops(rows: int, k: int, n: int) -> int:
    pool = 0 if k == n else (rows * k if k % n == 0 else 2 * rows * k * n)
    return 2 * rows * k * n + pool


def forward_flops_per_image(m: dict) -> int:
    """FLOPs of one image's forward; ``m`` the configuration's model group."""
    e, hd, heads = int(m["embed_dim"]), int(m["hidden_dim"]), int(m["num_heads"])
    p, c = int(m["patch_size"]), int(m["in_channels"])
    n_patches = (int(m["img_size"]) // p) ** 2
    n = n_patches + 1
    embed = 2 * n_patches * (c * p * p) * e
    if m["model"] == "vit":
        layer = 4 * (2 * n * e * e) + 4 * n * n * e + 2 * n * e * hd + 2 * n * hd * e
        head = 2 * e * int(m["num_classes"])
    elif m["model"] == "spectre_vit" and m["method"] == "permut_mix":
        layer = _linear_flops(n, e * heads, e) + _linear_flops(n, e, hd) \
            + _linear_flops(n, hd, e)
        head = _linear_flops(1, e, int(m["num_classes"]))
    else:
        raise NotImplementedError(f"no FLOP count for model={m['model']!r} "
                                  f"method={m.get('method')!r}")
    return embed + int(m["num_encoders"]) * layer + head


def train_flops_per_step(m: dict, batch: int) -> int:
    return 3 * forward_flops_per_image(m) * batch
