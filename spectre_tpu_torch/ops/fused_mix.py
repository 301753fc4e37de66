"""The folded permutation mix (forward of spectre_tpu/ops/fused_mix.py).

The reference mix ``(x.flat[perms] * signs).view(B, N, E*H) @ W`` splits into
a sign-free row permutation of the token-major [d, B] stream and a per-token
product whose weights carry the +-1 signs: ``Wp[n] = diag(s4[n]) @ W``.
Multiplying by +-1 is exact in any float format, so folding once when the
weights are set gives the same values as folding inside every call.

The JAX route registry and its stale-route guards do not come over: the
model derives its block table from its own buffers (models/layers.py).
"""

from __future__ import annotations

import torch


def perm_rows_t(xt: torch.Tensor, perms: torch.Tensor) -> torch.Tensor:
    """Sign-free multi-head row permutation, token-major: [d, B] -> [H*d, B];
    row ``h*d + i`` is ``xt[perms[h, i]]``. Plain gather for any table; the
    model runs the block form (ops/kernels/block_scatter.py)."""
    return xt.index_select(0, perms.reshape(-1))


def fold_weights(w: torch.Tensor, s4: torch.Tensor) -> torch.Tensor:
    """Per-token folded weights [N, in, O] = s4[n, e] * w[e, o]."""
    return s4[:, :, None] * w[None]


def folded_proj(g4: torch.Tensor, wp: torch.Tensor) -> torch.Tensor:
    """y[n, b, o] = sum_e g4[n, e, b] * wp[n, e, o]: one batched product over
    tokens, g4 [N, in, B] -> [N, B, O]. With ``wp = fold_weights(w, s4)``
    this is JAX's ``folded_proj(g4, w, s4)``."""
    return torch.bmm(g4.transpose(1, 2), wp)
