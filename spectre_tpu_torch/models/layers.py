"""Layers of the serving path (port of spectre_tpu/models/layers.py).

- ``SpectreLinear``: GELU(LN(x @ W + b)) + pool residual
  (``ops/linear.py::spectre_linear_apply``). W keeps the JAX [in, out]
  layout (not ``nn.Linear``'s [out, in]); on CUDA tensors the product, LN
  and GELU run in the hand-written kernel.
- ``MHPermutMix`` (``impl="folded"``) with ``FoldedMixLinear``: the multi-head
  sign + permutation mix, run as a block-row permutation kernel on the
  token-major [d, B] stream followed by a per-token product whose weights
  carry the signs.

Parameters are held in ``param_dtype`` and cast to the compute ``dtype`` in
the forward, as the flax modules do.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from spectre_tpu_torch.models.init import uniform_fan_in_
from spectre_tpu_torch.ops import (
    adaptive_pool_matrix,
    detect_block_size,
    fold_weights,
    folded_proj,
    gelu_exact,
    layer_norm,
    make_block_mix_tables,
    make_mix_tables,
    spectre_linear_apply,
)
from spectre_tpu_torch.ops.kernels import block_scatter_rows


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` (eps 1e-5) whose f32 weight and bias follow the
    input's compute dtype; flax's ``LayerNorm(scale, bias)`` maps onto
    ``weight``/``bias``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight.to(x.dtype), self.bias.to(x.dtype), self.eps)


class _ProjectionLN(nn.Module):
    """The parameters shared by SpectreLinear and FoldedMixLinear, with the
    flax names: kernel [in, out], bias [out], ln_scale, ln_bias."""

    def __init__(self, in_features: int, features: int, *, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.in_features, self.features, self.dtype = in_features, features, dtype
        kw = dict(dtype=param_dtype, device=device)
        self.kernel = nn.Parameter(torch.empty(in_features, features, **kw))
        self.bias = nn.Parameter(torch.empty(features, **kw))
        self.ln_scale = nn.Parameter(torch.ones(features, **kw))
        self.ln_bias = nn.Parameter(torch.zeros(features, **kw))

    def init_parameters(self, gen: torch.Generator) -> None:
        uniform_fan_in_(self.kernel, self.in_features, gen)
        uniform_fan_in_(self.bias, self.in_features, gen)
        with torch.no_grad():
            self.ln_scale.fill_(1.0)
            self.ln_bias.zero_()


class SpectreLinear(_ProjectionLN):
    """out = GELU(LayerNorm(x @ kernel + bias)) + pool_residual(x)
    (identity residual when in == out)."""

    def __init__(self, in_features: int, features: int, *, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__(in_features, features, dtype=dtype, param_dtype=param_dtype,
                         device=device)
        # the pool residual's averaging matrix when in does not divide into
        # out (adaptive_avg_pool1d's matrix path), built once: made per call,
        # its host-to-device copy would stall the stream
        self.register_buffer("pool_matrix", adaptive_pool_matrix(
            in_features, features, dtype, device) if in_features % features else None,
            persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return spectre_linear_apply(x.to(dt).contiguous(), self.kernel.to(dt),
                                    self.bias.to(dt), self.ln_scale.to(dt),
                                    self.ln_bias.to(dt), pool_matrix=self.pool_matrix)


class FoldedMix(NamedTuple):
    """Everything a folded mix forward derives from its buffers and kernel."""
    key: tuple
    blk: int
    bsrc: torch.Tensor   # int32 [H, d/blk]: source block of each output block
    wp: torch.Tensor     # [N, in, O] sign-folded projection weights
    pool_w: torch.Tensor  # [N, O, grp] grouped sign-mean weights, or [N, in, O]
    grp: int             # in // O when it divides, else 0 (pool-matrix path)


class FoldedMixLinear(_ProjectionLN):
    """The mix projection with the signs and pool residual folded into
    per-token weights (JAX ``FoldedMixLinear``): given the permuted stream
    g4 [N, in, B],

        y    = folded_proj(g4, diag(s_n) W) + b
        pool = grouped sign-mean of g4 (or sign-folded pool matrix)
        out  = GELU(LN(y)) + pool                  -> [B, N, O]
    """

    @torch.no_grad()
    def fold(self, s4: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, int]:
        """Sign-folded weights for signs s4 [N, in] (compute dtype)."""
        dt, o = self.dtype, self.features
        n, e = s4.shape
        wp = fold_weights(self.kernel.to(dt), s4)
        if e % o == 0:
            grp = e // o
            return wp, (s4.reshape(n, o, grp) / grp).contiguous(), grp
        pm = adaptive_pool_matrix(e, o, dt, s4.device)
        return wp, fold_weights(pm, s4), 0

    def forward(self, g4: torch.Tensor, mix: FoldedMix) -> torch.Tensor:
        dt = self.dtype
        n, _, b = g4.shape
        y = folded_proj(g4, mix.wp) + self.bias.to(dt)  # [N, B, O]
        if mix.grp:
            pool = torch.einsum("nuvb,nuv->nbu",
                                g4.reshape(n, self.features, mix.grp, b), mix.pool_w)
        else:
            pool = folded_proj(g4, mix.pool_w)
        h = gelu_exact(layer_norm(y, self.ln_scale.to(dt), self.ln_bias.to(dt))) + pool
        return h.transpose(0, 1)  # [B, N, O]


class MHPermutMix(nn.Module):
    """Multi-head sign-flip + permutation mixing (JAX ``MHPermutMix``,
    ``impl="folded"``): flatten [B, N, E] to d = N*E, apply H fixed
    permutations and sign patterns, read the H copies as [B, N, E*H] and
    project back to ``out_channels``.

    Buffers ``perms`` (int32 [H, d]) and ``signs`` (f32 [1, H, d]) are the
    flax ``mix_tables``. The block table ``bsrc = perms[:, ::blk] // blk``
    and the folded weights are derived from the live buffers and kernel:
    init and the weight bridge derive them, and whenever a buffer or the
    kernel changes later (``load_state_dict``, ``.to()``, an in-place edit)
    the next forward derives them again, so a stale table cannot be used.
    Any permutation is block-structured with blk >= 1, so every table goes
    through the block-row kernel."""

    def __init__(self, embed_dim: int, token_dim: int, num_heads: int,
                 out_channels: int, *, impl: str = "folded", mix_block: int = 0,
                 dtype=torch.float32, param_dtype=torch.float32, device=None):
        super().__init__()
        if impl != "folded":
            raise NotImplementedError(
                f"mix_impl={impl!r} is not ported yet; the port runs 'folded' "
                "only (ROADMAP.md, queue A9)")
        self.embed_dim, self.token_dim, self.num_heads = embed_dim, token_dim, num_heads
        self.mix_block, self.dtype = mix_block, dtype
        d = embed_dim * token_dim
        self.register_buffer("perms", torch.zeros(num_heads, d, dtype=torch.int32,
                                                  device=device))
        self.register_buffer("signs", torch.ones(1, num_heads, d, dtype=torch.float32,
                                                 device=device))
        self.linear = FoldedMixLinear(embed_dim * num_heads, out_channels, dtype=dtype,
                                      param_dtype=param_dtype, device=device)
        self._mix: FoldedMix | None = None

    def init_parameters(self, gen: torch.Generator) -> None:
        d, blk = self.perms.shape[1], self.mix_block
        if blk and d % blk == 0 and blk & (blk - 1) == 0:
            perms, signs = make_block_mix_tables(gen, self.num_heads, d, blk)
        else:
            if blk:
                warnings.warn(
                    f"mix_block={blk} does not divide d={d} (or is not a power of "
                    "two); sampling uniform permutation tables instead", stacklevel=2)
            perms, signs = make_mix_tables(gen, self.num_heads, d)
        with torch.no_grad():
            self.perms.copy_(perms)
            self.signs.copy_(signs)

    def _key(self) -> tuple:
        # a tensor made under torch.inference_mode() has no version counter,
        # so its in-place edits are not seen here: whoever edits one calls
        # refresh(force=True), as build_model and the weight bridge do
        return tuple((t.device, t.data_ptr(), None if t.is_inference() else t._version)
                     for t in (self.perms, self.signs, self.linear.kernel))

    @torch.no_grad()
    def refresh(self, force: bool = False) -> FoldedMix:
        """Derive the block table and folded weights from the live buffers
        and kernel (validating the tables), unless they are current."""
        key = self._key()
        if not force and self._mix is not None and self._mix.key == key:
            return self._mix
        d = self.perms.shape[1]
        p = self.perms.cpu().numpy()
        if not (np.sort(p, axis=1) == np.arange(d)).all():
            raise ValueError("mix perms must hold one permutation of range(d) per head")
        blk = detect_block_size(p, min_blk=1)
        bsrc = torch.from_numpy(np.ascontiguousarray(p[:, ::blk] // blk, dtype=np.int32))
        s4 = self.signs.to(self.dtype).reshape(self.token_dim, -1)
        wp, pool_w, grp = self.linear.fold(s4)
        self._mix = FoldedMix(key, blk, bsrc.to(self.perms.device), wp, pool_w, grp)
        return self._mix

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mix = self.refresh()
        b = x.shape[0]
        xt = x.to(self.dtype).reshape(b, -1).t().contiguous()  # token-major [d, B]
        g = block_scatter_rows(xt, mix.bsrc, mix.blk)  # [H*d, B] == [N*in, B]
        return self.linear(g.view(self.token_dim, -1, b), mix)
