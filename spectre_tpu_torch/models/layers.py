"""Layers of SpectreViT (port of spectre_tpu/models/layers.py), for serving
and training.

- ``SpectreLinear``: GELU(LN(x @ W + b)) + pool residual
  (``ops/linear.py::spectre_linear_apply``). W keeps the JAX [in, out]
  layout (not ``nn.Linear``'s [out, in]); on CUDA tensors the product, LN
  and GELU run in the hand-written kernel.
- ``Dense``: x @ kernel + bias with the flax [in, out] kernel.
- ``MHPermutMix``: the multi-head sign + permutation mix. ``impl="folded"``
  (with ``FoldedMixLinear``) runs a block-row permutation kernel on the
  token-major [d, B] stream followed by a per-token product whose weights
  carry the signs, its backward optionally through the Clos route (kernel
  B9); ``"gather"`` and ``"gather_unfused"`` gather batch-major and project
  through ``SpectreLinear``; ``"gather_tm"`` gathers token-major into
  ``TokenMajorMixLinear``; ``"structured"`` runs the tile-structured mix
  kernel and ``SpectreLinear``.
- The experimental layers of the JAX package: ``SignPermuteMix``,
  ``BinaryLinear``, ``FFTApproximator``, ``LearnedSigmoid``, ``NormalMask``,
  ``FFTLayer``, ``LearnableHadamard``.

- ``Dropout``: inverted dropout whose masks come from an explicit
  ``torch.Generator`` (the train state's), the identity in eval mode.

Parameters are held in ``param_dtype`` and cast to the compute ``dtype`` in
the forward, as the flax modules do; autograd casts each gradient back.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import torch
from torch import nn

import numpy as np

from spectre_tpu_torch.models.init import normal_, uniform_fan_in_
from spectre_tpu_torch.ops import (
    ROUTE_IMPLS,
    MixRoute,
    MixTables,
    adaptive_pool_matrix,
    derive_mix_route,
    derive_mix_tables,
    fold_weights,
    folded_bmm,
    folded_proj,
    gelu_exact,
    layer_norm,
    learnable_hadamard,
    make_block_mix_tables,
    make_mix_tables,
    make_structured_tables,
    next_pow2,
    perm_rows_t,
    permut_mix,
    permut_mix_fused,
    permut_mix_fused_t,
    pick_tile,
    rfft_real,
    signed_stream_proj,
    spectre_linear_apply,
)
from spectre_tpu_torch.ops.kernels import invert_tile_perms, structured_mix_grad
from spectre_tpu_torch.ops.routing import pick_factor
from spectre_tpu_torch.profile.spans import span

MIX_IMPLS = ("folded", "gather", "gather_unfused", "gather_tm", "structured")


class Dropout(nn.Module):
    """Inverted dropout: in train mode each element is kept with probability
    1 - p and scaled by 1 / (1 - p); the identity in eval mode or at p = 0.
    The mask is drawn from ``generator`` (on the input's device; the train
    state sets one generator on every Dropout of its model), or from torch's
    default generator while it is None.

    ``split_by``: the layer that produced x. Where tensor parallelism keeps
    that layer's output split by columns (``parallel/tp.py``), x holds this
    rank's columns of it: the mask is drawn for the whole width and the
    rank's columns kept, so that the masks, and every later draw, are those
    of the unsplit model whatever the layout (as JAX's random bits do not
    depend on the sharding)."""

    def __init__(self, p: float):
        super().__init__()
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout p must be in [0, 1), got {p}")
        self.p = float(p)
        self.generator: torch.Generator | None = None

    def mask(self, x: torch.Tensor, split_by: nn.Module | None = None) -> torch.Tensor:
        """The keep mask for x (1.0 kept, 0.0 dropped) in x's dtype."""
        tp = getattr(split_by, "tp", None)
        window = tp.column_window(split_by.features) if tp is not None else None
        if window is None:
            return torch.empty_like(x).bernoulli_(1.0 - self.p, generator=self.generator)
        full, start = window
        keep = torch.empty((*x.shape[:-1], full), dtype=x.dtype, device=x.device)
        keep.bernoulli_(1.0 - self.p, generator=self.generator)
        return keep[..., start:start + x.shape[-1]]

    def forward(self, x: torch.Tensor, split_by: nn.Module | None = None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        return x * self.mask(x, split_by) * (1.0 / (1.0 - self.p))


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` (eps 1e-5) whose f32 weight and bias follow the
    input's compute dtype; flax's ``LayerNorm(scale, bias)`` maps onto
    ``weight``/``bias``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight.to(x.dtype), self.bias.to(x.dtype), self.eps)


class Dense(nn.Module):
    """x @ kernel + bias in the compute dtype; ``kernel`` [in, out] and
    ``bias`` [out] are flax ``nn.Dense``'s, not ``nn.Linear``'s [out, in].
    ``tp`` (set by ``parallel.apply_tp``) runs a tensor-parallel shard."""

    tp = None

    def __init__(self, in_features: int, features: int, *, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.in_features, self.features, self.dtype = in_features, features, dtype
        kw = dict(dtype=param_dtype, device=device)
        self.kernel = nn.Parameter(torch.empty(in_features, features, **kw))
        self.bias = nn.Parameter(torch.empty(features, **kw))

    def init_parameters(self, gen: torch.Generator) -> None:
        uniform_fan_in_(self.kernel, self.in_features, gen)
        uniform_fan_in_(self.bias, self.in_features, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            return self.tp.dense(self, x)
        dt = self.dtype
        return torch.matmul(x.to(dt), self.kernel.to(dt)) + self.bias.to(dt)


class _ProjectionLN(nn.Module):
    """The parameters shared by SpectreLinear and FoldedMixLinear, with the
    flax names: kernel [in, out], bias [out], ln_scale, ln_bias. ``tp`` (set
    by ``parallel.apply_tp``) runs a tensor-parallel shard."""

    tp = None

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
        if self.tp is not None:
            return self.tp.projection_ln(self, x)
        dt = self.dtype
        return spectre_linear_apply(x.to(dt).contiguous(), self.kernel.to(dt),
                                    self.bias.to(dt), self.ln_scale.to(dt),
                                    self.ln_bias.to(dt), pool_matrix=self.pool_matrix)


class FoldedMix(NamedTuple):
    """What a folded mix forward derives from its ``perms`` and ``signs``
    buffers; nothing here depends on a trained parameter."""
    key: tuple
    tables: MixTables    # blk, bsrc, binv of the permutation
    s4: torch.Tensor     # [N, in] signs in the compute dtype
    pool_w: torch.Tensor  # [N, O, grp] grouped sign-mean weights, or [N, in, O]
    grp: int             # in // O when it divides, else 0 (pool-matrix path)
    route: MixRoute | None  # the backward's Clos route, when one is set


class FoldedMixLinear(_ProjectionLN):
    """The mix projection with the signs and pool residual folded into
    per-token weights (JAX ``FoldedMixLinear``): given the permuted stream
    g4 [N, in, B],

        y    = g4^T (diag(s_n) W) + b
        pool = grouped sign-mean of g4 (or sign-folded pool matrix)
        out  = GELU(LN(y)) + pool                  -> [B, N, O]

    When a gradient is wanted, y goes through ``ops.folded_proj`` (its
    backward never builds the [N, in, O] cotangent). Otherwise the folded
    weights ``diag(s_n) W`` are built once per value of ``kernel`` and kept:
    serving must not fold 8,192 x 512 weights for 65 tokens on every call.
    While ``torch.export`` traces, y is ``ops.signed_stream_proj``: the
    program holds the shared [in, O] kernel and no folded copy (which would
    be 65 x 8,192 x 512 a layer at the flagship's widths), and folds nothing
    per call; only the product's summation order differs from eager."""

    # None: the cache keys on the kernel's storage and version. Under FSDP
    # the kernel a forward sees is gathered into a buffer that is refilled
    # every forward (its address and version say nothing of its values), so
    # parallel/fsdp.py sets a function of the stored shard's version instead
    fold_key = None

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        # (key of the kernel, folded weights [N, in, O]); MHPermutMix.refresh
        # drops it when the signs change
        self._wp: tuple | None = None

    def pool_weights(self, s4: torch.Tensor) -> tuple[torch.Tensor, int]:
        """The pool residual's sign-folded weights for signs s4 [N, in]."""
        o = self.features
        n, e = s4.shape
        if e % o == 0:
            grp = e // o
            return (s4.reshape(n, o, grp) / grp).contiguous(), grp
        return fold_weights(adaptive_pool_matrix(e, o, s4.dtype, s4.device), s4), 0

    @torch.no_grad()
    def folded_weights(self, mix: FoldedMix) -> torch.Tensor:
        # a tensor made under torch.inference_mode() has no version counter,
        # so its in-place edits are not seen here: whoever edits one calls
        # MHPermutMix.refresh(force=True), as build_model and the weight
        # bridge do
        k = self.kernel
        key = self.fold_key() if self.fold_key is not None else \
            (k.device, k.data_ptr(), None if k.is_inference() else k._version)
        if self._wp is None or self._wp[0] != key:
            self._wp = (key, fold_weights(k.to(self.dtype), mix.s4))
        return self._wp[1]

    def forward(self, g4: torch.Tensor, mix: FoldedMix) -> torch.Tensor:
        if self.tp is not None:
            return self.tp.folded_mix_linear(self, g4, mix)
        dt = self.dtype
        n, _, b = g4.shape
        if torch.compiler.is_exporting():
            y = signed_stream_proj(g4, self.kernel.to(dt), mix.s4)
        elif torch.is_grad_enabled() and (self.kernel.requires_grad or g4.requires_grad):
            self._wp = None  # training: do not hold a stale [N, in, O] copy
            y = folded_proj(g4, self.kernel.to(dt), mix.s4)
        else:
            y = folded_bmm(g4, self.folded_weights(mix))
        y = y + self.bias.to(dt)  # [N, B, O]
        if mix.grp:
            pool = torch.einsum("nuvb,nuv->nbu",
                                g4.reshape(n, self.features, mix.grp, b), mix.pool_w)
        else:
            pool = folded_bmm(g4, mix.pool_w)
        h = gelu_exact(layer_norm(y, self.ln_scale.to(dt), self.ln_bias.to(dt))) + pool
        return h.transpose(0, 1)  # [B, N, O]


class TokenMajorMixLinear(_ProjectionLN):
    """The mix and its projection in the token-major [.., B] layout (JAX
    ``TokenMajorMixLinear``, ``mix_impl="gather_tm"``): the gather
    ``ops.permut_mix_fused_t`` gives the [N, in, B] stream, which a product
    batched over tokens projects directly, then LN, GELU and the pool
    residual of the same stream. The same parameters as the other gather
    impls (kernel, bias, ln_scale, ln_bias), so checkpoints interchange."""

    def __init__(self, in_features: int, features: int, *, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__(in_features, features, dtype=dtype, param_dtype=param_dtype,
                         device=device)
        self.register_buffer("pool_matrix", adaptive_pool_matrix(
            in_features, features, dtype, device) if in_features % features else None,
            persistent=False)

    def forward(self, x: torch.Tensor, perms: torch.Tensor,
                signs2: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            return self.tp.token_major_mix_linear(self, x, perms, signs2)
        dt = self.dtype
        b, n, e = x.shape
        xt = x.to(dt).permute(1, 2, 0).reshape(n * e, b)  # [d, B]
        m3 = permut_mix_fused_t(xt, perms, signs2).view(n, self.in_features, b)
        rows = m3.transpose(1, 2)  # [N, B, in]
        y = torch.matmul(rows, self.kernel.to(dt))  # [N, B, O]
        o = self.features
        if self.in_features == o:
            pool = rows
        elif self.pool_matrix is None:
            pool = m3.reshape(n, o, self.in_features // o, b).mean(dim=2).transpose(1, 2)
        else:
            pool = torch.matmul(rows, self.pool_matrix)
        h = gelu_exact(layer_norm(y + self.bias.to(dt), self.ln_scale.to(dt),
                                  self.ln_bias.to(dt))) + pool
        return h.transpose(0, 1)  # [B, N, O]


class StructuredMix(NamedTuple):
    """What a structured mix forward derives from its ``tile_perms`` and
    ``signs`` buffers."""
    key: tuple
    inv: torch.Tensor    # int32 [H, T], inv[h, tile_perms[h, j]] = j
    signs: torch.Tensor  # [H, d] in the compute dtype


class MHPermutMix(nn.Module):
    """Multi-head sign-flip + permutation mixing (JAX ``MHPermutMix``):
    flatten [B, N, E] to d = N*E, apply H fixed permutations and sign
    patterns, read the H copies as [B, N, E*H] and project back to
    ``out_channels``.

    ``impl`` (the config's ``mix_impl``; the gather variants share one
    parameter and buffer tree and the same numerics, so checkpoints
    interchange):

    - ``"folded"``: the token-major block-row kernel and ``FoldedMixLinear``.
    - ``"gather"``: the batch-major gather with the inverse-gather backward
      (``ops.permut_mix_fused``), then ``SpectreLinear``.
    - ``"gather_unfused"``: the same gather left to autograd
      (``ops.permut_mix``).
    - ``"gather_tm"``: the token-major gather (``ops.permut_mix_fused_t``)
      and ``TokenMajorMixLinear``.
    - ``"structured"``: random tile permutation, intra-tile Hadamard and
      signs (ops/kernels/structured_mix.py: on a CUDA tensor the hand-written
      kernels, forward and backward), then ``SpectreLinear``. Its buffers are
      ``tile_perms`` (int32 [H, T]) and ``signs``.

    Buffers ``perms`` (int32 [H, d]) and ``signs`` (f32 [1, H, d]) are the
    flax ``mix_tables``. The block tables (``bsrc = perms[:, ::blk] // blk``
    and its inverse ``binv``) and the sign weights are derived from the live
    buffers: init and the weight bridge derive them, and whenever a buffer
    changes later (``load_state_dict``, ``.to()``, an in-place edit) the
    next forward derives them again, so a stale table cannot be used. The
    derivation validates the table on the host; a change to a trained
    parameter does not repeat it, so an optimizer step costs no host sync
    here (``table_derivations`` counts them). Any permutation is
    block-structured with blk >= 1, so every table goes through the
    block-row kernel forward; backward, a uniform table (blk = 1) takes the
    row kernel. The structured mix derives its inverse tile table and its
    signs in the compute dtype the same way; the gather impls derive
    nothing.
    While ``torch.export`` traces, the forward reads the derived tables as
    they are (``export/program.py::export_forward`` derives them first), so
    that their tensors become constants of the program and nothing reads
    the host or a data pointer.

    ``set_mix_route(impl)`` (``ops.register_mix_routes``, the config's
    ``mix_routed``) routes a folded mix's backward through its 3-stage Clos
    route: ``"pallas"`` (kernel B9), ``"mxu"`` or ``"takes"``
    (ops/fused_mix.py). The route is derived with the block tables, from the
    live ``perms``, and moved to the device once; a buffer change derives it
    again, an optimizer step does not. The forward stays the block-row
    kernel."""

    def __init__(self, embed_dim: int, token_dim: int, num_heads: int,
                 out_channels: int, *, impl: str = "folded", mix_block: int = 0,
                 dtype=torch.float32, param_dtype=torch.float32, device=None):
        super().__init__()
        if impl not in MIX_IMPLS:
            raise ValueError(f"unknown MHPermutMix impl {impl!r}; expected one of {MIX_IMPLS}")
        self.embed_dim, self.token_dim, self.num_heads = embed_dim, token_dim, num_heads
        self.impl, self.mix_block, self.dtype = impl, mix_block, dtype
        d = embed_dim * token_dim
        if impl == "structured":
            self.register_buffer("tile_perms", torch.zeros(
                num_heads, d // pick_tile(d), dtype=torch.int32, device=device))
        else:
            self.register_buffer("perms", torch.zeros(num_heads, d, dtype=torch.int32,
                                                      device=device))
        self.register_buffer("signs", torch.ones(1, num_heads, d, dtype=torch.float32,
                                                 device=device))
        linear = {"folded": FoldedMixLinear, "gather_tm": TokenMajorMixLinear}.get(
            impl, SpectreLinear)
        self.linear = linear(embed_dim * num_heads, out_channels, dtype=dtype,
                             param_dtype=param_dtype, device=device)
        self._mix: FoldedMix | StructuredMix | None = None
        self.route_impl: str | None = None
        self.table_derivations = 0

    def init_parameters(self, gen: torch.Generator) -> None:
        d, blk = self.signs.shape[2], self.mix_block
        if self.impl == "structured":
            perms, signs = make_structured_tables(gen, self.num_heads, d)
        elif blk and d % blk == 0 and blk & (blk - 1) == 0:
            perms, signs = make_block_mix_tables(gen, self.num_heads, d, blk)
        else:
            if blk:
                warnings.warn(
                    f"mix_block={blk} does not divide d={d} (or is not a power of "
                    "two); sampling uniform permutation tables instead", stacklevel=2)
            perms, signs = make_mix_tables(gen, self.num_heads, d)
        with torch.no_grad():
            self._table().copy_(perms)
            self.signs.copy_(signs)

    def _table(self) -> torch.Tensor:
        return self.tile_perms if self.impl == "structured" else self.perms

    def _key(self) -> tuple:
        # see FoldedMixLinear.folded_weights on inference-mode tensors
        return (self.route_impl,) + tuple(
            (t.device, t.data_ptr(), None if t.is_inference() else t._version)
            for t in (self._table(), self.signs))

    def set_mix_route(self, impl: str | None) -> bool:
        """Route the backward through the Clos route of ``impl`` (one of
        ``ops.ROUTE_IMPLS``), or not (None), and derive what the forward
        needs now. Only a folded mix whose width d has a power-of-two factor
        >= 8 takes a route (the tables JAX routes); returns whether this
        one does."""
        if impl is not None and impl not in ROUTE_IMPLS:
            raise ValueError(f"unknown mix route impl {impl!r}; expected one of {ROUTE_IMPLS}")
        take = impl is not None and self.impl == "folded" and pick_factor(self.signs.shape[2]) > 0
        self.route_impl = impl if take else None
        self.refresh()
        return take

    @torch.no_grad()
    def refresh(self, force: bool = False) -> FoldedMix | StructuredMix | None:
        """Derive what the forward needs from the live buffers (validating
        the table on the host), unless it is current: the block tables, sign
        weights and route (when set) of the folded mix, the inverse tile
        table and the signs in the compute dtype of the structured mix,
        nothing for the gather impls."""
        if self.impl not in ("folded", "structured"):
            return None
        key = self._key()
        if not force and self._mix is not None and self._mix.key == key:
            return self._mix
        if self.impl == "structured":
            p = self.tile_perms.cpu().numpy()
            if not (np.sort(p, axis=1) == np.arange(p.shape[1])).all():
                raise ValueError("tile_perms must hold one permutation of range(T) per head")
            self._mix = StructuredMix(
                key, invert_tile_perms(self.tile_perms),
                self.signs.to(self.dtype).reshape(self.num_heads, -1).contiguous())
        else:
            tables = derive_mix_tables(self.perms)
            s4 = self.signs.to(self.dtype).reshape(self.token_dim, -1)
            pool_w, grp = self.linear.pool_weights(s4)
            route = None if self.route_impl is None else derive_mix_route(
                self.perms, self.route_impl, self.dtype)
            self._mix = FoldedMix(key, tables, s4, pool_w, grp, route)
            self.linear._wp = None
        self.table_derivations += 1
        return self._mix

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("op/mix"):
            return self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        mix = self._mix if torch.compiler.is_exporting() else self.refresh()
        b = x.shape[0]
        x = x.to(self.dtype)
        if self.impl == "folded":
            xt = x.reshape(b, -1).t().contiguous()  # token-major [d, B]
            g = perm_rows_t(xt, mix.tables, mix.route)  # [H*d, B] == [N*in, B]
            return self.linear(g.view(self.token_dim, -1, b), mix)
        if self.impl == "gather_tm":
            return self.linear(x.reshape(b, self.token_dim, self.embed_dim), self.perms,
                               self.signs[0].to(self.dtype))
        if self.impl == "structured":
            mixed = structured_mix_grad(x.reshape(b, -1).contiguous(), self.tile_perms,
                                        mix.signs, self.token_dim, mix.inv)
        elif self.impl == "gather":
            mixed = permut_mix_fused(x.reshape(b, -1), self.perms,
                                     self.signs[0].to(self.dtype))
        else:
            mixed = permut_mix(x, self.perms, self.signs.to(self.dtype), self.token_dim)
        return self.linear(mixed.reshape(b, self.token_dim, -1))


class SignPermuteMix(nn.Module):
    """One fixed random permutation and sign pattern over the flattened
    sequence, no multi-head expansion, identity-shaped. Buffers ``perms``
    (int32 [1, d]) and ``signs`` ([1, 1, d]) are the flax ``mix_tables``."""

    def __init__(self, embed_dim: int, token_dim: int, *, dtype=torch.float32, device=None):
        super().__init__()
        d = embed_dim * token_dim
        self.dtype = dtype
        self.register_buffer("perms", torch.zeros(1, d, dtype=torch.int32, device=device))
        self.register_buffer("signs", torch.ones(1, 1, d, dtype=torch.float32, device=device))

    def init_parameters(self, gen: torch.Generator) -> None:
        perms, signs = make_mix_tables(gen, 1, self.perms.shape[1])
        with torch.no_grad():
            self.perms.copy_(perms)
            self.signs.copy_(signs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        flat = x.to(self.dtype).reshape(x.shape[0], -1)
        mixed = flat.index_select(1, self.perms[0].long()) * self.signs[0, 0].to(self.dtype)
        return mixed.reshape(x.shape)


class BinaryLinear(nn.Module):
    """Sign-binarised linear with a learnable scale: ``scale * (x @
    sign(weight).T)``, ``weight`` [out, in]; a buffer of ones when not
    trainable."""

    def __init__(self, in_features: int, features: int, *, trainable: bool = True,
                 dtype=torch.float32, param_dtype=torch.float32, device=None):
        super().__init__()
        self.dtype, self.trainable = dtype, trainable
        kw = dict(dtype=param_dtype, device=device)
        if trainable:
            self.weight = nn.Parameter(torch.empty(features, in_features, **kw))
        else:
            self.register_buffer("weight", torch.ones(features, in_features, **kw))
        self.scale = nn.Parameter(torch.ones(1, **kw))

    def init_parameters(self, gen: torch.Generator) -> None:
        if self.trainable:
            normal_(self.weight, gen)
        with torch.no_grad():
            self.scale.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        w_bin = torch.sign(self.weight.to(dt))
        return self.scale.to(dt) * torch.matmul(x.to(dt), w_bin.t())


class FFTApproximator(nn.Module):
    """Learned dense approximation of rfft: one unconstrained
    [dim // 2 + 1, dim] projection."""

    def __init__(self, dim: int, *, dtype=torch.float32, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(dim // 2 + 1, dim, dtype=param_dtype,
                                               device=device))

    def init_parameters(self, gen: torch.Generator) -> None:
        normal_(self.weight, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x.to(self.dtype), self.weight.to(self.dtype).t())


class LearnedSigmoid(nn.Module):
    """Sharp learned threshold gate: 1 / (1 + exp((x + t) / sqrt(t^2 /
    sharpness)))."""

    def __init__(self, threshold: float, sharpness: float = 5000.0, device=None):
        super().__init__()
        self.sharpness = sharpness
        self.threshold = nn.Parameter(torch.tensor(float(threshold), device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = self.threshold
        return 1.0 / (1.0 + torch.exp((x + t) / torch.sqrt(t ** 2 / self.sharpness)))


class NormalMask(nn.Module):
    """Learnable-Gaussian frequency mask over the last axis of ``n_bins``."""

    def __init__(self, n_bins: int, device=None):
        super().__init__()
        self.n_bins = n_bins
        self.mean = nn.Parameter(torch.tensor(n_bins / 2.0, device=device))
        self.std = nn.Parameter(torch.tensor(n_bins / 8.0, device=device))
        self.register_buffer("freqs", torch.linspace(0.0, n_bins - 1, n_bins, device=device),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gauss = torch.exp(-0.5 * ((self.freqs - self.mean) / (self.std + 1e-8)) ** 2)
        return x * gauss


class FFTLayer(nn.Module):
    """Re(rfft(x)) over the last axis; the output has n // 2 + 1 values."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rfft_real(x, axis=-1)


class LearnableHadamard(nn.Module):
    """Residual Hadamard block with one learnable per-lane scale per pass
    (``scale_<i>`` [next_pow2(dim)])."""

    def __init__(self, dim: int, num_blocks: int = 2, *, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.register_parameter(f"scale_{i}", nn.Parameter(
                torch.ones(next_pow2(dim), dtype=param_dtype, device=device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return learnable_hadamard(x, [getattr(self, f"scale_{i}")
                                      for i in range(self.num_blocks)])
