"""The permutation mix as autograd Functions (port of
spectre_tpu/ops/fused_mix.py): the folded route with its Clos-routed
backward, and the two gather mixes with an inverse-gather backward,
``permut_mix_fused`` (batch-major) and ``permut_mix_fused_t`` (token-major).

The mix is ``m[b, h, i] = x[b, perms[h, i]] * signs[h, i]`` followed by a
projection. In the folded form the gather runs sign-free on the token-major
[d, B] stream (``perm_rows_t``) and the signs ride in the projection:
``y[n] = g4[n]^T (diag(s4[n]) W)`` (``folded_proj``). Multiplying by +-1 is
exact in any float format.

All are ``torch.autograd.Function``s:

- ``perm_rows_t``: forward is the block-row copy (kernels.block_scatter_rows);
  backward is the head-summed inverse gather, kernels.block_gather_sum for a
  block table (blk >= 2) and kernels.inverse_gather_sum for a uniform one,
  or, when the mix's tables carry a route (``register_mix_routes``, the
  config's ``mix_routed``), the route's application: kernels.
  routed_gather_sum (impl ``"pallas"``), the one-hot products (``"mxu"``) or
  the three gathers (``"takes"``) of ops/routing.py. The route takes
  precedence over the block tables, as in JAX.
- ``folded_proj(g4, w, s4)``: the backward is reassociated so that the
  [N, in, O] cotangent of the folded weights never exists:
  ``dg4 = s4 * (w @ dy^T)`` with w shared over tokens, and
  ``dW = sum_{n,b} (s4 * g4)[n, :, b] dy[n, b, :]`` as one product with
  K = N*B. ``s4`` holds fixed signs and gets no gradient.
- ``folded_mix_pool(xt, w, s4, tables, grp)``: ``perm_rows_t``, then
  ``folded_proj`` and the grouped sign-mean pool residual (its weights
  s4 / grp made from s4), as one op (JAX's ``perm_rows_t`` followed by
  ``folded_proj_pool``). The forward runs the
  same kernels as the three ops apart and gives the same bits. The backward
  computes the input cotangent ``block_gather_sum(s4 * (w @ dy^T + P @
  dpool^T))`` in one launch of kernel B8 (kernels.fused_block_bwd with the
  pool term): no [N, in, B] cotangent is made and nothing g4-sized passes
  through autograd; dW as ``folded_proj``'s backward makes it. Where it
  applies (``fuses_mix_backward``) is the kernel's contract: bf16, a block
  table with blk % 64 == 0, grp a multiple of 16, no route.
- ``permut_mix_fused(x2d, perms, signs2)``: [B, d] -> [B, H, d], the exact
  gather mix. Nothing activation-sized is saved; the backward applies the
  signs first, then one flat gather by the inverse permutations and the sum
  over heads (a gather instead of autograd's scatter-add). Plain torch ops
  in both directions, as the JAX function is jnp.
- ``permut_mix_fused_t(xt, perms, signs2)``: the same mix token-major,
  [d, B] -> [H*d, B] (``mix_impl="gather_tm"``); plain torch ops, as the JAX
  function is jnp.

The JAX route registry, keyed by scope path, and its stale-route guards do
not come over: each mix derives its tables and its route from its own
buffers (models/layers.py), again whenever a buffer changes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from spectre_tpu_torch.ops.kernels import (
    block_bwd_kernel,
    block_gather_sum,
    block_scatter_rows,
    fused_block_bwd,
    inverse_gather_sum,
    library,
    routed_gather_sum,
)
from spectre_tpu_torch.ops.kernels.fused_block_bwd import MAX_HEADS
from spectre_tpu_torch.ops.permute import MixTables
from spectre_tpu_torch.ops.routing import (
    build_route_tables_cached,
    route_gather_sum,
    route_gather_sum_mxu,
    route_onehots,
)

# the route impls of the config's ``mix_routed_impl`` (default "mxu", as in
# JAX): "pallas" is kernel B9, the hand-written CUDA kernel on this card
ROUTE_IMPLS = ("pallas", "mxu", "takes")


class MixRoute(NamedTuple):
    """A mix table's 3-stage route on the table's device (ops/routing.py)."""
    impl: str
    a_idx: torch.Tensor  # int32 [H, r, c]
    b_idx: torch.Tensor
    c_idx: torch.Tensor
    onehots: tuple | None  # impl "mxu": the three one-hot operators


def derive_mix_route(perms: torch.Tensor, impl: str, dtype: torch.dtype) -> MixRoute:
    """Factor each head's inverse of ``perms`` (int32 [H, d], full
    permutations, d with a power-of-two factor >= 8) into its route, through
    the disk cache, and move the tables to ``perms``' device once; for impl
    "mxu" (one of ``ROUTE_IMPLS``) also build the one-hot operators there, in
    ``dtype``, the compute dtype of the cotangents they meet."""
    inv = np.argsort(perms.cpu().numpy(), axis=1).astype(np.int32)
    rt = build_route_tables_cached(inv)
    a, b, c = (torch.from_numpy(np.ascontiguousarray(t)).to(perms.device)
               for t in (rt.a_idx, rt.b_idx, rt.c_idx))
    return MixRoute(impl, a, b, c, route_onehots(a, b, c, dtype) if impl == "mxu" else None)


def apply_mix_route(route: MixRoute, g: torch.Tensor) -> torch.Tensor:
    """``dxt[j] = sum_h g[h*d + inv[h, j]]`` through the route: [H*d, B] ->
    [d, B]."""
    if route.impl == "pallas":
        return routed_gather_sum(g, route.a_idx, route.b_idx, route.c_idx)
    if route.impl == "mxu":
        return route_gather_sum_mxu(g, *route.onehots)
    return route_gather_sum(g, route.a_idx, route.b_idx, route.c_idx)


def register_mix_routes(model: torch.nn.Module, impl: str = "mxu") -> int:
    """Route the backward of every folded permutation mix of ``model`` whose
    table JAX would route, through ``impl``, and derive the routes now.
    Returns how many mixes were routed. The counterpart of JAX's
    ``register_mix_routes``: there the routes live in a registry keyed by
    scope path and must be registered again after every restore; here each
    mix holds its route impl and derives the route from its live buffers,
    again after any buffer change (``MHPermutMix.refresh``)."""
    if impl not in ROUTE_IMPLS:
        raise ValueError(f"unknown mix route impl {impl!r}; expected one of {ROUTE_IMPLS}")
    n = 0
    for m in model.modules():
        set_route = getattr(m, "set_mix_route", None)
        if set_route is not None and set_route(impl):
            n += 1
    return n


def clear_mix_routes(model: torch.nn.Module) -> None:
    """Back to the unrouted backward (kernel B2 or B7) in every mix."""
    for m in model.modules():
        set_route = getattr(m, "set_mix_route", None)
        if set_route is not None:
            set_route(None)


def perm_rows_t_plain(xt: torch.Tensor, perms: torch.Tensor) -> torch.Tensor:
    """Sign-free multi-head row permutation, token-major: [d, B] -> [H*d, B];
    row ``h*d + i`` is ``xt[perms[h, i]]``. The plain gather for any table,
    differentiable by autograd; tests hold ``perm_rows_t`` to it."""
    return xt.index_select(0, perms.reshape(-1))


class _PermRowsT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xt, blk, bsrc, binv, route):
        ctx.blk, ctx.route = blk, route
        ctx.save_for_backward(binv)
        return block_scatter_rows(xt, bsrc, blk)

    @staticmethod
    def backward(ctx, g):
        (binv,) = ctx.saved_tensors
        g = g.contiguous()
        if ctx.route is not None:
            return apply_mix_route(ctx.route, g), None, None, None, None
        if ctx.blk == 1:  # uniform table: binv is the row-level inverse
            return inverse_gather_sum(g, binv), None, None, None, None
        return block_gather_sum(g, binv, ctx.blk), None, None, None, None


def perm_rows_t(xt: torch.Tensor, tables: MixTables,
                route: MixRoute | None = None) -> torch.Tensor:
    """``perm_rows_t_plain`` for the permutation ``tables`` was derived from
    (``derive_mix_tables``), through the kernels in both directions; with
    ``route`` (``derive_mix_route`` of the same table) the backward goes
    through the route. xt must be contiguous [d, B]. While ``torch.export``
    traces, the forward is the custom op ``kernels.library.block_scatter_rows``
    (one node of the program; no backward is traced)."""
    if torch.compiler.is_exporting():
        return library.block_scatter_rows(xt, tables.bsrc, tables.blk)
    return _PermRowsT.apply(xt, tables.blk, tables.bsrc, tables.binv, route)


def fold_weights(w: torch.Tensor, s4: torch.Tensor) -> torch.Tensor:
    """Per-token folded weights [N, in, O] = s4[n, e] * w[e, o]."""
    return s4[:, :, None] * w[None]


def folded_bmm(g4: torch.Tensor, wp: torch.Tensor) -> torch.Tensor:
    """y[n, b, o] = sum_e g4[n, e, b] * wp[n, e, o]: one batched product over
    tokens, g4 [N, in, B] -> [N, B, O]."""
    return torch.bmm(g4.transpose(1, 2), wp)


def _folded_dw(g4: torch.Tensor, s4: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dW [in, O] of the folded projection from its saved g4 [N, in, B] and
    a contiguous dy [N, B, O]: s4 * g4 written straight into [in, N, B], so
    that {n, b} is one contiguous K axis and dW is a single product."""
    n, e, b = g4.shape
    sg = torch.empty((e, n, b), dtype=g4.dtype, device=g4.device)
    torch.mul(g4.transpose(0, 1), s4.t()[:, :, None], out=sg)
    return torch.matmul(sg.view(e, n * b), dy.view(n * b, -1))


class _FoldedProj(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g4, w, s4):
        ctx.save_for_backward(g4, w, s4)
        return folded_bmm(g4, fold_weights(w, s4))

    @staticmethod
    def backward(ctx, dy):
        g4, w, s4 = ctx.saved_tensors
        n = g4.shape[0]
        dy = dy.contiguous()
        dg4 = dw = None
        if ctx.needs_input_grad[0]:
            # [in, O] @ [N, O, B] -> contiguous [N, in, B], w shared over
            # tokens (a stride-0 batch, not a copy); the signs go on in place
            dg4 = torch.bmm(w.expand(n, -1, -1), dy.transpose(1, 2))
            dg4.mul_(s4[:, :, None])
        if ctx.needs_input_grad[1]:
            dw = _folded_dw(g4, s4, dy)
        return dg4, dw, None


def grouped_pool_weights(s4: torch.Tensor, grp: int) -> torch.Tensor:
    """The grouped sign-mean pool's weights for signs s4 [N, in] and grp =
    in // O: s4 / grp as [N, O, grp]."""
    return (s4.reshape(s4.shape[0], -1, grp) / grp).contiguous()


def grouped_pool(g4: torch.Tensor, pool_w: torch.Tensor, grp: int) -> torch.Tensor:
    """The folded mix's pool residual for grp = in // O: pool[n, b, u] =
    sum_v g4[n, u*grp + v, b] * pool_w[n, u, v], with pool_w [N, O, grp]
    (``grouped_pool_weights``). g4 [N, in, B] -> [N, B, O]."""
    n, _, b = g4.shape
    return torch.einsum("nuvb,nuv->nbu", g4.reshape(n, pool_w.shape[1], grp, b), pool_w)


def fuses_mix_backward(dtype: torch.dtype, blk: int, heads: int, grp: int, o: int,
                       routed: bool) -> bool:
    """Whether ``folded_mix_pool``'s one-launch backward takes a folded mix
    of ``heads`` heads whose block tables move blk-row blocks, with grp =
    in // O (0 where O does not divide in), routed or not: kernel B8's wgmma
    kernel with the pool term, i.e. bf16, no route, blk % 64 == 0 (a 64-row
    tile lies in one token), grp a multiple of 16 (a warp's 16 rows in one
    pool column), O a multiple of 8 and at most ``MAX_HEADS`` heads."""
    return (not routed and grp > 0 and grp % 16 == 0 and o % 8 == 0
            and (o * grp) % blk == 0 and 1 <= heads <= MAX_HEADS
            and block_bwd_kernel(dtype, blk) == "fused_block_bwd_wgmma")


class _FoldedMixPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xt, w, s4, blk, bsrc, binv, grp):
        n, b = s4.shape[0], xt.shape[1]
        g4 = block_scatter_rows(xt, bsrc, blk).view(n, -1, b)
        y = folded_bmm(g4, fold_weights(w, s4))
        pool = grouped_pool(g4, grouped_pool_weights(s4, grp), grp)
        ctx.blk, ctx.grp = blk, grp
        ctx.save_for_backward(g4, w, s4, binv)
        return y, pool

    @staticmethod
    def backward(ctx, dy, dpool):
        # autograd hands zeros for an output the loss does not reach
        g4, w, s4, binv = ctx.saved_tensors
        dy = dy.contiguous()
        dxt = dw = None
        if ctx.needs_input_grad[0]:
            dxt = fused_block_bwd(dy, w, s4, binv, ctx.blk, dpool, ctx.grp)
        if ctx.needs_input_grad[1]:
            dw = _folded_dw(g4, s4, dy)
        return dxt, dw, None, None, None, None, None


def folded_mix_pool(xt: torch.Tensor, w: torch.Tensor, s4: torch.Tensor, tables: MixTables,
                    grp: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The folded mix up to its LayerNorm, as one op (JAX's ``perm_rows_t``
    then ``folded_proj_pool(g4, w, s4, grp)``): g4 = ``perm_rows_t``(xt,
    tables) viewed [N, in, B], then y = ``folded_proj``(g4, w, s4) and the
    grouped sign-mean pool = ``grouped_pool``(g4, ``grouped_pool_weights``
    (s4, grp), grp), both [N, B, O]. xt contiguous [d, B], w [in, O], s4
    [N, in] signs, in = O * grp. Gradients for xt (one launch of kernel B8
    with the pool term) and w; the backward needs ``fuses_mix_backward`` to
    hold on a card (on the CPU the kernel's plain version takes any dtype,
    blk and grp)."""
    return _FoldedMixPool.apply(xt, w, s4, tables.blk, tables.bsrc, tables.binv, grp)


def signed_stream_proj(g4: torch.Tensor, w: torch.Tensor, s4: torch.Tensor) -> torch.Tensor:
    """``folded_proj``'s value with the signs on the stream: (s4 * g4) read as
    [N, B, in] rows, then one product with the shared w [in, O] -> [N, B, O].
    The exported program's folded projection: it holds w, never the
    [N, in, O] folded weights. A +-1 product is exact, so against
    ``folded_bmm`` with ``fold_weights`` only the summation order of the
    product can differ."""
    return torch.matmul((g4 * s4[:, :, None]).transpose(1, 2), w)


def folded_proj(g4: torch.Tensor, w: torch.Tensor, s4: torch.Tensor) -> torch.Tensor:
    """y[n, b, o] = sum_e g4[n, e, b] * s4[n, e] * w[e, o]: the projection of
    the permuted stream g4 [N, in, B] with the signs s4 [N, in] folded into
    the weights w [in, O] -> [N, B, O]. Gradients for g4 and w."""
    return _FoldedProj.apply(g4, w, s4)


class _PermutMixFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, perms, signs2):
        ctx.save_for_backward(perms, signs2)
        h, d = perms.shape
        return x2d.index_select(1, perms.reshape(-1).long()).view(-1, h, d) * signs2

    @staticmethod
    def backward(ctx, g):
        perms, signs2 = ctx.saved_tensors
        h, d = perms.shape
        gs = (g * signs2).reshape(g.shape[0], h * d)
        # dx[b, j] = sum_h gs[b, h*d + inv[h, j]]: entry j*H + h of the flat
        # table is h*d + inv[h, j]
        inv = torch.argsort(perms.long(), dim=-1)
        offs = torch.arange(h, device=inv.device)[:, None] * d
        idx = (inv + offs).t().reshape(-1)
        return gs.index_select(1, idx).view(-1, d, h).sum(dim=2), None, None


def permut_mix_fused(x2d: torch.Tensor, perms: torch.Tensor,
                     signs2: torch.Tensor) -> torch.Tensor:
    """``m[b, h, i] = x2d[b, perms[h, i]] * signs2[h, i]``: x2d [B, d], perms
    int32 [H, d] (each row a permutation of range(d)), signs2 [H, d] +-1 ->
    [B, H, d]. Gradient for x2d only."""
    return _PermutMixFused.apply(x2d, perms, signs2)


class _PermutMixFusedT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xt, perms, signs2):
        ctx.save_for_backward(perms, signs2)
        return xt.index_select(0, perms.reshape(-1).long()) * signs2.reshape(-1, 1)

    @staticmethod
    def backward(ctx, g):
        perms, signs2 = ctx.saved_tensors
        h, d = perms.shape
        gs = (g.reshape(h, d, -1) * signs2[:, :, None]).reshape(h * d, -1)
        dxt = gs.index_select(0, _inverse_row_table(perms))
        return dxt.view(d, h, -1).sum(dim=1), None, None


def _inverse_row_table(perms: torch.Tensor) -> torch.Tensor:
    """[d*H] flat row table of the inverse of the multi-head row gather:
    entry j*H + h is ``h*d + inv[h, j]`` (perms[h, inv[h, j]] = j)."""
    h, d = perms.shape
    inv = torch.argsort(perms.long(), dim=-1)
    offs = torch.arange(h, device=inv.device)[:, None] * d
    return (inv + offs).t().reshape(-1)


def permut_mix_fused_t(xt: torch.Tensor, perms: torch.Tensor,
                       signs2: torch.Tensor) -> torch.Tensor:
    """Token-major mix: [d, B] -> [H*d, B]; row ``h*d + i`` of the output is
    ``xt[perms[h, i]] * signs2[h, i]`` (``permut_mix_fused`` on xt.T). The
    output is the [N, E*H, B] stream a per-token projection reads, with no
    relayout. perms int32 [H, d], signs2 [H, d] +-1. Gradient for xt only:
    the signed cotangent, one flat gather by the inverse rows, a [d, H, B]
    sum over heads."""
    return _PermutMixFusedT.apply(xt, perms, signs2)
