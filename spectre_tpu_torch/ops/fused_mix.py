"""The permutation mix as autograd Functions (port of
spectre_tpu/ops/fused_mix.py): the folded route, and ``permut_mix_fused``,
the batch-major gather with an inverse-gather backward.

The mix is ``m[b, h, i] = x[b, perms[h, i]] * signs[h, i]`` followed by a
projection. In the folded form the gather runs sign-free on the token-major
[d, B] stream (``perm_rows_t``) and the signs ride in the projection:
``y[n] = g4[n]^T (diag(s4[n]) W)`` (``folded_proj``). Multiplying by +-1 is
exact in any float format.

Both are ``torch.autograd.Function``s:

- ``perm_rows_t``: forward is the block-row copy (kernels.block_scatter_rows);
  backward is the head-summed inverse gather, kernels.block_gather_sum for a
  block table (blk >= 2) and kernels.inverse_gather_sum for a uniform one.
- ``folded_proj(g4, w, s4)``: the backward is reassociated so that the
  [N, in, O] cotangent of the folded weights never exists:
  ``dg4 = s4 * (w @ dy^T)`` with w shared over tokens, and
  ``dW = sum_{n,b} (s4 * g4)[n, :, b] dy[n, b, :]`` as one product with
  K = N*B. ``s4`` holds fixed signs and gets no gradient.

- ``permut_mix_fused(x2d, perms, signs2)``: [B, d] -> [B, H, d], the exact
  gather mix. Nothing activation-sized is saved; the backward applies the
  signs first, then one flat gather by the inverse permutations and the sum
  over heads (a gather instead of autograd's scatter-add). Plain torch ops
  in both directions, as the JAX function is jnp.

The JAX route registry and its stale-route guards do not come over: the
model derives its tables from its own buffers (models/layers.py).
"""

from __future__ import annotations

import torch

from spectre_tpu_torch.ops.kernels import (
    block_gather_sum,
    block_scatter_rows,
    inverse_gather_sum,
)
from spectre_tpu_torch.ops.permute import MixTables


def perm_rows_t_plain(xt: torch.Tensor, perms: torch.Tensor) -> torch.Tensor:
    """Sign-free multi-head row permutation, token-major: [d, B] -> [H*d, B];
    row ``h*d + i`` is ``xt[perms[h, i]]``. The plain gather for any table,
    differentiable by autograd; tests hold ``perm_rows_t`` to it."""
    return xt.index_select(0, perms.reshape(-1))


class _PermRowsT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xt, blk, bsrc, binv):
        ctx.blk = blk
        ctx.save_for_backward(binv)
        return block_scatter_rows(xt, bsrc, blk)

    @staticmethod
    def backward(ctx, g):
        (binv,) = ctx.saved_tensors
        g = g.contiguous()
        if ctx.blk == 1:  # uniform table: binv is the row-level inverse
            return inverse_gather_sum(g, binv), None, None, None
        return block_gather_sum(g, binv, ctx.blk), None, None, None


def perm_rows_t(xt: torch.Tensor, tables: MixTables) -> torch.Tensor:
    """``perm_rows_t_plain`` for the permutation ``tables`` was derived from
    (``derive_mix_tables``), through the kernels in both directions.
    xt must be contiguous [d, B]."""
    return _PermRowsT.apply(xt, tables.blk, tables.bsrc, tables.binv)


def fold_weights(w: torch.Tensor, s4: torch.Tensor) -> torch.Tensor:
    """Per-token folded weights [N, in, O] = s4[n, e] * w[e, o]."""
    return s4[:, :, None] * w[None]


def folded_bmm(g4: torch.Tensor, wp: torch.Tensor) -> torch.Tensor:
    """y[n, b, o] = sum_e g4[n, e, b] * wp[n, e, o]: one batched product over
    tokens, g4 [N, in, B] -> [N, B, O]."""
    return torch.bmm(g4.transpose(1, 2), wp)


class _FoldedProj(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g4, w, s4):
        ctx.save_for_backward(g4, w, s4)
        return folded_bmm(g4, fold_weights(w, s4))

    @staticmethod
    def backward(ctx, dy):
        g4, w, s4 = ctx.saved_tensors
        n, e, b = g4.shape
        dy = dy.contiguous()
        dg4 = dw = None
        if ctx.needs_input_grad[0]:
            # [in, O] @ [N, O, B] -> contiguous [N, in, B], w shared over
            # tokens (a stride-0 batch, not a copy); the signs go on in place
            dg4 = torch.bmm(w.expand(n, -1, -1), dy.transpose(1, 2))
            dg4.mul_(s4[:, :, None])
        if ctx.needs_input_grad[1]:
            # s4 * g4 written straight into [in, N, B], so that {n, b} is one
            # contiguous K axis and dW is a single product
            sg = torch.empty((e, n, b), dtype=g4.dtype, device=g4.device)
            torch.mul(g4.transpose(0, 1), s4.t()[:, :, None], out=sg)
            dw = torch.matmul(sg.view(e, n * b), dy.view(n * b, -1))
        return dg4, dw, None


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
