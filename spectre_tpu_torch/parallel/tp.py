"""Tensor parallelism with explicit collectives (port of spectre_tpu/parallel/tp.py).

The JAX package annotates parameters with ``model``-axis shardings and lets
GSPMD partition the products and insert the all-reduces. Here the rules pick
the same parameters and the same dimensions (``tp_specs`` gives JAX's spec of
every leaf, ``apply_tp`` makes those parameters ``DTensor`` shards on the
mesh's ``model`` axis), and each layer that holds a shard runs its own part
of the product on local tensors (``.to_local()``: a kernel launched on a
``DTensor``'s storage would read only the shard) with the collectives
written out:

- column-parallel (kernel [K, N] split over N; its bias and, for the
  ``_ProjectionLN`` family, ``ln_scale``/``ln_bias`` with it): the local
  product gives this rank's output columns. A LayerNorm over N needs the
  whole row: for a SpectreLinear, kernel B3's column-shard entries
  (``ops/kernels/fused_linear.py``) give h and this rank's row statistics,
  the statistics are all-gathered, and the epilogue entry merges them in
  rank order; the backward all-gathers the chain's row sums the same way.
  GELU and the columns of the pool residual are local. The output stays
  split when the next layer is row-parallel, else it is all-gathered.
- row-parallel (kernel split over the contracting K): the local product is
  a partial sum, all-reduced before the bias, LayerNorm and GELU (for a
  SpectreLinear: float32 partials, then B3's epilogue entry on the whole
  rows, and B3's backward on the local operands). When the input is split
  too (it comes from a column-parallel layer), the pool residual is a
  partial sum as well and rides in the same all-reduce; when the input is
  whole, this rank takes its rows of it and the pool is local.

Autograd through the collectives follows Megatron: ``copy_to_model`` is the
identity forward and an all-reduce backward (a whole input feeding a split
product); ``reduce_from_model`` is an all-reduce forward and the identity
backward (the partial sums, after which every rank computes the same
thing). The SpectreLinear shards are ``torch.autograd.Function``s whose
collectives sit between the kernel entries; on the CPU the entries run
their plain versions, so the CPU holds this arithmetic against JAX's mesh
steps, and on the card they launch the kernels. A Dropout after a
column-split output draws the whole row's mask and keeps this rank's
columns (``column_window``), so that the masks are the unsplit model's.
"""

from __future__ import annotations

import re
import threading

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard, distribute_tensor

from spectre_tpu_torch.ops import (
    adaptive_pool_matrix,
    folded_bmm,
    folded_proj,
    gelu_exact,
    layer_norm,
    permut_mix_fused_t,
)
from spectre_tpu_torch.ops.kernels import (
    chain_shard_dh,
    chain_shard_sums,
    fused_spectre_linear_bwd,
    fused_spectre_linear_shard_stats,
    linear_products,
    matmul_f32,
    sharded_ln_gelu,
)
from spectre_tpu_torch.parallel.mesh import MODEL_AXIS

# (regex on the port's parameter name, the JAX spec: one entry per dim, the
# model axis where the dim is split). First match wins; the rest replicate.
VIT_TP_RULES = (
    (r"encoder_\d+\.linear1\.kernel$", (None, MODEL_AXIS)),
    (r"encoder_\d+\.linear1\.bias$", (MODEL_AXIS,)),
    (r"encoder_\d+\.linear2\.kernel$", (MODEL_AXIS, None)),
    (r"self_attn\.mhsa\.(query|key|value)\.kernel$", (None, MODEL_AXIS, None)),
    (r"self_attn\.mhsa\.(query|key|value)\.bias$", (MODEL_AXIS, None)),
    (r"self_attn\.mhsa\.out\.kernel$", (MODEL_AXIS, None, None)),
)

SPECTRE_TP_RULES = (
    # the mix projection contracts over E*H: each rank projects its rows
    (r"mix_layer\.linear\.kernel$", (MODEL_AXIS, None)),
    # the wide FF hidden dim
    (r"linear1\.kernel$", (None, MODEL_AXIS)),
    (r"linear1\.(bias|ln_scale|ln_bias)$", (MODEL_AXIS,)),
    (r"linear3\.kernel$", (MODEL_AXIS, None)),
)

# (producer, consumer) of each module type: a column-parallel producer keeps
# its output split for a row-parallel consumer
_PAIRS = {
    "SpectreEncoderLayer": ("linear1", "linear3"),
    "TransformerEncoderLayer": ("linear1", "linear2"),
    "SpectreBranchEncoderLayer": ("linear1", "linear2"),
}


def trim(spec) -> tuple:
    """A spec without its trailing unsplit dims: ``(MODEL_AXIS, None)`` and
    ``(MODEL_AXIS,)`` say the same."""
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def tp_specs(model: nn.Module, model_size: int, rules) -> dict[str, tuple]:
    """JAX's ``tp_shardings`` for the port's parameters: {name: spec}, spec
    ``()`` for a replicated leaf (trailing unsplit dims dropped). A rule
    whose split dim does not divide by ``model_size`` leaves the leaf
    replicated, as in JAX."""
    out = {}
    for name, p in model.named_parameters():
        out[name] = ()
        for pattern, spec in rules:
            if re.search(pattern, name):
                if all(axis != MODEL_AXIS or p.shape[d] % model_size == 0
                       for d, axis in enumerate(spec)):
                    out[name] = trim(spec)
                break
    return out


def local(t: torch.Tensor) -> torch.Tensor:
    """The local shard of a ``DTensor``, else the tensor itself."""
    return t.to_local() if isinstance(t, DTensor) else t


# -- the collectives, differentiable -----------------------------------------

def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, group=group)
    return x


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    """All-gather the last dim; backward takes this rank's block of a
    gradient that every rank holds whole."""

    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.rank, ctx.n = rank, x.shape[-1]
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n], None, None, None


def copy_to_model(x, group):
    return _CopyToModel.apply(x, group)


def reduce_from_model(x, group):
    return _ReduceFromModel.apply(x, group)


# -- SpectreLinear split over ranks: kernel B3's shard entries -----------------

EPS = 1e-5  # SpectreLinear's LayerNorm


class _ColumnSpectreLinear(torch.autograd.Function):
    """SpectreLinear split by columns, on this rank's n of N: entry 1 (h and
    the row statistics of these columns), their all-gather (``gather``),
    entry 2 (the merged LayerNorm, GELU and the pool residual's columns).
    Backward: entry 3 (the row sums and dgamma, dbeta), the all-gather of
    the row sums, entry 4 (dh, db), then dW = x^T dh and this rank's partial
    dx = dh W^T, which ``copy_to_model`` sums."""

    @staticmethod
    def forward(ctx, x, w, b, gamma, beta, residual, gather, eps):
        n = w.shape[1]
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        gamma, beta = gamma.contiguous(), beta.contiguous()
        h, stats = fused_spectre_linear_shard_stats(x2, w.contiguous(), b.contiguous())
        stats = gather(stats)
        n_full = stats.shape[0] * n
        out, mstats, _ = sharded_ln_gelu(h, stats, gamma, beta, n_full,
                                         residual=residual.reshape(-1, n), eps=eps)
        ctx.save_for_backward(x2, w, gamma, beta, h, mstats)
        ctx.gather, ctx.n_full, ctx.x_shape = gather, n_full, x.shape
        return out.view(*x.shape[:-1], n)

    @staticmethod
    def backward(ctx, g):
        x2, w, gamma, beta, h, mstats = ctx.saved_tensors
        g2 = g.reshape(h.shape).contiguous()
        rows, sums = chain_shard_sums(h, g2, gamma, beta, mstats)
        dh, db = chain_shard_dh(h, g2, gamma, beta, mstats, ctx.gather(rows), ctx.n_full)
        dx, dw = linear_products(x2, w.contiguous(), dh)
        return dx.view(ctx.x_shape), dw, db, sums[0], sums[1], g, None, None


class _RowSpectreLinear(torch.autograd.Function):
    """SpectreLinear split by the rows of its kernel: the partial product in
    float32 sums (with the pool residual's partial when ``pool`` is given:
    the input is this rank's columns), all-reduced (``reduce``), then entry
    2 on the whole rows, which adds the bias, saves h and adds the pool (or
    ``residual``, whole). Backward: ``fused_spectre_linear_bwd`` on the
    local operands (dh of the whole rows, this rank's dW and dx) and the
    pool's part of dx."""

    @staticmethod
    def forward(ctx, x, w, b, gamma, beta, pool, residual, reduce, eps):
        n = w.shape[1]
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        gamma, beta = gamma.contiguous(), beta.contiguous()
        parts = [matmul_f32(x2, w)]
        if pool is not None:
            parts.append(matmul_f32(x2, pool))
        s = reduce(torch.cat(parts, -1) if len(parts) > 1 else parts[0])
        res = s[:, n:] if pool is not None else residual.reshape(-1, n).float()
        out, _, h = sharded_ln_gelu(s[:, :n], None, gamma, beta, n, bias=b.contiguous(),
                                    residual=res, eps=eps)
        ctx.save_for_backward(x2, w, gamma, beta, h, pool)
        ctx.eps, ctx.x_shape = eps, x.shape
        ctx.residual_dtype = None if residual is None else residual.dtype
        return out.view(*x.shape[:-1], n)

    @staticmethod
    def backward(ctx, g):
        x2, w, gamma, beta, h, pool = ctx.saved_tensors
        g2 = g.reshape(h.shape).contiguous()
        dx, dw, db, dgamma, dbeta = fused_spectre_linear_bwd(
            x2, w.contiguous(), gamma, beta, h, g2, ctx.eps, identity=False)
        if pool is not None:
            dx = dx + torch.mm(g2, pool.t())
        dres = None if ctx.residual_dtype is None else g.to(ctx.residual_dtype)
        return dx.view(ctx.x_shape), dw, db, dgamma, dbeta, None, dres, None, None


def column_spectre_linear(x, w, b, gamma, beta, residual, gather, eps: float = EPS):
    """GELU(LN(x @ w + b)) + residual on this rank's columns (w [K, n], b,
    gamma, beta [n], residual [..., n]) of a SpectreLinear split by columns;
    ``gather(t)`` stacks every rank's t in rank order ([size, ...]): an
    all-gather on the model group, or any stand-in that gives the ranks'
    values."""
    return _ColumnSpectreLinear.apply(x, w, b, gamma, beta, residual, gather, eps)


def row_spectre_linear(x, w, b, gamma, beta, reduce, *, pool=None, residual=None,
                       eps: float = EPS):
    """GELU(LN(sum over ranks of x @ w, + b)) + the pool residual, whole, of
    a SpectreLinear split by the rows of its kernel (x [..., K_local], w
    [K_local, N]); ``reduce(t)`` sums t over the ranks (an all-reduce).
    ``pool`` [K_local, N]: this rank's rows of the pool matrix, whose partial
    rides in the same reduction; else ``residual`` [..., N] whole."""
    return _RowSpectreLinear.apply(x, w, b, gamma, beta, pool, residual, reduce, eps)


class LocalRanks:
    """``size`` ranks of one process, each run in a thread of its own, whose
    ``gather(rank)`` callables meet at a barrier: the shard Functions run on
    in-process shards without a process group (the checks of the entries
    on whole layers). Backward in a thread: ``out.grad_fn.apply(g)``, as the
    autograd engine runs a card's work in one thread of its own."""

    def __init__(self, size: int):
        self.size, self._slots = size, [None] * size
        self._barrier = threading.Barrier(size)

    def gather(self, rank: int):
        def gather(t: torch.Tensor) -> torch.Tensor:
            self._slots[rank] = t
            self._barrier.wait()
            out = torch.stack(self._slots)
            self._barrier.wait()
            return out
        return gather

    def reduce(self, rank: int):
        gather = self.gather(rank)
        return lambda t: gather(t).sum(0)

    def run(self, fn) -> list:
        """[fn(rank) for each rank], each rank in its own thread."""
        out, errors = [None] * self.size, []

        def body(rank):
            try:
                out[rank] = fn(rank)
            except Exception as e:  # raised again in the caller's thread, below
                errors.append(e)
                self._barrier.abort()

        threads = [threading.Thread(target=body, args=(r,)) for r in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return out


# -- the layers' shard forwards ------------------------------------------------

class TensorParallel:
    """What a layer needs to run its shard: the ``model`` axis group, its
    rank and size there, ``mode`` ("col" or "row"), whether the output stays
    split (col) or the input comes split (row), and the pool matrix's block
    (``_ProjectionLN`` layers whose widths differ)."""

    def __init__(self, group, rank: int, size: int, mode: str, split: bool,
                 pool: torch.Tensor | None = None):
        self.group, self.rank, self.size = group, rank, size
        self.mode, self.split, self.pool = mode, split, pool

    def _block(self, n: int) -> slice:
        return slice(self.rank * n // self.size, (self.rank + 1) * n // self.size)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """[size, *t.shape]: every rank's ``t`` in rank order (all-gather)."""
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.stack(parts)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        return _all_reduce(t, self.group)

    def column_window(self, features: int) -> tuple[int, int] | None:
        """(whole width, first column) of this rank's columns of an output
        of ``features`` that stays split by columns; else None."""
        if self.mode != "col" or not self.split:
            return None
        return features, self._block(features).start

    def _out(self, y):
        if self.mode == "col" and not self.split:
            return _GatherLast.apply(y, self.group, self.rank, self.size)
        return y

    def projection_ln(self, m, x: torch.Tensor) -> torch.Tensor:
        """SpectreLinear: GELU(LN(x @ W + b)) + pool(x) on this rank's shard."""
        dt = m.dtype
        w, b = local(m.kernel).to(dt), local(m.bias).to(dt)
        gamma, beta = local(m.ln_scale).to(dt), local(m.ln_bias).to(dt)
        x = x.to(dt)
        if self.mode == "col":
            xr = copy_to_model(x, self.group)
            pool = xr[..., self._block(m.in_features)] if self.pool is None \
                else torch.matmul(xr, self.pool)
            return self._out(column_spectre_linear(xr, w, b, gamma, beta, pool, self.gather))
        if self.split:  # x holds this rank's rows of the contracting dim
            return row_spectre_linear(x, w, b, gamma, beta, self.all_reduce, pool=self.pool)
        xr = copy_to_model(x, self.group)[..., self._block(m.in_features)]
        return row_spectre_linear(xr, w, b, gamma, beta, self.all_reduce,
                                  residual=torch.matmul(x, self.pool))

    def folded_mix_linear(self, m, g4: torch.Tensor, mix) -> torch.Tensor:
        """FoldedMixLinear with its kernel split over the contracting E*H:
        the stream g4 [N, in, B] is whole on every rank, so each projects
        its rows of it and the pool residual is local."""
        dt = m.dtype
        n, _, b = g4.shape
        rows = self._block(m.in_features)
        g4r = copy_to_model(g4, self.group)[:, rows, :].contiguous()
        w = local(m.kernel).to(dt)
        s4 = mix.s4[:, rows].contiguous()
        y = reduce_from_model(folded_proj(g4r, w, s4), self.group) + local(m.bias).to(dt)
        if mix.grp:
            pool = torch.einsum("nuvb,nuv->nbu", g4.reshape(n, m.features, mix.grp, b),
                                mix.pool_w)
        else:
            pool = folded_bmm(g4, mix.pool_w)
        h = gelu_exact(layer_norm(y, local(m.ln_scale).to(dt), local(m.ln_bias).to(dt))) + pool
        return h.transpose(0, 1)

    def token_major_mix_linear(self, m, x, perms, signs2) -> torch.Tensor:
        """TokenMajorMixLinear with its kernel split over the contracting E*H."""
        dt = m.dtype
        b, n, e = x.shape
        xt = x.to(dt).permute(1, 2, 0).reshape(n * e, b)
        m3 = permut_mix_fused_t(xt, perms, signs2).view(n, m.in_features, b)
        rows = m3.transpose(1, 2)  # [N, B, in]
        mine = copy_to_model(rows, self.group)[..., self._block(m.in_features)]
        y = reduce_from_model(torch.matmul(mine, local(m.kernel).to(dt)), self.group)
        pool = torch.matmul(rows, self.pool)
        h = gelu_exact(layer_norm(y + local(m.bias).to(dt), local(m.ln_scale).to(dt),
                                  local(m.ln_bias).to(dt))) + pool
        return h.transpose(0, 1)

    def dense(self, m, x: torch.Tensor) -> torch.Tensor:
        """Dense (kernel [in, out]) split by columns or by rows."""
        dt = m.dtype
        w, b = local(m.kernel).to(dt), local(m.bias).to(dt)
        x = x.to(dt)
        if self.mode == "col":
            return self._out(torch.matmul(copy_to_model(x, self.group), w) + b)
        if not self.split:
            x = copy_to_model(x, self.group)[..., self._block(m.in_features)]
        return reduce_from_model(torch.matmul(x, w), self.group) + b

    def heads_dense(self, m, x: torch.Tensor) -> torch.Tensor:
        """The attention's query/key/value over this rank's heads:
        [B, N, E] -> [B, N, H / size, D]."""
        dt = m.dtype
        w = local(m.kernel).to(dt)
        e, h, d = w.shape
        y = torch.matmul(copy_to_model(x, self.group), w.reshape(e, h * d)) \
            + local(m.bias).to(dt).reshape(h * d)
        return y.view(*x.shape[:-1], h, d)

    def heads_out(self, m, x: torch.Tensor) -> torch.Tensor:
        """The attention's out projection from this rank's heads
        [B, N, H / size, D]: partial sums all-reduced, then the bias."""
        dt = m.dtype
        w = local(m.kernel).to(dt)
        h, d, e = w.shape
        part = torch.matmul(x.reshape(*x.shape[:-2], h * d), w.reshape(h * d, e))
        return reduce_from_model(part, self.group) + local(m.bias).to(dt)


def _split_dim(p) -> int | None:
    if isinstance(p, DTensor):
        for mesh_dim, pl in enumerate(p.placements):
            if p.device_mesh.mesh_dim_names[mesh_dim] == MODEL_AXIS and pl.is_shard():
                return pl.dim
    return None


def _configure(model: nn.Module, group, rank: int, size: int) -> int:
    """Give every layer that holds a split kernel its ``tp``; returns how
    many. Raises on a split the shard forwards do not cover."""
    from spectre_tpu_torch.models.layers import (
        Dense,
        FoldedMixLinear,
        SpectreLinear,
        TokenMajorMixLinear,
    )
    from spectre_tpu_torch.models.mixers import MultiHeadAttention

    def mode_of(m):
        d = _split_dim(m.kernel) if hasattr(m, "kernel") else None
        return None if d is None else ("col" if d == m.kernel.dim() - 1 else "row")

    consumer_of, producer_of = {}, {}
    for parent in model.modules():
        pair = _PAIRS.get(type(parent).__name__)
        if pair:
            a, c = getattr(parent, pair[0]), getattr(parent, pair[1])
            consumer_of[a], producer_of[c] = c, a
    n = 0
    for m in model.modules():
        if isinstance(m, MultiHeadAttention):
            # split over heads: dim 1 of query/key/value [E, H, D], dim 0 of
            # out [H, D, E]
            dims = [_split_dim(p.kernel) for p in (m.query, m.key, m.value, m.out)]
            if dims == [1, 1, 1, 0]:
                for p, mode in zip((m.query, m.key, m.value, m.out), ("col",) * 3 + ("row",)):
                    p.tp = TensorParallel(group, rank, size, mode, mode == "row")
                n += 4
            elif any(d is not None for d in dims):
                modes = dims
                raise NotImplementedError(f"attention split as {modes}: tensor parallelism "
                                          "splits query/key/value and out together")
            continue
        mode = mode_of(m) if isinstance(m, (Dense, SpectreLinear, FoldedMixLinear,
                                            TokenMajorMixLinear)) else None
        if mode is None:
            if hasattr(m, "kernel") and _split_dim(m.kernel) is not None \
                    and getattr(m, "tp", None) is None:
                raise NotImplementedError(f"{type(m).__name__}: no shard forward")
            continue
        if mode == "col":
            split = mode_of(consumer_of[m]) == "row" if m in consumer_of else False
        else:
            prod = producer_of.get(m)
            split = prod is not None and mode_of(prod) == "col"
        if mode == "col" and isinstance(m, (FoldedMixLinear, TokenMajorMixLinear)):
            raise NotImplementedError(f"{type(m).__name__} splits over its input rows only")
        pool = None
        if not isinstance(m, Dense) and (m.in_features != m.features or mode == "row"):
            full = adaptive_pool_matrix(m.in_features, m.features, m.dtype,
                                        local(m.kernel).device)
            if mode == "col":
                blk = slice(rank * m.features // size, (rank + 1) * m.features // size)
                pool = full[:, blk].contiguous()
            elif split:
                blk = slice(rank * m.in_features // size, (rank + 1) * m.in_features // size)
                pool = full[blk].contiguous()
            else:
                pool = full
        m.tp = TensorParallel(group, rank, size, mode, split, pool)
        n += 1
    return n


def apply_tp(model: nn.Module, mesh: DeviceMesh, rules) -> nn.Module:
    """Split the parameters the rules match over the mesh's ``model`` axis
    (``DTensor`` shards, the rest stay whole) and give each layer that holds
    one its shard forward. In place; returns ``model``. Parameters are
    replaced: an optimizer built earlier must take the new ones
    (``parallel.layout.parallelize`` swaps them)."""
    tp_mesh = mesh[MODEL_AXIS]
    size = tp_mesh.size()
    for name, spec in tp_specs(model, size, rules).items():
        if MODEL_AXIS not in spec:
            continue
        mod_name, _, pname = name.rpartition(".")
        owner = model.get_submodule(mod_name)
        p = getattr(owner, pname)
        shard = distribute_tensor(p.detach(), tp_mesh, [Shard(spec.index(MODEL_AXIS))])
        owner.register_parameter(pname, nn.Parameter(shard, requires_grad=p.requires_grad))
    _configure(model, tp_mesh.get_group(), tp_mesh.get_local_rank(), size)
    return model
