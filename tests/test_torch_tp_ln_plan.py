"""Kernel B3's entry 2 under tensor parallelism (``sharded_ln_gelu``) on the
CPU: its launch plan (``shard_ln_plan``) and its whole-row summation order,
mirrored in plain torch from ``csrc/fused_spectre_linear.cu`` and held to the
JAX package.

The plan is walked in Python: every (row, column) of h is taken by exactly
one lane of one team of one block, for a column shard (tiles on blockIdx.y)
and for a whole row (tiles as the warps of one team, or a row walked by a
block), whatever n and M, and its vectors divide every base and row stride
of operands laid out at each alignment, strided as linear3's rows are. The
mirror takes a whole row's two sums in the kernel's order: a lane's values
in order, the butterfly across the team's lanes, the warps in order; it is
held against the JAX package's ``fused_spectre_linear`` (the Pallas kernel
in interpret mode), out and h within 1e-5 of their largest entry in float32.
A shard's statistics, merged in rank order by the plain version, are what
``merge_stats`` gives, bit for bit. tests/test_torch_port_cuda.py holds the
kernel to the plain version on the card.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from spectre_tpu.ops.pallas.fused_linear import _forward as jax_fused_forward
from spectre_tpu_torch.ops import adaptive_avg_pool1d
from spectre_tpu_torch.ops.kernels.fused_linear import (
    SHARD_THREADS,
    ShardLnPlan,
    _alignment,
    _shard_ln_align,
    merge_stats,
    shard_ln_plan,
    sharded_ln_gelu_plain,
)

EPS = 1e-5
PLAN_WIDTHS = (25, 50, 192, 384, 512, 1536)
PLAN_ROWS = (1, 130, 16640)
# a whole row past a block's register reach (16 values a lane, 8 warps):
# walked
WALK_WIDTH = 4100


def _lane_columns(plan: ShardLnPlan, n: int):
    """Each lane's columns in the order it takes them, [groups, lanes,
    slots], and whether each lies within the row; groups are a shard's tiles
    or a whole row's warps. Registers: group w's tile, chunk c, value e at
    w * tile + (c * lanes + l) * vec + e. Walk: thread t = 32 w + l takes
    the vectors t, t + threads, ... in turn."""
    e = torch.arange(plan.vec)
    if plan.chunks:
        groups = max(plan.tiles, plan.warps)
        w = torch.arange(groups)[:, None, None, None]
        lane = torch.arange(plan.lanes)[None, :, None, None]
        c = torch.arange(plan.chunks)[None, None, :, None]
        cols = w * plan.lanes * plan.chunks * plan.vec + (c * plan.lanes + lane) * plan.vec + e
    else:
        steps = -(-n // (plan.threads * plan.vec))
        t = torch.arange(plan.threads).view(plan.warps, 32)[:, :, None, None]
        k = torch.arange(steps)[None, None, :, None]
        cols = (t + k * plan.threads) * plan.vec + e
    cols = cols.reshape(cols.shape[0], cols.shape[1], -1)
    return cols, cols < n


def _check_plan(plan, dtype, m, n, whole, align=16):
    el = dtype.itemsize
    assert n % plan.vec == 0 and plan.vec * el <= 16 and align % (plan.vec * el) == 0
    assert 0 <= plan.chunks <= 4 and plan.chunks * plan.vec <= 16
    assert plan.lanes in (1, 2, 4, 8, 16, 32)
    width = plan.lanes * plan.warps
    assert plan.threads % width == 0 and plan.threads <= SHARD_THREADS < plan.threads + width
    if whole:
        assert plan.tiles == 1  # a whole row stays in one block: its sums meet there
        assert plan.warps == 1 or plan.lanes == 32
    else:
        assert plan.warps == 1 and plan.chunks > 0 and plan.tiles <= 65535
        assert plan.tiles == 1 or plan.lanes == 32
    if plan.chunks == 0:
        assert whole and plan.warps * 32 == plan.threads == SHARD_THREADS
    assert 1 <= plan.blocks <= m and plan.blocks * plan.rows >= m
    assert (plan.blocks - 1) * plan.rows < m  # no block is empty
    cols, valid = _lane_columns(plan, n)
    vec_start = cols[..., ::plan.vec]
    assert bool(((vec_start < n) == valid[..., ::plan.vec]).all())
    assert bool((valid.view(*valid.shape[:2], -1, plan.vec).all(-1)
                 == valid.view(*valid.shape[:2], -1, plan.vec).any(-1)).all())  # whole vectors
    assert torch.equal(torch.sort(cols[valid]).values, torch.arange(n))
    # block b's team t takes rows b * rows + t + k * teams of its share
    teams = plan.threads // width
    b = np.arange(plan.blocks)[:, None, None]
    t = np.arange(teams)[None, :, None]
    k = np.arange(-(-plan.rows // teams))[None, None, :]
    rows = b * plan.rows + t + k * teams
    taken = rows[(t + k * teams < plan.rows) & (rows < m)]
    assert np.array_equal(np.sort(taken), np.arange(m))


@pytest.mark.parametrize("whole", [False, True])
@pytest.mark.parametrize("n", PLAN_WIDTHS + (WALK_WIDTH,))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_covers_every_row_and_column_once(dtype, n, whole):
    for m in PLAN_ROWS:
        for align in (16, 8, 4, 2)[:4 if dtype == torch.bfloat16 else 3]:
            plan = shard_ln_plan(dtype, m, n, align, whole)
            _check_plan(plan, dtype, m, n, whole, align)
            # walked: a whole row past 8 warps of at most 4 vectors and 16 values a lane
            assert (plan.chunks == 0) == (whole and n > 8 * 32 * min(4 * plan.vec, 16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_vectors_divide_strided_operands(dtype):
    """Operands at every base alignment and row stride (h and the residual
    views into wider rows, as linear3's halves of [M, 2n] and linear1's
    columns of the pool are): the plan's vector divides each base and each
    row stride, so every vector load is aligned."""
    el = dtype.itemsize
    for n in (25, 50, 192, 384, 512):
        for offset in (0, 1, 2, 4, 8):
            for pad in (0, 1, 2, 4, n):
                buf = torch.zeros(8 * (n + pad) + 16, dtype=dtype)
                h = buf[offset:offset + 8 * (n + pad)].view(8, n + pad)[:, :n]
                res = buf[:8 * (n + pad)].view(8, n + pad)[:, pad:]
                gamma = torch.zeros(n, dtype=dtype)
                plan = shard_ln_plan(dtype, 8, n, _alignment(h, res, gamma), False)
                vb = plan.vec * el
                for t in (h, res, gamma):
                    assert t.data_ptr() % vb == 0
                for t in (h, res):
                    assert t.stride(0) * el % vb == 0
                _check_plan(plan, dtype, 8, n, False, _alignment(h, res))
    # linear3's halves of the all-reduced [M, 2n] float32 sum take 16-byte vectors
    s = torch.zeros(130, 1024)
    assert _alignment(s[:, :512], s[:, 512:]) == 16
    assert shard_ln_plan(torch.float32, 130, 512, 16, True)[:5] == (4, 32, 4, 1, 1)


def test_plan_aligns_float32_rows_with_bf16_outputs():
    """float32 h and residual with bf16 parameters and outputs: a vector
    counts in elements of each, so a ragged shard of 25 (50-byte bf16 rows)
    takes single values and the flagship's shard 16-byte float32 vectors."""
    for n, vec in ((25, 1), (50, 2), (384, 4)):
        h, res = torch.zeros(130, n), torch.zeros(130, 2 * n)[:, n:]
        gamma, out = torch.zeros(n, dtype=torch.bfloat16), torch.zeros(130, n, dtype=torch.bfloat16)
        align = _shard_ln_align(h, res, gamma, gamma, None, out, None)
        assert shard_ln_plan(torch.float32, 130, n, align).vec == vec


def test_plan_widths():
    """The flagship's shards in bf16 take 8-byte vectors in every lane (n =
    384: 32 lanes of 3; n = 192: 16 lanes of 3); linear3's whole float32
    rows 16-byte vectors, one warp a row; a whole row of 1,536 three warps
    of a block, a shard of 1,536 three tiles; the grid from the card's
    occupancy, else the SM's 2,048 threads."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert shard_ln_plan(bf16, 16640, 384)[:6] == (4, 32, 3, 1, 1, 256)
    assert shard_ln_plan(bf16, 16640, 192)[:6] == (4, 16, 3, 1, 1, 256)
    assert shard_ln_plan(bf16, 130, 25)[:4] == (1, 8, 4, 1)
    assert shard_ln_plan(f32, 16640, 512, whole=True)[:6] == (4, 32, 4, 1, 1, 256)
    assert shard_ln_plan(f32, 16640, 1536, whole=True)[:6] == (4, 32, 4, 1, 3, 192)
    assert shard_ln_plan(f32, 16640, 1536)[:6] == (4, 32, 4, 3, 1, 256)
    m = 132 * 8 * 4
    assert shard_ln_plan(bf16, m, 384, occupancy=lambda v, c, t: 2)[6:] == (2 * 132, 16)
    assert shard_ln_plan(bf16, m, 384)[6:] == (8 * 132, 4)
    assert shard_ln_plan(f32, m, 1536, occupancy=lambda v, c, t: 3)[6:] == (132, 32)
    with pytest.raises(ValueError):
        shard_ln_plan(bf16, 130, 384, occupancy=lambda v, c, t: 0)


def _across(acc, plan):
    """[m, groups, lanes] per-lane sums: the butterfly across the lanes
    (lane 0's), then the warps in order."""
    idx = torch.arange(plan.lanes)
    o = 1
    while o < plan.lanes:
        acc = acc + acc[..., idx ^ o]
        o <<= 1
    total = acc[:, 0, 0]
    for w in range(1, acc.shape[1]):
        total = total + acc[:, w, 0]
    return total


def _lane_sums(values):
    """[m, groups, lanes, slots] -> each lane's slots summed in order."""
    acc = torch.zeros(values.shape[:3])
    for j in range(values.shape[3]):
        acc = acc + values[..., j]
    return acc


def mirror_whole_row(s, bias, gamma, beta, residual, plan, eps=EPS):
    """Entry 2 on whole float32 rows s [m, n] in the kernel's order: (out,
    h = s + bias, (mean, rstd) [m, 2]) in float32."""
    m, n = s.shape
    v = s + bias
    cols, valid = _lane_columns(plan, n)
    vals = torch.where(valid, v[:, cols.clamp(max=n - 1)], torch.zeros(()))
    mean1 = _across(_lane_sums(vals), plan) / n
    d = torch.where(valid, vals - mean1[:, None, None, None], torch.zeros(()))
    dsum, q2 = _across(_lane_sums(d), plan), _across(_lane_sums(d * d), plan)
    mean, m2 = mean1 + dsum / n, q2 - dsum * dsum / n
    rstd = torch.rsqrt(m2 * (1.0 / n) + eps)
    out = F.gelu((v - mean[:, None]) * rstd[:, None] * gamma + beta) + residual
    return out, v, torch.stack([mean, rstd], -1)


@functools.lru_cache(maxsize=None)
def _jax_case(m, n):
    """Numpy inputs [m, 64] x [64, n] and the JAX package's (out, h) of them
    (out with its adaptive-pool residual)."""
    rng = np.random.default_rng(m + n)
    k = 64
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)
    b, beta = ((rng.standard_normal(n) * 0.1).astype(np.float32) for _ in range(2))
    gamma = (1.0 + rng.standard_normal(n) * 0.1).astype(np.float32)
    arrays = (x, w, b, gamma, beta)
    out, h = jax_fused_forward(*(jnp.asarray(a) for a in arrays), EPS, True)
    return arrays, np.asarray(out), np.asarray(h)


def _close(name, got, want):
    want = np.asarray(want, dtype=np.float64)
    err = float(np.abs(got.double().numpy() - want).max())
    assert err <= 1e-5 * float(np.abs(want).max()), (name, err)


@pytest.mark.parametrize("m,n", [(130, 100), (130, 512), (130, 1536), (16, WALK_WIDTH)])
def test_whole_row_order_equals_jax(m, n):
    """The whole-row form's sums in the kernel's order (a warp a row, lanes
    of a narrower team at n = 100, three warps at 1,536, the walk beyond a
    block's reach), on the row split's float32 sum x @ W with the pool
    residual: out and h against the Pallas kernel, and the plain version's
    statistics against the mirror's."""
    (x, w, b, gamma, beta), out_j, h_j = _jax_case(m, n)
    x, w, b, gamma, beta = (torch.from_numpy(a) for a in (x, w, b, gamma, beta))
    s = x @ w
    pool = adaptive_avg_pool1d(x, n)
    plan = shard_ln_plan(torch.float32, m, n, 16, True, sm_count=1)
    out, h, mstats = mirror_whole_row(s, b, gamma, beta, pool, plan)
    _close("out", out, out_j)
    _close("h", h, h_j)
    out_p, mstats_p, h_p = sharded_ln_gelu_plain(s, None, gamma, beta, n, bias=b, residual=pool)
    assert torch.equal(h_p, h)
    _close("out vs plain", out, out_p)
    _close("mean", mstats[:, 0], mstats_p[:, 0])
    _close("rstd", mstats[:, 1], mstats_p[:, 1])


@pytest.mark.parametrize("size", [1, 2, 4])
def test_shard_statistics_merge_in_rank_order(size):
    """A column shard's plain version merges the ranks' (mean, M2) in rank
    order bit for bit as ``merge_stats`` does, whichever rank's columns it
    holds, and its rstd is rsqrt(M2 / n_full + eps) of them."""
    rng = np.random.default_rng(size)
    m, n = 130, 48
    stats = torch.from_numpy(np.stack([rng.standard_normal((size, m)) * 0.3,
                                       rng.uniform(5.0, 60.0, (size, m))], -1)
                             .astype(np.float32))
    mean, m2 = merge_stats(stats, n)
    gamma = torch.from_numpy((1.0 + rng.standard_normal(n) * 0.1).astype(np.float32))
    beta = torch.from_numpy((rng.standard_normal(n) * 0.1).astype(np.float32))
    for r in range(size):
        h = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32))
        _, mstats, saved = sharded_ln_gelu_plain(h, stats, gamma, beta, size * n)
        assert saved is None
        assert torch.equal(mstats[:, 0], mean)
        assert torch.equal(mstats[:, 1], torch.rsqrt(m2 * (1.0 / (size * n)) + EPS))
