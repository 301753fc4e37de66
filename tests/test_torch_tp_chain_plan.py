"""Kernel B3's column-shard backward entries 3 and 4 (``chain_shard_sums``,
``chain_shard_dh``) on the CPU: their launch plan (``shard_chain_plan``)
and their summation order, mirrored in plain torch from
``csrc/fused_spectre_linear_bwd.cu`` and held to the JAX package.

The plan is walked in Python: every (row, column) of h is taken by exactly
one lane of one team of one block, whatever n (ragged widths, widths cut
into tiles) and M. The mirror takes the kernels' sums in their order: a
lane's row sums over its chunks in order, the butterfly across the team's
lanes, the tiles in order; a team's column partials over its rows in
order, the teams of a block in order, then the blocks in the column-sum
pass's fixed order (32 strided segments, then the segments in turn). It is
checked against ``jax.vjp`` of the Pallas kernel in interpret mode (dgamma,
dbeta, db of each rank's columns within 1e-5 of their largest entry in
float32) and against the plain versions (dh, the row sums).
tests/test_torch_port_cuda.py holds the kernels to the plain versions on
the card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectre_tpu.ops.pallas import fused_spectre_linear as jax_fused_spectre_linear
from spectre_tpu_torch.ops.kernels.fused_linear import (
    SHARD_CHUNKS,
    SHARD_THREADS,
    SHARD_VALUES,
    ShardChainPlan,
    _shard_chain,
    chain_shard_dh_plain,
    chain_shard_sums_plain,
    merge_stats,
    shard_chain_plan,
    shard_stats_plain,
)

SEGMENTS = 32  # the column-sum pass's strided segments (kShardSegments)
EPS = 1e-5
# the reach of the kernels these replace: one warp a row, its columns'
# partial rows in 227 KB of shared memory, so n up to 29,056 in phase A
# and 58,112 in phase B
OLD_REACH = 227 * 1024 // (4 * 2)
PLAN_WIDTHS = (1, 7, 24, 25, 48, 50, 96, 100, 192, 384, 1536, 4096, OLD_REACH, 2 * OLD_REACH)
PLAN_ROWS = (1, 130, 16640, 66560)


def _columns(plan, n):
    """Each lane's columns: [tiles, lanes, chunks, vec] and whether its chunk
    lies within the row."""
    tile = plan.lanes * plan.chunks * plan.vec
    y = torch.arange(plan.tiles)[:, None, None, None]
    lane = torch.arange(plan.lanes)[None, :, None, None]
    c = torch.arange(plan.chunks)[None, None, :, None]
    e = torch.arange(plan.vec)
    start = y * tile + (c * plan.lanes + lane) * plan.vec
    return start + e, (start < n).expand(-1, -1, -1, plan.vec)


def _team_rows(plan, m, block, team):
    teams = SHARD_THREADS // plan.lanes
    r0 = block * plan.rows
    return list(range(r0 + team, min(m, r0 + plan.rows), teams))


@pytest.mark.parametrize("n", PLAN_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_covers_every_row_and_column_once(dtype, n):
    el = dtype.itemsize
    for m in PLAN_ROWS:
        plan = shard_chain_plan(dtype, m, n)
        assert n % plan.vec == 0 and plan.vec * el <= 16
        assert 1 <= plan.chunks <= SHARD_CHUNKS and plan.chunks * plan.vec <= SHARD_VALUES
        assert plan.lanes in (1, 2, 4, 8, 16, 32) and SHARD_THREADS % plan.lanes == 0
        assert SHARD_THREADS <= 1024 and plan.tiles <= 65535
        # a block's shared memory within the 227 KB the card gives one: phase
        # B's ring of two rows of h and g a team, or the teams' column
        # partials (two sums a column in phase A), whichever is larger
        ring = 2 * SHARD_THREADS * 2 * plan.chunks * plan.vec * el
        assert max(ring, SHARD_THREADS * 2 * plan.chunks * plan.vec * 4) <= 227 * 1024
        assert 1 <= plan.blocks <= m and plan.blocks * plan.rows >= m
        assert (plan.blocks - 1) * plan.rows < m  # no block is empty
        cols, valid = _columns(plan, n)
        assert plan.tiles == 1 or plan.lanes == 32
        taken = cols[valid]
        assert bool((cols[~valid] >= n).all())  # a chunk lies wholly in or out
        assert torch.equal(torch.sort(taken).values, torch.arange(n))
        # block b's team t takes rows b * rows + t + k * teams of its share
        teams = SHARD_THREADS // plan.lanes
        b = np.arange(plan.blocks)[:, None, None]
        t = np.arange(teams)[None, :, None]
        k = np.arange(-(-plan.rows // teams))[None, None, :]
        rows = b * plan.rows + t + k * teams
        taken = rows[(t + k * teams < plan.rows) & (rows < m)]
        assert np.array_equal(np.sort(taken), np.arange(m))


def test_plan_widths_and_vectors():
    """The flagship's shards fill every lane with 8-byte bf16 vectors (n =
    384: 32 lanes of 3; n = 192: 16 lanes of 3); a ragged shard takes
    single values; a wide row takes 16-byte vectors in tiles of a warp."""
    bf16 = torch.bfloat16
    assert shard_chain_plan(bf16, 16640, 384)[:4] == (4, 32, 3, 1)
    assert shard_chain_plan(bf16, 16640, 192)[:4] == (4, 16, 3, 1)
    assert shard_chain_plan(bf16, 130, 25)[:4] == (1, 8, 4, 1)
    assert shard_chain_plan(bf16, 130, 50)[:4] == (2, 8, 4, 1)
    assert shard_chain_plan(bf16, 16640, 1536)[:4] == (8, 32, 2, 3)
    assert shard_chain_plan(torch.float32, 16640, 384)[:4] == (4, 32, 3, 1)
    # unaligned bases take narrower vectors
    assert shard_chain_plan(bf16, 130, 384, align=4)[0] == 2
    # the grid: SHARD_BLOCKS_PER_SM or the card's occupancy, whichever is less
    assert shard_chain_plan(bf16, 16640, 384, sm_count=132, occupancy=lambda v, c: 1).blocks \
        == 132
    with pytest.raises(ValueError):
        shard_chain_plan(bf16, 130, 384, occupancy=lambda v, c: 0)


def _order_sum(terms):
    """Sum of a list of tensors, left to right."""
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


def _column_sums(values, plan, m):
    """The kernels' column sums of values [m, n] float32: each team over its
    rows in order, a block's teams in order, then the blocks in the
    column-sum pass's order."""
    teams = SHARD_THREADS // plan.lanes
    zero = torch.zeros(values.shape[1])
    blocks = []
    for b in range(plan.blocks):
        per_team = [_order_sum([zero] + [values[r] for r in _team_rows(plan, m, b, t)])
                    for t in range(teams)]
        blocks.append(_order_sum(per_team))
    segs = [_order_sum([zero] + blocks[s::SEGMENTS]) for s in range(SEGMENTS)]
    return _order_sum(segs)


def _row_sums(values, plan, n):
    """The kernels' row sums of values [m, n] float32: a lane's chunks in
    order, the butterfly across the team's lanes (lane 0's), the tiles in
    order."""
    cols, valid = _columns(plan, n)
    v = torch.where(valid, values[:, cols.clamp(max=n - 1)], torch.zeros(()))
    lane_sum = torch.zeros(v.shape[:3])  # [m, tiles, lanes]
    for c in range(plan.chunks):
        for e in range(plan.vec):
            lane_sum = lane_sum + v[..., c, e]
    idx = torch.arange(plan.lanes)
    o = 1
    while o < plan.lanes:
        lane_sum = lane_sum + lane_sum[..., idx ^ o]
        o <<= 1
    return _order_sum(list(lane_sum[..., 0].unbind(1)))


def mirror_shard_sums(h, g, gamma, beta, mstats, plan):
    """Entry 3 in the kernel's order: ((sum du, sum du u) [M, 2], [dgamma,
    dbeta] [2, n]) in float32."""
    m, n = h.shape
    u, dz, du = _shard_chain(h, g, gamma, beta, mstats)
    rows = torch.stack([_row_sums(du, plan, n), _row_sums(du * u, plan, n)], -1)
    return rows, torch.stack([_column_sums(dz * u, plan, m), _column_sums(dz, plan, m)])


def mirror_shard_dh(h, g, gamma, beta, mstats, rowsums, n_full, plan):
    """Entry 4 in the kernel's order: (dh [M, n], db [n]) in float32."""
    m, _ = h.shape
    u, _, du = _shard_chain(h, g, gamma, beta, mstats)
    s = _order_sum(list(rowsums.unbind(0)))
    inv = torch.tensor(1.0 / n_full, dtype=torch.float32)
    dh = mstats[:, 1:] * (du - s[:, :1] * inv - u * (s[:, 1:] * inv))
    return dh, _column_sums(dh, plan, m)


M = 130


@functools.lru_cache(maxsize=None)
def _case(n_full):
    """Numpy inputs of width n_full and JAX's (db, dgamma, dbeta) of them."""
    rng = np.random.default_rng(n_full + 17)
    k = 64
    x = rng.standard_normal((M, k)).astype(np.float32)
    w = (rng.standard_normal((k, n_full)) * k ** -0.5).astype(np.float32)
    b, beta = ((rng.standard_normal(n_full) * 0.1).astype(np.float32) for _ in range(2))
    gamma = (1.0 + rng.standard_normal(n_full) * 0.1).astype(np.float32)
    g = rng.standard_normal((M, n_full)).astype(np.float32)
    arrays = (x, w, b, gamma, beta, g)
    j = [jnp.asarray(a) for a in arrays]
    _, vjp = jax.vjp(lambda *a: jax_fused_spectre_linear(*a, EPS, True), *j[:5])
    return arrays, [np.asarray(t) for t in vjp(j[5])[2:]]


def _close(name, got, want):
    want = np.asarray(want, dtype=np.float64)
    err = float(np.abs(got.double().numpy() - want).max())
    assert err <= 1e-5 * float(np.abs(want).max()), (name, err)


def _plans(n):
    """The shipped plan on one SM (several rows a team at M = 130) and, to
    walk several tiles, 4 lanes of 4 single values a tile."""
    return [shard_chain_plan(torch.float32, M, n, sm_count=1),
            ShardChainPlan(1, 4, 4, -(-n // 16), 3, -(-M // 3))]


@pytest.mark.parametrize("n_full,size", [(96, 2), (96, 4), (100, 2), (100, 4)])
def test_summation_order_equals_jax_vjp(n_full, size):
    """The mirrored order of entries 3 and 4 on each rank's columns: dgamma,
    dbeta and db against JAX's VJP; the row sums and dh against the plain
    versions."""
    arrays, (db_j, dgamma_j, dbeta_j) = _case(n_full)
    x, w, b, gamma, beta, g = (torch.from_numpy(a) for a in arrays)
    n = n_full // size
    cols = [slice(r * n, (r + 1) * n) for r in range(size)]
    firsts = [shard_stats_plain(x, w[:, c].contiguous(), b[c].contiguous()) for c in cols]
    mean, m2 = merge_stats(torch.stack([s for _, s in firsts]), n)
    mstats = torch.stack([mean, torch.rsqrt(m2 / n_full + EPS)], -1)
    for plan in _plans(n):
        sums = [mirror_shard_sums(firsts[r][0], g[:, c].contiguous(), gamma[c], beta[c], mstats,
                                  plan) for r, c in enumerate(cols)]
        for r, c in enumerate(cols):
            rows_p, _ = chain_shard_sums_plain(firsts[r][0], g[:, c].contiguous(), gamma[c],
                                               beta[c], mstats)
            _close("rowsums", sums[r][0], rows_p)
        rowsums = torch.stack([s[0] for s in sums])
        got = [mirror_shard_dh(firsts[r][0], g[:, c].contiguous(), gamma[c], beta[c], mstats,
                               rowsums, n_full, plan) for r, c in enumerate(cols)]
        for r, c in enumerate(cols):
            dh_p, _ = chain_shard_dh_plain(firsts[r][0], g[:, c].contiguous(), gamma[c],
                                           beta[c], mstats, rowsums, n_full)
            _close("dh", got[r][0], dh_p)
        _close("dgamma", torch.cat([s[1][0] for s in sums]), dgamma_j)
        _close("dbeta", torch.cat([s[1][1] for s in sums]), dbeta_j)
        _close("db", torch.cat([d for _, d in got]), db_j)
