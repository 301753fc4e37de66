"""Kernel B3's entry 1 under tensor parallelism
(``fused_spectre_linear_shard_stats``) on the CPU: the launch plan of its
bf16 kernel (``shard_stats_plan``), the route that picks the kernel
(``shard_stats_kernel``), and the kernel's summation order of the row
statistics, mirrored in plain torch from ``csrc/fused_spectre_linear.cu`` and
held to the JAX package.

The plan is walked in Python as the kernel walks it: every (row, column) of
h below M and n is computed by exactly one consumer warpgroup of one block,
no wgmma product runs past n, every product's width is a multiple of 8 up to
256 (only a tile of n's last columns is not a multiple of 64), the shared memory fits a block, and at n = 384 W's L2-to-shared bytes
are at most 3 KB a row of output (half the first version's 6 KB). The mirror
takes a column tile's statistics in the kernel's order (shifted by the row's
first value of the tile; a thread's chunks in column order, then across the
quad) and merges the column tiles by Chan's formula; it is held against
``shard_stats_plain`` and, merged over the ranks by ``sharded_ln_gelu_plain``,
against the JAX package's ``fused_spectre_linear`` (the Pallas kernel in
interpret mode) within 1e-5 of the largest entry in float32.
tests/test_torch_port_cuda.py holds the kernel to the plain version on the
card.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectre_tpu.ops.pallas.fused_linear import _forward as jax_fused_forward
from spectre_tpu_torch.ops import adaptive_avg_pool1d
from spectre_tpu_torch.ops.kernels.fused_linear import (
    SHARD_STATS_ROWS,
    SHARD_STATS_TILE,
    SMEM_BLOCK,
    WGMMA_MAX_N,
    merge_stats,
    shard_stats_kernel,
    shard_stats_plain,
    shard_stats_plan,
    shard_stats_tiles,
    sharded_ln_gelu_plain,
)

EPS = 1e-5
PLAN_WIDTHS = (8, 64, 136, 192, 256, 384, 512, 768)
PLAN_DEPTHS = (8, 72, 512, 768)
PLAN_ROWS = (1, 63, 129, 16575)


def shard_stats_walk(plan, n):
    """The kernel's walk (csrc: shard_stats_wgmma_kernel): (block, warpgroup,
    first row, the column tile's first column, its width) in the order each
    block's consumers take them; a warpgroup computes 64 rows from its
    first (those below M) and the tile's columns with one wgmma product as
    wide as the tile (csrc: shard_stats_tile<W>)."""
    for block in range(plan.grid):
        for t in range(block, plan.row_tiles, plan.grid):
            for g in (0, 1):
                for n0, w in shard_stats_tiles(n, plan.tile_n):
                    yield block, g, t * SHARD_STATS_ROWS + 64 * g, n0, w


def _check_plan(m, k, n, sm_count):
    p = shard_stats_plan(m, k, n, sm_count)
    # what the C entry point checks before it launches
    assert 64 <= p.tile_n <= SHARD_STATS_TILE and p.tile_n % 64 == 0
    tiles = shard_stats_tiles(n, p.tile_n)
    assert (p.tiles_n, p.last_n) == (len(tiles), tiles[-1][1])
    assert p.row_tiles == -(-m // SHARD_STATS_ROWS) and 1 <= p.grid <= min(p.row_tiles, sm_count)
    assert p.smem <= SMEM_BLOCK
    owner = np.zeros((p.row_tiles * SHARD_STATS_ROWS, n), np.int32)
    for block, g, row, n0, w in shard_stats_walk(p, n):
        assert 0 <= block < p.grid and g in (0, 1) and row % 64 == 0
        # no product past n; wgmma widths; a tile starts on a 64-column box;
        # only a tile of n's last columns is not a multiple of 64 wide
        assert n0 + w <= n and w % 8 == 0 and 8 <= w <= min(256, SHARD_STATS_TILE)
        assert n0 % 64 == 0 and (w % 64 == 0 or (w < 64 and n0 + w == n))
        owner[row:row + 64, n0:n0 + w] += 1
    assert (owner[:m] == 1).all()
    return p


@pytest.mark.parametrize("n", PLAN_WIDTHS)
def test_plan_covers_every_row_and_column_once(n):
    """Every (row, column) of h is one consumer warpgroup's of one block, at
    every depth and ragged row count, with the grid of the H100 and with
    fewer SMs than row tiles (each block then walks several)."""
    for k in PLAN_DEPTHS:
        for m in PLAN_ROWS:
            for sm_count in (132, 3):
                _check_plan(m, k, n, sm_count)


def test_plan_cuts_w_reads_a_row_by_half():
    """At n = 384 (linear1's 768 columns over 2 ranks) and K = 512, W's
    L2-to-shared bytes a row of output are at most half the first version's
    (every 64-row tile read all of W: 384 x 512 x 2 / 64 = 6 KB), in two
    column tiles of 192; x's are read once a column tile."""
    p = shard_stats_plan(16640, 512, 384)
    assert (p.tile_n, p.tiles_n, p.last_n, p.row_tiles, p.grid) == (192, 2, 192, 130, 130)
    assert p.w_bytes_row <= 384 * 512 * 2 / 64 / 2 == 3072
    assert p.x_bytes_row == 2 * 512 * 2
    assert p.l2_bytes == (p.w_bytes_row + p.x_bytes_row) * SHARD_STATS_ROWS
    # the tiles of the other flagship shards, and the products that cut them
    assert (shard_stats_plan(16640, 512, 192).tiles_n, shard_stats_plan(16640, 512, 768).tiles_n,
            shard_stats_plan(66560, 512, 384).grid) == (1, 4, 132)
    assert shard_stats_tiles(384, 192) == [(0, 192), (192, 192)]
    assert shard_stats_tiles(392, 192) == [(0, 192), (192, 192), (384, 8)]
    assert shard_stats_tiles(136, 128) == [(0, 128), (128, 8)]
    assert shard_stats_tiles(56, 64) == [(0, 56)]


def test_route_takes_what_the_first_version_took():
    """``shard_stats_kernel`` sends to the new kernel exactly the shards the
    first version's wgmma route took (bf16, K and n multiples of 8, x and W
    16-byte aligned, n <= 768), each of which has a plan; everything else
    stays on the cluster kernel's statistics mode."""
    for dtype in (torch.bfloat16, torch.float32):
        for k in (8, 12, 64, 72, 512, 4100):
            for n in (8, 25, 50, 100, 136, 192, 384, 760, 768, 776, 1536):
                for aligned in (True, False):
                    route = shard_stats_kernel(dtype, k, n, aligned)
                    first = (dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0 and aligned
                             and n <= WGMMA_MAX_N)
                    assert route == ("fused_spectre_linear_shard_stats_wgmma" if first
                                     else "fused_spectre_linear_cluster")
                    if first:
                        shard_stats_plan(129, k, n)
                    elif aligned and dtype == torch.bfloat16:  # a shape the kernel does not take
                        with pytest.raises(ValueError):
                            shard_stats_plan(129, k, n)


def _quad(t):
    """The quad's shuffles: lanes (0, 1), (2, 3), then the pairs: [m, 4] -> [m]."""
    return (t[:, 0] + t[:, 1]) + (t[:, 2] + t[:, 3])


def mirror_stats(v, tile_n):
    """Each row's (mean, M2) [m, 2] over the float32 values v [m, n] in the
    kernel's order: per column tile (``shard_stats_tiles``), shifted by
    the row's value at the tile's first column; a thread's chunks of 8 in
    column order, each adding (d0 + d1) and (d0^2 + d1^2) of its two columns
    8c + 2q, 8c + 2q + 1 (q: the lane in the quad); the quad's shuffles; then
    Chan's merge over the column tiles in order."""
    m, n = v.shape
    na = mean = m2 = None
    for n0, w in shard_stats_tiles(n, tile_n):
        tile = v[:, n0:n0 + w]
        k = tile[:, :1]
        d = (tile - k).reshape(m, w // 8, 4, 2)
        s1 = torch.zeros(m, 4)
        s2 = torch.zeros(m, 4)
        for c in range(w // 8):
            s1 = s1 + (d[:, c, :, 0] + d[:, c, :, 1])
            s2 = s2 + (d[:, c, :, 0] * d[:, c, :, 0] + d[:, c, :, 1] * d[:, c, :, 1])
        s1, s2 = _quad(s1), _quad(s2)
        tm, tq = k[:, 0] + s1 / w, s2 - s1 * s1 / w
        if na is None:
            na, mean, m2 = float(w), tm, tq
        else:
            tot = na + w
            delta = tm - mean
            mean = mean + delta * (w / tot)
            m2 = m2 + tq + delta * delta * (na * w / tot)
            na = tot
    return torch.stack([mean, m2], -1)


@functools.lru_cache(maxsize=None)
def _jax_case(m, k, n_full):
    """Numpy inputs [m, k] x [k, n_full] and the JAX package's (out, h) of
    them (out with its adaptive-pool residual)."""
    rng = np.random.default_rng(m + k + n_full)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n_full)) * k ** -0.5).astype(np.float32)
    b, beta = ((rng.standard_normal(n_full) * 0.1).astype(np.float32) for _ in range(2))
    gamma = (1.0 + rng.standard_normal(n_full) * 0.1).astype(np.float32)
    arrays = (x, w, b, gamma, beta)
    out, h = jax_fused_forward(*(jnp.asarray(a) for a in arrays), EPS, True)
    return arrays, np.asarray(out), np.asarray(h)


def _close(name, got, want):
    want = np.asarray(want, dtype=np.float64)
    err = float(np.abs(got.double().numpy() - want).max())
    assert err <= 1e-5 * float(np.abs(want).max()), (name, err)


@pytest.mark.parametrize("m,k,n_full,size", [(130, 72, 768, 2), (130, 72, 768, 4),
                                             (130, 64, 400, 2), (130, 64, 80, 2)])
def test_statistics_order_equals_plain_and_jax(m, k, n_full, size):
    """Each rank's shard (384, 192, 200 and 40 columns: two and one column
    tiles of 192, 192 + 8 where n ends off a box, and a lone tile of 40
    narrower than a box) in float32: the
    mirror's (mean, M2) against ``shard_stats_plain``; the ranks' statistics
    merged by ``sharded_ln_gelu_plain`` with the pool's columns, and h,
    against the Pallas kernel's out and h."""
    (x, w, b, gamma, beta), out_j, h_j = _jax_case(m, k, n_full)
    x, w, b, gamma, beta = (torch.from_numpy(a) for a in (x, w, b, gamma, beta))
    n = n_full // size
    pool = adaptive_avg_pool1d(x, n_full)
    cols = [slice(r * n, (r + 1) * n) for r in range(size)]
    tile_n = shard_stats_plan(m, k, n).tile_n
    hs, stats = [], []
    for c in cols:
        h, plain = shard_stats_plain(x, w[:, c].contiguous(), b[c].contiguous())
        v = torch.matmul(x, w[:, c]) + b[c]
        mirror = mirror_stats(v, tile_n)
        _close("mean vs plain", mirror[:, 0], plain[:, 0].numpy())
        _close("M2 vs plain", mirror[:, 1], plain[:, 1].numpy())
        hs.append(h)
        stats.append(mirror)
    stats = torch.stack(stats)
    out = torch.cat([sharded_ln_gelu_plain(hs[r], stats, gamma[c], beta[c], n_full,
                                           residual=pool[:, c])[0]
                     for r, c in enumerate(cols)], 1)
    _close("out", out, out_j)
    _close("h", torch.cat(hs, 1), h_j)
    mean, m2 = merge_stats(stats, n)
    v = torch.from_numpy(h_j.astype(np.float64))
    _close("merged mean", mean, v.mean(1).numpy())
    _close("merged M2", m2, ((v - v.mean(1, keepdim=True)) ** 2).sum(1).numpy())
