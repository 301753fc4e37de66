"""Kernel 2's wide backward chain (N > 1,024) on the CPU: its launch plan
(``wide_chain_plan``) and its arithmetic order, mirrored in plain torch from
``csrc/fused_spectre_linear_bwd.cu`` and held to the JAX package.

The mirror takes the kernel's reductions in the kernel's order: each
thread's (count, mean, M2) over its chunks (a chunk's by two passes, the
chunks combined in order by Chan's formula), the butterflies of Chan's
formula across lanes and then across warps (the lower lane's operand
first), the two means of the LayerNorm backward by the same butterflies of
sums, and the column sums of each block's rows in order, then of the blocks
in the column-sum pass's fixed order. It is checked against ``jax.vjp`` of
the Pallas kernel in interpret mode: with x one-hot rows, dW's rows are dh,
so dh, dgamma, dbeta and db within 1e-5 of their largest entry in float32,
and the row statistics within 1e-6 relative of ``jnp.mean`` of the kernel's
own h, as tests/test_torch_port_linear_wide.py holds the forward's split-row
statistics. tests/test_torch_port_cuda.py holds the kernel to the plain
version on the card.
"""

import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectre_tpu.ops.pallas import fused_spectre_linear as jax_fused_spectre_linear
from spectre_tpu.ops.pallas.fused_linear import _forward as jax_forward
from spectre_tpu_torch.ops.kernels import backward_kernel
from spectre_tpu_torch.ops.kernels.fused_linear import (
    ROW_N,
    WIDE_BLOCKS_PER_SM,
    WIDE_MAX_THREADS,
    WIDE_REACH,
    WIDE_VALUES,
    _chain_plain,
    wide_chain_plan,
)

SRC = pathlib.Path(__file__).parents[1] / "spectre_tpu_torch" / "csrc" / "fused_spectre_linear_bwd.cu"
SEGMENTS = 8  # the column-sum pass's strided segments (kSegments)


def _chan(a, b):
    """Chan's formula as the kernel writes it: a's values, then b's (the
    kernel's fast division is within 2 ulp of this one)."""
    na, ma, qa = a
    nb, mb, qb = b
    tot = na + nb
    d = mb - ma
    f = torch.where(tot > 0, nb / torch.where(tot > 0, tot, torch.ones_like(tot)),
                    torch.zeros_like(tot))
    return tot, ma + d * f, qa + qb + d * d * na * f


def _lane_chan(s, width):
    """The butterfly of Chan's formula over the last axis (32 lanes), the
    lower lane's operand first at each level: every lane ends with the same
    bits."""
    lane = torch.arange(s[0].shape[-1])
    for o in (1 << k for k in range(int(math.log2(width)))):
        t = tuple(x[..., lane ^ o] for x in s)
        upper = (lane & o) != 0
        lo = tuple(torch.where(upper, y, x) for x, y in zip(s, t))
        hi = tuple(torch.where(upper, x, y) for x, y in zip(s, t))
        s = _chan(lo, hi)
    return s


def _lane_sum(v, levels):
    """A butterfly of sums over the last axis, at the given xor distances."""
    lane = torch.arange(v.shape[-1])
    for o in levels:
        v = v + v[..., lane ^ o]
    return v


def _pow2(x):
    return 1 << max(0, x - 1).bit_length()


def mirror_chain(h, g, gamma, beta, plan, eps=1e-5):
    """The wide chain in float32 in the kernel's order: (dh, dgamma, dbeta,
    db, mean, var) for h, g [m, n] under ``plan`` (vec values a vector,
    chunks vectors a thread, 0: the walk, which takes every chunk of the row
    in the same order; threads; blocks of ``rows`` contiguous rows)."""
    m, n = h.shape
    v, threads = plan.vec, plan.threads
    chunks = plan.chunks or -(-n // (threads * v))
    warps = threads // 32
    # column of (thread, chunk, e): (c * threads + t) * v + e
    col = ((torch.arange(chunks)[None, :] * threads + torch.arange(threads)[:, None]) * v)[..., None] \
        + torch.arange(v)
    valid = col < n  # whole chunks: n % v == 0
    hv = torch.where(valid, h[:, col.clamp(max=n - 1)], torch.zeros(()))  # [m, T, C, v]
    gv = torch.where(valid, g[:, col.clamp(max=n - 1)], torch.zeros(()))
    gam = torch.where(valid, gamma[col.clamp(max=n - 1)], torch.zeros(()))
    bet = torch.where(valid, beta[col.clamp(max=n - 1)], torch.zeros(()))
    in_chunk = valid[..., 0]  # [T, C]

    # each thread's statistics: chunks in order, a chunk's by two passes
    zero = torch.zeros(m, threads)
    st = (zero, zero, zero)
    for c in range(chunks):
        x = hv[:, :, c, :]
        s = torch.zeros(m, threads)
        for e in range(v):
            s = s + x[..., e]
        mean = s * (1.0 / v)
        q = torch.zeros(m, threads)
        for e in range(v):
            q = q + (x[..., e] - mean) * (x[..., e] - mean)
        inc = in_chunk[:, c]
        new = _chan(st, (torch.full_like(mean, float(v)), mean, q))
        st = tuple(torch.where(inc, a, b) for a, b in zip(new, st))
    # lanes, then warps (every group of wpow2 lanes holds all the warps')
    st = _lane_chan(tuple(x.reshape(m, warps, 32) for x in st), 32)
    wpow2 = _pow2(warps)
    w_of_lane = torch.arange(32) & (wpow2 - 1)
    red = tuple(x[:, :, 0] for x in st)  # [m, warps]
    pad = tuple(torch.where(w_of_lane < warps, x[:, w_of_lane.clamp(max=warps - 1)],
                            torch.zeros(())) for x in red)
    tot, mean, m2 = (x[:, 0] for x in _lane_chan(pad, wpow2))
    var = m2 * (1.0 / n)
    rsig = torch.rsqrt(var + eps)

    # the elements, the A&S erf of gelu_grad
    mu_, rs_ = mean[:, None, None, None], rsig[:, None, None, None]
    u = (hv - mu_) * rs_
    z = u * gam + bet
    e2 = torch.exp2(z * z * -0.72134752044448170368)
    t = 1.0 / (0.3275911 * 0.70710678118654752440 * z.abs() + 1.0)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741 + t * (-1.453152027
                                                                         + t * 1.061405429))))
    erf_abs = 1.0 - poly * e2
    dgelu = z * 0.39894228040143267794 * e2 + (0.5 + torch.copysign(0.5 * erf_abs, z))
    dz = torch.where(valid, gv * dgelu, torch.zeros(()))
    du = dz * gam
    uu = torch.where(valid, u, torch.zeros(()))
    m1 = torch.zeros(m, threads)
    m2s = torch.zeros(m, threads)
    for c in range(chunks):
        for e in range(v):
            m1 = m1 + du[:, :, c, e]
            m2s = m2s + du[:, :, c, e] * uu[:, :, c, e]
    sums = []
    for x in (m1, m2s):
        x = _lane_sum(x.reshape(m, warps, 32), (16, 8, 4, 2, 1))[:, :, 0]
        x = torch.where(w_of_lane < warps, x[:, w_of_lane.clamp(max=warps - 1)], torch.zeros(()))
        sums.append(_lane_sum(x, [1 << k for k in range(int(math.log2(wpow2)))])[:, 0])
    m1, m2s = (x[:, None, None, None] * (1.0 / n) for x in sums)
    dhv = torch.where(valid, rs_ * (du - m1 - uu * m2s), torch.zeros(()))

    def to_rows(a):  # [m, T, C, v] -> [m, n]
        out = torch.zeros(m, n)
        out[:, col[valid]] = a[:, valid]
        return out

    dh = to_rows(dhv)
    # column sums: each block's rows in order, then the blocks in the pass's order
    cols = []
    for a in (to_rows(dz * uu), to_rows(dz), dh):
        part = torch.zeros(plan.blocks, n)
        for blk in range(plan.blocks):
            for r in range(blk * plan.rows, min(m, (blk + 1) * plan.rows)):
                part[blk] = part[blk] + a[r]
        seg = torch.zeros(SEGMENTS, n)
        for blk in range(plan.blocks):
            seg[blk % SEGMENTS] = seg[blk % SEGMENTS] + part[blk]
        total = seg[0].clone()
        for s in range(1, SEGMENTS):
            total = total + seg[s]
        cols.append(total)
    return dh, cols[0], cols[1], cols[2], mean, var


def _case(m, k, n, seed):
    """x one-hot rows (so that dW's first m rows are dh), W, b, gamma, beta
    and the cotangent, float32."""
    rng = np.random.default_rng(seed)
    x = np.eye(m, k, dtype=np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    b = (0.5 + 0.1 * rng.standard_normal(n)).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, n).astype(np.float32)
    beta = (0.1 * rng.standard_normal(n)).astype(np.float32)
    cot = rng.standard_normal((m, n)).astype(np.float32)
    return x, w, b, gamma, beta, cot


# 1,025: one value a vector (odd N); 1,100: 8-byte vectors (not a multiple of
# 8); 1,536 and 4,096 (the C6 shape, two chunks a thread); 9,000: beyond the
# registers' reach, walked
@pytest.mark.parametrize("n", [1025, 1100, 1536, 4096, 9000])
def test_mirror_of_the_wide_chain_matches_the_pallas_kernels_vjp(n):
    m, k = 6, 8
    arrays = _case(m, k, n, seed=n)
    jargs = [jnp.asarray(a) for a in arrays]
    _, vjp = jax.vjp(lambda *a: jax_fused_spectre_linear(*a, interpret=True), *jargs[:5])
    _, dw, db, dgamma, dbeta = (torch.from_numpy(np.array(a)) for a in vjp(jargs[5]))
    _, h = jax_forward(*jargs[:5], 1e-5, True)
    ht = torch.from_numpy(np.array(h))
    # two blocks of three rows: the column sums cross blocks
    plan = wide_chain_plan(torch.float32, m, n, sm_count=2, occupancy=lambda *a: 1)
    assert (plan.blocks, plan.rows) == (2, 3) and (plan.chunks == 0) == (n > WIDE_REACH)
    got = mirror_chain(ht, torch.from_numpy(arrays[5]), torch.from_numpy(arrays[3]),
                       torch.from_numpy(arrays[4]), plan)
    for name, a, want in (("dh", got[0], dw[:m]), ("dgamma", got[1], dgamma),
                          ("dbeta", got[2], dbeta), ("db", got[3], db)):
        scale = want.abs().max().item()
        assert (a - want).abs().max().item() <= 1e-5 * scale, name
    hj = jnp.asarray(h)
    want_mean = jnp.mean(hj, axis=-1)
    want_var = jnp.mean((hj - want_mean[:, None]) ** 2, axis=-1)
    want_mean, want_var = (torch.from_numpy(np.array(a)) for a in (want_mean, want_var))
    scale = want_mean.abs() + want_var.sqrt()
    assert ((got[4] - want_mean).abs() / scale).max().item() <= 1e-6
    assert ((got[5] - want_var).abs() / want_var).max().item() <= 1e-6


@pytest.mark.parametrize("n", [1025, 1536, 8192, 8200])
def test_mirror_matches_the_plain_chain(n):
    """The mirror and ``_chain_plain`` (the CPU path and the card's
    yardstick) within 1e-5 of the largest entry, at ragged blocks of rows."""
    rng = np.random.default_rng(n)
    h, g = (torch.from_numpy(rng.standard_normal((7, n)).astype(np.float32)) for _ in range(2))
    gamma = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32))
    beta = torch.from_numpy((0.1 * rng.standard_normal(n)).astype(np.float32))
    plan = wide_chain_plan(torch.float32, 7, n, sm_count=3, occupancy=lambda *a: 1)
    assert (plan.blocks, plan.rows) == (3, 3)  # rows 3, 3, 1
    got = mirror_chain(h, g, gamma, beta, plan)
    for a, want in zip(got[:4], _chain_plain(h, g, gamma, beta, 1e-5)):
        assert (a - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [1025, 1026, 1100, 1536, 2047, 2048, 3000, 4096, 4104, 6144,
                               8191, 8192, 8193, 16384, 100_000])
def test_wide_chain_plan_covers_the_row(dtype, n):
    """Every N > ROW_N has a plan: the widest vector (at most 16 bytes)
    that divides N, 16 values a thread, and the fewest whole warps that
    cover the row; up to N = 8,192 held in registers, above walked by 512
    threads."""
    el = 2 if dtype == torch.bfloat16 else 4
    p = wide_chain_plan(dtype, 4160, n)
    assert backward_kernel(n) == "fused_spectre_linear_bwd_wide"
    assert n % p.vec == 0 and p.vec * el <= 16
    assert all(n % v for v in (8, 4, 2) if v > p.vec and v * el <= 16)
    assert p.threads % 32 == 0 and 32 <= p.threads <= WIDE_MAX_THREADS
    if n > WIDE_REACH:
        assert p.chunks == 0 and p.threads == WIDE_MAX_THREADS
        return
    assert p.chunks * p.vec == WIDE_VALUES
    assert p.threads * WIDE_VALUES >= n > (p.threads - 32) * WIDE_VALUES


def test_wide_chain_plan_takes_the_alignment_and_the_grid():
    """Unaligned bases narrow the vector; the grid is the card's occupancy,
    at most WIDE_BLOCKS_PER_SM an SM (one for the walk), at most a block a
    row, and the rows split so that no block is empty."""
    assert wide_chain_plan(torch.bfloat16, 64, 1536, align=16).vec == 8
    assert wide_chain_plan(torch.bfloat16, 64, 1536, align=8).vec == 4
    assert wide_chain_plan(torch.bfloat16, 64, 1536, align=2).vec == 1
    assert wide_chain_plan(torch.float32, 64, 1536, align=4).vec == 1
    asked = []
    p = wide_chain_plan(torch.bfloat16, 4160, 1536, sm_count=132,
                        occupancy=lambda *a: asked.append(a) or 9)
    assert asked == [(8, 2, 96)]
    assert (p.blocks, p.rows) == (520, 8)  # 4 an SM: 528 blocks of 8 rows, 520 of them
    p = wide_chain_plan(torch.bfloat16, 4160, 1536, sm_count=132, occupancy=lambda *a: 1)
    assert (p.blocks, p.rows) == (130, 32)  # 132 blocks of 32 rows, 130 of them
    p = wide_chain_plan(torch.float32, 5, 4096, sm_count=132)
    assert (p.blocks, p.rows) == (5, 1)
    p = wide_chain_plan(torch.bfloat16, 1040, 16384, sm_count=132, occupancy=lambda *a: 2)
    assert (p.chunks, p.blocks, p.rows) == (0, 130, 8)  # the walk: one block an SM
    assert WIDE_BLOCKS_PER_SM >= 1
    with pytest.raises(ValueError, match="does not fit"):
        wide_chain_plan(torch.float32, 8, 4096, occupancy=lambda *a: 0)


def test_plan_constants_are_the_kernels():
    """The plan's reach, values a thread and threads are the kernel's own
    constants (csrc/fused_spectre_linear_bwd.cu), and N <= ROW_N stays on
    the warp chain."""
    src = SRC.read_text()
    assert f"constexpr int kWideMaxThreads = {WIDE_MAX_THREADS};" in src
    assert f"constexpr int kWideValues = {WIDE_VALUES};" in src
    assert "constexpr int kWideReach = kWideMaxThreads * kWideValues;" in src
    assert WIDE_REACH == WIDE_MAX_THREADS * WIDE_VALUES
    assert backward_kernel(ROW_N) == "fused_spectre_linear_bwd_chain"
