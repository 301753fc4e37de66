"""Kernel B3's four column-shard entries (``ops/kernels/fused_linear.py``)
through their plain versions on the CPU, against the JAX package's
``fused_spectre_linear`` (the Pallas kernel in interpret mode) and
``jax.vjp`` of it, on the same numpy inputs made from a seed.

The ranks of a layer split by columns over ``size`` = 1, 2, 4 are simulated
in one process by slicing W, b, gamma and beta into column blocks: entry 1
(``shard_stats_plain``) on each block, the blocks' statistics stacked as the
all-gather stacks them, entry 2 (``sharded_ln_gelu_plain``) on each block
with its columns of the pool residual; backward entry 3
(``chain_shard_sums_plain``), the row sums stacked, entry 4
(``chain_shard_dh_plain``), then the two products of each block. The blocks
put side by side (dx: the blocks' partials summed, plus the pool's VJP) are
held to JAX's out, h, the row statistics, dh, dx, dW, db, dgamma and dbeta:
within 1e-5 of each one's largest entry in float32; in bf16 within 2^-6 of
the largest entry of the Pallas VJP's (the port's rule for bf16 against
the Pallas kernel, tests/test_torch_port_linear_bwd.py). dh is read from
JAX's dW where x's rows are one-hot (dW = x^T dh). N = 100 at 4 ranks gives
blocks of 25 columns, which on the card take the cluster kernel.
``column_spectre_linear`` (the autograd Function of ``parallel/tp.py``)
runs the same arithmetic on ranks in threads (``LocalRanks``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectre_tpu.ops.pallas import fused_spectre_linear as jax_fused_spectre_linear
from spectre_tpu_torch.ops import adaptive_avg_pool1d
from spectre_tpu_torch.ops.kernels import (
    chain_shard_dh_plain,
    chain_shard_sums_plain,
    linear_products,
    shard_stats_plain,
    sharded_ln_gelu_plain,
)
from spectre_tpu_torch.parallel.tp import LocalRanks, column_spectre_linear

M, K = 130, 64
EPS = 1e-5
LIMIT = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
CASES = [(size, n, dt) for size in (1, 2, 4) for n in (96, 100)
         for dt in (torch.float32, torch.bfloat16) if n % size == 0]


def _inputs(n, seed, onehot=False):
    rng = np.random.default_rng(seed)
    if onehot:  # row i is e_(i mod 64): each chunk of 64 rows has distinct one-hot rows
        x = np.eye(K, dtype=np.float32)[np.arange(M) % K]
    else:
        x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, n)) * K ** -0.5).astype(np.float32)
    b = (rng.standard_normal(n) * 0.1).astype(np.float32)
    gamma = (1.0 + rng.standard_normal(n) * 0.1).astype(np.float32)
    beta = (rng.standard_normal(n) * 0.1).astype(np.float32)
    g = rng.standard_normal((M, n)).astype(np.float32)
    return x, w, b, gamma, beta, g


def jax_forward(*a):
    from spectre_tpu.ops.pallas.fused_linear import _forward

    return _forward(*a, EPS, True)


@functools.lru_cache(maxsize=None)
def _jax(n, dt, onehot=False):
    """JAX on the inputs of width ``n`` (one set a width, whatever the
    ranks): (out, h, dx, dw, db, dgamma, dbeta) as float32 arrays; with
    ``onehot``, dh read from dW chunk by chunk instead."""
    arrays = _inputs(n, seed=n + onehot, onehot=onehot)
    j = [jnp.asarray(a, dtype=JDT[dt]) for a in arrays]
    f32 = lambda t: np.asarray(t.astype(jnp.float32))  # noqa: E731
    if onehot:
        dh = np.zeros((M, n), np.float32)
        for r0 in (0, K, M - K):  # chunks of 64 rows (one shape) that cover the rows
            rows = slice(r0, r0 + K)
            _, vjp = jax.vjp(lambda *a: jax_fused_spectre_linear(*a, EPS, True), j[0][rows],
                             *j[1:5])
            dh[rows] = f32(vjp(j[5][rows])[1])[np.arange(r0, r0 + K) % K]
        return arrays, dh
    out, h = jax_forward(*j[:5])
    _, vjp = jax.vjp(lambda *a: jax_fused_spectre_linear(*a, EPS, True), *j[:5])
    return arrays, [f32(t) for t in (out, h, *vjp(j[5]))]


def _shards(arrays, size, dt):
    """The port's entries on ``size`` column blocks: out, h, merged (mean,
    rstd), and the backward's dh, dx, dw, db, dgamma, dbeta, all put side by
    side (dx summed)."""
    x, w, b, gamma, beta, g = (torch.from_numpy(a).to(dt) for a in arrays)
    n = w.shape[1] // size
    blocks = [slice(r * n, (r + 1) * n) for r in range(size)]
    pool = adaptive_avg_pool1d(x, w.shape[1])
    firsts = [shard_stats_plain(x, w[:, c].contiguous(), b[c].contiguous()) for c in blocks]
    stats = torch.stack([s for _, s in firsts])
    fwd = [sharded_ln_gelu_plain(h, stats, gamma[c], beta[c], size * n, residual=pool[:, c],
                                 eps=EPS) for (h, _), c in zip(firsts, blocks)]
    sums = [chain_shard_sums_plain(h, g[:, c].contiguous(), gamma[c], beta[c], ms)
            for (h, _), (_, ms, _), c in zip(firsts, fwd, blocks)]
    rows = torch.stack([r for r, _ in sums])
    bwd = [chain_shard_dh_plain(h, g[:, c].contiguous(), gamma[c], beta[c], ms, rows, size * n)
           for (h, _), (_, ms, _), c in zip(firsts, fwd, blocks)]
    prods = [linear_products(x, w[:, c].contiguous(), dh) for (dh, _), c in zip(bwd, blocks)]
    xg = x.detach().clone().requires_grad_()
    dpool, = torch.autograd.grad(adaptive_avg_pool1d(xg, w.shape[1]), xg, g)
    dx = sum(p[0].float() for p in prods) + dpool.float()
    for (_, ms, _) in fwd[1:]:  # the merge is in rank order: every rank the same bits
        assert torch.equal(ms, fwd[0][1])
    return {"out": torch.cat([o for o, _, _ in fwd], 1), "h": torch.cat([h for h, _ in firsts], 1),
            "mstats": fwd[0][1], "stats": stats,
            "dh": torch.cat([dh for dh, _ in bwd], 1), "dx": dx,
            "dw": torch.cat([p[1] for p in prods], 1), "db": torch.cat([d for _, d in bwd]),
            "dgamma": torch.cat([s[0] for _, s in sums]),
            "dbeta": torch.cat([s[1] for _, s in sums])}


def _close(name, got, want, dt):
    want = np.asarray(want, dtype=np.float64)
    err = float(np.abs(got.detach().double().numpy() - want).max())
    assert err <= LIMIT[dt] * float(np.abs(want).max()), (name, err, LIMIT[dt])


@pytest.mark.parametrize("size,n,dt", CASES)
def test_forward_equals_jax(size, n, dt):
    arrays, (out, h, *_) = _jax(n, dt)
    got = _shards(arrays, size, dt)
    _close("out", got["out"], out, dt)
    _close("h", got["h"], h, dt)
    assert got["out"].dtype == got["h"].dtype == dt


@pytest.mark.parametrize("size,n", [(s, n) for s, n, dt in CASES if dt == torch.float32])
def test_row_statistics_equal_jax(size, n):
    """Each block's (mean, M2) and the merged (mean, rstd) against numpy's of
    the kernel's own float32 h: the means within 1e-5 of the largest |h|,
    M2 and rstd within 1e-5 relative."""
    arrays, (_, h, *_) = _jax(n, torch.float32)
    h = h.astype(np.float64)
    got = _shards(arrays, size, torch.float32)
    top = np.abs(h).max()
    for r, blk in enumerate(np.split(h, size, axis=1)):
        mean, m2 = got["stats"][r].double().numpy().T
        assert np.abs(mean - blk.mean(1)).max() <= 1e-5 * top
        want_m2 = ((blk - blk.mean(1, keepdims=True)) ** 2).sum(1)
        assert np.abs(m2 / want_m2 - 1).max() <= 1e-5
    mean, rstd = got["mstats"].double().numpy().T
    assert np.abs(mean - h.mean(1)).max() <= 1e-5 * top
    assert np.abs(rstd * np.sqrt(h.var(1) + EPS) - 1).max() <= 1e-5


@pytest.mark.parametrize("size,n,dt", CASES)
def test_backward_equals_jax_vjp(size, n, dt):
    arrays, (_, _, *want) = _jax(n, dt)
    got = _shards(arrays, size, dt)
    for name, w in zip(("dx", "dw", "db", "dgamma", "dbeta"), want):
        _close(name, got[name], w, dt)
    assert all(got[k].dtype == dt for k in ("dh", "dw", "db", "dgamma", "dbeta"))


@pytest.mark.parametrize("size,n,dt", CASES)
def test_dh_equals_jax_vjp(size, n, dt):
    """x's rows one-hot (row i = e_(i mod 64)): in each run of 64 rows JAX's
    dW holds that run's dh (row i at dW's row i mod 64)."""
    arrays, want = _jax(n, dt, onehot=True)
    _close("dh", _shards(arrays, size, dt)["dh"], want, dt)


@pytest.mark.parametrize("size", [2, 4])
def test_column_function_on_local_ranks_equals_jax(size):
    """``column_spectre_linear`` on ``size`` ranks in threads, each with its
    columns of W, b, gamma, beta and the pool residual: out and, through
    each rank's backward, dx (the ranks' partials summed), dW, db, dgamma,
    dbeta against JAX, float32."""
    n_full = 96
    arrays = _inputs(n_full, seed=size + 7)
    j = [jnp.asarray(a) for a in arrays]
    out_j, vjp = jax.vjp(lambda *a: jax_fused_spectre_linear(*a, EPS, True), *j[:5])
    want = [np.asarray(t) for t in (out_j, *vjp(j[5]))]
    x, w, b, gamma, beta, g = (torch.from_numpy(a) for a in arrays)
    n = n_full // size
    ranks = LocalRanks(size)

    def rank(r):
        c = slice(r * n, (r + 1) * n)
        xr = x.clone().requires_grad_()
        ps = [t[..., c].clone().requires_grad_() for t in (w, b, gamma, beta)]
        out = column_spectre_linear(xr, *ps, adaptive_avg_pool1d(xr, n_full)[:, c],
                                    ranks.gather(r))
        grads = out.grad_fn.apply(g[:, c].contiguous())
        return out.detach(), grads

    res = ranks.run(rank)
    _close("out", torch.cat([o for o, _ in res], 1), want[0], torch.float32)
    # the pool residual's gradient (grads[5]) goes back through its slice of x
    xg = x.clone().requires_grad_()
    dpool, = torch.autograd.grad(adaptive_avg_pool1d(xg, n_full), xg, g)
    _close("dx", sum(gr[0] for _, gr in res) + dpool, want[1], torch.float32)
    for i, name in enumerate(("dw", "db", "dgamma", "dbeta"), start=1):
        _close(name, torch.cat([gr[i] for _, gr in res], -1), want[i + 1], torch.float32)
