"""Kernel 5's token-grouped kernel (``fused_block_bwd_grouped``) on the CPU:
its schedule, mirrored in plain Python from the kernel's prologue
(csrc/fused_block_bwd.cu::build_schedule) with the launch shape of
``grouped_plan``, and the sum taken in the schedule's order in plain torch,
against the plain version and the JAX package's Pallas kernel (interpret
mode) fed the same inputs. tests/test_torch_port_cuda.py holds the kernel
itself to the plain version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectre_tpu.ops.pallas.bwd_gather import fused_block_bwd_pallas
from spectre_tpu_torch.ops.kernels import block_bwd_kernel, fused_block_bwd_plain, grouped_plan


def grouped_schedule(binv: np.ndarray, blk: int, eh: int, dtype: torch.dtype):
    """The kernel's schedule: (sb, J, blocks), each block the list of its
    steps in order, a step (token, [(head, slab q, first row in the flat
    [H*d] stream), ...]). A block owns slabs [q0, q0 + J) of sb rows; its
    (head, slab) pairs are sorted by (token, head, slab) and each token's
    run is cut into steps of at most 64 / sb pairs, a new step wherever a
    slab would come twice."""
    heads, nb = binv.shape
    sb, j = grouped_plan(dtype, heads, blk)
    d = nb * blk
    nq, per, g = d // sb, blk // sb, 64 // sb
    blocks = []
    for q0 in range(0, nq, j):
        pairs = []
        for i in range(heads * j):
            h, jj = divmod(i, j)
            q = q0 + jj
            if q < nq:
                st = h * d + int(binv[h, q // per]) * blk + (q % per) * sb
                pairs.append(((st // eh * heads + h) * j + jj, st, h, q))
        steps = []
        for key, st, h, q in sorted(pairs):
            if (steps and steps[-1][0] == st // eh and len(steps[-1][1]) < g
                    and q not in {qq for _, qq, _ in steps[-1][1]}):
                steps[-1][1].append((h, q, st))
            else:
                steps.append((st // eh, [(h, q, st)]))
        blocks.append(steps)
    return sb, j, blocks


def grouped_emulated(dy, w, s4, binv, blk: int) -> torch.Tensor:
    """The kernel's arithmetic in plain torch: each step's stacked slabs
    times its token's dy in float32, each row signed and added into the
    float32 sums in the schedule's order; one cast at the end."""
    n_tok, b, o = dy.shape
    eh = w.shape[0]
    sb, _, blocks = grouped_schedule(binv.numpy(), blk, eh, dy.dtype)
    wf, dyf, sf = w.float(), dy.float(), s4.reshape(-1).float()
    acc = torch.zeros(binv.shape[1] * blk, b)
    rows = torch.arange(sb)
    for steps in blocks:
        for n, slabs in steps:
            src = torch.cat([st % eh + rows for _, _, st in slabs])
            part = wf[src] @ dyf[n].T  # [slabs * sb, B]
            for k, (_, q, st) in enumerate(slabs):
                acc[q * sb + rows] += sf[st + rows][:, None] * part[k * sb + rows]
    return acc.to(dy.dtype)


def _case(h, e, n, b, o, blk, seed):
    """dy [N, B, O], w [E*H, O], s4 [N, E*H] of +-1, binv [H, N*E/blk]."""
    rng = np.random.default_rng(seed)
    binv = np.stack([rng.permutation(n * e // blk) for _ in range(h)]).astype(np.int32)
    dy = rng.standard_normal((n, b, o)).astype(np.float32)
    w = rng.standard_normal((e * h, o)).astype(np.float32)
    s4 = rng.choice([-1.0, 1.0], (n, e * h)).astype(np.float32)
    return dy, w, s4, binv


# E = 96 takes every blk here (16, 32 and 48, whose slabs are 16 rows); 5
# tokens, so d = 480 and a block of 256 (bf16) or 128 (float32) rows leaves
# a ragged last block
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [4, 16])
@pytest.mark.parametrize("blk", [16, 32, 48])
def test_the_schedule_covers_every_head_block_pair_once(dtype, heads, blk):
    """Every (head, slab) pair exactly once, so every (head, block of the
    table) pair exactly once as its blk / sb slabs; a step holds distinct
    slabs of one token, at most 64 / sb of them, each in that token; the
    steps go in (token, head) order, so each output row meets its heads in
    head order."""
    e, n = 96, 5
    eh, d = e * heads, n * e
    assert block_bwd_kernel(dtype, blk) == "fused_block_bwd_grouped"
    binv = _case(heads, e, n, 1, 8, blk, seed=blk + heads)[3]
    sb, j, blocks = grouped_schedule(binv, blk, eh, dtype)
    assert sb == (32 if blk == 32 else 16) and heads * j <= 256
    assert j * sb <= (256 if dtype == torch.bfloat16 else 128)
    seen = []
    for bi, steps in enumerate(blocks):
        order = [(tok, h) for tok, slabs in steps for h, _, _ in slabs]
        assert order == sorted(order)
        heads_of_slab = {}
        for tok, slabs in steps:
            assert 1 <= len(slabs) <= 64 // sb
            assert len({q for _, q, _ in slabs}) == len(slabs)
            for h, q, st in slabs:
                assert bi * j <= q < (bi + 1) * j
                assert st // eh == tok and (st + sb - 1) // eh == tok
                assert st == h * d + binv[h, q * sb // blk] * blk + q * sb % blk
                heads_of_slab.setdefault(q, []).append(h)
                seen.append((h, q))
        assert all(hs == list(range(heads)) for hs in heads_of_slab.values())
    assert sorted(seen) == [(h, q) for h in range(heads) for q in range(d // sb)]
    blocks_seen = sorted((h, q * sb // blk) for h, q in seen)
    assert blocks_seen == sorted((h, jb) for h in range(heads) for jb in range(d // blk)
                                 for _ in range(blk // sb))


# float32 within 1e-5 of the largest entry: the same float32 products, added
# over O in other orders (the Pallas kernel, the plain bmm, the emulation's
# matmul); bf16 within 2^-6, the port's bf16 limit against a Pallas kernel
# fed the same bf16 inputs (the three round the float32 sums once, so they
# differ by a bf16 ulp of an entry, 2^-8 of it, where the sums' order
# moves a rounding); B = 5 is a ragged batch tile
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -6)])
@pytest.mark.parametrize("blk", [16, 32, 48])
@pytest.mark.parametrize("b", [24, 5])
def test_the_schedules_sum_matches_plain_and_the_pallas_kernel(dtype, rel, blk, b):
    heads, e, n, o = 4, 96, 5, 16
    arrays = _case(heads, e, n, b, o, blk, seed=3 * blk + b)
    dy, w, s4 = (torch.from_numpy(a).to(dtype) for a in arrays[:3])
    binv = torch.from_numpy(arrays[3])
    got = grouped_emulated(dy, w, s4, binv, blk)
    plain = fused_block_bwd_plain(dy, w, s4, binv, blk)
    assert got.shape == plain.shape == (n * e, b) and got.dtype == dtype
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    pallas = fused_block_bwd_pallas(*(jnp.asarray(a, dtype=jdt) for a in arrays[:3]),
                                    jnp.asarray(arrays[3]), blk, interpret=True)
    pallas = torch.from_numpy(np.array(pallas.astype(jnp.float32)))
    scale = plain.float().abs().max().item()
    assert (got.float() - plain.float()).abs().max().item() <= rel * scale
    assert (got.float() - pallas).abs().max().item() <= rel * scale
