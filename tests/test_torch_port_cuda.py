"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU with nvcc and carries the ``cuda``
marker; without a CUDA device each one skips. The file imports neither jax
nor the JAX package, so it also runs on the GPU machine, which has no jax:

    python -m pytest tests/test_torch_port_cuda.py -q --noconftest -p no:cacheprovider

(``--noconftest`` skips tests/conftest.py, which imports jax.) The CPU
tests hold the plain versions to the JAX package; these hold the kernels to
the plain versions, and a small model on the card to the same model on the
CPU.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from spectre_tpu_torch.configs import FLAGSHIP, parse_config
from spectre_tpu_torch.data import BatchIterator, prefetch_to_device, synthetic_batch, \
    synthetic_dataset
from spectre_tpu_torch.models import build_model
from spectre_tpu_torch.models.layers import FoldedMixLinear, MHPermutMix
from spectre_tpu_torch.ops import fwht as fwht_any_axis
from spectre_tpu_torch.ops import perm_rows_t, register_mix_routes
from spectre_tpu_torch.ops.kernels.fused_linear import wide_cluster_reach
from spectre_tpu_torch.ops.routing import build_route_tables_cached
from spectre_tpu_torch.ops.kernels import (
    block_gather_sum,
    block_gather_sum_plain,
    block_scatter_rows,
    block_scatter_rows_plain,
    block_bwd_kernel,
    cluster_plan,
    forward_kernel,
    fused_block_bwd,
    fused_block_bwd_grouped,
    fused_block_bwd_plain,
    fused_block_bwd_wgmma,
    fused_spectre_linear,
    fused_spectre_linear_bwd,
    fused_spectre_linear_bwd_plain,
    fused_spectre_linear_bwd_wide,
    fused_spectre_linear_cluster,
    fused_spectre_linear_grad,
    fused_spectre_linear_plain,
    fused_spectre_linear_wide_cluster,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_fwd,
    flash_attention_fwd_plain,
    flash_attention_plain,
    fwht,
    fwht_plain,
    inverse_gather_sum,
    inverse_gather_sum_plain,
    launch_counts,
    routed_gather_sum,
    routed_gather_sum_plain,
    structured_mix,
    structured_mix_bwd,
    structured_mix_bwd_plain,
    structured_mix_grad,
    structured_mix_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the GPU: python3 chip_smoke.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _linear_case(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.uniform(-k ** -0.5, k ** -0.5, (k, n)).astype(np.float32)
    b = (rng.standard_normal(n) * 0.1).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, n).astype(np.float32)
    beta = (rng.standard_normal(n) * 0.1).astype(np.float32)
    return x, w, b, gamma, beta


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_scatter_kernel_is_bitwise_the_plain_copy(cuda_device, dtype):
    """16-byte chunks (blk=64), element-wise chunks (blk=1 at odd B), chunks
    shorter than a block that share one (single rows; a chunk count and a
    chunk length that do not divide the block) and a source whose base is not
    16-byte aligned."""
    rng = np.random.default_rng(0)
    h = 4
    for nb, blk, b, offset in ((40, 64, 1, 0), (40, 64, 3, 0), (40, 64, 64, 0),
                               (40, 64, 130, 0), (300, 1, 3, 0), (300, 1, 8, 0),
                               (40, 64, 8, 1), (301, 1, 256, 0), (300, 1, 24, 0),
                               (300, 1, 1024, 0), (301, 1, 8, 1)):
        bsrc = torch.from_numpy(np.stack([rng.permutation(nb) for _ in range(h)])
                                .astype(np.int32)).to(cuda_device)
        flat = torch.from_numpy(rng.standard_normal(offset + nb * blk * b).astype(np.float32))
        xt = flat.to(cuda_device, dtype)[offset:].view(nb * blk, b)
        n0 = block_scatter_rows.launches
        got = block_scatter_rows(xt, bsrc, blk)
        assert block_scatter_rows.launches == n0 + 1
        assert torch.equal(got, block_scatter_rows_plain(xt, bsrc, blk)), (nb, blk, b, offset)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_sum_kernels_are_bitwise_the_plain_head_sum(cuda_device, dtype):
    """Kernel and plain version add the same float32 values in the same head
    order and cast once, so they agree bit for bit: 16-byte chunks, chunks
    shorter than a block, odd B (element-wise units), a source whose base is
    not 16-byte aligned, and more heads than one batch of loads in flight."""
    rng = np.random.default_rng(0)
    for h, nb, blk, b, offset in ((4, 40, 64, 1, 0), (4, 40, 64, 3, 0), (16, 40, 64, 64, 0),
                                  (4, 40, 64, 130, 0), (11, 300, 1, 3, 0), (4, 300, 1, 8, 0),
                                  (16, 300, 1, 256, 0), (4, 40, 8, 8, 1), (9, 300, 1, 8, 1)):
        binv = torch.from_numpy(np.stack([rng.permutation(nb) for _ in range(h)])
                                .astype(np.int32)).to(cuda_device)
        flat = torch.from_numpy(rng.standard_normal(offset + h * nb * blk * b)
                                .astype(np.float32))
        g = flat.to(cuda_device, dtype)[offset:].view(h * nb * blk, b)
        n0 = launch_counts()
        got = block_gather_sum(g, binv, blk)
        assert torch.equal(got, block_gather_sum_plain(g, binv, blk)), (h, nb, blk, b, offset)
        if blk == 1:
            rows = inverse_gather_sum(g, binv)
            assert torch.equal(rows, inverse_gather_sum_plain(g, binv)), (h, nb, b, offset)
            assert torch.equal(rows, got)
        n1 = launch_counts()
        assert n1["block_gather_sum"] == n0["block_gather_sum"] + 1
        assert n1["inverse_gather_sum"] == n0["inverse_gather_sum"] + (blk == 1)


# relative to the largest entry of the result. f32: FMAs in another order than
# the plain version's product. bf16: both add exact products in float32 and
# round once, so single entries differ by one bf16 ulp (2^-8 of the entry)
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("blk", [16, 32, 64, 128])
@pytest.mark.parametrize("b", [5, 250, 256, 1024])
def test_fused_block_bwd_kernel_matches_plain_and_the_chain(cuda_device, dtype, rel, blk, b):
    """Kernel 5 against its plain version and against the chain it fuses
    (dg4 product, signs, block_gather_sum), with a ragged batch tail, an O
    that is no multiple of the kernel's K stage, and every slab size; bf16
    with blk = 64 and 128 (two 64-row tiles a block of the table) on the
    wgmma kernel (batch tiles of 256 columns: B = 1024 is four), the rest on
    the token-grouped kernel (batch tiles of 128 columns)."""
    rng = np.random.default_rng(blk + b)
    # blk = 128 divides EH = 256 and d = 384 with six tokens
    h, e, n, o = 4, 64, 6 if blk == 128 else 5, 40
    d, eh = n * e, e * h
    binv = torch.from_numpy(np.stack([rng.permutation(d // blk) for _ in range(h)])
                            .astype(np.int32)).to(cuda_device)
    dy = torch.from_numpy(rng.standard_normal((n, b, o)).astype(np.float32)).to(cuda_device, dtype)
    w = torch.from_numpy(rng.standard_normal((eh, o)).astype(np.float32)).to(cuda_device, dtype)
    s4 = torch.from_numpy(rng.choice([-1.0, 1.0], (n, eh)).astype(np.float32)).to(cuda_device,
                                                                                 dtype)
    n0, route = fused_block_bwd.launches, block_bwd_kernel(dtype, blk)
    assert (route == "fused_block_bwd_wgmma") == (dtype == torch.bfloat16 and blk % 64 == 0)
    k0 = launch_counts()[route]
    got = fused_block_bwd(dy, w, s4, binv, blk)
    torch.cuda.synchronize()
    assert fused_block_bwd.launches == n0 + 1 and launch_counts()[route] == k0 + 1
    assert torch.equal(got, fused_block_bwd(dy, w, s4, binv, blk))  # two runs bitwise
    want = fused_block_bwd_plain(dy, w, s4, binv, blk)
    assert got.shape == want.shape == (d, b) and got.dtype == dtype
    scale = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= rel * scale
    dg4 = torch.bmm(w.expand(n, -1, -1), dy.transpose(1, 2)) * s4[:, :, None]
    chain = block_gather_sum(dg4.reshape(h * d, b), binv, blk)
    # the chain rounds dg4 to the data type per head before it adds
    assert (got.float() - chain.float()).abs().max().item() <= 4 * rel * scale


# gradients relative to each tensor's largest entry. f32: the kernel's
# product sums in another order than cuBLAS. bf16: h is saved rounded to
# bf16 on both paths, but out of two float32 products that differ in the
# last bits, so single entries of h differ by one bf16 ulp (2^-8 relative)
@pytest.mark.parametrize("dtype,out_atol,rel", [(torch.float32, 1e-4, 1e-4),
                                                (torch.bfloat16, 2e-2, 2e-2)])
@pytest.mark.parametrize("m,k,n", [(130, 64, 64), (70, 96, 48), (33, 64, 100)])
def test_fused_spectre_linear_function_matches_the_plain_path(cuda_device, dtype, out_atol,
                                                              rel, m, k, n):
    """h against the plain pre-LN product, and the Function's five gradients
    against autograd of the plain version, at a small shape."""
    arrays = _linear_case(m, k, n, seed=m)
    ct = torch.from_numpy(np.random.default_rng(m).standard_normal((m, n))
                          .astype(np.float32)).to(cuda_device, dtype)
    a = [torch.from_numpy(v).to(cuda_device, dtype).requires_grad_() for v in arrays]
    b = [torch.from_numpy(v).to(cuda_device, dtype).requires_grad_() for v in arrays]
    with torch.no_grad():
        out, h = fused_spectre_linear(*a, save_h=True)
        want, want_h = fused_spectre_linear_plain(*b, save_h=True)
    assert (h.float() - want_h.float()).abs().max().item() <= out_atol
    n0 = fused_spectre_linear.launches
    got = fused_spectre_linear_grad(*a)
    assert fused_spectre_linear.launches == n0 + 1
    assert torch.equal(got, out)
    got.backward(ct)
    assert fused_spectre_linear.launches == n0 + 1  # the backward launches no forward
    fused_spectre_linear_plain(*b).backward(ct)
    for name, ta, tb in zip(("dx", "dw", "db", "dgamma", "dbeta"), a, b):
        assert ta.grad.dtype == dtype
        scale = tb.grad.float().abs().max().item()
        diff = (ta.grad.float() - tb.grad.float()).abs().max().item()
        assert diff <= rel * scale, (name, diff, scale)


# f32: only the summation order differs; bf16: one ulp of the output
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("m,k,n", [(1040, 512, 768), (1040, 768, 512), (33, 512, 100),
                                   (70, 64, 64), (9, 40, 24)])
def test_fused_spectre_linear_kernel_matches_plain(cuda_device, dtype, atol, m, k, n):
    args = [torch.from_numpy(a).to(cuda_device, dtype) for a in _linear_case(m, k, n)]
    n0 = fused_spectre_linear.launches
    got = fused_spectre_linear(*args)
    assert fused_spectre_linear.launches == n0 + 1
    want = fused_spectre_linear_plain(*args)
    assert (got.float() - want.float()).abs().max().item() <= atol


# kernel 2's bf16 wgmma kernel: the flagship's shapes at B=256, the mix
# projection at K=8,192, the serving buckets' rows 65 x {1, 2, 7, 64, 256},
# and ragged rows, N not a multiple of the 256-wide warpgroup tile, K == N
# (the identity residual) and K < 64. bf16: one ulp of the output (2e-2),
# 4e-2 at K=8,192, whose pre-LN values reach [4, 8)
@pytest.mark.parametrize("m,k,n", [(65 * 256, 512, 768), (65 * 256, 768, 512),
                                   (65 * 256, 8192, 512), (195, 128, 192), (195, 768, 768),
                                   (130, 96, 48), (9, 40, 24)]
                         + [(65 * b, k, n) for b in (1, 2, 7, 64, 256)
                            for k, n in ((512, 768), (768, 512))])
def test_fused_spectre_linear_wgmma_kernel_matches_plain(cuda_device, m, k, n):
    atol = 4e-2 if k > 1024 else 2e-2
    args = [torch.from_numpy(a).to(cuda_device, torch.bfloat16)
            for a in _linear_case(m, k, n, seed=m + k + n)]
    assert forward_kernel(torch.bfloat16, k, n) == "fused_spectre_linear_wgmma"
    n0 = launch_counts()
    got, h = fused_spectre_linear(*args, save_h=True)
    out_only = fused_spectre_linear(*args)
    torch.cuda.synchronize()
    n1 = launch_counts()
    assert n1["fused_spectre_linear_wgmma"] - n0["fused_spectre_linear_wgmma"] == 2
    assert n1["fused_spectre_linear"] - n0["fused_spectre_linear"] == 2
    assert n1["fused_spectre_linear_cluster"] == n0["fused_spectre_linear_cluster"]
    want, want_h = fused_spectre_linear_plain(*args, save_h=True)
    assert torch.equal(got, out_only)
    assert (got.float() - want.float()).abs().max().item() <= atol
    assert (h.float() - want_h.float()).abs().max().item() <= atol


@pytest.mark.parametrize("m,k,n", [(65 * 256, 512, 768), (65 * 7, 768, 512)])
def test_fused_spectre_linear_wgmma_kernel_is_bitwise_repeatable(cuda_device, m, k, n):
    args = [torch.from_numpy(a).to(cuda_device, torch.bfloat16) for a in _linear_case(m, k, n)]
    first = fused_spectre_linear(*args, save_h=True)
    for a, b in zip(first, fused_spectre_linear(*args, save_h=True)):
        assert torch.equal(a, b)


# the cluster kernel, called directly, at every shape the f32/WMMA and wide
# f32/WMMA kernels took on a path: the head's N = 100 at each serving and
# train batch, the MNIST head (K 16, N 10), `perf linear`'s 8 rows, the C6
# shapes; 1,041 rows end in a ragged 16-row tile. f32 within 1e-4 (the
# order of the sums); bf16 within one bf16 ulp of the largest entry of out
# and of h (2^-7 of the power of two below it): both round float32 values
# once, which differ in their last bits, and at 4,160 rows GELU's output
# reaches [4, 8), where one ulp is 2^-5. With and without h, two runs
# bitwise equal.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(m, 512, 100) for m in (1, 2, 7, 64, 256, 1024, 1041)]
                         + [(64, 16, 10), (8, 1024, 1024), (8, 2048, 2048), (8, 4096, 4096),
                            (4160, 1536, 1536), (4160, 768, 1100)])
def test_fused_spectre_linear_cluster_kernel_matches_plain(cuda_device, dtype, m, k, n):
    def atol(ref):
        if dtype == torch.float32:
            return 1e-4
        return 2.0 ** (np.floor(np.log2(ref.float().abs().max().item())) - 7)

    args = [torch.from_numpy(a).to(cuda_device, dtype)
            for a in _linear_case(m, k, n, seed=m + k + n)]
    outs = [torch.empty(m, n, dtype=dtype, device=cuda_device) for _ in range(4)]
    n0 = fused_spectre_linear_cluster.launches
    fused_spectre_linear_cluster(*args, outs[0], outs[1], 1e-5)
    fused_spectre_linear_cluster(*args, outs[2], None, 1e-5)
    fused_spectre_linear_cluster(*args, outs[3], outs[2].new_empty(m, n), 1e-5)
    torch.cuda.synchronize()
    assert fused_spectre_linear_cluster.launches == n0 + 3
    want, want_h = fused_spectre_linear_plain(*args, save_h=True)
    assert torch.equal(outs[0], outs[2]) and torch.equal(outs[0], outs[3])
    assert (outs[0].float() - want.float()).abs().max().item() <= atol(want)
    assert (outs[1].float() - want_h.float()).abs().max().item() <= atol(want_h)


def test_fused_spectre_linear_cluster_kernel_is_bitwise_repeatable(cuda_device):
    """The head at B=256 in bf16, whose plan splits K across the cluster
    (partial sums added through DSMEM in rank order), and float32 on 8 rows."""
    for dtype, (m, k, n) in ((torch.bfloat16, (256, 512, 100)), (torch.float32, (8, 1024, 1024))):
        assert cluster_plan(dtype, m, k, n, 132).cluster > 1
        args = [torch.from_numpy(a).to(cuda_device, dtype) for a in _linear_case(m, k, n)]
        first = fused_spectre_linear(*args, save_h=True)
        for a, b in zip(first, fused_spectre_linear(*args, save_h=True)):
            assert torch.equal(a, b)


# kernel 2 at N > 1,024 (bf16 that TMA can describe on the wide cluster
# kernel up to its reach on the card, N = 4,096 with a cluster of 16 blocks;
# beyond it and the rest on the cluster kernel): K == N (the identity residual),
# K != N, N not a multiple of 8, ragged rows and ragged column tiles; out
# and h against the plain version (which normalises the float32 sums, as
# the kernels do) under the limits of the one-pass kernels, and two runs
# bitwise equal
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("m,k,n", [(4160, 1536, 1536), (4160, 768, 2048), (195, 768, 1100),
                                   (70, 40, 1032), (9, 1100, 1100), (1040, 512, 4096),
                                   (300, 512, 4104)])
def test_fused_spectre_linear_wide_kernels_match_plain(cuda_device, dtype, atol, m, k, n):
    args = [torch.from_numpy(a).to(cuda_device, dtype)
            for a in _linear_case(m, k, n, seed=m + k + n)]
    name = forward_kernel(dtype, k, n)
    tma = dtype == torch.bfloat16 and n % 8 == 0 and k % 8 == 0
    reach = wide_cluster_reach(cuda_device.index or 0)
    assert name == ("fused_spectre_linear_wide_cluster" if tma and n <= reach
                    else "fused_spectre_linear_cluster")
    n0 = launch_counts()
    got, h = fused_spectre_linear(*args, save_h=True)
    out_only = fused_spectre_linear(*args)
    again = fused_spectre_linear(*args, save_h=True)
    torch.cuda.synchronize()
    n1 = launch_counts()
    assert n1[name] - n0[name] == 3 and n1["fused_spectre_linear"] - n0["fused_spectre_linear"] == 3
    want, want_h = fused_spectre_linear_plain(*args, save_h=True)
    assert torch.equal(got, out_only) and torch.equal(got, again[0]) and torch.equal(h, again[1])
    assert (got.float() - want.float()).abs().max().item() <= atol
    assert (h.float() - want_h.float()).abs().max().item() <= atol


def test_the_wide_cluster_reaches_n_4096_on_the_card(cuda_device):
    """The wide cluster kernel launches clusters of 16 blocks on the card
    (non-portable), so it takes N up to 4,096."""
    assert wide_cluster_reach(cuda_device.index or 0) == 4096


# N from 776 (a cluster of four, the last block with 8 columns) to 2,056,
# at ragged rows and a ragged last column block, with and without h
@pytest.mark.parametrize("m,k,n", [(4160, 1536, 1536), (195, 768, 1032), (130, 64, 2056),
                                   (70, 512, 776)])
def test_fused_spectre_linear_wide_cluster_matches_plain(cuda_device, m, k, n):
    args = [torch.from_numpy(a).to(cuda_device, torch.bfloat16)
            for a in _linear_case(m, k, n, seed=m + n)]
    want, want_h = fused_spectre_linear_plain(*args, save_h=True)
    out, h = torch.empty_like(want), torch.empty_like(want)
    n0 = fused_spectre_linear_wide_cluster.launches
    fused_spectre_linear_wide_cluster(*args, out, h, 1e-5)
    out_only = torch.empty_like(want)
    fused_spectre_linear_wide_cluster(*args, out_only, None, 1e-5)
    torch.cuda.synchronize()
    assert fused_spectre_linear_wide_cluster.launches == n0 + 2
    assert torch.equal(out, out_only)
    assert (out.float() - want.float()).abs().max().item() <= 2e-2
    assert (h.float() - want_h.float()).abs().max().item() <= 2e-2


# kernel 5's grouped kernel at the flagship mix backward's shape (d =
# 33,280, H = 16, 65 tokens, O = 512) with the tables it takes there, and
# with 128 heads (two slabs a block: 256 pairs, the schedule's most)
@pytest.mark.parametrize("dtype,blk", [(torch.bfloat16, 16), (torch.bfloat16, 32),
                                       (torch.float32, 16), (torch.float32, 64)])
def test_fused_block_bwd_grouped_at_the_flagship_shape(cuda_device, dtype, blk):
    rel = 1e-4 if dtype == torch.float32 else 1e-2
    for h, e, n, o, b in ((16, 512, 65, 512, 256), (128, 32, 3, 64, 40)):
        if e % blk:
            continue
        rng = np.random.default_rng(h + blk)
        d = n * e
        binv = torch.from_numpy(np.stack([rng.permutation(d // blk) for _ in range(h)])
                                .astype(np.int32)).to(cuda_device)
        dy = torch.from_numpy(rng.standard_normal((n, b, o)).astype(np.float32)).to(
            cuda_device, dtype)
        w = torch.from_numpy(rng.standard_normal((e * h, o)).astype(np.float32)).to(
            cuda_device, dtype)
        s4 = torch.from_numpy(rng.choice([-1.0, 1.0], (n, e * h)).astype(np.float32)).to(
            cuda_device, dtype)
        k0 = fused_block_bwd_grouped.launches
        got = fused_block_bwd(dy, w, s4, binv, blk)
        assert torch.equal(got, fused_block_bwd(dy, w, s4, binv, blk))
        assert fused_block_bwd_grouped.launches == k0 + 2
        want = fused_block_bwd_plain(dy, w, s4, binv, blk)
        scale = want.float().abs().max().item()
        assert (got.float() - want.float()).abs().max().item() <= rel * scale


# kernel 5's wgmma kernel with the pool residual's cotangent at the flagship
# layer's shape (N = 65, EH = 8,192, O = 512, H = 16, blk = 64, grp = 16),
# against its plain version at kernel 5's limit; dpool as the train step
# hands it over (a transposed [B, N, O] view) and contiguous
@pytest.mark.parametrize("b", [1024, 250])
@pytest.mark.parametrize("layout", ["step", "contiguous"])
def test_fused_block_bwd_pool_term_at_the_flagship_shape(cuda_device, b, layout):
    h, e, n, o, blk = 16, 512, 65, 512, 64
    d, eh, grp = n * e, e * h, e * h // o
    rng = np.random.default_rng(b)
    binv = torch.from_numpy(np.stack([rng.permutation(d // blk) for _ in range(h)])
                            .astype(np.int32)).to(cuda_device)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
            cuda_device, torch.bfloat16)

    dy, w = normal(n, b, o), normal(eh, o)
    dpool = normal(b, n, o).transpose(0, 1) if layout == "step" else normal(n, b, o)
    s4 = torch.from_numpy(rng.choice([-1.0, 1.0], (n, eh)).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    k0, n0 = fused_block_bwd_wgmma.launches, fused_block_bwd.launches
    got = fused_block_bwd(dy, w, s4, binv, blk, dpool, grp)
    assert torch.equal(got, fused_block_bwd(dy, w, s4, binv, blk, dpool, grp))  # bitwise
    assert fused_block_bwd_wgmma.launches == k0 + 2 and fused_block_bwd.launches == n0 + 2
    want = fused_block_bwd_plain(dy, w, s4, binv, blk, dpool, grp)
    assert got.shape == want.shape == (d, b) and got.dtype == torch.bfloat16
    scale = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= 1e-2 * scale
    # the pool term alone (dy = 0): exact float32 terms added in head order
    # on both sides and rounded once, so bit for bit
    zero = torch.zeros_like(dy)
    pool_only = fused_block_bwd(zero, w, s4, binv, blk, dpool, grp)
    assert torch.equal(pool_only, fused_block_bwd_plain(zero, w, s4, binv, blk, dpool, grp))
    assert pool_only.abs().max().item() > 0


# the pool term at every grp a multiple of 16 (grp = H: O = 64), blk 64 and
# 128, batch tails, and a dpool view 2-byte aligned (no 8-byte loads)
@pytest.mark.parametrize("h,blk,b,offset", [(16, 64, 5, 0), (16, 128, 300, 1), (32, 64, 250, 0),
                                            (48, 64, 40, 0), (48, 128, 257, 3)])
def test_fused_block_bwd_pool_term_takes_every_grp_the_rule_allows(cuda_device, h, blk, b,
                                                                   offset):
    e, n, o = 64, 6, 64
    d, eh, grp = n * e, e * h, h
    rng = np.random.default_rng(h + blk + b)
    binv = torch.from_numpy(np.stack([rng.permutation(d // blk) for _ in range(h)])
                            .astype(np.int32)).to(cuda_device)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
            cuda_device, torch.bfloat16)

    dy, w = normal(n, b, o), normal(eh, o)
    dpool = normal(offset + b * n * o)[offset:].view(b, n, o).transpose(0, 1)
    s4 = torch.from_numpy(rng.choice([-1.0, 1.0], (n, eh)).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    got = fused_block_bwd(dy, w, s4, binv, blk, dpool, grp)
    assert torch.equal(got, fused_block_bwd(dy, w, s4, binv, blk, dpool, grp))
    want = fused_block_bwd_plain(dy, w, s4, binv, blk, dpool, grp)
    scale = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= 1e-2 * scale
    zero = torch.zeros_like(dy)
    assert torch.equal(fused_block_bwd(zero, w, s4, binv, blk, dpool, grp),
                       fused_block_bwd_plain(zero, w, s4, binv, blk, dpool, grp))


def test_fused_block_bwd_pool_term_refuses_what_the_kernel_does_not_take(cuda_device):
    """The pool term runs on the wgmma kernel with grp a multiple of 16 only."""
    n, b, o = 6, 8, 64
    for dtype, blk, grp in ((torch.bfloat16, 32, 16), (torch.float32, 64, 16),
                            (torch.bfloat16, 64, 8)):
        h = 16
        e = o * grp // h
        if (n * e) % blk:
            continue
        binv = torch.stack([torch.randperm(n * e // blk) for _ in range(h)]).to(
            cuda_device, torch.int32)
        dy = torch.zeros(n, b, o, device=cuda_device, dtype=dtype)
        w = torch.zeros(e * h, o, device=cuda_device, dtype=dtype)
        s4 = torch.ones(n, e * h, device=cuda_device, dtype=dtype)
        with pytest.raises(ValueError):
            fused_block_bwd(dy, w, s4, binv, blk, torch.zeros_like(dy), grp)


def test_flagship_mix_layer_on_the_card_takes_the_one_launch_backward(cuda_device):
    """One flagship mix layer (E=512, 65 tokens, H=16, blk=64, bf16) at
    B=256: the fused path's forward equals the chain's bit for bit, so do
    the parameters' gradients (the same ops), and dx lies within 4 times
    kernel 5's limit of the chain's, which rounds dg4 per op."""
    torch.manual_seed(0)
    m = MHPermutMix(512, 65, 16, 512, mix_block=64, dtype=torch.bfloat16, device=cuda_device)
    gen = torch.Generator().manual_seed(1)
    m.init_parameters(gen)
    m.linear.init_parameters(gen)
    mix = m.refresh()
    x = torch.randn(256, 65, 512, device=cuda_device)
    cot = torch.randn(256, 65, 512, device=cuda_device, dtype=torch.bfloat16)

    def run(fn):
        xa = x.clone().requires_grad_()
        for p in m.parameters():
            p.grad = None
        out = fn(xa)
        out.backward(cot)
        return out.detach(), xa.grad, [p.grad.clone() for p in m.parameters()]

    def chain(xa):
        xt = xa.to(torch.bfloat16).reshape(256, -1).t().contiguous()
        g = perm_rows_t(xt, mix.tables, mix.route)
        return m.linear(g.view(65, -1, 256), mix)

    paths0 = dict(FoldedMixLinear.forward_paths)
    k0 = launch_counts()
    got = run(m)
    k1 = launch_counts()
    assert FoldedMixLinear.forward_paths["fused"] == paths0["fused"] + 1
    assert k1["fused_block_bwd_wgmma"] - k0["fused_block_bwd_wgmma"] == 1
    assert k1["block_gather_sum"] == k0["block_gather_sum"]
    want = run(chain)
    assert k1["block_gather_sum"] < launch_counts()["block_gather_sum"]
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[2], want[2]))
    scale = want[1].float().abs().max().item()
    assert (got[1].float() - want[1].float()).abs().max().item() <= 4e-2 * scale


def test_flagship_train_step_launches_kernel_5_and_not_kernel_3(cuda_device):
    """A flagship bf16 train step (B=64) launches kernel 5's wgmma kernel once
    a layer (4 a step) and kernel 3 (block_gather_sum) not at all; the
    counter puts every mix backward on the fused path."""
    from spectre_tpu_torch.train.loop import build_step

    cfg = parse_config(FLAGSHIP)
    assert (cfg.compute_dtype, cfg.mix_block, cfg.num_heads) == ("bfloat16", 64, 16)
    state, step = build_step(cfg, cuda_device)
    xb, yb = synthetic_batch(cfg.dataset, 64)
    x, y = torch.from_numpy(xb).to(cuda_device), torch.from_numpy(yb).to(cuda_device)
    step(state, x, y)
    torch.cuda.synchronize()
    before, paths0 = launch_counts(), dict(FoldedMixLinear.forward_paths)
    step(state, x, y)
    torch.cuda.synchronize()
    delta = {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}
    layers = cfg.num_encoders
    assert delta["fused_block_bwd_wgmma"] == delta["fused_block_bwd"] == layers == 4
    assert "block_gather_sum" not in delta and "fused_block_bwd_grouped" not in delta
    assert FoldedMixLinear.forward_paths == dict(paths0, fused=paths0["fused"] + layers)


@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)])
@pytest.mark.parametrize("m,k,n", [(4160, 1536, 1536), (4160, 768, 2048), (195, 768, 1100),
                                   (33, 40, 1025), (520, 64, 4096), (260, 64, 8192),
                                   (65, 64, 8191), (130, 64, 12288)])
def test_fused_spectre_linear_bwd_wide_chain_matches_plain(cuda_device, dtype, rel, m, k, n):
    """The wide chain (a block a row; its columns of the row in a thread's
    registers up to N = 8,192, odd N one value a vector, beyond the reach
    the row walked) against the plain version with the limits of the
    one-warp chain, two runs bitwise."""
    args = _bwd_case(m, k, n, dtype, cuda_device, seed=m + n)
    n0 = fused_spectre_linear_bwd_wide.launches
    got = fused_spectre_linear_bwd(*args)
    assert fused_spectre_linear_bwd_wide.launches == n0 + 1
    for a, b in zip(got, fused_spectre_linear_bwd(*args)):
        assert torch.equal(a, b)
    want = fused_spectre_linear_bwd_plain(*args)
    for name, a, b in zip(("dx", "dw", "db", "dgamma", "dbeta"), got, want):
        assert a.dtype == b.dtype == dtype and a.shape == b.shape, name
        scale = b.float().abs().max().item()
        diff = (a.float() - b.float()).abs().max().item()
        assert diff <= rel * scale, (name, diff, scale)


@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)])
def test_fused_spectre_linear_bwd_wide_chain_takes_a_ragged_last_block(cuda_device, dtype, rel):
    """A grid whose last block owns fewer rows than the others (4,163 rows
    split into blocks of ``plan.rows``), against the plain version."""
    from spectre_tpu_torch.ops.kernels import fused_linear as fl

    m, k, n = 4163, 256, 1536
    args = _bwd_case(m, k, n, dtype, cuda_device, seed=7)
    dev = args[0].get_device()
    plan = fl.wide_chain_plan(dtype, m, n, 16, fl._sm_count(dev),
                              lambda *a: fl._wide_occupancy(dev, dtype, *a))
    assert plan.blocks * plan.rows > m > (plan.blocks - 1) * plan.rows
    got = fused_spectre_linear_bwd(*args)
    want = fused_spectre_linear_bwd_plain(*args)
    for name, a, b in zip(("dx", "dw", "db", "dgamma", "dbeta"), got, want):
        scale = b.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() <= rel * scale, name


def _bwd_case(m, k, n, dtype, device, seed=0):
    """x, w, gamma, beta of ``_linear_case`` with a saved h = x @ w + b and a
    cotangent g, in ``dtype`` on ``device``."""
    x, w, b, gamma, beta = _linear_case(m, k, n, seed)
    g = np.random.default_rng(seed + 1).standard_normal((m, n)).astype(np.float32)
    return [torch.from_numpy(a).to(device, dtype) for a in (x, w, gamma, beta, x @ w + b, g)]


# each gradient against the plain version, as a share of its largest entry.
# f32: the chain's sums (row statistics, column sums) in another order; bf16:
# dh and the column sums round once each on both paths, so single entries
# differ by one bf16 ulp (2^-8 to 2^-7 of the largest entry), and the
# products sum the same bf16 operands in float32 in another order
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)])
@pytest.mark.parametrize("m,k,n", [(1040, 512, 768), (1040, 768, 512), (33, 512, 100),
                                   (70, 64, 64), (9, 40, 24), (130, 96, 1024), (65, 24, 36)])
def test_fused_spectre_linear_bwd_kernel_matches_plain(cuda_device, dtype, rel, m, k, n):
    """16-byte vectors (N a multiple of 8 or 4), one value a lane (N = 100,
    36), ragged rows in a block (9, 33, 65), K == N (the residual in the
    product) and K != N."""
    args = _bwd_case(m, k, n, dtype, cuda_device, seed=m + n)
    n0 = fused_spectre_linear_bwd.launches
    got = fused_spectre_linear_bwd(*args)
    assert fused_spectre_linear_bwd.launches == n0 + 1
    want = fused_spectre_linear_bwd_plain(*args)
    for name, a, b in zip(("dx", "dw", "db", "dgamma", "dbeta"), got, want):
        assert a.dtype == b.dtype == dtype and a.shape == b.shape, name
        scale = b.float().abs().max().item()
        diff = (a.float() - b.float()).abs().max().item()
        assert diff <= rel * scale, (name, diff, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_spectre_linear_bwd_kernel_is_deterministic(cuda_device, dtype):
    """Two runs at a flagship layer's shape give the same bits: the column
    sums go through per-block partials added in a fixed order."""
    args = _bwd_case(65 * 64, 512, 768, dtype, cuda_device)
    first = fused_spectre_linear_bwd(*args)
    for a, b in zip(first, fused_spectre_linear_bwd(*args)):
        assert torch.equal(a, b)


def test_fused_spectre_linear_bwd_refuses_what_the_kernel_does_not_take(cuda_device):
    # N > 1,024 is no longer refused: the wide chain takes it
    x, w, gamma, beta, h, g = _bwd_case(8, 16, 1040, torch.float32, cuda_device)
    n0 = fused_spectre_linear_bwd_wide.launches
    fused_spectre_linear_bwd(x, w, gamma, beta, h, g)
    assert fused_spectre_linear_bwd_wide.launches == n0 + 1
    x, w, gamma, beta, h, g = _bwd_case(8, 16, 16, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        fused_spectre_linear_bwd(x, w, gamma, beta, h, g.t().contiguous().t())
    with pytest.raises(TypeError):
        fused_spectre_linear_bwd(x, w, gamma, beta, h.half(), g)


def test_small_model_on_the_card_matches_the_cpu(cuda_device):
    """The whole forward in f32 through both kernels against the CPU path
    (which the CPU tests hold to JAX), same seed, within 1e-4."""
    cfg = SimpleNamespace(model="spectre_vit", method="permut_mix", mix_impl="folded",
                          mix_block=8, img_size=8, patch_size=4, in_channels=3,
                          num_classes=10, embed_dim=16, num_encoders=2, num_heads=2,
                          hidden_dim=32, random_seed=0, compute_dtype="float32",
                          param_dtype="float32")
    x = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (8, 3, 8, 8))
                         .astype(np.float32))
    with torch.inference_mode():
        want = build_model(cfg, "cpu")(x)
        before = launch_counts()
        got = build_model(cfg, cuda_device)(x.to(cuda_device)).cpu()
        after = launch_counts()
    assert after["block_scatter_rows"] - before["block_scatter_rows"] == 2
    assert after["fused_spectre_linear"] - before["fused_spectre_linear"] == 5
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=0)


@pytest.mark.parametrize("mix_block", [8, 0])
def test_small_model_gradients_on_the_card_match_the_cpu(cuda_device, mix_block):
    """One backward in f32 through all kernels of the train path against the
    CPU path (which the CPU tests hold to JAX): every gradient within 1e-4
    of its largest entry; block tables take the block backward, uniform
    tables the row backward."""
    cfg = SimpleNamespace(model="spectre_vit", method="permut_mix", mix_impl="folded",
                          mix_block=mix_block, img_size=8, patch_size=4, in_channels=3,
                          num_classes=10, embed_dim=16, num_encoders=2, num_heads=2,
                          hidden_dim=32, random_seed=0, compute_dtype="float32",
                          param_dtype="float32", dropout=0.0)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.uniform(0, 1, (8, 3, 8, 8)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, 8))
    cpu, gpu = build_model(cfg, "cpu", train=True), build_model(cfg, cuda_device, train=True)
    torch.nn.functional.cross_entropy(cpu(x), y).backward()
    before = launch_counts()
    torch.nn.functional.cross_entropy(gpu(x.to(cuda_device)), y.to(cuda_device)).backward()
    after = launch_counts()
    delta = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert delta == {"block_scatter_rows": 2, "fused_spectre_linear": 5,
                     "fused_spectre_linear_cluster": 5, "fused_spectre_linear_bwd": 5,
                     "block_gather_sum" if mix_block else "inverse_gather_sum": 2}
    for (name, pc), pg in zip(cpu.named_parameters(), gpu.parameters()):
        scale = pc.grad.abs().max().item()
        assert (pg.grad.cpu() - pc.grad).abs().max().item() <= 1e-4 * scale, name


# as a share of the reference's largest entry. f32: the same float32 products
# summed in another order; bf16: the plain version rounds P * pm and dS to
# bf16 where the tensor-core kernel does, so what is left is the order of
# the float32 sums and the one rounding on store: one bf16 ulp of an entry
# (2^-8 to 2^-7 of it)
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)])
@pytest.mark.parametrize("use_pm", [False, True])
@pytest.mark.parametrize("shape", [(3, 4, 65, 32), (5, 2, 50, 16), (1, 1, 7, 8),
                                   (2, 2, 128, 32), (2, 3, 96, 64), (3, 2, 33, 24)])
def test_attention_kernels_match_plain(cuda_device, dtype, rel, use_pm, shape):
    """Forward (O and LSE) and backward against the plain versions, on
    strided [B, H, N, D] views of [B, N, H, D] memory: ragged rows and key
    columns, all three kernel instances (N <= 64 and N <= 96 at D <= 32, and
    the widest for the rest), 8 to 64 features."""
    b, h, n, d = shape
    rng = np.random.default_rng(n + d)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((b, n, h, d)).astype(np.float32))
                  .to(cuda_device, dtype).permute(0, 2, 1, 3) for _ in range(4))
    pm = None
    if use_pm:
        pm = torch.from_numpy(((rng.uniform(size=(n, n)) < 0.8) / 0.8).astype(np.float32)) \
            .to(cuda_device)
    n0 = launch_counts()
    o, lse = flash_attention_fwd(q, k, v, pm)
    dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, g, pm)
    torch.cuda.synchronize()
    n1 = launch_counts()
    assert n1["flash_attention_fwd"] == n0["flash_attention_fwd"] + 1
    assert n1["flash_attention_bwd"] == n0["flash_attention_bwd"] + 1
    o_p, lse_p = flash_attention_fwd_plain(q, k, v, pm)
    assert o.shape == q.shape and o.dtype == dtype and lse.shape == (b, h, n, 1)
    assert (lse - lse_p).abs().max().item() <= 1e-5
    pairs = [(o, o_p)] + list(zip((dq, dk, dv), flash_attention_bwd_plain(q, k, v, o, lse, g, pm)))
    for name, (got, want) in zip(("o", "dq", "dk", "dv"), pairs):
        scale = want.float().abs().max().item()
        assert (got.float() - want.float()).abs().max().item() <= rel * scale, name


def _attention_case(shape, device, seed=0, use_pm=True):
    b, h, n, d = shape
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((b, n, h, d)).astype(np.float32))
                  .to(device, torch.bfloat16).permute(0, 2, 1, 3) for _ in range(4))
    pm = torch.from_numpy(((rng.uniform(size=(n, n)) < 0.8) / 0.8).astype(np.float32)) \
        .to(device) if use_pm else None
    return q, k, v, g, pm


@pytest.mark.parametrize("use_pm", [False, True])
def test_attention_bf16_kernels_take_the_widest_block(cuda_device, use_pm):
    """[2, 2, 128, 64] in bf16: the tensor-core backward holds it in 140 KB
    of shared memory (the float32 kernel refuses it, below)."""
    q, k, v, g, pm = _attention_case((2, 2, 128, 64), cuda_device, seed=3, use_pm=use_pm)
    o, lse = flash_attention_fwd(q, k, v, pm)
    grads = flash_attention_bwd(q, k, v, o, lse, g, pm)
    torch.cuda.synchronize()
    o_p, lse_p = flash_attention_fwd_plain(q, k, v, pm)
    assert (lse - lse_p).abs().max().item() <= 1e-5
    pairs = [(o, o_p)] + list(zip(grads, flash_attention_bwd_plain(q, k, v, o, lse, g, pm)))
    for name, (got, want) in zip(("o", "dq", "dk", "dv"), pairs):
        scale = want.float().abs().max().item()
        assert (got.float() - want.float()).abs().max().item() <= 2.0 ** -7 * scale, name


@pytest.mark.parametrize("shape", [(256, 16, 65, 32), (3, 2, 33, 24)])
def test_attention_bf16_kernels_are_bitwise_repeatable(cuda_device, shape):
    """No atomics: two runs of the forward, and two of the backward, are
    bitwise equal."""
    q, k, v, g, pm = _attention_case(shape, cuda_device, seed=4)
    o, lse = flash_attention_fwd(q, k, v, pm)
    o1, lse1 = flash_attention_fwd(q, k, v, pm)
    assert torch.equal(o, o1) and torch.equal(lse, lse1)
    first = flash_attention_bwd(q, k, v, o, lse, g, pm)
    again = flash_attention_bwd(q, k, v, o, lse, g, pm)
    for name, x, y in zip(("dq", "dk", "dv"), first, again):
        assert torch.equal(x, y), name


def test_attention_function_on_the_card_matches_autograd_of_plain(cuda_device):
    b, h, n, d = 4, 4, 65, 32
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(4)]
    a = [torch.from_numpy(t).to(cuda_device).requires_grad_() for t in arrays[:3]]
    p = [torch.from_numpy(t).to(cuda_device).requires_grad_() for t in arrays[:3]]
    w = torch.from_numpy(arrays[3]).to(cuda_device)
    (flash_attention(*a) * w).sum().backward()
    (flash_attention_plain(*p) * w).sum().backward()
    for ta, tp in zip(a, p):
        scale = tp.grad.abs().max().item()
        assert (ta.grad - tp.grad).abs().max().item() <= 1e-5 * scale
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.zeros(1, 1, 128, 64, device=cuda_device)
        flash_attention_fwd(big, big, big)
    # no fallback for rows the loader's 16-byte vectors cannot take
    odd = torch.zeros(1, 1, 7, 12, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_fwd(odd, odd, odd)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fwht_kernel_is_bitwise_the_plain_butterfly(cuda_device, dtype):
    """Every power of two from 1 to 32,768, row counts that leave a ragged
    last chunk, normalised and not, a base that is not 16-byte aligned, and
    another axis through ops.hadamard.fwht."""
    rng = np.random.default_rng(0)
    for n in (1, 2, 4, 8, 16, 64, 128, 512, 1024, 2048, 4096, 32768):
        for m in (1, 3, 130):
            x = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32)) \
                .to(cuda_device, dtype)
            for normalize in (True, False):
                n0 = fwht.launches
                got = fwht(x, normalize)
                assert fwht.launches == n0 + 1
                assert torch.equal(got, fwht_plain(x, normalize)), (n, m, normalize)
    flat = torch.from_numpy(rng.standard_normal(1 + 5 * 64).astype(np.float32)) \
        .to(cuda_device, dtype)
    odd = flat[1:].view(5, 64)
    assert torch.equal(fwht(odd), fwht_plain(odd))
    x3 = torch.from_numpy(rng.standard_normal((16, 3, 5)).astype(np.float32)) \
        .to(cuda_device, dtype).requires_grad_()
    y = fwht_any_axis(x3, axis=0)
    assert torch.equal(y.detach(), fwht_plain(x3.detach().movedim(0, -1)).movedim(-1, 0))
    (y.float() ** 2).sum().backward()
    assert x3.grad.shape == x3.shape and torch.isfinite(x3.grad).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [2 ** p for p in range(1, 16)])
def test_fwht_kernel_is_bitwise_the_plain_butterfly_at_every_length(cuda_device, dtype, n):
    """n = 2 ... 32,768, both designs (a warp a tile up to 1,024, a block a
    row above): whole tiles, a ragged last tile, one row, and a base that is
    not 16-byte aligned."""
    rng = np.random.default_rng(n)
    m = max(1, 4096 // n) * 33 + 1
    flat = torch.from_numpy(rng.standard_normal(1 + m * n).astype(np.float32)) \
        .to(cuda_device, dtype)
    for x in (flat[:m * n].view(m, n), flat[:n].view(1, n), flat[1:].view(m, n)):
        assert torch.equal(fwht(x), fwht_plain(x)), (n, x.shape, x.data_ptr() % 16)
        assert torch.equal(fwht(x, False), fwht_plain(x, False))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_structured_mix_kernels_are_bitwise_the_plain_versions(cuda_device, dtype):
    """Forward and backward at every tile size from 1 to 256, batches that
    are no multiple of anything, and through the autograd Function."""
    rng = np.random.default_rng(0)
    for b, h, n_tiles, t in ((3, 2, 5, 16), (5, 3, 6, 4), (2, 2, 3, 1), (4, 2, 2, 256),
                             (7, 3, 4, 2), (9, 2, 3, 8), (33, 4, 7, 128), (250, 2, 9, 64)):
        d = n_tiles * t
        tp = torch.from_numpy(np.stack([rng.permutation(n_tiles) for _ in range(h)])
                              .astype(np.int32)).to(cuda_device)
        sg = torch.from_numpy(rng.choice([-1.0, 1.0], (1, h, d)).astype(np.float32)) \
            .to(cuda_device)
        x = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32)) \
            .to(cuda_device, dtype)
        g = torch.from_numpy(rng.standard_normal((b, h * d)).astype(np.float32)) \
            .to(cuda_device, dtype)
        n0 = launch_counts()
        got = structured_mix(x, tp, sg, 1)
        got_b = structured_mix_bwd(g, tp, sg)
        n1 = launch_counts()
        assert n1["structured_mix"] == n0["structured_mix"] + 1
        assert n1["structured_mix_bwd"] == n0["structured_mix_bwd"] + 1
        assert torch.equal(got, structured_mix_plain(x, tp, sg, 1)), (b, h, n_tiles, t)
        assert torch.equal(got_b, structured_mix_bwd_plain(g, tp, sg)), (b, h, n_tiles, t)
        xr = x.detach().clone().requires_grad_()
        structured_mix_grad(xr, tp, sg, 1).backward(g.view(b, 1, -1))
        assert torch.equal(xr.grad, got_b)


@pytest.mark.parametrize("over", [dict(model="vit", method="attention", embed_dim=32,
                                       num_heads=4, hidden_dim=48),
                                  dict(mix_impl="structured"), dict(mix_impl="gather"),
                                  dict(method="attention")],
                         ids=lambda o: "-".join(map(str, o.values())))
def test_other_families_on_the_card_match_the_cpu(cuda_device, over):
    """Logits and every gradient in f32 through the kernels against the CPU
    path (which the CPU tests hold to JAX), same seed: within 1e-4 (of each
    gradient's largest entry, floored at 1e-3 of the largest of all: the
    attention's key bias has a zero gradient)."""
    cfg = SimpleNamespace(**(dict(
        model="spectre_vit", method="permut_mix", mix_impl="folded", mix_block=8, img_size=8,
        patch_size=4, in_channels=3, num_classes=10, embed_dim=16, num_encoders=2, num_heads=2,
        hidden_dim=32, random_seed=0, compute_dtype="float32", param_dtype="float32",
        dropout=0.0) | over))
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.uniform(0, 1, (8, 3, 8, 8)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, 8))
    cpu, gpu = build_model(cfg, "cpu", train=True), build_model(cfg, cuda_device, train=True)
    out_c = cpu(x)
    torch.nn.functional.cross_entropy(out_c, y).backward()
    before = launch_counts()
    out_g = gpu(x.to(cuda_device))
    torch.nn.functional.cross_entropy(out_g, y.to(cuda_device)).backward()
    after = launch_counts()
    assert sum(after.values()) > sum(before.values())
    np.testing.assert_allclose(out_g.detach().cpu().numpy(), out_c.detach().numpy(), atol=1e-4,
                               rtol=0)
    floor = 1e-3 * max(p.grad.abs().max().item() for p in cpu.parameters())
    for (name, pc), pg in zip(cpu.named_parameters(), gpu.parameters()):
        scale = max(pc.grad.abs().max().item(), floor)
        assert (pg.grad.cpu() - pc.grad).abs().max().item() <= 1e-4 * scale, name


@pytest.mark.parametrize("prefetch", [1, 2, 3])
def test_prefetch_queue_on_the_card_yields_the_batches_of_plain_iteration(cuda_device, prefetch):
    """Pinned slots are reused many times over (40 batches through 1 to 3
    slots): a buffer written again before its copy had finished would show as
    a batch that differs from plain iteration."""
    x, y = synthetic_dataset("cifar100", "train")
    make = lambda: BatchIterator(x, y, 100, shuffle=True, seed=2)  # noqa: E731
    plain = list(make())
    assert len(plain) == 40
    seen = 0
    for got, want in zip(prefetch_to_device(make(), cuda_device, prefetch=prefetch), plain,
                         strict=True):
        assert got["image"].device.type == "cuda" and got["valid"] == want["valid"]
        torch.matmul(got["image"], got["image"].transpose(-1, -2))  # work the copies overlap
        for k in ("image", "label", "mask", "index"):
            assert np.array_equal(got[k].cpu().numpy(), want[k]), (seen, k)
        seen += 1
    assert seen == 40


def _route_case(h, d, c, seed, cache_dir):
    """Uniform permutations [H, d], their inverses and route tables with c
    columns; the tables int32 on the card."""
    rng = np.random.default_rng(seed)
    inv = np.argsort(np.stack([rng.permutation(d) for _ in range(h)]), axis=1).astype(np.int32)
    rt = build_route_tables_cached(inv, c, cache_dir=str(cache_dir))
    tables = [torch.from_numpy(t).cuda() for t in (rt.a_idx, rt.b_idx, rt.c_idx)]
    return torch.from_numpy(inv).cuda(), tables


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_routed_gather_kernel_is_bitwise_the_plain_chain(cuda_device, dtype, tmp_path):
    """Kernel B9 and its plain version add the same values in head order,
    rounding to the data type after every head, so they agree bit for bit:
    the flagship mix shape (H=16, d=33,280, c=128) at B=256 and B=250, c=8,
    rows that are no whole 16-byte vector (element units), a source whose
    base is not 16-byte aligned, more heads than one batch of loads in
    flight. In f32 the chain is kernel 4's float32 sum: bitwise equal too."""
    rng = np.random.default_rng(0)
    for h, d, c, b, offset in ((16, 33_280, 128, 256, 0), (16, 33_280, 128, 250, 0),
                               (4, 256, 8, 16, 0), (3, 544, 32, 3, 0), (11, 1040, 16, 8, 0),
                               (4, 256, 128, 130, 0), (2, 520, 8, 64, 1), (9, 64, 8, 1, 0)):
        inv, tables = _route_case(h, d, c, h + d + c, tmp_path)
        flat = torch.from_numpy(rng.standard_normal(offset + h * d * b).astype(np.float32))
        g = flat.to(cuda_device, dtype)[offset:].view(h * d, b)
        n0 = launch_counts()
        got = routed_gather_sum(g, *tables)
        n1 = launch_counts()
        assert n1["routed_gather_sum"] == n0["routed_gather_sum"] + 1
        assert sum(n1.values()) == sum(n0.values()) + 1
        assert torch.equal(got, routed_gather_sum_plain(g, *tables)), (h, d, c, b, offset)
        if dtype == torch.float32:
            assert torch.equal(got, inverse_gather_sum_plain(g, inv)), (h, d, c, b, offset)


def test_routed_gather_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device, tmp_path):
    _, tables = _route_case(2, 64, 8, 0, tmp_path)
    g = torch.zeros(2 * 64, 4, device=cuda_device)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        routed_gather_sum(g.half(), *tables)
    with pytest.raises(TypeError, match="int32"):
        routed_gather_sum(g, tables[0].long(), *tables[1:])
    with pytest.raises(ValueError, match="on cpu"):
        routed_gather_sum(g, tables[0], tables[1].cpu(), tables[2])
    with pytest.raises(ValueError, match="contiguous"):
        routed_gather_sum(torch.zeros(4, 2 * 64, device=cuda_device).t(), *tables)
    with pytest.raises(ValueError, match="rows"):
        routed_gather_sum(g[:-1], *tables)


def test_small_routed_model_gradients_on_the_card_match_the_cpu(cuda_device):
    """One backward in f32 with the Clos-routed mix backward (impl "pallas":
    kernel B9 on the card) against the same on the CPU: every gradient
    within 1e-4 of its largest entry; B9 replaces the block backward."""
    cfg = SimpleNamespace(model="spectre_vit", method="permut_mix", mix_impl="folded",
                          mix_block=8, img_size=8, patch_size=4, in_channels=3,
                          num_classes=10, embed_dim=16, num_encoders=2, num_heads=2,
                          hidden_dim=32, random_seed=0, compute_dtype="float32",
                          param_dtype="float32", dropout=0.0)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.uniform(0, 1, (8, 3, 8, 8)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, 8))
    cpu, gpu = build_model(cfg, "cpu", train=True), build_model(cfg, cuda_device, train=True)
    assert register_mix_routes(cpu, "pallas") == register_mix_routes(gpu, "pallas") == 2
    torch.nn.functional.cross_entropy(cpu(x), y).backward()
    before = launch_counts()
    torch.nn.functional.cross_entropy(gpu(x.to(cuda_device)), y.to(cuda_device)).backward()
    after = launch_counts()
    delta = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert delta == {"block_scatter_rows": 2, "fused_spectre_linear": 5,
                     "fused_spectre_linear_cluster": 5, "fused_spectre_linear_bwd": 5, "routed_gather_sum": 2}
    for (name, pc), pg in zip(cpu.named_parameters(), gpu.parameters()):
        scale = pc.grad.abs().max().item()
        assert (pg.grad.cpu() - pc.grad).abs().max().item() <= 1e-4 * scale, name


def test_small_branch_on_the_card_matches_the_cpu(cuda_device):
    """SpectreBranch in f32 (convolutions with TF32 off) against the CPU
    path: logits within 1e-4; the folded mix runs kernel 1 forward, and no
    SpectreLinear kernel (the branch's layers are plain Denses)."""
    torch.backends.cudnn.allow_tf32 = False
    cfg = SimpleNamespace(model="spectre_branch", method="permut_mix", mix_impl="folded",
                          img_size=16, patch_size=4, in_channels=3, num_classes=10,
                          embed_dim=24, num_encoders=2, num_heads=2, hidden_dim=16,
                          random_seed=0, compute_dtype="float32", param_dtype="float32")
    x = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (8, 3, 16, 16))
                         .astype(np.float32))
    with torch.inference_mode():
        want = build_model(cfg, "cpu")(x)
        before = launch_counts()
        got = build_model(cfg, cuda_device)(x.to(cuda_device)).cpu()
        after = launch_counts()
    delta = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert delta == {"block_scatter_rows": 2}
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=0)


def test_small_distill_on_the_card_matches_the_cpu(cuda_device):
    """A tiny teacher's view and logits, and one distill step of a tiny
    student on them, in f32 on the card against the CPU: logits within
    1e-4, the step's loss, KD and CE within 1e-4."""
    from spectre_tpu_torch.distill import load_teacher, make_teacher_view
    from spectre_tpu_torch.train import create_train_state, make_distill_step, make_optimizer

    cfg = SimpleNamespace(model="spectre_vit", method="permut_mix", mix_impl="folded",
                          mix_block=8, img_size=8, patch_size=4, in_channels=3,
                          num_classes=10, embed_dim=16, num_encoders=2, num_heads=2,
                          hidden_dim=32, random_seed=0, compute_dtype="float32",
                          param_dtype="float32", dropout=0.0, epochs=1, learning_rate=1e-3)
    rng = np.random.default_rng(2)
    raw = torch.from_numpy(rng.uniform(0, 1, (8, 3, 8, 8)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, 8))
    metrics = {}
    for dev in ("cpu", cuda_device):
        teacher = load_teacher(10, img_size=32, seed=1, embed_dim=32, depth=2, num_heads=2,
                               num_registers=2, device=dev)
        with torch.inference_mode():
            logits = teacher(make_teacher_view(32)(raw.to(dev))).clone()
        model = build_model(cfg, dev, train=True)
        state = create_train_state(model, *make_optimizer(cfg, model.parameters(), 4), seed=0)
        m = make_distill_step()(state, raw.to(dev), logits, y.to(dev))
        metrics[str(dev)] = (logits.cpu(), {k: float(v) for k, v in m.items()})
    (lc, mc), (lg, mg) = metrics["cpu"], metrics[str(cuda_device)]
    np.testing.assert_allclose(lg.numpy(), lc.numpy(), atol=1e-4, rtol=0)
    for k in ("loss", "loss_dist", "loss_ce"):
        assert abs(mg[k] - mc[k]) <= 1e-4, k


@pytest.mark.parametrize("over,ops", [
    (dict(mix_impl="folded", mix_block=8), {"block_scatter_rows": 2}),
    (dict(mix_impl="structured"), {"structured_mix": 2}),
    (dict(model="vit", method="attention"), {"flash_attention_fwd": 2}),
])
def test_exported_program_on_the_card_launches_the_kernels(cuda_device, tmp_path, over, ops):
    """A small model exported on the card (f32), saved and loaded: one call
    of the loaded program launches each kernel of the eval forward as many
    times as the eager forward does, and its logits are within 1e-5 of the
    live model's and within 1e-4 of the CPU's."""
    from spectre_tpu_torch.export import export_forward, exported_module, load_exported, \
        save_exported

    cfg = SimpleNamespace(model="spectre_vit", method="permut_mix", img_size=8, patch_size=4,
                          in_channels=3, num_classes=10, embed_dim=16, num_encoders=2,
                          num_heads=2, hidden_dim=32, random_seed=0, compute_dtype="float32",
                          param_dtype="float32", dropout=0.0)
    for k, v in over.items():
        setattr(cfg, k, v)
    x = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (4, 3, 8, 8))
                         .astype(np.float32))
    model = build_model(cfg, cuda_device)
    with torch.no_grad():
        before = launch_counts()
        live = model(x.to(cuda_device))
        eager = {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}
    path = save_exported(export_forward(model, x.to(cuda_device)), str(tmp_path / "m.pt2"))
    program = load_exported(path)
    before = launch_counts()
    got = exported_module(program)(x.to(cuda_device))
    torch.cuda.synchronize()
    delta = {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}
    assert delta == eager
    assert all(delta.get(k) == n for k, n in ops.items()), delta
    np.testing.assert_allclose(got.cpu().numpy(), live.cpu().numpy(), atol=1e-5, rtol=0)
    with torch.no_grad():
        cpu = build_model(cfg, "cpu")(x)
    np.testing.assert_allclose(got.cpu().numpy(), cpu.numpy(), atol=1e-4, rtol=0)


def test_server_on_the_card_answers_around_buckets_that_fail(cuda_device):
    """Buckets of one shape through the pinned staging buffers, every third
    one's forward raising after its upload: its request gets the error, the
    others exactly their own rows (no staging buffer rewritten under a copy
    still pending)."""
    import threading
    from concurrent.futures import Future

    from spectre_tpu_torch.serving import TorchServer

    def forward(x):
        if bool((x[:, 0, 0, 0] < 0).any()):
            raise RuntimeError("bad bucket")
        return x.reshape(x.shape[0], -1)[:, :4] * 2

    srv = TorchServer(forward, (3, 8, 8), cuda_device, max_batch=2)
    rng = np.random.default_rng(11)
    jobs = []
    for i in range(30):
        x = rng.uniform(0, 1, (2, 3, 8, 8)).astype(np.float32)
        if i % 3 == 1:
            x[0, 0, 0, 0] = -1
        jobs.append((x, Future()))
        srv._jobs.put(jobs[-1])
    t = threading.Thread(target=srv._batcher_loop, daemon=True)
    t.start()
    for i, (x, f) in enumerate(jobs):
        if i % 3 == 1:
            with pytest.raises(RuntimeError, match="bad bucket"):
                f.result(timeout=60)
        else:
            np.testing.assert_array_equal(f.result(timeout=60), x.reshape(2, -1)[:, :4] * 2)
    srv._jobs.put(None)
    t.join(timeout=60)
    assert srv.forwards == 20


@pytest.mark.parametrize("m,k,n,offset", [(m, k, n, 0.0) for m, k in ((129, 72), (16575, 512))
                                          for n in (8, 64, 136, 192, 256, 384, 512, 768)]
                         + [(129, 72, n, 0.0) for n in (16, 24, 32, 40, 48, 56, 200, 392, 632)]
                         + [(1, 8, 8, 0.0), (63, 768, 136, 0.0), (66560, 512, 384, 0.0)]
                         + [(129, 72, n, 1e3) for n in (8, 40, 136, 392)])
def test_shard_stats_kernel_equals_plain(cuda_device, m, k, n, offset):
    """Kernel B3's entry 1 in bf16 on its own kernel at the plan test's
    shapes (tests/test_torch_tp_stats_plan.py: column tiles of 192, a width
    ending off a 64-column box, every remainder of 8 to 56, ragged and
    single rows, K of 8 to 768), the flagship's B = 1,024 shard, and h
    about 1,000 (bias ``offset``), where the statistics hold the limit only
    if each column tile's shift is one of its rows' own values (a shift of 0
    would lose the spread of about 1 in float32's cancellation): h and
    (mean, M2) against the plain version within 2^-6 of each result's
    largest entry (h is rounded to bf16 once on both paths, the float32
    sums run in another order), two runs bit for bit, one launch a call
    counted in the wrapper and the kernel and none in kernel 2's forwards."""
    from spectre_tpu_torch.ops.kernels import (fused_spectre_linear_shard_stats,
                                               shard_stats_kernel, shard_stats_plain)

    gen = torch.Generator().manual_seed(m + k + n)
    x = torch.randn(m, k, generator=gen).to(cuda_device, torch.bfloat16)
    w = (torch.randn(k, n, generator=gen) * k ** -0.5).to(cuda_device, torch.bfloat16)
    b = (offset + 0.1 * torch.randn(n, generator=gen)).to(cuda_device, torch.bfloat16)
    assert shard_stats_kernel(torch.bfloat16, k, n) == "fused_spectre_linear_shard_stats_wgmma"
    before = dict(launch_counts())
    h, st = fused_spectre_linear_shard_stats(x, w, b)
    hp, sp = shard_stats_plain(x, w, b)
    for got, want in ((h, hp), (st[:, 0], sp[:, 0]), (st[:, 1], sp[:, 1])):
        got, want = got.float(), want.float()
        assert float((got - want).abs().max()) <= 2.0 ** -6 * float(want.abs().max())
    again = fused_spectre_linear_shard_stats(x, w, b)
    assert torch.equal(h, again[0]) and torch.equal(st, again[1])
    counts = launch_counts()
    for name, calls in (("fused_spectre_linear_shard_stats", 2),
                        ("fused_spectre_linear_shard_stats_wgmma", 2),
                        ("fused_spectre_linear_wgmma", 0), ("fused_spectre_linear_cluster", 0)):
        assert counts[name] - before[name] == calls, name


@pytest.mark.parametrize("m,n,size", [(130, 25, 4), (130, 50, 2), (1, 7, 2), (16640, 384, 2),
                                      (16640, 192, 4), (333, 1536, 2), (65, 29056, 2),
                                      (65, 58111, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chain_shard_entries_equal_plain(cuda_device, m, n, size, dtype):
    """Kernel B3's entries 3 and 4 at every route of ``shard_chain_plan``:
    the flagship's shards, ragged widths (single values, lanes past n
    masked), one value a row, and rows cut into tiles (1,536, 29,056 and
    an odd 58,111 columns): the row sums, dgamma, dbeta, dh and db against
    the plain versions on the same inputs, with the other ranks' row sums
    drawn (f32: 1e-5 of each result's largest entry; bf16: 2^-6, one
    rounding of the sums or dh apart), two runs bit for bit."""
    from spectre_tpu_torch.ops.kernels import (chain_shard_dh, chain_shard_dh_plain,
                                               chain_shard_sums, chain_shard_sums_plain)

    gen = torch.Generator().manual_seed(m + n)
    h = torch.randn(m, n, generator=gen).to(cuda_device, dtype)
    g = torch.randn(m, n, generator=gen).to(cuda_device, dtype)
    gamma = (1 + 0.1 * torch.randn(n, generator=gen)).to(cuda_device, dtype)
    beta = (0.1 * torch.randn(n, generator=gen)).to(cuda_device, dtype)
    mstats = torch.stack([0.1 * torch.randn(m, generator=gen),
                          1 + 0.1 * torch.rand(m, generator=gen)], -1).to(cuda_device)
    others = 0.5 * torch.randn(size - 1, m, 2, generator=gen).to(cuda_device)
    limit = 1e-5 if dtype == torch.float32 else 2.0 ** -6

    def close(a, b):
        a, b = a.float(), b.float()
        assert float((a - b).abs().max()) <= limit * max(float(b.abs().max()), 1e-30)

    before = dict(launch_counts())
    rows, sums = chain_shard_sums(h, g, gamma, beta, mstats)
    rows_p, sums_p = chain_shard_sums_plain(h, g, gamma, beta, mstats)
    close(rows, rows_p)
    close(sums, sums_p)
    gathered = torch.cat([rows[None], others])
    dh, db = chain_shard_dh(h, g, gamma, beta, mstats, gathered, size * n)
    dh_p, db_p = chain_shard_dh_plain(h, g, gamma, beta, mstats, gathered, size * n)
    close(dh, dh_p)
    close(db, db_p)
    again = (*chain_shard_sums(h, g, gamma, beta, mstats),
             *chain_shard_dh(h, g, gamma, beta, mstats, gathered, size * n))
    assert all(torch.equal(a, b) for a, b in zip((rows, sums, dh, db), again))
    counts = launch_counts()
    assert counts["chain_shard_sums"] - before["chain_shard_sums"] == 2
    assert counts["chain_shard_dh"] - before["chain_shard_dh"] == 2


@pytest.mark.parametrize("m,n,size,whole", [(16640, 384, 2, False), (16640, 192, 4, False),
                                            (130, 25, 4, False), (130, 50, 2, False),
                                            (333, 1536, 2, False), (16640, 512, 1, True),
                                            (4160, 1536, 1, True), (130, 100, 1, True),
                                            (65, 4100, 1, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sharded_ln_gelu_equals_plain(cuda_device, m, n, size, whole, dtype):
    """Kernel B3's entry 2 at the routes of ``shard_ln_plan``: column shards
    (the flagship's 384 and 192 columns, ragged 25 and 50, a shard of 1,536
    in tiles) with the other ranks' statistics drawn and the residual a
    strided view of the pool, and linear3's whole float32 rows (512; 1,536
    on three warps of a block; 100 on a team of 8 lanes; 4,100 walked),
    h and the residual the halves of one [M, 2n] sum. out and the merged
    (mean, rstd) against the plain version on the same inputs (f32: 1e-5 of
    each result's largest entry; bf16: 2^-6, one rounding of out apart);
    the saved h bit for bit (one rounding of h + bias on both); two runs bit
    for bit; one launch a call."""
    from spectre_tpu_torch.ops.kernels import sharded_ln_gelu, sharded_ln_gelu_plain
    from spectre_tpu_torch.ops.kernels.fused_linear import _row_stats

    gen = torch.Generator().manual_seed(m + n + size)
    gamma = (1 + 0.1 * torch.randn(n, generator=gen)).to(cuda_device, dtype)
    beta = (0.1 * torch.randn(n, generator=gen)).to(cuda_device, dtype)
    if whole:
        s = (2.0 + torch.randn(m, 2 * n, generator=gen)).to(cuda_device)
        h, res, stats = s[:, :n], s[:, n:], None
        bias = (0.1 * torch.randn(n, generator=gen)).to(cuda_device, dtype)
    else:
        pool = torch.randn(m, size * n, generator=gen).to(cuda_device, dtype)
        h = (2.0 + torch.randn(m, n, generator=gen)).to(cuda_device, dtype)
        res, bias = pool[:, (size - 1) * n:], None
        others = torch.stack([0.5 * torch.randn(size - 1, m, generator=gen),
                              n * (0.5 + torch.rand(size - 1, m, generator=gen))], -1)
        stats = torch.cat([_row_stats(h.float())[None], others.to(cuda_device)])
    args = (h, stats, gamma, beta, size * n, bias, res)
    limit = 1e-5 if dtype == torch.float32 else 2.0 ** -6

    def close(a, b):
        a, b = a.float(), b.float()
        assert float((a - b).abs().max()) <= limit * max(float(b.abs().max()), 1e-30)

    before = launch_counts()["sharded_ln_gelu"]
    out, mstats, saved = sharded_ln_gelu(*args)
    out_p, mstats_p, saved_p = sharded_ln_gelu_plain(*args)
    close(out, out_p)
    close(mstats[:, 0], mstats_p[:, 0])
    close(mstats[:, 1], mstats_p[:, 1])
    assert (saved is None) == (saved_p is None) == (not whole)
    if whole:
        assert torch.equal(saved, saved_p)
    again = sharded_ln_gelu(*args)
    assert all(torch.equal(a, b) for a, b in zip((out, mstats, saved), again) if a is not None)
    assert launch_counts()["sharded_ln_gelu"] - before == 2


@pytest.mark.parametrize("m,n,size,h_dtype,dtype", [
    (130, 101, 1, torch.bfloat16, torch.bfloat16), (4160, 512, 1, torch.bfloat16, torch.bfloat16),
    (65, 4100, 1, torch.bfloat16, torch.bfloat16), (4160, 384, 2, torch.float32, torch.bfloat16),
    (130, 25, 4, torch.float32, torch.bfloat16)])
def test_sharded_ln_gelu_takes_every_dtype_pair(cuda_device, m, n, size, h_dtype, dtype):
    """Entry 2's other (h, gamma) dtype pairs: whole rows of h in bf16 (an
    odd width on single values, 512, 4,100 walked) and float32 shards under
    bf16 parameters, against the plain version (2^-6 of the largest entry),
    the saved h bit for bit."""
    from spectre_tpu_torch.ops.kernels import sharded_ln_gelu, sharded_ln_gelu_plain

    gen = torch.Generator().manual_seed(m + n)
    gamma = (1 + 0.1 * torch.randn(n, generator=gen)).to(cuda_device, dtype)
    beta = (0.1 * torch.randn(n, generator=gen)).to(cuda_device, dtype)
    h = (2.0 + torch.randn(m, n, generator=gen)).to(cuda_device, h_dtype)
    res = torch.randn(m, n, generator=gen).to(cuda_device, h_dtype)
    if size == 1:
        stats, bias = None, (0.1 * torch.randn(n, generator=gen)).to(cuda_device, dtype)
    else:
        stats = torch.stack([0.5 * torch.randn(size, m, generator=gen),
                             n * (0.5 + torch.rand(size, m, generator=gen))], -1).to(cuda_device)
        bias = None
    args = (h, stats, gamma, beta, size * n, bias, res)
    got, want = sharded_ln_gelu(*args), sharded_ln_gelu_plain(*args)
    for a, b in zip(got[:2], want[:2]):
        a, b = a.float(), b.float()
        assert float((a - b).abs().max()) <= 2.0 ** -6 * float(b.abs().max())
    assert (got[2] is None and want[2] is None) or torch.equal(got[2], want[2])


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_spectre_linears_launch_the_shard_entries(cuda_device, size, dtype):
    """The two split SpectreLinear Functions of parallel/tp.py on in-process
    shards (``LocalRanks``: a thread a rank, no process group), a column
    split linear1 feeding a row split linear3 at the flagship's widths and
    64 rows: each rank's forward and backward launch kernel B3's four shard
    entries (entry 1 on ``shard_stats_kernel``'s route) and the row split's
    backward chain, and the outputs and gradients equal the same ranks on
    the CPU, where the entries run their plain versions. f32: 1e-5 of each
    result's largest entry; bf16: 2^-6 (one bf16 rounding of dh or h moves
    the products that follow)."""
    from spectre_tpu_torch.ops import adaptive_pool_matrix
    from spectre_tpu_torch.ops.kernels import reset_launch_counts, shard_stats_kernel
    from spectre_tpu_torch.parallel.tp import LocalRanks, column_spectre_linear, \
        row_spectre_linear

    e, f, m = 512, 768, 64
    gen = torch.Generator().manual_seed(size)
    x = torch.randn(2, m // 2, e, generator=gen)
    params = [torch.randn(e, f, generator=gen) * e ** -0.5, torch.randn(f, generator=gen) * 0.1,
              1 + torch.randn(f, generator=gen) * 0.1, torch.randn(f, generator=gen) * 0.1,
              torch.randn(f, e, generator=gen) * f ** -0.5, torch.randn(e, generator=gen) * 0.1,
              1 + torch.randn(e, generator=gen) * 0.1, torch.randn(e, generator=gen) * 0.1]
    gy = torch.randn(2, m // 2, e, generator=gen)
    n = f // size

    def ranks(device):
        local = LocalRanks(size)
        p1 = adaptive_pool_matrix(e, f, dtype, device)
        p3 = adaptive_pool_matrix(f, e, dtype, device)

        def rank(r):
            c = slice(r * n, (r + 1) * n)
            xr = x.to(device, dtype).requires_grad_()
            w1, b1, g1, be1 = (t[..., c].contiguous().to(device, dtype).requires_grad_()
                               for t in params[:4])
            w3 = params[4][c].contiguous().to(device, dtype).requires_grad_()
            b3, g3, be3 = (t.to(device, dtype).requires_grad_() for t in params[5:])
            h1 = column_spectre_linear(xr, w1, b1, g1, be1, xr @ p1[:, c], local.gather(r))
            out = row_spectre_linear(h1, w3, b3, g3, be3, local.reduce(r),
                                     pool=p3[c].contiguous())
            g3s = out.grad_fn.apply(gy.to(device, dtype))
            dh1 = g3s[0]
            g1s = h1.grad_fn.apply(dh1.view_as(h1))
            return [out, dh1, *g1s[:5], *g3s[1:5]]

        return local.run(rank)

    reset_launch_counts()
    got = ranks(cuda_device)
    torch.cuda.synchronize()
    counts = launch_counts()
    route = shard_stats_kernel(dtype, e, n)
    assert route == ("fused_spectre_linear_shard_stats_wgmma" if dtype == torch.bfloat16
                     else "fused_spectre_linear_cluster")
    assert counts["fused_spectre_linear_shard_stats"] == counts[route] == size
    assert counts["sharded_ln_gelu"] == 2 * size  # linear1's shards and linear3's rows
    assert counts["chain_shard_sums"] == counts["chain_shard_dh"] == size
    assert counts["fused_spectre_linear_bwd"] == size  # linear3's chain on local operands
    want = ranks("cpu")
    limit = 1e-5 if dtype == torch.float32 else 2.0 ** -6
    names = ("out", "dh1", "dx", "dw1", "db1", "dgamma1", "dbeta1", "dw3", "db3", "dgamma3",
             "dbeta3")
    for r in range(size):
        for name, a, b in zip(names, got[r], want[r]):
            a, b = a.detach().float().cpu(), b.detach().float()
            err = float((a - b).abs().max())
            assert err <= limit * float(b.abs().max()), (r, name, err)
