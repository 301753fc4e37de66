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

from spectre_tpu_torch.models import build_model
from spectre_tpu_torch.ops.kernels import (
    block_gather_sum,
    block_gather_sum_plain,
    block_scatter_rows,
    block_scatter_rows_plain,
    fused_spectre_linear,
    fused_spectre_linear_grad,
    fused_spectre_linear_plain,
    inverse_gather_sum,
    inverse_gather_sum_plain,
    launch_counts,
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
    delta = {k: after[k] - before[k] for k in after}
    assert delta == {"block_scatter_rows": 2, "block_gather_sum": 2 * bool(mix_block),
                     "inverse_gather_sum": 2 * (not mix_block), "fused_spectre_linear": 5}
    for (name, pc), pg in zip(cpu.named_parameters(), gpu.parameters()):
        scale = pc.grad.abs().max().item()
        assert (pg.grad.cpu() - pc.grad).abs().max().item() <= 1e-4 * scale, name
