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
    block_scatter_rows,
    block_scatter_rows_plain,
    fused_spectre_linear,
    fused_spectre_linear_plain,
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
    """16-byte chunks (blk=64), element-wise chunks (blk=1 at odd B) and a
    source whose base is not 16-byte aligned."""
    rng = np.random.default_rng(0)
    h = 4
    for nb, blk, b, offset in ((40, 64, 1, 0), (40, 64, 3, 0), (40, 64, 64, 0),
                               (40, 64, 130, 0), (300, 1, 3, 0), (300, 1, 8, 0),
                               (40, 64, 8, 1)):
        bsrc = torch.from_numpy(np.stack([rng.permutation(nb) for _ in range(h)])
                                .astype(np.int32)).to(cuda_device)
        flat = torch.from_numpy(rng.standard_normal(offset + nb * blk * b).astype(np.float32))
        xt = flat.to(cuda_device, dtype)[offset:].view(nb * blk, b)
        n0 = block_scatter_rows.launches
        got = block_scatter_rows(xt, bsrc, blk)
        assert block_scatter_rows.launches == n0 + 1
        assert torch.equal(got, block_scatter_rows_plain(xt, bsrc, blk)), (nb, blk, b, offset)


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
