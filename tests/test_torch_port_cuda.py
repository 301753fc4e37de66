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

from spectre_tpu_torch.data import BatchIterator, prefetch_to_device, synthetic_dataset
from spectre_tpu_torch.models import build_model
from spectre_tpu_torch.ops import fwht as fwht_any_axis
from spectre_tpu_torch.ops import register_mix_routes
from spectre_tpu_torch.ops.routing import build_route_tables_cached
from spectre_tpu_torch.ops.kernels import (
    block_gather_sum,
    block_gather_sum_plain,
    block_scatter_rows,
    block_scatter_rows_plain,
    fused_block_bwd,
    fused_block_bwd_plain,
    fused_spectre_linear,
    fused_spectre_linear_grad,
    fused_spectre_linear_plain,
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
@pytest.mark.parametrize("blk", [16, 32, 64])
@pytest.mark.parametrize("b", [5, 250, 256])
def test_fused_block_bwd_kernel_matches_plain_and_the_chain(cuda_device, dtype, rel, blk, b):
    """Kernel 5 against its plain version and against the chain it fuses
    (dg4 product, signs, block_gather_sum), with a ragged batch tail, an O
    that is no multiple of the kernel's K stage, and every row-tile size."""
    rng = np.random.default_rng(blk + b)
    h, e, n, o = 4, 64, 5, 40
    d, eh = n * e, e * h
    binv = torch.from_numpy(np.stack([rng.permutation(d // blk) for _ in range(h)])
                            .astype(np.int32)).to(cuda_device)
    dy = torch.from_numpy(rng.standard_normal((n, b, o)).astype(np.float32)).to(cuda_device, dtype)
    w = torch.from_numpy(rng.standard_normal((eh, o)).astype(np.float32)).to(cuda_device, dtype)
    s4 = torch.from_numpy(rng.choice([-1.0, 1.0], (n, eh)).astype(np.float32)).to(cuda_device,
                                                                                 dtype)
    n0 = fused_block_bwd.launches
    got = fused_block_bwd(dy, w, s4, binv, blk)
    torch.cuda.synchronize()
    assert fused_block_bwd.launches == n0 + 1
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
    assert delta == {"block_scatter_rows": 2, "fused_spectre_linear": 5, "routed_gather_sum": 2}
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
