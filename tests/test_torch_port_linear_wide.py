"""Kernel 2 above N = 1,024 on the CPU: which CUDA kernels a call on the card
takes (the two-pass wide kernel of the forward for bf16 that TMA can
describe, the cluster kernel for the rest; the wide chain of the backward), and the plain forward and backward at such N against the JAX
package's Pallas kernel in interpret mode and its VJP, in float32, with the
JAX package's own tolerances (tests/test_pallas.py: 1e-5 forward, 1e-4
gradients). tests/test_torch_port_cuda.py holds the kernels to the plain
versions on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectre_tpu.ops.pallas import fused_spectre_linear as jax_fused_spectre_linear
from spectre_tpu.ops.pallas.fused_linear import _forward as jax_forward
from spectre_tpu_torch.ops import spectre_linear_apply
from spectre_tpu_torch.ops.kernels import (
    backward_kernel,
    forward_kernel,
    fused_spectre_linear_plain,
)

WIDE_WGMMA, CLUSTER = "fused_spectre_linear_wide_wgmma", "fused_spectre_linear_cluster"


@pytest.mark.parametrize("n", [1100, 1536, 2048])
@pytest.mark.parametrize("k", [768, 1536])
def test_n_above_1024_names_a_wide_kernel(k, n):
    """bf16 that TMA can describe (N a multiple of 8) on the two-pass wgmma
    kernel; N = 1,100 in bf16, unaligned operands and every float32 call on
    the cluster kernel, which splits the row across its blocks; no call
    raises."""
    assert forward_kernel(torch.bfloat16, k, n) == (WIDE_WGMMA if n % 8 == 0 else CLUSTER)
    assert forward_kernel(torch.float32, k, n) == CLUSTER
    assert forward_kernel(torch.bfloat16, k, n, aligned=False) == CLUSTER
    assert backward_kernel(n) == "fused_spectre_linear_bwd_wide"


@pytest.mark.parametrize("n", [100, 512, 768, 1024])
def test_n_up_to_1024_keeps_its_kernels(n):
    """At N <= 1,024 bf16 that TMA can describe stays on the wgmma kernel up
    to N = 768; the rest goes to the cluster kernel."""
    assert forward_kernel(torch.float32, 512, n) == CLUSTER
    assert forward_kernel(torch.bfloat16, 512, n) == (
        "fused_spectre_linear_wgmma" if n % 8 == 0 and n <= 768 else CLUSTER)
    assert backward_kernel(n) == "fused_spectre_linear_bwd_chain"


def _case(m, k, n, seed):
    rng = np.random.default_rng(seed)
    return [a.astype(np.float32) for a in (
        rng.standard_normal((m, k)), rng.uniform(-k ** -0.5, k ** -0.5, (k, n)),
        0.1 * rng.standard_normal(n), rng.uniform(0.5, 1.5, n), 0.1 * rng.standard_normal(n),
        rng.standard_normal((m, n)))]


# K == N (the identity residual inside the kernel's function), K < N with
# N = 1,100 (a pool residual that does not divide evenly), K > N; ragged rows
@pytest.mark.parametrize("m,k,n", [(65, 1536, 1536), (33, 64, 1100), (9, 2048, 1100)])
def test_plain_forward_and_backward_match_the_pallas_kernel(m, k, n):
    arrays = _case(m, k, n, seed=m + k + n)
    jargs = [jnp.asarray(a) for a in arrays]
    want, vjp = jax.vjp(lambda *a: jax_fused_spectre_linear(*a, interpret=True), *jargs[:5])
    want_grads = vjp(jargs[5])
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays[:5]]
    got = spectre_linear_apply(*leaves)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    got.backward(torch.from_numpy(arrays[5]))
    for name, t, wg in zip(("dx", "dw", "db", "dgamma", "dbeta"), leaves, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(wg), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    # the kernel's own function and its saved h: the pre-LN float32 product
    out, h = fused_spectre_linear_plain(*map(torch.from_numpy, arrays[:5]), save_h=True)
    want_out, want_h = jax_forward(*jargs[:5], 1e-5, True)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), rtol=1e-5, atol=1e-5)
    if k == n:
        np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=1e-5, atol=1e-5)
