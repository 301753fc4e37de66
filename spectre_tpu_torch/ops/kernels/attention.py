"""Kernels 8 and 9: softmax attention for short sequences, forward and backward.

``flash_attention(q, k, v, pm=None)`` computes ``(softmax(q k^T D^-1/2) * pm) v``
over [B, H, N, D] (the JAX package's layout). The forward saves O and the
float32 log-sum-exp of every score row, LSE [B, H, N, 1]; the backward
rebuilds ``P = exp(S - LSE)`` from it, takes ``delta = rowsum(dO * O)`` and
returns dQ, dK, dV. No [N, N] tensor reaches device memory. The CUDA kernels
are in ``csrc/attention.cu`` (they replace the TPU kernels ``_fwd_kernel``
and ``_bwd_kernel`` of ``spectre_tpu/ops/pallas/attention.py``).

``pm`` is an optional float32 [N, N] multiplier on the probabilities, shared
by every batch and head: a dropout keep-mask over its keep-probability, drawn
by the caller (``models/mixers.py::AttentionMixer``, from the train state's
generator), as flax's ``MultiHeadDotProductAttention`` draws one mask for all
batches and heads. The JAX package leaves its kernel whenever dropout is
active; here the train step runs both kernels at the config's own dropout.
In the backward ``dP = (dO v^T) * pm``, and ``delta = rowsum(dO * O)`` still
holds. With ``pm=None`` the kernels compute exactly what the Pallas kernels
compute.

q, k and v may be strided views (any strides on B, H and N, the last axis
contiguous, every row starting on a 16-byte boundary and a whole number of
16-byte chunks long: D a multiple of 4 in float32, of 8 in bfloat16), so a
caller can pass views of its [B, N, H, D] projections without a copy. O, dQ,
dK and dV come back as [B, H, N, D] views of [B, N, H, D] memory for the same
reason.

The plain versions state the kernels' arithmetic in PyTorch. In float32
everything is float32, one cast at the end. In bfloat16 the kernels multiply
on the tensor cores with bf16 operands and float32 sums, so P * pm (the
forward's P v and the backward's dV) and dS (dQ and dK) are rounded to bf16
before their products; everything else is float32, one cast at the end, and
the plain versions round at the same two places. The JAX kernel keeps P in
float32; the distance this makes is measured in ``chip_smoke.py`` and stated
in PERF.md. On the CPU the autograd Function runs the plain versions, the
analytic backward included.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. There is no fallback from a CUDA tensor to the plain path.
"""

from __future__ import annotations

import ctypes

import torch

from spectre_tpu_torch.ops.kernels.build import check, load_library

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_N, MAX_D = 128, 64  # one block holds a (batch, head) pair (csrc/attention.cu)
MAX_SHARED_BYTES = 227 * 1024


def score_columns(n: int, d: int) -> int:
    """Key columns, padding included, of the float32 kernel instance that
    takes [N, D] (``dispatch`` in csrc/attention.cu): the two built for the
    configs' shapes, and the widest for every other shape."""
    if d <= 32 and n <= 64:
        return 64
    if d <= 32 and n <= 96:
        return 96
    return MAX_N


def backward_shared_bytes(n: int, d: int, dtype: torch.dtype = torch.float32) -> int:
    """Shared memory of one block of the backward kernel (the larger of the
    two) for ``dtype``. float32: K and V transposed, q and dO, P * pm and dS.
    bfloat16 (the tensor-core kernel, one buffer; ``launch_bwd_tc``): q, k,
    v and dO with rows and features padded to multiples of 16 and rows 8
    elements longer, then P * pm and dS likewise."""
    if dtype == torch.bfloat16:
        npad, dpad = -(-n // 16) * 16, -(-d // 16) * 16
        return 2 * (4 * npad * (dpad + 8) + 2 * npad * (npad + 8))
    npad, n4 = score_columns(n, d), -(-n // 4) * 4
    return 4 * (2 * d * (npad + 1) + 2 * n4 * d + 2 * n4 * npad)


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return torch.matmul(q.float(), k.float().transpose(-1, -2)) * (q.shape[-1] ** -0.5)


def _operand(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A float32 product operand as the kernel for ``dtype`` feeds it to its
    product: rounded to bf16 for the tensor cores, as it is in float32."""
    return x.to(torch.bfloat16).float() if dtype == torch.bfloat16 else x


def flash_attention_fwd_plain(q, k, v, pm=None):
    """Plain PyTorch version of the forward: (O in q's dtype, LSE float32
    [B, H, N, 1])."""
    s = _scores(q, k)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    p = e / l
    if pm is not None:
        p = p * pm
    return torch.matmul(_operand(p, q.dtype), v.float()).to(q.dtype), m + torch.log(l)


def flash_attention_bwd_plain(q, k, v, o, lse, g, pm=None):
    """Plain PyTorch version of the backward: (dQ, dK, dV) from the saved O
    and LSE, without reducing the score rows again."""
    scale = q.shape[-1] ** -0.5
    gf = g.float()
    p = torch.exp(_scores(q, k) - lse)
    delta = (gf * o.float()).sum(dim=-1, keepdim=True)
    dp = torch.matmul(gf, v.float().transpose(-1, -2))
    pp = p
    if pm is not None:
        pp, dp = p * pm, dp * pm
    ds = _operand(p * (dp - delta), q.dtype)
    pp = _operand(pp, q.dtype)
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    dv = torch.matmul(pp.transpose(-1, -2), gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_plain(q, k, v, pm=None):
    """Plain PyTorch version of ``flash_attention``, differentiable by
    autograd."""
    return flash_attention_fwd_plain(q, k, v, pm)[0]


def _validate(name: str, tensors, pm) -> None:
    q = tensors[0]
    if q.dim() != 4:
        raise ValueError(f"{name}: want [B, H, N, D] tensors, got {tuple(q.shape)}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} takes float32 or bfloat16, not {q.dtype}")
    for t in tensors:
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: operands must share q's shape {tuple(q.shape)}, dtype "
                             f"and device; got {tuple(t.shape)} {t.dtype} on {t.device}")
    n = q.shape[2]
    if pm is not None and (tuple(pm.shape) != (n, n) or pm.dtype != torch.float32
                           or pm.device != q.device):
        raise ValueError(f"{name}: pm must be float32 [{n}, {n}] on {q.device}, got "
                         f"{pm.dtype} {tuple(pm.shape)} on {pm.device}")


def rows_aligned(t: torch.Tensor) -> bool:
    """Whether every row of [B, H, N, D] ``t`` is contiguous, starts on a
    16-byte boundary and is a whole number of 16-byte chunks long, as the
    kernels' loader needs."""
    size = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s * size % 16 == 0 for s in (t.shape[-1], *t.stride()[:3])))


def _for_kernel(name: str, tensors, pm):
    """What the kernels add to ``_validate``: the device, the block's limits,
    aligned rows (and a contiguous pm)."""
    q = tensors[0]
    if q.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {q.device}")
    _, _, n, d = q.shape
    # the forward refuses what the backward could not take
    need = backward_shared_bytes(n, d, q.dtype)
    if n > MAX_N or d > MAX_D or need > MAX_SHARED_BYTES:
        raise ValueError(f"{name} kernel takes N <= {MAX_N} and D <= {MAX_D} within "
                         f"{MAX_SHARED_BYTES} bytes of shared memory "
                         f"(N={n}, D={d} in {q.dtype} needs {need})")
    for t in tensors:
        if not rows_aligned(t):
            raise ValueError(f"{name} needs the last axis contiguous and every row a whole "
                             f"number of 16-byte chunks on a 16-byte boundary; got {t.dtype} "
                             f"{tuple(t.shape)} with strides {t.stride()}")
    return None if pm is None else pm.contiguous()


def _bhn_strides(*tensors):
    flat = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _empty_bhnd(like: torch.Tensor) -> torch.Tensor:
    """[B, H, N, D] view of new [B, N, H, D] memory."""
    b, h, n, d = like.shape
    return torch.empty((b, n, h, d), dtype=like.dtype, device=like.device).permute(0, 2, 1, 3)


def flash_attention_fwd(q, k, v, pm=None):
    """(O, LSE) of softmax attention; O is a [B, H, N, D] view of [B, N, H, D]
    memory, LSE float32 [B, H, N, 1]. Not differentiable: ``flash_attention``
    is."""
    _validate("flash_attention_fwd", (q, k, v), pm)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, pm)
    pm = _for_kernel("flash_attention_fwd", (q, k, v), pm)
    b, h, n, d = q.shape
    o = _empty_bhnd(q)
    lse = torch.empty((b, h, n, 1), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return o, lse
    lib = load_library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if pm is None else pm.data_ptr(), o.data_ptr(), lse.data_ptr(), b, h, n, d,
            _bhn_strides(q, k, v, o), d ** -0.5,
            torch.cuda.current_stream().cuda_stream)
    check(err, "flash_attention_fwd launch")
    flash_attention_fwd.launches += 1
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, g, pm=None):
    """(dQ, dK, dV) for the cotangent g of O, from the forward's O and LSE."""
    _validate("flash_attention_bwd", (q, k, v, o, g), pm)
    b, h, n, d = q.shape
    if tuple(lse.shape) != (b, h, n, 1) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"flash_attention_bwd: lse must be float32 [{b}, {h}, {n}, 1] on "
                         f"{q.device}, got {lse.dtype} {tuple(lse.shape)} on {lse.device}")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, g, pm)
    pm = _for_kernel("flash_attention_bwd", (q, k, v, o, g), pm)
    dq, dk, dv = _empty_bhnd(q), _empty_bhnd(q), _empty_bhnd(q)
    if q.numel() == 0:
        return dq, dk, dv
    lib = load_library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.contiguous().data_ptr(), g.data_ptr(), None if pm is None else pm.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, n, d,
            _bhn_strides(q, k, v, o, g, dq, dk, dv), d ** -0.5,
            torch.cuda.current_stream().cuda_stream)
    check(err, "flash_attention_bwd launch")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_fwd.launches = 0
flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, pm):
        o, lse = flash_attention_fwd(q, k, v, pm)
        ctx.save_for_backward(q, k, v, o, lse, pm)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse, pm = ctx.saved_tensors
        if not rows_aligned(g):  # an expanded cotangent, as sum() gives
            g = g.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, g, pm)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    pm: torch.Tensor | None = None) -> torch.Tensor:
    """Softmax attention over [B, H, N, D] q, k, v -> [B, H, N, D], with
    gradients for q, k and v; ``pm`` (float32 [N, N], no gradient) multiplies
    the probabilities."""
    return _FlashAttention.apply(q, k, v, pm)
