"""Kernel 2: the SpectreLinear block's product, LayerNorm and GELU in one pass,
and the LayerNorm/GELU chain of its backward.

``out = GELU(LN(x @ W + b) * gamma + beta)`` plus ``x`` when K == N, with
x [..., K] and W [K, N] in the JAX [in, out] layout. The K != N pool residual
stays with the caller (``ops/linear.py``), as in the JAX package. The CUDA
kernels are in ``csrc/fused_spectre_linear.cu`` (they replace the forward of
the TPU kernel ``spectre_tpu/ops/pallas/fused_linear.py::fused_spectre_linear``):
``fused_spectre_linear_wgmma``, bf16 on Hopper's wgmma + TMA mainloop
(``csrc/wgmma_gemm.cuh``) up to N = 768; above it
``fused_spectre_linear_wide_cluster``, a thread-block cluster of
``wide_cluster_size(N)`` blocks on the same mainloop, each owning 256
columns of a row tile and meeting the others in their shared memory for the
LayerNorm statistics, up to the largest cluster the card holds (N = 4,096 on
the H100), both for bf16 that TMA can describe; and
``fused_spectre_linear_cluster`` for everything else: float32 at any K and
N (exact float32 on the FP32 pipes, no TF32), bf16 that TMA cannot describe
(the head's N = 100) and bf16 beyond the wide cluster's reach. It splits a row tile's
columns, and for few rows its K, across a thread-block cluster whose blocks
meet in each other's shared memory for the LayerNorm statistics; the plan
is ``cluster_plan``'s. ``forward_kernel`` decides which kernel a call
launches, from what it can see: the dtype, K and N, the alignment of the
operands and the wide cluster's reach on the card.

With ``save_h`` the kernel also writes the pre-LayerNorm activation
``h = x @ W + b`` in x's dtype. ``fused_spectre_linear_grad`` is the
differentiable form: a ``torch.autograd.Function`` whose forward is the
kernel with ``save_h`` and whose backward is ``fused_spectre_linear_bwd``
on the saved ``h``: the analytic LayerNorm/GELU chain and its three column
sums in one CUDA kernel (``csrc/fused_spectre_linear_bwd.cu``; the JAX
package's ``_bwd``, jnp beside its Pallas kernel), then the two products
``dW = x^T dh`` and ``dx = dh W^T`` (+ g when K == N, added before the one
rounding). The forward product is not run again in the backward.

Arithmetic of the backward, stated by ``fused_spectre_linear_bwd_plain``:
the chain in float32 from the saved h (LayerNorm statistics of the rounded
h); in bfloat16 dh is rounded to bf16 and the products take bf16 operands
with float32 sums (the JAX package multiplies float32 operands at the
TPU's default precision, which is not float32 either); in float32
everything is float32, the products true float32 (no TF32). dgamma, dbeta
and db are float32 sums (db of the unrounded dh), each gradient cast once
to its tensor's dtype. The chain kernel holds a row in a warp's registers up
to N = 1,024; above, ``fused_spectre_linear_bwd_wide`` (``backward_kernel``)
spreads a row over a block, each thread holding its columns of every row in
registers, with the next rows on their way into shared memory and the column
sums in registers across the block's rows, up to N = ``WIDE_REACH``; above
that it walks the row from memory. ``wide_chain_plan`` picks its vector
width, vectors a thread, threads and grid.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. There is no fallback from a CUDA tensor to the plain path.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from spectre_tpu_torch.ops.kernels.build import check, current_stream, load_library

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# up to this N one warp holds a row of the backward's chain; above, the
# wide chain (csrc/fused_spectre_linear_bwd.cu)
ROW_N = 1024
# the wgmma kernel's 64 x N float32 sums live in registers: 64 N of an SM's 65,536
WGMMA_MAX_N = 768
BWD_BLOCKS_PER_SM = 3  # the chain kernel's blocks an SM (csrc/fused_spectre_linear_bwd.cu)
# The wide chain (csrc/fused_spectre_linear_bwd.cu, N > ROW_N): the values
# a thread holds in registers, the threads a block at most, and so the N up
# to which a row is held in registers (above, the row is walked by
# WIDE_MAX_THREADS threads); at most WIDE_BLOCKS_PER_SM blocks an SM of what
# the card's occupancy allows, since each block adds a partial row of
# column sums, and one where the row is walked, whose column sums go
# through memory every row (the card's sweeps, PERF.md: 16 values a thread
# and 4 blocks an SM were the fastest at every C6 shape, one block an SM at
# N = 16,384)
WIDE_VALUES = 16
WIDE_MAX_THREADS = 512
WIDE_REACH = WIDE_MAX_THREADS * WIDE_VALUES
WIDE_BLOCKS_PER_SM = 4


def fused_spectre_linear_plain(x, w, b, gamma, beta, eps: float = 1e-5,
                               save_h: bool = False):
    """Plain PyTorch version: the kernel's math in float32, cast once. With
    ``save_h`` returns ``(out, h)``, h the pre-LN activation in x's dtype."""
    K, N = w.shape
    h = torch.matmul(x.float(), w.float()) + b.float()
    y = F.gelu(F.layer_norm(h, (N,), gamma.float(), beta.float(), eps))
    if K == N:
        y = y + x.float()
    y = y.to(x.dtype)
    return (y, h.to(x.dtype)) if save_h else y


def _validate(x, w, b, gamma, beta) -> None:
    if w.dim() != 2 or x.dim() < 1 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"want x [..., K] and w [K, N]; got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    n = w.shape[1]
    for name, t in (("b", b), ("gamma", gamma), ("beta", beta)):
        if tuple(t.shape) != (n,):
            raise ValueError(f"{name} must be [{n}], got {tuple(t.shape)}")
    for t in (x, w, b, gamma, beta):
        if t.dtype != x.dtype:
            raise TypeError(f"all operands must share x's dtype {x.dtype}; got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"all operands must be on {x.device}; got {t.device}")
        if not t.is_contiguous():
            raise ValueError("fused_spectre_linear needs contiguous operands")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_spectre_linear takes float32 or bfloat16, not {x.dtype}")


# the wide cluster kernel's columns a block (csrc/fused_spectre_linear.cu: WcCfg)
WIDE_COLUMNS = 256


def wide_cluster_size(n: int) -> int:
    """Blocks in a cluster of the wide cluster kernel for N = ``n``: one for
    every WIDE_COLUMNS columns."""
    return -(-n // WIDE_COLUMNS)


def forward_kernel(dtype: torch.dtype, k: int, n: int, aligned: bool = True,
                   device: int | None = None) -> str:
    """The name of the CUDA kernel that runs a forward with W [k, n] on card
    ``device`` (None: the current one). Where TMA can describe the operands
    (bfloat16, k and n multiples of 8, ``aligned``: x and W 16-byte
    aligned): ``fused_spectre_linear_wgmma`` for n <= WGMMA_MAX_N, above it
    ``fused_spectre_linear_wide_cluster`` up to the card's
    ``wide_cluster_reach`` (asked only then; 4,096 on the H100). Everything
    else, ``fused_spectre_linear_cluster``: float32 (exact float32), bf16
    that TMA cannot describe (the head's n = 100 makes 200-byte rows of W,
    which TMA cannot stride) and bf16 beyond the wide cluster's reach."""
    if dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0 and aligned:
        if n <= WGMMA_MAX_N:
            return "fused_spectre_linear_wgmma"
        dev = torch.cuda.current_device() if device is None else device
        if n <= wide_cluster_reach(dev):
            return "fused_spectre_linear_wide_cluster"
    return "fused_spectre_linear_cluster"


# The cluster kernel's shapes (csrc/fused_spectre_linear.cu: Cl, ClLayout,
# cluster_smem): the K split's unit (a multiple of every stage's depth); the
# most blocks a cluster (above 8 the card's non-portable sizes); the dynamic
# shared memory of a block and of an SM on the H100; and, per (dtype, rows a
# block), the columns a chunk, the K depth of a stage, the threads, the
# ring's stages and the blocks an SM runs at once (its registers; bf16 at
# 16 rows as the card's sweep found, 2 where ptxas would allow 3).
CLUSTER_TK = 32
MAX_CLUSTER = 16
PORTABLE_CLUSTER = 8
# cluster_plan's costs below a full card, in a block's stages: a block's
# fixed cost (its barriers and epilogue), and each K block's partial sums
BLOCK_STAGES, K_SPLIT_STAGES = 4, 0.25
SMEM_BLOCK, SMEM_SM = 232448, 233472
_CLUSTER_TILES = {(torch.bfloat16, 16): (64, 32, 128, 8, 2),
                  (torch.bfloat16, 64): (128, 32, 256, 4, 1),
                  (torch.float32, 16): (256, 32, 256, 4, 1),
                  (torch.float32, 32): (128, 16, 256, 3, 3)}
# rows a cluster where row tiles of 128 columns already fill the card
_BIG_BM = {torch.bfloat16: 64, torch.float32: 32}


class ClusterPlan(NamedTuple):
    """A launch of the cluster kernel: ``bm`` rows a cluster, ``cn`` blocks
    of ``bn`` columns times ``ck`` blocks of ``kc`` of K in each cluster."""
    bm: int
    bn: int
    cn: int
    ck: int
    kc: int
    threads: int
    smem: int
    blocks: int

    @property
    def cluster(self) -> int:
        return self.cn * self.ck


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def cluster_smem(dtype: torch.dtype, bm: int, bn: int, cn: int) -> int:
    """Bytes of dynamic shared memory a block takes: the ring of x and W
    stages (rows padded by 16 bytes; float32 keeps x transposed), the parked
    float32 sums [bm, bn] (rows rounded up to 8 mod 32 floats) and a (mean,
    M2) pair a row for each of the cn column blocks."""
    tn, tk, _, stages, _ = _CLUSTER_TILES[dtype, bm]
    el = 2 if dtype == torch.bfloat16 else 4
    pad = 16 // el
    xtile = tk * (bm + pad) if dtype == torch.float32 else bm * (tk + pad)
    stage = (xtile + tk * (tn + pad)) * el
    return stages * stage + bm * (bn + (8 - bn % 32) % 32) * 4 + cn * bm * 8


def _plan(dtype, bm, n, k, cn, ck, rows) -> ClusterPlan:
    bn = _ceil(_ceil(n, cn), 8) * 8
    kc = _ceil(_ceil(k, ck), CLUSTER_TK) * CLUSTER_TK
    cn, ck = _ceil(n, bn), _ceil(k, kc)
    threads = _CLUSTER_TILES[dtype, bm][2]
    return ClusterPlan(bm, bn, cn, ck, kc, threads, cluster_smem(dtype, bm, bn, cn),
                       rows * cn * ck)


@functools.lru_cache(maxsize=4096)
def cluster_plan(dtype: torch.dtype, m: int, k: int, n: int, sm_count: int = 132) -> ClusterPlan:
    """The cluster kernel's launch for x [m, k] and W [k, n] on a card of
    ``sm_count`` SMs. Rows a cluster: 64 in bf16 (32 in float32) where such
    row tiles of 128 columns already fill the card, else 16. With rows to
    spare, of the column splits that give ``sm_count`` blocks (up to
    PORTABLE_CLUSTER blocks, more only where shared memory forces it), the
    one whose waves of blocks walk the fewest columns. Below that, among
    the (columns x K) splits that fill the card (all of them if none does),
    the one whose waves times a block's stages, plus a fixed cost a block,
    is least: with few rows a stage costs a block a round of copies and
    little else (the card's sweeps of these plans); a K split pays its
    partial sums through shared memory, a little for each block. Raises
    ValueError for what no plan can launch."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the cluster kernel takes float32 or bfloat16, not {dtype}")
    if min(m, k, n) <= 0:
        raise ValueError(f"want m, k, n >= 1; got {m}, {k}, {n}")
    big_bm = _BIG_BM[dtype]
    big = _ceil(m, big_bm) * _ceil(n, 128) >= sm_count
    for bm in ((big_bm, 16) if big else (16,)):
        bn_max = max((b for b in range(8, n + 8, 8)
                      if cluster_smem(dtype, bm, b, MAX_CLUSTER) <= SMEM_BLOCK), default=0)
        if bn_max and _ceil(n, bn_max) <= MAX_CLUSTER:
            break
    else:
        raise ValueError(f"N = {n} needs more than {MAX_CLUSTER} blocks' shared memory a row")
    big = big and bm == big_bm
    rows = _ceil(m, bm)
    cn_min = _ceil(n, bn_max)
    cn_max = max(cn_min, min(MAX_CLUSTER, _ceil(n, 8)))
    tn, tk, _, _, regs_sm = _CLUSTER_TILES[dtype, bm]

    def waves(p):  # of the blocks an SM holds at once, by shared memory and registers
        return _ceil(p.blocks, sm_count * max(1, min(SMEM_SM // (p.smem + 1024), regs_sm)))

    if big:
        plans = {_plan(dtype, bm, n, k, cn, 1, rows)
                 for cn in range(cn_min, max(cn_min, min(PORTABLE_CLUSTER, cn_max)) + 1)}
        plans = {p for p in plans if p.blocks >= sm_count} or plans
        return min(plans, key=lambda p: (waves(p) * _ceil(p.bn, tn) * tn, p.cn))
    plans = {_plan(dtype, bm, n, k, cn, ck, rows)
             for cn in range(cn_min, cn_max + 1)
             for ck in range(1, max(1, min(MAX_CLUSTER // cn, _ceil(k, CLUSTER_TK))) + 1)}
    plans = {p for p in plans if p.cluster <= MAX_CLUSTER and p.smem <= SMEM_BLOCK}
    plans = {p for p in plans if p.blocks >= sm_count} or plans
    return min(plans, key=lambda p: (
        waves(p) * (_ceil(p.bn, tn) * _ceil(p.kc, tk) + BLOCK_STAGES)
        + K_SPLIT_STAGES * (p.ck - 1), p.cluster, p.cn))


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def fused_spectre_linear_wgmma(x, w, b, gamma, beta, out, h, eps: float) -> None:
    """Launch the bf16 wgmma kernel on checked operands of the current
    device into ``out`` (and ``h`` unless it is None)."""
    k, n = w.shape
    err = load_library().fused_spectre_linear_wgmma(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        out.data_ptr(), None if h is None else h.data_ptr(), x.numel() // k, k, n, eps,
        current_stream(x.get_device()))
    check(err, "fused_spectre_linear_wgmma launch")
    fused_spectre_linear_wgmma.launches += 1


def fused_spectre_linear_cluster(x, w, b, gamma, beta, out, h, eps: float) -> None:
    """Launch the cluster kernel (float32, or bf16 that the wgmma kernels do
    not take) on checked operands of the current device into ``out`` (and
    ``h`` unless it is None), with ``cluster_plan``'s launch."""
    k, n = w.shape
    m = x.numel() // k
    dev = x.get_device()
    p = cluster_plan(x.dtype, m, k, n, _sm_count(dev))
    err = load_library().fused_spectre_linear_cluster(
        _DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(), b.data_ptr(), gamma.data_ptr(),
        beta.data_ptr(), out.data_ptr(), None if h is None else h.data_ptr(), m, k, n, p.bm,
        p.bn, p.cn, p.ck, p.kc, eps, current_stream(dev))
    check(err, f"fused_spectre_linear_cluster launch ({p})")
    fused_spectre_linear_cluster.launches += 1


def fused_spectre_linear_wide_cluster(x, w, b, gamma, beta, out, h, eps: float) -> None:
    """Launch the bf16 wide cluster kernel (a cluster of
    ``wide_cluster_size(N)`` blocks a row tile) on checked operands of the
    current device into ``out`` (and ``h`` unless it is None)."""
    k, n = w.shape
    err = load_library().fused_spectre_linear_wide_cluster(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        out.data_ptr(), None if h is None else h.data_ptr(), x.numel() // k, k, n, eps,
        current_stream(x.get_device()))
    check(err, f"fused_spectre_linear_wide_cluster launch (cluster of {wide_cluster_size(n)})")
    fused_spectre_linear_wide_cluster.launches += 1


@functools.lru_cache(maxsize=None)
def wide_cluster_reach(device_index: int) -> int:
    """The largest N the wide cluster kernel takes on a card: 256 columns
    times the largest cluster of its blocks that the card can hold
    (``cudaOccupancyMaxActiveClusters``), asked once before any launch."""
    size = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        check(load_library().fused_spectre_linear_wide_cluster_reach(ctypes.byref(size)),
              "fused_spectre_linear_wide_cluster_reach")
    return WIDE_COLUMNS * size.value


_FORWARD_KERNELS = {fn.__name__: fn for fn in (
    fused_spectre_linear_wgmma, fused_spectre_linear_cluster, fused_spectre_linear_wide_cluster)}
for _fn in _FORWARD_KERNELS.values():
    _fn.launches = 0


def fused_spectre_linear(x, w, b, gamma, beta, eps: float = 1e-5, save_h: bool = False):
    """GELU(LN(x @ w + b)) (+ x when K == N); leading axes of x are rows.
    With ``save_h`` returns ``(out, h)``, h = x @ w + b in x's dtype. Not
    differentiable: ``fused_spectre_linear_grad`` is. On the card it
    launches the kernel ``forward_kernel`` names; ``launches`` counts all three."""
    _validate(x, w, b, gamma, beta)
    if x.device.type == "cpu":
        return fused_spectre_linear_plain(x, w, b, gamma, beta, eps, save_h)
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_spectre_linear: no kernel for device {x.device}")
    dev = x.get_device()
    if dev != torch.cuda.current_device():  # the kernel launches on the current device
        with torch.cuda.device(dev):
            return fused_spectre_linear(x, w, b, gamma, beta, eps, save_h)
    K, N = w.shape
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    launch = _FORWARD_KERNELS[forward_kernel(x.dtype, K, N, aligned, dev)]
    out = torch.empty((*x.shape[:-1], N), dtype=x.dtype, device=x.device)
    h = torch.empty_like(out) if save_h else None
    launch(x, w, b, gamma, beta, out, h, eps)
    fused_spectre_linear.launches += 1
    return (out, h) if save_h else out


fused_spectre_linear.launches = 0

_INV_SQRT2 = 2.0 ** -0.5
_INV_SQRT_2PI = (2.0 * math.pi) ** -0.5


def _chain_plain(h, g, gamma, beta, eps):
    """The LayerNorm/GELU chain in float32: (dh, dgamma, dbeta, db), all
    float32, from h and g [M, N]."""
    hf, gy, gam = h.float(), g.float(), gamma.float()
    var, mu = torch.var_mean(hf, dim=-1, keepdim=True, correction=0)
    rsig = torch.rsqrt(var + eps)
    u = (hf - mu) * rsig
    z = u * gam + beta.float()
    # gelu'(z) = Phi(z) + z * phi(z), the exact erf form
    dgelu = 0.5 * (1.0 + torch.erf(z * _INV_SQRT2)) \
        + z * torch.exp(-0.5 * z * z) * _INV_SQRT_2PI
    dz = gy * dgelu
    du = dz * gam
    dh = rsig * (du - du.mean(-1, keepdim=True) - u * (du * u).mean(-1, keepdim=True))
    return dh, (dz * u).sum(0), dz.sum(0), dh.sum(0)


def _bwd_validate(x, w, gamma, beta, h, g) -> None:
    k, n = w.shape
    if x.shape[-1] != k or h.shape != g.shape or h.shape[:-1] != x.shape[:-1] \
            or h.shape[-1] != n:
        raise ValueError(f"want x [..., {k}], h and g [..., {n}] over x's rows; got "
                         f"{tuple(x.shape)}, {tuple(h.shape)}, {tuple(g.shape)}")
    for t in (w, gamma, beta, h, g):
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError(f"all operands must share x's dtype {x.dtype} and device "
                            f"{x.device}; got {t.dtype} on {t.device}")


def fused_spectre_linear_bwd_plain(x, w, gamma, beta, h, g, eps: float = 1e-5,
                                   identity: bool | None = None):
    """Plain PyTorch version of the backward: (dx, dw, db, dgamma, dbeta)
    from the saved pre-LN ``h`` and the cotangent ``g`` of the output (the
    K != N pool residual's part of dx stays with the caller; ``identity``
    as for ``fused_spectre_linear_bwd``). The chain in float32; for bf16
    inputs dh is rounded to bf16 before the two products, whose sums are
    float32; one cast of each gradient."""
    _bwd_validate(x, w, gamma, beta, h, g)
    k, n = w.shape
    dh, dgamma, dbeta, db = _chain_plain(h.reshape(-1, n), g.reshape(-1, n), gamma, beta, eps)
    dh_op = dh.to(x.dtype).float()  # the products' operand: rounded for bf16
    dw = torch.matmul(x.reshape(-1, k).float().t(), dh_op)
    dx = torch.matmul(dh_op, w.float().t())
    if k == n if identity is None else identity:
        dx = dx + g.reshape(-1, n).float()
    return (dx.reshape(x.shape).to(x.dtype), dw.to(w.dtype), db.to(w.dtype),
            dgamma.to(gamma.dtype), dbeta.to(beta.dtype))


@functools.lru_cache(maxsize=None)
def _bwd_grid(device_index: int) -> int:
    """The chain kernel's grid on a card: as many blocks as are resident at
    once, each owning a contiguous share of the rows (one partial row of
    column sums a block)."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return BWD_BLOCKS_PER_SM * sms


def backward_kernel(n: int) -> str:
    """The C entry point of the chain a backward with N = ``n`` launches: a
    row in a warp's registers up to ROW_N, else spread over a block."""
    return "fused_spectre_linear_bwd_chain" if n <= ROW_N else "fused_spectre_linear_bwd_wide"


class WideChainPlan(NamedTuple):
    """A launch of the wide chain: vectors of ``vec`` values, ``chunks``
    vectors a thread (0: the row is walked, N > WIDE_REACH), ``threads`` a
    block, ``blocks`` blocks of ``rows`` contiguous rows each."""
    vec: int
    chunks: int
    threads: int
    blocks: int
    rows: int


def wide_chain_plan(dtype: torch.dtype, m: int, n: int, align: int = 16, sm_count: int = 132,
                    occupancy=None) -> WideChainPlan:
    """The wide chain's launch for h and g [m, n] whose bases (h, g, dh,
    gamma, beta) are all ``align``-byte aligned. The widest vector of at
    most 16 bytes that n and the bases allow; WIDE_VALUES values a thread
    (WIDE_VALUES / vec vectors); the threads that cover the row, in whole
    warps (at most WIDE_MAX_THREADS: N <= WIDE_REACH; above, the row is
    walked by WIDE_MAX_THREADS threads). The grid:
    ``occupancy(vec, chunks, threads)`` blocks an SM (the card's answer;
    WIDE_BLOCKS_PER_SM when None), at most WIDE_BLOCKS_PER_SM (one for the
    walk), on ``sm_count`` SMs, at most one a row; the rows split evenly,
    so no block is empty."""
    el = dtype.itemsize
    vec = max(v for v in (8, 4, 2, 1)
              if v * el <= 16 and n % v == 0 and align % (v * el) == 0)
    vectors = _ceil(n, vec)
    if n > WIDE_REACH:
        chunks, threads = 0, WIDE_MAX_THREADS
    else:
        chunks = WIDE_VALUES // vec
        threads = _ceil(_ceil(vectors, chunks), 32) * 32
    per_sm = WIDE_BLOCKS_PER_SM if occupancy is None else occupancy(vec, chunks, threads)
    if per_sm < 1:
        raise ValueError(f"the wide chain's block ({vec}, {chunks}, {threads}) does not fit an SM")
    per_sm = min(per_sm, WIDE_BLOCKS_PER_SM if chunks else 1)
    rows = _ceil(m, min(m, per_sm * sm_count))
    return WideChainPlan(vec, chunks, threads, _ceil(m, rows), rows)


@functools.lru_cache(maxsize=None)
def _wide_occupancy(device_index: int, dtype: torch.dtype, vec: int, chunks: int,
                    threads: int) -> int:
    """Blocks of a wide chain instance an SM of the card holds (its
    registers and shared memory), asked once."""
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        check(load_library().fused_spectre_linear_bwd_wide_occupancy(
            _DTYPE_CODES[dtype], vec, chunks, threads, ctypes.byref(per_sm)),
            "fused_spectre_linear_bwd_wide_occupancy")
    return per_sm.value


def _alignment(*tensors) -> int:
    """The largest power of two up to 16 that divides every base address and
    the row stride in bytes of every 2-d tensor (None: skipped)."""
    bits = 16
    for t in tensors:
        if t is not None:
            bits |= t.data_ptr()
            if t.dim() == 2:
                bits |= t.stride(0) * t.element_size()
    return bits & -bits


def fused_spectre_linear_bwd_wide(h, g, gamma, beta, dh, sums, eps: float) -> None:
    """Launch the chain for N > ROW_N on checked operands of the current
    device, h, g and dh [M, N], into dh and ``sums`` (dgamma, dbeta, db
    [3, N]), with ``wide_chain_plan``'s launch."""
    m, n = h.shape
    dev = h.get_device()
    plan = wide_chain_plan(h.dtype, m, n, _alignment(h, g, dh, gamma, beta), _sm_count(dev),
                           functools.partial(_wide_occupancy, dev, h.dtype))
    partial = torch.empty((plan.blocks, 3, n), dtype=torch.float32, device=h.device)
    at, step = sums.data_ptr(), n * sums.element_size()
    check(load_library().fused_spectre_linear_bwd_wide(
        _DTYPE_CODES[h.dtype], h.data_ptr(), g.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        dh.data_ptr(), at, at + step, at + 2 * step, partial.data_ptr(), m, n, plan.blocks, eps,
        current_stream(dev), plan.vec, plan.chunks, plan.threads),
        f"fused_spectre_linear_bwd_wide launch ({plan})")
    fused_spectre_linear_bwd_wide.launches += 1


fused_spectre_linear_bwd_wide.launches = 0


def backward_chain(h, g, gamma, beta, eps: float = 1e-5):
    """The LayerNorm/GELU chain alone on the card: (dh [M, N] in h's dtype,
    sums [3, N]: dgamma, dbeta, db) from checked, contiguous h and g [M, N]
    on the current device, M >= 1; the kernel ``backward_kernel`` names."""
    m, n = h.shape
    dh = torch.empty_like(h)
    sums = torch.empty((3, n), dtype=h.dtype, device=h.device)
    if backward_kernel(n) == "fused_spectre_linear_bwd_wide":
        fused_spectre_linear_bwd_wide(h, g, gamma, beta, dh, sums, eps)
        return dh, sums
    dev = h.get_device()
    blocks = min(m, _bwd_grid(dev))
    partial = torch.empty((blocks, 3, n), dtype=torch.float32, device=h.device)
    at, step = sums.data_ptr(), n * sums.element_size()
    check(load_library().fused_spectre_linear_bwd_chain(
        _DTYPE_CODES[h.dtype], h.data_ptr(), g.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        dh.data_ptr(), at, at + step, at + 2 * step, partial.data_ptr(), m, n, blocks, eps,
        current_stream(dev)), "fused_spectre_linear_bwd_chain launch")
    return dh, sums


def linear_products(x2, w, dh, g2=None):
    """(dx, dw) of a product x2 @ w from dh [M, N] in x2's dtype: dW = x2^T dh
    and dx = dh w^T (+ g2, joined before the one rounding), bf16 operands
    with float32 sums for bf16 (one cuBLAS call each on the card), true
    float32 for float32; each cast once to its tensor's dtype."""
    if x2.device.type == "cpu":
        dh_op = dh.float()
        dx = torch.matmul(dh_op, w.float().t())
        if g2 is not None:
            dx = dx + g2.float()
        return dx.to(x2.dtype), torch.matmul(x2.float().t(), dh_op).to(w.dtype)
    if x2.dtype == torch.bfloat16:  # float32 sums, one rounding
        dw = torch.mm(x2.t(), dh, out_dtype=torch.float32).to(w.dtype)
    else:
        dw = torch.mm(x2.t(), dh)
    dx = torch.mm(dh, w.t()) if g2 is None else torch.addmm(g2, dh, w.t())
    return dx, dw


def fused_spectre_linear_bwd(x, w, gamma, beta, h, g, eps: float = 1e-5,
                             identity: bool | None = None):
    """(dx, dw, db, dgamma, dbeta) of ``fused_spectre_linear`` from the saved
    pre-LN ``h`` and the cotangent ``g``: the chain kernel
    (``backward_kernel``), then the two products (bf16 operands and float32
    sums for bf16 inputs). ``identity``: whether g joins dx through the
    identity residual (None: K == N; a row shard under tensor parallelism
    may have K == N by chance and no such residual). ``launches`` counts
    both chains, ``fused_spectre_linear_bwd_wide.launches`` the wide one."""
    _bwd_validate(x, w, gamma, beta, h, g)
    k, n = w.shape
    identity = k == n if identity is None else identity
    if x.device.type == "cpu":
        return fused_spectre_linear_bwd_plain(x, w, gamma, beta, h, g, eps, identity)
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_spectre_linear_bwd: no kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_spectre_linear_bwd takes float32 or bfloat16, not {x.dtype}")
    if not all(t.is_contiguous() for t in (x, w, gamma, beta, h, g)):
        raise ValueError("fused_spectre_linear_bwd needs contiguous operands")
    dev = x.get_device()
    if dev != torch.cuda.current_device():  # the kernel launches on the current device
        with torch.cuda.device(dev):
            return fused_spectre_linear_bwd(x, w, gamma, beta, h, g, eps, identity)
    m = h.numel() // n
    x2, g2 = x.reshape(m, k), g.reshape(m, n)
    if m == 0:
        dh = torch.empty((m, n), dtype=x.dtype, device=x.device)
        sums = torch.zeros((3, n), dtype=x.dtype, device=x.device)
    else:
        dh, sums = backward_chain(h.reshape(m, n), g2, gamma, beta, eps)
        fused_spectre_linear_bwd.launches += 1
    dx, dw = linear_products(x2, w, dh, g2 if identity else None)
    return dx.reshape(x.shape), dw, sums[2], sums[0], sums[1]


fused_spectre_linear_bwd.launches = 0


class _FusedSpectreLinear(torch.autograd.Function):
    """Forward: the kernel, saving the pre-LN ``h``. Backward:
    ``fused_spectre_linear_bwd`` on the saved ``h``."""

    @staticmethod
    def forward(ctx, x, w, b, gamma, beta, eps):
        out, h = fused_spectre_linear(x, w, b, gamma, beta, eps, save_h=True)
        ctx.save_for_backward(x, w, gamma, beta, h)
        ctx.eps = eps
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, gamma, beta, h = ctx.saved_tensors
        return (*fused_spectre_linear_bwd(x, w, gamma, beta, h, g.contiguous(), ctx.eps), None)


def fused_spectre_linear_grad(x, w, b, gamma, beta, eps: float = 1e-5):
    """``fused_spectre_linear`` with gradients for x, w, b, gamma and beta."""
    return _FusedSpectreLinear.apply(x, w, b, gamma, beta, eps)


# -- a SpectreLinear split over tensor-parallel ranks --------------------------
#
# Four entries compute the shard forms of the kernel above, for a layer whose
# N columns (column split: kernel, bias, gamma and beta) or K rows (row
# split) are spread over ``size`` ranks (``parallel/tp.py``). A LayerNorm
# over N needs the whole row; the ranks all-gather their per-row statistics
# between two entries, and each entry merges the gathered values in rank
# order itself, so that every rank computes the same bits whatever order the
# collective took:
#
# 1. ``fused_spectre_linear_shard_stats``: h = x @ W_local + b_local in x's
#    dtype and each row's (mean, M2) over the local columns of the float32
#    sums [M, 2]: its own kernel for bf16 that TMA describes up to n = 768
#    (``fused_spectre_linear_shard_stats_wgmma`` on ``shard_stats_plan``),
#    else the cluster kernel's statistics mode.
# 2. ``sharded_ln_gelu``: GELU(LN(h) gamma + beta) (+ residual) from the
#    gathered statistics [size, M, 2] merged by Chan's formula; or, with no
#    statistics, over its own whole row (the row split's all-reduced float32
#    sum, to which it adds the bias and whose rounding it saves as h). It
#    saves the merged (mean, rstd) [M, 2].
# 3. ``chain_shard_sums``: the backward chain's per-row (sum du, sum du u)
#    over the local columns [M, 2], and dgamma, dbeta of the local columns.
# 4. ``chain_shard_dh``: from the gathered row sums [size, M, 2] (added in
#    rank order), dh and db.
#
# csrc/fused_spectre_linear.cu holds 1 and 2, csrc/fused_spectre_linear_bwd.cu
# 3 and 4. Entry 1's bf16 kernel walks 128-row tiles with a persistent grid,
# cut into column tiles that end at n (``shard_stats_plan``). Entries 2, 3
# and 4 are one kernel each on the row shape of
# ``_shard_shape`` (``shard_ln_plan``, ``shard_chain_plan``): a team of lanes
# a row, each lane's columns the same in every row, so that gamma, beta (and
# the bias, or the column sums) stay in its registers, the next row loaded
# while one is computed; 3 and 4 then a fixed-order column-sum pass. The
# plain versions state the arithmetic: float32 statistics, the same
# rank-order merge, the roundings where the kernels round.

# entries 2, 3 and 4: the threads of a block and the vectors and values a
# lane holds in registers at most; 3 and 4 (csrc/fused_spectre_linear_bwd.cu):
# the blocks an SM at most of what the card's occupancy allows (each block
# adds one partial row of column sums)
SHARD_THREADS = 256
SHARD_CHUNKS = 4
SHARD_VALUES = 16
SHARD_BLOCKS_PER_SM = 3
# the threads an SM of the H100 holds
SM_THREADS = 2048


def matmul_f32(a, b):
    """a @ b [M, N] in float32 for 2-d a and b: bf16 operands' exact products
    summed in float32 (one cuBLAS call on the card), float32 as is."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _row_stats(v):
    """(mean, M2) [M, 2] of float32 rows by two passes, the second summing
    the deviations from the first mean to correct it (the cluster kernel's
    order of operations)."""
    n = v.shape[-1]
    mean1 = v.sum(-1, keepdim=True) / n
    d = v - mean1
    dsum = d.sum(-1, keepdim=True)
    return torch.cat([mean1 + dsum / n, (d * d).sum(-1, keepdim=True) - dsum * dsum / n], -1)


def merge_stats(stats, n: int):
    """Chan's formula over the ranks' (mean, M2) [size, M, 2], each of ``n``
    columns, in rank order: (mean, M2) [M] of the whole rows."""
    mean, m2 = stats[0, :, 0], stats[0, :, 1]
    na = float(n)
    for j in range(1, stats.shape[0]):
        tot = na + n
        d = stats[j, :, 0] - mean
        mean = mean + d * (n / tot)
        m2 = m2 + stats[j, :, 1] + d * d * (na * n / tot)
        na = tot
    return mean, m2


def shard_stats_plain(x, w, b):
    """Plain version of entry 1: (h [M, n] in x's dtype, (mean, M2) [M, 2]
    float32 of the float32 sums x @ w + b) for x [M, K], w [K, n]."""
    hf = torch.matmul(x.float(), w.float()) + b.float()
    return hf.to(x.dtype), _row_stats(hf)


def sharded_ln_gelu_plain(h, stats, gamma, beta, n_full: int, bias=None, residual=None,
                          eps: float = 1e-5):
    """Plain version of entry 2: (out [M, n], (mean, rstd) [M, 2] float32, h
    saved or None). ``stats`` [size, M, 2]: the ranks' (mean, M2) of a column
    shard h (its own dtype); None: h is a whole float32 row, to which
    ``bias`` is added, saved rounded to gamma's dtype. out in gamma's dtype,
    the residual added in float32 before the one rounding."""
    v = h.float()
    saved = None
    if stats is None:
        v = v + bias.float()
        saved = v.to(gamma.dtype)
        mean, m2 = _row_stats(v).unbind(-1)
    else:
        mean, m2 = merge_stats(stats, h.shape[-1])
    rstd = torch.rsqrt(m2 * (1.0 / n_full) + eps)
    y = F.gelu((v - mean[:, None]) * rstd[:, None] * gamma.float() + beta.float())
    if residual is not None:
        y = y + residual.float()
    return y.to(gamma.dtype), torch.stack([mean, rstd], -1), saved


def _shard_chain(h, g, gamma, beta, mstats):
    """u, dz and du [M, n] in float32 from the saved merged (mean, rstd)."""
    u = (h.float() - mstats[:, :1]) * mstats[:, 1:]
    gam = gamma.float()
    z = u * gam + beta.float()
    dgelu = 0.5 * (1.0 + torch.erf(z * _INV_SQRT2)) \
        + z * torch.exp(-0.5 * z * z) * _INV_SQRT_2PI
    dz = g.float() * dgelu
    return u, dz, dz * gam


def chain_shard_sums_plain(h, g, gamma, beta, mstats):
    """Plain version of entry 3: ((sum du, sum du u) [M, 2] float32, [dgamma,
    dbeta] [2, n] in h's dtype) over this rank's columns."""
    u, dz, du = _shard_chain(h, g, gamma, beta, mstats)
    rows = torch.stack([du.sum(-1), (du * u).sum(-1)], -1)
    return rows, torch.stack([(dz * u).sum(0), dz.sum(0)]).to(h.dtype)


def chain_shard_dh_plain(h, g, gamma, beta, mstats, rowsums, n_full: int):
    """Plain version of entry 4: (dh [M, n], db [n]) in h's dtype from the
    ranks' row sums [size, M, 2], added in rank order; db of the float32 dh."""
    u, _, du = _shard_chain(h, g, gamma, beta, mstats)
    s = rowsums[0]
    for j in range(1, rowsums.shape[0]):
        s = s + rowsums[j]
    dh = mstats[:, 1:] * (du - s[:, :1] * (1.0 / n_full) - u * (s[:, 1:] * (1.0 / n_full)))
    return dh.to(h.dtype), dh.sum(0).to(h.dtype)


def shard_stats_kernel(dtype: torch.dtype, k: int, n: int, aligned: bool = True) -> str:
    """The kernel entry 1 runs for W [k, n]:
    ``fused_spectre_linear_shard_stats_wgmma`` where TMA can describe the
    operands (bf16, k and n multiples of 8, x and W 16-byte aligned) and n
    <= WGMMA_MAX_N, else the statistics mode of
    ``fused_spectre_linear_cluster``."""
    if dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0 and aligned \
            and n <= WGMMA_MAX_N:
        return "fused_spectre_linear_shard_stats_wgmma"
    return "fused_spectre_linear_cluster"


# entry 1's bf16 kernel (csrc/fused_spectre_linear.cu: shard_stats_wgmma_kernel):
# rows a row tile (two consumer warpgroups of 64), columns a column tile at
# most (96 float32 sums a consumer thread), stages of its TMA ring; a stage
# holds a 128 x 64 box of x and up to three 64 x 64 boxes of W
SHARD_STATS_ROWS = 128
SHARD_STATS_TILE = 192
SHARD_STATS_STAGES = 4
_BOX_BYTES = 64 * 64 * 2


class ShardStatsPlan(NamedTuple):
    """A launch of entry 1's bf16 kernel: a row tile's n columns in
    ``tiles_n`` column tiles (``shard_stats_tiles`` of ``tile_n``, the last
    ``last_n`` wide); ``grid`` persistent blocks walk the ``row_tiles`` row
    tiles of SHARD_STATS_ROWS; ``smem`` bytes of shared memory a block;
    ``l2_bytes`` the bytes TMA brings from L2 into shared memory for a row
    tile, W's ``w_bytes`` of them (the plan's count, not a measurement)."""
    tile_n: int
    tiles_n: int
    last_n: int
    row_tiles: int
    grid: int
    smem: int
    l2_bytes: int
    w_bytes: int

    @property
    def w_bytes_row(self) -> float:
        """W's L2-to-shared bytes a row of output."""
        return self.w_bytes / SHARD_STATS_ROWS

    @property
    def x_bytes_row(self) -> float:
        """x's L2-to-shared bytes a row of output."""
        return (self.l2_bytes - self.w_bytes) / SHARD_STATS_ROWS


def shard_stats_tiles(n: int, tile_n: int) -> list[tuple[int, int]]:
    """(first column, width) of the column tiles of a row tile's n columns
    (csrc: ss_width): tiles of ``tile_n`` (a multiple of 64) up to n's last
    multiple of 64, then the rest (8 to 56 columns) in a tile of its own."""
    n64 = n // 64 * 64
    tiles = [(n0, min(tile_n, n64 - n0)) for n0 in range(0, n64, tile_n)]
    return tiles + [(n64, n - n64)] if n > n64 else tiles


@functools.lru_cache(maxsize=256)
def shard_stats_plan(m: int, k: int, n: int, sm_count: int = 132) -> ShardStatsPlan:
    """Entry 1's bf16 launch for x [m, k] and W [k, n] (k and n multiples of
    8, n <= WGMMA_MAX_N) on ``sm_count`` SMs: n's multiples of 64 in the
    fewest column tiles of at most SHARD_STATS_TILE columns, each a multiple
    of 64, as even as that allows; one persistent block an SM, at most one a
    row tile."""
    if m < 1 or k < 8 or k % 8 or n < 8 or n % 8 or n > WGMMA_MAX_N:
        raise ValueError(f"entry 1's wgmma kernel takes m >= 1, k and n multiples of 8, "
                         f"n <= {WGMMA_MAX_N}; got {m}, {k}, {n}")
    n64 = n // 64 * 64
    tile = 64 * max(1, _ceil(n64, 64 * max(1, _ceil(n64, SHARD_STATS_TILE))))
    cols = shard_stats_tiles(n, tile)
    row_tiles, steps = _ceil(m, SHARD_STATS_ROWS), _ceil(k, 64)
    w_bytes = steps * sum(_ceil(w, 64) for _, w in cols) * _BOX_BYTES
    x_box = SHARD_STATS_ROWS * 128
    smem = (SHARD_STATS_STAGES * (x_box + SHARD_STATS_TILE // 64 * _BOX_BYTES)
            + 2 * SHARD_STATS_TILE // 64 * _BOX_BYTES + (WGMMA_MAX_N + SHARD_STATS_TILE) * 4
            + 1024)
    return ShardStatsPlan(tile, len(cols), cols[-1][1], row_tiles, min(row_tiles, sm_count),
                          smem, w_bytes + len(cols) * steps * x_box, w_bytes)


class ShardChainPlan(NamedTuple):
    """A launch of entry 3 or 4: vectors of ``vec`` values, ``lanes`` lanes
    a row, ``chunks`` vectors a lane, so ``tiles`` tiles of lanes * chunks *
    vec columns a row (blockIdx.y); ``blocks`` blocks a tile of ``rows``
    contiguous rows each."""
    vec: int
    lanes: int
    chunks: int
    tiles: int
    blocks: int
    rows: int


def _shard_shape(dtype: torch.dtype, n: int, align: int) -> tuple[int, int, int, int]:
    """(vec, lanes, chunks, tiles) of a row of n values whose bases and row
    strides are ``align``-byte aligned. For each vector of at most 16 bytes
    that n and ``align`` allow: the lanes a row (a power of two up to 32) and
    chunks a lane (at most SHARD_CHUNKS vectors and SHARD_VALUES values)
    with the fewest column slots, the fewest lanes among them; a row beyond
    32 lanes' reach in tiles of 32 lanes. Of those, the widest vector whose
    slots past n (idle lanes) are at most an eighth of its slots, else the
    fewest slots."""
    el = dtype.itemsize
    shapes = []  # (slots, vec, lanes, chunks, tiles), widest vector first
    for vec in (8, 4, 2, 1):
        if vec * el > 16 or n % vec or align % (vec * el):
            continue
        vectors = n // vec
        most = min(SHARD_CHUNKS, SHARD_VALUES // vec)
        if vectors > 32 * most:
            tiles = _ceil(vectors, 32 * most)
            lanes, chunks = 32, _ceil(vectors, 32 * tiles)
        else:
            tiles = 1
            lanes, chunks = min(((lane, _ceil(vectors, lane)) for lane in (1, 2, 4, 8, 16, 32)
                                 if _ceil(vectors, lane) <= most), key=lambda lc: lc[0] * lc[1])
        shapes.append((tiles * lanes * chunks * vec, vec, lanes, chunks, tiles))
    tight = [s for s in shapes if 8 * (s[0] - n) <= s[0]]
    return (tight[0] if tight else min(shapes, key=lambda s: s[0]))[1:]


def shard_chain_plan(dtype: torch.dtype, m: int, n: int, align: int = 16, sm_count: int = 132,
                     occupancy=None) -> ShardChainPlan:
    """Entry 3's or 4's launch for h and g [m, n] whose bases (h, g, dh,
    gamma, beta) are all ``align``-byte aligned: ``_shard_shape``'s vector,
    lanes, chunks and tiles. The grid: ``occupancy(vec, chunks)`` blocks an
    SM (the card's answer; SHARD_BLOCKS_PER_SM when None), at most
    SHARD_BLOCKS_PER_SM, on ``sm_count`` SMs, shared among the tiles, at
    most one a row; the rows split evenly, so no block is empty."""
    vec, lanes, chunks, tiles = _shard_shape(dtype, n, align)
    per_sm = SHARD_BLOCKS_PER_SM if occupancy is None else occupancy(vec, chunks)
    if per_sm < 1:
        raise ValueError(f"entry 3/4's block ({vec}, {chunks}) does not fit an SM")
    per_sm = min(per_sm, SHARD_BLOCKS_PER_SM)
    rows = _ceil(m, min(m, max(1, per_sm * sm_count // tiles)))
    return ShardChainPlan(vec, lanes, chunks, tiles, _ceil(m, rows), rows)


@functools.lru_cache(maxsize=None)
def _shard_occupancy(device_index: int, dtype: torch.dtype, dh_phase: bool, vec: int,
                     chunks: int) -> int:
    """Blocks of entry 3's (or, ``dh_phase``, 4's) instance an SM of the card
    holds, asked once."""
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        check(load_library().fused_spectre_linear_shard_occupancy(
            _DTYPE_CODES[dtype], int(dh_phase), vec, chunks, ctypes.byref(per_sm)),
            "fused_spectre_linear_shard_occupancy")
    return per_sm.value


def _shard_plan(h, dh_phase: bool, *tensors) -> ShardChainPlan:
    """``shard_chain_plan`` for operands on the current card."""
    m, n = h.shape
    dev = h.get_device()
    return shard_chain_plan(h.dtype, m, n, _alignment(h, *tensors), _sm_count(dev),
                            functools.partial(_shard_occupancy, dev, h.dtype, dh_phase))


class ShardLnPlan(NamedTuple):
    """A launch of entry 2: vectors of ``vec`` values, ``lanes`` lanes a
    row, ``chunks`` vectors a lane (0: a block of SHARD_THREADS walks each
    whole row), so ``tiles`` tiles of lanes * chunks * vec columns a row: a
    shard's on blockIdx.y, or a whole row's as the ``warps`` warps of a team
    in one block; ``threads`` a block; ``blocks`` blocks (a tile) of
    ``rows`` contiguous rows each."""
    vec: int
    lanes: int
    chunks: int
    tiles: int
    warps: int
    threads: int
    blocks: int
    rows: int


def shard_ln_plan(dtype: torch.dtype, m: int, n: int, align: int = 16, whole: bool = False,
                  sm_count: int = 132, occupancy=None) -> ShardLnPlan:
    """Entry 2's launch for h [m, n] of ``dtype`` (the input's) whose bases
    and row strides (h, the residual; out, h_out, gamma, beta, bias in their
    own dtype) are aligned to ``align`` bytes of it (``align / itemsize``
    elements of each): ``_shard_shape``'s vector, lanes, chunks and
    tiles. A shard's tiles go on blockIdx.y; a ``whole`` row's tiles are
    the warps of one team (up to SHARD_THREADS / 32 of them, which meet in
    shared memory), and a wider whole row is walked. Teams of lanes * warps
    threads fill a block of at most SHARD_THREADS. The grid:
    ``occupancy(vec, chunks, threads)`` blocks an SM (the card's answer; as
    many as SM_THREADS allow when None), on ``sm_count`` SMs, shared among
    the tiles, at most one a row; the rows split evenly, so no block is
    empty."""
    vec, lanes, chunks, tiles = _shard_shape(dtype, n, align)
    warps = 1
    if whole and tiles > 1:
        if tiles <= SHARD_THREADS // 32:
            warps, tiles = tiles, 1
        else:
            lanes, chunks, tiles, warps = 32, 0, 1, SHARD_THREADS // 32
    width = lanes * warps
    threads = SHARD_THREADS // width * width
    per_sm = SM_THREADS // threads if occupancy is None else occupancy(vec, chunks, threads)
    if per_sm < 1:
        raise ValueError(f"entry 2's block ({vec}, {chunks}, {threads}) does not fit an SM")
    rows = _ceil(m, min(m, max(1, per_sm * sm_count // tiles)))
    return ShardLnPlan(vec, lanes, chunks, tiles, warps, threads, _ceil(m, rows), rows)


def _shard_ln_align(h, residual, *outputs) -> int:
    """The alignment, in bytes of h's dtype, that a vector of entry 2 has in
    every operand: in h's elements for h and the residual, in gamma's for
    ``outputs`` (gamma, beta, bias, out, the saved h; None skipped)."""
    el, el_out = h.element_size(), outputs[0].element_size()
    return el * min(_alignment(h, residual) // el, _alignment(*outputs) // el_out)


@functools.lru_cache(maxsize=256)
def _shard_ln_launch(device_index: int, in_dtype: torch.dtype, out_dtype: torch.dtype, m: int,
                     n: int, align: int, whole: bool) -> ShardLnPlan:
    """``shard_ln_plan`` on the card, kept for each shape: the wrapper's
    host time a call stays below the kernel's at the flagship's shards."""
    return shard_ln_plan(in_dtype, m, n, align, whole, _sm_count(device_index),
                         functools.partial(_shard_ln_occupancy, device_index, in_dtype,
                                           out_dtype, whole))


@functools.lru_cache(maxsize=None)
def _shard_ln_occupancy(device_index: int, in_dtype: torch.dtype, out_dtype: torch.dtype,
                        whole: bool, vec: int, chunks: int, threads: int) -> int:
    """Blocks of entry 2's instance (a ``whole`` row's or a shard's) of
    ``threads`` threads an SM of the card holds, asked once."""
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        check(load_library().fused_spectre_linear_shard_ln_occupancy(
            _DTYPE_CODES[in_dtype], _DTYPE_CODES[out_dtype], int(whole), vec, chunks, threads,
            ctypes.byref(per_sm)), "fused_spectre_linear_shard_ln_occupancy")
    return per_sm.value


def _on_card(name, *tensors) -> bool:
    """Whether the operands want the kernel (all on one card) rather than
    the plain version (all on the CPU); raises for anything else."""
    dev = tensors[0].device
    for t in tensors:
        if t is not None and t.device != dev:
            raise ValueError(f"{name}: all operands must be on {dev}; got {t.device}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {dev}")
    return True


def _check_dtype(name, dtype, *tensors) -> None:
    for t in tensors:
        if t is not None and t.dtype != dtype:
            raise TypeError(f"{name}: want {dtype}, got {t.dtype}")
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} takes float32 or bfloat16, not {dtype}")


@functools.lru_cache(maxsize=256)
def _shard_stats_launch(device_index: int, m: int, k: int, n: int) -> tuple[int, int]:
    """``shard_stats_plan``'s (tile_n, grid) on the card, kept for each
    shape: the wrapper's host time a call stays below the kernel's."""
    p = shard_stats_plan(m, k, n, _sm_count(device_index))
    return p.tile_n, p.grid


def fused_spectre_linear_shard_stats_wgmma(x, w, b, h, stats) -> None:
    """Launch entry 1's bf16 kernel on checked operands of the current
    device into ``h`` and ``stats``, on ``shard_stats_plan``'s launch."""
    (m, k), n = x.shape, w.shape[1]
    dev = x.get_device()
    tile_n, grid = _shard_stats_launch(dev, m, k, n)
    err = load_library().fused_spectre_linear_shard_stats_wgmma(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), h.data_ptr(), stats.data_ptr(), m, k, n,
        tile_n, grid, current_stream(dev))
    check(err, "fused_spectre_linear_shard_stats_wgmma launch")
    fused_spectre_linear_shard_stats_wgmma.launches += 1


def fused_spectre_linear_shard_stats(x, w, b):
    """Entry 1: (h [M, n] in x's dtype, (mean, M2) [M, 2] float32) for x
    [M, K], w [K, n], b [n], all contiguous; on the card the kernel
    ``shard_stats_kernel`` names, which counts the launch too."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0] or b.shape != (w.shape[1],):
        raise ValueError(f"want x [M, K], w [K, n], b [n]; got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}, {tuple(b.shape)}")
    _check_dtype("fused_spectre_linear_shard_stats", x.dtype, w, b)
    if not all(t.is_contiguous() for t in (x, w, b)):
        raise ValueError("fused_spectre_linear_shard_stats needs contiguous operands")
    if not _on_card("fused_spectre_linear_shard_stats", x, w, b):
        return shard_stats_plain(x, w, b)
    dev = x.get_device()
    if dev != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return fused_spectre_linear_shard_stats(x, w, b)
    (m, k), n = x.shape, w.shape[1]
    h = torch.empty((m, n), dtype=x.dtype, device=x.device)
    stats = torch.empty((m, 2), dtype=torch.float32, device=x.device)
    if m == 0:
        return h, stats
    route = shard_stats_kernel(x.dtype, k, n, x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
    if route == "fused_spectre_linear_shard_stats_wgmma":
        fused_spectre_linear_shard_stats_wgmma(x, w, b, h, stats)
    else:
        p = cluster_plan(x.dtype, m, k, n, _sm_count(dev))
        check(load_library().fused_spectre_linear_shard_stats(
            _DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(), b.data_ptr(), h.data_ptr(),
            stats.data_ptr(), m, k, n, p.bm, p.bn, p.cn, p.ck, p.kc, current_stream(dev)),
            "fused_spectre_linear_shard_stats launch (fused_spectre_linear_cluster)")
        fused_spectre_linear_cluster.launches += 1
    fused_spectre_linear_shard_stats.launches += 1
    return h, stats


def sharded_ln_gelu(h, stats, gamma, beta, n_full: int, bias=None, residual=None,
                    eps: float = 1e-5):
    """Entry 2: (out [M, n] in gamma's dtype, (mean, rstd) [M, 2] float32, h
    saved or None), as ``sharded_ln_gelu_plain`` states. h [M, n] and the
    residual [M, n] (one dtype; rows may be strided) are a column shard in
    gamma's dtype when ``stats`` [size, M, 2] float32 are given
    (n_full = size * n), else a whole row in float32 (with ``bias``,
    n_full = n); bf16 or float32."""
    m, n = h.shape
    if stats is None:
        if bias is None or n_full != n:
            raise ValueError("a whole row needs its bias and n_full == n")
    elif stats.shape != (stats.shape[0], m, 2) or n_full != stats.shape[0] * n \
            or stats.dtype != torch.float32:
        raise ValueError(f"want stats [size, {m}, 2] float32 of size * {n} = {n_full} "
                         f"columns; got {tuple(stats.shape)} {stats.dtype}")
    _check_dtype("sharded_ln_gelu", gamma.dtype, beta, bias)
    _check_dtype("sharded_ln_gelu", h.dtype, residual)
    for name, t in (("gamma", gamma), ("beta", beta), ("bias", bias)):
        if t is not None and (t.shape != (n,) or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous [{n}], got {tuple(t.shape)}")
    if residual is not None and residual.shape != (m, n):
        raise ValueError(f"residual must be [{m}, {n}], got {tuple(residual.shape)}")
    codes = (_DTYPE_CODES[h.dtype], _DTYPE_CODES[gamma.dtype])
    if codes not in ((1, 1), (0, 1), (0, 0)):
        raise TypeError(f"sharded_ln_gelu takes h in {gamma.dtype} or float32; got {h.dtype}")
    if not _on_card("sharded_ln_gelu", h, stats, gamma, beta, bias, residual):
        return sharded_ln_gelu_plain(h, stats, gamma, beta, n_full, bias, residual, eps)
    dev = h.get_device()
    if dev != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return sharded_ln_gelu(h, stats, gamma, beta, n_full, bias, residual, eps)
    if h.stride(-1) != 1:
        h = h.contiguous()
    if residual is not None and residual.stride(-1) != 1:
        residual = residual.contiguous()
    if stats is not None:
        stats = stats.contiguous()
    out = torch.empty((m, n), dtype=gamma.dtype, device=h.device)
    mstats = torch.empty((m, 2), dtype=torch.float32, device=h.device)
    saved = torch.empty_like(out) if stats is None else None
    if m == 0:
        return out, mstats, saved

    def ptr(t):
        return None if t is None else t.data_ptr()

    plan = _shard_ln_launch(dev, h.dtype, gamma.dtype, m, n,
                            _shard_ln_align(h, residual, gamma, beta, bias, out, saved),
                            stats is None)
    err = load_library().fused_spectre_linear_shard_ln(
        *codes, h.data_ptr(), h.stride(0), ptr(stats),
        1 if stats is None else stats.shape[0], ptr(bias), gamma.data_ptr(), beta.data_ptr(),
        ptr(residual), 0 if residual is None else residual.stride(0), out.data_ptr(),
        ptr(saved), mstats.data_ptr(), m, n, n_full, eps, plan.blocks, plan.vec, plan.lanes,
        plan.chunks, plan.warps, current_stream(dev))
    if err:
        check(err, f"sharded_ln_gelu launch ({plan})")
    sharded_ln_gelu.launches += 1
    return out, mstats, saved


def _chain_operands(name, h, g, gamma, beta, mstats) -> tuple[int, int]:
    m, n = h.shape
    if g.shape != (m, n) or gamma.shape != (n,) or beta.shape != (n,) \
            or mstats.shape != (m, 2) or mstats.dtype != torch.float32:
        raise ValueError(f"{name}: want h, g [M, n], gamma, beta [n], mstats [M, 2] float32; "
                         f"got {tuple(h.shape)}, {tuple(g.shape)}, {tuple(gamma.shape)}, "
                         f"{tuple(beta.shape)}, {tuple(mstats.shape)} {mstats.dtype}")
    _check_dtype(name, h.dtype, g, gamma, beta)
    if not all(t.is_contiguous() for t in (h, g, gamma, beta, mstats)):
        raise ValueError(f"{name} needs contiguous operands")
    return m, n


def chain_shard_sums(h, g, gamma, beta, mstats):
    """Entry 3: ((sum du, sum du u) [M, 2] float32, [dgamma, dbeta] [2, n] in
    h's dtype) over this rank's columns, as ``chain_shard_sums_plain``
    states."""
    m, n = _chain_operands("chain_shard_sums", h, g, gamma, beta, mstats)
    if not _on_card("chain_shard_sums", h, g, gamma, beta, mstats):
        return chain_shard_sums_plain(h, g, gamma, beta, mstats)
    dev = h.get_device()
    if dev != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return chain_shard_sums(h, g, gamma, beta, mstats)
    rows = torch.empty((m, 2), dtype=torch.float32, device=h.device)
    if m == 0:
        return rows, torch.zeros((2, n), dtype=h.dtype, device=h.device)
    sums = torch.empty((2, n), dtype=h.dtype, device=h.device)
    plan = _shard_plan(h, False, g, gamma, beta)
    # the blocks' partial rows, then the tiles' row sums where a row has several
    partial = torch.empty(plan.blocks * 2 * n + (plan.tiles * m * 2 if plan.tiles > 1 else 0),
                          dtype=torch.float32, device=h.device)
    check(load_library().fused_spectre_linear_shard_sums(
        _DTYPE_CODES[h.dtype], h.data_ptr(), g.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        mstats.data_ptr(), rows.data_ptr(), sums.data_ptr(), partial.data_ptr(), m, n,
        plan.blocks, plan.vec, plan.lanes, plan.chunks, current_stream(dev)),
        f"chain_shard_sums launch ({plan})")
    chain_shard_sums.launches += 1
    return rows, sums


def chain_shard_dh(h, g, gamma, beta, mstats, rowsums, n_full: int):
    """Entry 4: (dh [M, n], db [n]) in h's dtype from the ranks' row sums
    [size, M, 2] float32 (n_full = size * n), as ``chain_shard_dh_plain``
    states."""
    m, n = _chain_operands("chain_shard_dh", h, g, gamma, beta, mstats)
    if rowsums.shape != (rowsums.shape[0], m, 2) or rowsums.dtype != torch.float32 \
            or n_full != rowsums.shape[0] * n:
        raise ValueError(f"chain_shard_dh: want rowsums [size, {m}, 2] float32 of size * {n} "
                         f"= {n_full} columns; got {tuple(rowsums.shape)} {rowsums.dtype}")
    if not _on_card("chain_shard_dh", h, g, gamma, beta, mstats, rowsums):
        return chain_shard_dh_plain(h, g, gamma, beta, mstats, rowsums, n_full)
    dev = h.get_device()
    if dev != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return chain_shard_dh(h, g, gamma, beta, mstats, rowsums, n_full)
    dh = torch.empty_like(h)
    if m == 0:
        return dh, torch.zeros((n,), dtype=h.dtype, device=h.device)
    db = torch.empty((n,), dtype=h.dtype, device=h.device)
    rowsums = rowsums.contiguous()
    plan = _shard_plan(h, True, g, gamma, beta, dh)
    partial = torch.empty((plan.blocks, n), dtype=torch.float32, device=h.device)
    check(load_library().fused_spectre_linear_shard_dh(
        _DTYPE_CODES[h.dtype], h.data_ptr(), g.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        mstats.data_ptr(), rowsums.data_ptr(), rowsums.shape[0], dh.data_ptr(), db.data_ptr(),
        partial.data_ptr(), m, n, n_full, plan.blocks, plan.vec, plan.lanes, plan.chunks,
        current_stream(dev)), f"chain_shard_dh launch ({plan})")
    chain_shard_dh.launches += 1
    return dh, db


for _fn in (fused_spectre_linear_shard_stats, fused_spectre_linear_shard_stats_wgmma,
            sharded_ln_gelu, chain_shard_sums, chain_shard_dh):
    _fn.launches = 0
