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


def fused_spectre_linear_bwd_plain(x, w, gamma, beta, h, g, eps: float = 1e-5):
    """Plain PyTorch version of the backward: (dx, dw, db, dgamma, dbeta)
    from the saved pre-LN ``h`` and the cotangent ``g`` of the output (the
    K != N pool residual's part of dx stays with the caller). The chain in
    float32; for bf16 inputs dh is rounded to bf16 before the two products,
    whose sums are float32; one cast of each gradient."""
    _bwd_validate(x, w, gamma, beta, h, g)
    k, n = w.shape
    dh, dgamma, dbeta, db = _chain_plain(h.reshape(-1, n), g.reshape(-1, n), gamma, beta, eps)
    dh_op = dh.to(x.dtype).float()  # the products' operand: rounded for bf16
    dw = torch.matmul(x.reshape(-1, k).float().t(), dh_op)
    dx = torch.matmul(dh_op, w.float().t())
    if k == n:
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
    """The largest power of two up to 16 that divides every base address."""
    bases = 16
    for t in tensors:
        bases |= t.data_ptr()
    return bases & -bases


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


def fused_spectre_linear_bwd(x, w, gamma, beta, h, g, eps: float = 1e-5):
    """(dx, dw, db, dgamma, dbeta) of ``fused_spectre_linear`` from the saved
    pre-LN ``h`` and the cotangent ``g``: the chain kernel
    (``backward_kernel``), then the two products (bf16 operands and float32
    sums for bf16 inputs). ``launches`` counts both chains,
    ``fused_spectre_linear_bwd_wide.launches`` the wide one."""
    _bwd_validate(x, w, gamma, beta, h, g)
    if x.device.type == "cpu":
        return fused_spectre_linear_bwd_plain(x, w, gamma, beta, h, g, eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_spectre_linear_bwd: no kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_spectre_linear_bwd takes float32 or bfloat16, not {x.dtype}")
    k, n = w.shape
    if not all(t.is_contiguous() for t in (x, w, gamma, beta, h, g)):
        raise ValueError("fused_spectre_linear_bwd needs contiguous operands")
    dev = x.get_device()
    if dev != torch.cuda.current_device():  # the kernel launches on the current device
        with torch.cuda.device(dev):
            return fused_spectre_linear_bwd(x, w, gamma, beta, h, g, eps)
    m = h.numel() // n
    x2, g2 = x.reshape(m, k), g.reshape(m, n)
    if m == 0:
        dh = torch.empty((m, n), dtype=x.dtype, device=x.device)
        sums = torch.zeros((3, n), dtype=x.dtype, device=x.device)
    else:
        dh, sums = backward_chain(h.reshape(m, n), g2, gamma, beta, eps)
        fused_spectre_linear_bwd.launches += 1
    if x.dtype == torch.bfloat16:  # float32 sums, one rounding
        dw = torch.mm(x2.t(), dh, out_dtype=torch.float32).to(w.dtype)
    else:
        dw = torch.mm(x2.t(), dh)
    # the identity residual joins the product's float32 sum before its rounding
    dx = torch.addmm(g2, dh, w.t()) if k == n else torch.mm(dh, w.t())
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
