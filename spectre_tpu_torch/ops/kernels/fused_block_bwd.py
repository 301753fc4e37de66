"""Kernel 5: the folded mix's backward, fused.

``dxt[j*blk + t, b] = sum_h s4f[r] * sum_o dy[n_r, b, o] * w[e_r, o]`` with
``r = h*d + binv[h, j]*blk + t``, ``n_r = r // EH``, ``e_r = r % EH`` and
``s4f`` the flat view of ``s4``: dy [N, B, O], w [EH, O], s4 [N, EH] of +-1,
binv [H, d/blk] -> dxt [d, B]. It is ``block_gather_sum`` of the ``dg4`` that
``ops.fused_mix._FoldedProj.backward`` makes, without the [H*d, B] cotangent
in device memory. The CUDA kernels are in ``csrc/fused_block_bwd.cu`` (they
replace the TPU kernel ``spectre_tpu/ops/pallas/bwd_gather.py::fused_block_bwd_pallas``):
``fused_block_bwd_wgmma``, bf16 with blk a multiple of 64 on Hopper's wgmma +
TMA mainloop (``csrc/wgmma_gemm.cuh``), and ``fused_block_bwd_grouped``,
float32 on the FP32 pipes (no TF32) and bf16 with blk % 64 != 0 on wgmma: a
block owns a run of output rows and takes its (head, slab) pairs in steps
grouped by source token, so that a token's dy tile is read once for all its
slabs (the launch's shape is ``grouped_plan``'s). ``block_bwd_kernel``
decides which one a call launches.

With ``dpool`` [N, B, O] and ``grp`` (EH = O * grp), the cotangent of the
folded mix's pool residual ``pool[n, b, u] = sum_v g4[n, u*grp + v, b] *
s4[n, u*grp + v] / grp`` joins the sum: each head's product gets
``dpool[n_r, b, e_r // grp] / grp`` before its sign, so the result is the
whole input cotangent of ``ops.fused_mix.folded_mix_pool``. Only the wgmma
kernel takes it, and only with grp a multiple of 16 (a warp's 16 rows then
read one pool column); dpool may be strided in N and B, with u contiguous.
The train step calls it so from ``folded_mix_pool``'s backward where
``fuses_mix_backward`` holds (bf16, blk % 64 == 0, no route); every other
case keeps the chain. ``python -m spectre_tpu_torch.repl.perf fused-bwd``
times it against the chain.

The kernel takes ``blk`` a multiple of 16 that divides EH (a source block
never straddles a token), O a multiple of 8, at most 128 heads, any B >= 1,
float32 or bfloat16. A uniform table (blk = 1) is outside its contract, as it
is outside the TPU kernel's. The wrapper raises on anything else.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. There is no fallback from a CUDA tensor to the plain path.
"""

from __future__ import annotations

import torch

from spectre_tpu_torch.ops.kernels.build import check, current_stream, load_library

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEADS = 128  # the per-block table of head coordinates (csrc/fused_block_bwd.cu)


def fused_block_bwd_plain(dy: torch.Tensor, w: torch.Tensor, s4: torch.Tensor,
                          binv: torch.Tensor, blk: int, dpool: torch.Tensor | None = None,
                          grp: int = 0) -> torch.Tensor:
    """Plain PyTorch version, in the kernel's arithmetic: per head a float32
    product of the block's rows of ``w`` with its token's ``dy``, with the
    pool term ``dpool[n, b, e // grp] * (1/grp)`` added to it in float32
    when ``dpool`` is given, signed and added in head order in float32; one
    cast at the end. (The chain rounds ``dg4`` to the data type per head
    before it adds.) Any blk >= 1 that divides EH, any grp with EH = O * grp."""
    h, nb = binv.shape
    n_tok, b, o = dy.shape
    eh = w.shape[0]
    d = nb * blk
    dev = dy.device
    start = torch.arange(h, device=dev)[:, None] * d + binv.long() * blk  # [H, nb]
    rows = torch.arange(blk, device=dev)
    wf, dyf, sf = w.float(), dy.float(), s4.reshape(-1).float()
    dpf = None if dpool is None else dpool.float()
    acc = torch.zeros(nb, blk, b, dtype=torch.float32, device=dev)
    for i in range(h):
        n, e0 = start[i] // eh, start[i] % eh
        part = torch.bmm(wf[e0[:, None] + rows], dyf[n].transpose(1, 2))  # [nb, blk, B]
        if dpf is not None:  # [nb, blk, B]: each row's pool column, all of B;
            # 1/grp meets the float32 values as a float32 scalar, as in the kernel
            part = part + dpf[n[:, None], :, (e0[:, None] + rows) // grp] * (1.0 / grp)
        acc += sf[start[i][:, None] + rows][:, :, None] * part
    return acc.to(dy.dtype).reshape(d, b)


def _validate(dy, w, s4, binv, blk: int) -> None:
    if dy.dim() != 3 or w.dim() != 2 or s4.dim() != 2 or binv.dim() != 2:
        raise ValueError(f"want dy [N, B, O], w [EH, O], s4 [N, EH], binv [H, d/blk]; got "
                         f"{tuple(dy.shape)}, {tuple(w.shape)}, {tuple(s4.shape)}, "
                         f"{tuple(binv.shape)}")
    if dy.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_block_bwd takes float32 or bfloat16, not {dy.dtype}")
    if w.dtype != dy.dtype or s4.dtype != dy.dtype:
        raise TypeError(f"w and s4 must share dy's dtype {dy.dtype}; got {w.dtype}, {s4.dtype}")
    if binv.dtype != torch.int32:
        raise TypeError(f"binv must be int32, not {binv.dtype}")
    n_tok, b, o = dy.shape
    eh = w.shape[0]
    h, nb = binv.shape
    if blk == 1:
        raise ValueError("fused_block_bwd takes a block table (blk a multiple of 16), not a "
                         "uniform one (blk = 1): use folded_proj's backward and "
                         "inverse_gather_sum")
    if blk < 16 or blk % 16:
        raise ValueError(f"fused_block_bwd needs blk a multiple of 16, got {blk}")
    if eh % blk:
        raise ValueError(f"blk={blk} must divide EH={eh}: a source block may not straddle "
                         "a token")
    if w.shape[1] != o or tuple(s4.shape) != (n_tok, eh) or n_tok * eh != h * nb * blk:
        raise ValueError(f"shapes disagree: dy {tuple(dy.shape)}, w {tuple(w.shape)}, s4 "
                         f"{tuple(s4.shape)}, binv {tuple(binv.shape)}, blk {blk} "
                         "(want N*EH == H*d)")
    if o % 8:
        raise ValueError(f"fused_block_bwd needs O a multiple of 8 (16-byte copies), got {o}")
    if not 1 <= h <= MAX_HEADS or b < 1:
        raise ValueError(f"fused_block_bwd takes 1..{MAX_HEADS} heads and B >= 1; got H={h}, "
                         f"B={b}")
    for t in (dy, w, s4, binv):
        if t.device != dy.device:
            raise ValueError(f"all operands must be on {dy.device}; got {t.device}")
        if not t.is_contiguous():
            raise ValueError("fused_block_bwd needs contiguous operands")
    if dy.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("fused_block_bwd needs dy and w aligned to 16 bytes")


def _validate_pool(dy, w, dpool, grp: int) -> None:
    n_tok, b, o = dy.shape
    if dpool.dtype != dy.dtype or dpool.device != dy.device:
        raise TypeError(f"dpool must share dy's dtype and device; got {dpool.dtype} on "
                        f"{dpool.device}")
    if tuple(dpool.shape) != (n_tok, b, o):
        raise ValueError(f"dpool must be [N, B, O] = {(n_tok, b, o)}, got {tuple(dpool.shape)}")
    if grp < 1 or w.shape[0] != o * grp:
        raise ValueError(f"the pool needs EH = O * grp; got EH={w.shape[0]}, O={o}, grp={grp}")


def block_bwd_kernel(dtype: torch.dtype, blk: int) -> str:
    """The name of the CUDA kernel that runs a call on the card:
    ``fused_block_bwd_wgmma`` for bfloat16 with blk a multiple of 64 (a
    64-row wgmma tile then lies in one token), else
    ``fused_block_bwd_grouped``."""
    if dtype == torch.bfloat16 and blk % 64 == 0:
        return "fused_block_bwd_wgmma"
    return "fused_block_bwd_grouped"


# the grouped kernel's shapes (csrc/fused_block_bwd.cu: GbCfg, GfCfg,
# kMaxPairs): batch columns a block, rows of dxt a block by dtype, and the
# (head, slab) pairs a block's schedule holds
GROUPED_BT = 128
GROUPED_ROWS = {torch.bfloat16: 256, torch.float32: 128}
GROUPED_MAX_PAIRS = 256


def grouped_plan(dtype: torch.dtype, heads: int, blk: int) -> tuple[int, int]:
    """(sb, J) of the grouped kernel: slabs of sb rows (64, 32 or 16, the
    largest that divides blk: a block of the table is a run of slabs), J
    slabs (J * sb rows of dxt) a thread block, as many as its rows allow
    with at most GROUPED_MAX_PAIRS (head, slab) pairs."""
    sb = 64 if blk % 64 == 0 else 32 if blk % 32 == 0 else 16
    return sb, min(GROUPED_ROWS[dtype] // sb, max(1, GROUPED_MAX_PAIRS // heads))


def _dims(dy, w, binv, blk: int) -> tuple:
    n_tok, b, o = dy.shape
    h, nb = binv.shape
    return h, nb, blk, n_tok, w.shape[0], o, b


def fused_block_bwd_wgmma(dy, w, s4, binv, blk: int, out, dpool=None, grp: int = 0) -> None:
    """Launch the bf16 wgmma kernel on checked operands of the current
    device into ``out``, with the pool term when ``dpool`` (u contiguous)
    is given."""
    pool = (None, 0, 0, 0) if dpool is None else \
        (dpool.data_ptr(), dpool.stride(0), dpool.stride(1), grp)
    err = load_library().fused_block_bwd_wgmma(
        dy.data_ptr(), w.data_ptr(), s4.data_ptr(), binv.data_ptr(), out.data_ptr(),
        *_dims(dy, w, binv, blk), *pool, current_stream(dy.get_device()))
    check(err, "fused_block_bwd_wgmma launch")
    fused_block_bwd_wgmma.launches += 1


def fused_block_bwd_grouped(dy, w, s4, binv, blk: int, out) -> None:
    """Launch the token-grouped kernel (float32, or bf16 with blk % 64 != 0)
    on checked operands of the current device into ``out``, with
    ``grouped_plan``'s shape."""
    sb, j = grouped_plan(dy.dtype, binv.shape[0], blk)
    err = load_library().fused_block_bwd_grouped(
        _DTYPE_CODES[dy.dtype], dy.data_ptr(), w.data_ptr(), s4.data_ptr(), binv.data_ptr(),
        out.data_ptr(), *_dims(dy, w, binv, blk), sb, j, current_stream(dy.get_device()))
    check(err, f"fused_block_bwd_grouped launch (sb={sb}, J={j})")
    fused_block_bwd_grouped.launches += 1


fused_block_bwd_wgmma.launches = 0
fused_block_bwd_grouped.launches = 0
_KERNELS = {fn.__name__: fn for fn in (fused_block_bwd_wgmma, fused_block_bwd_grouped)}


def fused_block_bwd(dy: torch.Tensor, w: torch.Tensor, s4: torch.Tensor,
                    binv: torch.Tensor, blk: int, dpool: torch.Tensor | None = None,
                    grp: int = 0) -> torch.Tensor:
    """dy [N, B, O], w [EH, O], s4 [N, EH], binv [H, d/blk] -> dxt [d, B],
    with the pool residual's cotangent dpool [N, B, O] (any strides) when
    given, EH = O * grp. On the card it launches the kernel
    ``block_bwd_kernel`` names; ``launches`` counts both. The pool term runs
    on the wgmma kernel with grp a multiple of 16 only; elsewhere on the
    card it raises."""
    _validate(dy, w, s4, binv, blk)
    if dpool is not None:
        _validate_pool(dy, w, dpool, grp)
    if dy.device.type == "cpu":
        return fused_block_bwd_plain(dy, w, s4, binv, blk, dpool, grp)
    if dy.device.type != "cuda":
        raise RuntimeError(f"fused_block_bwd: no kernel for device {dy.device}")
    dev = dy.get_device()
    if dev != torch.cuda.current_device():  # the kernel launches on the current device
        with torch.cuda.device(dev):
            return fused_block_bwd(dy, w, s4, binv, blk, dpool, grp)
    route = block_bwd_kernel(dy.dtype, blk)
    out = torch.empty((binv.shape[1] * blk, dy.shape[1]), dtype=dy.dtype, device=dy.device)
    if dpool is None:
        _KERNELS[route](dy, w, s4, binv, blk, out)
    else:
        if route != "fused_block_bwd_wgmma" or grp % 16:
            raise ValueError(f"the pool term runs on the wgmma kernel (bf16, blk % 64 == 0) "
                             f"with grp a multiple of 16; got {dy.dtype}, blk={blk}, grp={grp}")
        if dpool.stride(2) != 1:
            dpool = dpool.contiguous()
        fused_block_bwd_wgmma(dy, w, s4, binv, blk, out, dpool, grp)
    fused_block_bwd.launches += 1
    return out


fused_block_bwd.launches = 0
