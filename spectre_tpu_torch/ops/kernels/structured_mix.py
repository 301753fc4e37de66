"""Kernel 7: the tile-structured mix, forward and backward.

Per head h and tile j, with t = d / T and H_t the normalised Hadamard matrix:

    out[b, h*d + j*t : +t] = signs[h, j*t : +t] * (x[b, tile_perms[h, j]*t : +t] @ H_t)

x is batch-major [B, d] (or [B, N, E]); the result [B, H*d] is read as
[B, token_dim, -1]. The CUDA kernels are in ``csrc/structured_mix.cu``. The
forward replaces the TPU kernel
``spectre_tpu/ops/pallas/structured_mix.py::structured_mix_pallas``; the
backward, jnp in the JAX package (its ``_bwd``), is a second kernel here
built from the same butterfly: ``dx[b, src] = (sum_h signs * g at the tile of
head h that read src) @ H_t``, the head sum taken first because the
transform is linear. Both kernels work by source tile and read only the
inverse table ``inv[h, tile_perms[h, j]] = j``, so every row of
``tile_perms`` must be a permutation of range(T) (``MHPermutMix`` validates
its buffer); the wrappers derive ``inv`` on the device unless it is passed.
Every shape goes through the kernels: any B >= 1 and any power-of-two tile
up to 256 (the JAX wrapper's fallback for ``t % 128 or B % 8`` is a TPU block
rule and has no counterpart).

The plain versions state the kernels' arithmetic: widen to float32, the
butterfly of ``fwht_plain``, one multiply by t^-1/2, the sign, one cast (the
backward: the float32 sum over heads in head order first). Kernel and plain
version agree bit for bit. ``ops/permute.py::structured_mix`` is the JAX
package's matrix form of the same function.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. There is no fallback from a CUDA tensor to the plain path.
"""

from __future__ import annotations

import torch

from spectre_tpu_torch.ops.kernels.build import check, load_library
from spectre_tpu_torch.ops.kernels.fwht import fwht_plain

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_TILE = 256  # a tile is held by at most one warp (csrc/structured_mix.cu)


def invert_tile_perms(tile_perms: torch.Tensor) -> torch.Tensor:
    """int32 [H, T] with ``inv[h, tile_perms[h, j]] = j``, on the same device
    (argsort of a permutation inverts it; no host sync)."""
    return torch.argsort(tile_perms.long(), dim=-1).to(torch.int32)


def _shapes(x: torch.Tensor, tile_perms: torch.Tensor, signs: torch.Tensor,
            name: str) -> tuple[int, int, int, int]:
    """(B, H, T, t) after validating dtypes, devices and sizes; x is [B, ...]
    with d values per row, or (the backward) H*d."""
    if tile_perms.dim() != 2 or tile_perms.dtype != torch.int32:
        raise TypeError(f"{name}: tile_perms must be int32 [H, T], got {tile_perms.dtype} "
                        f"{tuple(tile_perms.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} takes float32 or bfloat16, not {x.dtype}")
    h, n_tiles = tile_perms.shape
    if h < 1 or n_tiles < 1 or signs.numel() % (h * n_tiles):
        raise ValueError(f"{name}: signs of {signs.numel()} values do not fit tile_perms "
                         f"{tuple(tile_perms.shape)}")
    t = signs.numel() // (h * n_tiles)
    if t & (t - 1) or t == 0:
        raise ValueError(f"{name}: the tile d / T = {t} must be a power of two")
    for other in (tile_perms, signs):
        if other.device != x.device:
            raise ValueError(f"{name}: x on {x.device} but a table on {other.device}")
    return x.shape[0], h, n_tiles, t


def structured_mix_plain(x: torch.Tensor, tile_perms: torch.Tensor, signs: torch.Tensor,
                         token_dim: int) -> torch.Tensor:
    """Plain PyTorch version of the forward: gather the tiles, butterfly in
    float32, scale, sign, cast once."""
    b, h, n_tiles, t = _shapes(x, tile_perms, signs, "structured_mix")
    xt = x.reshape(b, n_tiles, t)
    gathered = xt.index_select(1, tile_perms.reshape(-1).long())  # [B, H*T, t]
    y = fwht_plain(gathered.float(), normalize=False) * (t ** -0.5)
    y = y * signs.reshape(1, h * n_tiles, t).float()
    return y.to(x.dtype).reshape(b, token_dim, -1)


def structured_mix_bwd_plain(g: torch.Tensor, tile_perms: torch.Tensor,
                             signs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the backward: [B, H*d] -> [B, d]."""
    b, h, n_tiles, t = _shapes(g, tile_perms, signs, "structured_mix_bwd")
    inv = invert_tile_perms(tile_perms).long()
    gs = g.reshape(b, h, n_tiles, t)
    sg = signs.reshape(h, n_tiles, t)
    acc = torch.zeros(b, n_tiles, t, dtype=torch.float32, device=g.device)
    for i in range(h):  # float32 sum in head order
        acc += gs[:, i].index_select(1, inv[i]).float() * sg[i].index_select(0, inv[i]).float()
    y = fwht_plain(acc, normalize=False) * (t ** -0.5)
    return y.to(g.dtype).reshape(b, n_tiles * t)


def _launch(fn, entry: str, x, tile_perms, signs, inv, out_cols: int) -> torch.Tensor:
    b, h, n_tiles, t = _shapes(x, tile_perms, signs, fn.__name__)
    if x.device.type != "cuda":
        raise RuntimeError(f"{fn.__name__}: no kernel for device {x.device}")
    if t > MAX_TILE:
        raise ValueError(f"{fn.__name__} kernel takes tiles up to {MAX_TILE}, got {t}")
    if inv is None:
        inv = invert_tile_perms(tile_perms)
    if inv.dtype != torch.int32 or inv.shape != tile_perms.shape or inv.device != x.device:
        raise TypeError(f"{fn.__name__}: inv must be int32 {tuple(tile_perms.shape)} on "
                        f"{x.device}")
    x2 = x.reshape(b, -1)
    if not x2.is_contiguous():
        raise ValueError(f"{fn.__name__} needs a contiguous input")
    sg = signs.reshape(h, n_tiles * t).to(x.dtype).contiguous()
    out = torch.empty((b, out_cols), dtype=x.dtype, device=x.device)
    if b == 0:
        return out
    lib = load_library()
    with torch.cuda.device(x.device):
        err = getattr(lib, entry)(
            _DTYPE_CODES[x.dtype], x2.data_ptr(), inv.contiguous().data_ptr(), sg.data_ptr(),
            out.data_ptr(), b, h, n_tiles, t, t ** -0.5,
            torch.cuda.current_stream().cuda_stream)
    check(err, f"{entry} launch")
    fn.launches += 1
    return out


def structured_mix(x: torch.Tensor, tile_perms: torch.Tensor, signs: torch.Tensor,
                   token_dim: int, inv: torch.Tensor | None = None) -> torch.Tensor:
    """x [B, N, E] or [B, d], tile_perms int32 [H, T], signs [1, H, d] ->
    [B, token_dim, H*d / token_dim]. ``inv`` is ``invert_tile_perms(tile_perms)``
    when the caller holds it. Not differentiable: ``structured_mix_grad`` is."""
    b, h, n_tiles, t = _shapes(x, tile_perms, signs, "structured_mix")
    if x.numel() != b * n_tiles * t:
        raise ValueError(f"structured_mix: x {tuple(x.shape)} does not hold d = {n_tiles * t} "
                         "values per row")
    if x.device.type == "cpu":
        return structured_mix_plain(x, tile_perms, signs, token_dim)
    out = _launch(structured_mix, "structured_mix_fwd", x, tile_perms, signs, inv,
                  h * n_tiles * t)
    return out.view(b, token_dim, -1)


def structured_mix_bwd(g: torch.Tensor, tile_perms: torch.Tensor, signs: torch.Tensor,
                       inv: torch.Tensor | None = None) -> torch.Tensor:
    """The cotangent of x for a cotangent g [B, ...] of H*d values per row:
    [B, d]."""
    b, h, n_tiles, t = _shapes(g, tile_perms, signs, "structured_mix_bwd")
    if g.numel() != b * h * n_tiles * t:
        raise ValueError(f"structured_mix_bwd: g {tuple(g.shape)} does not hold H*d = "
                         f"{h * n_tiles * t} values per row")
    if g.device.type == "cpu":
        return structured_mix_bwd_plain(g, tile_perms, signs)
    return _launch(structured_mix_bwd, "structured_mix_bwd", g, tile_perms, signs, inv,
                   n_tiles * t)


structured_mix.launches = 0
structured_mix_bwd.launches = 0


class _StructuredMix(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tile_perms, signs, token_dim, inv):
        ctx.save_for_backward(tile_perms, signs, inv)
        ctx.x_shape = x.shape
        return structured_mix(x, tile_perms, signs, token_dim, inv)

    @staticmethod
    def backward(ctx, g):
        tile_perms, signs, inv = ctx.saved_tensors
        dx = structured_mix_bwd(g.contiguous(), tile_perms, signs, inv)
        return dx.reshape(ctx.x_shape), None, None, None, None


def structured_mix_grad(x: torch.Tensor, tile_perms: torch.Tensor, signs: torch.Tensor,
                        token_dim: int, inv: torch.Tensor | None = None) -> torch.Tensor:
    """``structured_mix`` with a gradient for x (the tables are fixed).
    While ``torch.export`` traces, the forward is the custom op
    ``library.structured_mix``."""
    if inv is None:
        inv = invert_tile_perms(tile_perms)
    if torch.compiler.is_exporting():
        from spectre_tpu_torch.ops.kernels import library

        return library.structured_mix(x, tile_perms, signs, token_dim, inv)
    return _StructuredMix.apply(x, tile_perms, signs, token_dim, inv)
