"""Sign-flip + permutation mixing (port of spectre_tpu/ops/permute.py): the
mix tables, the exact gather mix ``permut_mix``, and the tile-structured mix
in its matrix form (``structured_mix``: random tile permutation, intra-tile
Hadamard product, signs; the hand-written kernel for it is
ops/kernels/structured_mix.py).

The [N, E] sequence is flattened to d = N*E values; each of H heads applies a
fixed random permutation and a fixed random +-1 sign pattern. Tables are
sampled from an explicit ``torch.Generator`` (the draws differ from JAX's
PRNG for the same seed; parity tests copy JAX's tables instead of
resampling). Storage matches the JAX buffers: perms int32 [H, d], signs
float32 [1, H, d].
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def _signs(gen: torch.Generator, num_heads: int, d: int) -> torch.Tensor:
    bits = torch.randint(0, 2, (num_heads, d), generator=gen)
    return (bits.to(torch.float32) * 2 - 1)[None]


def make_mix_tables(gen: torch.Generator, num_heads: int,
                    d: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Uniform per-head permutations [H, d] int32 and +-1 signs [1, H, d]."""
    perms = torch.stack([torch.randperm(d, generator=gen) for _ in range(num_heads)])
    return perms.to(torch.int32), _signs(gen, num_heads, d)


def make_block_mix_tables(gen: torch.Generator, num_heads: int, d: int,
                          blk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Block-structured permutations (whole ``blk``-element blocks move:
    ``perm[h, jb*blk + t] = bperm[h, jb]*blk + t``) and element-wise signs,
    in the same storage format as ``make_mix_tables``."""
    if d % blk:
        raise ValueError(f"mix_block={blk} must divide d={d}")
    if blk & (blk - 1):
        raise ValueError(f"mix_block={blk} must be a power of two")
    nb = d // blk
    bperms = torch.stack([torch.randperm(nb, generator=gen) for _ in range(num_heads)])
    perms = (bperms[:, :, None] * blk + torch.arange(blk)).reshape(num_heads, d)
    return perms.to(torch.int32), _signs(gen, num_heads, d)


def detect_block_size(perms, min_blk: int = 8) -> int:
    """Largest power-of-two blk >= min_blk such that every head's perm is
    block-structured (``perm[h, jb*blk+t] = base[h, jb] + t`` with
    blk-aligned bases), else 0. Host-side numpy."""
    perms = np.asarray(perms)
    h, d = perms.shape
    blk = 1
    while d % (blk * 2) == 0:
        blk *= 2
    while blk >= min_blk:
        if d % blk == 0:
            p = perms.reshape(h, d // blk, blk)
            if ((p[..., 0] % blk == 0).all()
                    and (p == p[..., :1] + np.arange(blk)).all()):
                return blk
        blk //= 2
    return 0


class MixTables(NamedTuple):
    """The block form of a permutation table [H, d], derived on the host
    (``derive_mix_tables``): whole ``blk``-row blocks move, ``blk = 1`` for a
    uniform table. ``bsrc[h, jb]`` is the source block of output block jb in
    the forward gather; ``binv = argsort(bsrc)`` is the block each input
    block goes to, which the backward's head-sum reads."""
    blk: int
    bsrc: torch.Tensor  # int32 [H, d/blk]
    binv: torch.Tensor  # int32 [H, d/blk]


def derive_mix_tables(perms: torch.Tensor) -> MixTables:
    """Validate ``perms`` (one permutation of range(d) per head) and derive
    its block tables on ``perms``' device. Copies the table to the host and
    sorts it there, so callers derive once per table, not per step."""
    p = perms.cpu().numpy()
    d = p.shape[1]
    inv = np.argsort(p, axis=1)
    if not (np.take_along_axis(p, inv, axis=1) == np.arange(d)).all():
        raise ValueError("mix perms must hold one permutation of range(d) per head")
    blk = detect_block_size(p, min_blk=1)
    bsrc = np.ascontiguousarray(p[:, ::blk] // blk, dtype=np.int32)
    binv = np.argsort(bsrc, axis=1).astype(np.int32)
    return MixTables(blk, torch.from_numpy(bsrc).to(perms.device),
                     torch.from_numpy(binv).to(perms.device))


def permut_mix(x: torch.Tensor, perms: torch.Tensor, signs: torch.Tensor,
               token_dim: int) -> torch.Tensor:
    """The exact mix by one gather: x [B, N, E] (or [B, d]), perms [H, d],
    signs [1, H, d] -> [B, token_dim, E*H]; the reshape reads the contiguous
    [H, N*E] block as torch ``.view`` does. Differentiable by autograd."""
    b = x.shape[0]
    flat = x.reshape(b, -1)
    h, d = perms.shape
    mixed = flat.index_select(1, perms.reshape(-1).long()).view(b, h, d) * signs
    return mixed.reshape(b, token_dim, -1)


def _hadamard_matrix_np(n: int) -> np.ndarray:
    h = np.asarray([[1.0]], dtype=np.float32)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


def hadamard_matrix(n: int, dtype=torch.float32, normalize: bool = True,
                    device=None) -> torch.Tensor:
    """Dense H_n (Sylvester / natural order); orthonormal when normalised."""
    h = torch.tensor(_hadamard_matrix_np(n), dtype=dtype, device=device)
    return h * (n ** -0.5) if normalize else h


def pick_tile(d: int, max_tile: int = 128) -> int:
    """Largest power of two <= max_tile that divides d."""
    t = max_tile
    while t > 1 and d % t:
        t //= 2
    return t


def make_structured_tables(gen: torch.Generator, num_heads: int, d: int,
                           tile: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Tables of the tile-structured mix: per-head random tile permutations
    int32 [H, T] and per-element +-1 signs [1, H, d], applied after the
    intra-tile Hadamard product."""
    t = tile or pick_tile(d)
    n_tiles = d // t
    tile_perms = torch.stack([torch.randperm(n_tiles, generator=gen)
                              for _ in range(num_heads)])
    return tile_perms.to(torch.int32), _signs(gen, num_heads, d)


def structured_mix(x: torch.Tensor, tile_perms: torch.Tensor, signs: torch.Tensor,
                   token_dim: int) -> torch.Tensor:
    """Matrix form of the structured mix, in x's dtype: x [B, N, E] or [B, d]
    -> [B, token_dim, -1]; per head a tile gather, the [t, t] Hadamard
    product, the signs. Differentiable by autograd."""
    b = x.shape[0]
    flat = x.reshape(b, -1)
    h, n_tiles = tile_perms.shape
    t = flat.shape[-1] // n_tiles
    had = hadamard_matrix(t, x.dtype, device=x.device)
    gathered = flat.view(b, n_tiles, t).index_select(1, tile_perms.reshape(-1).long())
    mixed = torch.matmul(gathered.view(b, h, n_tiles, t), had)
    mixed = mixed * signs.reshape(1, h, n_tiles, t)
    return mixed.reshape(b, token_dim, -1)


def invert_permutation(perm: torch.Tensor) -> torch.Tensor:
    """inv with inv[..., perm[..., i]] = i, for one permutation [d] or a batch
    [..., d]."""
    iota = torch.arange(perm.shape[-1], dtype=perm.dtype, device=perm.device)
    return torch.zeros_like(perm).scatter_(-1, perm.long(), iota.expand_as(perm))
