"""Sign-flip + permutation mix tables (port of spectre_tpu/ops/permute.py:31-98).

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
