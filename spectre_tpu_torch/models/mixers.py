"""Pluggable token mixers (port of spectre_tpu/models/mixers.py). Contract:
[B, N, E] -> [B, N, E].

- ``permut_mix``  ``MHPermutMix`` sign + permutation mixing
- ``fft_bare``    FNet: Re(FFT2 over token and embed axes), as dense DFT products
- ``fft_mh``      per-head Dense -> Re(FFT2) -> concat -> projection, with residual
- ``dwt_embed``   Haar DWT along the embedding axis
- ``dwt_token``   Haar DWT along the token axis
- ``attention``   multi-head self-attention through the hand-written
                  attention kernels (ops/kernels/attention.py)
"""

from __future__ import annotations

import torch
from torch import nn

from spectre_tpu_torch.models.init import uniform_
from spectre_tpu_torch.models.layers import Dense, Dropout, MHPermutMix
from spectre_tpu_torch.ops import fft2_real_matmul, haar_dwt_mix
from spectre_tpu_torch.ops.kernels import flash_attention

MIXERS = ("permut_mix", "fft_bare", "fft_mh", "dwt_embed", "dwt_token", "attention")


class FNetMixer(nn.Module):
    """fft_bare: parameter-free FNet mixing, Re(DFT_token . x . DFT_embed^T)."""

    def __init__(self, *, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fft2_real_matmul(x.to(self.dtype))


class MHFFTMixer(nn.Module):
    """fft_mh: per-head Dense(E -> E/shrink) -> Re(FFT2) -> concat ->
    projection, with residual. flax names: ``head_<h>``, ``proj_head``."""

    def __init__(self, embed_dim: int, num_heads: int, *, shrink: int = 4,
                 use_fft: bool = True, dtype=torch.float32, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.num_heads, self.use_fft = num_heads, use_fft
        head_dim = embed_dim // shrink
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        for h in range(num_heads):
            self.add_module(f"head_{h}", Dense(embed_dim, head_dim, **kw))
        self.proj_head = Dense(head_dim * num_heads, embed_dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        heads = []
        for h in range(self.num_heads):
            e = getattr(self, f"head_{h}")(x)
            heads.append(fft2_real_matmul(e) if self.use_fft else e)
        return self.proj_head(torch.cat(heads, dim=-1)) + x


class DWTMixer(nn.Module):
    """dwt_embed / dwt_token: the shape-preserving Haar subband concat along
    ``axis`` (-1 = embed, -2 = token)."""

    def __init__(self, axis: int):
        super().__init__()
        self.axis = axis

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return haar_dwt_mix(x, axis=self.axis)


class _HeadsDense(nn.Module):
    """flax ``DenseGeneral`` onto (heads, head_dim): kernel [E, H, D], bias
    [H, D]. The forward returns [B, N, H, D]; under tensor parallelism
    (``tp``, set by ``parallel.apply_tp``) this rank's heads."""

    tp = None

    def __init__(self, embed_dim: int, num_heads: int, *, dtype, param_dtype, device):
        super().__init__()
        self.embed_dim, self.dtype = embed_dim, dtype
        head_dim = embed_dim // num_heads
        kw = dict(dtype=param_dtype, device=device)
        self.kernel = nn.Parameter(torch.empty(embed_dim, num_heads, head_dim, **kw))
        self.bias = nn.Parameter(torch.zeros(num_heads, head_dim, **kw))

    def init_parameters(self, gen: torch.Generator) -> None:
        uniform_(self.kernel, (1.5 / self.embed_dim) ** 0.5, gen)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            return self.tp.heads_dense(self, x)
        dt = self.dtype
        e, h, d = self.kernel.shape
        y = torch.matmul(x, self.kernel.to(dt).view(e, h * d)) + self.bias.to(dt).view(h * d)
        return y.view(*x.shape[:-1], h, d)


class _HeadsOut(nn.Module):
    """flax ``DenseGeneral`` from (heads, head_dim) back to E: kernel
    [H, D, E], bias [E]; ``tp`` as ``_HeadsDense``'s."""

    tp = None

    def __init__(self, embed_dim: int, num_heads: int, *, dtype, param_dtype, device):
        super().__init__()
        self.embed_dim, self.dtype = embed_dim, dtype
        kw = dict(dtype=param_dtype, device=device)
        self.kernel = nn.Parameter(torch.empty(num_heads, embed_dim // num_heads, embed_dim,
                                               **kw))
        self.bias = nn.Parameter(torch.zeros(embed_dim, **kw))

    def init_parameters(self, gen: torch.Generator) -> None:
        uniform_(self.kernel, self.embed_dim ** -0.5, gen)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # x [B, N, H, D]
        if self.tp is not None:
            return self.tp.heads_out(self, x)
        dt = self.dtype
        h, d, e = self.kernel.shape
        return torch.matmul(x.reshape(*x.shape[:-2], h * d),
                            self.kernel.to(dt).view(h * d, e)) + self.bias.to(dt)


class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` over x with itself: ``query``,
    ``key``, ``value`` (kernel [E, H, D], bias [H, D]) and ``out`` (kernel
    [H, D, E], bias [E]), in flax's layouts so that no weight is transposed.

    The attention itself is ``ops.kernels.flash_attention``: q, k and v go
    in as [B, H, N, D] views of the projections' [B, N, H, D] outputs, and O
    comes back as such a view, so nothing is copied around the kernel. In
    train mode with dropout > 0 one keep-mask [N, N] over the
    keep-probability is drawn for all batches and heads (flax's
    ``broadcast_dropout``) from the generator of ``attn_dropout`` (the train
    state's) and multiplies the probabilities inside the kernel."""

    def __init__(self, embed_dim: int, num_heads: int, *, dropout: float = 0.0,
                 dtype=torch.float32, param_dtype=torch.float32, device=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} must be divisible by num_heads {num_heads}")
        self.dtype = dtype
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.query = _HeadsDense(embed_dim, num_heads, **kw)
        self.key = _HeadsDense(embed_dim, num_heads, **kw)
        self.value = _HeadsDense(embed_dim, num_heads, **kw)
        self.out = _HeadsOut(embed_dim, num_heads, **kw)
        self.attn_dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        q, k, v = (proj(x).permute(0, 2, 1, 3) for proj in (self.query, self.key, self.value))
        pm = None
        if self.training and self.attn_dropout.p > 0.0:
            n = x.shape[1]
            pm = self.attn_dropout(torch.ones(n, n, dtype=torch.float32, device=x.device))
        o = flash_attention(q, k, v, pm)  # [B, H, N, D]
        return self.out(o.permute(0, 2, 1, 3))


class AttentionMixer(nn.Module):
    """Standard MHSA over [B, N, E] (batch-first); flax name ``mhsa``."""

    def __init__(self, embed_dim: int, num_heads: int, *, dropout: float = 0.0,
                 dtype=torch.float32, param_dtype=torch.float32, device=None):
        super().__init__()
        self.mhsa = MultiHeadAttention(embed_dim, num_heads, dropout=dropout, dtype=dtype,
                                       param_dtype=param_dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mhsa(x)


def make_mixer(method: str, *, embed_dim: int, seq_length: int, num_heads: int,
               dropout: float = 0.0, dtype=torch.float32, param_dtype=torch.float32,
               mix_impl: str = "gather", mix_block: int = 0, device=None) -> nn.Module:
    """Mixer factory keyed by the config's ``method``."""
    kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
    if method == "permut_mix":
        return MHPermutMix(embed_dim, seq_length, num_heads, embed_dim, impl=mix_impl,
                           mix_block=mix_block, **kw)
    if method == "fft_bare":
        return FNetMixer(dtype=dtype)
    if method == "fft_mh":
        return MHFFTMixer(embed_dim, num_heads, **kw)
    if method == "dwt_embed":
        return DWTMixer(axis=-1)
    if method == "dwt_token":
        return DWTMixer(axis=-2)
    if method == "attention":
        return AttentionMixer(embed_dim, num_heads, dropout=dropout, **kw)
    raise ValueError(f"unknown mixer method {method!r}; expected one of {MIXERS}")
