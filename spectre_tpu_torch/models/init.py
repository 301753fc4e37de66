"""Parameter initialisers of the port (spectre_tpu/models/init.py's
distributions, drawn from an explicit ``torch.Generator``):

    kernels and biases   U(-1/sqrt(fan_in), +1/sqrt(fan_in))
    attention            q/k/v kernels U(+-sqrt(1.5/E)) (xavier over the packed
                         [3E, E] matrix), out kernel U(+-1/sqrt(E)), biases zero
    cls / position       normal(0, 1)
    freq weights, LN     ones (scales), zeros (biases)

Draws are taken on the CPU from the generator and copied into the
parameter, so a seed gives the same weights on every device.
"""

from __future__ import annotations

import torch


@torch.no_grad()
def uniform_fan_in_(param: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    uniform_(param, float(fan_in) ** -0.5, gen)


@torch.no_grad()
def uniform_(param: torch.Tensor, bound: float, gen: torch.Generator) -> None:
    draw = torch.empty(param.shape, dtype=torch.float32).uniform_(-bound, bound, generator=gen)
    param.copy_(draw)


@torch.no_grad()
def normal_(param: torch.Tensor, gen: torch.Generator, std: float = 1.0) -> None:
    param.copy_(torch.empty(param.shape, dtype=torch.float32).normal_(0.0, std, generator=gen))


def init_weights(model: torch.nn.Module, gen: torch.Generator) -> None:
    """Call ``init_parameters(gen)`` on every module that defines it, in
    module order; each draws only its own parameters and buffers. LayerNorms
    keep their constructed ones/zeros."""
    for m in model.modules():
        draw = getattr(m, "init_parameters", None)
        if draw is not None:
            draw(gen)
