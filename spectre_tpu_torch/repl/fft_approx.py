"""Learned-FFT-approximation study (port of spectre_tpu/repl/fft_approx.py).

Trains ``FFTApproximator`` (one unconstrained [D // 2 + 1, D] projection) to
regress Re(rfft(x)) of random inputs under MSE with Adam, then times the
true transform two ways, ``rfft_real`` (torch.fft) and the DFT product
``x @ C`` with the cosine matrix, beside the learned one at its own dim,
across power-of-two and other dims.

    python -m spectre_tpu_torch.repl.fft_approx [--dim 256] [--steps 2000] [--batch 256]
        [--iters 200] [--device cuda]
"""

from __future__ import annotations

import argparse

import torch

from spectre_tpu_torch.models import FFTApproximator
from spectre_tpu_torch.models.init import init_weights
from spectre_tpu_torch.ops import dft_matrices, rfft_real
from spectre_tpu_torch.repl.perf import _time_fn
from spectre_tpu_torch.utils import cli_device


def train_approximator(dim: int, steps: int, device: torch.device, batch: int = 256,
                       lr: float = 1e-3, seed: int = 0) -> FFTApproximator:
    model = FFTApproximator(dim, device=device)
    init_weights(model, torch.Generator().manual_seed(seed))
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    loss = None
    for i in range(steps):
        x = torch.randn(batch, dim, generator=gen, device=device)
        loss = torch.mean((model(x) - rfft_real(x)) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if i % max(1, steps // 10) == 0:
            print(f"  step {i}: mse {loss.item():.6f}", flush=True)
    print(f"final mse {loss.item():.6f}", flush=True)
    return model.eval()


def timing_sweep(model: FFTApproximator, device: torch.device, batch: int = 64,
                 iters: int = 200) -> list[dict]:
    print(f"approx vs rfft timing on {device} (ms/iter), pow2 + non-pow2 dims", flush=True)
    dim_of_model = model.weight.shape[1]
    out = []
    for dim in [256, 512, 1000, 1024, 3000, 4096]:
        x = torch.randn(batch, dim, generator=torch.Generator().manual_seed(0)).to(device)
        cos = dft_matrices(dim, device=device)[0][:, : dim // 2 + 1].contiguous()
        t = {"rfft": _time_fn(lambda: rfft_real(x), device, iters=iters),
             "dft-matmul": _time_fn(lambda: x @ cos, device, iters=iters)}
        if dim == dim_of_model:
            with torch.no_grad():
                t["learned-approx"] = _time_fn(lambda: model(x), device, iters=iters)
        print(f"  dim={dim}: " + " | ".join(f"{k} {v * 1e3:.4f}" for k, v in t.items()),
              flush=True)
        out.append({"dim": dim, **{k + "_ms": v * 1e3 for k, v in t.items()}})
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--iters", type=int, default=200, help="timed calls per row")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)
    device = cli_device(args.device)
    model = train_approximator(args.dim, args.steps, device, args.batch)
    return timing_sweep(model, device, iters=args.iters)


if __name__ == "__main__":
    main()
