"""Orthogonal-permutation mixing study (port of
spectre_tpu/repl/orthogonal_permut.py).

The mixing sweep of ``repl/perf.py mixer`` (the gather mix, the structured
mix's matrix form, the 2-D DFT by products and the structured-mix kernel at
d = 2^6 .. 2^max_pow; the kernel at every d), its timing plot
(``<out>/spectremix_h<H>.png``, matplotlib imported where it draws), and a
profile of one gather-mix pass at d = 4,096 through ``trace_step`` and
``ProfilerParser``.

    python -m spectre_tpu_torch.repl.orthogonal_permut [--heads 4] [--batch 8] [--max-pow 13]
        [--out plots] [--device cuda]
"""

from __future__ import annotations

import argparse
import os

import torch

from spectre_tpu_torch.ops import make_mix_tables, permut_mix
from spectre_tpu_torch.profile import ProfilerParser, trace_step
from spectre_tpu_torch.repl.perf import mixer_sweep
from spectre_tpu_torch.utils import cli_device


def plot_sweep(rows: list[dict], heads: int, batch: int, path: str) -> None:
    try:
        import matplotlib
    except ImportError:
        raise ImportError("the timing plot needs matplotlib, which is not installed; "
                          "repl/perf.py's mixer_sweep runs without it") from None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    dims = [r["d"] for r in rows]
    fig, ax = plt.subplots(figsize=(7, 4))
    for key, style, label in (("gather_ms", "o-", "permut-mix (gather)"),
                              ("structured_ms", "s-", "permut-mix (structured)"),
                              ("structured_kernel_ms", "d-", "structured-mix kernel"),
                              ("fft2_ms", "^-", "fft2 (DFT matmul)")):
        ax.loglog(dims, [r[key] for r in rows], style, label=label)
    ax.set_xlabel("flattened dim d")
    ax.set_ylabel("ms / iter")
    ax.set_title(f"mixing transforms, H={heads}, B={batch}")
    ax.legend()
    ax.grid(True, which="both", alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    print(f"wrote {path}", flush=True)


def profile_mix(device: torch.device, heads: int, batch: int, out: str) -> ProfilerParser:
    """One gather-mix pass at d = 4,096 under the profiler: its top 10 ops."""
    n, d = 8, 2 ** 12
    x = torch.randn(batch, n, d // n, generator=torch.Generator().manual_seed(0)).to(device)
    perms, signs = (t.to(device) for t in make_mix_tables(
        torch.Generator().manual_seed(0), heads, d))
    permut_mix(x, perms, signs, n)  # first call outside the trace
    with trace_step(os.path.join(out, "mix_trace"), device) as t:
        permut_mix(x, perms, signs, n)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return (ProfilerParser(t.trace_file).remove_idle().add_percentages().round()
            .sort_by_device().head(10).show())


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--max-pow", dest="max_pow", type=int, default=13)
    p.add_argument("--warmup", type=int, default=10)
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--out", default="plots")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)
    device = cli_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    rows = mixer_sweep(device, args.batch, args.heads, args.max_pow, args.warmup, args.iters)
    plot_sweep(rows, args.heads, args.batch, os.path.join(args.out, f"spectremix_h{args.heads}.png"))
    profile_mix(device, args.heads, args.batch, args.out)
    return rows


if __name__ == "__main__":
    main()
