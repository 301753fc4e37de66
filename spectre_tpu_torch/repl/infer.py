"""Run an exported program (the AOT runner; the port's counterpart of
spectre_tpu/repl/infer.py).

    python -m spectre_tpu_torch.repl.infer --artifact export/model.pt2 \\
        --input export/example_input.f32 --batch 2 --channels 3 --size 32 \\
        [--expect export/example_logits.f32] [--device cuda]

Loads the ``.pt2`` that ``repl/export.py`` wrote (weights inside) onto
``--device`` and runs the raw float32 NCHW input through it, with no model
code: it imports the custom ops of the kernels (``ops/kernels/library.py``)
and nothing of ``spectre_tpu_torch.models``, and says so. ``--expect`` holds
the logits to a file within the export's limit for the program's dtype
(1e-5 float32, 5e-2 bfloat16). ``--device cuda`` (the default) refuses to
run without a card.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--artifact", required=True, help="a model.pt2 written by repl/export.py")
    p.add_argument("--input", required=True, help="raw float32 NCHW file")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--channels", type=int, default=3)
    p.add_argument("--size", type=int, default=32)
    p.add_argument("--expect", default=None,
                   help="optional raw float32 logits file to parity-check")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asked, but torch.cuda.is_available() is "
                           "False; pass --device cpu to run on the CPU")

    from torch.export.passes import move_to_device_pass

    from spectre_tpu_torch.export.program import (
        EXPORT_ATOL,
        exported_module,
        load_exported,
        program_compute_dtype,
    )

    program = move_to_device_pass(load_exported(args.artifact), device)
    x = np.fromfile(args.input, np.float32).reshape(
        args.batch, args.channels, args.size, args.size)
    logits = exported_module(program)(torch.from_numpy(x).to(device)).float().cpu().numpy()
    for i, row in enumerate(logits):
        print(f"sample {i} argmax {int(row.argmax())} top logit {row.max():.4f}")
    models = sorted(m for m in sys.modules if m.startswith("spectre_tpu_torch.models"))
    print(f"model code imported: {', '.join(models) if models else 'none'}", flush=True)
    if args.expect:
        want = np.fromfile(args.expect, np.float32).reshape(logits.shape)
        err = float(np.max(np.abs(logits - want)))
        atol = EXPORT_ATOL[program_compute_dtype(program)]
        print(f"parity vs {args.expect}: max|delta|={err:.2e} (limit {atol})", flush=True)
        if not err <= atol:
            raise SystemExit(f"parity check failed: max|delta|={err} > {atol}")
    return logits


if __name__ == "__main__":
    main()
