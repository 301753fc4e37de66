"""Export a model for deployment (the port's counterpart of
spectre_tpu/repl/export.py).

    python -m spectre_tpu_torch.repl.export [--config <config.py>] \\
        [--checkpoint runs/<experiment>/ckpt | weights.npz] [--outdir export] [--batch 2] \\
        [--device cuda]

Artifacts written to --outdir:
    model.pt2           the eval forward as a ``torch.export`` program, weights
                        inside, the kernels as custom ops (``repl/infer.py``
                        runs it without model code; tied to the torch version
                        that wrote it)
    weights.stw         flat binary weights for the native C++ runner
    meta.txt            model hyperparameters (key=value) for the native runner,
                        the same keys in the same order as the JAX package's
    example_input.f32   one example batch (raw float32 NCHW)
    example_logits.f32  the live model's logits for it, for parity checks

``--checkpoint`` is a trainer's checkpoint directory, restored at its best
step, else its latest, or a flax variable tree saved as ``.npz``
(``models.save_npz``; ``tools/orbax_to_npz.py`` writes one from a JAX
trainer's checkpoint). The program is replayed against the live model before
anything is written, within 1e-5 in float32 and 5e-2 in bfloat16 (the JAX
package's limits). ``--device cuda`` (the default) refuses to run without a
card. ``--onnx`` refuses: the port has no ONNX bridge, which waits for the
``onnx`` package.
"""

from __future__ import annotations

import argparse
import os
from types import SimpleNamespace

import numpy as np
import torch

from spectre_tpu_torch.configs import FLAGSHIP

META_KEYS = ("img_size", "patch_size", "in_channels", "num_classes",
             "embed_dim", "num_encoders", "num_heads", "hidden_dim")


def write_meta(config: SimpleNamespace, path: str) -> str:
    """``meta.txt`` as the JAX package writes it, which ``native/`` reads."""
    with open(path, "w") as f:
        for k in META_KEYS:
            f.write(f"{k}={getattr(config, k)}\n")
        f.write(f"model={getattr(config, 'model', 'spectre_vit')}\n")
        f.write(f"method={getattr(config, 'method', 'permut_mix')}\n")
        f.write(f"mix_impl={getattr(config, 'mix_impl', 'gather')}\n")
    return path


def export_from_config(config: SimpleNamespace, checkpoint: str | None = None,
                       outdir: str = "export", batch: int = 2,
                       device: torch.device | str = "cuda") -> str:
    from spectre_tpu_torch.export import (
        EXPORT_ATOL,
        export_forward,
        save_exported,
        save_stw,
        verify_export,
    )
    from spectre_tpu_torch.models import build_model, load_flax_variables, load_npz
    from spectre_tpu_torch.serving.torch_server import restore_for_serving

    device = torch.device(device)
    model = build_model(config, device)
    if checkpoint and checkpoint.endswith(".npz"):
        load_flax_variables(model, load_npz(checkpoint))
    elif checkpoint:
        step, which = restore_for_serving(model, checkpoint)
        print(f"restored step {step} ({which}) from {checkpoint}", flush=True)
    x = np.random.default_rng(0).uniform(
        0, 1, (batch, config.in_channels, config.img_size, config.img_size)).astype(np.float32)
    xt = torch.from_numpy(x).to(device)
    program = export_forward(model, xt)
    atol = EXPORT_ATOL["float32" if getattr(config, "compute_dtype", "float32") == "float32"
                       else "bfloat16"]
    err = verify_export(program, model, xt, atol=atol)
    with torch.no_grad():
        logits = model(xt).float().cpu().numpy()

    os.makedirs(outdir, exist_ok=True)
    save_exported(program, os.path.join(outdir, "model.pt2"))
    save_stw(model, os.path.join(outdir, "weights.stw"))
    write_meta(config, os.path.join(outdir, "meta.txt"))
    x.tofile(os.path.join(outdir, "example_input.f32"))
    logits.tofile(os.path.join(outdir, "example_logits.f32"))
    print(f"exported to {outdir}/ (program parity max|delta|={err:.2e} within {atol}, "
          f"{logits.shape[0]} example logits, device {device})", flush=True)
    return outdir


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default=FLAGSHIP, help="path to a python config file")
    p.add_argument("--checkpoint", default=None,
                   help="a trainer's checkpoint directory (its best step, else its latest), "
                        "or a flax variable tree as .npz")
    p.add_argument("--outdir", default="export")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--onnx", action="store_true",
                   help="refused: the ONNX bridge waits for the onnx package")
    p.add_argument("--set", nargs="*", default=[], help="config overrides key=value")
    args = p.parse_args(argv)
    if args.onnx:
        raise SystemExit("--onnx: the port has no ONNX bridge; it waits for the 'onnx' "
                         "package, which is not installed. Nothing was written.")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asked, but torch.cuda.is_available() is "
                           "False; pass --device cpu to export on the CPU")

    from spectre_tpu_torch.configs import apply_overrides, parse_config

    config = apply_overrides(parse_config(args.config), args.set)
    return export_from_config(config, args.checkpoint, args.outdir, args.batch, device)


if __name__ == "__main__":
    main()
