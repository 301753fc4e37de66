"""Serve SpectreViT with the port: the model on a torch device behind the
SPQ2/SPQ3 protocol (serving/torch_server.py), or the native CPU daemon.

    python -m spectre_tpu_torch.repl.serve [--config <config.py>] --device cuda \\
        [--ckpt runs/<experiment>/ckpt | weights.npz] [--port 7788 | --uds /tmp/spectre.sock] \\
        [--max-batch 256] [--backend torch | native [--export-dir runs/serve_export]]

``--config`` defaults to the port's flagship, ``spectre_tpu_torch/configs/
spectre_vit_cifar100.py``. Without
``--ckpt`` the weights are the port's init seeded from ``random_seed``.
``--ckpt`` takes a trainer's checkpoint directory (``repl/train.py`` writes
``<checkpoint_dir>/<experiment>/ckpt``), whose best-metric step it restores,
else the latest, and says which; a path ending ``.npz`` is instead a flax
variable tree saved by ``spectre_tpu_torch.models.save_npz``. ``--device
cuda`` refuses to start when no CUDA device is present; on a host with
several cards it serves a replica on each (every bucket split over them,
``--max-batch`` a multiple of their count), as the JAX server shards its
buckets over a mesh of every local chip; ``--devices cuda:0,cuda:1`` (or
``cpu,cpu``) names the devices instead. Clients:
``spectre_tpu_torch.serving.SpectreClient``.

``--backend native`` asks for the CPU daemon instead: it builds ``native/``
(``make -C native``), exports ``weights.stw`` and ``meta.txt`` of the same
weights on the CPU to ``--export-dir`` (``repl/export.py``) and runs
``native/build/spectre_serve`` on them until interrupted. The default,
``torch``, serves on ``--device``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch

from spectre_tpu_torch.configs import FLAGSHIP

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default=FLAGSHIP, help="path to a python config file")
    p.add_argument("--ckpt", default=None,
                   help="a trainer's checkpoint directory (its best step, else its latest), "
                        "or a flax variable tree as .npz (models.save_npz); default: the "
                        "port's seeded init")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--devices", default=None,
                   help="comma-separated devices, a replica on each (default: every card "
                        "with --device cuda)")
    p.add_argument("--port", type=int, default=7788)
    p.add_argument("--uds", default=None,
                   help="serve on a unix-domain socket path instead of TCP")
    p.add_argument("--host", default=None,
                   help="bind a specific interface (default loopback); a "
                        "non-loopback host requires --token-file or "
                        "$SPECTRE_SERVE_TOKEN (plaintext stream: front it "
                        "with TLS across untrusted networks)")
    p.add_argument("--token-file", default=None,
                   help="file holding the shared-secret auth token")
    p.add_argument("--max-batch", type=int, default=256)
    p.add_argument("--set", nargs="*", default=[], help="config overrides key=value")
    p.add_argument("--backend", choices=("torch", "native"), default="torch",
                   help="torch: the port on --device (default); native: the CPU daemon of "
                        "native/ on an export of the same weights")
    p.add_argument("--export-dir", default=None,
                   help="where --backend native writes its export (default "
                        "runs/serve_export)")
    return p


def start(argv=None):
    """Parse the CLI flags, build the model and start listening. Returns
    ``(server, address)``: the bound TCP port, or the unix-socket path."""
    args = _parser().parse_args(argv)
    if args.backend != "torch":
        raise ValueError("start() serves the torch backend; main() runs --backend native")

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asked, but torch.cuda.is_available() is "
                           "False; pass --device cpu to serve on the CPU")

    from spectre_tpu_torch.configs import apply_overrides, parse_config
    from spectre_tpu_torch.models import load_npz
    from spectre_tpu_torch.serving import from_config

    cfg = apply_overrides(parse_config(args.config), args.set)
    token = None
    if args.token_file:
        with open(args.token_file) as f:
            token = f.readline().strip()
    elif os.environ.get("SPECTRE_SERVE_TOKEN"):
        token = os.environ["SPECTRE_SERVE_TOKEN"]
    if args.devices:
        devices = args.devices.split(",")
    elif device.type == "cuda" and device.index is None and torch.cuda.device_count() > 1:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    else:
        devices = None
    if devices and args.max_batch % len(devices):
        sys.exit(f"--max-batch {args.max_batch} must divide over {len(devices)} devices")
    npz = args.ckpt is not None and args.ckpt.endswith(".npz")
    srv = from_config(cfg, device, weights=load_npz(args.ckpt) if npz else None,
                      checkpoint=None if npz else args.ckpt, max_batch=args.max_batch,
                      token=token, devices=devices)
    if args.uds:
        addr = where = srv.listen_uds(args.uds)
    else:
        host = args.host or "127.0.0.1"
        addr = srv.listen_tcp(host=host, port=args.port)
        where = f"{host}:{addr}"
    print(f"serving {getattr(cfg, 'model', 'spectre_vit')} on {where} "
          f"(device {', '.join(devices) if devices else device})", flush=True)
    return srv, addr


def start_native(args):
    """Build native/, export the weights on the CPU and launch the daemon.
    Returns ``(process, address)``."""
    from spectre_tpu_torch.configs import apply_overrides, parse_config
    from spectre_tpu_torch.repl.export import export_from_config
    from spectre_tpu_torch.serving import start_server

    r = subprocess.run(["make", "-C", os.path.join(_REPO, "native")],
                       capture_output=True, text=True)
    if r.returncode != 0:
        sys.exit(f"native build failed:\n{r.stderr}")
    cfg = apply_overrides(parse_config(args.config), args.set)
    outdir = args.export_dir or os.path.join("runs", "serve_export")
    export_from_config(cfg, checkpoint=args.ckpt, outdir=outdir, batch=1, device="cpu")
    proc, addr = start_server(outdir, port=args.port, max_batch=args.max_batch, uds=args.uds,
                              host=args.host, token_file=args.token_file)
    where = addr if args.uds else f"{args.host or '127.0.0.1'}:{addr}"
    print(f"serving {getattr(cfg, 'model', 'spectre_vit')} from {outdir} on {where} "
          "(native daemon, CPU)", flush=True)
    return proc, addr


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.backend == "native":
        proc, _ = start_native(args)
        try:
            proc.wait()
        except KeyboardInterrupt:
            proc.kill()
            proc.wait()
        return
    srv, _ = start(argv)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.close()


if __name__ == "__main__":
    main()
