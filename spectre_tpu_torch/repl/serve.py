"""Serve SpectreViT with the port: the model on a torch device behind the
SPQ2/SPQ3 protocol (serving/torch_server.py).

    python -m spectre_tpu_torch.repl.serve [--config <config.py>] --device cuda \\
        [--ckpt runs/<experiment>/ckpt | weights.npz] [--port 7788 | --uds /tmp/spectre.sock] \\
        [--max-batch 256]

``--config`` defaults to the port's flagship, ``spectre_tpu_torch/configs/
spectre_vit_cifar100.py``. Without
``--ckpt`` the weights are the port's init seeded from ``random_seed``.
``--ckpt`` takes a trainer's checkpoint directory (``repl/train.py`` writes
``<checkpoint_dir>/<experiment>/ckpt``), whose best-metric step it restores,
else the latest, and says which; a path ending ``.npz`` is instead a flax
variable tree saved by ``spectre_tpu_torch.models.save_npz``. ``--device
cuda`` refuses to start when no CUDA device is present. Clients:
``spectre_tpu_torch.serving.SpectreClient``.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from spectre_tpu_torch.configs import FLAGSHIP


def start(argv=None):
    """Parse the CLI flags, build the model and start listening. Returns
    ``(server, address)``: the bound TCP port, or the unix-socket path."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default=FLAGSHIP, help="path to a python config file")
    p.add_argument("--ckpt", default=None,
                   help="a trainer's checkpoint directory (its best step, else its latest), "
                        "or a flax variable tree as .npz (models.save_npz); default: the "
                        "port's seeded init")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
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
    args = p.parse_args(argv)

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
    npz = args.ckpt is not None and args.ckpt.endswith(".npz")
    srv = from_config(cfg, device, weights=load_npz(args.ckpt) if npz else None,
                      checkpoint=None if npz else args.ckpt, max_batch=args.max_batch,
                      token=token)
    if args.uds:
        addr = where = srv.listen_uds(args.uds)
    else:
        host = args.host or "127.0.0.1"
        addr = srv.listen_tcp(host=host, port=args.port)
        where = f"{host}:{addr}"
    print(f"serving {getattr(cfg, 'model', 'spectre_vit')} on {where} "
          f"(device {device})", flush=True)
    return srv, addr


def main(argv=None):
    srv, _ = start(argv)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.close()


if __name__ == "__main__":
    main()
