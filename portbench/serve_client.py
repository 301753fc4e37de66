"""One client process of ``"kind": "serve"`` traffic: a closed loop of u8
requests over loopback (numpy and the standard library only).

Protocol with the runner, one line each on standard input and output:
the client connects and prints ``READY``; it reads ``GO <t0> <t1>``
(CLOCK_MONOTONIC seconds, shared by every process of the machine), waits
until t0, and sends requests one after another, each of ``--images`` images
of the image pool, until a ``STOP`` line arrives; it then prints one JSON
line: per request the send and reply times and the images answered, and the
logits of the requests sampled for the correctness check (completed inside
[t0, t1], each with probability ``--sample-p`` from the client's seed, at
most ``--sample-cap``).

    python portbench/serve_client.py --port P --client I --clients N \
        --images 64 --pool 4096 --data-seed S --client-seed T \
        --sample-p 0.02 --sample-cap 6
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import select
import sys
import time

import numpy as np

if not __package__:  # run as a script: import the package from the checkout's root
    _here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [os.path.dirname(_here)] + [p for p in sys.path
                                             if os.path.abspath(p or ".") != _here]

from portbench.spq3 import connect, read_reply, request_frame  # noqa: E402


def image_pool(n: int, shape: tuple, seed: int) -> np.ndarray:
    """The u8 images every client and the reference draw requests from."""
    return np.random.default_rng(seed).integers(0, 256, size=(n, *shape), dtype=np.uint8)


def request_rows(client: int, clients: int, r: int, images: int, pool: int) -> np.ndarray:
    """The pool rows of request ``r`` of ``client``."""
    start = client * pool // clients + r * images
    return (start + np.arange(images)) % pool


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    for name in ("port", "client", "clients", "images", "pool", "data-seed", "client-seed",
                 "sample-cap"):
        p.add_argument("--" + name, type=int, required=True)
    p.add_argument("--shape", type=int, nargs=3, default=(3, 32, 32))
    p.add_argument("--sample-p", type=float, required=True)
    a = p.parse_args(argv)
    pool = image_pool(a.pool, tuple(a.shape), a.data_seed)
    coin = np.random.default_rng([a.client_seed, a.client])
    sock = connect(a.port)
    print("READY", flush=True)
    words = sys.stdin.readline().split()
    t0, t1 = float(words[1]), float(words[2])
    while time.monotonic() < t0:
        time.sleep(min(0.001, max(0.0, t0 - time.monotonic())))
    sent, done, answered, errors, kept = [], [], [], 0, []
    r = 0
    while True:
        rows = request_rows(a.client, a.clients, r, a.images, a.pool)
        frame = request_frame(pool[rows])
        start = time.monotonic()
        sock.sendall(frame)
        try:
            logits = read_reply(sock)
        except RuntimeError:
            logits = None
        end = time.monotonic()
        sent.append(start)
        done.append(end)
        answered.append(0 if logits is None else int(logits.shape[0]))
        errors += logits is None
        keep = coin.random() < a.sample_p
        if keep and logits is not None and end <= t1 and len(kept) < a.sample_cap:
            kept.append([r, base64.b64encode(logits.astype(np.float32).tobytes()).decode()])
        r += 1
        if select.select([sys.stdin], [], [], 0)[0]:
            break
    sock.close()
    print(json.dumps({"client": a.client, "sent": sent, "done": done, "answered": answered,
                      "errors": errors, "kept": kept}), flush=True)


if __name__ == "__main__":
    main()
