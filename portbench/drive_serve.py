"""The runner of ``"kind": "serve"`` traffic: the model behind the program's
server (``serving/torch_server.py``: one batcher, power-of-two buckets up to
``max_batch``, the one-deep fetch pipeline) on the u8 protocol over
loopback, under ``clients`` client processes (``serve_client.py``), each a
closed loop of requests of ``request_images`` images.

Set-up builds the model in eval mode with the benchmark's weights, starts
the server, sends ``warm_rounds`` requests of each size of ``warm_buckets``
from this process, and starts the clients. The window is [t0, t0 + seconds)
on the machine's monotonic clock: ``serve_img_s`` counts the images of the
requests answered inside it, at the clients, over its length;
``serve_p95_ms`` is the 95th percentile of the latency, send to last reply
byte, of every request answered inside it. A ``--trace 1`` run traces
``trace_s`` seconds after the window, the clients still running.

Traffic parameters: ``clients``, ``request_images``, ``max_batch``,
``batch_timeout_s``, ``pool_images`` (the u8 images requests are drawn from,
made from the seed), ``warm_buckets``, ``warm_rounds``, ``sample_p`` and
``sample_cap`` (the replies the reference checks), ``trace_s``.
"""

from __future__ import annotations

import base64
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from portbench import correct
from portbench.common import (derive_seeds, device_record, end_to_end, launches,
                              port_config, print_launches)
from portbench.manifest import read_per_layer
from portbench.reference.common import make_params
from portbench.reference.steps import family, served_logits
from portbench.serve_client import image_pool, request_rows
from portbench.spq3 import connect, read_reply, request_frame

CLIENT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "serve_client.py")
START_S = 0.5   # between the last client's READY and the window's start


def build_server(cell, sd, device):
    from spectre_tpu_torch.models import build_model
    from spectre_tpu_torch.models.registry import refresh_mixes
    from spectre_tpu_torch.serving.torch_server import TorchServer

    m, traffic = cell.config["model"], cell.traffic
    cfg = port_config(cell.config)
    cfg.random_seed = sd.program
    model = build_model(cfg, device)
    params = make_params(family(cell.config["reference"]).spec(m), sd.weights, device)
    model.load_state_dict(params, strict=True)
    refresh_mixes(model)
    shape = (m["in_channels"], m["img_size"], m["img_size"])
    server = TorchServer(model, shape, device, max_batch=int(traffic["max_batch"]),
                         batch_timeout_s=float(traffic["batch_timeout_s"]))
    return server, model, params


def start_clients(cell, sd, port: int) -> list[subprocess.Popen]:
    t, m = cell.traffic, cell.config["model"]
    env = dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = []
    for i in range(int(t["clients"])):
        args = [sys.executable, CLIENT, "--port", str(port), "--client", str(i),
                "--clients", str(t["clients"]), "--images", str(t["request_images"]),
                "--pool", str(t["pool_images"]), "--data-seed", str(sd.data),
                "--client-seed", str(sd.clients), "--sample-p", str(t["sample_p"]),
                "--sample-cap", str(t["sample_cap"]), "--shape", str(m["in_channels"]),
                str(m["img_size"]), str(m["img_size"])]
        procs.append(subprocess.Popen(args, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                      text=True, env=env))
    return procs


def stop_clients(procs: list[subprocess.Popen], timeout: float = 120.0) -> list[dict]:
    """Tell every client to stop after its request in flight, and read its
    record; a client that does not end in time is killed."""
    for p in procs:
        try:
            p.stdin.write("STOP\n")
            p.stdin.flush()
        except OSError:
            pass
    out = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            stdout, _ = p.communicate()
        lines = [ln for ln in stdout.splitlines() if ln.startswith("{")]
        if p.returncode != 0 or not lines:
            raise RuntimeError(f"a serving client failed (exit {p.returncode})")
        out.append(json.loads(lines[-1]))
    return out


def window_stats(records: list[dict], t0: float, t1: float) -> dict:
    """Over every client: the requests sent in [t0, t1), those answered by
    t1, their images and latencies, and the failed ones."""
    attempted, images, failed, lat = 0, 0, 0, []
    for rec in records:
        for s, d, n in zip(rec["sent"], rec["done"], rec["answered"]):
            if not t0 <= s < t1:
                continue
            attempted += 1
            if n == 0:
                failed += 1
            elif d <= t1:
                images += n
                lat.append(d - s)
    return {"attempted": attempted, "failed": failed, "images": images, "latencies": lat}


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float, numbers_out: dict | None = None) -> tuple[dict, dict]:
    """One run of the cell; ``numbers_out``, when given, receives every number
    of the correctness check, those without a limit too."""
    t = cell.traffic
    sd = derive_seeds(seed)
    m = cell.config["model"]
    shape = (m["in_channels"], m["img_size"], m["img_size"])
    server, model, params = build_server(cell, sd, device)
    port = server.listen_tcp("127.0.0.1", 0)
    procs = []
    try:
        warm = image_pool(max(t["warm_buckets"]), shape, sd.data)
        sock = connect(port)
        try:
            for _ in range(int(t["warm_rounds"])):
                for n in t["warm_buckets"]:
                    sock.sendall(request_frame(warm[:n]))
                    read_reply(sock)
        finally:
            sock.close()
        procs = start_clients(cell, sd, port)
        for p in procs:
            if p.stdout.readline().strip() != "READY":
                raise RuntimeError("a serving client did not come up")
        t0 = time.monotonic() + START_S
        t1 = t0 + seconds
        for p in procs:
            p.stdin.write(f"GO {t0!r} {t1!r}\n")
            p.stdin.flush()
        setup_s = time.perf_counter() - t_start + (t0 - time.monotonic())
        while time.monotonic() < t0:
            time.sleep(0.001)
        f0, l0 = server.forwards, launches()
        time.sleep(max(0.0, t1 - time.monotonic()))
        f1, l1 = server.forwards, launches()
        trace_rec = None
        if trace:
            from portbench.tracing import traced

            sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
            with traced(sync) as holder:
                time.sleep(float(t["trace_s"]))
            trace_rec = holder["trace"]
        records = stop_clients(procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        server.close()
    device_rec = device_record(device, cell.chips)
    del server, model
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    print_launches(l0, l1, f1 - f0, "bucket")
    stats = window_stats(records, t0, t1)
    prog, pixels = sampled_replies(records, t, shape, sd)
    ref = served_logits(cell.config, params, pixels, device) if len(pixels) else prog
    numbers = correct.logit_numbers(prog, ref)
    if numbers_out is not None:
        numbers_out.update(numbers)
    checks = correct.judge(numbers, cell.config["limits"]["serve"])

    record = {"kind": "serve", "model": m, "window_s": seconds, "images": stats["images"],
              "forwards": f1 - f0, "trace": trace_rec}
    if trace:
        metrics = read_per_layer(cell, record)
    else:
        metrics = end_to_end(cell, {"serve_img_s": stats["images"] / seconds,
                                    "serve_p95_ms": 1e3 * float(np.percentile(
                                        stats["latencies"], 95)),
                                    "setup_s": setup_s})
    ok = all(c["ok"] for c in checks.values()) and stats["failed"] == 0
    result = {"correct": ok, "attempted": stats["attempted"], "failed": stats["failed"],
              "metrics": metrics, "device": device_rec}
    if trace:
        result["device"].update(busy_s=trace_rec["busy_s"], window_s=trace_rec["window_s"])
        result["breakdown"] = {"device_ops": trace_rec["device_ops"],
                               "idle_gaps": trace_rec["idle_gaps"]}
    return result, checks


def sampled_replies(records: list[dict], t: dict, shape: tuple, sd) -> tuple[torch.Tensor,
                                                                            np.ndarray]:
    """The logits the clients kept and the u8 images of their requests."""
    pool = image_pool(int(t["pool_images"]), shape, sd.data)
    logits, rows = [], []
    for rec in records:
        for r, payload in rec["kept"]:
            z = np.frombuffer(base64.b64decode(payload), np.float32)
            logits.append(z.reshape(int(t["request_images"]), -1))
            rows.append(request_rows(rec["client"], int(t["clients"]), r,
                                     int(t["request_images"]), int(t["pool_images"])))
    if not logits:
        return torch.zeros(0), np.zeros((0, *shape), np.uint8)
    return torch.from_numpy(np.concatenate(logits)), pool[np.concatenate(rows)]
