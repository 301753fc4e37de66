"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each raising on failure (nothing is caught):

1. device: require CUDA; print the card's name and power limit; TF32 off.
2. build: compile every kernel in spectre_tpu_torch/csrc/ with nvcc.
3. kernel 1 (block_scatter_rows) vs its plain version at the flagship mix
   shape (d=33,280, H=16, blk=64), B in {1, 3, 64, 256}, bf16 and f32:
   bitwise equal. Median times at B=256.
4. kernel 2 (fused_spectre_linear_fwd) vs its plain version at the serving
   path's three shapes for B=256, f32 (<= 1e-4: only the summation order
   differs) and bf16 (<= 2e-2: one bf16 ulp is 7.8e-3 near 1 and 1.6e-2
   in [2, 4)). Times.
5. model: the flagship config (spectre_tpu/configs/spectre_vit_cifar100.py)
   at full width on cuda, the port's seeded init; one bucket-256 forward
   must launch exactly 4 block-scatter and 9 fused-linear kernels, give
   finite [256, 100] logits, and agree with the same module run on the
   plain versions (tolerance below).
6. serve: the serving CLI's start path (repl/serve.py) on loopback port 0;
   SPQ2 f32 requests of batch 1, 7 and 64 and an SPQ3 u8 request of batch
   5 through the port's SpectreClient, each sent twice; replies checked
   against a direct forward of the same padded bucket. Launch counts are
   reset just before the server starts and read right after its run.

Prints the card line, one JSON line of per-kernel results, then
``{"ok": true, "device": {...}}`` as the last line. Exits non-zero, with no
result, when CUDA is missing or the port is not beside this script.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "spectre_tpu", "configs", "spectre_vit_cifar100.py")
# bf16 logits of the kernel path vs the plain path: both round each op's
# output to bf16 once, but a 1-ulp flip inside an early layer is carried
# through 4 layers and the head. Logits are O(1) (GELU(LN(.)) + pool), so
# 0.1 is about three bf16 ulps at the largest logit magnitudes.
MODEL_ATOL = 0.1


def cuda_time_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Median over ``reps`` of the mean time of ``iters`` back-to-back calls,
    by CUDA events, after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def phase_kernel1(kernels, gen):
    d, heads, blk = 33_280, 16, 64
    nb = d // blk
    bsrc = torch.stack([torch.randperm(nb, generator=gen) for _ in range(heads)])
    bsrc = bsrc.to(torch.int32).cuda()
    for dtype in (torch.bfloat16, torch.float32):
        for b in (1, 3, 64, 256):
            xt = torch.randn(d, b, generator=gen).to("cuda", dtype)
            got = kernels.block_scatter_rows(xt, bsrc, blk)
            ref = kernels.block_scatter_rows_plain(xt, bsrc, blk)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise AssertionError(f"block_scatter_rows != plain at B={b} {dtype}")
    print("kernel 1 block_scatter_rows: bitwise equal to plain for B in (1, 3, 64, 256), "
          "bf16 and f32", flush=True)
    xt = torch.randn(d, 256, generator=gen).to("cuda", torch.bfloat16)
    ms_k = cuda_time_ms(lambda: kernels.block_scatter_rows(xt, bsrc, blk))
    ms_p = cuda_time_ms(lambda: kernels.block_scatter_rows_plain(xt, bsrc, blk))
    moved = (heads * d * 256 + d * 256) * 2
    print(f"kernel 1 at d={d} H={heads} blk={blk} B=256 bf16: kernel {ms_k:.4f} ms "
          f"({moved / ms_k / 1e6:.1f} GB/s of write+read), plain {ms_p:.4f} ms", flush=True)
    return {"name": "block_scatter_rows", "route": "cuda",
            "source": "spectre_tpu_torch/csrc/block_scatter_rows.cu",
            "replaces": "spectre_tpu/ops/pallas/bwd_gather.py:343",
            "max_abs_err": 0.0, "ms": ms_k, "plain_ms": ms_p,
            "shape": f"xt[{d},256] bf16 -> [{heads * d},256]"}


def phase_kernel2(kernels, gen):
    b = 256
    shapes = ((65 * b, 512, 768), (65 * b, 768, 512), (b, 512, 100))
    limits = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    worst = {}
    times = []
    for m, k, n in shapes:
        x = torch.randn(m, k, generator=gen)
        w = torch.empty(k, n).uniform_(-k ** -0.5, k ** -0.5, generator=gen)
        bias = torch.empty(n).uniform_(-k ** -0.5, k ** -0.5, generator=gen)
        gamma = 1.0 + 0.1 * torch.randn(n, generator=gen)
        beta = 0.1 * torch.randn(n, generator=gen)
        for dtype, limit in limits.items():
            args = [t.to("cuda", dtype) for t in (x, w, bias, gamma, beta)]
            got = kernels.fused_spectre_linear(*args)
            ref = kernels.fused_spectre_linear_plain(*args)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            worst[dtype] = max(worst.get(dtype, 0.0), err)
            if not err <= limit:
                raise AssertionError(f"fused_spectre_linear ({m}x{k})x({k}x{n}) {dtype}: "
                                     f"max abs err {err} > {limit}")
            ms_k = cuda_time_ms(lambda: kernels.fused_spectre_linear(*args))
            ms_p = cuda_time_ms(lambda: kernels.fused_spectre_linear_plain(*args))
            gflops = 2 * m * k * n / 1e9
            print(f"kernel 2 ({m}x{k})x({k}x{n}) {str(dtype)[6:]}: max abs err {err:.3g}, "
                  f"kernel {ms_k:.4f} ms ({gflops / ms_k:.1f} TFLOP/s), plain {ms_p:.4f} ms",
                  flush=True)
            if dtype == torch.bfloat16:
                times.append((m, k, n, ms_k, ms_p))
    m, k, n, ms_k, ms_p = max(times, key=lambda t: t[3])
    return {"name": "fused_spectre_linear_fwd", "route": "cuda",
            "source": "spectre_tpu_torch/csrc/fused_spectre_linear.cu",
            "replaces": "spectre_tpu/ops/pallas/fused_linear.py:94",
            "max_abs_err": worst[torch.bfloat16], "ms": ms_k, "plain_ms": ms_p,
            "max_abs_err_f32": worst[torch.float32],
            "shape": f"({m}x{k})x({k}x{n}) bf16"}


def phase_model(kernels, build_model, parse_config):
    cfg = parse_config(CONFIG)
    t0 = time.perf_counter()
    model = build_model(cfg, "cuda")
    torch.cuda.synchronize()
    print(f"model: flagship built on cuda in {time.perf_counter() - t0:.2f} s "
          f"(E={cfg.embed_dim} H={cfg.num_heads} layers={cfg.num_encoders} "
          f"{cfg.compute_dtype} compute, mix_block={cfg.mix_block})", flush=True)
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (256, cfg.in_channels, cfg.img_size, cfg.img_size)).astype(np.float32)).cuda()
    with torch.inference_mode():
        model(x)  # warm-up
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        logits = model(x)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3
        counts = kernels.launch_counts()
        want = {"block_scatter_rows": cfg.num_encoders,
                "fused_spectre_linear": 2 * cfg.num_encoders + 1}
        if counts != want:
            raise AssertionError(f"one forward launched {counts}, want {want}")
        # the same module on the plain versions, swapped in where the model
        # calls the wrappers
        with mock.patch("spectre_tpu_torch.models.layers.block_scatter_rows",
                        kernels.block_scatter_rows_plain), \
                mock.patch("spectre_tpu_torch.ops.linear.fused_spectre_linear",
                           kernels.fused_spectre_linear_plain):
            ref = model(x)
        torch.cuda.synchronize()
    if tuple(logits.shape) != (256, cfg.num_classes) or not torch.isfinite(logits).all():
        raise AssertionError(f"bad logits: shape {tuple(logits.shape)}, "
                             f"finite {bool(torch.isfinite(logits).all())}")
    diff = (logits - ref).abs().max().item()
    if not diff <= MODEL_ATOL:
        raise AssertionError(f"kernel path vs plain path logits differ by {diff} > {MODEL_ATOL}")
    print(f"model: bucket-256 forward {fwd_ms:.2f} ms (host clock, synchronised), "
          f"launches {counts}, logits finite [256, {cfg.num_classes}], max |kernel - plain| "
          f"{diff:.4g} (limit {MODEL_ATOL}), |logits| max {logits.abs().max().item():.3f}",
          flush=True)
    return model, cfg


def phase_serve(kernels, serve, client_cls, model, cfg):
    rng = np.random.default_rng(1)
    shape = (cfg.in_channels, cfg.img_size, cfg.img_size)
    requests = [("SPQ2", rng.uniform(0, 1, (b, *shape)).astype(np.float32)) for b in (1, 7, 64)]
    requests.append(("SPQ3", rng.integers(0, 256, (5, *shape), dtype=np.uint8)))
    kernels.reset_launch_counts()
    srv, port = serve.start(["--config", CONFIG, "--device", "cuda", "--port", "0"])
    replies = []
    try:
        with client_cls(port=port) as c:
            for rnd in ("first", "second"):
                for wire, x in requests:
                    t0 = time.perf_counter()
                    got = c.infer(x) if wire == "SPQ2" else c.infer_u8(x)
                    ms = (time.perf_counter() - t0) * 1e3
                    print(f"serve: {wire} batch {x.shape[0]} ({rnd} send): {ms:.2f} ms",
                          flush=True)
                    replies.append((wire, x, got))
    finally:
        srv.close()
    counts = kernels.launch_counts()
    if min(counts.values()) < 1:
        raise AssertionError(f"serving run launched no kernel of the path: {counts}")
    for wire, x, got in replies:
        b = x.shape[0]
        bucket = 1 << (b - 1).bit_length()
        xp = np.concatenate([x, np.zeros((bucket - b, *shape), x.dtype)])
        with torch.inference_mode():
            xt = torch.from_numpy(xp).cuda()
            if wire == "SPQ3":
                xt = xt.to(torch.float32) / 255.0
            want = model(xt)[:b].float().cpu().numpy()
        if got.shape != (b, cfg.num_classes):
            raise AssertionError(f"{wire} batch {b}: reply shape {got.shape}")
        diff = float(np.abs(got - want).max())
        if not diff <= 1e-3:
            raise AssertionError(f"{wire} batch {b}: reply differs from a direct forward "
                                 f"by {diff}")
    print(f"serve: {len(replies)} replies match direct forwards (<= 1e-3); "
          f"launches during the serving run {counts}", flush=True)
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 2
    # the port, imported only once a card is known to be there
    from spectre_tpu_torch.configs import parse_config
    from spectre_tpu_torch.models import build_model
    from spectre_tpu_torch.ops import kernels
    from spectre_tpu_torch.ops.kernels import build
    from spectre_tpu_torch.repl import serve
    from spectre_tpu_torch.serving import SpectreClient

    if not os.path.exists(CONFIG):
        raise FileNotFoundError(CONFIG)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"device: {name}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    so = build.build()
    build.load_library()
    print(f"build: {os.path.relpath(so, ROOT)} in {time.perf_counter() - t0:.2f} s", flush=True)

    gen = torch.Generator().manual_seed(0)
    k1 = phase_kernel1(kernels, gen)
    k2 = phase_kernel2(kernels, gen)
    model, cfg = phase_model(kernels, build_model, parse_config)
    counts = phase_serve(kernels, serve, SpectreClient, model, cfg)
    k1["launches"] = counts["block_scatter_rows"]
    k2["launches"] = counts["fused_spectre_linear"]

    print(smi, flush=True)
    print(json.dumps({"kernels": [k1, k2]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
