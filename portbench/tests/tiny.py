"""A checkout of the benchmark at a tiny size for the CPU tests: a copy of
``BENCHMARK.json`` whose cells run a shrunk configuration (the flagship's or
the ViT's, image 16, E 64, 2 heads, FF 96, one layer, 10 classes) under
small train and serve mixes, with the real readers; and one whose cell
distils a 2-block teacher at 32 px into that student."""

from __future__ import annotations

import json
import os
import shutil

from portbench.manifest import PACKAGE, ROOT

SHRINK = {"img_size": 16, "embed_dim": 64, "num_heads": 2, "hidden_dim": 96,
          "num_encoders": 1, "num_classes": 10}
TRAIN = {"kind": "train", "batch_size": 16, "dataset_images": 64, "check_steps": 3,
         "warmup_steps": 1, "trace_s": 0.2}
TEACHER = {"img_size": 32, "patch_size": 8, "embed_dim": 64, "num_heads": 2, "depth": 2,
           "mlp_hidden_dim": 256, "num_classes": 10}
DISTILL = dict(TRAIN, kind="distill")
SERVE = {"kind": "serve", "clients": 2, "request_images": 4, "max_batch": 8,
         "batch_timeout_s": 0.0, "pool_images": 64, "warm_buckets": [4, 8], "warm_rounds": 1,
         "sample_p": 1.0, "sample_cap": 2, "trace_s": 0.2}


def tiny_root(path: str, config: str = "spectre_vit_cifar100", **model) -> str:
    """Write the tiny checkout under ``path``: cells ``tiny.train`` and
    ``tiny.serve`` of config ``tiny``; ``model`` overrides more of it (both
    in the program's config and in the benchmark's copy)."""
    pkg = os.path.join(path, PACKAGE)
    os.makedirs(os.path.join(pkg, "configs"))
    os.makedirs(os.path.join(pkg, "traffic"))
    shutil.copytree(os.path.join(ROOT, PACKAGE, "layer_metrics"),
                    os.path.join(pkg, "layer_metrics"))
    with open(os.path.join(ROOT, PACKAGE, "configs", config + ".json")) as f:
        conf = json.load(f)
    over = dict(SHRINK, **model)
    conf["overrides"] = dict(conf["overrides"], **over)
    conf["model"].update(over)
    with open(os.path.join(pkg, "configs", "tiny.json"), "w") as f:
        json.dump(conf, f)
    for name, mix in (("tiny_train", TRAIN), ("tiny_serve", SERVE)):
        with open(os.path.join(pkg, "traffic", name + ".json"), "w") as f:
            json.dump(mix, f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] = [{"name": "tiny", "source": "https://example.org/tiny",
                         "file": f"{PACKAGE}/configs/tiny.json", "reduced": [],
                         "why": "the CPU tests' size"}]
    bench["workloads"] = [
        {"name": "tiny.train", "config": "tiny", "traffic": "tiny_train", "chips": 1, "why": "t"},
        {"name": "tiny.serve", "config": "tiny", "traffic": "tiny_serve", "chips": 1, "why": "s"}]
    serving = ("serve_img_s", "serve_p95_ms", "serve.images_per_bucket", "mfu.serve",
               "idle_pct.serve")
    for key in ("end_to_end", "per_layer"):
        bench[key] = [m for m in bench[key] if m["name"] not in serving]
        for metric in bench[key]:
            if "workloads" in metric:
                metric["workloads"] = ["tiny.train"]
    # the serving mix's metrics, as a serving cell lists them
    bench["end_to_end"] += [
        {"name": "serve_img_s", "unit": "img/s", "better": "higher", "bound": 0.25,
         "source": "host_clock", "workloads": ["tiny.serve"]},
        {"name": "serve_p95_ms", "unit": "ms", "better": "lower", "bound": 0.25,
         "source": "host_clock", "workloads": ["tiny.serve"]}]
    bench["per_layer"] += [
        {"name": name, "unit": unit, "better": better, "source": source, "layer": layer,
         "moves": "serve_img_s", "workloads": ["tiny.serve"]}
        for name, unit, better, source, layer in (
            ("serve.images_per_bucket", "img", "higher", "program_counter", "serving"),
            ("mfu.serve", "%", "higher", "host_clock", "device"),
            ("idle_pct.serve", "%", "lower", "device_trace", "device"))]
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return path


def tiny_distill_root(path: str, config: str = "distill_dinov2_cifar100",
                      teacher: dict | None = None, **model) -> str:
    """Write a tiny checkout under ``path`` whose one cell, ``tiny.distill``
    of config ``tiny_distill``, distils the shrunk ``TEACHER`` (in the
    program's ``teacher_*`` keys and the benchmark's ``teacher`` group) into
    the shrunk student, with the cell's per-layer metrics; ``teacher``
    overrides more of the benchmark's ``teacher`` group alone."""
    pkg = os.path.join(path, PACKAGE)
    os.makedirs(os.path.join(pkg, "configs"))
    os.makedirs(os.path.join(pkg, "traffic"))
    shutil.copytree(os.path.join(ROOT, PACKAGE, "layer_metrics"),
                    os.path.join(pkg, "layer_metrics"))
    with open(os.path.join(ROOT, PACKAGE, "configs", config + ".json")) as f:
        conf = json.load(f)
    over = dict(SHRINK, **model)
    conf["model"].update(over)
    conf["teacher"].update(TEACHER, **(teacher or {}))
    conf["distill"]["teacher_img_size"] = TEACHER["img_size"]
    conf["overrides"] = dict(conf["overrides"], **over, teacher_img_size=TEACHER["img_size"],
                             **{"teacher_" + k: TEACHER[k] for k in
                                ("patch_size", "embed_dim", "num_heads", "depth")})
    with open(os.path.join(pkg, "configs", "tiny_distill.json"), "w") as f:
        json.dump(conf, f)
    with open(os.path.join(pkg, "traffic", "tiny_distill.json"), "w") as f:
        json.dump(DISTILL, f)
    cell = ["tiny.distill"]
    bench = {"command": ["python3", f"{PACKAGE}/run.py"], "paths": [PACKAGE], "run_seconds": 10,
             "configs": [{"name": "tiny_distill", "source": "https://example.org/tiny",
                          "file": f"{PACKAGE}/configs/tiny_distill.json", "reduced": [],
                          "why": "the CPU tests' size"}],
             "workloads": [{"name": "tiny.distill", "config": "tiny_distill",
                            "traffic": "tiny_distill", "chips": 1, "why": "d"}],
             "end_to_end": [{"name": "train_img_s", "unit": "img/s", "better": "higher",
                             "bound": 0.01, "source": "host_clock", "workloads": cell},
                            {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
                             "source": "host_clock"}],
             "per_layer": [{"name": name, "unit": unit, "better": better, "source": source,
                            "layer": layer, "moves": "train_img_s", "workloads": cell}
                           for name, unit, better, source, layer in (
                               ("input_wait_ms.distill", "ms", "lower", "host_clock",
                                "input pipeline"),
                               ("host_issue_ms.distill", "ms", "lower", "host_clock",
                                "trainer step"),
                               ("elementwise_ms.distill", "ms", "lower", "device_trace",
                                "models and ops"),
                               ("mfu.distill", "%", "higher", "host_clock", "device"),
                               ("idle_pct.distill", "%", "lower", "device_trace", "device"))]}
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return path
