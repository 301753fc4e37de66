"""The readings the correctness limits are set from, on the card at a cell's
own size, several seeds in one process (the benchmark's own runs do not run
this):

- ``program``: the program's first steps (or, for a serving cell, a short
  window's sampled replies) against the float32 reference, as a run
  compares them: the lower reading of each number;
- ``control``: the reference itself computed with fp8 products (e4m3
  operands, e5m2 gradients, a scale a tensor), the precision below the
  configuration's bf16, against the float32 reference: the upper reading;
- ``half_batch`` (training): the reference with half of each batch left out
  and the mean taken over the rest, a fault planted in its place;
- ``unchanged`` (training): the reference whose steps leave the parameters
  and the optimizer's state unchanged, read as a run reads the program: the
  first gradient from an optimizer state that has none reads zero.

One JSON line a seed and reading.

    python3 portbench/control.py --workload spectre_vit.train.b1024 --seeds 1 2 3
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if not __package__:  # run as a script: import the package from the checkout's root
    sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != HERE]


def train_readings(cell, seed: int, device) -> list[dict]:
    from portbench import correct
    from portbench.drive_train import Trainer, reference

    trainer = Trainer(cell, seed, device)
    prog = trainer.first_steps(int(cell.traffic["check_steps"]))
    trainer.close()
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    steps = int(cell.traffic["check_steps"])
    ref = reference(cell, trainer, device, steps=steps)
    frozen = reference(cell, trainer, device, steps=steps, frozen=True)
    unchanged = (frozen[0], {k: torch.zeros_like(v) for k, v in frozen[1].items()}, frozen[2])
    out = []
    for kind, cand in (("program", prog),
                       ("control", reference(cell, trainer, device, "fp8", steps=steps)),
                       ("half_batch", reference(cell, trainer, device, half_batch=True,
                                                steps=steps)),
                       ("unchanged", unchanged)):
        numbers = correct.train_numbers(cand[0], ref[0], cand[1], ref[1], cand[2], ref[2])
        out.append({"reading": kind, **numbers, "losses": cand[0], "ref_losses": ref[0]})
    return out


def serve_readings(cell, seed: int, device, seconds: float) -> list[dict]:
    import torch

    from portbench import correct, drive_serve
    from portbench.common import derive_seeds
    from portbench.reference.common import make_params
    from portbench.reference.steps import family, served_logits
    from portbench.serve_client import image_pool

    numbers: dict = {}
    result, _ = drive_serve.run(cell, seed, seconds, False, device, time.perf_counter(), numbers)
    t, m = cell.traffic, cell.config["model"]
    sd = derive_seeds(seed)
    n = int(t["clients"]) * int(t["sample_cap"]) * int(t["request_images"])
    pixels = image_pool(n, (m["in_channels"], m["img_size"], m["img_size"]), sd.data)
    params = make_params(family(cell.config["reference"]).spec(m), sd.weights, device)
    ref = served_logits(cell.config, params, pixels, device)
    ctl = served_logits(cell.config, params, pixels, device, precision="fp8")
    del params
    torch.cuda.empty_cache()
    return [{"reading": "program", **numbers,
             "serve_img_s": result["metrics"].get("serve_img_s", {}).get("value")},
            {"reading": "control", **correct.logit_numbers(ctl, ref)}]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0, help="a serving cell's window")
    p.add_argument("--out", default=None, help="also append the lines to this file")
    a = p.parse_args(argv)
    import torch

    from portbench.manifest import find_cell, load_manifest

    cell = find_cell(load_manifest(os.path.join(ROOT, "BENCHMARK.json")), a.workload, ROOT)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in a.seeds:
        t = time.perf_counter()
        if cell.traffic["kind"] == "train":
            lines = train_readings(cell, seed, device)
        else:
            lines = serve_readings(cell, seed, device, a.seconds)
        for line in lines:
            line = {"workload": a.workload, "seed": seed, **line,
                    "seconds": time.perf_counter() - t}
            print(json.dumps(line), flush=True)
            if a.out:
                with open(a.out, "a") as f:
                    f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
