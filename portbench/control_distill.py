"""The readings the limits of a distillation cell are set from, on the card
at the cell's own size, several seeds in one process (the benchmark's own
runs do not run this). Each reading is held against the float32 reference:

- ``program``: the distiller's first steps with the teacher online, as a run
  compares them: the lower reading of each number;
- ``control``: the reference itself, student and teacher, computed with fp8
  products (``reference/common.py``), the precision below the
  configuration's bf16: the upper reading;
- ``half_batch``: the reference with half of each batch left out and the
  mean taken over the rest;
- ``unchanged``: the reference whose steps leave the parameters and the
  optimizer's state unchanged, read as a run reads the program;
- ``teacher:<fault>``: the reference with each fault of its teacher family
  planted (``FAULTS`` of ``reference/<family>.py``, such as DINOv3's RoPE
  left out or its registers dropped).

One JSON line a seed and reading, each naming the card it was read on.
The readings are the card's: with no CUDA device the tool stops, as a run
of the benchmark does.

    python3 portbench/control_distill.py --workload <cell> --seeds 1 2 3
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


def readings(cell, seed: int, device) -> list[dict]:
    import torch

    from portbench.drive_distill import Distiller, numbers, reference
    from portbench.reference.steps import family

    steps = int(cell.traffic["check_steps"])
    run = Distiller(cell, seed, device)
    prog = run.first_steps(steps)
    run.close()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = reference(cell, run, device, steps=steps)
    frozen = reference(cell, run, device, steps=steps, frozen=True)
    unchanged = (frozen[0], {k: torch.zeros_like(v) for k, v in frozen[1].items()}, frozen[2],
                 frozen[3])
    candidates = [("program", lambda: prog),
                  ("control", lambda: reference(cell, run, device, "fp8", steps=steps)),
                  ("half_batch", lambda: reference(cell, run, device, half_batch=True,
                                                   steps=steps)),
                  ("unchanged", lambda: unchanged)]
    candidates += [(f"teacher:{fault}",
                    lambda fault=fault: reference(cell, run, device, steps=steps,
                                                  teacher_fault=fault))
                   for fault in family(cell.config["teacher"]["reference"]).FAULTS]
    out = []
    for kind, make in candidates:
        cand = make()
        out.append({"reading": kind, **numbers(cand, ref), "losses": cand[0],
                    "ref_losses": ref[0]})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", default=None, help="also append the lines to this file")
    a = p.parse_args(argv)
    import torch

    from portbench.common import device_record
    from portbench.manifest import find_cell, load_manifest

    cell = find_cell(load_manifest(os.path.join(ROOT, "BENCHMARK.json")), a.workload, ROOT)
    if not torch.cuda.is_available():
        print("needs a CUDA device: the limits are read on the card at the cell's own size",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    kind = device_record(device, 1)["kind"]
    for seed in a.seeds:
        t = time.perf_counter()
        for line in readings(cell, seed, device):
            line = {"workload": a.workload, "device": kind, "seed": seed, **line,
                    "seconds": time.perf_counter() - t}
            print(json.dumps(line), flush=True)
            if a.out:
                with open(a.out, "a") as f:
                    f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
