"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration, traffic mix and metrics are found by the names in
``BENCHMARK.json`` (``portbench/manifest.py``); the runner of the mix's
``kind``, the file ``portbench/drive_<kind>.py``, runs it on one card. The
last line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``, each number of the correctness check beside its limit (also
the last lines of standard error). The kernels build into ``build/kernels/``
of the checkout on its first run and load from there afterwards.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if not __package__:
    # run as a script, this file's directory heads sys.path; its modules must
    # not shadow the standard library's, so the package is imported from the root
    sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != HERE]
os.environ.setdefault("USE_FLAX", "0")


def find_runner(kind: str):
    """The runner of traffic of ``kind``: the module ``portbench.drive_<kind>``,
    whose ``run(cell, seed, seconds, trace, device, t_start)`` returns
    (result, checks). A kind with no such module stops the run with a
    message that names the file looked for."""
    name = f"portbench.drive_{kind}"
    if str(kind).isidentifier():
        try:
            return importlib.import_module(name)
        except ModuleNotFoundError as e:
            if e.name != name:
                raise
    raise LookupError(f"no runner for traffic kind {kind!r}: looked for "
                      f"{os.path.join(HERE, f'drive_{kind}.py')}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    import spectre_tpu_torch
    import torch

    if not os.path.abspath(spectre_tpu_torch.__file__).startswith(ROOT + os.sep):
        print(f"the program imported from {spectre_tpu_torch.__file__}, not from this "
              f"checkout ({ROOT})", file=sys.stderr)
        return 2

    from portbench.common import emit, forbidden_modules
    from portbench.manifest import find_cell, load_manifest

    cell = find_cell(load_manifest(os.path.join(ROOT, "BENCHMARK.json")), a.workload, ROOT)
    try:
        runner = find_runner(cell.traffic["kind"])
    except LookupError as e:
        print(e, file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}", file=sys.stderr)
        return 2
    result, checks = runner.run(cell, a.seed, a.seconds, bool(a.trace), torch.device("cuda", 0),
                                T_START)
    found = forbidden_modules()
    if found:
        print(f"the process loaded {found}: the benchmark must not load JAX or the JAX "
              "package", file=sys.stderr)
        return 3
    emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
