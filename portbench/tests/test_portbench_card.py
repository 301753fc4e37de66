"""On the card, at each cell's own size, three seeds: the control (the
reference computed with fp8 products in the program's place) fails the
cell's check, and the program's own readings pass it. Runs only where a
card is present:

    python -m pytest portbench/tests/test_portbench_card.py -q -p no:cacheprovider
"""

from __future__ import annotations

import pytest
import torch

from portbench import control
from portbench.manifest import find_cell, load_manifest

pytestmark = pytest.mark.cuda
CELLS = [w["name"] for w in load_manifest()["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control is read at the cell's own size")
    return torch.device("cuda")


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(card, name):
    cell = find_cell(load_manifest(), name)
    limits = cell.config["limits"][cell.traffic["kind"]]
    for seed in (101, 202, 303):
        if cell.traffic["kind"] == "train":
            lines = control.train_readings(cell, seed, card)
        else:
            lines = control.serve_readings(cell, seed, card, 3.0)
        readings = {line["reading"]: line for line in lines}
        assert all(readings["program"][k] <= v for k, v in limits.items()), readings["program"]
        assert any(readings["control"][k] > v for k, v in limits.items()), readings["control"]
