"""Dropout under tensor parallelism draws the unsplit model's masks.

A Dropout after a column-split output (SpectreViT's linear1, the ViT's
linear1 under GELU) sees this rank's columns only. Drawn at that shape from
a generator that both model-axis partners hold alike, the two ranks would
drop the same positions of different column blocks, and every later draw
of the step would be offset against the unsplit step's. JAX's random bits
do not depend on the sharding, so its TP step with dropout is its
single-device step; the port's Dropout draws the whole row's mask and keeps
the rank's columns (``models/layers.py::Dropout``, ``split_by``).

Held here on the CPU: a 1 x 2 TP leg of the tiny SpectreViT and ViT with
dropout 0.1 (tests/torch_port_parallel_worker.py ``dropout2``, 2 ranks over
gloo) against the port's unwrapped single-process steps on the same seed:
every mask bit for bit, losses and parameters after 2 steps within the
limits of tests/test_torch_port_parallel.py.
"""

import os
import sys

import numpy as np
import pytest
import torch

from spectre_tpu_torch.models.layers import Dropout

sys.path.insert(0, os.path.dirname(__file__))
import torch_port_parallel_worker as worker  # noqa: E402
from test_torch_port_parallel import (  # noqa: E402
    ATOL, LR, PARAM_ATOL, RTOL, ZERO_GRADIENT, launch)

KINDS = ("spectre", "vit")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tp_dropout"))
    tp = launch("dropout2", 2, d)
    torch.manual_seed(0)
    return {"tp": tp, "single": {kind: worker.dropout_steps(kind, d) for kind in KINDS}}


@pytest.mark.parametrize("kind", KINDS)
def test_masks_equal_the_unsplit_steps(runs, kind):
    """Each call's masks: a column-split input's ranks side by side, a
    whole input's on every rank, equal to the single process's."""
    want = runs["single"][kind]["masks"]
    ranks = runs["tp"][kind]["masks"]
    assert len(want) > 0 and all(len(r) == len(want) for r in ranks)
    split = 0
    for i, w in enumerate(want):
        got = [r[i] for r in ranks]
        if got[0].shape != w.shape:
            split += 1
            got = [torch.cat(got, dim=-1)]
        for g in got:
            assert torch.equal(g, w), f"{kind}: dropout call {i} of {len(want)} differs"
    assert split > 0  # the column-split outputs were seen


@pytest.mark.parametrize("kind", KINDS)
def test_losses_and_parameters_equal_the_unsplit_steps(runs, kind):
    got, want = runs["tp"][kind], runs["single"][kind]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL, atol=ATOL)
    assert set(got["params"]) == set(want["params"])
    for name, p in got["params"].items():
        # a gradient of zero up to rounding moves AdamW by up to LR a step
        atol = 2 * 2 * LR if name.endswith(ZERO_GRADIENT) else PARAM_ATOL
        np.testing.assert_allclose(p.numpy(), want["params"][name].numpy(), rtol=RTOL,
                                   atol=atol, err_msg=name)


class _Columns(torch.nn.Module):
    """A layer whose output tensor parallelism keeps split by columns."""

    def __init__(self, features, rank, size):
        super().__init__()
        from spectre_tpu_torch.parallel.tp import TensorParallel

        self.features = features
        self.tp = TensorParallel(None, rank, size, "col", True)


@pytest.mark.parametrize("size", [2, 4])
def test_window_keeps_the_ranks_columns_of_the_whole_draw(size):
    d = Dropout(0.3)
    x = torch.ones(3, 5, 24)
    d.generator = torch.Generator().manual_seed(11)
    whole = d.mask(x)
    parts = []
    for rank in range(size):
        d.generator = torch.Generator().manual_seed(11)
        parts.append(d.mask(x[..., :24 // size], _Columns(24, rank, size)))
    assert torch.equal(torch.cat(parts, dim=-1), whole)
    d.generator = torch.Generator().manual_seed(11)
    assert torch.equal(d.mask(x), whole)  # no producer: the plain draw
