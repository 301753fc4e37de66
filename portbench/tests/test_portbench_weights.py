"""The benchmark's weights (``reference/common.py::make_params``): the same
bytes as before each ``uniform`` and ``normal`` leaf was scaled in place, for
every family a configuration runs, and those leaves held once, as views of
their draw."""

from __future__ import annotations

import hashlib
import json
import os

import pytest
import torch

from portbench.manifest import PACKAGE, ROOT
from portbench.reference import dinov2, dinov3, spectre_vit, vit
from portbench.reference.common import make_params

SEED = 2**62 + 2**31 + 7  # a 63-bit seed, as ``derive_seeds`` gives them

# sha256 of every leaf's name, shape, type and bytes, as the out-of-place
# make_params gave them at SEED on the CPU
DIGESTS = {
    "spectre_vit": "902c156d8608dbd48b6adb7b06fbc33453f907b09be36e5bedfead3b1203d992",
    "vit": "3a2a3ba0bcd27288d3c74e01a1382deb7049e5b33c0427fbf604eafb1b14ce44",
    "dinov2": "177637026b432a3383044129d25c8300f086d0d278ab2bd9edf0c2bae4aad55b",
    "dinov3": "a3c5f53e45b90e65a01f4e91b11e24d130e277b401e5783fba5bcca9c8afcef8",
}
SPECS = {  # family: (its module, configuration, group)
    "spectre_vit": (spectre_vit, "spectre_vit_cifar100", "model"),
    "vit": (vit, "vit_cifar100", "model"),
    "dinov2": (dinov2, "distill_dinov2_cifar100", "teacher"),
    "dinov3": (dinov3, "distill_cifar100", "teacher"),
}


def _spec(name: str) -> list[tuple]:
    module, config, group = SPECS[name]
    with open(os.path.join(ROOT, PACKAGE, "configs", config + ".json")) as f:
        return module.spec(json.load(f)[group])


def _digest(params: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(params):
        v = params[k]
        h.update(f"{k}:{tuple(v.shape)}:{v.dtype};".encode())
        h.update(v.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(SPECS))
def test_weights_are_the_same_bytes_as_out_of_place(name):
    assert _digest(make_params(_spec(name), SEED, "cpu")) == DIGESTS[name]


@pytest.mark.parametrize("name", sorted(SPECS))
def test_drawn_leaves_are_views_of_one_draw_a_kind(name):
    """Every ``uniform`` leaf lies in one storage, and every ``normal`` leaf
    in another, no larger than the leaves: no second copy of the weights."""
    spec = _spec(name)
    params = make_params(spec, SEED, "cpu")
    for kind in ("uniform", "normal"):
        leaves = [params[n] for n, _, k, _ in spec if k == kind]
        storages = {leaf.untyped_storage().data_ptr() for leaf in leaves}
        assert len(storages) == 1
        assert leaves[0].untyped_storage().nbytes() == sum(x.nbytes for x in leaves)


def test_each_drawn_leaf_is_its_slice_of_the_draw_scaled():
    spec = [("u", (3, 4), "uniform", 0.5), ("n", (5,), "normal", 0.02),
            ("v", (2, 2), "uniform", 2.0), ("m", (1, 3), "normal", 3.0)]
    params = make_params(spec, SEED, "cpu")
    gen = torch.Generator().manual_seed(SEED)
    uniform, normal = torch.rand(16, generator=gen), torch.randn(8, generator=gen)
    assert torch.equal(params["u"], ((uniform[:12] * 2.0 - 1.0) * 0.5).view(3, 4))
    assert torch.equal(params["v"], ((uniform[12:] * 2.0 - 1.0) * 2.0).view(2, 2))
    assert torch.equal(params["n"], normal[:5] * 0.02)
    assert torch.equal(params["m"], (normal[5:] * 3.0).view(1, 3))
