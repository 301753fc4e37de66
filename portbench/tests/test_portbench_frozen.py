"""The benchmark's frozen copies agree with the program's originals today:
the FLOP count, the bound arithmetic and its peaks, the device categories of
a trace, the names of the hand-written kernels, the u8 request and reply
frames."""

from __future__ import annotations

import glob
import json
import os
import re
import socket
import struct
import threading
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import flops, kernel_names, roofline, spq3
from portbench.manifest import PACKAGE, ROOT

CONFIGS = ["spectre_vit_cifar100", "vit_cifar100"]


def _model(name: str) -> dict:
    with open(os.path.join(ROOT, PACKAGE, "configs", name + ".json")) as f:
        return json.load(f)["model"]


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("batch", [256, 1024])
def test_flop_count_is_the_programs(name, batch):
    from spectre_tpu_torch.repl import bench

    m = _model(name)
    assert flops.train_flops_per_step(m, batch) == bench.train_flops_per_step(
        SimpleNamespace(**m), batch)
    assert flops.PEAK_BF16_FLOPS == bench.PEAK_BF16_FLOPS["NVIDIA H100 80GB HBM3"]


def test_flagship_step_is_9_23_tflop_at_1024():
    assert flops.train_flops_per_step(_model("spectre_vit_cifar100"), 1024) / 1e12 == \
        pytest.approx(9.23, abs=0.01)


@pytest.mark.parametrize("n_bytes,ops", [(1e9, 0.0), (1e6, 1e12), (3.35e9, 989e9)])
def test_bound_arithmetic_is_the_programs(n_bytes, ops):
    from spectre_tpu_torch.utils import timing

    assert (roofline.HBM_BYTES_PER_S, roofline.BF16_FLOPS) == (timing.HBM_BYTES_PER_S,
                                                               timing.BF16_FLOPS)
    assert roofline.bound_s(n_bytes, ops) * 1e3 == pytest.approx(timing.bound_ms(n_bytes, ops)[0])


def test_device_categories_are_the_parsers():
    from spectre_tpu_torch.profile import parser

    assert kernel_names.DEVICE_CATEGORIES == parser.DEVICE_CATEGORIES
    assert kernel_names.DROPPED_CATEGORIES == parser._DROPPED_CATEGORIES


def test_every_hand_written_kernel_is_classified_so():
    names = set()
    for path in glob.glob(os.path.join(ROOT, "spectre_tpu_torch", "csrc", "*.cu*")):
        text = open(path).read()
        names |= set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)",
                                text))
    assert len(names) >= 20
    for name in names:
        assert kernel_names.classify(f"void {name}<__nv_bfloat16, 4>(int, float*)") == \
            "hand_written", name
    assert kernel_names.classify("void at::native::vectorized_elementwise_kernel<4>()") == \
        "pytorch"
    assert kernel_names.classify("nvjet_hsh_256x128_64x4_1x2_h_bz_coopA_NTN") == \
        "library_product"
    assert kernel_names.classify("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy") == "memcpy"


def test_roofline_groups_find_their_kernels():
    group = re.compile(roofline.GROUPS["spectre_linear"][0])
    assert group.search("void fused_linear_wgmma_kernel<128, 192>(Params)")
    assert group.search("void chain_kernel<float, 4, 2>()")
    assert not group.search("void shard_chain_kernel<float>()")
    assert re.compile(roofline.GROUPS["attention"][0]).search(
        "void flash_attention_bwd_kernel_tc<64>()")


def test_request_and_reply_frames_are_the_clients():
    from spectre_tpu_torch.serving.client import SpectreClient

    images = np.arange(2 * 3 * 4 * 4, dtype=np.uint8).reshape(2, 3, 4, 4)
    logits = np.linspace(-1, 1, 2 * 5, dtype=np.float32).reshape(2, 5)
    reply = b"SPR1" + struct.pack("<II", 2, 5) + logits.tobytes()
    a, b = socket.socketpair()
    got = {}

    def serve():
        got["frame"] = spq3._recv(b, len(spq3.request_frame(images)))
        b.sendall(reply)

    t = threading.Thread(target=serve)
    t.start()
    client = SpectreClient.__new__(SpectreClient)
    client._sock = a
    out = client.infer_u8(images)
    t.join(timeout=10)
    assert got["frame"] == spq3.request_frame(images)
    np.testing.assert_array_equal(out, logits)
    c, d = socket.socketpair()
    d.sendall(reply)
    np.testing.assert_array_equal(spq3.read_reply(c), logits)
    for s in (a, b, c, d):
        s.close()
