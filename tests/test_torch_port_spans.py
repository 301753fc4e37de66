"""The program's spans (``spectre_tpu_torch/profile/spans.py``): with no
profiler ``span`` makes no torch call and hands back one shared no-op
context; under ``trace_step`` two train steps of a small flagship-shaped
model, fed by ``BatchIterator`` and ``prefetch_to_device`` through
``build_step``, leave every span of the input path, the step and the two
ops in the trace, nested as the program nests them, and train bit for bit
as they do with no profiler. The card's staging path and its slot wait are
checked on a card (``cuda`` marker). The file imports neither jax nor the
JAX package, so it runs on the GPU machine too:

    python -m pytest tests/test_torch_port_spans.py -q --noconftest -p no:cacheprovider
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from spectre_tpu_torch.configs import parse_config
from spectre_tpu_torch.data import BatchIterator, prefetch_to_device
from spectre_tpu_torch.profile import span, spans, trace_step
from spectre_tpu_torch.train.loop import build_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"img_size": 16, "embed_dim": 64, "num_heads": 2, "hidden_dim": 96,
         "num_encoders": 2, "num_classes": 10, "batch_size": 8}
STEP_SPANS = ("step", "step/augment", "step/forward", "step/backward", "step/optimizer")
OP_SPANS = ("op/mix", "op/spectre_linear")


def test_span_without_a_profiler_calls_no_torch_function(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("record_function called with no profiler running")

    monkeypatch.setattr(spans._profiler, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    first = span("step")
    assert span("op/mix") is first and span("data/gather") is first
    with first as inside:
        assert inside is None
    with span("step"), span("step/forward"):
        pass


def test_span_under_a_profiler_is_a_record_function():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        marked = span("step")
        assert isinstance(marked, torch.autograd.profiler.record_function)
        assert span("step") is not marked
    assert span("step") is span("op/mix")


def _trainer(device="cpu"):
    cfg = parse_config(os.path.join(ROOT, "spectre_tpu_torch/configs/spectre_vit_cifar100.py"))
    for k, v in SMALL.items():
        setattr(cfg, k, v)
    rng = np.random.default_rng(0)
    images = rng.random((32, 3, 16, 16), dtype=np.float32)
    labels = rng.integers(0, 10, 32).astype(np.int32)
    state, step = build_step(cfg, device, steps_per_epoch=4)
    feed = prefetch_to_device(BatchIterator(images, labels, 8, shuffle=True, seed=1), device)
    return state, step, feed


def _two_steps(state, step, feed) -> list[torch.Tensor]:
    losses = []
    for _ in range(2):
        batch = next(feed)
        losses.append(step(state, batch["image"], batch["label"])["loss"].detach().clone())
    return losses


def _program_spans(trace_file: str) -> list[dict]:
    with open(trace_file) as f:
        events = json.load(f)["traceEvents"]
    return sorted((e for e in events if e.get("cat") == "user_annotation"
                   and e["name"].split("/")[0] in ("data", "step", "op")),
                  key=lambda e: (e["ts"], -e["dur"]))


def _parents(found: list[dict]) -> list[tuple[str, str | None]]:
    """(span, the innermost span of its thread around it) for each span."""
    out = []
    for e in found:
        around = [p for p in found if p is not e and p["tid"] == e["tid"]
                  and p["ts"] <= e["ts"] and e["ts"] + e["dur"] <= p["ts"] + p["dur"]]
        inner = min(around, key=lambda p: p["dur"], default=None)
        out.append((e["name"], inner["name"] if inner else None))
    return out


@pytest.fixture(scope="module")
def traced_and_plain(tmp_path_factory):
    d = tmp_path_factory.mktemp("spans")
    plain = _trainer()
    plain_losses = _two_steps(*plain)
    traced = _trainer()
    with trace_step(str(d), device="cpu") as t:
        traced_losses = _two_steps(*traced)
    return t.trace_file, (plain[0], plain_losses), (traced[0], traced_losses)


def test_trace_holds_every_span_nested_as_the_program_nests_them(traced_and_plain):
    found = _program_spans(traced_and_plain[0])
    counts = {}
    for e in found:
        counts[e["name"]] = counts.get(e["name"], 0) + 1
    # two steps of one microbatch; two layers' mixes; linear1 and linear3 of
    # each layer and the head
    assert counts == {"data/gather": 2, "data/stage": 2, "step": 2, "step/augment": 2,
                      "step/forward": 2, "step/backward": 2, "step/optimizer": 2,
                      "op/mix": 4, "op/spectre_linear": 10}
    parents = set(_parents(found))
    assert parents == {("data/gather", None), ("data/stage", None), ("step", None),
                       ("step/augment", "step"), ("step/forward", "step"),
                       ("step/backward", "step"), ("step/optimizer", "step"),
                       ("op/mix", "step/forward"), ("op/spectre_linear", "step/forward")}
    # the batch is gathered and staged before the step that takes it
    order = [e["name"] for e in found if e["name"] in ("data/gather", "data/stage", "step")]
    assert order == ["data/gather", "data/stage", "step"] * 2


def test_a_traced_step_trains_bit_for_bit_as_an_untraced_one(traced_and_plain):
    _, (plain, plain_losses), (traced, traced_losses) = traced_and_plain
    assert [float(x) for x in plain_losses] == [float(x) for x in traced_losses]
    assert all(torch.equal(a, b) for a, b in zip(plain_losses, traced_losses))
    want = dict(plain.model.named_parameters())
    for name, p in traced.model.named_parameters():
        assert torch.equal(p, want[name]), name
    assert plain.step == traced.step == 2


@pytest.mark.cuda
def test_the_cards_staging_spans(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pinned staging path runs only on a card")
    images = np.random.default_rng(0).random((40, 3, 8, 8), dtype=np.float32)
    labels = np.arange(40, dtype=np.int32)
    feed = prefetch_to_device(BatchIterator(images, labels, 8, shuffle=False),
                              torch.device("cuda"), prefetch=2)
    with trace_step(str(tmp_path)) as t:
        got = [b["label"].cpu() for b in feed]
        torch.cuda.synchronize()
    assert torch.equal(torch.cat(got), torch.from_numpy(labels))
    found = _program_spans(t.trace_file)
    names = [e["name"] for e in found]
    # five batches staged; from the third on each waits for its slot's last copy
    assert names.count("data/gather") == 5 and names.count("data/stage") == 5
    assert names.count("data/slot_wait") == 3
    assert ("data/slot_wait", "data/stage") in set(_parents(found))
