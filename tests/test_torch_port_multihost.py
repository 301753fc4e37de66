"""The port's multi-process paths on the CPU, over gloo: the four legs of
``parallel/multihost_smoke.py`` (the bare DDP step with a checkpoint round
trip, FSDP, ``train_from_config`` and ``distill_from_config`` across 2
processes, as tests/test_multihost.py runs the JAX package's), the FSDP
train loop's checkpoints across layouts (tests/torch_port_parallel_worker.py,
leg ``loop``), ``repl/train.py --multihost``, and serving on two devices.
Checkpoints and resumes are held bit for bit; the smoke's losses across
processes within 1e-6 (each rank prints the loss averaged over the ranks).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import REPO_ROOT
from spectre_tpu_torch.models import build_model
from spectre_tpu_torch.serving import from_config
from spectre_tpu_torch.train import CheckpointManager, create_train_state, make_optimizer, \
    make_train_step

sys.path.insert(0, os.path.dirname(__file__))
import torch_port_parallel_worker as worker  # noqa: E402
from test_torch_port_parallel import launch  # noqa: E402

TIMEOUT_S = 300
ENV = dict(os.environ, PYTHONPATH=REPO_ROOT, OMP_NUM_THREADS="1")


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    """The four legs in one start of 2 processes: {leg: [rank 0's, rank 1's]}."""
    d = str(tmp_path_factory.mktemp("smoke"))
    procs = []
    for rank in range(2):
        err = open(os.path.join(d, f"rank{rank}.err"), "w+")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "spectre_tpu_torch.parallel.multihost_smoke",
             "--init-method", f"file://{os.path.join(d, 'rendezvous')}",
             "--num-processes", "2", "--process-id", str(rank), "--device", "cpu",
             "--ckpt-dir", os.path.join(d, "ckpt"), "--all"], cwd=REPO_ROOT, env=ENV,
            stdout=subprocess.PIPE, stderr=err, text=True), err))
    outs = []
    for proc, err in procs:
        try:
            out, _ = proc.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        err.seek(0)
        assert proc.returncode == 0, f"worker failed:\n{out}\n{err.read()[-3000:]}"
        err.close()
        outs.append([json.loads(line) for line in out.splitlines() if line.startswith("{")])
    legs = {}
    for lines in outs:
        for o in lines:
            legs.setdefault(o["leg"], []).append(o)
    return legs


def _common(outs, step):
    for rank, o in enumerate(outs):
        assert (o["process_id"], o["process_count"], o["global_devices"]) == (rank, 2, 2)
        assert o["step"] == step
    assert abs(outs[0]["loss"] - outs[1]["loss"]) <= 1e-6


def test_two_process_train_step_and_checkpoint(smoke):
    _common(smoke["step"], 1)
    assert all(o["restore_exact"] is True for o in smoke["step"])


def test_two_process_fsdp_step_and_sharded_checkpoint(smoke):
    _common(smoke["fsdp"], 1)
    assert all(o["fsdp_sharded"] is True and o["restore_exact"] is True
               for o in smoke["fsdp"])
    # the same global batch and weights: FSDP's loss is DDP's
    assert abs(smoke["fsdp"][0]["loss"] - smoke["step"][0]["loss"]) <= 1e-6


def test_two_process_full_train_loop(smoke):
    _common(smoke["train-loop"], 2)
    accs = [o["val_accuracy"] for o in smoke["train-loop"]]
    assert 0.0 <= accs[0] <= 1.0 and accs[0] == accs[1]  # the sums are all-reduced


def test_two_process_distill_loop(smoke):
    _common(smoke["distill-loop"], 2)


@pytest.fixture(scope="module")
def loop(tmp_path_factory):
    """The FSDP loop's runs (2 ranks), after a single-device checkpoint has
    been written for them to restore."""
    d = str(tmp_path_factory.mktemp("loop"))
    cfg = worker.config("spectre")
    model = build_model(cfg, "cpu", train=True)
    optimizer, scheduler = make_optimizer(cfg, model.parameters(), worker.STEPS_PER_EPOCH)
    state = create_train_state(model, optimizer, scheduler, seed=0)
    x, y = worker.batch()
    step = make_train_step()
    for _ in range(2):
        step(state, torch.from_numpy(x), torch.from_numpy(y).long())
    CheckpointManager(os.path.join(d, "single_ckpt")).save(state, {"accuracy": 0.0})
    return d, launch("loop", 2, d)


def _assert_bitwise(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_bitwise(a[k], b[k])
        else:
            assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])), k


def test_fsdp_loop_resume_equals_the_uninterrupted_run(loop):
    """Stopped at step 3 and resumed to 6 under FSDP: parameters, AdamW
    moments, step and rank 0's generator equal the run to 6, bit for bit."""
    _, out = loop
    assert out["world"] == 2 and out["resumed"]["step"] == out["whole"]["step"] == 6
    _assert_bitwise(out["resumed"], out["whole"])


def test_fsdp_checkpoint_restores_into_one_device(loop):
    """The FSDP run's step-3 file is the single-device format: it restores
    into a model and optimizer on one device, bit for bit."""
    _, out = loop
    ckpt = CheckpointManager(os.path.join(out["logdir"], "ckpt"))
    cfg = worker.config("spectre", num_encoders=1, in_channels=1)
    model = build_model(cfg, "cpu", train=True)
    optimizer, scheduler = make_optimizer(cfg, model.parameters(), 8)
    state = create_train_state(model, optimizer, scheduler, seed=0)
    ckpt.restore(state, step=3)
    assert state.step == 3
    for name, p in model.named_parameters():
        assert torch.equal(p.detach(), out["cut"][name]), name
    saved = torch.load(os.path.join(ckpt.directory, "step_00000003.pt"), weights_only=True)
    assert not any(k.startswith("module.") for k in saved["model"])
    assert len(saved["generators"]) == 2
    for i, s in state.optimizer.state_dict()["state"].items():
        _assert_bitwise(s, saved["optimizer"]["state"][i])


def test_one_device_checkpoint_restores_into_fsdp(loop):
    d, out = loop
    saved = torch.load(os.path.join(d, "single_ckpt", "step_00000002.pt"), weights_only=True)
    got = out["single_into_fsdp"]
    assert got["step"] == 2
    names = [n for n in saved["model"] if n in got["params"]]
    assert len(names) == len(got["params"])
    for name in names:
        assert torch.equal(got["params"][name], saved["model"][name]), name
    _assert_bitwise(got["moments"], saved["optimizer"]["state"])
    assert torch.equal(got["generator"], saved["generator"]["state"])


def test_train_cli_multihost_with_fsdp(tmp_path):
    """``repl/train.py --multihost`` joins the group torchrun describes (one
    rank here) and trains with FSDP."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(ENV, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port))
    r = subprocess.run(
        [sys.executable, "-m", "spectre_tpu_torch.repl.train", "--multihost", "--device", "cpu",
         "--synthetic", "--steps", "2", "--no-checkpoint", "--config",
         "spectre_tpu_torch/configs/spectre_vit_mnist.py", "--set", "num_encoders=1",
         "batch_size=16", "fsdp=True", f"checkpoint_dir={tmp_path}"],
        cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=TIMEOUT_S)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "layout=fsdp mesh=(1, 1)" in r.stdout and "done: 2 steps" in r.stdout


def test_two_devices_serve_the_replies_of_one():
    """``devices=["cpu", "cpu"]``: a replica each, buckets split over them
    and padded to a multiple of 2; the replies equal one device's."""
    cfg = worker.config("spectre")
    rng = np.random.default_rng(5)
    requests = [rng.uniform(0, 1, (b, 3, 8, 8)).astype(np.float32) for b in (1, 3, 8)]
    replies = {}
    for devices in (None, ["cpu", "cpu"]):
        srv = from_config(cfg, "cpu", max_batch=8, devices=devices)
        from spectre_tpu_torch.serving import SpectreClient

        port = srv.listen_tcp()
        try:
            with SpectreClient(port=port) as c:
                replies[str(devices)] = [c.infer(x) for x in requests]
        finally:
            srv.close()
    for one, two in zip(replies["None"], replies[str(["cpu", "cpu"])]):
        np.testing.assert_allclose(two, one, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="must divide"):
        from_config(cfg, "cpu", max_batch=7, devices=["cpu", "cpu"])
