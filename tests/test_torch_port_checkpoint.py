"""Checkpoints, resume, the save on SIGTERM, metric files and the eval entry
point of the port (the counterparts of tests/test_train.py's checkpoint and
resume tests), on the CPU in float32 at a tiny size."""

import json
import os
import signal
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from conftest import REPO_ROOT
from spectre_tpu.train.loop import train_from_config as jax_train_from_config
from spectre_tpu.utils.metrics import experiment_name as jax_experiment_name
from spectre_tpu_torch.models import MHPermutMix
from spectre_tpu_torch.repl import eval as eval_cli
from spectre_tpu_torch.train import CheckpointManager, make_train_step, train_from_config
from spectre_tpu_torch.train import loop as train_loop
from spectre_tpu_torch.train.loop import create_trainer, default_augment
from spectre_tpu_torch.utils import experiment_name


def _cfg(tmp_path, **over):
    cfg = SimpleNamespace(
        model="spectre_vit", method="permut_mix", mix_impl="folded", mix_block=8,
        dataset="mnist", img_size=8, patch_size=4, in_channels=1, num_classes=10,
        embed_dim=16, num_encoders=1, num_heads=2, hidden_dim=24, dropout=0.1,
        batch_size=512, val_batch_size=512, epochs=2, learning_rate=1e-3, random_seed=0,
        compute_dtype="float32", param_dtype="float32", checkpoint_dir=str(tmp_path),
        keep_checkpoints=2)
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


def _trained_state(cfg, steps=3, seed_batches=0):
    state = create_trainer(cfg, "cpu", steps_per_epoch=8)
    step = make_train_step(default_augment(cfg.dataset, cfg.in_channels))
    rng = np.random.default_rng(seed_batches)
    for _ in range(steps):
        x = torch.from_numpy(rng.uniform(0, 1, (8, cfg.in_channels, 8, 8)).astype(np.float32))
        step(state, x, torch.from_numpy(rng.integers(0, 10, 8)))
    return state


def _assert_states_bitwise_equal(a, b):
    assert a.step == b.step
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert list(sa) == list(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert list(oa["state"]) == list(ob["state"]) and len(oa["state"]) > 0
    for i, moments in oa["state"].items():
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(moments[k], ob["state"][i][k]), (i, k)
    assert a.scheduler.state_dict() == b.scheduler.state_dict()
    assert torch.equal(a.dropout_generator.get_state(), b.dropout_generator.get_state())


def test_checkpoint_round_trip_is_bit_for_bit(tmp_path):
    """Every parameter, buffer, AdamW moment, the scheduler's step and the
    generator's state; training continues identically from the restored
    state."""
    cfg = _cfg(tmp_path)
    state = _trained_state(cfg)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    mgr.save(state, {"accuracy": 0.5})
    mgr.wait()
    assert mgr.latest_step == mgr.best_step == 3
    assert not [n for n in os.listdir(tmp_path / "ckpt") if n.endswith(".tmp")]

    fresh = create_trainer(cfg, "cpu", steps_per_epoch=8)
    restored = CheckpointManager(str(tmp_path / "ckpt")).restore(fresh)
    assert restored is fresh and restored.step == 3
    assert restored.scheduler.last_epoch == 3
    assert any(k.endswith("perms") for k in state.model.state_dict())
    _assert_states_bitwise_equal(restored, state)
    step = make_train_step(default_augment("mnist", 1))
    x, y = torch.rand(8, 1, 8, 8), torch.arange(8)
    m1, m2 = step(state, x, y), step(restored, x, y)
    assert torch.equal(m1["loss"], m2["loss"])
    _assert_states_bitwise_equal(restored, state)
    mgr.close()
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        CheckpointManager(str(tmp_path / "empty")).restore(fresh)


def test_restore_into_another_seed_gives_the_saved_models_logits(tmp_path):
    """The mix tables are draws of the seed: restoring changes the buffers
    in place, and the mix layers must derive their block tables and folded
    weights again. Held on logits, not on shapes."""
    cfg = _cfg(tmp_path, dropout=0.0)
    state = _trained_state(cfg)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(state, {"accuracy": 0.1})
    x = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (4, 1, 8, 8))
                         .astype(np.float32))
    state.model.eval()
    with torch.no_grad():
        want = state.model(x)
    other = create_trainer(_cfg(tmp_path, dropout=0.0, random_seed=7), "cpu", steps_per_epoch=8)
    other.model.eval()
    mixes = [m for m in other.model.modules() if isinstance(m, MHPermutMix)]
    with torch.no_grad():
        before = other.model(x)  # also fills the caches a stale table would sit in
        derived = [m.table_derivations for m in mixes]
        assert not torch.equal(mixes[0].perms, state.model.state_dict()[
            "encoder_blocks.layer_0.mix_layer.perms"])
        mgr.restore(other)
        got = other.model(x)
    assert (before - want).abs().max().item() > 1e-3
    assert torch.equal(got, want)
    assert [m.table_derivations for m in mixes] == [d + 1 for d in derived]


def test_manager_keeps_the_latest_and_the_best(tmp_path):
    cfg = _cfg(tmp_path)
    state = create_trainer(cfg, "cpu", steps_per_epoch=8)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    for step, acc in ((1, 0.2), (2, 0.9), (3, 0.3), (4, 0.4), (5, 0.1)):
        state.step = step
        mgr.save(state, {"accuracy": acc, "loss": 1.0})
    files = sorted(n for n in os.listdir(tmp_path / "ckpt") if n.endswith(".pt"))
    assert files == ["step_00000002.pt", "step_00000004.pt", "step_00000005.pt"]
    assert mgr.latest_step == 5 and mgr.best_step == 2
    again = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)  # reads the index
    assert again.latest_step == 5 and again.best_step == 2
    assert again.restore(state, step=again.best_step).step == 2
    index = json.load(open(tmp_path / "ckpt" / "index.json"))
    assert index["steps"]["2"] == {"accuracy": 0.9, "loss": 1.0}


def test_generator_state_across_device_types_is_reseeded_with_a_warning(tmp_path):
    """A generator's state restores only into a generator of the same device
    type; otherwise everything else restores exactly and the generator is
    seeded with its initial seed plus the step."""
    cfg = _cfg(tmp_path)
    state = _trained_state(cfg)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(state)
    path = tmp_path / "ckpt" / "step_00000003.pt"
    payload = torch.load(path, weights_only=True)
    assert payload["generator"]["device"] == "cpu" and payload["generator"]["initial_seed"] == 0
    assert all(t.device.type == "cpu" for t in payload["model"].values())
    payload["generator"] = {"device": "cuda", "state": torch.zeros(16, dtype=torch.uint8),
                            "initial_seed": 0}
    torch.save(payload, path)
    fresh = create_trainer(cfg, "cpu", steps_per_epoch=8)
    with pytest.warns(UserWarning, match="initial_seed"):
        mgr.restore(fresh)
    assert torch.equal(fresh.dropout_generator.get_state(),
                       torch.Generator().manual_seed(3).get_state())
    for (k, a), b in zip(fresh.model.state_dict().items(), state.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_resume_continues_epochs_not_restarts(tmp_path):
    """A finished run resumed does zero steps; a raised epoch budget trains
    only the difference."""
    r1 = train_from_config(_cfg(tmp_path), device="cpu", synthetic=True, write_metrics=False)
    assert r1.state.step == 16 and r1.logdir.startswith(str(tmp_path))
    r2 = train_from_config(_cfg(tmp_path), device="cpu", synthetic=True, resume=True,
                           write_metrics=False)
    assert r2.state.step == 16 and r2.train_losses == []
    r3 = train_from_config(_cfg(tmp_path, epochs=4), device="cpu", synthetic=True, resume=True,
                           write_metrics=False)
    assert r3.state.step == 32 and len(r3.train_losses) == 2
    # without resume a run starts over, whatever lies in the directory
    r4 = train_from_config(_cfg(tmp_path), device="cpu", synthetic=True, max_steps=2,
                           write_metrics=False, checkpoint=False)
    assert r4.state.step == 2


@pytest.mark.parametrize("dataset,channels", [("mnist", 1), ("cifar100", 3)])
def test_resumed_run_is_bitwise_the_uninterrupted_run(tmp_path, dataset, channels):
    """Stopped mid-epoch by ``max_steps`` (twice, the second stop in the next
    epoch) and resumed, against one run to the same step: parameters, AdamW
    moments, schedule, generator and step bit for bit, with the dataset's
    augmentation and dropout on."""
    over = dict(dataset=dataset, in_channels=channels, num_classes=10 if channels == 1 else 100)
    whole = train_from_config(_cfg(tmp_path / "whole", **over), device="cpu", synthetic=True,
                              max_steps=13, write_metrics=False, checkpoint=False)
    assert whole.state.step == 13
    cfg = _cfg(tmp_path / "parts", **over)
    first = train_from_config(cfg, device="cpu", synthetic=True, max_steps=5,
                              write_metrics=False)
    assert first.state.step == 5
    second = train_from_config(cfg, device="cpu", synthetic=True, max_steps=11, resume=True,
                               write_metrics=False)
    assert second.state.step == 11
    third = train_from_config(cfg, device="cpu", synthetic=True, max_steps=13, resume=True,
                              write_metrics=False)
    _assert_states_bitwise_equal(third.state, whole.state)
    assert third.train_losses[-1] != whole.train_losses[-1]  # its epoch mean is of 2 steps
    # and the augmentation did draw: a run without it ends elsewhere
    plain = train_from_config(_cfg(tmp_path / "plain", **over), device="cpu", synthetic=True,
                              max_steps=13, write_metrics=False, checkpoint=False,
                              augment_fn=lambda gen, x: train_loop.make_eval_transform(
                                  *train_loop.dataset_stats(dataset))(x))
    a = next(iter(plain.state.model.parameters()))
    assert not torch.equal(a, next(iter(whole.state.model.parameters())))


def test_mid_epoch_resume_ends_with_the_schedule(tmp_path):
    cfg = _cfg(tmp_path, epochs=1)
    r1 = train_from_config(cfg, device="cpu", synthetic=True, max_steps=3, write_metrics=False)
    assert r1.state.step == 3
    r2 = train_from_config(cfg, device="cpu", synthetic=True, resume=True, write_metrics=False)
    assert r2.state.step == 8  # not 3 + 8: the trained prefix of the epoch is skipped


def test_sigterm_saves_without_validating_and_the_checkpoint_resumes(tmp_path, monkeypatch):
    """SIGTERM lands while the loop's handler is installed (raised from the
    batch stream after the second batch): the loop finishes the step, skips
    the validation pass (``last_val_accuracy`` stays -1), saves, and puts the
    previous handlers back."""
    real = train_loop.prefetch_to_device
    seen = []

    def previous_handler(signum, frame):
        seen.append(signum)

    def prefetch_and_preempt(it, device, **kw):
        for i, b in enumerate(real(it, device, **kw)):
            yield b
            if i == 1 and kw:  # the train stream (the validation stream passes no depth)
                os.kill(os.getpid(), signal.SIGTERM)

    cfg = _cfg(tmp_path, batch_size=64, val_batch_size=64, epochs=500)
    old = signal.signal(signal.SIGTERM, previous_handler)
    try:
        monkeypatch.setattr(train_loop, "prefetch_to_device", prefetch_and_preempt)
        r = train_from_config(cfg, device="cpu", synthetic=True, write_metrics=False)
        monkeypatch.setattr(train_loop, "prefetch_to_device", real)
        assert signal.getsignal(signal.SIGTERM) is previous_handler
        assert seen == []  # the loop's own handler took the signal
    finally:
        signal.signal(signal.SIGTERM, old)
    # the flag is seen after the step that follows the signal
    stopped = r.state.step
    assert 2 <= stopped <= 4 and r.last_val_accuracy == -1.0 and r.train_losses == []
    mgr = CheckpointManager(os.path.join(r.logdir, "ckpt"))
    assert mgr.latest_step == stopped
    r2 = train_from_config(cfg, device="cpu", synthetic=True, resume=True,
                           max_steps=stopped + 1, write_metrics=False)
    assert r2.state.step == stopped + 1 and r2.last_val_accuracy >= 0.0


def test_experiment_name_and_event_tags_equal_the_jax_packages(tmp_path):
    """The same run name for the same config, and the same sequence of
    (tag, step) in ``events.jsonl``: a train scalar pair every ``log_every``
    steps, the validation and throughput scalars per epoch, the training
    time at the end."""
    cfg = _cfg(tmp_path / "port", dropout=0.0, log_every=2, epochs=1)
    jcfg = _cfg(tmp_path / "jax", dropout=0.0, log_every=2, epochs=1)
    assert experiment_name(cfg) == jax_experiment_name(jcfg) == \
        "spectre_vit_mnist_mpermut_mix_e16_l1_h2_p4_b512_lr0.001"
    r = train_from_config(cfg, device="cpu", synthetic=True, max_steps=5, checkpoint=False)
    jr = jax_train_from_config(jcfg, synthetic=True, max_steps=5, checkpoint=False)
    assert os.path.relpath(r.logdir, tmp_path / "port") == \
        os.path.relpath(jr.logdir, tmp_path / "jax")

    def events(logdir):
        with open(os.path.join(logdir, "events.jsonl")) as f:
            return [json.loads(line) for line in f]

    ours, theirs = events(r.logdir), events(jr.logdir)
    assert [(e["tag"], e["step"]) for e in ours] == [(e["tag"], e["step"]) for e in theirs]
    tags = [e["tag"] for e in ours]
    assert tags[:4] == ["Loss/Train", "Accuracy/Train"] * 2
    assert tags[4:] == ["Loss/Validation", "Accuracy/Validation", "Perf/steps_per_sec",
                        "Perf/images_per_sec_per_chip", "Training time"]
    assert all(np.isfinite(e["value"]) and set(e) == {"t", "step", "tag", "value"}
               for e in ours)


def test_eval_entry_point_reports_the_loops_last_validation(tmp_path, capsys):
    cfg = _cfg(tmp_path, epochs=3, keep_checkpoints=3)
    r = train_from_config(cfg, device="cpu", synthetic=True, write_metrics=False)
    ckpt = os.path.join(r.logdir, "ckpt")
    index = json.load(open(os.path.join(ckpt, "index.json")))["steps"]
    loss, acc = eval_cli.evaluate(cfg, ckpt, synthetic=True, device="cpu")
    assert acc == r.last_val_accuracy == index["24"]["accuracy"]
    assert loss == pytest.approx(index["24"]["loss"], abs=1e-6)
    assert "restored step 24" in capsys.readouterr().out
    best = CheckpointManager(ckpt).best_step
    _, best_acc = eval_cli.evaluate(cfg, ckpt, best=True, synthetic=True, device="cpu")
    assert best_acc == r.best_val_accuracy == index[str(best)]["accuracy"]
    # no checkpoint: the seeded initial weights
    _, init_acc = eval_cli.evaluate(cfg, synthetic=True, device="cpu")
    assert 0.0 <= init_acc <= 1.0


def _run(module, *args):
    return subprocess.run([sys.executable, "-m", f"spectre_tpu_torch.repl.{module}", *args],
                          cwd=REPO_ROOT, capture_output=True, text=True, timeout=300)


def test_train_resume_and_eval_from_the_command_line(tmp_path):
    tiny = ["--device", "cpu", "--synthetic", "--config",
            "spectre_tpu_torch/configs/spectre_vit_mnist.py", "--set", "num_encoders=1",
            "batch_size=16", f"checkpoint_dir={tmp_path}"]
    r = _run("train", "--steps", "3", *tiny)
    assert r.returncode == 0, r.stderr
    assert "epoch 1/5 step 3 train loss" in r.stdout
    logdir = r.stdout.strip().rsplit("-> ", 1)[1]
    assert os.path.exists(os.path.join(logdir, "events.jsonl"))
    assert os.path.exists(os.path.join(logdir, "ckpt", "step_00000003.pt"))
    r = _run("train", "--steps", "5", "--resume", *tiny)
    assert r.returncode == 0, r.stderr
    assert "resumed from step 3" in r.stdout and "done: 5 steps" in r.stdout
    val = r.stdout.split("| val ")[1].split("\n")[0]  # "loss 2.8135 acc 0.1074"
    r = _run("eval", "--checkpoint", os.path.join(logdir, "ckpt"), *tiny)
    assert r.returncode == 0, r.stderr
    assert "restored step 5" in r.stdout
    assert f"val: loss {val.split()[1]} top-1 {val.split()[3]} (1024 examples)" in r.stdout


def test_serve_cli_serves_the_trainers_checkpoint_directory(tmp_path, capsys):
    """``repl/serve.py --ckpt <run>/ckpt`` restores the trainer's best step
    (else its latest) and replies with the trained model's eval logits; a
    directory without a checkpoint raises instead of serving the seeded
    init. (The ``.npz`` path: tests/test_torch_port_serving.py.)"""
    from spectre_tpu_torch.repl import serve
    from spectre_tpu_torch.serving import SpectreClient, from_config

    cfg = _cfg(tmp_path)
    r = train_from_config(cfg, device="cpu", synthetic=True, max_steps=3, write_metrics=False)
    ckpt = os.path.join(r.logdir, "ckpt")
    assert CheckpointManager(ckpt).best_step == 3
    cfg_path = tmp_path / "tiny.py"
    cfg_path.write_text("".join(f"{k} = {v!r}\n" for k, v in vars(cfg).items()))
    capsys.readouterr()
    srv, addr = serve.start(["--config", str(cfg_path), "--ckpt", ckpt, "--device", "cpu",
                             "--uds", str(tmp_path / "s.sock"), "--max-batch", "8"])
    try:
        assert f"restored step 3 (best) from {ckpt}" in capsys.readouterr().out
        x = np.random.default_rng(5).uniform(0, 1, (8, 1, 8, 8)).astype(np.float32)
        with SpectreClient(uds=addr) as c:
            got = c.infer(x)
    finally:
        srv.close()
    model = r.state.model.eval()
    with torch.inference_mode():
        want = model(torch.from_numpy(x)).float().numpy()
    np.testing.assert_array_equal(got, want)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        from_config(cfg, "cpu", checkpoint=str(empty))
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        serve.start(["--config", str(cfg_path), "--ckpt", str(tmp_path / "missing"),
                     "--device", "cpu", "--port", "0"])
