"""The port's training (spectre_tpu_torch.train, .data, .repl.train) against
the JAX package's, on the CPU in float32: the same weights (initialised in
JAX, carried over by the weight bridge), the same batches (numpy, seeded),
dropout 0, no augmentation, ``fast_rng=False``."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import REPO_ROOT, tiny_export_cfg
from spectre_tpu.data.datasets import _synthetic as jax_synthetic
from spectre_tpu.data.pipeline import BatchIterator as JaxBatchIterator
from spectre_tpu.models import build_model as jax_build_model
from spectre_tpu.ops.fused_mix import clear_mix_routes, register_block_mix_routes
from spectre_tpu.train.optim import make_optimizer as jax_make_optimizer
from spectre_tpu.train.optim import make_schedule as jax_make_schedule
from spectre_tpu.train.state import create_train_state as jax_create_train_state
from spectre_tpu.train.state import param_count as jax_param_count
from spectre_tpu.train.step import make_eval_step as jax_make_eval_step
from spectre_tpu.train.step import make_train_step as jax_make_train_step
from spectre_tpu_torch.data import BatchIterator, synthetic_dataset
from spectre_tpu_torch.configs import FLAGSHIP, parse_config
from spectre_tpu_torch.repl import bench
from spectre_tpu_torch.repl import train as train_cli
from spectre_tpu_torch.models import Dropout, MHPermutMix, build_model, load_flax_variables
from spectre_tpu_torch.train import (
    create_train_state,
    make_eval_step,
    make_optimizer,
    make_schedule,
    make_train_step,
    param_count,
    train_from_config,
)

STEPS_PER_EPOCH = 6  # with epochs=2: a 12-step cosine, so 10 steps move the lr


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfg(**over):
    return tiny_export_cfg(**(dict(mix_impl="folded", mix_block=8, epochs=2) | over))


def _batches(cfg, n, b=8, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(0, 1, (b, 3, 8, 8)).astype(np.float32),
             rng.integers(0, cfg.num_classes, b).astype(np.int32)) for _ in range(n)]


def _both_states(cfg):
    """(JAX model, JAX state, port state) holding the same weights."""
    jm = jax_build_model(cfg)
    jstate = jax_create_train_state(jm, jax_make_optimizer(cfg, STEPS_PER_EPOCH),
                                    jnp.zeros((1, 3, 8, 8)), seed=0)
    model = build_model(cfg, "cpu", train=True)
    load_flax_variables(model, _np({"params": jstate.params, "buffers": jstate.buffers}))
    optimizer, scheduler = make_optimizer(cfg, model.parameters(), STEPS_PER_EPOCH)
    return jm, jstate, create_train_state(model, optimizer, scheduler, seed=0)


@pytest.mark.parametrize("over", [dict(), dict(warmup_steps=3, eta_min=1e-5),
                                  dict(warmup_epochs=1)])
def test_schedule_matches_optax(over):
    cfg = _cfg(**over)
    got, want = make_schedule(cfg, STEPS_PER_EPOCH), jax_make_schedule(cfg, STEPS_PER_EPOCH)
    for step in range(15):  # past the end of the 12-step decay too
        assert abs(got(step) - float(want(step))) <= 1e-9, step


# the plain cosine schedule, and warmup + global-norm clipping (0.05 is
# under the first gradient's norm, so the clip is active)
@pytest.mark.parametrize("over", [dict(), dict(warmup_steps=3, grad_clip_norm=0.05)])
def test_train_steps_match_jax(over):
    """Parameters after step 1 within 1e-6; the loss at each of 10 steps
    within 1e-4; the step counter and learning rate advance."""
    cfg = _cfg(**over)
    jm, jstate, state = _both_states(cfg)
    assert param_count(state.model) == jax_param_count(jstate.params)
    register_block_mix_routes(jstate.variables())
    try:
        jstep = jax_make_train_step(jm, augment_fn=None, fast_rng=False)
        step = make_train_step(grad_clip_norm=getattr(cfg, "grad_clip_norm", None))
        for i, (x, y) in enumerate(_batches(cfg, 10)):
            jstate, jmetrics = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
            metrics = step(state, torch.from_numpy(x), torch.from_numpy(y))
            assert abs(float(metrics["loss"]) - float(jmetrics["loss"])) <= 1e-4, i
            assert float(metrics["accuracy"]) == float(jmetrics["accuracy"]), i
            if i == 0:
                ported = load_flax_variables(
                    build_model(cfg, "cpu"),
                    _np({"params": jstate.params, "buffers": jstate.buffers}))
                want = dict(ported.named_parameters())
                for name, p in state.model.named_parameters():
                    diff = (p.detach() - want[name].detach()).abs().max().item()
                    assert diff <= 1e-6, (name, diff)
    finally:
        clear_mix_routes()
    assert state.step == int(jstate.step) == 10
    lr = state.optimizer.param_groups[0]["lr"]
    assert abs(lr - float(jax_make_schedule(cfg, STEPS_PER_EPOCH)(10))) <= 1e-9


def test_a_train_step_derives_no_mix_table():
    """The tables depend on the buffers only: three optimizer steps and an
    eval pass leave each mix layer at its one derivation (which copies the
    permutation to the host), and a new permutation causes exactly one more."""
    cfg = _cfg()
    model = build_model(cfg, "cpu", train=True)
    optimizer, scheduler = make_optimizer(cfg, model.parameters(), STEPS_PER_EPOCH)
    state = create_train_state(model, optimizer, scheduler)
    mixes = [m for m in model.modules() if isinstance(m, MHPermutMix)]
    assert [m.table_derivations for m in mixes] == [1, 1]
    step = make_train_step()
    for x, y in _batches(cfg, 3):
        step(state, torch.from_numpy(x), torch.from_numpy(y))
    model.eval()
    with torch.no_grad():
        model(torch.from_numpy(_batches(cfg, 1)[0][0]))
    assert [m.table_derivations for m in mixes] == [1, 1]
    with torch.no_grad():
        mixes[0].perms.copy_(mixes[0].perms.flip(1))
        model(torch.from_numpy(_batches(cfg, 1)[0][0]))
    assert [m.table_derivations for m in mixes] == [2, 1]


def test_grad_accumulation_equals_the_full_batch_step():
    cfg = _cfg()
    (x, y), = _batches(cfg, 1, b=8)
    after = []
    for accum in (1, 2):
        model = build_model(cfg, "cpu", train=True)
        optimizer, scheduler = make_optimizer(cfg, model.parameters(), STEPS_PER_EPOCH)
        state = create_train_state(model, optimizer, scheduler)
        metrics = make_train_step(grad_accum_steps=accum)(
            state, torch.from_numpy(x), torch.from_numpy(y))
        after.append(([p.detach().clone() for p in model.parameters()], metrics))
    for pa, pb in zip(after[0][0], after[1][0]):
        assert (pa - pb).abs().max().item() <= 1e-6
    assert abs(float(after[0][1]["loss"]) - float(after[1][1]["loss"])) <= 1e-6
    with pytest.raises(ValueError, match="divisible"):
        make_train_step(grad_accum_steps=3)(state, torch.from_numpy(x), torch.from_numpy(y))


def test_auxiliary_loss_hook_is_summed_into_the_objective():
    cfg = _cfg()
    model = build_model(cfg, "cpu", train=True)
    optimizer, scheduler = make_optimizer(cfg, model.parameters(), STEPS_PER_EPOCH)
    state = create_train_state(model, optimizer, scheduler)
    (x, y), = _batches(cfg, 1)
    step = make_train_step()
    head = model.mlp_head
    head.register_forward_hook(
        lambda m, a, out: setattr(m, "spectre_loss", 0.5 * out.float().pow(2).mean()))
    metrics = step(state, torch.from_numpy(x), torch.from_numpy(y))
    assert float(metrics["loss_aux"]) > 0
    with torch.no_grad():
        model.eval()
        model(torch.from_numpy(x))
    assert abs(float(metrics["loss_aux"]) - float(head.spectre_loss)) < 1.0


def test_eval_step_sums_under_a_padded_mask_match_jax():
    cfg = _cfg()
    jm, jstate, state = _both_states(cfg)
    (x, y), = _batches(cfg, 1, b=8, seed=3)
    mask = np.array([1, 1, 1, 1, 1, 0, 0, 0], np.bool_)
    want = jax_make_eval_step(jm)(jstate.params, jstate.buffers, jnp.asarray(x),
                                  jnp.asarray(y), jnp.asarray(mask))
    eval_step = make_eval_step(state.model)
    with pytest.raises(RuntimeError, match="eval mode"):
        eval_step(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(mask))
    state.model.eval()
    got = eval_step(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(mask))
    assert abs(float(got["loss_sum"]) - float(want["loss_sum"])) <= 1e-4
    assert int(got["correct"]) == int(want["correct"])
    assert int(got["count"]) == int(want["count"]) == 5


def test_dropout_keep_rate_eval_identity_and_seeded_masks():
    x = torch.ones(200, 500)
    drop = Dropout(0.1)
    drop.generator = torch.Generator().manual_seed(7)
    out = drop(x)
    kept = (out != 0).float().mean().item()
    sigma = (0.1 * 0.9 / x.numel()) ** 0.5
    assert abs(kept - 0.9) <= 3 * sigma
    assert torch.allclose(out[out != 0], torch.tensor(1.0 / 0.9))
    drop.generator.manual_seed(7)
    assert torch.equal(drop(x), out)
    assert not torch.equal(drop(x), out)
    drop.eval()
    assert drop(x) is x
    # one generator for every Dropout of a model, set by the train state
    cfg = _cfg(dropout=0.1)
    model = build_model(cfg, "cpu", train=True)
    optimizer, scheduler = make_optimizer(cfg, model.parameters(), STEPS_PER_EPOCH)
    state = create_train_state(model, optimizer, scheduler, seed=5)
    drops = [m for m in model.modules() if isinstance(m, Dropout)]
    assert len(drops) == 1 + cfg.num_encoders
    assert all(m.generator is state.dropout_generator and m.p == 0.1 for m in drops)
    xb = torch.from_numpy(_batches(cfg, 1)[0][0])
    a = model(xb)
    state.dropout_generator.manual_seed(5)
    b = model(xb)
    assert torch.equal(a, b) and not torch.equal(model(xb), a)
    assert build_model(cfg, "cpu").training is False  # serving callers: eval mode


def test_data_copies_match_the_jax_package():
    for name, split in (("cifar100", "train"), ("mnist", "test")):
        (x, y), (jx, jy) = synthetic_dataset(name, split), jax_synthetic(name, split)
        assert x.dtype == jx.dtype and np.array_equal(x, jx) and np.array_equal(y, jy)
    x, y = synthetic_dataset("mnist", "test")
    for shuffle in (True, False):
        ours = BatchIterator(x[:100], y[:100], 32, shuffle=shuffle, seed=3)
        theirs = JaxBatchIterator(x[:100], y[:100], 32, shuffle=shuffle, seed=3)
        assert len(ours) == len(theirs) == (3 if shuffle else 4)
        for _ in range(2):  # two epochs: the shuffle stream advances alike
            for a, b in zip(ours, theirs, strict=True):
                assert all(np.array_equal(a[k], b[k]) for k in ("image", "label", "mask"))


def test_train_from_config_runs_epochs_and_validates(capsys, tmp_path, monkeypatch):
    cfg = _cfg(dataset="mnist", in_channels=1, batch_size=512, val_batch_size=600,
               epochs=2, learning_rate=3e-3, checkpoint_dir=str(tmp_path))
    result = train_from_config(cfg, device="cpu", synthetic=True)
    assert result.state.step == 16  # 4096 // 512 steps in each of 2 epochs
    assert len(result.train_losses) == 2 and result.train_losses[1] < result.train_losses[0]
    assert 0.0 <= result.last_val_accuracy <= result.best_val_accuracy <= 1.0
    assert result.images_per_sec > 0 and result.state.model.training
    assert capsys.readouterr().out.count("val loss") == 2
    capped = train_from_config(cfg, device="cpu", synthetic=True, max_steps=3,
                               checkpoint=False, write_metrics=False)
    assert capped.state.step == 3 and len(capped.train_losses) == 1
    # without the synthetic flag the dataset is searched for on the disk, and
    # the synthetic set stands in only when no file is found
    monkeypatch.delenv("SPECTRE_DATA_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    cfg.data_dir = str(tmp_path / "no_such_dir")
    searched = train_from_config(cfg, device="cpu", synthetic=False, max_steps=1,
                                 checkpoint=False, write_metrics=False)
    assert searched.state.step == 1


def test_bench_counts_flops_from_the_config_and_refuses_a_bad_clock():
    """The flagship's products per image, written out: the embedding, four
    layers of mix projection (with its grouped pool residual) and two linears
    (each with its pool-matrix product, as 512 and 768 do not divide), the
    head; a step is three forwards. The peak is looked up by the card's name
    and an unknown name raises; two timings that do not lie on a rising line
    raise."""
    cfg = parse_config(FLAGSHIP)
    n, e, eh, hd = 65, 512, 8192, 768
    layer = 2 * n * eh * e + n * eh + 2 * (2 * n * e * hd) + 2 * (2 * n * hd * e)
    want = 2 * 64 * 48 * e + 4 * layer + 2 * (2 * e * 100)
    assert bench.forward_flops_per_image(cfg) == want
    assert bench.train_flops_per_step(cfg, 1024) == 3 * 1024 * want == 9_229_540_786_176
    cfg.hidden_dim = 512  # square linears carry the identity residual: no pool product
    assert bench.forward_flops_per_image(cfg) == want - 4 * (8 * n * e * hd) + 4 * (4 * n * e * e)
    assert bench.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert bench.peak_flops("NVIDIA H100 PCIe") == 756e12
    with pytest.raises(RuntimeError, match="no published bf16 peak"):
        bench.peak_flops("NVIDIA H100")
    slope, const = bench.slope_seconds(0.52, 1.52, 5, 15)
    assert slope == pytest.approx(0.1) and const == pytest.approx(0.02)
    with pytest.raises(RuntimeError, match="non-linear"):
        bench.slope_seconds(1.0, 0.9, 5, 15)  # more steps in less time
    with pytest.raises(RuntimeError, match="non-linear"):
        bench.slope_seconds(0.1, 1.5, 5, 15)  # a constant well below zero
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA card"):
            bench.main([])


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "spectre_tpu_torch.repl.train", *args],
                          cwd=REPO_ROOT, capture_output=True, text=True, timeout=300)


def test_train_cli_takes_steps_on_the_cpu_and_refuses_cuda_without_a_card(tmp_path):
    tiny = ["--config", "spectre_tpu_torch/configs/spectre_vit_mnist.py", "--synthetic",
            "--steps", "3", "--no-checkpoint", "--set", "num_encoders=1", "batch_size=16",
            "val_batch_size=512", f"checkpoint_dir={tmp_path}"]
    r = _cli("--device", "cpu", *tiny)
    assert r.returncode == 0, r.stderr
    assert "epoch 1/5 step 3 train loss" in r.stdout
    loss = float(r.stdout.split("last train loss ")[1].split(",")[0])
    assert np.isfinite(loss)
    if not torch.cuda.is_available():
        r = _cli("--device", "cuda", *tiny)
        assert r.returncode != 0 and "torch.cuda.is_available() is False" in r.stderr
    # --multihost joins a process group (without torchrun's variables, one
    # of this process alone), trains under DDP and leaves no group behind;
    # at one rank its losses are the plain run's, bit for bit
    plain = train_cli.main(["--device", "cpu", *tiny])
    multi = train_cli.main(["--device", "cpu", "--multihost", *tiny])
    assert multi.state.layout.kind == "dp" and not torch.distributed.is_initialized()
    assert multi.train_losses == plain.train_losses
    # a config with use_distillation runs the distill loop (a tiny teacher)
    r = train_cli.main(["--device", "cpu", *tiny, "use_distillation=True", "teacher_img_size=32",
                        "teacher_depth=1", "teacher_embed_dim=32", "teacher_num_heads=2",
                        "teacher_num_registers=2"])
    assert r.state.step == 3 and np.isfinite(r.metrics["loss"])
    assert r.logdir.split("/")[-1].startswith("distill_")
