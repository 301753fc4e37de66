"""The port's parallelism (spectre_tpu_torch.parallel) against the JAX
package's on the CPU: the same flax weights (initialised in JAX, carried
over by the weight bridge), the same global batch, f32, dropout 0, no
augmentation.

The port's ranks are processes over gloo (tests/torch_port_parallel_worker.py,
one launch of 2 ranks and one of 4); the JAX steps run on the 8-device CPU
mesh in the same layout (DP 2, FSDP 2, TP 1 x 2, FSDP x TP 2 x 2), whose
equality with JAX's single-device step the JAX package's own tests hold.
Limits: losses within 1e-5 relative and 1e-6 absolute (sums in another
order: the partial products and LayerNorm statistics of the tensor-parallel
layers, the gradient reductions). Parameters after 2 AdamW steps within
1e-5 relative and PARAM_ATOL absolute: AdamW divides each gradient's mean by
its root mean square, so the last bits of a gradient near zero move its
update by a good part of the learning rate; JAX's own mesh steps differ from
JAX's single-device step by up to 1.3e-5 on these weights, and the port's
single-device step from JAX's by 8.3e-6. So the AdamW moments after the
first step, which scale with the gradient, are held too, within GRAD_REL of
each leaf's largest entry. The placement of every leaf is exactly JAX's.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from conftest import REPO_ROOT
from spectre_tpu.models import build_model as jax_build_model
from spectre_tpu.ops.fused_mix import clear_mix_routes
from spectre_tpu.parallel import (
    SPECTRE_TP_RULES as JAX_SPECTRE_RULES,
    VIT_TP_RULES as JAX_VIT_RULES,
    apply_fsdp as jax_apply_fsdp,
    apply_tp as jax_apply_tp,
    create_mesh as jax_create_mesh,
    fsdp_shardings,
    pin_step_shardings,
    replicated_sharding,
    shard_batch as jax_shard_batch,
    tp_shardings,
)
from spectre_tpu.train.optim import make_optimizer as jax_make_optimizer
from spectre_tpu.train.state import create_train_state as jax_create_train_state
from spectre_tpu.train.step import make_train_step as jax_make_train_step
from spectre_tpu_torch.data import RowWindow, make_train_augment, rank_slice
from spectre_tpu_torch.models import build_model, flax_state_dict, load_flax_variables, save_npz
from spectre_tpu_torch.parallel import (
    MIN_SHARD_SIZE,
    SPECTRE_TP_RULES,
    VIT_TP_RULES,
    assert_dp_signature,
    assert_fsdp_signature,
    assert_tp_signature,
    fsdp_specs,
    local_rows,
    rank_seed,
    shard_batch,
    tp_specs,
)
from spectre_tpu_torch.train import create_train_state, make_optimizer, make_train_step

sys.path.insert(0, os.path.dirname(__file__))
import torch_port_parallel_worker as worker  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
LR = 1e-3  # the configs' learning rate
PARAM_ATOL = 0.03 * LR
# The attention's key bias has a gradient of zero up to rounding (softmax is
# invariant to a shift of the keys): AdamW's update of it is that rounding
# divided by its own RMS, up to the learning rate a step, on either side.
ZERO_GRADIENT = ("self_attn.mhsa.key.bias",)
# The moments after one step within this share of their leaf's largest entry,
# the limit of the port's gradient tests (tests/test_torch_port_grads.py);
# the zero-gradient leaves above within it of the largest entry of any leaf.
GRAD_REL = 1e-4
WORKER_TIMEOUT_S = 300
# leg -> (model, data ranks, model ranks, fsdp, clip)
LEGS = {"dp": ("spectre", 2, 1, False, None), "fsdp": ("spectre", 2, 1, True, None),
        "fsdp_clip": ("spectre", 2, 1, True, worker.CLIP),
        "tp_spectre": ("spectre", 1, 2, False, None), "tp_vit": ("vit", 1, 2, False, None),
        "tp_branch": ("branch", 1, 2, False, None),
        "fsdp_tp": ("spectre", 2, 2, True, None)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_init(kind):
    cfg = worker.config(kind)
    jm = jax_build_model(cfg)
    state = jax_create_train_state(jm, jax_make_optimizer(cfg, worker.STEPS_PER_EPOCH),
                                   jnp.zeros((1, 3, 8, 8)), seed=0)
    return jm, state


def _spec_of(sharding) -> tuple:
    spec = list(sharding.spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def _jax_specs(kind, shardings):
    """JAX's specs of a param tree by the port's parameter names."""
    model = build_model(worker.config(kind), "cpu")
    return {k: _spec_of(v) for k, v in flax_state_dict(
        model, {"params": shardings}).items() if k in dict(model.named_parameters())}


def _adam_state(opt_state) -> optax.ScaleByAdamState:
    """The AdamW moments (mu, nu) of an optax state, clipped or not."""
    return next(n for n in jax.tree.leaves(
        opt_state, is_leaf=lambda n: isinstance(n, optax.ScaleByAdamState))
        if isinstance(n, optax.ScaleByAdamState))


def launch(leg: str, world: int, d: str) -> dict:
    """Start ``world`` ranks of the worker; rank 0's result."""
    env = dict(os.environ, PYTHONPATH=REPO_ROOT, XLA_FLAGS="", OMP_NUM_THREADS="1")
    procs = []
    for rank in range(world):
        err = open(os.path.join(d, f"{leg}{rank}.err"), "w+")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.join(REPO_ROOT, "tests", "torch_port_parallel_worker.py"),
             leg, str(rank), str(world), d], cwd=REPO_ROOT, env=env,
            stdout=subprocess.DEVNULL, stderr=err), err))
    failed = []
    for proc, err in procs:
        try:
            proc.communicate(timeout=WORKER_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
        err.seek(0)
        if proc.returncode != 0:
            failed.append(err.read()[-3000:])
        err.close()
    assert not failed, f"{leg}: a rank failed:\n" + "\n---\n".join(failed)
    return torch.load(os.path.join(d, f"{leg}.pt"), weights_only=False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX mesh runs and the port's ranks, on the same weights and batch."""
    clear_mix_routes()
    d = str(tmp_path_factory.mktemp("parallel"))
    inits = {kind: _jax_init(kind) for kind in ("spectre", "vit", "branch")}
    for kind, (_, state) in inits.items():
        save_npz(os.path.join(d, f"{kind}.npz"),
                 _np({"params": state.params, "buffers": state.buffers}))
    port = {**launch("parity2", 2, d), **launch("parity4", 4, d)}

    x, y = worker.batch()
    jax_runs = {}
    for leg, (kind, dp, mp, fsdp, clip) in LEGS.items():
        cfg = worker.config(kind, grad_clip_norm=clip)
        jm = jax_build_model(cfg)
        s = jax_create_train_state(jm, jax_make_optimizer(cfg, worker.STEPS_PER_EPOCH),
                                   jnp.zeros((1, 3, 8, 8)), seed=0)
        mesh = jax_create_mesh(jax.devices()[:dp * mp], data_parallel=dp, model_parallel=mp)
        step = jax_make_train_step(jm, fast_rng=False)
        rules = JAX_VIT_RULES if kind == "vit" else JAX_SPECTRE_RULES
        if fsdp:
            s = jax_apply_fsdp(s, mesh, min_size=worker.MIN_SIZE,
                               tp_rules=rules if mp > 1 else None)
            step = pin_step_shardings(step, s)
        elif mp > 1:
            s = jax_apply_tp(s, mesh, rules)
        else:
            s = jax.device_put(s, replicated_sharding(mesh))
        b = jax_shard_batch(mesh, {"image": x, "label": y})
        # the layout applied (GSPMD's propagation moves unpinned leaves later)
        specs = _jax_specs(kind, jax.tree.map(lambda a: a.sharding, s.params))
        model = build_model(cfg, "cpu")
        losses, moments = [], None
        for _ in range(2):
            s, m = step(s, b["image"], b["label"])
            losses.append(float(m["loss"]))
            if moments is None:
                adam = _adam_state(s.opt_state)
                moments = {key: flax_state_dict(model, {"params": _np(tree)})
                           for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu))}
        jax_runs[leg] = {"losses": losses, "params": flax_state_dict(
            model, {"params": _np(s.params)}), "specs": specs, "moments": moments}
    return {"port": port, "jax": jax_runs}


@pytest.mark.parametrize("kind", ["spectre", "vit"])
def test_tp_specs_equal_jax(kind):
    jm, state = _jax_init(kind)
    mesh = jax_create_mesh(jax.devices(), data_parallel=4, model_parallel=2)
    rules, jax_rules = (VIT_TP_RULES, JAX_VIT_RULES) if kind == "vit" \
        else (SPECTRE_TP_RULES, JAX_SPECTRE_RULES)
    want = _jax_specs(kind, tp_shardings(state.params, mesh, jax_rules))
    got = tp_specs(build_model(worker.config(kind), "cpu"), 2, rules)
    assert got == want
    assert any("model" in s for s in got.values())


@pytest.mark.parametrize("layout,min_size", [((8, 1), 1024), ((4, 2), 1024),
                                             ((8, 1), MIN_SHARD_SIZE)])
def test_fsdp_specs_equal_jax(layout, min_size):
    """The largest divisible dim, TP claims first, small leaves whole."""
    dp, mp = layout
    _, state = _jax_init("spectre")
    mesh = jax_create_mesh(jax.devices(), data_parallel=dp, model_parallel=mp)
    want = _jax_specs("spectre", fsdp_shardings(
        state.params, mesh, min_size=min_size,
        tp_rules=JAX_SPECTRE_RULES if mp > 1 else None))
    got = fsdp_specs(build_model(worker.config("spectre"), "cpu"), dp, min_size=min_size,
                     tp_rules=SPECTRE_TP_RULES if mp > 1 else None, model_size=mp)
    assert got == want


@pytest.mark.parametrize("leg", ["dp", "fsdp", "tp_spectre", "tp_vit", "tp_branch", "fsdp_tp"])
def test_placements_after_steps_equal_jax(runs, leg):
    """Every parameter's layout after 2 steps is the one it was given, and
    JAX's for the same tree: DTensor shards where JAX shards, whole leaves
    where JAX replicates."""
    port, want = runs["port"][leg], runs["jax"][leg]["specs"]
    assert port["specs"] == port["specs_before"]
    assert port["specs"] == want


@pytest.mark.parametrize("leg", list(LEGS))
def test_losses_equal_jax_mesh_step(runs, leg):
    np.testing.assert_allclose(runs["port"][leg]["losses"], runs["jax"][leg]["losses"],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("leg", list(LEGS))
def test_parameters_after_two_steps_equal_jax(runs, leg):
    got, want = runs["port"][leg]["params"], runs["jax"][leg]["params"]
    assert set(got) == set(want)
    for name, p in got.items():
        atol = 2 * 2 * LR if name.endswith(ZERO_GRADIENT) else PARAM_ATOL
        np.testing.assert_allclose(p.numpy(), want[name], rtol=RTOL, atol=atol, err_msg=name)


@pytest.mark.parametrize("leg", list(LEGS))
def test_adamw_moments_after_one_step_equal_jax(runs, leg):
    """After the first step exp_avg = (1 - b1) g and exp_avg_sq = (1 - b2) g^2
    of the reduced (and clipped) gradient: unlike the parameters, which
    AdamW's division by the RMS leaves alike for a gradient off by a
    constant factor, they show the gradient's scale. Gathered whole, against
    JAX's mu and nu in the same layout."""
    got, want = runs["port"][leg]["moments"], runs["jax"][leg]["moments"]
    for key in ("exp_avg", "exp_avg_sq"):
        assert set(got) == set(want[key])
        top = max(float(np.abs(w).max()) for w in want[key].values())
        for name, t in got.items():
            w = want[key][name]
            scale = top if name.endswith(ZERO_GRADIENT) else float(np.abs(w).max())
            err = float(np.abs(t[key].numpy() - w).max())
            assert err <= GRAD_REL * scale, f"{name} {key}: {err} > {GRAD_REL} * {scale}"


@pytest.mark.parametrize("leg", ["fsdp", "fsdp_tp"])
def test_adamw_moments_are_sharded_like_the_parameters(runs, leg):
    """Each rank holds 1/dp of every sharded parameter's moments (1/(dp*mp)
    where TP splits it too), in the parameter's layout."""
    port = runs["port"][leg]
    _, dp, mp, _, _ = LEGS[leg]
    sharded = {n: s for n, s in port["specs"].items() if "data" in s}
    assert sharded
    for name, spec in sharded.items():
        assert port["moment_specs"][name] == spec, name
        assert port["moment_fraction"][name] == 1 / (dp * (mp if "model" in spec else 1)), name


def test_audit_signatures(runs):
    """DP: a gradient all-reduce and no all-gather at all (no exemption);
    FSDP: all-gathers and reduce-scatters; TP: more all-reduces than DP."""
    port = runs["port"]
    assert_dp_signature(port["dp"]["audit"])
    assert port["dp"]["audit"].get("all-gather", 0) == 0
    assert_fsdp_signature(port["fsdp"]["audit"])
    assert_fsdp_signature(port["fsdp_tp"]["audit"])
    # each layer's linear1 gathers its statistics and its row sums
    assert_tp_signature(port["tp_spectre"]["audit"], port["dp"]["audit"],
                        column_layers=worker.config("spectre").num_encoders)
    assert_tp_signature(port["tp_vit"]["audit"], port["dp"]["audit"])
    assert port["tp_branch"]["audit"].get("all-gather", 0) >= 1  # linear1's output


@pytest.mark.parametrize("leg", ["dp", "fsdp"])
def test_gradient_accumulation_equals_the_whole_batch(runs, leg):
    """2 microbatches a rank, the reduction skipped on the first (DDP's
    ``no_sync``, FSDP2's ``set_requires_gradient_sync(False)``): the
    parameters of the whole local batch's step (sums in another order)."""
    got, want = runs["port"][f"{leg}_accum"], runs["port"][leg]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL, atol=ATOL)
    for name, p in got["params"].items():
        np.testing.assert_allclose(p.numpy(), want["params"][name].numpy(), rtol=RTOL,
                                   atol=PARAM_ATOL, err_msg=name)


def test_signature_asserts():
    assert_dp_signature({"all-reduce": 2})
    with pytest.raises(AssertionError):
        assert_dp_signature({})
    with pytest.raises(AssertionError):
        assert_dp_signature({"all-reduce": 1, "all-gather": 3})
    assert_fsdp_signature({"all-reduce": 1, "all-gather": 5, "reduce-scatter": 5})
    with pytest.raises(AssertionError):
        assert_fsdp_signature({"all-reduce": 4})
    assert_tp_signature({"all-reduce": 3}, {"all-reduce": 1})
    assert_tp_signature({"all-reduce": 3, "all-gather": 4}, {"all-reduce": 1}, column_layers=2)
    with pytest.raises(AssertionError):
        assert_tp_signature({"all-reduce": 1}, {"all-reduce": 1})
    with pytest.raises(AssertionError):
        assert_tp_signature({"all-reduce": 3, "all-gather": 3}, {"all-reduce": 1},
                            column_layers=2)


def _single_device(cfg, steps, x, y, d_weights):
    model = build_model(cfg, "cpu", train=True)
    load_flax_variables(model, d_weights)
    optimizer, scheduler = make_optimizer(cfg, model.parameters(), worker.STEPS_PER_EPOCH)
    state = create_train_state(model, optimizer, scheduler, seed=0)
    step = make_train_step(grad_clip_norm=getattr(cfg, "grad_clip_norm", None))
    for _ in range(steps):
        step(state, torch.from_numpy(x), torch.from_numpy(y).long())
    return state


def test_fsdp_clipping_equals_single_process(runs):
    """The clip's norm is reduced over every rank's shards: FSDP with
    ``grad_clip_norm`` gives the single process's parameters."""
    _, jstate = _jax_init("spectre")
    x, y = worker.batch()
    state = _single_device(worker.config("spectre", grad_clip_norm=worker.CLIP), 2, x, y,
                           _np({"params": jstate.params, "buffers": jstate.buffers}))
    got = runs["port"]["fsdp_clip"]["params"]
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(got[name].numpy(), p.detach().numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    # the clip acted: without it the parameters differ
    free = runs["port"]["fsdp"]["params"]
    assert any(not torch.allclose(free[n], got[n], rtol=RTOL, atol=ATOL) for n in got)


def _unwrapped_logits(params, x):
    _, jstate = _jax_init("spectre")
    model = build_model(worker.config("spectre"), "cpu")
    load_flax_variables(model, _np({"params": jstate.params, "buffers": jstate.buffers}))
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(params[name])
        return model(torch.from_numpy(x))


def test_fsdp_validation_equals_the_unwrapped_model(runs):
    """After a step, FSDP's eval forward equals the unwrapped model with the
    same weights; three batches fold each mix's weights once, and a further
    step folds them again from the new weights (the cache keys on the
    stored shard, not on FSDP's gathered buffer)."""
    port = runs["port"]["fsdp"]
    x, _ = worker.batch()
    torch.testing.assert_close(port["eval_logits"], _unwrapped_logits(port["params"], x),
                               rtol=RTOL, atol=ATOL)
    assert port["eval_repeat_equal"]
    assert port["eval_folds"] == 1
    torch.testing.assert_close(port["eval_logits_after"],
                               _unwrapped_logits(port["params_after"], x),
                               rtol=RTOL, atol=ATOL)
    assert port["eval_folds_after"] == 2
    assert not torch.equal(port["eval_logits"], port["eval_logits_after"])


def test_row_windows_draw_the_global_batch():
    """The augmentation of a batch split over 2 ranks, each drawing through
    its RowWindow, equals the augmentation of the whole batch: the draws do
    not depend on the layout."""
    aug = make_train_augment((0.5,) * 3, (0.5,) * 3)
    x = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (8, 3, 8, 8))
                         .astype(np.float32))
    whole = aug(torch.Generator().manual_seed(7), x)
    parts = [aug(RowWindow(torch.Generator().manual_seed(7), 8, start), x[start:start + 4])
             for start in (0, 4)]
    torch.testing.assert_close(torch.cat(parts), whole, rtol=0, atol=0)


def test_rank_slices_and_rows():
    x, y = np.arange(10)[:, None] * np.ones((1, 2)), np.arange(10)
    a, b = rank_slice(x, y, 0, 3), rank_slice(x, y, 2, 3)
    assert len(a[0]) == len(b[0]) == 3  # truncated to the shortest slice
    assert list(b[1]) == [2, 5, 8]
    assert local_rows(None, 8) == slice(0, 8)
    assert shard_batch(None, {"image": x, "valid": 3})["valid"] == 3
    assert rank_seed(42, 0) == 42 and rank_seed(42, 1) != 42
