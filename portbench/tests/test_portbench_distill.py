"""The runner found by its traffic kind, the distillation cells' pieces on
the CPU at a tiny size: the teacher families' references against
independent formulas and against the program's teacher, the distiller's
MFU arithmetic, and whole runs of the distillation runner with the harness's
look for a card skipped: a sound run read as correct, and each fault a
distillation cell can have planted underneath the timed path and read as
not correct."""

from __future__ import annotations

import io
import json
import math
import os
import sys
import time
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

from portbench.common import emit
from portbench.manifest import (PACKAGE, ROOT, find_cell, load_manifest, load_reader,
                                read_per_layer)
from portbench.reference import dinov2, dinov3
from portbench.reference.common import make_params
from portbench.run import find_runner
from portbench.tests.tiny import tiny_distill_root

SEED = 2**31 + 4242  # beyond 32 signed bits, as a run's seeds may be


# -- runners by kind -------------------------------------------------------------

@pytest.mark.parametrize("kind", ["train", "serve", "distill"])
def test_each_kind_finds_its_runner(kind):
    runner = find_runner(kind)
    assert callable(runner.run) and runner.__file__.endswith(f"drive_{kind}.py")


@pytest.mark.parametrize("kind", ["nope", "../run", "train.py", ""])
def test_an_unknown_kind_names_the_file_looked_for(kind):
    with pytest.raises(LookupError, match="no runner for traffic kind") as err:
        find_runner(kind)
    assert os.path.join(ROOT, PACKAGE, f"drive_{kind}.py") in str(err.value)


def test_a_new_kind_is_a_new_file(tmp_path, monkeypatch):
    import portbench

    (tmp_path / "drive_echo.py").write_text(
        "def run(cell, seed, seconds, trace, device, t_start):\n"
        "    return {'correct': True, 'seed': seed}, {}\n")
    with monkeypatch.context() as m:  # the file as if it were in the benchmark's package
        m.setattr(portbench, "__path__", [*portbench.__path__, str(tmp_path)])
        try:
            result, checks = find_runner("echo").run(None, 7, 1.0, False, "cpu", 0.0)
        finally:
            sys.modules.pop("portbench.drive_echo", None)
            vars(portbench).pop("drive_echo", None)
    assert result == {"correct": True, "seed": 7} and checks == {}
    with pytest.raises(LookupError, match="drive_echo.py"):
        find_runner("echo")  # not in the benchmark's own package


def test_a_runner_that_fails_to_import_says_why(tmp_path, monkeypatch):
    import portbench

    (tmp_path / "drive_broken.py").write_text("import portbench_no_such_module\n")
    monkeypatch.setattr(portbench, "__path__", [*portbench.__path__, str(tmp_path)])
    with pytest.raises(ModuleNotFoundError, match="portbench_no_such_module"):
        find_runner("broken")


def test_the_control_tool_refuses_to_read_limits_off_the_card(monkeypatch, capsys):
    from portbench import control_distill

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert control_distill.main(["--workload", "distill_dinov2.online.b512",
                                 "--seeds", "1"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "needs a CUDA device" in out.err


# -- the teacher families' references -------------------------------------------

def _teacher(family) -> dict:
    return {"img_size": 24, "patch_size": 8, "in_channels": 3, "embed_dim": 32, "num_heads": 2,
            "depth": 2, "mlp_hidden_dim": 128, "num_registers": 4, "layerscale": "ones",
            "num_classes": 10, "rope_base": 100.0,
            "layer_norm_eps": 1e-5 if family is dinov3 else 1e-6}


def test_rope_leaves_cls_and_registers_and_rotates_each_pair_by_its_angle():
    side, d, base, prefix = 3, 8, 100.0, 5
    x = torch.randn(2, 3, prefix + side * side, d, dtype=torch.float64).float()
    cos, sin = dinov3.rope_tables(side, d, base)
    got = dinov3.rope(x, cos, sin, prefix)
    assert torch.equal(got[:, :, :prefix], x[:, :, :prefix])
    for tok in range(side * side):
        row, col = divmod(tok, side)
        for f in range(d // 2):
            axis, k = divmod(f, d // 4)
            coord = ((row if axis == 0 else col) + 0.5) / side * 2 - 1
            angle = 2 * math.pi * coord / base ** (2 * k / (d // 2))
            a, b = x[:, :, prefix + tok, f].double(), x[:, :, prefix + tok, f + d // 2].double()
            c, s = math.cos(angle), math.sin(angle)
            torch.testing.assert_close(got[:, :, prefix + tok, f].double(), a * c - b * s,
                                       rtol=0, atol=1e-6)
            torch.testing.assert_close(got[:, :, prefix + tok, f + d // 2].double(),
                                       b * c + a * s, rtol=0, atol=1e-6)


def test_rope_scores_depend_on_the_offset_between_patches_alone():
    side, d = 4, 8
    cos, sin = dinov3.rope_tables(side, d, 100.0)
    q, k = torch.randn(d), torch.randn(d)

    def score(i, j):
        rq = dinov3.rope(q.expand(1, 1, side * side, d), cos, sin, 0)[0, 0, i]
        rk = dinov3.rope(k.expand(1, 1, side * side, d), cos, sin, 0)[0, 0, j]
        return float(rq @ rk)

    assert score(0, 5) == pytest.approx(score(10, 15), abs=1e-5)  # both one row, one column on
    assert score(0, 5) != pytest.approx(score(0, 6), abs=1e-3)


def _port_teacher(t: dict, variant: str, params: dict, **kw):
    from spectre_tpu_torch.distill.teacher import (DinoClassifier, DinoVisionTransformer,
                                                   freeze)

    bb = DinoVisionTransformer(img_size=t["img_size"], patch_size=t["patch_size"],
                               embed_dim=t["embed_dim"], depth=t["depth"],
                               num_heads=t["num_heads"], num_registers=t["num_registers"],
                               variant=variant, device="cpu", **kw)
    model = freeze(DinoClassifier(bb, t["num_classes"]))
    model.load_state_dict(params, strict=True)
    return model


def _gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got - ref).abs().max() / ref.pow(2).mean().sqrt())


def test_dinov2_reference_is_the_programs_v2_teacher_in_float32():
    t = _teacher(dinov2)
    params = make_params(dinov2.spec(t), 3, "cpu")
    x = dinov2.view(torch.rand(4, 3, 16, 16), t)
    with torch.no_grad():
        got = _port_teacher(t, "v2", params)(x)
    assert _gap(got, dinov2.forward(torch.matmul, params, x, t)) < 1e-5
    for fault in dinov2.FAULTS:  # each fault moves the logits
        assert _gap(dinov2.forward(torch.matmul, params, x, t, fault),
                    dinov2.forward(torch.matmul, params, x, t)) > 1e-2


def test_programs_dinov3_teacher_departs_from_the_family_in_its_rope_and_eps():
    """The open fault (PERF.md, Open questions): the program's v3 teacher
    rotates pairs (2i, 2i+1) by coord / period, x before y, with LayerNorm
    eps 1e-6, where DINOv3 rotates halves (i, i + D/2) by 2 pi coord / period,
    h before w, with eps 1e-5. Given DINOv3's rotation through its own
    ``rope_periods`` (divided by 2 pi), q and k laid out in its pairs, and
    eps 1e-5, the program's teacher is the reference to float32 rounding;
    as it runs, it is not. A program that adopts DINOv3's convention
    updates this test, and the cell ``distill_cifar100.online.b256`` joins
    the benchmark."""
    t = _teacher(dinov3)
    d = t["embed_dim"] // t["num_heads"]
    params = make_params(dinov3.spec(t), 4, "cpu")
    x = dinov3.view(torch.rand(4, 3, 16, 16), t)
    ref = dinov3.forward(torch.matmul, params, x, t)
    with torch.no_grad():
        as_run = _port_teacher(t, "v3", params)(x)
    idx = torch.empty(d, dtype=torch.long)
    for f in range(d // 2):  # the program's pair j holds DINOv3's features (f, f + D/2)
        j = ((f // (d // 4)) ^ 1) * (d // 4) + f % (d // 4)
        idx[2 * j], idx[2 * j + 1] = f, f + d // 2
    laid_out = {k: v[..., idx] if k.endswith(("query.kernel", "query.bias", "key.kernel",
                                               "key.bias")) else v for k, v in params.items()}
    periods = 100.0 ** (torch.arange(d // 4, dtype=torch.float64) * 2 / (d // 2)) / (2 * math.pi)
    model = _port_teacher(t, "v3", laid_out, rope_periods=tuple(periods.tolist()))
    for m in model.modules():
        if isinstance(m, torch.nn.LayerNorm):
            m.eps = t["layer_norm_eps"]
    with torch.no_grad():
        aligned = model(x)
    assert _gap(aligned, ref) < 1e-5
    assert _gap(as_run, ref) > 0.1


@pytest.mark.parametrize("family", [dinov2, dinov3])
def test_teacher_flops_count_every_product(family):
    t = _teacher(family)
    n_p, e, f = 9, 32, 128
    n = n_p + 1 + 4
    want = 2 * n_p * 192 * e + 2 * (4 * 2 * n * e * e + 2 * 2 * n * n * e + 2 * 2 * n * e * f) \
        + 2 * e * 10
    assert family.forward_flops_per_image(t) == want


def test_vits16_forward_is_9_40_gflop_and_vits14_12_46():
    conf = {c: json.load(open(os.path.join(ROOT, PACKAGE, "configs", c + ".json")))["teacher"]
            for c in ("distill_cifar100", "distill_dinov2_cifar100")}
    assert dinov3.forward_flops_per_image(conf["distill_cifar100"]) / 1e9 == \
        pytest.approx(9.396, abs=1e-3)
    assert dinov2.forward_flops_per_image(conf["distill_dinov2_cifar100"]) / 1e9 == \
        pytest.approx(12.455, abs=1e-3)


# -- the distiller's MFU ---------------------------------------------------------

def test_mfu_distill_counts_the_students_step_and_the_teachers_forward(tmp_path):
    from portbench.flops import train_flops_per_step

    root = tiny_distill_root(str(tmp_path))
    cell = find_cell(load_manifest(os.path.join(root, "BENCHMARK.json")), "tiny.distill", root)
    t = cell.config["teacher"]
    record = {"kind": "distill", "model": cell.config["model"], "teacher": t, "batch": 16,
              "steps": 10, "window_s": 2.0, "input_wait_s": 0.1, "issue_s": 0.5}
    got = read_per_layer(cell, record)
    step = train_flops_per_step(cell.config["model"], 16) \
        + 16 * dinov2.forward_flops_per_image(t)
    assert got["mfu.distill"]["value"] == pytest.approx(100 * step * 10 / 2.0 / 989e12)
    assert got["input_wait_ms.distill"]["value"] == pytest.approx(10.0)
    assert got["host_issue_ms.distill"]["value"] == pytest.approx(50.0)
    assert "elementwise_ms.distill" not in got and "idle_pct.distill" not in got  # no trace
    assert read_per_layer(cell, dict(record, kind="train")) == {}


def test_spectre_linear_roofline_distill_counts_the_students_kernel_2_alone():
    from portbench.roofline import spectre_linear_step_s

    read = load_reader(os.path.join(ROOT, PACKAGE, "layer_metrics",
                                    "spectre_linear_roofline.distill.py"))
    m = json.load(open(os.path.join(ROOT, PACKAGE, "configs",
                                    "distill_dinov2_cifar100.json")))["model"]
    kernels = {"void fused_linear_wgmma_kernel<1>()": ["kernel", 0.012, 16],
               "void chain_kernel<1>()": ["kernel", 0.008, 18],
               # the teacher's products and elementwise work are not kernel 2's
               "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT": ["kernel", 0.5, 24],
               "at::native::elementwise_kernel_MulFunctor_": ["pytorch", 0.3, 96]}
    rec = {"kind": "distill", "model": m, "batch": 512, "trace_steps": 2,
           "trace": {"kernels": kernels}}
    assert read(rec) == pytest.approx(100 * spectre_linear_step_s(m, 512) * 2 / 0.02)
    assert read(dict(rec, kind="train")) is None
    assert read({k: v for k, v in rec.items() if k != "trace"}) is None
    rec["trace"] = {"kernels": {k: v for k, v in kernels.items() if "linear" not in k
                                and "chain" not in k}}
    assert read(rec) is None  # no kernel 2 ran: nothing to read, never 0


# -- whole runs of the distillation runner -------------------------------------

def _cell(tmp_path, config="distill_dinov2_cifar100", teacher=None, **model):
    root = tiny_distill_root(str(tmp_path), config, teacher, **model)
    return find_cell(load_manifest(os.path.join(root, "BENCHMARK.json")), "tiny.distill", root)


def _run(cell, trace=False):
    return find_runner("distill").run(cell, SEED, 0.3, trace, torch.device("cpu"),
                                      time.perf_counter())


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_schema(tmp_path, trace):
    cell = _cell(tmp_path)
    result, checks = _run(cell, trace)
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        emit(result, checks)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks" and line["attempted"] > 0
    wanted = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    if trace:
        assert set(line["metrics"]) <= wanted and "mfu.distill" in line["metrics"]
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == wanted == {"train_img_s", "setup_s"}
    assert set(line["checks"]) == set(cell.config["limits"]["distill"]) == {
        "loss", "grad", "update", "grad_err", "teacher_logits", "teacher_err"}


def test_reference_matches_the_programs_plain_path_in_float32(tmp_path):
    """With the program computing in float32, every number reads at
    rounding: the reference makes the same teacher view and logits, draws,
    batches, loss and update as the program's distiller."""
    result, checks = _run(_cell(tmp_path, compute_dtype="float32"))
    assert result["correct"]
    assert max(c["value"] for c in checks.values()) < 1e-5, checks


def test_state_left_unchanged_is_not_correct(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)
    result, checks = _run(_cell(tmp_path, compute_dtype="float32"))
    assert not result["correct"] and not checks["update"]["ok"]


def test_half_the_batch_left_out_is_not_correct(tmp_path, monkeypatch):
    from spectre_tpu_torch.train import step as step_module

    make = step_module.make_distill_step

    def halved(*args, **kw):
        step = make(*args, **kw)
        return lambda state, images, soft, labels: step(
            state, images[: len(images) // 2], soft[: len(soft) // 2], labels[: len(labels) // 2])

    monkeypatch.setattr(step_module, "make_distill_step", halved)
    result, checks = _run(_cell(tmp_path, compute_dtype="float32"))
    assert not result["correct"]


def test_a_teacher_answer_altered_where_it_is_produced_is_not_correct(tmp_path, monkeypatch):
    from spectre_tpu_torch.distill.teacher import DinoClassifier

    forward = DinoClassifier.forward

    def altered(self, x, return_features=False):
        logits = forward(self, x, return_features)
        logits[0, 0] += 1.0  # one logit of the batch's first image
        return logits

    monkeypatch.setattr(DinoClassifier, "forward", altered)
    result, checks = _run(_cell(tmp_path, compute_dtype="float32"))
    assert not result["correct"] and not checks["teacher_logits"]["ok"]


@pytest.mark.parametrize("fault", ["no_pos_embed", "no_registers"])
def test_a_teacher_fault_planted_in_the_program_is_not_correct(tmp_path, monkeypatch, fault):
    """The teacher's position embedding left out, or its registers dropped,
    inside the program's forward."""
    from spectre_tpu_torch.distill.teacher import DinoVisionTransformer

    features = DinoVisionTransformer.forward_features

    def broken(self, x):
        if fault == "no_pos_embed":
            saved = self.pos_embed.data.clone()
            self.pos_embed.data.zero_()
            try:
                return features(self, x)
            finally:
                self.pos_embed.data.copy_(saved)
        tokens = self.register_tokens
        self.num_registers, self.register_tokens = 0, torch.nn.Parameter(tokens[:, :0])
        try:
            out = features(self, x)
        finally:
            self.num_registers, self.register_tokens = tokens.shape[1], tokens
        return out

    monkeypatch.setattr(DinoVisionTransformer, "forward", broken)
    result, checks = _run(_cell(tmp_path, compute_dtype="float32"))
    assert not result["correct"] and not checks["teacher_err"]["ok"]


def test_the_dinov3_configuration_runs_and_reads_the_programs_fault(tmp_path):
    """The DINOv3 configuration runs through the same runner: the program's
    v3 teacher, built from its config, held against the DINOv3 reference.
    Its RoPE departs (the open fault above), so the teacher's numbers read
    far above their limits."""
    cell = _cell(tmp_path, "distill_cifar100", compute_dtype="float32")
    assert cell.config["teacher"]["reference"] == "dinov3"
    result, checks = _run(cell)
    assert not result["correct"] and checks["teacher_err"]["value"] > 0.1


# -- a teacher family is one file and one entry -------------------------------

FAMILY = "dinoreg_tiny"  # a family no file of the benchmark holds
FAMILY_FILES = {
    # DINOv2's reference re-exported under a new name
    "same": "from portbench.reference.dinov2 import *  # noqa: F403\n",
    # the same family with its first MLP projection under another name
    "renamed": ("from portbench.reference.dinov2 import *  # noqa: F403\n"
                "from portbench.reference.dinov2 import spec as _spec\n\n\n"
                "def spec(t):\n"
                "    return [(n.replace('mlp.fc1', 'mlp.w1'), *rest) for n, *rest in _spec(t)]\n"),
}


@pytest.fixture
def new_family(tmp_path, monkeypatch):
    """``add(kind)`` writes ``FAMILY_FILES[kind]`` as the family ``FAMILY``'s
    one file and puts it on the reference package's path, as if it were one
    of its files."""
    import portbench.reference as reference

    folder = tmp_path / "family"
    folder.mkdir()
    monkeypatch.setattr(reference, "__path__", [*reference.__path__, str(folder)])

    def add(kind: str = "same") -> str:
        (folder / f"{FAMILY}.py").write_text(FAMILY_FILES[kind])
        return FAMILY

    yield add
    sys.modules.pop(f"portbench.reference.{FAMILY}", None)
    vars(reference).pop(FAMILY, None)


def test_the_runner_holds_no_table_of_teacher_families():
    from portbench import drive_distill

    source = open(drive_distill.__file__).read()
    assert "dinov2" not in source and "dinov3" not in source and "fc1" not in source


def test_a_new_teacher_family_is_one_file_and_one_config(tmp_path, new_family):
    """A family the runner has never heard of, with the program's variant its
    configuration states, distils through the runner and reads correct at
    float32 rounding."""
    family = new_family()
    cell = _cell(tmp_path / "root", teacher={"reference": family, "variant": "v2"},
                 compute_dtype="float32")
    assert cell.config["teacher"]["reference"] == family
    result, checks = _run(cell)
    assert result["correct"], checks
    assert max(c["value"] for c in checks.values()) < 1e-5, checks


@pytest.mark.parametrize("kind,teacher,match", [
    ("same", {"variant": "v3"}, "teacher variant: program 'v2', benchmark 'v3'"),
    ("same", {"variant": None}, "teacher variant: program 'v2', benchmark None"),
    ("same", {"mlp_hidden_dim": 128}, "size mismatch for backbone.block_0.mlp.fc1.kernel"),
    ("renamed", {}, "Missing key.*block_0.mlp.fc1.kernel"),
])
def test_a_teacher_the_program_builds_otherwise_is_refused(tmp_path, new_family, kind, teacher,
                                                           match):
    """Another variant than the configuration states, another MLP width, or a
    leaf the program names otherwise: the run stops before its first step."""
    family = new_family(kind)
    cell = _cell(tmp_path / "root", teacher={"reference": family, "variant": "v2", **teacher})
    with pytest.raises(RuntimeError, match=match):
        _run(cell)
