"""The port's study, submission and reproduction CLIs and the JAX package's
four ``repl/perf.py`` sweeps, each on ``--device cpu`` at a tiny size: the
rows they print (the JAX package's), the kernels each sweep routes to, the
files they write, and the deterministic numbers the figure CLIs print
against the JAX CLIs' output."""

import os
import re

import pytest

from spectre_tpu.repl import dwt_experiments as jax_dwt
from spectre_tpu.repl import fft_experiments as jax_fft
from spectre_tpu_torch.repl import (
    dataset_spectre,
    dwt_experiments,
    fft_approx,
    fft_experiments,
    mnist_submission,
    orthogonal_permut,
    perf,
    reproduce,
)

TINY = ["--device", "cpu", "--batch", "2", "--embed-dim", "16", "--warmup", "1", "--iters", "2"]


def test_perf_latency_prints_the_jax_rows(capsys):
    res = perf.main(["latency", *TINY, "--use-pallas"])
    out = capsys.readouterr().out
    assert "--use-pallas has no effect" in out
    rows = re.findall(r"^  patch=(\d) heads=(\d): [\d.]+ ms/iter \(\d+ img/s\)$", out, re.M)
    assert rows == [(p, h) for p in "48" for h in "1248"]
    assert [(r["patch"], r["heads"]) for r in res["latency"]] == [
        (p, h) for p in (4, 8) for h in (1, 2, 4, 8)]


def test_perf_linear_routes_to_the_float32_and_wide_kernels(capsys):
    res = perf.main(["linear", *TINY])
    out = capsys.readouterr().out
    dims = re.findall(r"^  dim=(\d+): spectre .* \(([\d,]+) params\) \| dense .* \(([\d,]+) "
                      r"params\)$", out, re.M)
    assert [int(d) for d, _, _ in dims] == [256, 512, 1024, 2048, 4096]
    for d, n_sl, n_d in dims:
        d = int(d)
        assert int(n_sl.replace(",", "")) == d * d + 3 * d  # kernel, bias, LN scale and bias
        assert int(n_d.replace(",", "")) == d * d + d
    assert [r["kernel"] for r in res["linear"]] == ["fused_spectre_linear_cluster"] * 5


def test_perf_mixer_runs_the_kernel_at_every_d(capsys):
    res = perf.main(["mixer", *TINY, "--max-pow", "9"])
    out = capsys.readouterr().out
    assert "fallback" not in out
    assert [r["d"] for r in res["mixer"]] == [64, 128, 256, 512]
    for line in out.splitlines()[2:]:
        assert re.match(r"^  d=\d+: gather .* \| structured .* \| fft2 .* \| "
                        r"structured-kernel\(plain on cpu\) ", line), line
    assert all(r["structured_kernel_ms"] > 0 for r in res["mixer"])


def test_perf_encoder_profiles_one_layer(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    res = perf.main(["encoder", *TINY])
    assert "wrote plots/encoder_layer.csv" in capsys.readouterr().out
    text = (tmp_path / "plots" / "encoder_layer.csv").read_text().splitlines()
    assert text[0] == "name,calls,host_total_ms,device_total_ms,avg_device_ms,device_pct"
    assert 1 < len(text) <= 26 and len(res["encoder"]) == len(text) - 1
    assert any(r["name"] == "aten::layer_norm" for r in res["encoder"])


def test_fft_approx(capsys):
    rows = fft_approx.main(["--dim", "32", "--steps", "30", "--batch", "32", "--iters", "2",
                            "--device", "cpu"])
    out = capsys.readouterr().out
    assert "final mse" in out and "rfft" in out and "dft-matmul" in out
    assert [r["dim"] for r in rows] == [256, 512, 1000, 1024, 3000, 4096]


def test_mnist_submission(tmp_path):
    out, grid = tmp_path / "submission.csv", tmp_path / "grid.png"
    sub = mnist_submission.main([
        "--synthetic", "--steps", "2", "--out", str(out), "--grid", str(grid), "--device", "cpu",
        "--set", "batch_size=16", "val_batch_size=64", "epochs=1", "num_encoders=1",
        "embed_dim=16", "hidden_dim=32"])
    lines = out.read_text().strip().splitlines()
    assert lines[0] == "ImageId,Label" and grid.exists()
    assert len(lines) - 1 == len(sub.images) == 1024  # the synthetic submission split
    assert lines[1:3] == [f"1,{sub.labels[0]}", f"2,{sub.labels[1]}"]
    assert tuple(sub.logits.shape) == (1024, 10) and not sub.model.training


def test_reproduce_side_b_and_side_a_refused_by_name(monkeypatch, capsys):
    common = ["--config", os.path.join("spectre_tpu_torch", "configs", "spectre_vit_mnist.py"),
              "--synthetic", "--steps", "3", "--device", "cpu", "--set", "num_encoders=1",
              "batch_size=16", "val_batch_size=256", "mix_block=8"]
    root = os.path.join(os.path.dirname(__file__), "..")
    monkeypatch.chdir(root)
    report = reproduce.main([*common, "--skip-torch"])
    assert 0.0 <= report["port_top1"] <= 1.0 and report["port_img_per_sec"] > 0
    assert "port_top1_uniform" in report and report["port_mix_block"] == 8
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith('{"config"')
    monkeypatch.delenv("SPECTRE_REFERENCE_ROOT", raising=False)
    with pytest.raises(FileNotFoundError, match="side A"):
        reproduce.main([*common, "--no-uniform-leg"])


def test_orthogonal_permut(tmp_path):
    rows = orthogonal_permut.main(["--max-pow", "8", "--out", str(tmp_path), "--warmup", "1",
                                   "--iters", "2", "--device", "cpu"])
    assert [r["d"] for r in rows] == [64, 128, 256]
    assert (tmp_path / "spectremix_h4.png").exists()
    assert list((tmp_path / "mix_trace").glob("*.pt.trace.json"))


def _printed(fn, capsys) -> str:
    fn()
    return capsys.readouterr().out


def test_fft_experiments_print_what_jax_prints(tmp_path, capsys):
    out = _printed(lambda: fft_experiments.main(["--out", str(tmp_path / "p"), "--device",
                                                 "cpu"]), capsys)
    want = _printed(lambda: jax_fft.main(["--out", str(tmp_path / "j")]), capsys)
    for f in ["sine_fft.png", "token_example.png", "hadamard_image.png", "shifted_sigmoid.png"]:
        assert (tmp_path / "p" / f).exists()
    keep = ("top-5", "rfft2", "  rfft2", "  fft2")
    assert [ln for ln in out.splitlines() if ln.startswith(keep)] == [
        ln for ln in want.splitlines() if ln.startswith(keep)]
    assert "(2, 3, 16, 9)" in out


@pytest.mark.parametrize("levels", [2, 3])
def test_dwt_experiments_reconstruct_as_jax(tmp_path, capsys, levels):
    err = dwt_experiments.main(["--out", str(tmp_path / "p"), "--levels", str(levels),
                                "--device", "cpu"])
    out = capsys.readouterr().out
    jax_dwt.main(["--out", str(tmp_path / "j"), "--levels", str(levels)])
    want = capsys.readouterr().out
    assert err < 1e-5
    line = [ln for ln in out.splitlines() if ln.startswith("perfect reconstruction")]
    assert line == [ln for ln in want.splitlines() if ln.startswith("perfect reconstruction")]
    assert (tmp_path / "p" / "dwt_subbands.png").exists()
    assert (tmp_path / "p" / "dwt_vs_fft.png").exists()


def test_dataset_spectre_on_synthetic_images(tmp_path, capsys):
    share = dataset_spectre.main(["--out", str(tmp_path), "--limit", "4", "--device", "cpu"])
    assert (tmp_path / "dataset_spectrum.png").exists()
    assert "analyzed 4 images" in capsys.readouterr().out and 0.0 < share <= 1.0


def test_cuda_entry_points_refuse_without_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (fft_approx.main, fft_experiments.main, dwt_experiments.main,
                 dataset_spectre.main, orthogonal_permut.main, mnist_submission.main,
                 reproduce.main, lambda argv: perf.main(["mixer", *argv])):
        with pytest.raises(RuntimeError, match="is_available"):
            main([])

