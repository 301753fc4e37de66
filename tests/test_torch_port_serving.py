"""The port's server (spectre_tpu_torch/serving/torch_server.py) on the CPU:
the same wire protocol as the JAX server, answered by the port's model with
JAX-initialised weights, checked against JAX ``model.apply``."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_export_cfg
from spectre_tpu.models import build_model as jax_build_model
from spectre_tpu_torch.models import save_npz
from spectre_tpu_torch.repl import serve
from spectre_tpu_torch.serving import SpectreClient, TorchServer, from_config

ATOL = 1e-4  # f32 on both sides; summation order differs


@pytest.fixture(scope="module")
def served():
    """(server, port, jax apply) for a tiny flagship topology, max_batch 8."""
    cfg = tiny_export_cfg(mix_impl="folded", mix_block=8)
    jm = jax_build_model(cfg)
    v = jm.init(jax.random.key(0), jnp.zeros((1, 3, 8, 8)))
    srv = from_config(cfg, "cpu", weights=jax.tree.map(np.asarray, v), max_batch=8)
    port = srv.listen_tcp()
    apply = jax.jit(jm.apply)
    yield srv, port, lambda x: np.asarray(apply(v, jnp.asarray(x)))
    srv.close()


def _rand(b, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (b, 3, 8, 8)).astype(np.float32)


def test_spq2_matches_jax_at_every_bucket(served):
    _, port, jax_apply = served
    with SpectreClient(port=port) as c:
        for b in (1, 3, 8):
            x = _rand(b, seed=b)
            got = c.infer(x)
            assert got.shape == (b, 10)
            np.testing.assert_allclose(got, jax_apply(x), atol=ATOL, rtol=0)


def test_spq3_u8_is_scaled_on_the_device(served):
    _, port, jax_apply = served
    x8 = np.random.default_rng(4).integers(0, 256, (5, 3, 8, 8), dtype=np.uint8)
    with SpectreClient(port=port) as c:
        got = c.infer_u8(x8)
    np.testing.assert_allclose(got, jax_apply(x8.astype(np.float32) / 255.0),
                               atol=ATOL, rtol=0)


def test_oversized_request_is_split_and_reassembled(served):
    _, port, jax_apply = served
    x = _rand(21, seed=3)
    with SpectreClient(port=port) as c:
        got = c.infer(x)
    assert got.shape == (21, 10)
    np.testing.assert_allclose(got, jax_apply(x), atol=ATOL, rtol=0)


def test_concurrent_clients_get_their_own_rows(served):
    _, port, jax_apply = served
    errs = []

    def worker(i):
        try:
            x = _rand(2, seed=100 + i)
            want = jax_apply(x)
            with SpectreClient(port=port) as c:
                for _ in range(3):
                    np.testing.assert_allclose(c.infer(x), want, atol=ATOL, rtol=0)
        except Exception as e:  # noqa: BLE001 -- collected and asserted below
            errs.append((i, e))

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    assert not errs, errs


def test_bad_dims_are_rejected_and_the_connection_survives(served):
    _, port, jax_apply = served
    with SpectreClient(port=port) as c:
        with pytest.raises(RuntimeError, match="do not match"):
            c.infer(np.zeros((2, 3, 16, 16), np.float32))
        x = _rand(2, seed=9)
        np.testing.assert_allclose(c.infer(x), jax_apply(x), atol=ATOL, rtol=0)


def test_token_auth_and_loopback_stance():
    model = torch.nn.Sequential(torch.nn.Flatten(), torch.nn.Linear(3 * 8 * 8, 10))
    with TorchServer(model, (3, 8, 8), "cpu", max_batch=8, token="pt-secret") as srv:
        port = srv.listen_tcp()
        x = _rand(2)
        with SpectreClient(port=port, token="pt-secret") as c:
            assert c.infer(x).shape == (2, 10)
        with pytest.raises(PermissionError):
            SpectreClient(port=port, token="nope")
        with pytest.raises((RuntimeError, ConnectionError)):
            with SpectreClient(port=port) as c:  # no auth frame
                c.infer(x)
    with pytest.raises(ValueError, match="requires a token"):
        TorchServer(model, (3, 8, 8), "cpu").listen_tcp(host="0.0.0.0")


def test_serve_cli_loads_npz_weights_and_serves_over_uds(served, tmp_path):
    """The CLI's start path (--ckpt .npz, --device cpu, --uds) answers like
    the in-process server; --device cuda refuses without a CUDA device."""
    _, _, jax_apply = served
    cfg = tiny_export_cfg(mix_impl="folded", mix_block=8)
    jm = jax_build_model(cfg)
    v = jax.tree.map(np.asarray, jm.init(jax.random.key(0), jnp.zeros((1, 3, 8, 8))))
    ckpt = str(tmp_path / "w.npz")
    save_npz(ckpt, v)
    cfg_path = tmp_path / "tiny.py"
    cfg_path.write_text("".join(f"{k} = {val!r}\n" for k, val in vars(cfg).items()))
    sock = str(tmp_path / "s.sock")
    srv, addr = serve.start(["--config", str(cfg_path), "--ckpt", ckpt, "--device", "cpu",
                             "--uds", sock, "--max-batch", "8"])
    try:
        x = _rand(3, seed=12)
        with SpectreClient(uds=addr) as c:
            np.testing.assert_allclose(c.infer(x), jax_apply(x), atol=ATOL, rtol=0)
    finally:
        srv.close()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            serve.start(["--config", str(cfg_path), "--device", "cuda", "--port", "0"])
