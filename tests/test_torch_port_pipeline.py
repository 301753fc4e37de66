"""The port server's one-deep fetch pipeline
(spectre_tpu_torch/serving/torch_server.py, the counterpart of the JAX
server's ``_resolve``) on the CPU.

- The batcher dispatches bucket k+1 before it resolves bucket k, and resolves
  at once when the queue runs dry.
- While the card still runs the pending bucket, requests that arrive join
  the next bucket, which is dispatched once the pending one completes.
- Concurrent clients' replies equal forwards of each request alone, within
  1e-5 (float32; a row's sums may be ordered differently in a larger batch).
- An error fans out to every request of its batch and to no other; a
  bucket that fails to dispatch resolves the pending one before the next
  dispatch, so its staging buffer is not reused under a pending copy.
- ``close()`` resolves a pending batch before the batcher stops.
"""

import threading
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from conftest import tiny_export_cfg
from spectre_tpu_torch.models import build_model
from spectre_tpu_torch.serving import SpectreClient, TorchServer

ATOL = 1e-5


def _rand(b, seed):
    return np.random.default_rng(seed).uniform(0, 1, (b, 3, 8, 8)).astype(np.float32)


class _Logged(TorchServer):
    """Records the order of dispatches and resolves, by the first value of
    each bucket's first request."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.log = []

    def _dispatch(self, x, parts):
        self.log.append(("dispatch", int(parts[0][0][0, 0, 0, 0])))
        return super()._dispatch(x, parts)

    def _resolve(self, pending):
        self.log.append(("resolve", int(pending[0][0][0][0, 0, 0, 0])))
        return TorchServer._resolve(pending)


def _tagged(tag, b=2):
    x = np.zeros((b, 3, 8, 8), np.float32)
    x[0, 0, 0, 0] = tag
    return x


def _batcher(srv):
    t = threading.Thread(target=srv._batcher_loop, daemon=True)
    t.start()
    return t


def test_each_bucket_is_resolved_after_the_next_is_dispatched():
    srv = _Logged(lambda x: x.reshape(x.shape[0], -1)[:, :4], (3, 8, 8), "cpu", max_batch=2)
    futs = []
    for tag in (1, 2, 3):
        f = Future()
        srv._jobs.put((_tagged(tag), f))
        futs.append(f)
    t = _batcher(srv)
    for tag, f in zip((1, 2, 3), futs):
        assert f.result(timeout=30)[0, 0] == tag
    srv._jobs.put(None)
    t.join(timeout=30)
    assert srv.log == [("dispatch", 1), ("dispatch", 2), ("resolve", 1), ("dispatch", 3),
                       ("resolve", 2), ("resolve", 3)]
    assert srv.forwards == 3


class _GatedEvent:
    """Stands in for a bucket's CUDA event: the bucket runs until ``gate``."""

    def __init__(self, gate):
        self.gate = gate

    def query(self):
        return self.gate.is_set()

    def synchronize(self):
        assert self.gate.wait(30)


def test_requests_arriving_while_the_card_runs_join_the_next_bucket():
    entered, issued, gate, sizes = threading.Event(), threading.Event(), threading.Event(), []

    def forward(x):
        sizes.append(x.shape[0])
        entered.set()
        assert issued.wait(30)  # the host issuing the first bucket
        return x.reshape(x.shape[0], -1)[:, :4]

    class Busy(TorchServer):
        def _dispatch(self, x, parts):
            parts, logits, _ = super()._dispatch(x, parts)
            return parts, logits, [_GatedEvent(gate)]  # one event per device

    srv = Busy(forward, (3, 8, 8), "cpu", max_batch=8)
    t = _batcher(srv)
    futs = [Future() for _ in range(4)]
    srv._jobs.put((_tagged(1, b=1), futs[0]))
    assert entered.wait(30)
    srv._jobs.put((_tagged(2, b=1), futs[1]))  # queued while the first is issued
    issued.set()  # the first bucket now runs on the "card"
    for tag, f in zip((3, 4), futs[2:]):
        threading.Event().wait(0.05)  # each arrives on its own
        srv._jobs.put((_tagged(tag, b=1), f))
    threading.Event().wait(0.05)
    assert sizes == [1] and not futs[0].done()
    gate.set()
    for tag, f in zip((1, 2, 3, 4), futs):
        assert f.result(timeout=30)[0, 0] == tag
    srv._jobs.put(None)
    t.join(timeout=30)
    assert sizes == [1, 4] and srv.forwards == 2  # three requests, one bucket of 4


def test_concurrent_clients_get_what_each_request_alone_gives():
    cfg = tiny_export_cfg(mix_impl="folded", mix_block=8)
    model = build_model(cfg, "cpu")
    srv = TorchServer(model, (3, 8, 8), "cpu", max_batch=8)
    port = srv.listen_tcp()
    errs, got = [], {}

    def worker(i):
        try:
            with SpectreClient(port=port) as c:
                for j in range(4):
                    x = _rand(1 + (i + j) % 3, seed=10 * i + j)
                    got[(i, j)] = (x, c.infer(x))
        except Exception as e:  # noqa: BLE001 -- collected and asserted below
            errs.append((i, e))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        srv.close()
    assert not errs, errs
    assert len(got) == 24
    for x, reply in got.values():
        with torch.no_grad():
            want = model(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(reply, want, atol=ATOL, rtol=0)


def test_an_error_fans_out_to_its_whole_batch_only():
    def forward(x):
        if (x[:, 0, 0, 0] == 9).any():
            raise RuntimeError("bad bucket")
        return x.reshape(x.shape[0], -1)[:, :4]

    srv = TorchServer(forward, (3, 8, 8), "cpu", max_batch=4)
    jobs = [(_tagged(9), Future()), (_tagged(1), Future()), (_tagged(2, b=3), Future())]
    for j in jobs:
        srv._jobs.put(j)
    t = _batcher(srv)
    for _, f in jobs[:2]:  # one bucket of 4 rows, its forward raises
        with pytest.raises(RuntimeError, match="bad bucket"):
            f.result(timeout=30)
    assert jobs[2][1].result(timeout=30)[0, 0] == 2
    srv._jobs.put(None)
    t.join(timeout=30)


def test_a_failed_dispatch_resolves_the_pending_bucket_before_the_next():
    def forward(x):
        if (x[:, 0, 0, 0] == 9).any():
            raise RuntimeError("bad bucket")
        return x.reshape(x.shape[0], -1)[:, :4]

    srv = _Logged(forward, (3, 8, 8), "cpu", max_batch=2)
    jobs = [(_tagged(tag), Future()) for tag in (1, 9, 2)]  # three buckets of one shape
    for j in jobs:
        srv._jobs.put(j)
    t = _batcher(srv)
    assert jobs[0][1].result(timeout=30)[0, 0] == 1
    with pytest.raises(RuntimeError, match="bad bucket"):
        jobs[1][1].result(timeout=30)
    assert jobs[2][1].result(timeout=30)[0, 0] == 2
    srv._jobs.put(None)
    t.join(timeout=30)
    assert srv.log == [("dispatch", 1), ("dispatch", 9), ("resolve", 1), ("dispatch", 2),
                       ("resolve", 2)]


def test_close_resolves_the_pending_batch():
    entered, gate = threading.Event(), threading.Event()

    def forward(x):
        entered.set()
        gate.wait(30)
        return x.reshape(x.shape[0], -1)[:, :4]

    srv = _Logged(forward, (3, 8, 8), "cpu", max_batch=2)
    srv.listen_tcp()
    first, second = Future(), Future()
    srv._jobs.put((_tagged(1), first))
    srv._jobs.put((_tagged(2), second))  # queued behind the forward of the first
    assert entered.wait(30)  # the first bucket is being dispatched
    threading.Timer(0.5, gate.set).start()
    srv.close()  # stops while the first bucket is dispatched and pending
    assert first.result(timeout=1)[0, 0] == 1
    assert ("resolve", 1) in srv.log
    assert not second.done()  # never dispatched: the batcher stopped
