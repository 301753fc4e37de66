"""Device-backed serving of the port: the SPQ2/SPQ3 protocol over a torch model.

Speaks the same length-prefixed wire protocol as the JAX package's server
(frames documented in ``serving/client.py``) and mirrors its architecture:

- one thread per connection reads and validates frames (payloads capped at
  1 GiB) and enqueues sample ranges on a shared batcher; requests larger
  than ``max_batch`` are split into chunks and the replies reassembled in
  order;
- ONE batcher thread coalesces samples across concurrent requests up to
  ``max_batch`` (waiting at most ``batch_timeout_s`` for more), pads the
  batch to the next power-of-two bucket, runs the forward under
  ``torch.inference_mode()`` on ``device`` and answers each request with its
  slice. u8 pixels (SPQ3) are upcast and scaled by 1/255 on the device.
- The batcher is a one-deep fetch pipeline, as the JAX server's
  ``_resolve``: it dispatches bucket k+1 before it resolves bucket k. On a
  card, dispatching is the copy of the batch into a pinned staging buffer,
  its host-to-device copy (non-blocking), the forward, and a non-blocking
  copy of the logits into pinned host memory behind a recorded CUDA event;
  resolving waits on the event and slices the replies. So the card runs
  bucket k+1 while the host answers bucket k and coalesces the next.
  While the card still runs the pending bucket, the batcher goes on
  coalescing: bucket k+1 is dispatched once bucket k has completed or
  k+1 is full, so requests that arrive meanwhile join it instead of
  waiting for a bucket of their own. Each bucket shape has two pinned
  staging buffers, used in turn, and a buffer is rewritten only after its
  last host-to-device copy has completed. When the queue is empty the
  pending bucket is resolved at once; ``close()`` resolves it before the
  batcher stops. An error fans out to every request of its batch, and a
  bucket that fails to dispatch resolves the pending one first.

All torch work happens on the batcher thread; connection threads touch only
numpy and sockets.

Several devices (``devices=[...]``, the counterpart of the JAX server's
``mesh``): one replica of the model per device, and every bucket padded to
a multiple of the device count and split into equal slices, one a device.
Each slice is copied to its device and forwarded on that device's current
stream (launches return at once, so the devices run together), its logits
copied back behind an event of their own; resolving waits for every
device's event and joins the slices in order. ``max_batch`` must divide over
the devices, as the JAX server asks of its data axis.
"""

from __future__ import annotations

import contextlib
import copy
import hmac
import os
import queue
import socket
import struct
import threading
from concurrent.futures import Future

import numpy as np
import torch

_MAX_PAYLOAD = 1 << 30  # 1 GiB per request (and per drained bad-dims payload)
_POLL_S = 2e-4  # how often the coalescing batcher asks whether the card is done


def _read_full(sock: socket.socket, n: int) -> bytes | None:
    buf = bytearray()
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except OSError:
            return None
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


def _send_error(sock: socket.socket, msg: str) -> bool:
    try:
        m = msg.encode()
        sock.sendall(b"SPER" + struct.pack("<I", len(m)) + m)
        return True
    except OSError:
        return False


class TorchServer:
    """Serve ``forward(images [B, C, H, W] float32 on device) -> logits
    [B, classes]`` over the SPQ2/SPQ3 protocol with dynamic cross-request
    batching. ``from_config`` builds one from a config the way
    ``repl/serve.py`` does."""

    def __init__(self, forward, input_shape: tuple[int, int, int],
                 device: torch.device | str | None, max_batch: int = 256,
                 batch_timeout_s: float = 0.0, token: str | None = None,
                 devices: list | None = None):
        # one (device, forward) replica per device; ``forward`` is then a
        # sequence of forwards, one per device of ``devices``
        if devices is None:
            self._replicas = [(torch.device(device), forward)]
        else:
            devices = [torch.device(d) for d in devices]
            if len(forward) != len(devices):
                raise ValueError(f"{len(devices)} devices need as many forwards, got "
                                 f"{len(forward)}")
            if max_batch % len(devices):
                raise ValueError(f"max_batch={max_batch} must divide over the "
                                 f"{len(devices)} devices")
            self._replicas = list(zip(devices, forward))
        self.device = self._replicas[0][0]
        self.input_shape = tuple(int(d) for d in input_shape)  # (C, H, W)
        self.max_batch = int(max_batch)
        self.batch_timeout_s = float(batch_timeout_s)
        self._token = token or ""
        self.forwards = 0  # buckets the batcher has run through the model
        # (bucket, wire dtype) -> two [pinned staging buffer, event of its
        # last host-to-device copy], the next to use first
        self._staging: dict[tuple, list] = {}
        self._jobs: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._listener: socket.socket | None = None
        self._threads: list[threading.Thread] = []
        self._uds_path: str | None = None
        self._lock_fd: int | None = None

    # -- lifecycle ---------------------------------------------------------

    def listen_tcp(self, host: str = "127.0.0.1", port: int = 0) -> int:
        if host != "127.0.0.1" and not self._token:
            raise ValueError(
                "binding a non-loopback host requires a token: an exposed "
                "port must not be an open inference endpoint (front it with "
                "TLS across untrusted networks)")
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, port))
        s.listen(64)
        self._listener = s
        self._start_threads()
        return s.getsockname()[1]

    def listen_uds(self, path: str) -> str:
        import fcntl
        import stat

        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        # serialize probe+unlink+bind across concurrently starting servers
        # with a sidecar flock held for the server's lifetime
        self._lock_fd = os.open(path + ".lock", os.O_CREAT | os.O_RDWR, 0o600)
        try:
            fcntl.flock(self._lock_fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            os.close(self._lock_fd)
            self._lock_fd = None
            raise OSError(f"another server is starting/running on {path} "
                          f"(lock {path}.lock)")
        if os.path.exists(path):
            # never delete a non-socket file; unlink only a dead socket
            if not stat.S_ISSOCK(os.stat(path).st_mode):
                raise OSError(f"{path} exists and is not a socket")
            probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                probe.connect(path)
                raise OSError(f"{path} has a live server")
            except (ConnectionRefusedError, FileNotFoundError):
                os.unlink(path)
            finally:
                probe.close()
        s.bind(path)
        s.listen(64)
        self._listener = s
        self._uds_path = path
        self._start_threads()
        return path

    def _start_threads(self):
        t = threading.Thread(target=self._accept_loop, daemon=True)
        b = threading.Thread(target=self._batcher_loop, daemon=True)
        t.start()
        b.start()
        self._threads += [t, b]

    def close(self):
        self._stop.set()
        if self._listener is not None:
            try:  # shutdown wakes the accept() blocked in the accept thread
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._listener.close()
        self._jobs.put(None)  # wake the batcher
        for t in self._threads:
            t.join(timeout=5)
        if self._uds_path and os.path.exists(self._uds_path):
            try:
                os.unlink(self._uds_path)
            except OSError:
                pass
        if self._lock_fd is not None:
            os.close(self._lock_fd)  # releases the flock
            self._lock_fd = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- connection handling -------------------------------------------------

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return  # listener closed
            threading.Thread(target=self._serve_conn, args=(conn,), daemon=True).start()

    def _authenticate(self, conn: socket.socket, magic: bytes) -> bool | None:
        """Handle the optional first SPA1 frame. Returns True when the frame
        was an accepted auth frame, False when it is a request to serve, and
        None when the connection must close."""
        if magic == b"SPA1":
            raw = _read_full(conn, 4)
            if raw is None:
                return None
            (n,) = struct.unpack("<I", raw)
            if n > 4096:
                return None
            got = _read_full(conn, n) if n else b""
            if got is None:
                return None
            if self._token and not hmac.compare_digest(got, self._token.encode()):
                _send_error(conn, "auth failed")
                return None
            try:
                conn.sendall(b"SPOK")
            except OSError:
                return None
            return True
        if self._token:
            _send_error(conn, "auth required")
            return None
        return False

    def _serve_conn(self, conn: socket.socket):
        c, h, w = self.input_shape
        img_elems = c * h * w
        first = True
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass  # UDS has no TCP options
        with conn:
            while not self._stop.is_set():
                magic = _read_full(conn, 4)
                if magic is None:
                    return
                if first:
                    first = False
                    authed = self._authenticate(conn, magic)
                    if authed is None:
                        return
                    if authed:
                        continue
                if magic not in (b"SPQ2", b"SPQ3"):
                    _send_error(conn, "bad magic")
                    return
                dtype = np.uint8 if magic == b"SPQ3" else np.float32
                hdr = _read_full(conn, 16)
                if hdr is None:
                    return
                batch, qc, qh, qw = struct.unpack("<IIII", hdr)
                if (qc, qh, qw) != (c, h, w):
                    # drain the mis-shaped payload so the connection survives
                    # for the next request, but only up to the 1 GiB cap
                    n_bad = dtype().itemsize * batch * qc * qh * qw
                    if n_bad > _MAX_PAYLOAD:
                        _send_error(conn, "bad dims")
                        return
                    if _read_full(conn, n_bad) is None:
                        return
                    if not _send_error(conn, f"input dims ({qc},{qh},{qw}) do not "
                                             f"match model ({c},{h},{w})"):
                        return
                    continue
                if batch == 0 or batch > 1 << 20:
                    _send_error(conn, "bad batch")
                    return
                n_bytes = dtype().itemsize * batch * img_elems
                if n_bytes > _MAX_PAYLOAD:
                    _send_error(conn, "payload too large (1 GiB cap)")
                    return
                payload = _read_full(conn, n_bytes)
                if payload is None:
                    return
                x = np.frombuffer(payload, dtype).reshape(batch, c, h, w)
                futs = []
                for s0 in range(0, batch, self.max_batch):
                    f: Future = Future()
                    self._jobs.put((x[s0:s0 + self.max_batch], f))
                    futs.append(f)
                outs, failed = [], None
                for f in futs:
                    try:
                        outs.append(f.result(timeout=120))
                    except Exception as e:  # noqa: BLE001 -- relayed to the client
                        failed = e
                        break
                if failed is not None:
                    if not _send_error(conn, f"inference failed: {failed}"):
                        return
                    continue
                logits = np.concatenate(outs, axis=0)
                try:
                    conn.sendall(b"SPR1" + struct.pack("<II", *logits.shape)
                                 + np.ascontiguousarray(logits, np.float32).tobytes())
                except OSError:
                    return

    # -- the batcher ---------------------------------------------------------

    @staticmethod
    def _bucket(n: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return b

    def _upload(self, x: np.ndarray, device: torch.device) -> torch.Tensor:
        """``x`` on the card ``device``, copied without blocking from the next
        pinned staging buffer of its bucket, dtype and card. A buffer is
        rewritten only once its previous copy has completed."""
        key = (x.shape, x.dtype.str, device)
        slots = self._staging.get(key)
        if slots is None:
            slots = self._staging[key] = [
                [torch.empty(x.shape, dtype=torch.from_numpy(x).dtype, pin_memory=True), None]
                for _ in range(2)]
        slot = slots.pop(0)
        slots.append(slot)
        buf, copied = slot
        if copied is not None:
            copied.synchronize()
        buf.numpy()[...] = x
        xt = buf.to(device, non_blocking=True)
        slot[1] = torch.cuda.Event()
        slot[1].record()
        return xt

    def _dispatch(self, x: np.ndarray, parts: list):
        """Start one padded bucket on the devices, a slice each: returns
        ``(parts, logits, events)``, the logits float32 in host memory
        (pinned off a card) once every event (none off the card) has
        completed."""
        n = len(self._replicas)
        rows = x.shape[0] // n
        host, events = [], []
        with torch.inference_mode():
            for i, (device, forward) in enumerate(self._replicas):
                xi = x[i * rows:(i + 1) * rows]
                with torch.cuda.device(device) if device.type == "cuda" \
                        else contextlib.nullcontext():
                    xt = self._upload(xi, device) if device.type == "cuda" \
                        else torch.from_numpy(xi).to(device)
                    if xt.dtype == torch.uint8:
                        xt = xt.to(torch.float32) / 255.0
                    logits = forward(xt).float()
                    if device.type == "cuda":
                        out = torch.empty(logits.shape, dtype=torch.float32, pin_memory=True)
                        out.copy_(logits, non_blocking=True)
                        events.append(torch.cuda.Event())
                        events[-1].record()
                        logits = out
                    else:
                        logits = logits.cpu()
                host.append(logits)
        self.forwards += 1
        return parts, host, events

    @staticmethod
    def _running(pending) -> bool:
        """Whether a device still runs the pending bucket."""
        return pending is not None and not all(e.query() for e in pending[2])

    @staticmethod
    def _resolve(pending):
        """Wait for a dispatched bucket's logits and answer its requests (an
        error goes to every one of them)."""
        parts, logits, events = pending
        try:
            for event in events:
                event.synchronize()
            out = np.concatenate([t.numpy() for t in logits])
        except Exception as e:  # noqa: BLE001 -- fanned out to every request
            for _, f in parts:
                f.set_exception(e)
            return
        off = 0
        for part, f in parts:
            n = part.shape[0]
            f.set_result(out[off:off + n])
            off += n

    def _batcher_loop(self):
        c, h, w = self.input_shape
        pending = None  # a bucket dispatched but not yet resolved
        while True:
            try:
                job = self._jobs.get_nowait()
            except queue.Empty:
                if pending is not None:  # nothing to overlap with: answer now
                    self._resolve(pending)
                    pending = None
                job = self._jobs.get()
            if job is None or self._stop.is_set():
                if pending is not None:
                    self._resolve(pending)
                return
            parts = [job]
            total = job[0].shape[0]
            wire = job[0].dtype
            # coalesce whatever else is queued (waiting once for up to
            # batch_timeout_s when set), and what arrives while the card
            # still runs the pending bucket, up to max_batch; only requests
            # of one wire dtype share a batch
            deadline = self.batch_timeout_s or None
            while total < self.max_batch:
                try:
                    nxt = (self._jobs.get(timeout=deadline) if deadline
                           else self._jobs.get_nowait())
                except queue.Empty:
                    deadline = None
                    if not self._running(pending):
                        break
                    try:
                        nxt = self._jobs.get(timeout=_POLL_S)
                    except queue.Empty:
                        continue
                if nxt is None:
                    self._jobs.put(None)  # re-post the stop token
                    break
                if total + nxt[0].shape[0] > self.max_batch or nxt[0].dtype != wire:
                    self._jobs.put(nxt)  # does not fit; next round
                    break
                parts.append(nxt)
                total += nxt[0].shape[0]
                deadline = None
            x = np.concatenate([p[0] for p in parts], axis=0)
            bucket = min(self._bucket(total), self.max_batch)
            n_dev = len(self._replicas)
            if bucket % n_dev:  # a slice for every device
                bucket = min(-(-bucket // n_dev) * n_dev, self.max_batch)
            if bucket > total:
                x = np.concatenate([x, np.zeros((bucket - total, c, h, w), wire)], axis=0)
            try:
                dispatched = self._dispatch(x, parts)
            except Exception as e:  # noqa: BLE001 -- fanned out to every request
                for _, f in parts:
                    f.set_exception(e)
                dispatched = None
            if pending is not None:
                self._resolve(pending)
            pending = dispatched


def restore_for_serving(model: torch.nn.Module, checkpoint: str) -> tuple[int, str]:
    """Load a trainer checkpoint directory's parameters and buffers into
    ``model``: the step with the best recorded metric, else the latest, as
    the JAX server restores. Returns (step, "best" or "latest"); raises when
    the directory holds no checkpoint."""
    from spectre_tpu_torch.models.registry import refresh_mixes
    from spectre_tpu_torch.train.checkpoint import CheckpointManager

    if not os.path.isdir(checkpoint):
        raise FileNotFoundError(f"no checkpoint directory {checkpoint!r}")
    mgr = CheckpointManager(checkpoint)
    step, which = mgr.best_step, "best"
    if step is None or mgr.best_metric not in mgr.metrics(step):
        step, which = mgr.latest_step, "latest"
    step = mgr.restore_model(model, step)  # raises on an empty directory
    refresh_mixes(model)
    return step, which


def from_config(config, device: torch.device | str, weights=None, checkpoint: str | None = None,
                devices: list | None = None, **kw) -> TorchServer:
    """Build a TorchServer for a parsed config: the model on ``device`` with
    the port's own init seeded from ``config.random_seed``; or the weights of
    a flax variable tree (numpy leaves) when ``weights`` is given; or those
    of a trainer checkpoint directory (``train/checkpoint.py``; its best
    step, else its latest) when ``checkpoint`` is given. With ``devices``
    (two or more), a replica of that model on each of them."""
    from spectre_tpu_torch.models import build_model, load_flax_variables
    from spectre_tpu_torch.models.registry import refresh_mixes

    if weights is not None and checkpoint is not None:
        raise ValueError("from_config takes weights or a checkpoint, not both")
    model = build_model(config, device)
    if weights is not None:
        load_flax_variables(model, weights)
    if checkpoint is not None:
        step, which = restore_for_serving(model, checkpoint)
        print(f"restored step {step} ({which}) from {checkpoint}", flush=True)
    shape = (int(config.in_channels), int(config.img_size), int(config.img_size))
    if devices and len(devices) > 1:
        replicas = []
        for d in devices:
            replica = copy.deepcopy(model).to(d)
            refresh_mixes(replica)
            replicas.append(replica)
        return TorchServer(replicas, shape, None, devices=devices, **kw)
    return TorchServer(model, shape, device, **kw)
