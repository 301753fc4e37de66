"""Python client of the SpectreViT serving protocol (the port's copy of
spectre_tpu/serving/client.py::SpectreClient, without the native-daemon
launcher). Length-prefixed frames over TCP or a unix-domain socket:

    request : b"SPQ2" | u32 batch | u32 C | u32 H | u32 W | float32 pixels
              (the explicit dims let the server reject a shape-mismatched
              client instead of mis-framing the stream)
    request : b"SPQ3" | u32 batch | u32 C | u32 H | u32 W | uint8 pixels
              (raw 0-255 pixels at 1/4 the bytes; the server upcasts and
              scales by 1/255 on the device. Use ``infer_u8``.)
    auth    : b"SPA1" | u32 len | token bytes (first frame; server replies
              b"SPOK" -- required when the server has a token configured)
    response: b"SPR1" | u32 batch | u32 classes | float32 logits
    error   : b"SPER" | u32 len | message

Usage:

    with SpectreClient(port=port) as client:
        logits = client.infer(images)               # [B, C, H, W] float32
"""

from __future__ import annotations

import socket
import struct

import numpy as np


class SpectreClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 uds: str | None = None, token: str | None = None):
        """Connect over TCP (host/port) or a unix-domain socket (``uds``).

        ``token``: shared secret for token-gated servers, sent once as the
        connection's first frame; the server replies SPOK or refuses."""
        if uds is not None:
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._sock.connect(uds)
        else:
            self._sock = socket.create_connection((host, port))
            self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if token is not None:
            t = token.encode()
            self._sock.sendall(b"SPA1" + struct.pack("<I", len(t)) + t)
            head = self._recv(4)
            if head == b"SPER":
                (n,) = struct.unpack("<I", self._recv(4))
                msg = self._recv(n).decode()
                self._sock.close()
                raise PermissionError(f"server refused auth: {msg}")
            if head != b"SPOK":
                self._sock.close()
                raise RuntimeError(f"bad auth response magic {head!r}")

    def infer(self, images: np.ndarray) -> np.ndarray:
        """images: [B, C, H, W] float32 (normalized to [0, 1]) -> logits
        [B, num_classes]."""
        return self._request(images, np.float32, b"SPQ2")

    def infer_u8(self, images: np.ndarray) -> np.ndarray:
        """images: [B, C, H, W] uint8 raw pixels (0-255) -> logits; the
        server computes ``x / 255`` on the device."""
        return self._request(images, np.uint8, b"SPQ3")

    def _request(self, images: np.ndarray, dtype, magic: bytes) -> np.ndarray:
        x = np.ascontiguousarray(images, dtype=dtype)
        if x.ndim != 4:
            raise ValueError(f"images must be [B, C, H, W]; got {x.shape}")
        batch, c, h, w = x.shape
        self._sock.sendall(magic + struct.pack("<IIII", batch, c, h, w) + x.tobytes())
        head = self._recv(4)
        if head == b"SPER":
            (n,) = struct.unpack("<I", self._recv(4))
            raise RuntimeError(f"server error: {self._recv(n).decode()}")
        if head != b"SPR1":
            raise RuntimeError(f"bad response magic {head!r}")
        got_batch, classes = struct.unpack("<II", self._recv(8))
        payload = self._recv(4 * got_batch * classes)
        return np.frombuffer(payload, np.float32).reshape(got_batch, classes)

    def _recv(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("server closed connection")
            buf += chunk
        return bytes(buf)

    def close(self):
        self._sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
