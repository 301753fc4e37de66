"""The frames of the serving protocol's u8 request and its reply, a frozen
copy of the program's client (``serving/client.py``):

    request : b"SPQ3" | u32 batch | u32 C | u32 H | u32 W | uint8 pixels
    response: b"SPR1" | u32 batch | u32 classes | float32 logits
    error   : b"SPER" | u32 len | message

Numpy and the standard library only: the client processes import nothing
else.
"""

from __future__ import annotations

import socket
import struct

import numpy as np


def request_frame(images: np.ndarray) -> bytes:
    x = np.ascontiguousarray(images, dtype=np.uint8)
    if x.ndim != 4:
        raise ValueError(f"images must be [B, C, H, W]; got {x.shape}")
    return b"SPQ3" + struct.pack("<IIII", *x.shape) + x.tobytes()


def _recv(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("server closed connection")
        buf += chunk
    return bytes(buf)


def read_reply(sock: socket.socket) -> np.ndarray:
    """The logits [batch, classes] of one reply; raises on an error frame."""
    head = _recv(sock, 4)
    if head == b"SPER":
        (n,) = struct.unpack("<I", _recv(sock, 4))
        raise RuntimeError(f"server error: {_recv(sock, n).decode()}")
    if head != b"SPR1":
        raise RuntimeError(f"bad response magic {head!r}")
    batch, classes = struct.unpack("<II", _recv(sock, 8))
    return np.frombuffer(_recv(sock, 4 * batch * classes), np.float32).reshape(batch, classes)


def connect(port: int) -> socket.socket:
    sock = socket.create_connection(("127.0.0.1", port))
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return sock
