"""Client side of the out-of-process store node's wire.

Counterpart of ``fluidframework_tpu/service/store_server.py``, of which only
the framing helpers and the :class:`_Conn` client socket are ported: the
historian's :class:`~fluidframework_tpu_torch.service.historian.RemoteCache`
talks to a store node's cache through them. The store node itself
(``StoreServer``) and its ``RemoteBlobBackend`` / ``RemotePartitionedLog``
adapters are not ported yet; they come with the network server, a later
slice of the port (see ROADMAP.md).

Protocol: one JSON line per request/response, binary bodies
length-prefixed after the header — trivial to implement from any
language, framing errors fail loudly.
"""

from __future__ import annotations

import json
import socket
import threading
from typing import Tuple

# ---------------------------------------------------------------------------
# Framing: header line (JSON + "\n"), then `blen` raw bytes when present.


def _send_msg(sock: socket.socket, head: dict, body: bytes = b"") -> None:
    head = dict(head)
    head["blen"] = len(body)
    sock.sendall(json.dumps(head).encode() + b"\n" + body)


def _parse_msg(line: bytes, f) -> Tuple[dict, bytes]:
    head = json.loads(line)
    body = f.read(head.get("blen", 0)) if head.get("blen") else b""
    return head, body


def _recv_msg(f) -> Tuple[dict, bytes]:
    line = f.readline()
    if not line:
        raise ConnectionError("peer closed")
    return _parse_msg(line, f)


# ---------------------------------------------------------------------------
# Client adapters


class _Conn:
    """One socket, request/response in lockstep (thread-safe)."""

    def __init__(self, host: str, port: int):
        self._sock = socket.create_connection((host, port), timeout=30)
        self._f = self._sock.makefile("rb")
        self._lock = threading.Lock()

    def call(self, head: dict, body: bytes = b"") -> Tuple[dict, bytes]:
        with self._lock:
            _send_msg(self._sock, head, body)
            resp, rbody = _recv_msg(self._f)
        if not resp.get("ok"):
            raise RuntimeError(f"store node error: {resp.get('error')}")
        return resp, rbody
