"""Minimal sans-IO WebSocket (RFC 6455) — handshake + framing.

The reference's live op channel is socket.io over WebSocket
(``packages/drivers/driver-base/src/documentDeltaConnection.ts``,
``server/routerlicious/packages/services-shared/src/socketIoServer.ts``).
This module provides the wire layer for the network front door and driver
with zero external dependencies: HTTP upgrade handshake, frame
encode, and an incremental frame decoder usable from both asyncio (server)
and blocking sockets (client driver).

Only what the op channel needs is implemented: text/binary/ping/pong/close
frames, client-side masking, 7/16/64-bit lengths. No extensions, no
fragmentation re-assembly beyond continuation frames.

Counterpart of ``fluidframework_tpu/service/wsproto.py``, copied unchanged:
handshake keys and client masks come from ``os.urandom``.
"""

from __future__ import annotations

import base64
import hashlib
import os
import struct
from typing import List, Optional, Tuple

GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT = 0x0
OP_TEXT = 0x1
OP_BINARY = 0x2
OP_CLOSE = 0x8
OP_PING = 0x9
OP_PONG = 0xA


def accept_key(client_key: str) -> str:
    digest = hashlib.sha1((client_key + GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def client_handshake(host: str, path: str) -> Tuple[bytes, str]:
    """Returns (request bytes, expected Sec-WebSocket-Accept value)."""
    key = base64.b64encode(os.urandom(16)).decode()
    req = (
        f"GET {path} HTTP/1.1\r\n"
        f"Host: {host}\r\n"
        "Upgrade: websocket\r\n"
        "Connection: Upgrade\r\n"
        f"Sec-WebSocket-Key: {key}\r\n"
        "Sec-WebSocket-Version: 13\r\n"
        "\r\n"
    ).encode()
    return req, accept_key(key)


def server_handshake_response(headers: dict) -> bytes:
    key = headers.get("sec-websocket-key")
    if not key:
        raise ValueError("missing Sec-WebSocket-Key")
    return (
        "HTTP/1.1 101 Switching Protocols\r\n"
        "Upgrade: websocket\r\n"
        "Connection: Upgrade\r\n"
        f"Sec-WebSocket-Accept: {accept_key(key)}\r\n"
        "\r\n"
    ).encode()


def encode_frame(opcode: int, payload: bytes, mask: bool = False) -> bytes:
    """One complete (FIN) frame. Clients MUST mask (RFC 6455 §5.3)."""
    head = bytearray([0x80 | opcode])
    n = len(payload)
    mask_bit = 0x80 if mask else 0
    if n < 126:
        head.append(mask_bit | n)
    elif n < 1 << 16:
        head.append(mask_bit | 126)
        head += struct.pack(">H", n)
    else:
        head.append(mask_bit | 127)
        head += struct.pack(">Q", n)
    if mask:
        key = os.urandom(4)
        head += key
        payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
    return bytes(head) + payload


# Reference caps the op channel at 16KB messages (routerlicious
# config.json:55 maxMessageSize); 16MB here leaves room for snapshot blobs
# while bounding what one peer can make the server buffer.
MAX_FRAME_BYTES = 16 << 20


class FrameDecoder:
    """Incremental decoder: feed bytes, pop (opcode, payload) frames.
    Continuation frames are merged into their initial frame. Declared frame
    lengths (and the merged message size) are capped at ``max_bytes`` so a
    hostile peer cannot make us buffer unboundedly."""

    def __init__(self, max_bytes: int = MAX_FRAME_BYTES) -> None:
        self._buf = bytearray()
        self._partial: Optional[Tuple[int, bytearray]] = None
        self.max_bytes = max_bytes

    def feed(self, data: bytes) -> List[Tuple[int, bytes]]:
        self._buf += data
        out: List[Tuple[int, bytes]] = []
        while True:
            frame = self._try_parse()
            if frame is None:
                # Cap the UNPARSEABLE remainder only — a full legal frame
                # plus the coalesced start of the next one may transiently
                # exceed max_bytes before the drain above consumes it.
                if len(self._buf) > self.max_bytes + 14:  # payload + header
                    raise ValueError("frame buffer overflow")
                return out
            fin, opcode, payload = frame
            if opcode == OP_CONT:
                if self._partial is None:
                    raise ValueError("continuation without initial frame")
                if len(self._partial[1]) + len(payload) > self.max_bytes:
                    raise ValueError("fragmented message exceeds cap")
                self._partial[1].extend(payload)
                if fin:
                    op0, acc = self._partial
                    self._partial = None
                    out.append((op0, bytes(acc)))
            elif fin:
                out.append((opcode, payload))
            else:
                self._partial = (opcode, bytearray(payload))

    def _try_parse(self):
        buf = self._buf
        if len(buf) < 2:
            return None
        fin = bool(buf[0] & 0x80)
        opcode = buf[0] & 0x0F
        masked = bool(buf[1] & 0x80)
        n = buf[1] & 0x7F
        pos = 2
        if n == 126:
            if len(buf) < pos + 2:
                return None
            n = struct.unpack_from(">H", buf, pos)[0]
            pos += 2
        elif n == 127:
            if len(buf) < pos + 8:
                return None
            n = struct.unpack_from(">Q", buf, pos)[0]
            pos += 8
        if n > self.max_bytes:
            raise ValueError(f"declared frame length {n} exceeds cap")
        key = None
        if masked:
            if len(buf) < pos + 4:
                return None
            key = bytes(buf[pos : pos + 4])
            pos += 4
        if len(buf) < pos + n:
            return None
        payload = bytes(buf[pos : pos + n])
        if key is not None:
            payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
        del buf[: pos + n]
        return fin, opcode, payload


def read_http_head(data: bytes) -> Optional[Tuple[bytes, dict, bytes]]:
    """Split an HTTP message into (request/status line, headers, rest) once
    the blank line has arrived; None if incomplete."""
    end = data.find(b"\r\n\r\n")
    if end < 0:
        return None
    head = data[:end].split(b"\r\n")
    headers = {}
    for line in head[1:]:
        k, _, v = line.partition(b":")
        headers[k.decode().strip().lower()] = v.decode().strip()
    return head[0], headers, data[end + 4 :]
