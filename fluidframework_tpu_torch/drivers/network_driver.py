"""Network driver — the routerlicious-driver equivalent.

Reference: ``packages/drivers/routerlicious-driver`` — REST delta fetch
(``deltaStorageService.ts:24``), REST git storage via historian
(``documentStorageService.ts:24``), socket.io live delta stream
(``documentDeltaConnection.ts:19``), HMAC-token auth (``restWrapper.ts``).

The client stack is synchronous, so this driver runs a blocking
socket with a background reader thread per connection; the returned
``NetworkConnection`` duck-types ``LocalConnection`` (inbox / signals /
nacks / ``take_inbox`` / ``submit``), which means ``ContainerRuntime`` runs
unchanged over a real network. URL scheme::

    fluid-net://host:port/tenant/doc-id

Counterpart of ``fluidframework_tpu/drivers/network_driver.py``. It is pure
Python on the client's side of the wire and touches no tensor and no device.
"""

from __future__ import annotations

import json
import socket
import threading
import time
from typing import Callable, List, Optional
from urllib.request import Request, urlopen

from fluidframework_tpu_torch.protocol.types import (
    DocumentMessage,
    NackMessage,
    SequencedDocumentMessage,
    SignalMessage,
)
from fluidframework_tpu_torch.service import wsproto
from fluidframework_tpu_torch.service.codec import from_jsonable, to_jsonable
from fluidframework_tpu_torch.service.network_server import TenantManager
from fluidframework_tpu_torch.service.summary_store import SummaryStore

URL_SCHEME = "fluid-net://"


def parse_url(url: str):
    assert url.startswith(URL_SCHEME), f"unsupported url {url!r}"
    hostport, _, tail = url[len(URL_SCHEME):].partition("/")
    host, _, port = hostport.partition(":")
    tenant, _, doc = tail.partition("/")
    doc = doc.split("/", 1)[0]
    return host, int(port), tenant, doc


class RestBlobBackend:
    """SummaryStore backend over the server's /blobs routes (historian)."""

    def __init__(self, base: str, auth: str = ""):
        self.base = base
        self.auth = auth

    def put_blob(self, data: bytes) -> str:
        req = Request(f"{self.base}/blobs?{self.auth}", data=data, method="POST")
        with urlopen(req, timeout=10) as r:
            return json.loads(r.read())["handle"]

    def get_blob(self, handle: str) -> bytes:
        with urlopen(f"{self.base}/blobs/{handle}?{self.auth}", timeout=10) as r:
            return r.read()

    def has(self, handle: str) -> bool:
        try:
            req = Request(
                f"{self.base}/blobs/{handle}?{self.auth}", method="HEAD"
            )
            with urlopen(req, timeout=10):
                return True
        except Exception:
            return False


def _ws_client_connect(host: str, port: int):
    """Dial + websocket-upgrade one socket (shared by the op channel and
    the push channel). Returns ``(sock, decoder, pending_frames)``. The
    connect itself times out at 10s, then the socket goes blocking —
    reader threads park in recv() indefinitely (an idle stream is normal;
    a leftover timeout would silently kill the reader after 10 quiet
    seconds)."""
    sock = socket.create_connection((host, port), timeout=10)
    try:
        req, expect = wsproto.client_handshake(f"{host}:{port}", "/socket")
        sock.sendall(req)
        buf = b""
        while True:
            head = wsproto.read_http_head(buf)
            if head is not None:
                break
            chunk = sock.recv(65536)
            if not chunk:
                raise ConnectionError("server closed during handshake")
            buf += chunk
        status, headers, rest = head
        if b"101" not in status:
            raise ConnectionError(f"websocket upgrade failed: {status!r}")
        if headers.get("sec-websocket-accept") != expect:
            raise ConnectionError("bad websocket accept key")
        sock.settimeout(None)
        decoder = wsproto.FrameDecoder()
        return sock, decoder, decoder.feed(rest)
    except BaseException:
        try:
            sock.close()
        except OSError:
            pass
        raise


class NetworkConnection:
    """Live delta stream over a websocket (DocumentDeltaConnection)."""

    def __init__(self, host: str, port: int, doc_id: str, tenant: str,
                 token: str, mode: str, from_seq: int,
                 push: bool = False):
        self.doc_id = doc_id
        self.inbox: List[SequencedDocumentMessage] = []
        # Dual-channel ingest (odsp push-channel analog): sequenced ops may
        # arrive on the op socket AND a delivery-only push socket; a seq
        # watermark + stash keeps the inbox gap-free and duplicate-free
        # regardless of which channel wins the race.
        self._seq_watermark = from_seq
        self._stash: dict = {}
        self._push_sock: Optional[socket.socket] = None
        self.signals: List[SignalMessage] = []
        self.nacks: List[NackMessage] = []
        self.on_nack: Optional[Callable[[NackMessage], None]] = None
        self.initial_summary: Optional[tuple] = None
        self.client_id: int = -1
        self.join_seq: int = 0
        self.conn_no: int = 0
        # Binary frame-wire counters: proof the
        # OP_BINARY path was actually taken, assertable from e2e tests.
        self.frames_sent = 0
        self.frames_received = 0
        self.ops_from_frames = 0
        self.closed = False
        self._lock = threading.Lock()
        self._connected = threading.Event()
        self._error: Optional[str] = None

        self._sock, self._decoder, self._pending = _ws_client_connect(
            host, port
        )
        try:
            self._send_json(
                {
                    "type": "connect_document",
                    "doc": doc_id,
                    "tenant": tenant,
                    "token": token,
                    "mode": mode,
                    "from_seq": from_seq,
                    # Negotiate the batched binary frame wire (both
                    # directions); frame-ignorant servers drop the key.
                    "frames": True,
                }
            )
            self._reader = threading.Thread(target=self._read_loop, daemon=True)
            self._reader.start()
            if not self._connected.wait(10):
                raise ConnectionError("connect_document timed out")
            if self._error is not None:
                raise ConnectionError(self._error)
            if self.client_id < 0:
                # Socket dropped before connect_document_success arrived.
                raise ConnectionError("connection closed before join completed")
            if push:
                try:
                    self._open_push(
                        host, port, tenant, token, self._seq_watermark
                    )
                except (OSError, ConnectionError):
                    # Push is best-effort: a failed second dial must not
                    # kill the established op channel.
                    self._push_sock = None
        except BaseException:
            self.closed = True
            for s in (self._sock, self._push_sock):
                if s is not None:
                    try:
                        s.close()
                    except OSError:
                        pass
            raise

    # -- wire ---------------------------------------------------------------

    def _send_json(self, obj: dict) -> None:
        frame = wsproto.encode_frame(
            wsproto.OP_TEXT, json.dumps(obj).encode(), mask=True
        )
        self._sock.sendall(frame)

    def _read_loop(self) -> None:
        frames = self._pending
        try:
            while not self.closed:
                for opcode, payload in frames:
                    if opcode == wsproto.OP_CLOSE:
                        return
                    if opcode == wsproto.OP_PING:
                        self._sock.sendall(
                            wsproto.encode_frame(
                                wsproto.OP_PONG, payload, mask=True
                            )
                        )
                        continue
                    if opcode == wsproto.OP_BINARY:
                        self._on_binary(payload)
                        continue
                    if opcode == wsproto.OP_TEXT:
                        self._on_message(json.loads(payload.decode()))
                data = self._sock.recv(65536)
                if not data:
                    return
                frames = self._decoder.feed(data)
        except (OSError, ValueError):
            # OSError: socket died; ValueError: peer violated the frame
            # protocol (oversized/malformed) — either way the stream is dead.
            pass
        finally:
            self.closed = True
            self._connected.set()

    def _on_message(self, msg: dict) -> None:
        t = msg.get("type")
        if t == "connect_document_success":
            self.client_id = msg["client_id"]
            self.join_seq = msg.get("join_seq", 0)
            self.conn_no = msg.get("conn_no", 0)
            if msg.get("initial_summary"):
                self.initial_summary = tuple(msg["initial_summary"])
                # Delivery starts above the summary head, not from_seq.
                with self._lock:
                    self._seq_watermark = max(
                        self._seq_watermark, self.initial_summary[1]
                    )
            self._connected.set()
        elif t == "connect_document_error":
            self._error = msg.get("error", "connect failed")
            self._connected.set()
        elif t == "op":
            self._ingest(from_jsonable(msg["msg"]))
        elif t == "signal":
            self.signals.append(
                SignalMessage(
                    client_id=msg["client_id"],
                    client_connection_number=msg["num"],
                    content=msg.get("content"),
                )
            )
        elif t == "nack":
            nk = from_jsonable(msg["nack"])
            self.nacks.append(nk)
            if self.on_nack:
                self.on_nack(nk)

    def _ingest(self, m: SequencedDocumentMessage) -> None:
        """Watermark + stash merge: contiguous delivery into the inbox no
        matter which channel (op socket / push socket) a seq arrives on
        first; duplicates drop."""
        with self._lock:
            seq = m.sequence_number
            if seq <= self._seq_watermark or seq in self._stash:
                return
            self._stash[seq] = m
            while self._seq_watermark + 1 in self._stash:
                self._seq_watermark += 1
                self.inbox.append(self._stash.pop(self._seq_watermark))

    # -- the push channel (odspDocumentDeltaConnection analog) ---------------

    def _open_push(self, host: str, port: int, tenant: str, token: str,
                   from_seq: int) -> None:
        """Second, delivery-only socket: the server streams sequenced ops
        from the durable log; ops race the main channel and merge through
        the same watermark ingest."""
        self._push_sock, self._push_decoder, pending = _ws_client_connect(
            host, port
        )
        self._push_sock.sendall(
            wsproto.encode_frame(
                wsproto.OP_TEXT,
                json.dumps(
                    {
                        "type": "subscribe_push",
                        "doc": self.doc_id,
                        "tenant": tenant,
                        "token": token,
                        "from_seq": from_seq,
                    }
                ).encode(),
                mask=True,
            )
        )

        def loop():
            frames = pending
            try:
                while not self.closed:
                    for opcode, payload in frames:
                        if opcode == wsproto.OP_CLOSE:
                            return
                        if opcode == wsproto.OP_TEXT:
                            msg = json.loads(payload.decode())
                            if msg.get("type") == "op":
                                self._ingest(from_jsonable(msg["msg"]))
                    data = self._push_sock.recv(65536)
                    if not data:
                        return
                    frames = self._push_decoder.feed(data)
            except (OSError, ValueError):
                pass  # push is best-effort; the op channel remains

        self._push_reader = threading.Thread(target=loop, daemon=True)
        self._push_reader.start()

    # -- LocalConnection surface -------------------------------------------

    def _on_binary(self, payload: bytes) -> None:
        """A sequenced op frame: expand through the same watermark ingest
        (client rates are interactive — per-op expansion is fine HERE;
        it is the service that must never pay it)."""
        from fluidframework_tpu_torch.protocol.opframe import SeqFrame

        self.frames_received += 1
        msgs = SeqFrame.decode(payload).messages()
        self.ops_from_frames += len(msgs)
        for m in msgs:
            self._ingest(m)

    def submit(self, msg: DocumentMessage) -> None:
        self._send_json({"type": "submitOp", "op": to_jsonable(msg)})

    def submit_frame(self, frame) -> None:
        """Ship a batch of string-kernel ops as ONE binary ws frame
        (protocol/opframe.py) — the high-throughput client wire."""
        self._sock.sendall(
            wsproto.encode_frame(wsproto.OP_BINARY, frame.encode(), mask=True)
        )
        self.frames_sent += 1

    def submit_signal(self, content) -> None:
        self._send_json({"type": "submitSignal", "content": content})

    def take_inbox(self, n: Optional[int] = None) -> List[SequencedDocumentMessage]:
        with self._lock:
            n = len(self.inbox) if n is None else min(n, len(self.inbox))
            out, self.inbox[:] = self.inbox[:n], self.inbox[n:]
            return out

    def wait_for(self, pred, timeout: float = 10.0) -> bool:
        """Poll until ``pred(self)`` (arrival is asynchronous over the wire —
        the in-proc services deliver synchronously, sockets cannot). The
        predicate runs without the inbox lock, so it may call take_inbox."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if pred(self):
                return True
            time.sleep(0.002)
        return False

    def disconnect(self) -> None:
        if not self.closed:
            try:
                self._send_json({"type": "disconnect"})
                self._sock.sendall(
                    wsproto.encode_frame(wsproto.OP_CLOSE, b"", mask=True)
                )
            except OSError:
                pass
            self.closed = True
        # Close both channels regardless of how we got here (a dead op
        # socket sets self.closed in its read loop; the push fd must not
        # leak behind it).
        for s in (self._sock, self._push_sock):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass


class NetworkFluidService:
    """Client-side service facade bound to one server; duck-types
    ``LocalFluidService`` for ``ContainerRuntime`` (connect / get_deltas /
    store)."""

    def __init__(self, host: str, port: int, tenant: str = "local",
                 key: Optional[str] = None, push: bool = False):
        self.host, self.port, self.tenant, self.key = host, port, tenant, key
        # push=True opens a second delivery-only websocket per connection
        # (the odsp push-channel analog): sequenced ops race both channels
        # and merge through a watermark, so delivery survives one channel
        # stalling (e.g. the op socket busy with a large submit).
        self.push = push
        self._store: Optional[SummaryStore] = None

    def _auth(self, doc_id: str) -> str:
        if self.key is None:
            return ""
        return (
            f"tenant={self.tenant}"
            f"&token={TenantManager.mint(self.tenant, doc_id, self.key)}"
        )

    def connect(self, doc_id: str, mode: str = "write", from_seq: int = 0):
        token = (
            TenantManager.mint(self.tenant, doc_id, self.key)
            if self.key
            else ""
        )
        return NetworkConnection(
            self.host, self.port, doc_id, self.tenant, token, mode, from_seq,
            push=self.push,
        )

    def get_channel_text(self, doc_id: str, channel_id: str) -> str:
        """Read a string channel straight from the service's device-resident
        replica (GET /documents/:id/channels/:cid) — no container needed."""
        q = self._auth(doc_id)
        url = (
            f"http://{self.host}:{self.port}/documents/{doc_id}"
            f"/channels/{channel_id}" + (f"?{q}" if q else "")
        )
        with urlopen(url, timeout=10) as r:
            return json.loads(r.read())["text"]

    def get_channel_summary(self, doc_id: str, channel_id: str) -> dict:
        """Device-produced channel summary over REST (view=summary)."""
        q = "view=summary"
        auth = self._auth(doc_id)
        if auth:
            q += "&" + auth
        url = (
            f"http://{self.host}:{self.port}/documents/{doc_id}"
            f"/channels/{channel_id}?{q}"
        )
        with urlopen(url, timeout=10) as r:
            return json.loads(r.read())

    def get_deltas(self, doc_id: str, from_seq: int = 0,
                   to_seq: Optional[int] = None):
        q = f"from={from_seq}" + (f"&to={to_seq}" if to_seq is not None else "")
        auth = self._auth(doc_id)
        if auth:
            q += "&" + auth
        url = f"http://{self.host}:{self.port}/deltas/{doc_id}?{q}"
        with urlopen(url, timeout=10) as r:
            return [from_jsonable(m) for m in json.loads(r.read())]

    @property
    def store(self) -> SummaryStore:
        if self._store is None:
            self._store = SummaryStore(
                backend=RestBlobBackend(
                    f"http://{self.host}:{self.port}", self._auth("")
                )
            )
        return self._store


class NetworkDocumentServiceFactory:
    """IDocumentServiceFactory over fluid-net:// URLs."""

    def __init__(self, key: Optional[str] = None):
        self.key = key

    def create_document_service(self, url: str):
        from fluidframework_tpu_torch.drivers.local_driver import LocalDocumentService

        host, port, tenant, doc = parse_url(url)
        svc = NetworkFluidService(host, port, tenant, self.key)
        return LocalDocumentService(svc, doc)
