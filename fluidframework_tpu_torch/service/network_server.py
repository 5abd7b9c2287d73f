"""Network front door — the alfred/tinylicious equivalent.

Reference: alfred exposes the live op stream over socket.io websockets
(``connect_document``/``submitOp``/``submitSignal``,
``lambdas/src/alfred/index.ts:197,486,524``) and REST routes for historical
deltas and documents (``routerlicious-base/src/alfred/routes/api``), with
riddler validating per-tenant HMAC-signed tokens (``riddler/``). Storage
(historian) serves content-addressed blobs over REST.

This server fronts any in-proc ordering service (``LocalFluidService`` or
the partitioned-lambda ``PipelineFluidService``) with the same three
surfaces, stdlib-only:

- WebSocket (RFC 6455, :mod:`wsproto`): ``connect_document`` handshake ->
  ``connect_document_success{client_id, initial_summary}``; ``submitOp``;
  ``submitSignal``; server pushes ``op``/``signal``/``nack`` frames.
- REST: ``GET /deltas/{doc}?from=&to=`` (delta storage),
  ``POST /blobs`` / ``GET|HEAD /blobs/{handle}`` (summary storage).
- Tenant auth: HMAC-SHA256 token over (tenant, doc) with the tenant's
  secret key — the riddler contract without JWT ceremony.

All service access happens on the asyncio loop thread, so the wrapped
service needs no locking (the reference equivalently serializes per-socket
processing on the Node event loop).

Counterpart of ``fluidframework_tpu/service/network_server.py``. The device
work of a read, a residency sweep and the deadline ticker's scan is split as
there: the loop thread starts it (``read_start`` / ``prefetch_scan``, the
gather or copy queued on the default CUDA stream of device 0), an executor
thread waits for it and copies it to the host (``read_transfer`` /
``scan_transfer``: a synchronous copy on that same default stream, or an
event wait), and the loop finishes it. The token keeps the gathered tensor
alive until its transfer returns. Nothing on the loop thread blocks on the
card.
"""

from __future__ import annotations

import asyncio
import hashlib
import hmac
import json
import queue as queue_mod
import secrets
import select
import threading
import time
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from fluidframework_tpu_torch.service import admission, retry, wsproto
from fluidframework_tpu_torch.service.codec import from_jsonable, to_jsonable
from fluidframework_tpu_torch.service.local_server import LocalFluidService
from fluidframework_tpu_torch.telemetry import metrics
from fluidframework_tpu_torch.testing import faults
from fluidframework_tpu_torch.testing.faults import inject_fault


class TenantManager:
    """Riddler equivalent: tenant registry + HMAC token mint/validate."""

    def __init__(self) -> None:
        self._keys: Dict[str, str] = {}

    def register(self, tenant_id: str, key: Optional[str] = None) -> str:
        key = key or secrets.token_hex(16)
        self._keys[tenant_id] = key
        return key

    @staticmethod
    def mint(tenant_id: str, doc_id: str, key: str) -> str:
        msg = f"{tenant_id}:{doc_id}".encode()
        return hmac.new(key.encode(), msg, hashlib.sha256).hexdigest()

    def validate(self, tenant_id: str, doc_id: str, token: str) -> bool:
        key = self._keys.get(tenant_id)
        if key is None:
            return False
        return hmac.compare_digest(self.mint(tenant_id, doc_id, key), token)


class _Session:
    """One websocket client: its service connection + outbound writer.

    A session is either an op channel (``conn`` set after
    connect_document) or a PUSH subscriber (``push_doc`` set after
    subscribe_push) — the odsp push-channel analog
    (odspDocumentDeltaConnection.ts): delivery-only, no quorum join, ops
    streamed from the durable log by watermark."""

    def __init__(self, writer: asyncio.StreamWriter):
        self.writer = writer
        self.conn = None  # service connection once connect_document succeeds
        self.doc_id: Optional[str] = None
        self.push_doc: Optional[str] = None
        self.push_seq = 0  # delivery watermark for push subscribers
        # The encode-once fan-out keeps per-subscriber state to a
        # watermark + this requeue tail: already-encoded (seq_hi, bytes)
        # payloads a failed write left undelivered — the next sweep
        # drains them without re-reading the log or dragging the fan-out
        # group's minimum watermark back.
        self.push_tail: list = []
        self.frames_ok = False  # client negotiated the binary frame wire
        # The writer-loop offload: once a push subscriber's raw
        # socket is attached (transport buffer drained), its byte
        # writes run on the drainer thread — push_busy marks a batch
        # in flight there, and the fan-out sweep skips the session
        # until the drainer clears it (watermark/tail updates happen on
        # the drainer; the loop reads them only when not busy).
        self.push_sock = None
        self.push_busy = False


class _PushEncodeCache:
    """Per-(doc, sweep) lazy byte cache — the encode-once contract of
    the push fan-out: each durable-log entry's wire bytes are built
    AT MOST ONCE per sweep per wire format (one binary ws frame per
    SeqFrame; one JSON text frame per expanded op), no matter how many
    subscribers drain it. ``encodes`` counts actual encode passes (the
    shim tests pin it flat across 1/10/100 subscribers)."""

    __slots__ = ("_json", "_frame", "encodes")

    def __init__(self) -> None:
        self._json: Dict[int, list] = {}  # entry idx -> [(seq, bytes)]
        self._frame: Dict[int, bytes] = {}
        self.encodes = 0

    def json_items(self, i: int, entry) -> list:
        got = self._json.get(i)
        if got is None:
            self.encodes += 1
            obj = entry[2]
            msgs = (
                [obj] if hasattr(obj, "sequence_number")
                else obj.messages()
            )
            got = self._json[i] = [
                (
                    m.sequence_number,
                    wsproto.encode_frame(
                        wsproto.OP_TEXT,
                        json.dumps(
                            {"type": "op", "msg": to_jsonable(m)}
                        ).encode(),
                    ),
                )
                for m in msgs
            ]
        return got

    def frame_bytes(self, i: int, entry) -> bytes:
        got = self._frame.get(i)
        if got is None:
            self.encodes += 1
            got = self._frame[i] = wsproto.encode_frame(
                wsproto.OP_BINARY, entry[2].encode()
            )
        return got


class _PushStall(Exception):
    """A bounded-write timeout after ``sent`` bytes of the payload
    reached the kernel. The partial prefix is ON THE WIRE — recovery
    must resume from ``data[sent:]``, never resend the whole payload
    (a whole-frame resend after a partial prefix tears the websocket
    stream unrecoverably)."""

    def __init__(self, sent: int, timeout_s: float):
        super().__init__(f"push write stalled past {timeout_s}s "
                         f"({sent} bytes already sent)")
        self.sent = sent


def _sock_sendall(sock, data: bytes, timeout_s: float) -> None:
    """Blocking-with-bound sendall on asyncio's non-blocking socket:
    spin send/select until the payload is fully written or the
    per-write stall bound expires. The bound is the stalled-
    subscriber contract made real at the byte layer — a subscriber
    whose kernel buffer stays full for ``timeout_s`` raises
    :class:`_PushStall` (carrying how much of the payload already
    reached the wire, so the requeue resumes mid-payload), and the
    drainer moves on instead of parking behind one slow socket."""
    view = memoryview(data)
    sent = 0
    deadline = time.monotonic() + timeout_s
    while view:
        try:
            n = sock.send(view)  # graftlint: onloop(drainer-owned socket write — the loop reaches this only through the post-stop inline fallback where no drainer runs; live serving always crosses the drainer thread)
            view = view[n:]
            sent += n
        except (BlockingIOError, InterruptedError):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise _PushStall(sent, timeout_s)
            select.select([], [sock], [], min(remaining, 0.05))  # graftlint: onloop(bounded writability wait on the drainer thread — same post-stop-only loop reachability as the send above)


class _PushDrainer:
    """The writer-loop offload: push
    fan-out byte WRITES run on one daemon drainer thread, so the
    asyncio loop spends its time forming boxcars and reading sockets
    instead of copying the same encoded bytes into N kernel buffers.
    The encode-once sweep (grouping, the shared log read, the encode
    cache) stays ON the loop where it is serialized with service state;
    only ``_push_send`` batches — already-encoded ``(seq, bytes, is
    frame)`` payloads — cross to the drainer.

    Delivery semantics are unchanged by construction: the drainer runs
    the SAME ``_push_send_sync`` body (the ``push.fanout`` injection
    boundary included), one thread + one FIFO queue preserves
    per-subscriber payload order, and ``push_busy`` keeps the loop from
    reading a session's watermark/tail (or enqueueing more work) while
    a batch is in flight — so the exactly-once crash-after rule and
    the requeue-tail recovery hold verbatim, now chaos-matrix-pinned
    from the drainer thread."""

    _STOP = object()

    def __init__(self, server: "FluidNetworkServer"):
        self._server = server
        # queue.Queue (not SimpleQueue): its task_done()/unfinished
        # accounting is lock-protected, which is what makes join() a
        # sound cross-thread barrier.
        self._q: queue_mod.Queue = queue_mod.Queue()
        self._thread: Optional[threading.Thread] = None
        self.batches = 0  # processed batches (tests/bench read these)
        self.threads: set = set()  # ident(s) that ran writes

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> None:
        if self.alive:
            return
        self._thread = threading.Thread(
            target=self._run, name="push-drainer", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        if not self.alive:
            return
        self._q.put(self._STOP)
        self._thread.join(5)
        self._thread = None

    def submit(self, session: "_Session", payloads: list) -> None:
        """Hand one subscriber's encoded batch to the drainer. Caller
        (the fan-out sweep, on the loop) must not touch the session's
        push state again until ``push_busy`` clears."""
        session.push_busy = True
        self._q.put((session, payloads))

    def submit_control(self, session: "_Session", data: bytes) -> None:
        """Queue a control-frame write (pong, control-plane reply)
        behind the session's op stream WITHOUT the busy/watermark
        machinery: control bytes touch no push state, so they must not
        make the fan-out sweep skip the session they just woke (the
        sweep runs right after the ping is processed)."""
        self._q.put((session, data))

    def join(self, timeout_s: float = 5.0) -> bool:
        """Wait until every submitted batch has been processed (tests
        and the bench's per-round measurement barrier). Rides the
        queue's lock-protected unfinished-task count."""
        deadline = time.monotonic() + timeout_s
        while self._q.unfinished_tasks > 0:
            if time.monotonic() > deadline:
                return False
            time.sleep(0.0005)
        return True

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is self._STOP:
                self._q.task_done()
                return
            session, payloads = item
            try:
                self.threads.add(threading.get_ident())
                if isinstance(payloads, bytes):
                    # Control write (pong): bytes only, no push state.
                    if session.push_sock is not None:
                        _sock_sendall(
                            session.push_sock,
                            payloads,
                            self._server.PUSH_WRITE_TIMEOUT_S,
                        )
                else:
                    self._server._push_send_sync(session, payloads)
            except Exception:
                # The write body already converts failures into requeue
                # tails; anything else (a torn-down session, a stalled
                # pong) must not kill the drainer for every other
                # subscriber.
                pass
            finally:
                if not isinstance(payloads, bytes):
                    session.push_busy = False
                    # Follow-up sweep on the loop: ops that became
                    # durable while this batch was in flight were
                    # busy-skipped — without this, a then-quiet server
                    # would sit on them until arbitrary new inbound
                    # traffic. Converges: a sweep with nothing past the
                    # watermarks enqueues no batch, so no follow-up.
                    loop = self._server._loop
                    if loop is not None and not loop.is_closed():
                        try:
                            loop.call_soon_threadsafe(
                                self._server._push_sweep
                            )
                        except RuntimeError:
                            pass  # loop shutting down
                self.batches += 1
                self._q.task_done()


class FluidNetworkServer:
    """TCP server hosting the websocket + REST front door in a daemon
    thread. ``service`` defaults to a fresh ``LocalFluidService``; pass a
    ``PipelineFluidService`` to run the full partitioned-lambda pipeline
    behind real sockets. ``tenants=None`` runs open (no auth), the local
    tinylicious mode."""

    def __init__(
        self,
        service=None,
        host: str = "127.0.0.1",
        port: int = 0,
        tenants: Optional[TenantManager] = None,
        residency_sweep_s: float = 0.0,
    ):
        self.service = service if service is not None else LocalFluidService()
        self.host = host
        self.port = port
        self.tenants = tenants
        self._sessions: List[_Session] = []
        # Binary frame-wire counters (ingress/egress OP_BINARY frames):
        # e2e tests assert the batched wire was actually taken.
        self.frames_received = 0
        self.frames_expanded = 0  # ingress frames per-op fallback-expanded
        self.frames_delivered = 0
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self._server: Optional[asyncio.AbstractServer] = None
        # The deadline ticker: a loop task firing the device
        # backend's continuous-feed trigger every feed-deadline period,
        # so sub-threshold rows dispatch within the deadline even when
        # no client read arrives. pump_ticks counts fired tick bodies
        # (tests wait on it).
        self._pump_task: Optional[asyncio.Task] = None
        self.pump_ticks = 0
        # The loop-stall watchdog: a sentinel task measures the
        # socket loop's expected-vs-actual tick delta every period and
        # exports it as the event_loop_lag_ms gauge; past the threshold
        # it journals a loop.stall event (a blocking readback regression
        # on the loop is caught BY NAME) and, while a /profilez capture
        # is armed, records a loop_lag timeline interval. lag_ticks
        # counts sentinel wakeups (tests wait on it); stalls_seen counts
        # threshold crossings.
        self._lag_task: Optional[asyncio.Task] = None
        self.loop_lag_threshold_ms = 50.0
        self.lag_ticks = 0
        self.stalls_seen = 0
        # The overload envelope: the REFUSE_CONNECTIONS tier gates
        # the accept path (a refused socket gets a 503 + Retry-After
        # right after the bounded header read and holds ZERO session
        # state — the pause-accept analog: back pressure reaches the
        # socket edge instead of growing in-process queues; GET /metrics
        # alone is exempt so the scaler can still see tier 3), and
        # SHED_READS sheds REST reads and push subscriptions. Counters
        # are the test/bench view; the metric families are the
        # scaler's.
        self.connections_refused = 0
        self.reads_shed = 0
        # Batched snapshot reads: REST channel reads queue here
        # for one aggregation window, then the whole batch is served by
        # ONE device gather + ONE off-loop host transfer
        # (DeviceFleetBackend.read_start/read_transfer/read_finish).
        # read_batches counts served batches (tests/bench read it).
        self._pending_reads: list = []
        self._reads_scheduled = False
        self.read_batches = 0
        # The off-loop hibernation sweep: every residency_sweep_s
        # the deadline ticker runs one bounded residency sweep — idle
        # detection and the hibernate walk, with the blocking halves
        # (the batched state gather's device→host transfer, the durable
        # summary put) in the executor and every backend mutation on
        # the loop, the scan-prefetch split applied to hibernation.
        # 0 = disabled (the default: an embedder opts in; the pipeline's
        # synchronous hibernate_sweep() stays available either way).
        self.residency_sweep_s = float(residency_sweep_s)
        self._resid_sweep_edge = 0.0
        self.residency_sweeps = 0
        # The writer-loop offload: push byte writes drain on this
        # thread once the server is running.
        # A server that never starts (in-proc tests driving
        # _drain_all directly) keeps the synchronous inline path —
        # same body, same semantics.
        self._push_drainer = _PushDrainer(self)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> Tuple[str, int]:
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        assert self._started.wait(10), "server failed to start"
        return self.host, self.port

    def _run(self) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)

        async def boot():
            self._server = await asyncio.start_server(
                self._handle, self.host, self.port
            )
            self.port = self._server.sockets[0].getsockname()[1]
            dev = getattr(self.service, "device", None)
            if dev is not None and getattr(dev, "pump_mode", False):
                self._pump_task = asyncio.ensure_future(self._pump_ticker())
            # The loop-stall watchdog runs on EVERY front door (a
            # device-less service can still block its loop), and the gc
            # pause hooks install once per process (idempotent).
            self._lag_task = asyncio.ensure_future(self._lag_sentinel())
            from fluidframework_tpu_torch.telemetry import profiler

            profiler.install_gc_hooks()
            self._push_drainer.start()
            self._started.set()

        self._loop.run_until_complete(boot())
        try:
            self._loop.run_forever()
        finally:
            self._loop.close()

    def stop(self) -> None:
        if self._loop is None:
            return

        async def shutdown():
            for task in (self._pump_task, self._lag_task):
                if task is not None:
                    task.cancel()
                    try:
                        await task
                    except (asyncio.CancelledError, Exception):
                        pass
            for s in list(self._sessions):
                self._close_session(s)
            if self._server is not None:
                self._server.close()
            self._loop.stop()

        asyncio.run_coroutine_threadsafe(shutdown(), self._loop)
        if self._thread is not None:
            self._thread.join(5)
        self._push_drainer.stop()

    # -- connection handling ------------------------------------------------

    async def _handle(self, reader: asyncio.StreamReader, writer) -> None:
        try:
            data = b""
            while True:
                chunk = await reader.read(65536)
                if not chunk:
                    return
                data += chunk
                head = wsproto.read_http_head(data)
                if head is not None:
                    break
                # No complete header yet: everything buffered IS header
                # bytes, so cap it (a coalesced body after the blank line
                # would have parsed above).
                if len(data) > 64 << 10:
                    return
            request_line, headers, rest = head
            method, path, _ = request_line.decode().split(" ", 2)
            # REFUSE_CONNECTIONS (the LAST shed tier): turn the new
            # socket away right after the bounded header read — no
            # session allocation, no websocket handshake, nothing queued
            # in-process — with ONE exemption: GET /metrics. The scaler
            # reads its scale-up signal there precisely when the
            # envelope is at its worst; refusing the scrape would pin
            # the server at tier 3 with no one able to see it.
            # /debugz shares the /metrics exemption: the flight
            # recorder is read precisely when the envelope is at its
            # worst — refusing the post-mortem surface at tier 3 would
            # blind the one reader who needs it.
            ov = getattr(self.service, "overload", None)
            if ov is not None and ov.refuse_connections() and not (
                method == "GET"
                and urlparse(path).path in ("/metrics", "/debugz")
            ):
                self.connections_refused += 1
                admission.shed_counter().inc(kind="connection")
                retry_after_s = max(1, int(ov.retry_after_ms() / 1e3 + 0.5))
                writer.write(
                    (
                        "HTTP/1.1 503 Service Unavailable\r\n"
                        f"Retry-After: {retry_after_s}\r\n"
                        "Content-Length: 0\r\nConnection: close\r\n\r\n"
                    ).encode()
                )
                await writer.drain()
                return
            if headers.get("upgrade", "").lower() == "websocket":
                await self._websocket(reader, writer, headers, rest)
            else:
                await self._rest(reader, writer, method, path, headers, rest)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        except ValueError:
            pass  # protocol violation (oversized/malformed frame): drop
        finally:
            try:
                writer.close()
            except Exception:
                pass

    # -- REST (delta storage + blob storage) --------------------------------

    async def _rest(self, reader, writer, method, path, headers, body) -> None:
        content_length = int(headers.get("content-length", "0"))
        if content_length > wsproto.MAX_FRAME_BYTES:
            writer.write(
                b"HTTP/1.1 413 Payload Too Large\r\n"
                b"Content-Length: 0\r\nConnection: close\r\n\r\n"
            )
            return
        need = content_length - len(body)
        while need > 0:
            chunk = await reader.read(need)
            if not chunk:
                break
            body += chunk
            need -= len(chunk)
        url = urlparse(path)
        parts = [p for p in url.path.split("/") if p]
        query = {k: v[0] for k, v in parse_qs(url.query).items()}

        def reply(status: int, payload: bytes = b"", ctype="application/json",
                  headers: Optional[dict] = None):
            extra = "".join(
                f"{k}: {v}\r\n" for k, v in (headers or {}).items()
            )
            writer.write(
                (
                    f"HTTP/1.1 {status} X\r\n"
                    f"Content-Type: {ctype}\r\n"
                    f"Content-Length: {len(payload)}\r\n"
                    f"{extra}"
                    "Connection: close\r\n\r\n"
                ).encode()
                + payload
            )

        if method == "GET" and parts == ["debugz"]:
            # The flight recorder: replica-deterministic journal
            # render — pure host state, ZERO device readbacks (the
            # journal consumes the existing scan/scrape data only), and
            # exempt from shed tiers exactly like /metrics (handled
            # BEFORE the SHED_READS branch below).
            from fluidframework_tpu_torch.telemetry import journal

            reply(
                200, journal.render().encode(),
                ctype="text/plain; charset=utf-8",
            )
            await writer.drain()
            return
        if method == "GET" and parts == ["metrics"]:
            # Prometheus exposition (unauthenticated, like the health
            # surface): refresh the device gauges with the contractual
            # ONE batched readback, then render the process registry.
            # NEVER shed — the scaler reads its signal here precisely
            # when the envelope is under pressure.
            reply(
                200, await self._metrics_payload(),
                ctype="text/plain; version=0.0.4; charset=utf-8",
            )
            await writer.drain()
            return
        # SHED_READS (the FIRST shed tier): every REST read — deltas,
        # document metadata, device-served channel snapshots, blob
        # fetches — sheds with a 503 + Retry-After before touching the
        # service, so the sequencing path keeps its budget for writes.
        # Writes (POST /blobs, POST /documents) pass: their throttling
        # is admission's (nack + retry-after), one tier later.
        ov = getattr(self.service, "overload", None)
        if (
            ov is not None and ov.shed_reads() and method in ("GET", "HEAD")
        ):
            self.reads_shed += 1
            admission.shed_counter().inc(kind="read")
            reply(
                503, b'{"error": "overloaded, reads shed"}',
                headers={
                    "Retry-After": max(
                        1, int(ov.retry_after_ms() / 1e3 + 0.5)
                    ),
                },
            )
            await writer.drain()
            return
        if method == "GET" and parts == ["profilez"]:
            # The serving timeline profiler: arm a bounded capture
            # window, sleep it out on the loop (serving continues — the
            # producers record from the traffic this very socket loop
            # keeps driving), and return the Perfetto/Chrome trace JSON.
            # Deliberately AFTER the SHED_READS branch above and OUTSIDE
            # the REFUSE_CONNECTIONS exemption tuple: an armed capture
            # ALLOCATES, so under overload /profilez is shed with
            # Retry-After like any read — the opposite of /metrics and
            # /debugz, whose exemption exists because they allocate
            # nothing the envelope needs to protect.
            import math

            from fluidframework_tpu_torch.telemetry import profiler

            try:
                duration_ms = float(query.get("duration_ms", 250.0))
            except ValueError:
                duration_ms = float("nan")
            if not math.isfinite(duration_ms):
                # NaN slips through min/max clamps (every comparison is
                # False) and would defeat the self-disarm deadline AND
                # hang this handler's sleep — reject it at the edge.
                reply(400, b'{"error": "malformed duration_ms"}')
                await writer.drain()
                return
            duration_ms = min(
                max(duration_ms, 1.0), profiler.MAX_WINDOW_MS
            )
            if profiler.enabled():
                # One capture at a time: a concurrent arm would reset
                # the ring mid-capture and the first requester's disarm
                # would truncate the second's window — both silently
                # wrong. Serialize at the surface.
                reply(
                    409, b'{"error": "a capture is already armed"}',
                    headers={"Retry-After": 1},
                )
                await writer.drain()
                return
            if not profiler.arm(duration_ms):
                # Counted retry_attempts_total{profiler.arm,fallback}
                # inside arm() and absorbed — the capture fails, the
                # serving path does not.
                reply(
                    503, b'{"error": "profiler arm failed"}',
                    headers={"Retry-After": 1},
                )
                await writer.drain()
                return
            await asyncio.sleep(duration_ms / 1e3)
            profiler.disarm()
            reply(200, json.dumps(profiler.chrome_trace()).encode())
            await writer.drain()
            return
        # Delta/document routes are doc-scoped; blob routes use a
        # storage-scope token (minted for the empty doc id), since handles
        # aren't per-document.
        scope = (
            parts[1]
            if len(parts) > 1 and parts[0] in ("deltas", "documents")
            else ""
        )
        if not self._authorized(query, doc_id=scope):
            reply(403, b'{"error": "invalid token"}')
            return
        # The historian-backed read tier: where the service offers
        # one, catch-up deltas, blob reads, and the latest-summary
        # snapshot are served from its caches — cold catch-up never
        # pumps the sequencing loop, and every hit/miss lands on
        # read_cache_{hits,misses}_total{tier}.
        rt = getattr(self.service, "read_tier", None)
        if method == "POST" and parts == ["blobs"]:
            handle = (
                rt.put_blob(body) if rt is not None
                else self.service.store.put_blob(body)
            )
            reply(201, json.dumps({"handle": handle}).encode())
        elif method in ("GET", "HEAD") and len(parts) == 2 and parts[0] == "blobs":
            blobs = rt if rt is not None else self.service.store
            if blobs.has(parts[1]):
                data = b"" if method == "HEAD" else blobs.get_blob(parts[1])
                reply(200, data, ctype="application/octet-stream")
            else:
                reply(404)
        elif method == "GET" and len(parts) == 2 and parts[0] == "deltas":
            if rt is not None:
                reply(200, rt.deltas_payload(
                    parts[1],
                    from_seq=int(query.get("from", 0)),
                    to_seq=int(query["to"]) if "to" in query else None,
                ))
            else:
                msgs = self.service.get_deltas(
                    parts[1],
                    from_seq=int(query.get("from", 0)),
                    to_seq=int(query["to"]) if "to" in query else None,
                )
                reply(
                    200,
                    json.dumps([to_jsonable(m) for m in msgs]).encode(),
                )
        elif (
            method == "GET"
            and len(parts) == 3
            and parts[0] == "documents"
            and parts[2] == "summary"
        ):
            # Latest-summary snapshot read: the LatestSummaryCache
            # path — pointer probe + cached inflation, no pump.
            summary = (
                rt.latest_summary(parts[1]) if rt is not None else None
            )
            if summary is None:
                reply(404, b'{"error": "no summary"}')
            else:
                reply(200, json.dumps(summary).encode())
        elif method == "POST" and parts == ["documents"]:
            # Create (alfred POST /documents, routerlicious-base
            # alfred/routes/api): allocates the document's service state;
            # the caller supplies or receives its id.
            if not hasattr(self.service, "_doc"):
                reply(501, b'{"error": "documents API unsupported"}')
                await writer.drain()
                return
            try:
                req = json.loads(body or b"{}")
            except ValueError:
                reply(400, b'{"error": "malformed JSON body"}')
                await writer.drain()
                return
            doc_id = req.get("id") or f"doc-{secrets.token_hex(6)}"
            self.service._doc(doc_id)
            reply(201, json.dumps({"id": doc_id}).encode())
        elif (
            method == "GET"
            and len(parts) == 4
            and parts[0] == "documents"
            and parts[2] == "channels"
        ):
            # Device-served read (GET /documents/:id/channels/:cid?view=…):
            # the string channel's state straight from the service's
            # device-resident replica — no client replica involved. The
            # request queues for one aggregation window and the whole
            # pending batch is served by ONE device gather + ONE
            # off-loop host transfer (batched snapshot reads — the
            # reads_per_device_dispatch amortization).
            if getattr(self.service, "device", None) is None:
                reply(501, b'{"error": "device backend unsupported"}')
                await writer.drain()
                return
            status, payload = await self._channel_read(
                parts[1], parts[3], query.get("view")
            )
            reply(status, payload)
        elif method == "GET" and len(parts) == 2 and parts[0] == "documents":
            # Metadata (alfred GET /documents/:id): existence, head seq,
            # latest acked summary pointer, connected clients.
            doc_id = parts[1]
            if not hasattr(self.service, "docs"):
                reply(501, b'{"error": "documents API unsupported"}')
                await writer.drain()
                return
            exists = doc_id in self.service.docs
            if not exists:
                reply(404, json.dumps({"id": doc_id, "exists": False}).encode())
            else:
                doc = self.service.docs[doc_id]
                reply(
                    200,
                    json.dumps(
                        {
                            "id": doc_id,
                            "exists": True,
                            "head": doc.sequencer.seq,
                            "minimum_sequence_number": doc.sequencer.min_seq,
                            "latest_summary": (
                                list(doc.latest_summary)
                                if doc.latest_summary
                                else None
                            ),
                            "clients": len(doc.connections),
                        }
                    ).encode(),
                )
        else:
            reply(404, b'{"error": "not found"}')
        await writer.drain()

    async def _metrics_payload(self) -> bytes:
        """One /metrics scrape: refresh the wrapped service's device
        gauges — exactly ONE batched telemetry readback — then render the
        process registry. The scrape's Python-state halves (assembly,
        gauge fold) run ON the event loop, serialized with the serving
        traffic that mutates fleet state; only the blocking device→host
        transfer runs off-loop, so a scrape neither races a promotion nor
        stalls websocket traffic for a device round trip. A service
        without a device stage just renders."""
        backend = getattr(self.service, "device", None)
        if backend is not None:
            dev, layout, totals = backend._telemetry_start()
            host = await asyncio.get_running_loop().run_in_executor(
                None, backend._telemetry_readback, dev
            )
            backend.publish_metrics(
                scrape=backend._telemetry_finish(host, layout, totals)
            )
        return metrics.REGISTRY.render().encode()

    async def _channel_read(
        self, doc_id: str, channel_id: str, view: Optional[str]
    ) -> Tuple[int, bytes]:
        """Queue one REST channel read into the pending batch and await
        its result. The first request of a batch schedules the serving
        task; everything that arrives within its aggregation window
        rides the same device gather."""
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._pending_reads.append((doc_id, channel_id, view, fut))
        if not self._reads_scheduled:
            self._reads_scheduled = True
            asyncio.ensure_future(self._serve_reads())
        return await fut

    async def _serve_reads(self) -> None:
        """Serve every queued channel read with ONE batched device
        gather: after one feed-deadline aggregation window, the
        batch's Python-state halves (pump, flush, key resolution, state
        split) run ON the loop — serialized with the serving traffic
        that mutates fleet state — while the single blocking device→host
        transfer runs off-loop (the /metrics scrape split). N pending
        readers, one readback — ``reads_per_device_dispatch`` counts the
        amortization."""
        dev = getattr(self.service, "device", None)
        window = (
            max(float(getattr(dev, "feed_deadline_ms", 3.0)), 0.5)
            if dev is not None else 3.0
        ) / 1e3
        await asyncio.sleep(window)
        self._reads_scheduled = False
        pending, self._pending_reads = self._pending_reads, []
        if not pending:
            return
        try:
            svc_pump = getattr(self.service, "pump", None)
            if svc_pump is not None:
                svc_pump()  # settle so fresh channels are visible
            # Re-fetch: crash_device() replaces the backend.
            dev = getattr(self.service, "device", None)
            if dev.needs_flush():
                dev.flush()
            reqs = []
            for doc_id, channel_id, view, fut in pending:
                if not dev.has_channel(doc_id, channel_id):
                    if not fut.done():
                        fut.set_result(
                            (404, b'{"error": "unknown channel"}')
                        )
                else:
                    reqs.append((doc_id, channel_id, view, fut))
            if not reqs:
                return
            keys = list(dict.fromkeys((d, c) for d, c, _v, _f in reqs))
            token = dev.read_start(keys)
            host = None
            if token["dev"] is not None:
                host = await asyncio.get_running_loop().run_in_executor(
                    None, dev.read_transfer, token["dev"]
                )
            states = dev.read_finish(token, host)
            # Duplicate-key requests (N readers of one hot doc) were
            # deduped out of the gather but ARE reads served by this
            # dispatch — the amortization counter must see them.
            dev.reads_served += len(reqs) - len(keys)
            self.read_batches += 1
            for doc_id, channel_id, view, fut in reqs:
                key = (doc_id, channel_id)
                try:
                    # Per-request isolation: one bad channel must fail
                    # ITS reader, not every future in the batch.
                    if view == "summary":
                        payload = json.dumps(
                            dev.summary_from_state(key, states[key])
                        ).encode()
                    else:
                        payload = json.dumps({
                            "text": dev.text_from_state(key, states[key])
                        }).encode()
                    result = (200, payload)
                except Exception as e:
                    result = (
                        500,
                        json.dumps({"error": repr(e)[:200]}).encode(),
                    )
                if not fut.done():
                    fut.set_result(result)
        except Exception as e:
            for _d, _c, _v, fut in pending:
                if not fut.done():
                    fut.set_result((
                        500,
                        json.dumps({"error": repr(e)[:200]}).encode(),
                    ))

    #: Loop-lag sentinel period (s): the expected tick delta the stall
    #: watchdog measures against. Small enough to catch a blocked loop
    #: within one blocking call, cheap enough to run always (one sleep +
    #: two perf_counter reads + one gauge set per period).
    LOOP_LAG_PERIOD_S = 0.025

    async def _lag_sentinel(self) -> None:
        """The loop-stall watchdog: sleep one period, measure the
        overshoot. A healthy loop wakes within scheduler jitter of the
        period; a loop blocked by a synchronous device readback, a
        compile, or a long Python pass overshoots by the blocked wall —
        which this task measures BY CONSTRUCTION (its wakeup queues
        behind the blocking call), exports as ``event_loop_lag_ms``,
        journals past the threshold (``loop.stall``), and records on the
        ``loop_lag`` timeline lane while a /profilez capture is armed."""
        from fluidframework_tpu_torch.telemetry import journal, profiler

        period = self.LOOP_LAG_PERIOD_S
        while True:
            t0 = time.perf_counter()
            await asyncio.sleep(period)
            t1 = time.perf_counter()
            self.lag_ticks += 1
            lag_ms = max(0.0, (t1 - t0 - period) * 1e3)
            # Re-resolved per tick (one dict probe): the registry idiom
            # that survives a test-isolation REGISTRY.reset().
            profiler.loop_lag_gauge().set(round(lag_ms, 3))
            # Fold buffered collector pauses into their metric families
            # every tick (the gc callback itself is lock-free by
            # contract — it only buffers; see profiler.drain_gc_events).
            profiler.drain_gc_events()
            if lag_ms >= self.loop_lag_threshold_ms:
                self.stalls_seen += 1
                if journal._ON:
                    journal.record(
                        "loop.stall", lag_ms=round(lag_ms, 3),
                        threshold_ms=self.loop_lag_threshold_ms,
                    )
                if profiler._ON:
                    # The stall interval is the overshoot itself: the
                    # expected wake instant to the actual one.
                    profiler.record("loop_lag", t0 + period, t1)

    async def _pump_ticker(self) -> None:
        """The deadline ticker (the continuous-feed analog of the
        idle flush in ``_drain_all``): every feed-deadline period, fire
        the backend's hybrid size/time trigger so sub-threshold rows
        dispatch within ``feed_deadline_ms`` even when no client read
        arrives — and barrier an idle in-flight health scan so capacity
        nacks never wait for future traffic.

        No device round trip ever lands on a submit path or the event
        loop: the feed's Python-state halves (trigger check, staging,
        the async AOT dispatch enqueue) run ON the loop, serialized with
        the serving traffic, while the blocking scan consume runs
        off-loop first (``scan_transfer`` → ``scan_prefetched``, the
        same split as the /metrics readback) — the prefetch IS the
        pump's one-boxcar-stale transfer, not an extra readback."""
        loop = asyncio.get_running_loop()
        while True:
            # Re-fetch per tick: crash_device() REPLACES the service's
            # backend, and a ticker pinned to the dead one would feed an
            # orphan forever while the live backend misses its deadline.
            dev = getattr(self.service, "device", None)
            period = (
                max(float(getattr(dev, "feed_deadline_ms", 3.0)), 0.5)
                if dev is not None else 50.0
            ) / 1e3
            await asyncio.sleep(period)
            # Backpressure propagation: every tick — including
            # idle ones, so the tier can step DOWN as pressure clears —
            # feeds the device's typed pressure signal into the overload
            # controller and lets admission retarget its refill rates
            # from the registry's live applied-ops rate. Pure host
            # state, no device round trip on the loop.
            ov = getattr(self.service, "overload", None)
            if dev is not None and ov is not None:
                ov.observe(dev.pressure())
            adm = getattr(self.service, "admission", None)
            if adm is not None:
                # Feed the LIVE host counter (dev.ops_applied advances
                # with every boxcar), not the scrape-refreshed gauge —
                # a fast ticker on the gauge reads delta=0 between
                # Prometheus scrapes and would pin the rates to the
                # autotune floor.
                adm.autotune(
                    applied_total=(
                        dev.ops_applied if dev is not None else None
                    )
                )
            # The off-loop hibernation sweep rides the SAME ticker
            # (it must run on idle ticks — idleness is exactly when
            # documents hibernate), time-gated by residency_sweep_s.
            if (
                dev is not None
                and self.residency_sweep_s > 0
                and time.perf_counter() - self._resid_sweep_edge
                >= self.residency_sweep_s
            ):
                self._resid_sweep_edge = time.perf_counter()
                try:
                    await self._residency_sweep(dev, loop)
                except asyncio.CancelledError:
                    raise
                except Exception:
                    # Same supervisor contract as the feed tick: a
                    # failed sweep (including an injected doc.hibernate
                    # fault) must not kill future ticks — the doc simply
                    # stays RESIDENT.
                    pass
            if dev is None or not (
                dev.needs_flush() or dev.needs_scan_drain()
            ):
                continue
            self.pump_ticks += 1
            try:
                token = dev.prefetch_scan()
                if token is not None:
                    # Off-loop: the blocking device→host half of the
                    # scan consume. The loop keeps serving while it
                    # streams; the token-identity check in
                    # scan_prefetched drops the result if a racing
                    # drain consumed the scan first, and prefetch_scan
                    # returns None while an installed prefetch awaits
                    # its consume — the same token never transfers
                    # twice.
                    host = await loop.run_in_executor(
                        None, dev.scan_transfer, token
                    )
                    dev.scan_prefetched(token, host)
                if dev.needs_flush():
                    # pump_feed_absorbed does the pump.feed recovery
                    # accounting and absorbs the injected fault (a
                    # faulted tick leaves the rows buffered; the next
                    # tick re-fires over exactly those rows —
                    # docs/failure-semantics.md).
                    dev.pump_feed_absorbed()
                elif dev.needs_scan_drain():
                    # Idle with a scan still streaming: barrier it so
                    # sticky errors surface without new traffic (the
                    # prefetch above made this non-blocking).
                    dev.collect_now()
            except asyncio.CancelledError:
                raise
            except Exception:
                # The ticker is a supervisor loop: a failed tick —
                # including a failed off-loop transfer (e.g. the fleet
                # torn down mid-stream by crash_device) — must not kill
                # future ticks (the quiescence flush remains the
                # correctness backstop).
                continue
            nack = getattr(self.service, "_nack_device_errors", None)
            if nack is not None:
                nack()

    async def _residency_sweep(
        self, dev, loop, max_docs: int = 4,
    ) -> None:
        """One bounded hibernation sweep with the serving loop's
        off-loop discipline: candidate selection, the batched-gather
        device dispatch, and the evict commit run ON the loop
        (serialized with the serving traffic — backend state is
        loop-affine); the gather's device→host transfer and the durable
        summary put run in the executor. Because the loop keeps serving
        between those halves, an op may land on a candidate mid-sweep —
        the applied-head recheck and hibernate_doc's own eligibility
        guards make that a skip, never a lost op."""
        svc = self.service
        rm = getattr(dev, "residency", None)
        if rm is None or not hasattr(svc, "doc_is_idle"):
            return
        self.residency_sweeps += 1
        rm.heat.observe_window()
        for doc_id in rm.resident_docs():
            if svc.doc_is_idle(doc_id):
                rm.mark_idle(doc_id)
        for doc_id in rm.hibernation_candidates(want=max_docs):
            if not dev.hibernate_eligible(doc_id):
                continue
            keys = [k for k in dev.channels() if k[0] == doc_id]
            heads = {k: dev.applied_seq[k] for k in keys}
            token = dev.read_start(keys)
            host = None
            if token["dev"] is not None:
                host = await loop.run_in_executor(
                    None, dev.read_transfer, token["dev"]
                )
            states = dev.read_finish(token, host)
            summary = {
                "channels": {
                    addr: dev.summary_from_state((d, addr), st)
                    for (d, addr), st in states.items()
                },
                "doc_id": doc_id,
                "head": max(heads.values()),
            }
            handle = await loop.run_in_executor(
                None, svc.store.put_summary, summary
            )
            if any(dev.applied_seq[k] != heads[k] for k in keys):
                # Ops applied while the blocking halves streamed: the
                # gathered states are stale. Skip — the doc went busy
                # anyway, and the next sweep re-candidates it.
                continue
            svc.read_tier.latest.update(doc_id, handle)
            dev.hibernate_doc(doc_id, states)

    def _authorized(self, params: dict, doc_id: str) -> bool:
        if self.tenants is None:
            return True
        return self.tenants.validate(
            params.get("tenant", ""), doc_id, params.get("token", "")
        )

    # -- websocket op channel ------------------------------------------------

    async def _websocket(self, reader, writer, headers, rest: bytes) -> None:
        writer.write(wsproto.server_handshake_response(headers))
        await writer.drain()
        session = _Session(writer)
        self._sessions.append(session)
        decoder = wsproto.FrameDecoder()
        frames = decoder.feed(rest)
        try:
            while True:
                for opcode, payload in frames:
                    if opcode == wsproto.OP_CLOSE:
                        return
                    if opcode == wsproto.OP_PING:
                        pong = wsproto.encode_frame(
                            wsproto.OP_PONG, payload
                        )
                        if session.push_sock is not None:
                            # Drainer-owned socket: the pong must ride
                            # the drainer queue too — a transport write
                            # racing a raw send could interleave
                            # mid-frame. Control writes skip the busy
                            # flag so the sweep this ping triggers
                            # still delivers to this session.
                            self._push_drainer.submit_control(
                                session, pong
                            )
                        else:
                            writer.write(pong)
                        continue
                    if opcode == wsproto.OP_BINARY:
                        # Batched binary op wire (protocol/opframe.py):
                        # the payload IS planar kernel rows — one ticket
                        # call, no per-op JSON on the serving path.
                        self._on_frame(session, payload)
                        continue
                    if opcode != wsproto.OP_TEXT:
                        continue
                    self._on_message(session, json.loads(payload.decode()))
                self._drain_all()
                await writer.drain()
                chunk = await reader.read(65536)
                if not chunk:
                    return
                frames = decoder.feed(chunk)
        finally:
            self._close_session(session)
            self._drain_all()

    def _close_session(self, session: _Session) -> None:
        if session in self._sessions:
            self._sessions.remove(session)
        if session.conn is not None:
            self.service.disconnect(session.doc_id, session.conn.client_id)
            session.conn = None

    def _send(self, session: _Session, obj: dict) -> None:
        data = wsproto.encode_frame(
            wsproto.OP_TEXT, json.dumps(obj).encode()
        )
        if session.push_sock is not None:
            # Drainer-owned socket: EVERY loop-side write (error
            # replies to a repeat subscribe/connect included) must ride
            # the drainer queue — a transport write racing a raw send
            # would interleave mid-frame.
            self._push_drainer.submit_control(session, data)
        else:
            session.writer.write(data)

    @inject_fault("ws.deliver")
    def _deliver(self, session: _Session, data: bytes) -> None:
        """One op-stream delivery write — the ``ws.deliver`` injection
        boundary (control-plane replies go through :meth:`_send` and are
        not injected: their recovery is the client's reconnect)."""
        session.writer.write(data)

    def _deliver_obj(self, session: _Session, obj: dict) -> None:
        """JSON-text delivery through the injected boundary (the _send
        encoding, minus the control-plane path)."""
        self._deliver(
            session,
            wsproto.encode_frame(wsproto.OP_TEXT, json.dumps(obj).encode()),
        )

    def _requeue(self, target: list, rest: list) -> None:
        """Delivery-failure recovery: the unsent tail goes back to the
        HEAD of its queue so order is preserved and the next drain tick
        retries — watermarks only advance with a successful write, so the
        client sees each message exactly once. A crash AFTER the final
        write of a batch leaves nothing to requeue (the tail is empty):
        that surfaces as ``fatal``, not a phantom requeue."""
        if rest:
            target[:0] = rest
            retry.retry_counter().inc(site="ws.deliver", outcome="requeue")
        else:
            retry.retry_counter().inc(site="ws.deliver", outcome="fatal")

    @staticmethod
    def _unsent_tail(msgs: list, j: int, exc: BaseException) -> list:
        """Which messages still need delivery after a failed write of
        ``msgs[j]``: a crash AFTER the write (the ack-lost window) means
        ``msgs[j]`` reached the socket — requeueing it would deliver it
        twice; every other failure means it never left."""
        if isinstance(exc, faults.InjectedCrash) and exc.completed:
            return msgs[j + 1:]
        return msgs[j:]

    # -- the encode-once push fan-out ----------------------------------

    #: Per-write stall bound for drainer-thread socket writes: a
    #: subscriber whose kernel buffer stays full this long requeues its
    #: already-encoded tail instead of parking the drainer.
    PUSH_WRITE_TIMEOUT_S = 0.25

    @inject_fault("push.fanout")
    def _push_write(self, session: _Session, data: bytes) -> None:
        """One fan-out delivery write of shared pre-encoded bytes — the
        ``push.fanout`` injection boundary, on whichever thread runs
        the batch (the drainer once the raw socket is attached; the
        loop inline otherwise). Recovery: the failed subscriber's
        remaining ALREADY-ENCODED payloads requeue as its tail
        (``_push_send_sync``); every other subscriber in the group
        keeps draining the same bytes."""
        sock = session.push_sock
        if sock is not None:
            _sock_sendall(sock, data, self.PUSH_WRITE_TIMEOUT_S)
        else:
            session.writer.write(data)

    #: Catch-up window per (subscriber-group, sweep): a cold subscriber
    #: (e.g. subscribe_push from_seq=0 against a deep log) streams the
    #: backlog in bounded per-sweep slices instead of materializing the
    #: whole log on the event loop — and instead of dragging the shared
    #: group read back for every caught-up subscriber.
    PUSH_CATCHUP_SPAN = 4096

    def _push_sweep(self) -> None:
        """One push fan-out sweep over every subscriber group — called
        from every ``_drain_all`` AND scheduled by the drainer when a
        batch completes (the loop-side half of the offload: a
        busy-skipped session's pending ops deliver without waiting for
        new inbound traffic)."""
        push_groups: Dict[str, List[_Session]] = {}
        for s in self._sessions:
            if s.push_doc is not None:
                push_groups.setdefault(s.push_doc, []).append(s)
        for doc_id, subs in push_groups.items():
            self._push_fanout(doc_id, subs)

    def _push_fanout(self, doc_id: str, subs: List["_Session"]) -> None:
        """Deliver newly durable ops to every push subscriber of one doc:
        requeued tails drain first (bytes already encoded — no re-read,
        and a stalled subscriber never drags the group's minimum
        watermark back), then ONE log read from the near group's minimum
        watermark feeds the shared encode cache. Subscribers more than
        ``PUSH_CATCHUP_SPAN`` behind the head are catch-up laggards:
        they read their own bounded slice (grouped by watermark, so a
        mass cold-subscribe still costs one read per distinct start
        point) and converge on the shared read over later sweeps."""
        live = []
        for s in subs:
            if s.push_busy:
                # A batch is in flight on the drainer: the session's
                # watermark/tail belong to that thread until it clears.
                # Like a tailed subscriber, a busy one never drags the
                # group's minimum watermark back — the next sweep picks
                # it up where the drainer left it.
                continue
            if s.push_tail:
                self._push_deliver_tail(s)
            if not s.push_tail and not s.push_busy:
                live.append(s)
        if not live:
            return
        head_fn = getattr(self.service, "doc_head", None)
        head = head_fn(doc_id) if head_fn is not None else None
        span = self.PUSH_CATCHUP_SPAN
        if head is None:
            near, laggards = live, []
        else:
            near = [s for s in live if head - s.push_seq <= span]
            laggards = [s for s in live if head - s.push_seq > span]
        if near:
            min_wm = min(s.push_seq for s in near)
            if head is None or head > min_wm:
                entries = self._push_read(doc_id, min_wm, head)
                if entries:
                    cache = _PushEncodeCache()
                    for s in near:
                        self._push_deliver(s, entries, cache)
        if laggards:
            by_wm: Dict[int, List[_Session]] = {}
            for s in laggards:
                by_wm.setdefault(s.push_seq, []).append(s)
            for wm, group in sorted(by_wm.items()):
                entries = self._push_read(doc_id, wm, min(wm + span, head))
                if not entries:
                    continue
                cache = _PushEncodeCache()
                for s in group:
                    self._push_deliver(s, entries, cache)

    def _push_read(
        self, doc_id: str, min_wm: int, head: Optional[int]
    ) -> list:
        """ONE durable-log read per (doc, sweep) from the fan-out
        group's minimum watermark: whole sequenced frames where the
        service stores them (``log_entries`` — the SeqFrame wire encodes
        once per frame), per-op messages otherwise. A service with no
        head probe scans its per-doc log once per sweep for the WHOLE
        group; the group read is the amortization."""
        ents = getattr(self.service, "log_entries", None)
        if ents is not None and head is not None:
            return ents(doc_id, min_wm + 1, head)
        ranged = getattr(self.service, "ops_range", None)
        if ranged is not None and head is not None:
            msgs = ranged(doc_id, min_wm + 1, head)
        else:
            msgs = self.service.get_deltas(doc_id, from_seq=min_wm)
        return [
            (m.sequence_number, m.sequence_number, m) for m in msgs
        ]

    def _push_deliver(
        self, s: "_Session", entries: list, cache: "_PushEncodeCache"
    ) -> None:
        """One subscriber's drain over the shared entry list: entries at
        or below the watermark skip; a whole frame past the watermark
        ships as the cached binary wire (where negotiated); a frame the
        watermark straddles — only a mid-frame subscribe point, since
        frames write atomically — degrades to the cached per-op JSON
        expansion for its unseen suffix. Entries are seq-sorted and
        non-overlapping, so a caught-up subscriber bisects straight to
        its first unseen entry instead of re-scanning the backlog."""
        import bisect

        payloads: list = []
        start = bisect.bisect_right(entries, s.push_seq, key=lambda e: e[1])
        for i in range(start, len(entries)):
            entry = entries[i]
            lo, hi, obj = entry
            if hi <= s.push_seq:
                continue
            is_frame = not hasattr(obj, "sequence_number")
            if is_frame and s.frames_ok and lo > s.push_seq:
                payloads.append((hi, cache.frame_bytes(i, entry), True))
            else:
                payloads.extend(
                    (seq, data, False)
                    for seq, data in cache.json_items(i, entry)
                    if seq > s.push_seq
                )
        self._push_send(s, payloads)

    def _push_deliver_tail(self, s: "_Session") -> None:
        """Drain a requeued tail: the bytes were encoded on the sweep
        that failed — delivery resumes exactly where it stopped."""
        payloads, s.push_tail = s.push_tail, []
        self._push_send(s, payloads)

    def _push_send(self, s: "_Session", payloads: list) -> None:
        """Route one subscriber's pending payloads: onto the drainer
        thread when it runs and the session's raw socket is attached
        (the writer-loop offload — the loop enqueues and moves to
        the next subscriber), inline otherwise (unstarted servers,
        duck-typed writers, and the handshake window while the
        transport buffer drains). Either way the batch runs
        ``_push_send_sync`` — one body, one contract."""
        if not payloads:
            return
        dr = self._push_drainer
        if dr.alive and self._attach_push_sock(s):
            dr.submit(s, payloads)
        else:
            self._push_send_sync(s, payloads)

    def _attach_push_sock(self, s: "_Session") -> bool:
        """Attach the session's raw socket for drainer writes, once the
        asyncio transport has nothing buffered (mixing transport writes
        with raw sends would interleave mid-frame — the
        subscribe_push_success reply must fully flush first). Returns
        True when drainer writes are safe."""
        if s.push_sock is not None:
            return True
        tr = getattr(s.writer, "transport", None)
        if tr is None:
            return False  # duck-typed writer: stay inline
        try:
            if tr.get_write_buffer_size() > 0:
                return False  # handshake bytes still draining
            sock = tr.get_extra_info("socket")
        except Exception:
            return False
        if sock is None:
            return False
        # asyncio hands out a TransportSocket wrapper whose send()
        # methods are deprecated-then-removed across CPython versions —
        # unwrap the real socket (same fd, no dup) for drainer writes.
        s.push_sock = getattr(sock, "_sock", sock)
        return True

    def _push_send_sync(self, s: "_Session", payloads: list) -> None:
        """Write one subscriber's pending payloads in seq order. The
        watermark advances per successful write (or past a crash-AFTER
        write — it reached the socket; redelivering would double-send:
        the ws exactly-once rule); everything unsent requeues as the
        subscriber's tail for the next sweep. A bounded-write stall
        that left a PARTIAL payload on the wire requeues the payload's
        unsent SUFFIX bytes (same seq, same wire position) — resending
        the whole payload after a delivered prefix would tear the
        subscriber's frame stream."""
        for j, (seq, data, binary) in enumerate(payloads):
            try:
                self._push_write(s, data)
            except Exception as e:
                completed = (
                    isinstance(e, faults.InjectedCrash) and e.completed
                )
                if completed:
                    s.push_seq = max(s.push_seq, seq)
                tail = payloads[j + 1:] if completed else payloads[j:]
                if (
                    isinstance(e, _PushStall)
                    and e.sent > 0
                    and not completed
                ):
                    # Resume THIS payload mid-byte: its prefix reached
                    # the kernel; the watermark stays below seq until
                    # the suffix lands.
                    tail = [(seq, data[e.sent:], binary)] + payloads[j + 1:]
                if tail:
                    s.push_tail = tail
                    retry.retry_counter().inc(
                        site="push.fanout", outcome="requeue"
                    )
                else:
                    retry.retry_counter().inc(
                        site="push.fanout", outcome="fatal"
                    )
                return
            s.push_seq = max(s.push_seq, seq)
            if binary:
                self.frames_delivered += 1

    def _on_frame(self, session: _Session, payload: bytes) -> None:
        from fluidframework_tpu_torch.protocol.opframe import OpFrame

        if session.conn is None:
            return
        self.frames_received += 1
        frame = OpFrame.decode(payload)
        submit = getattr(session.conn, "submit_frame", None)
        if submit is not None:
            submit(frame)
        else:
            self.frames_expanded += 1
            # Service without a frame front door (e.g. the in-memory
            # local orderer): fall back to per-op submits — the wire
            # stays usable everywhere, just without the batched ticket.
            from fluidframework_tpu_torch.protocol.constants import (
                F_REF, F_SEQ, F_TYPE, OP_INSERT,
            )
            from fluidframework_tpu_torch.protocol.opframe import row_contents
            from fluidframework_tpu_torch.protocol.types import (
                DocumentMessage, MessageType,
            )

            ti = 0
            for i in range(frame.n):
                r = frame.rows[i]
                c = row_contents(r, frame.texts, ti)
                if int(r[F_TYPE]) == OP_INSERT:
                    ti += 1
                session.conn.submit(DocumentMessage(
                    client_sequence_number=int(r[F_SEQ]),
                    reference_sequence_number=int(r[F_REF]),
                    type=MessageType.OPERATION,
                    contents={"address": frame.address, "contents": c},
                ))

    def _on_message(self, session: _Session, msg: dict) -> None:
        t = msg.get("type")
        if t == "connect_document":
            if session.conn is not None or session.push_doc is not None:
                # One document connection per socket: releasing the old one
                # implicitly here would leak quorum entries on client bugs.
                self._send(session, {"type": "connect_document_error",
                                     "error": "already connected"})
                return
            doc_id = msg["doc"]
            if not self._authorized(msg, doc_id):
                self._send(session, {"type": "connect_document_error",
                                     "error": "invalid token"})
                return
            try:
                if msg.get("tenant") and hasattr(self.service, "admission"):
                    # Scope the admission budget to the authenticated
                    # tenant (riddler): per-tenant token buckets give
                    # overload FAIRNESS — one tenant's burst throttles
                    # that tenant, not the fleet.
                    conn = self.service.connect(
                        doc_id, msg.get("mode", "write"),
                        msg.get("from_seq", 0), tenant=msg["tenant"],
                    )
                else:
                    conn = self.service.connect(
                        doc_id, msg.get("mode", "write"),
                        msg.get("from_seq", 0),
                    )
            except ConnectionError as e:
                self._send(session, {"type": "connect_document_error",
                                     "error": str(e)})
                return
            session.conn = conn
            session.doc_id = doc_id
            session.frames_ok = bool(msg.get("frames", False))
            self._send(
                session,
                {
                    "type": "connect_document_success",
                    "client_id": conn.client_id,
                    "join_seq": getattr(conn, "join_seq", 0),
                    "conn_no": getattr(conn, "conn_no", 0),
                    "initial_summary": list(conn.initial_summary)
                    if conn.initial_summary
                    else None,
                },
            )
        elif t == "subscribe_push":
            ov = getattr(self.service, "overload", None)
            if ov is not None and ov.shed_reads():
                # Push subscriptions are delivery-only READ load: shed
                # them with a retry-after at the first tier, like the
                # REST reads (the op channel's writes throttle one tier
                # later, through admission).
                self.reads_shed += 1
                admission.shed_counter().inc(kind="subscribe")
                self._send(session, {
                    "type": "subscribe_push_error",
                    "error": "overloaded, reads shed",
                    "retry_after_ms": ov.retry_after_ms(),
                })
                return
            if session.conn is not None or session.push_doc is not None:
                # One role per socket, once: a combined session would
                # starve its op-channel queue in _drain_all, and a repeat
                # subscribe would rewind the watermark (redelivery flood).
                self._send(session, {"type": "subscribe_push_error",
                                     "error": "socket already bound"})
                return
            doc_id = msg["doc"]
            if not self._authorized(msg, doc_id):
                self._send(session, {"type": "subscribe_push_error",
                                     "error": "invalid token"})
                return
            session.push_doc = doc_id
            session.push_seq = int(msg.get("from_seq", 0))
            # frames=True: sequenced SeqFrames deliver as ONE binary ws
            # frame (the same bytes every frame-negotiated subscriber of
            # the doc gets — the encode-once fan-out wire).
            session.frames_ok = bool(msg.get("frames", False))
            self._send(session, {"type": "subscribe_push_success"})
        elif t == "submitOp" and session.conn is not None:
            session.conn.submit(from_jsonable(msg["op"]))
        elif t == "submitSignal" and session.conn is not None:
            session.conn.submit_signal(msg.get("content"))
        elif t == "disconnect" and session.conn is not None:
            self._close_session(session)

    def _drain_all(self) -> None:
        """Forward anything the service put in per-connection queues since
        the last drain (the broadcaster role at the socket layer)."""
        # Time-based device boxcar: a service with a raised
        # device_flush_min_rows defers sub-threshold rows so each client
        # submit doesn't pay a device dispatch; this idle flush bounds
        # how long they wait (and how late capacity nacks can be). The
        # flush is the ASYNC form (dispatch enqueue + streaming health
        # scan, no round-trip barrier — blocking the event loop on the
        # device RTT every tick starves socket IO); the barrier
        # (collect_now) runs only once the ingest goes quiet, so sticky
        # errors still surface within a tick of the last boxcar.
        # One pipeline sweep per drain tick; per-session drains then skip
        # their own pump (a pump per session per inbound message made the
        # socket path O(sessions^2) in pipeline sweeps).
        svc_pump = getattr(self.service, "pump", None)
        if svc_pump is not None:
            svc_pump()
        dev = getattr(self.service, "device", None)
        if dev is not None:
            now = time.monotonic()
            last = getattr(self, "_last_dev_flush", 0.0)
            if dev.needs_flush() and now - last > 0.05:
                self._last_dev_flush = now
                dev.flush()
                nack = getattr(self.service, "_nack_device_errors", None)
                if nack is not None:
                    nack()
            elif (
                not dev.needs_flush()
                and dev.needs_scan_drain()
                and now - last > 0.1
            ):
                self._last_dev_flush = now
                dev.collect_now()
                nack = getattr(self.service, "_nack_device_errors", None)
                if nack is not None:
                    nack()
        # Push delivery (encode-once fan-out): subscribers group by
        # doc, the durable log is read ONCE per (doc, sweep) from the
        # group's minimum watermark, every sequenced entry encodes ONCE
        # per wire format, and the same bytes write to every subscriber
        # past their watermark. Per-subscriber state is a watermark + a
        # requeue tail — the exactly-once crash-after semantics per
        # socket are unchanged.
        self._push_sweep()
        for s in self._sessions:
            if s.conn is None:
                continue
            nopump = getattr(s.conn, "supports_nopump", False)
            take_raw = (
                getattr(s.conn, "take_inbox_raw", None)
                if s.frames_ok else None
            )
            if take_raw is not None:
                msgs = take_raw(pump=False) if nopump else take_raw()
            else:
                msgs = (
                    s.conn.take_inbox(pump=False)
                    if nopump else s.conn.take_inbox()
                )
            for j, m in enumerate(msgs):
                try:
                    if hasattr(m, "sequence_number"):
                        self._deliver_obj(
                            s, {"type": "op", "msg": to_jsonable(m)}
                        )
                    else:
                        # SeqFrame: n sequenced ops in ONE binary frame.
                        self._deliver(s, wsproto.encode_frame(
                            wsproto.OP_BINARY, m.encode()
                        ))
                        self.frames_delivered += 1
                except Exception as e:
                    self._requeue(s.conn.inbox, self._unsent_tail(msgs, j, e))
                    break
            sigs, s.conn.signals[:] = list(s.conn.signals), []
            for j, sig in enumerate(sigs):
                try:
                    self._deliver_obj(s, {
                        "type": "signal",
                        "client_id": sig.client_id,
                        "num": sig.client_connection_number,
                        "content": sig.content,
                    })
                except Exception as e:
                    self._requeue(
                        s.conn.signals, self._unsent_tail(sigs, j, e)
                    )
                    break
            nacks, s.conn.nacks[:] = list(s.conn.nacks), []
            for j, nk in enumerate(nacks):
                try:
                    self._deliver_obj(
                        s, {"type": "nack", "nack": to_jsonable(nk)}
                    )
                except Exception as e:
                    self._requeue(s.conn.nacks, self._unsent_tail(nacks, j, e))
                    break
