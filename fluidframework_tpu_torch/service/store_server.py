"""Out-of-proc store node: blobs + partition logs over a socket.

Reference: the routerlicious deployable persists to EXTERNAL stores —
Mongo for documents/checkpoints
(``server/routerlicious/packages/services/src/mongoDatabaseManager.ts``),
Redis for cache (``redisCache.ts``), Kafka brokers for the op logs — so a
service container is disposable: kill it, schedule a new one, documents
survive. This module is the seam plus one real out-of-proc adapter:

- :class:`StoreServer` — a standalone TCP node hosting the
  content-addressed blob store and the partitioned op logs (the
  mongo+kafka role collapsed to one data node, optionally disk-backed
  via the native C++ stores so IT can restart too);
- :class:`RemoteBlobBackend` — a ``SummaryStore`` backend speaking to it
  (the IDb seam: any object with put_blob/get_blob/has slots in);
- :class:`RemotePartitionedLog` — the ``PartitionedLog`` duck interface
  over the wire (the IProducer/IConsumer seam), values serialized with
  the same codec the native log uses.

Protocol: one JSON line per request/response, binary bodies
length-prefixed after the header — trivial to implement from any
language, framing errors fail loudly.

Counterpart of ``fluidframework_tpu/service/store_server.py``, whole: a
directory given with ``--dir`` puts the node on this package's builds of
the native log and blob store (``utils/native.py``). It is host-only and
touches no device.

Recovery model (test_torch_store_server.py): a REPLACEMENT service process
connects with empty in-proc lambda checkpoints, replays the remote logs
from offset zero, re-sequences deterministically, and upserts
idempotently downstream — the documented at-least-once pipeline model,
now crossing a process boundary.
"""

from __future__ import annotations

import base64
import os
import json
import socket
import socketserver
import threading
from typing import Any, Dict, List, Optional, Tuple

from fluidframework_tpu_torch.service import retry
from fluidframework_tpu_torch.service.codec import decode_value, encode_value
from fluidframework_tpu_torch.service.queue import LogRecord, partition_of
from fluidframework_tpu_torch.telemetry import metrics
from fluidframework_tpu_torch.testing.faults import inject_fault
from fluidframework_tpu_torch.utils.lru import LruCache
from fluidframework_tpu_torch.service.summary_store import SummaryStore

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
# Server


class _Handler(socketserver.StreamRequestHandler):
    def handle(self) -> None:  # one connection, many requests
        srv: "StoreServer" = self.server.store_node  # type: ignore
        while True:
            try:
                line = self.rfile.readline()
            except OSError:
                return
            if not line:
                return
            if line.split(b" ")[:2] in (
                [b"GET", b"/metrics"], [b"GET", b"/debugz"]
            ):
                # Prometheus scrape / flight-recorder read on the store
                # port: plain HTTP on the same socket (the store node
                # has no separate admin listener) — drain the request
                # head, render, close.
                try:
                    while self.rfile.readline() not in (b"\r\n", b"\n", b""):
                        pass
                    self.connection.sendall(
                        srv.debugz_payload()
                        if b"/debugz" in line.split(b" ")[:2]
                        else srv.metrics_payload()
                    )
                except OSError:
                    pass
                return
            try:
                head, body = _parse_msg(line, self.rfile)
            except (ConnectionError, ValueError, OSError):
                return
            try:
                out_head, out_body = srv.dispatch(head, body)
            except KeyError as e:
                out_head, out_body = {"ok": False, "error": f"missing {e}"}, b""
            except Exception as e:  # fail loudly, keep serving
                out_head, out_body = {"ok": False, "error": repr(e)}, b""
            try:
                _send_msg(self.connection, out_head, out_body)
            except OSError:
                return


class StoreServer:
    """The data node. ``serve_background()`` runs it on a daemon thread
    (tests, single-box); ``python -m ...store_server`` runs it as the
    container entry point the k8s StatefulSet/compose service uses."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 n_partitions: int = 8, directory: Optional[str] = None):
        if directory:
            # The native stores mkdir only ONE level; create the tree
            # here or they silently fall back to memory-only and the
            # durability contract is fiction.
            os.makedirs(os.path.join(directory, "plog"), exist_ok=True)
        self.store = SummaryStore(
            native=directory is not None, directory=directory
        )
        self.n_partitions = n_partitions
        # With a directory, the partition logs AND consumer offsets ride
        # the native disk-backed log (``native/partition_log.cpp``) — a
        # restarted store node reloads every record and commit, so the
        # documented replay-from-zero recovery finds the full history.
        # Without one, plain in-memory dicts (test/single-run mode).
        self._plog = None
        if directory:
            from fluidframework_tpu_torch.utils.native import (
                NativePartitionLog,
                native_plog_available,
            )

            if not native_plog_available():
                raise RuntimeError(
                    "disk-backed store node requires libplog.so — a "
                    "silent in-memory fallback would fake durability"
                )
            self._plog = NativePartitionLog(
                directory + "/plog", n_partitions
            )
        self._logs: Dict[Tuple[str, int], List[LogRecord]] = {}
        self._commits: Dict[Tuple[str, str, int], int] = {}
        # Cache tier (the redisCache.ts role): volatile keyed bytes with
        # LRU eviction, served to historian façades over the same socket.
        # Deliberately NOT persisted — a restarted cache node serves cold
        # and read-through refills it (test_historian.py pins this).
        self._cache = LruCache(64 << 20)
        self._lock = threading.Lock()
        self._tcp = socketserver.ThreadingTCPServer(
            (host, port), _Handler, bind_and_activate=True
        )
        self._tcp.daemon_threads = True
        self._tcp.store_node = self  # type: ignore
        self.host, self.port = self._tcp.server_address[:2]

    @property
    def cache_capacity(self) -> int:
        return self._cache.capacity

    @cache_capacity.setter
    def cache_capacity(self, n: int) -> None:
        self._cache.capacity = n

    # -- request dispatch ------------------------------------------------------

    def dispatch(self, head: dict, body: bytes) -> Tuple[dict, bytes]:
        resp, rbody = self._dispatch(head, body)
        # Count AFTER dispatch so an unrecognized client-supplied op
        # string collapses to one label — the socket is unauthenticated,
        # and a counter label set is permanent registry memory.
        known = not str(resp.get("error", "")).startswith("unknown op")
        metrics.REGISTRY.counter(
            "store_requests_total",
            "store-node requests by operation",
            labelnames=("op",),
        ).inc(op=head["op"] if known else "unknown")
        return resp, rbody

    def _dispatch(self, head: dict, body: bytes) -> Tuple[dict, bytes]:
        op = head["op"]
        with self._lock:
            if op == "blob.put":
                return {"ok": True, "handle": self.store.put_blob(body)}, b""
            if op == "blob.get":
                try:
                    return {"ok": True}, self.store.get_blob(head["handle"])
                except KeyError:
                    return {"ok": False, "error": "no such blob"}, b""
            if op == "blob.has":
                return {"ok": True, "has": self.store.has(head["handle"])}, b""
            if op == "log.send":
                p, off = self._log_send(head["topic"], head["key"], body)
                return {"ok": True, "partition": p, "offset": off}, b""
            if op == "log.read":
                lo, limit = head["offset"], head.get("limit", 64)
                if self._plog is not None:
                    out = []
                    for off in range(lo, lo + limit):
                        got = self._plog.read(
                            head["topic"], head["partition"], off
                        )
                        if got is None:
                            break
                        key, val = got
                        out.append({
                            "offset": off,
                            "key": key,
                            "value": base64.b64encode(val).decode(),
                        })
                    return {"ok": True, "records": out}, b""
                log = self._logs.get((head["topic"], head["partition"]), [])
                recs = log[lo: lo + limit]
                out = [
                    {
                        "offset": r.offset,
                        "key": r.key,
                        "value": base64.b64encode(r.value).decode(),
                    }
                    for r in recs
                ]
                return {"ok": True, "records": out}, b""
            if op == "log.end":
                if self._plog is not None:
                    end = self._plog.end_offset(
                        head["topic"], head["partition"]
                    )
                    return {"ok": True, "end": end}, b""
                log = self._logs.get((head["topic"], head["partition"]), [])
                return {"ok": True, "end": len(log)}, b""
            if op == "log.commit":
                if self._plog is not None:
                    self._plog.commit(
                        head["group"], head["topic"], head["partition"],
                        head["offset"],
                    )
                    return {"ok": True}, b""
                k = (head["group"], head["topic"], head["partition"])
                self._commits[k] = max(
                    self._commits.get(k, 0), head["offset"]
                )
                return {"ok": True}, b""
            if op == "log.committed":
                if self._plog is not None:
                    off = self._plog.committed(
                        head["group"], head["topic"], head["partition"]
                    )
                    return {"ok": True, "offset": off}, b""
                k = (head["group"], head["topic"], head["partition"])
                return {"ok": True, "offset": self._commits.get(k, 0)}, b""
            if op == "cache.set":
                self._cache.set(head["key"], body)
                return {"ok": True}, b""
            if op == "cache.get":
                v = self._cache.get(head["key"])
                if v is None:
                    return {"ok": True, "hit": False}, b""
                return {"ok": True, "hit": True}, v
            if op == "cache.del":
                self._cache.delete(head["key"])
                return {"ok": True}, b""
            if op == "meta":
                return {"ok": True, "n_partitions": self.n_partitions}, b""
        return {"ok": False, "error": f"unknown op {op}"}, b""

    @inject_fault("store.append")
    def _log_send(self, topic: str, key: str, body: bytes) -> Tuple[int, int]:
        """The durable-append boundary of the store node (the Mongo/Kafka
        write). An injected failure fires BEFORE the append, surfaces as
        an error response, and the client adapter's retry resends; a
        crash AFTER the append models the ack-lost window — the resend
        then duplicates the record, which every downstream consumer
        absorbs idempotently (the documented at-least-once model)."""
        if self._plog is not None:
            return self._plog.send(topic, key, body)
        p = partition_of(key, self.n_partitions)
        log = self._logs.setdefault((topic, p), [])
        rec = LogRecord(offset=len(log), key=key, value=body)
        log.append(rec)
        return p, rec.offset

    def debugz_payload(self) -> bytes:
        """One complete HTTP response carrying the flight-recorder
        journal (replica-deterministic text, telemetry/journal.py) — the
        store node's ``GET /debugz``. Device-free like the rest of the
        node: the journal consumes host state only."""
        from fluidframework_tpu_torch.telemetry import journal

        body = journal.render().encode()
        return (
            "HTTP/1.1 200 OK\r\n"
            "Content-Type: text/plain; charset=utf-8\r\n"
            f"Content-Length: {len(body)}\r\n"
            "Connection: close\r\n\r\n"
        ).encode() + body

    def metrics_payload(self) -> bytes:
        """One complete HTTP response carrying the process registry in
        Prometheus text format — what a ``GET /metrics`` on the store
        port receives (the store node is device-free, so a scrape here
        never touches an accelerator)."""
        body = metrics.REGISTRY.render().encode()
        return (
            "HTTP/1.1 200 OK\r\n"
            "Content-Type: text/plain; version=0.0.4; charset=utf-8\r\n"
            f"Content-Length: {len(body)}\r\n"
            "Connection: close\r\n\r\n"
        ).encode() + body

    # -- lifecycle -------------------------------------------------------------

    def serve_background(self) -> "StoreServer":
        t = threading.Thread(target=self._tcp.serve_forever, daemon=True)
        t.start()
        return self

    def serve_forever(self) -> None:
        self._tcp.serve_forever()

    def close(self) -> None:
        self._tcp.shutdown()
        self._tcp.server_close()


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


class RemoteBlobBackend:
    """SummaryStore backend over a store node (the IDb/ICache seam's one
    real out-of-proc adapter)."""

    def __init__(self, host: str, port: int):
        self._conn = _Conn(host, port)

    def put_blob(self, data: bytes) -> str:
        resp, _ = self._conn.call({"op": "blob.put"}, data)
        return resp["handle"]

    def get_blob(self, handle: str) -> bytes:
        _resp, body = self._conn.call({"op": "blob.get", "handle": handle})
        return body

    def has(self, handle: str) -> bool:
        resp, _ = self._conn.call({"op": "blob.has", "handle": handle})
        return resp["has"]


class RemotePartitionedLog:
    """The ``PartitionedLog`` duck interface over a store node: values
    ride the shared protocol codec, so everything the in-proc pipeline
    produces round-trips across the process boundary."""

    def __init__(self, host: str, port: int):
        self._conn = _Conn(host, port)
        resp, _ = self._conn.call({"op": "meta"})
        self.n_partitions = resp["n_partitions"]

    def send(self, topic: str, key: str, value: Any) -> Tuple[int, int]:
        # Remote produce rides the unified retry policy: store-node
        # errors (including injected ``store.append`` faults) and
        # transient socket failures resend; a resend after an ack-lost
        # append duplicates the record, which the pipeline's replay
        # consumers absorb idempotently (at-least-once).
        resp, _ = retry.call_with_retry(
            "queue.send",
            self._conn.call,
            {"op": "log.send", "topic": topic, "key": key},
            encode_value(value),
            retryable=(RuntimeError, ConnectionError, OSError),
        )
        return resp["partition"], resp["offset"]

    def send_batch(self, topic: str, entries: List[Tuple[str, Any]]) -> None:
        for key, value in entries:
            self.send(topic, key, value)

    def read(self, topic: str, partition: int, offset: int,
             limit: int = 64) -> List[LogRecord]:
        resp, _ = self._conn.call(
            {"op": "log.read", "topic": topic, "partition": partition,
             "offset": offset, "limit": limit}
        )
        return [
            LogRecord(
                offset=r["offset"], key=r["key"],
                value=decode_value(base64.b64decode(r["value"])),
            )
            for r in resp["records"]
        ]

    def end_offset(self, topic: str, partition: int) -> int:
        resp, _ = self._conn.call(
            {"op": "log.end", "topic": topic, "partition": partition}
        )
        return resp["end"]

    def commit(self, group: str, topic: str, partition: int,
               offset: int) -> None:
        self._conn.call(
            {"op": "log.commit", "group": group, "topic": topic,
             "partition": partition, "offset": offset}
        )

    def committed(self, group: str, topic: str, partition: int) -> int:
        resp, _ = self._conn.call(
            {"op": "log.committed", "group": group, "topic": topic,
             "partition": partition}
        )
        return resp["offset"]


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=7071)
    ap.add_argument("--partitions", type=int, default=8)
    ap.add_argument("--dir", default=None, help="disk persistence root")
    args = ap.parse_args()
    srv = StoreServer(args.host, args.port, args.partitions, args.dir)
    print(f"store node on {srv.host}:{srv.port}", flush=True)
    srv.serve_forever()


if __name__ == "__main__":
    main()
