"""Attachment blobs: out-of-band large payloads bound into the op stream.

Reference: ``packages/runtime/container-runtime/src/blobManager.ts``
(``createBlob`` :380, ``uploadBlob`` :408, pending-blob stashing :165-248):
a blob uploads directly to storage (never rides the sequenced stream), and
a small ``BlobAttach`` op binds the client-minted ``localId`` to the
storage id so the service retains it and every replica can resolve the
handle. Without this, large payloads have only op-chunking — which bloats
the sequenced stream.

Offline behavior: blobs uploaded while disconnected hold their BYTES
host-side (storage may be unreachable); reconnect uploads them and
re-announces every unacked binding. Bindings are idempotent, so duplicate
announcements are harmless — the same contract as channel ATTACH ops.

GC: each binding is a node ``/_blobs/<localId>`` reachable only through
handles stored in channel state; unreferenced bindings age through the
Inactive→Tombstone→Sweep states like any route and drop from summaries
when swept (reference gcTreeKey integration).
"""

from __future__ import annotations

from typing import Dict, Optional

from fluidframework_tpu_torch.runtime.handles import encode_handle

BLOB_ROUTE_PREFIX = "/_blobs/"


class BlobManager:
    def __init__(self, runtime):
        self._rt = runtime
        # localId -> storageId, sequenced (every replica converges on this).
        self.bindings: Dict[str, str] = {}
        # localId -> storageId, uploaded + announced but not yet sequenced.
        self.pending: Dict[str, str] = {}
        # localId -> raw bytes, authored offline (not yet uploadable).
        self.offline: Dict[str, bytes] = {}
        self._counter = 0

    # -- client API ----------------------------------------------------------

    def upload_blob(self, data: bytes) -> dict:
        """Upload and return a storable handle (blobManager.ts createBlob).
        The binding op is submitted immediately when connected; offline
        blobs stage locally and upload at reconnect."""
        self._counter += 1
        local_id = f"b{self._rt.conn_no}-{self._counter}"
        if self._rt.connected:
            storage_id = self._rt._service.store.put_blob(data)
            self.pending[local_id] = storage_id
            self._announce(local_id, storage_id)
        else:
            self.offline[local_id] = data
        return encode_handle(BLOB_ROUTE_PREFIX.rstrip("/") + "/" + local_id)

    def get_blob(self, handle_or_id) -> bytes:
        """Resolve a blob handle (or bare localId) to its bytes."""
        local_id = handle_or_id
        if isinstance(handle_or_id, dict):
            local_id = handle_or_id["url"].rsplit("/", 1)[-1]
        elif isinstance(local_id, str) and local_id.startswith(
            BLOB_ROUTE_PREFIX
        ):
            local_id = local_id.rsplit("/", 1)[-1]
        if local_id in self.offline:
            return self.offline[local_id]
        storage_id = self.bindings.get(local_id) or self.pending.get(local_id)
        assert storage_id is not None, f"unknown blob {local_id!r}"
        return self._rt._service.store.get_blob(storage_id)

    # -- runtime plumbing ----------------------------------------------------

    def _announce(self, local_id: str, storage_id: str) -> None:
        from fluidframework_tpu_torch.protocol.types import MessageType

        self._rt._submit_system(
            MessageType.BLOB_ATTACH,
            {"localId": local_id, "storageId": storage_id},
        )

    def process_attach(self, contents: dict) -> None:
        """A sequenced BlobAttach: record the binding on every replica.
        LocalIds are globally unique (connection-ordinal scoped), so the
        pending pop needs no own-echo check, and duplicate announcements
        after reconnect/nack recovery re-bind the same pair (idempotent)."""
        self.bindings[contents["localId"]] = contents["storageId"]
        self.pending.pop(contents["localId"], None)

    def on_reconnect(self) -> None:
        """Upload offline blobs, then re-announce every unacked binding
        (the reference's pending-blob stash replay)."""
        offline, self.offline = self.offline, {}
        for local_id, data in offline.items():
            self.pending[local_id] = self._rt._service.store.put_blob(data)
        for local_id, storage_id in sorted(self.pending.items()):
            self._announce(local_id, storage_id)

    # -- summaries / GC ------------------------------------------------------

    def gc_routes(self):
        """One graph node per binding (no out-edges); reachable only via
        handles in channel state."""
        # Sorted: the route dict's insertion order reaches GC sweeps and
        # summary serialization, and set order varies with the replica's
        # insertion history — every replica must emit identical routes
        # (graftlint determinism).
        ids = set(self.bindings) | set(self.pending) | set(self.offline)
        return {
            BLOB_ROUTE_PREFIX.rstrip("/") + "/" + i: [] for i in sorted(ids)
        }

    def summarize(self, swept_routes=()) -> Dict[str, str]:
        swept_ids = {
            r.rsplit("/", 1)[-1]
            for r in swept_routes
            if r.startswith(BLOB_ROUTE_PREFIX)
        }
        return {
            k: v for k, v in sorted(self.bindings.items())
            if k not in swept_ids
        }

    def load(self, bindings: Optional[Dict[str, str]]) -> None:
        self.bindings = dict(bindings or {})

    def get_pending_state(self) -> dict:
        """Serializable unacked blob state (stashing support)."""
        return {
            "pending": dict(self.pending),
            "offline": {
                k: v.hex() for k, v in self.offline.items()
            },
            "counter": self._counter,
        }

    def load_pending_state(self, state: dict) -> None:
        self.pending.update(state.get("pending", {}))
        self.offline.update(
            {k: bytes.fromhex(v) for k, v in state.get("offline", {}).items()}
        )
        self._counter = max(self._counter, state.get("counter", 0))
