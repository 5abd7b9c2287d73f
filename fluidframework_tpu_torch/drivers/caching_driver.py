"""Caching driver — the odsp-driver's persistence/coherency layer.

Reference: ``packages/drivers/odsp-driver`` + ``driver-web-cache``: a
persistent cache of snapshots and op tails keyed per document
(``odspCache.ts``, IndexedDB-backed in the browser), guarded by an
**EpochTracker** (``epochTracker.ts``): every cached artifact is stamped
with the service's document epoch, and a mismatch (the document was
restored/branched server-side) evicts the cache rather than serving stale
state. Cold loads then hit only the blob store for missing entries.

Counterpart of ``fluidframework_tpu/drivers/caching_driver.py``, with the
port's imports: cache files carry the same names (SHA-256 of the key) and
the same bytes (the binary snapshot) as the reference's.

Here the cache wraps ANY inner service (local, network, multinode):

- ``connect`` serves the cached summary + cached op tail first, fetching
  only the ops past the cached watermark from the service;
- blobs read through a local content-addressed cache (content-addressed ==
  immutable, so blobs never need epoch checks);
- the epoch guard drops the whole per-doc cache when the service epoch
  moved (document restored from an older summary).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, List, Optional

from fluidframework_tpu_torch.protocol.types import SequencedDocumentMessage
from fluidframework_tpu_torch.service.codec import from_jsonable, to_jsonable
from fluidframework_tpu_torch.service.summary_store import SummaryStore


class PersistentCache:
    """driver-web-cache analog: JSON files per document + a blob dir;
    in-memory when no directory is given."""

    def __init__(self, directory: Optional[str] = None):
        self.dir = directory
        if directory:
            os.makedirs(os.path.join(directory, "blobs"), exist_ok=True)
        self._docs: Dict[str, dict] = {}
        self._blobs: Dict[str, bytes] = {}

    # -- per-document snapshot/op-tail entries -------------------------------

    @staticmethod
    def _fs_name(key: str) -> str:
        # Handles and doc ids come from the (untrusted) service; never use
        # them as filenames — a '/' or '..' would escape the cache dir.
        return hashlib.sha256(key.encode()).hexdigest()

    def _doc_path(self, doc_id: str) -> str:
        return os.path.join(self.dir, f"doc-{self._fs_name(doc_id)}.snap")

    def get_doc(self, doc_id: str) -> Optional[dict]:
        if doc_id in self._docs:
            return self._docs[doc_id]
        if self.dir and os.path.exists(self._doc_path(doc_id)):
            from fluidframework_tpu_torch.drivers.binary_snapshot import (
                decode_snapshot,
            )

            with open(self._doc_path(doc_id), "rb") as f:
                self._docs[doc_id] = decode_snapshot(f.read())
            return self._docs[doc_id]
        return None

    def put_doc(self, doc_id: str, entry: dict) -> None:
        self._docs[doc_id] = entry
        if self.dir:
            # Compact binary on disk (the odsp snapshot-format analog) —
            # cold-start bytes are the cache's whole point.
            from fluidframework_tpu_torch.drivers.binary_snapshot import (
                encode_snapshot,
            )

            with open(self._doc_path(doc_id), "wb") as f:
                f.write(encode_snapshot(entry))

    def evict_doc(self, doc_id: str) -> None:
        self._docs.pop(doc_id, None)
        if self.dir and os.path.exists(self._doc_path(doc_id)):
            os.remove(self._doc_path(doc_id))

    # -- blobs (content-addressed: immutable, epoch-free) --------------------

    def get_blob(self, handle: str) -> Optional[bytes]:
        if handle in self._blobs:
            return self._blobs[handle]
        if self.dir:
            p = os.path.join(self.dir, "blobs", self._fs_name(handle))
            if os.path.exists(p):
                with open(p, "rb") as f:
                    self._blobs[handle] = f.read()
                return self._blobs[handle]
        return None

    def has_blob(self, handle: str) -> bool:
        """Existence probe without reading the blob body."""
        if handle in self._blobs:
            return True
        return bool(self.dir) and os.path.exists(
            os.path.join(self.dir, "blobs", self._fs_name(handle))
        )

    def put_blob(self, handle: str, data: bytes) -> None:
        self._blobs[handle] = data
        if self.dir:
            p = os.path.join(self.dir, "blobs", self._fs_name(handle))
            with open(p, "wb") as f:
                f.write(data)


class _CachedBlobBackend:
    """Read-through blob cache in front of the inner summary store."""

    def __init__(self, inner: SummaryStore, cache: PersistentCache):
        self.inner = inner
        self.cache = cache

    def put_blob(self, data: bytes) -> str:
        handle = self.inner.put_blob(data)
        self.cache.put_blob(handle, data)
        return handle

    def get_blob(self, handle: str) -> bytes:
        data = self.cache.get_blob(handle)
        if data is None:
            data = self.inner.get_blob(handle)
            self.cache.put_blob(handle, data)
        return data

    def has(self, handle: str) -> bool:
        return self.cache.has_blob(handle) or self.inner.has(handle)


class CachingFluidService:
    """Service wrapper: cached cold-start + epoch coherency."""

    def __init__(self, inner, cache: Optional[PersistentCache] = None,
                 epoch_of=None):
        self.inner = inner
        self.cache = cache or PersistentCache()
        # The service-side document epoch (bumps when a document is
        # restored/branched). Default: constant 1 (services without the
        # concept never invalidate).
        self._epoch_of = epoch_of or (lambda doc_id: 1)
        self._store = SummaryStore(
            backend=_CachedBlobBackend(inner.store, self.cache)
        )
        self.stats = {"cached_ops_served": 0, "fetched_ops": 0, "evictions": 0}

    @property
    def store(self) -> SummaryStore:
        return self._store

    def _validate_epoch(self, doc_id: str, entry: Optional[dict]):
        if entry is None:
            return None
        if entry.get("epoch") != self._epoch_of(doc_id):
            # Reference epochTracker: epoch moved -> every cached artifact
            # for the document is suspect; evict and refetch.
            self.cache.evict_doc(doc_id)
            self.stats["evictions"] += 1
            return None
        return entry

    def connect(self, doc_id: str, mode: str = "write", from_seq: int = 0):
        entry = self._validate_epoch(doc_id, self.cache.get_doc(doc_id))
        cached_ops: List[SequencedDocumentMessage] = []
        if from_seq == 0 and entry is not None:
            cached_ops = [from_jsonable(m) for m in entry["ops"]]
            from_seq = entry["head"]
            self.stats["cached_ops_served"] += len(cached_ops)
        conn = self.inner.connect(doc_id, mode, from_seq=from_seq)
        if cached_ops:
            conn.inbox[:0] = cached_ops
        if entry is not None and entry.get("summary"):
            # A cached summary with an empty op tail is still a valid cold
            # start — don't gate it on cached_ops.
            conn.initial_summary = tuple(entry["summary"])
        return conn

    def get_deltas(self, doc_id: str, from_seq: int = 0, to_seq=None):
        msgs = self.inner.get_deltas(doc_id, from_seq, to_seq)
        self.stats["fetched_ops"] += len(msgs)
        return msgs

    def disconnect(self, doc_id: str, client_id: int) -> None:
        self.inner.disconnect(doc_id, client_id)

    def snapshot_to_cache(self, doc_id: str, initial_summary=None) -> None:
        """Persist the document's current tail (and summary pointer) so the
        next cold start serves from cache. Only ops PAST the summary are
        cached — a loader starts at the summary's seq, so earlier ops would
        trip the runtime's gapless-sequence assertion."""
        base = initial_summary[1] if initial_summary else 0
        ops = self.inner.get_deltas(doc_id, from_seq=base)
        self.cache.put_doc(
            doc_id,
            {
                "epoch": self._epoch_of(doc_id),
                "head": ops[-1].sequence_number if ops else base,
                "ops": [to_jsonable(m) for m in ops],
                "summary": list(initial_summary) if initial_summary else None,
            },
        )
