"""Historian — the caching façade between readers and summary storage.

Reference: the historian service fronts git storage with a Redis cache
(``server/historian/packages/historian-base/src/services/
restGitService.ts`` — read-through caching of immutable git objects,
latest-summary caching invalidated on new writes, and cache failures
logged-but-never-failed; ``redisCache.ts`` is the external cache tier).

The tpu-native shape: everything in the summary store is
CONTENT-ADDRESSED (SHA-256 handles), so the object cache needs no
invalidation protocol at all — a handle's bytes never change, only the
*latest* pointer is mutable. That splits the façade into:

- :class:`CachingBlobBackend` — a ``SummaryStore`` backend wrapper:
  reads go through the cache (immutable → cache forever, LRU-bounded),
  writes populate it (the reference caches on write so the next read is
  warm, ``restGitService.ts:128``), and ANY cache error is counted and
  absorbed — the store stays the source of truth
  (``restGitService.ts:437-446``'s log-don't-fail rule).
- :class:`LruCache` — the in-proc tier (byte-bounded, thread-safe).
- :class:`RemoteCache` — the same interface over a
  :class:`~fluidframework_tpu_torch.service.store_server.StoreServer` cache
  node (the Redis analog): volatile, restart-to-cold, refilled by
  read-through.
- :class:`LatestSummaryCache` — the one MUTABLE thing historian caches:
  the per-document latest-summary pointer, updated (= invalidated) when
  scribe durably accepts a newer summary
  (``restGitService.ts:222-232``).

``historian(...)`` assembles a ``SummaryStore`` over the caching backend
— it duck-types the plain store, so it slots into
``PipelineFluidService(store=...)`` or ``FluidNetworkServer`` unchanged,
putting the cache tier exactly where the reference puts historian:
between the REST readers and the durable store.
"""

from __future__ import annotations

import json
import threading
from typing import Dict, List, Optional, Tuple

from fluidframework_tpu_torch.service.store_server import _Conn
from fluidframework_tpu_torch.service.summary_store import SummaryStore
from fluidframework_tpu_torch.utils.lru import LruCache

__all__ = [
    "CachingBlobBackend",
    "HistorianReadTier",
    "LatestSummaryCache",
    "LruCache",
    "RemoteCache",
    "historian",
    "read_cache_counter",
    "read_cache_miss_counter",
]


def read_cache_counter(registry=None):
    """``read_cache_hits_total{tier}``, registered in ONE place (the
    ``tree_ingest_counter`` idiom): every read-tier cache — the
    immutable delta chunks, the latest-summary pointer, the
    content-addressed blob tier — reports hits here, so the /metrics
    scrape sees the read path's cache effectiveness without test-local
    state."""
    from fluidframework_tpu_torch.telemetry import metrics

    reg = registry or metrics.REGISTRY
    return reg.counter(
        "read_cache_hits_total",
        "read-tier cache hits, by tier (deltas / summary / blob)",
        labelnames=("tier",),
    )


def read_cache_miss_counter(registry=None):
    """``read_cache_misses_total{tier}`` — the other half of the hit
    ratio (hits alone cannot distinguish a warm cache from no reads)."""
    from fluidframework_tpu_torch.telemetry import metrics

    reg = registry or metrics.REGISTRY
    return reg.counter(
        "read_cache_misses_total",
        "read-tier cache misses, by tier (deltas / summary / blob)",
        labelnames=("tier",),
    )


class RemoteCache:
    """The cache tier on a store node (Redis analog): same get/set/delete
    surface over the node's socket protocol. Connection failures raise —
    the façade absorbs them, so a cache-node outage degrades reads to
    store-direct instead of failing them."""

    def __init__(self, host: str, port: int):
        self.host, self.port = host, port
        self._conn: Optional[_Conn] = None

    def _c(self) -> _Conn:
        if self._conn is None:
            self._conn = _Conn(self.host, self.port)
        return self._conn

    def _call(self, head: dict, body: bytes = b"") -> Tuple[dict, bytes]:
        try:
            return self._c().call(head, body)
        except Exception:
            # One reconnect attempt (the node may have been replaced);
            # a second failure propagates to the façade's absorber.
            self._conn = None
            return self._c().call(head, body)

    def get(self, key: str) -> Optional[bytes]:
        resp, body = self._call({"op": "cache.get", "key": key})
        return body if resp.get("hit") else None

    def set(self, key: str, value: bytes) -> None:
        self._call({"op": "cache.set", "key": key}, value)

    def delete(self, key: str) -> None:
        self._call({"op": "cache.del", "key": key})


class CachingBlobBackend:
    """Read-through / write-populate blob backend wrapper. Handles are
    content hashes, so cached entries are immutable by construction —
    the only eviction is capacity. Cache errors never surface: the
    inner backend is always authoritative."""

    def __init__(self, inner, cache=None):
        self.inner = inner
        self.cache = cache if cache is not None else LruCache()
        self.hits = 0
        self.misses = 0
        self.cache_errors = 0

    def _cache_get(self, key: str) -> Optional[bytes]:
        try:
            return self.cache.get(key)
        except Exception:
            self.cache_errors += 1
            return None

    def _cache_set(self, key: str, value: bytes) -> None:
        try:
            self.cache.set(key, value)
        except Exception:
            self.cache_errors += 1

    def put_blob(self, data: bytes) -> str:
        handle = self.inner.put_blob(data)
        self._cache_set(handle, data)
        return handle

    def get_blob(self, handle: str) -> bytes:
        v = self._cache_get(handle)
        if v is not None:
            self.hits += 1
            read_cache_counter().inc(tier="blob")
            return v
        self.misses += 1
        read_cache_miss_counter().inc(tier="blob")
        data = self.inner.get_blob(handle)
        self._cache_set(handle, data)
        return data

    def has(self, handle: str) -> bool:
        # A cache hit proves existence; a miss proves nothing (no
        # negative caching — a blob absent now may be written later).
        if self._cache_get(handle) is not None:
            self.hits += 1
            read_cache_counter().inc(tier="blob")
            return True
        return self.inner.has(handle)


class LatestSummaryCache:
    """Per-document latest-summary pointer + inflated summary cache —
    the one mutable entry historian keeps. ``update`` both advances the
    pointer and drops the stale inflated copy (the delete-then-write of
    ``restGitService.ts:222-232``)."""

    def __init__(self, store: SummaryStore):
        self.store = store
        self._latest: Dict[str, str] = {}  # doc -> tree handle
        self._inflated: Dict[str, Tuple[str, dict]] = {}
        self._lock = threading.Lock()

    def update(self, doc_id: str, handle: str) -> None:
        with self._lock:
            self._latest[doc_id] = handle
            self._inflated.pop(doc_id, None)

    def latest_handle(self, doc_id: str) -> Optional[str]:
        return self._latest.get(doc_id)

    def latest_summary(self, doc_id: str) -> Optional[dict]:
        with self._lock:
            handle = self._latest.get(doc_id)
            if handle is None:
                return None
            got = self._inflated.get(doc_id)
            if got is not None and got[0] == handle:
                return got[1]
        summary = self.store.get_summary(handle)
        with self._lock:
            if self._latest.get(doc_id) == handle:
                self._inflated[doc_id] = (handle, summary)
        return summary


class HistorianReadTier:
    """The caching read tier in front of the ordering service (the
    read-path fan-out): REST catch-up and snapshot reads are served HERE
    — immutable delta-range chunks, the ``LatestSummaryCache``-backed
    summary pointer, and content-addressed blobs through
    :class:`CachingBlobBackend` — and **no read in this class ever pumps
    the sequencing pipeline**. That is the reference's historian
    placement (PAPER.md §2.3/§2.9): cold catch-up traffic lands on the
    cache tier and storage, never on deli's hot loop.

    Why delta chunks can cache forever: a sequenced op is immutable once
    durable, so the encoded JSON for the fixed seq range
    ``[k*chunk+1, (k+1)*chunk]`` can never change — the
    content-addressed-blob argument applied to op ranges. Only chunks
    FULLY at or below the durable head are cached (a partial chunk would
    need invalidation as the head advances); range edges encode fresh
    per request. Every hit/miss lands on
    ``read_cache_{hits,misses}_total{tier}``.

    The service needs ``doc_head`` (the no-pump durable-head probe) and
    ``ops_range(..., pump=False)`` for the chunk path; anything else
    degrades to an uncached ``get_deltas`` encode — correct, just
    cold."""

    def __init__(self, service, cache=None, chunk: int = 256,
                 blob_cache=None):
        self.service = service
        self.chunk = int(chunk)
        self.cache = cache if cache is not None else LruCache(16 << 20)
        self.blobs = CachingBlobBackend(service.store, blob_cache)
        self.latest = LatestSummaryCache(service.store)
        self.hits = 0
        self.misses = 0

    # -- catch-up deltas -----------------------------------------------------

    def _range_ops(self, doc_id: str, lo: int, hi: int) -> List:
        """Ops in [lo, hi], WITHOUT pumping the pipeline."""
        ranged = getattr(self.service, "ops_range", None)
        if ranged is not None:
            try:
                return ranged(doc_id, lo, hi, pump=False)
            except TypeError:
                # A service whose ops_range has no pump seam never pumps
                # from it (local_server) — call it plain.
                return ranged(doc_id, lo, hi)
        return self.service.get_deltas(
            doc_id, from_seq=lo - 1, to_seq=hi
        )

    def _encode_ops(self, doc_id: str, lo: int, hi: int) -> bytes:
        """JSON-encode ops [lo, hi] as a bracketless item run (the
        composable chunk body: chunks join with commas into one array)."""
        from fluidframework_tpu_torch.service.codec import to_jsonable

        msgs = self._range_ops(doc_id, lo, hi)
        if not msgs:
            return b""
        return json.dumps([to_jsonable(m) for m in msgs]).encode()[1:-1]

    def _chunk_bytes(self, doc_id: str, c0: int) -> bytes:
        """One full immutable chunk's encoded bytes, cache-backed."""
        key = f"{doc_id}#deltas/{self.chunk}/{c0}"
        cached = self.cache.get(key)
        if cached is not None:
            self.hits += 1
            read_cache_counter().inc(tier="deltas")
            return cached
        self.misses += 1
        read_cache_miss_counter().inc(tier="deltas")
        data = self._encode_ops(
            doc_id, c0 * self.chunk + 1, (c0 + 1) * self.chunk
        )
        self.cache.set(key, data)
        return data

    def deltas_payload(
        self, doc_id: str, from_seq: int = 0,
        to_seq: Optional[int] = None,
    ) -> bytes:
        """The encoded ``GET /deltas`` body — ops with
        ``from_seq < seq <= to_seq`` (default: the durable head) —
        composed from cached immutable chunks plus freshly encoded range
        edges. Never pumps; a service without the no-pump probes encodes
        fresh (uncached, still correct)."""
        head_fn = getattr(self.service, "doc_head", None)
        head = head_fn(doc_id) if head_fn is not None else None
        if head is None:
            from fluidframework_tpu_torch.service.codec import to_jsonable

            msgs = self.service.get_deltas(
                doc_id, from_seq=from_seq, to_seq=to_seq
            )
            return json.dumps([to_jsonable(m) for m in msgs]).encode()
        hi = head if to_seq is None else min(to_seq, head)
        lo = from_seq + 1
        if hi < lo:
            return b"[]"
        parts: List[bytes] = []
        c = self.chunk
        seq = lo
        while seq <= hi:
            c0 = (seq - 1) // c
            clo, chi = c0 * c + 1, (c0 + 1) * c
            if seq == clo and chi <= hi:
                parts.append(self._chunk_bytes(doc_id, c0))
                seq = chi + 1
            else:
                end = min(hi, chi)
                parts.append(self._encode_ops(doc_id, seq, end))
                seq = end + 1
        return b"[" + b",".join(p for p in parts if p) + b"]"

    # -- latest summary ------------------------------------------------------

    def latest_summary(self, doc_id: str) -> Optional[dict]:
        """The doc's latest scribe-acked summary, inflated through the
        :class:`LatestSummaryCache` (the one MUTABLE pointer historian
        caches): the pointer probe is cheap host state with no pump; a
        handle change invalidates the stale inflated copy exactly as
        ``restGitService.ts:222-232`` deletes-then-writes."""
        probe = getattr(self.service, "latest_summary_pointer", None)
        ptr = probe(doc_id) if probe is not None else None
        if ptr is None:
            return None
        handle = ptr[0]
        if self.latest.latest_handle(doc_id) == handle:
            self.hits += 1
            read_cache_counter().inc(tier="summary")
        else:
            self.misses += 1
            read_cache_miss_counter().inc(tier="summary")
            self.latest.update(doc_id, handle)
        return self.latest.latest_summary(doc_id)

    # -- blobs ---------------------------------------------------------------
    # The content-addressed tier: the façade's CachingBlobBackend wraps
    # the service's store, so REST blob reads ride the cache (and its
    # counters) while writes populate it for the next reader.

    def put_blob(self, data: bytes) -> str:
        return self.blobs.put_blob(data)

    def get_blob(self, handle: str) -> bytes:
        return self.blobs.get_blob(handle)

    def has(self, handle: str) -> bool:
        return self.blobs.has(handle)

    def hit_ratio(self) -> float:
        """Read-tier hit ratio across every cache (deltas + summary +
        blob) — the bench headline's ``read_historian_hit_ratio``."""
        hits = self.hits + self.blobs.hits
        total = hits + self.misses + self.blobs.misses
        return hits / total if total else 0.0


def historian(
    inner, cache=None, chunk_bytes: int = 256 * 1024
) -> SummaryStore:
    """A ``SummaryStore`` whose reads ride a cache tier. ``inner`` is any
    blob backend (the in-proc dict, the native C++ store, or a
    ``RemoteBlobBackend`` against a store node); ``cache`` is any
    get/set/delete tier (``LruCache`` in-proc, ``RemoteCache`` for the
    external node). The result duck-types a plain store — hand it to the
    service front door and every summary/blob read a client triggers is
    served through the cache."""
    return SummaryStore(
        backend=CachingBlobBackend(inner, cache), chunk_bytes=chunk_bytes
    )
