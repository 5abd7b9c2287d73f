"""Content-addressed summary storage.

Reference: summaries are git trees written through historian/gitrest
(``server/gitrest``, libgit2-backed; ``scribe/summaryWriter.ts``). Here the
same content-addressed model: blobs keyed by digest, trees mapping names to
child handles, incremental reuse for free (unchanged subtrees hash to the
same handle). The Python interface is backed either by an in-memory dict or
by the native C++ store (``native/``), selected at construction, or by any
backend object with ``put_blob`` / ``get_blob`` / ``has``.

Counterpart of ``fluidframework_tpu/service/summary_store.py``.
"""

from __future__ import annotations

import hashlib
import json
from typing import Dict, Optional


class _DictBackend:
    def __init__(self) -> None:
        self._blobs: Dict[str, bytes] = {}

    def put_blob(self, data: bytes) -> str:
        h = hashlib.sha256(data).hexdigest()
        self._blobs[h] = data
        return h

    def get_blob(self, handle: str) -> bytes:
        return self._blobs[handle]

    def has(self, handle: str) -> bool:
        return handle in self._blobs


def scribe_decide(msg, protocol_head: int, store: "SummaryStore"):
    """The scribe acceptance rule for a sequenced Summarize op (reference
    scribe/lambda.ts:204-240): the op's refSeq must not precede the protocol
    head and the uploaded tree must exist. Returns (ok, ack_contents) —
    shared by every service variant so the rule can't diverge."""
    handle = msg.contents["handle"]
    head = msg.contents["head"]
    ok = (
        msg.reference_sequence_number >= protocol_head
        and store.has(handle)
    )
    return ok, {
        "handle": handle,
        "summary_seq": msg.sequence_number,
        "head": head,
    }


SUMMARY_HANDLE_KEY = "__summary_handle__"


def summary_handle(blob_handle: str) -> dict:
    """An ISummaryHandle analog (protocol-definitions summary.ts:10-15):
    'this subtree is unchanged — reuse the blob the previous summary
    uploaded'. O(1) bytes regardless of channel size."""
    return {SUMMARY_HANDLE_KEY: blob_handle}


def is_summary_handle(node) -> bool:
    return isinstance(node, dict) and SUMMARY_HANDLE_KEY in node


class SummaryStore:
    """Content-addressed store over a pluggable blob backend: the native
    C++ store (``native/ca_store.cpp``, optionally disk-persistent) when
    asked for, else an in-memory dict (the TestHistorian analog). Both key
    blobs by SHA-256, so handles are interchangeable, and the same in both
    packages."""

    def __init__(
        self,
        backend=None,
        native: bool = False,
        directory=None,
        chunk_bytes: int = 256 * 1024,
    ):
        if backend is None and native:
            from fluidframework_tpu_torch.utils.native import NativeBlobStore

            backend = NativeBlobStore(directory)
        self._backend = backend or _DictBackend()
        # Channel blobs larger than this split into chunk blobs (reference
        # merge-tree snapshotChunks.ts): bounded blob sizes for transport.
        self.chunk_bytes = chunk_bytes

    # -- blobs ----------------------------------------------------------------

    def put_blob(self, data: bytes) -> str:
        return self._backend.put_blob(data)

    def get_blob(self, handle: str) -> bytes:
        return self._backend.get_blob(handle)

    def has(self, handle: str) -> bool:
        return self._backend.has(handle)

    # -- trees (JSON-encoded name -> handle maps) -----------------------------

    def put_tree(self, entries: Dict[str, str]) -> str:
        data = json.dumps(entries, sort_keys=True).encode()
        return self.put_blob(b"tree:" + data)

    def get_tree(self, handle: str) -> Dict[str, str]:
        data = self.get_blob(handle)
        assert data.startswith(b"tree:"), "handle is not a tree"
        return json.loads(data[5:])

    # -- whole summaries ------------------------------------------------------

    def _put_channel_blob(self, data: bytes) -> str:
        """Store one channel body, chunking oversized payloads into bounded
        blobs joined by a chunk-index blob (snapshotChunks.ts analog)."""
        if len(data) <= self.chunk_bytes:
            return self.put_blob(data)
        chunks = [
            self.put_blob(data[i : i + self.chunk_bytes])
            for i in range(0, len(data), self.chunk_bytes)
        ]
        return self.put_blob(
            b"chunks:" + json.dumps(chunks, sort_keys=True).encode()
        )

    def _get_channel_blob(self, handle: str) -> bytes:
        data = self.get_blob(handle)
        if data.startswith(b"chunks:"):
            return b"".join(
                self.get_blob(h) for h in json.loads(data[len(b"chunks:"):])
            )
        return data

    def put_summary(self, summary: dict) -> str:
        """Store a runtime summary as one tree of per-channel blobs (the
        shredded-summary layout: unchanged channels re-hash identically).
        A channel entry that is a summary HANDLE reuses the referenced
        blob directly — zero new bytes for unchanged channels (the
        incremental ISummaryHandle path)."""
        entries = {}
        for cid, channel_summary in summary["channels"].items():
            if is_summary_handle(channel_summary):
                entries["channel:" + cid] = channel_summary[
                    SUMMARY_HANDLE_KEY
                ]
            else:
                entries["channel:" + cid] = self._put_channel_blob(
                    json.dumps(channel_summary, sort_keys=True).encode()
                )
        entries["meta"] = self.put_blob(
            json.dumps(
                {k: v for k, v in summary.items() if k != "channels"},
                sort_keys=True,
            ).encode()
        )
        return self.put_tree(entries)

    def get_summary(self, handle: str) -> dict:
        entries = self.get_tree(handle)
        out = json.loads(self.get_blob(entries["meta"]))
        out["channels"] = {
            name[len("channel:"):]: json.loads(self._get_channel_blob(h))
            for name, h in entries.items()
            if name.startswith("channel:")
        }
        return out

    def channel_blob_handles(self, handle: str) -> Dict[str, str]:
        """cid -> blob handle for each channel of a stored summary (what an
        incremental summarizer reuses for unchanged channels)."""
        return {
            name[len("channel:"):]: h
            for name, h in self.get_tree(handle).items()
            if name.startswith("channel:")
        }
