"""Content-addressed blob storage (in memory).

Counterpart of ``fluidframework_tpu/service/summary_store.py`` with its
in-memory backend, reduced to the blob surface the device scribe uses:
blobs keyed by their SHA-256 digest, so a blob hashes to the same handle
in both packages. Trees, whole runtime summaries and the native blob
backend are not ported yet.
"""

from __future__ import annotations

import hashlib
from typing import Dict


class SummaryStore:
    """Content-addressed blob store held in a dict."""

    def __init__(self):
        self._blobs: Dict[str, bytes] = {}

    def put_blob(self, data: bytes) -> str:
        h = hashlib.sha256(data).hexdigest()
        self._blobs[h] = data
        return h

    def get_blob(self, handle: str) -> bytes:
        return self._blobs[handle]
