"""File driver — snapshots + op logs on local disk.

Reference: ``packages/drivers/file-driver``: reads/writes a document's
snapshot and op stream from local files, used together with the
replay-tool to capture real sessions and play them back offline
(``packages/tools/replay-tool``). Layout here: one directory per
document with ``ops.jsonl`` (one sequenced message per line),
``latest.json`` (latest acked summary pointer), and ``blobs/`` (the
content-addressed summary blobs, via the native store when requested).

Counterpart of ``fluidframework_tpu/drivers/file_driver.py``, with the
port's imports: a directory saved by either package loads in the other,
and one script saves byte-equal directories in both.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

from fluidframework_tpu_torch.protocol.types import (
    MessageType,
    SequencedDocumentMessage,
)
from fluidframework_tpu_torch.service.local_server import LocalFluidService
from fluidframework_tpu_torch.service.summary_store import SummaryStore


def _encode_msg(m: SequencedDocumentMessage) -> str:
    d = dataclasses.asdict(m)
    d["type"] = int(m.type)
    return json.dumps(d, sort_keys=True)


def _decode_msg(line: str) -> SequencedDocumentMessage:
    d = json.loads(line)
    d["type"] = MessageType(d["type"])
    return SequencedDocumentMessage(**d)


def save_document(service: LocalFluidService, doc_id: str, path: str) -> None:
    """Capture a live document — full op log, latest summary pointer, and
    every blob that summary references — to ``path``."""
    os.makedirs(path, exist_ok=True)
    doc = service._doc(doc_id)
    with open(os.path.join(path, "ops.jsonl"), "w") as f:
        for m in doc.op_log:
            f.write(_encode_msg(m) + "\n")
    blob_dir = os.path.join(path, "blobs")
    os.makedirs(blob_dir, exist_ok=True)
    latest = doc.latest_summary
    with open(os.path.join(path, "latest.json"), "w") as f:
        json.dump({"summary": list(latest) if latest else None}, f)
    if latest is not None:
        tree_handle = latest[0]
        _copy_blob(service.store, blob_dir, tree_handle)
        for h in service.store.get_tree(tree_handle).values():
            _copy_blob(service.store, blob_dir, h)
            # Chunked channel bodies reference further chunk blobs from a
            # 'chunks:' index blob — copy those too or loads fail.
            body = service.store.get_blob(h)
            if body.startswith(b"chunks:"):
                for ch in json.loads(body[len(b"chunks:"):]):
                    _copy_blob(service.store, blob_dir, ch)


def _copy_blob(store: SummaryStore, blob_dir: str, handle: str) -> None:
    with open(os.path.join(blob_dir, handle), "wb") as f:
        f.write(store.get_blob(handle))


class FileDocumentService:
    """Read side: serves a saved document from disk. Compose with the
    replay driver for stepped playback, or consume directly."""

    def __init__(self, path: str, doc_id: str = "file"):
        self.path = path
        self.doc_id = doc_id
        with open(os.path.join(path, "ops.jsonl")) as f:
            self.ops: List[SequencedDocumentMessage] = [
                _decode_msg(line) for line in f if line.strip()
            ]
        with open(os.path.join(path, "latest.json")) as f:
            latest = json.load(f)["summary"]
        self.initial_summary = tuple(latest) if latest else None
        self.store = SummaryStore()
        blob_dir = os.path.join(path, "blobs")
        if os.path.isdir(blob_dir):
            for name in os.listdir(blob_dir):
                with open(os.path.join(blob_dir, name), "rb") as f:
                    handle = self.store.put_blob(f.read())
                    assert handle == name, "blob digest mismatch on load"

    def as_replay_service(self, replay_to: Optional[int] = None):
        from fluidframework_tpu_torch.drivers.replay_driver import (
            ReplayDocumentService,
        )

        return ReplayDocumentService(
            self.ops,
            doc_id=self.doc_id,
            initial_summary=self.initial_summary,
            store=self.store,
            replay_to=replay_to,
        )


def load_document(path: str, doc_id: str = "file") -> FileDocumentService:
    return FileDocumentService(path, doc_id)
