"""Op virtualization: batch compression, oversize-op chunking, batch marks.

Reference: ``packages/runtime/container-runtime/src/opLifecycle/`` —
``OpCompressor`` (opCompressor.ts:19) compresses a whole batch into
message[0] and sends empty placeholder ops to reserve sequence numbers for
the rest (opCompressor.ts:14-57); ``OpSplitter`` (opSplitter.ts) splits a
single oversized message into ChunkedOps reassembled before processing;
``RemoteMessageProcessor`` (remoteMessageProcessor.ts:11) reverses both on
the inbound path. Batch boundaries ride as begin/end metadata so the
inbound scheduler can keep a batch atomic (scheduleManager.ts).

The wire unit here is the already-enveloped op ``{"address": channel_id,
"contents": ...}``. Every logical op maps to exactly one wire message whose
ack drives the pending FIFO: in compressed mode each placeholder is that
message; in chunked mode it is the final chunk.
"""

from __future__ import annotations

import base64
import json
import zlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from fluidframework_tpu_torch.protocol.types import (
    MessageType,
    SequencedDocumentMessage,
)

# Compress batches whose serialized envelopes exceed this many bytes
# (reference default minimumBatchSizeInBytes, compressionOptions).
DEFAULT_COMPRESSION_THRESHOLD = 4096
# Split wire messages bigger than this (reference maxMessageSize 16KB,
# routerlicious config.json:55).
DEFAULT_CHUNK_SIZE = 16 * 1024


def _dumps(value: Any) -> str:
    return json.dumps(value, separators=(",", ":"), sort_keys=True)


@dataclass
class WireOp:
    """One outbound wire message produced by packing a logical batch.

    ``logical_index`` is set on the single wire message whose sequencing
    acks logical op i of the batch (None on swallowed messages: non-final
    chunks).
    """

    contents: Any
    metadata: Optional[dict]
    logical_index: Optional[int]


def pack_batch(
    envelopes: List[Any],
    compression_threshold: Optional[int] = DEFAULT_COMPRESSION_THRESHOLD,
    chunk_size: Optional[int] = DEFAULT_CHUNK_SIZE,
) -> List[WireOp]:
    """Outbox packing (outbox.ts:34): maybe-compress the batch, then
    maybe-chunk any oversized wire message, and stamp batch-boundary
    metadata on the first and last wire messages."""
    if not envelopes:
        return []
    wire: List[WireOp] = []
    encoded = [_dumps(env) for env in envelopes]

    def emit(env: Any, enc: str, logical_index: int) -> None:
        """One wire message for one envelope, chunked if oversized
        (chunking runs after compression too: the compressed first message
        must itself respect the max message size, opSplitter.ts)."""
        if chunk_size is not None and len(enc) > chunk_size:
            pieces = [enc[j : j + chunk_size] for j in range(0, len(enc), chunk_size)]
            for k, piece in enumerate(pieces):
                final = k == len(pieces) - 1
                wire.append(
                    WireOp(
                        {"chunkedOp": {"index": k, "total": len(pieces), "data": piece}},
                        {"chunked": True},
                        logical_index if final else None,
                    )
                )
        else:
            wire.append(WireOp(env, None, logical_index))

    if (
        compression_threshold is not None
        and sum(len(e) for e in encoded) >= compression_threshold
    ):
        batch_json = "[" + ",".join(encoded) + "]"
        packed = base64.b64encode(zlib.compress(batch_json.encode())).decode()
        head = {"packedContents": packed}
        emit(head, _dumps(head), 0)
        # Empty placeholders reserve one sequence number per remaining op
        # (opCompressor.ts:40-52).
        for i in range(1, len(envelopes)):
            wire.append(WireOp(None, {"compressed": True}, i))
    else:
        for i, (env, enc) in enumerate(zip(envelopes, encoded)):
            emit(env, enc, i)
    if len(wire) > 1:
        wire[0].metadata = {**(wire[0].metadata or {}), "batchBegin": True}
        wire[-1].metadata = {**(wire[-1].metadata or {}), "batchEnd": True}
    return wire


class RemoteMessageProcessor:
    """Inbound unpacking (remoteMessageProcessor.ts:11): undo compression
    and chunking, returning the logical op carried by each wire message or
    None for swallowed messages (non-final chunks).

    State is keyed by sending client id: one client's wire messages arrive
    in submission order, so its decompressed-batch remainder and chunk
    accumulator never interleave with its other ops.
    """

    def __init__(self) -> None:
        self._batch_remainder: Dict[int, List[Any]] = {}
        self._chunks: Dict[int, List[str]] = {}

    def forget_client(self, client_id: int) -> None:
        """Purge partial chunk/batch state for a departed client. A client
        that dies mid-chunked-op leaves a partial accumulator behind; its
        slot recycles, so the next holder's first chunk would trip the
        in-order assert against the corpse's state."""
        self._chunks.pop(client_id, None)
        self._batch_remainder.pop(client_id, None)

    def process(
        self, msg: SequencedDocumentMessage
    ) -> Optional[SequencedDocumentMessage]:
        if msg.type != MessageType.OPERATION:
            return msg
        contents = msg.contents
        if isinstance(contents, dict) and "chunkedOp" in contents:
            chunk = contents["chunkedOp"]
            acc = self._chunks.setdefault(msg.client_id, [])
            assert chunk["index"] == len(acc), "chunk out of order"
            acc.append(chunk["data"])
            if len(acc) < chunk["total"]:
                return None
            del self._chunks[msg.client_id]
            # Fall through: the reassembled payload may itself be a
            # compressed-batch head (chunking runs after compression).
            contents = json.loads("".join(acc))
            msg = self._with_contents(msg, contents)
        if isinstance(contents, dict) and "packedContents" in contents:
            envelopes = json.loads(
                zlib.decompress(
                    base64.b64decode(contents["packedContents"])
                ).decode()
            )
            if len(envelopes) > 1:
                self._batch_remainder[msg.client_id] = envelopes[1:]
            return self._with_contents(msg, envelopes[0])
        if contents is None and msg.client_id in self._batch_remainder:
            remainder = self._batch_remainder[msg.client_id]
            env = remainder.pop(0)
            if not remainder:
                del self._batch_remainder[msg.client_id]
            return self._with_contents(msg, env)
        return msg

    @staticmethod
    def _with_contents(
        msg: SequencedDocumentMessage, contents: Any
    ) -> SequencedDocumentMessage:
        return SequencedDocumentMessage(
            client_id=msg.client_id,
            sequence_number=msg.sequence_number,
            client_sequence_number=msg.client_sequence_number,
            reference_sequence_number=msg.reference_sequence_number,
            minimum_sequence_number=msg.minimum_sequence_number,
            type=msg.type,
            contents=contents,
            metadata=msg.metadata,
            timestamp=msg.timestamp,
            traces=msg.traces,
        )
