"""Wire protocol types.

TPU-native re-design of the reference's shared protocol layer
(``common/lib/protocol-definitions/src/protocol.ts``): plain dataclasses with
int client ids (the sequencer assigns small integer slots so ops lower
directly to int32 kernel rows, instead of string clientIds + JSON contents).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Optional


class MessageType(enum.IntEnum):
    """Reference ``protocol.ts:6`` MessageType (subset, int-coded)."""

    NOOP = 0
    OPERATION = 1
    CLIENT_JOIN = 2
    CLIENT_LEAVE = 3
    PROPOSE = 4
    REJECT = 5
    SUMMARIZE = 6
    SUMMARY_ACK = 7
    SUMMARY_NACK = 8
    NO_CLIENT = 9
    CONTROL = 10
    SIGNAL = 11
    ATTACH = 12  # dynamic channel/datastore creation (reference "attach" op)
    BLOB_ATTACH = 13  # bind a blob localId -> storageId (blobManager.ts)


class NackErrorType(enum.IntEnum):
    """Reference ``protocol.ts`` INackContent error classes."""

    THROTTLING = 0
    INVALID_SCOPE = 1
    BAD_REQUEST = 2
    LIMIT_EXCEEDED = 3


@dataclass
class DocumentMessage:
    """Client -> server op (reference ``IDocumentMessage`` protocol.ts:133)."""

    client_sequence_number: int
    reference_sequence_number: int
    type: MessageType
    contents: Any = None
    metadata: Optional[dict] = None
    traces: list = field(default_factory=list)


@dataclass
class SequencedDocumentMessage:
    """Server -> client sequenced op (``ISequencedDocumentMessage``
    protocol.ts:212): adds the total-order stamp and the collab-window floor.
    """

    client_id: int  # -1 for server-generated messages
    sequence_number: int
    client_sequence_number: int
    reference_sequence_number: int
    minimum_sequence_number: int
    type: MessageType
    contents: Any = None
    metadata: Optional[dict] = None
    timestamp: float = 0.0
    traces: list = field(default_factory=list)


@dataclass
class NackMessage:
    """Server rejection of an inbound op (``INack``)."""

    sequence_number: int  # sequence number when the nack was generated
    content_code: int  # HTTP-ish status, e.g. 400/403
    error_type: NackErrorType
    message: str = ""
    retry_after_s: float = 0.0
    client_sequence_number: int = -1  # the rejected op, for resubmission


@dataclass
class SignalMessage:
    """Transient, per-doc-unsequenced message (``ISignalMessage``)."""

    client_id: int
    client_connection_number: int
    content: Any = None


@dataclass
class ClientDetail:
    """Join payload (subset of reference ``IClient``)."""

    client_id: int
    mode: str = "write"  # "write" | "read"
    user: str = ""
    details: Optional[dict] = None
