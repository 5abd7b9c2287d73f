"""Wire codec for log values — protocol dataclasses ⇄ JSON bytes.

The in-proc :class:`~fluidframework_tpu_torch.service.queue.PartitionedLog`
carries Python objects directly; the native C++ log (and any on-disk or
cross-process transport) carries bytes. This codec round-trips the
protocol dataclasses (DocumentMessage, SequencedDocumentMessage,
NackMessage) nested anywhere inside the record values the pipeline
produces, mirroring how the reference serializes ops onto Kafka.

Counterpart of ``fluidframework_tpu/service/codec.py``, with one addition:
the binary op frames the pipeline puts on its topics (``OpFrame`` on
rawdeltas, ``SeqFrame`` on deltas) ride as their own wire bytes, base64 in
a tagged object. The reference's codec has no case for them, so there a
frame on a remote or native log raises ``TypeError``; every other value
encodes to the same bytes in both packages.
"""

from __future__ import annotations

import base64
import dataclasses
import json
from typing import Any

from fluidframework_tpu_torch.protocol.opframe import OpFrame, SeqFrame
from fluidframework_tpu_torch.protocol.types import (
    DocumentMessage,
    MessageType,
    NackErrorType,
    NackMessage,
    SequencedDocumentMessage,
)

_TAG = "__proto__"
_TYPES = {
    "DocumentMessage": DocumentMessage,
    "SequencedDocumentMessage": SequencedDocumentMessage,
    "NackMessage": NackMessage,
}
_ENUM_FIELDS = {"type": MessageType, "error_type": NackErrorType}
_FRAME_TAG = "__frame__"
_FRAMES = {"OpFrame": OpFrame, "SeqFrame": SeqFrame}


def _to_jsonable(v: Any) -> Any:
    if isinstance(v, (OpFrame, SeqFrame)):
        return {_FRAME_TAG: type(v).__name__,
                "b64": base64.b64encode(v.encode()).decode()}
    if dataclasses.is_dataclass(v) and type(v).__name__ in _TYPES:
        d = {
            f.name: _to_jsonable(getattr(v, f.name))
            for f in dataclasses.fields(v)
        }
        for k in _ENUM_FIELDS:
            if k in d and d[k] is not None:
                d[k] = int(d[k])
        d[_TAG] = type(v).__name__
        return d
    if isinstance(v, dict):
        return {k: _to_jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_to_jsonable(x) for x in v]
    return v


def _from_jsonable(v: Any) -> Any:
    if isinstance(v, dict) and _FRAME_TAG in v:
        return _FRAMES[v[_FRAME_TAG]].decode(base64.b64decode(v["b64"]))
    if isinstance(v, dict):
        tag = v.pop(_TAG, None)
        out = {k: _from_jsonable(x) for k, x in v.items()}
        if tag is not None:
            for k, enum_cls in _ENUM_FIELDS.items():
                if k in out and out[k] is not None:
                    out[k] = enum_cls(out[k])
            return _TYPES[tag](**out)
        return out
    if isinstance(v, list):
        return [_from_jsonable(x) for x in v]
    return v


def encode_value(value: Any) -> bytes:
    return json.dumps(_to_jsonable(value), sort_keys=True).encode()


def decode_value(data: bytes) -> Any:
    return _from_jsonable(json.loads(data.decode()))


# Public aliases for transports that embed protocol objects inside their own
# JSON envelopes (the websocket front door / network driver).
to_jsonable = _to_jsonable
from_jsonable = _from_jsonable
