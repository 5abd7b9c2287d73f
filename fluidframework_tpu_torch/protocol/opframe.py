"""OpFrame — the batched binary client op wire.

Reference: the serving path clients actually ride is the socket wire
(``packages/drivers/driver-base/src/documentDeltaConnection.ts`` submit →
``server/routerlicious/packages/services-shared/src/socketIoServer.ts`` →
deli ``ticket()``). The reference ships one JSON ``IDocumentMessage`` per
op; here clients already lower SharedString ops to int32 kernel rows
(``models/shared_string.py:row_from_wire``), so the TPU-native wire ships
THE ROWS: a frame is a contiguous run of string-kernel ops from one client
on one channel, as planar int32 columns plus one UTF-8 text blob — the
client-side mirror of the fleet service's width-adaptive device wire
(``service/fleet_service.py``). Deli tickets a whole frame in one
vectorized call (seq stamps are ``seq0 + arange``), every service stage
handles the frame as one record, and the device stage stages the rows
without any per-op Python — this is what takes the generic-wire pipeline
path from single-digit-k to 100k+ ops/s.

The JSON per-op wire remains the compat path: frames are additive, and a
frame-ignorant consumer that filters on ``value["t"] == "seq"`` simply
never sees one (frames carry only OPERATION-type string ops — joins,
leaves, summaries, and every other DDS still ride the JSON wire).
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from fluidframework_tpu_torch.protocol.constants import (
    F_ARG,
    F_CLIENT,
    F_LEN,
    F_MSN,
    F_POS1,
    F_POS2,
    F_REF,
    F_SEQ,
    F_TYPE,
    OP_ANNOTATE,
    OP_INSERT,
    OP_REMOVE,
    OP_WIDTH,
)
from fluidframework_tpu_torch.protocol.types import (
    DocumentMessage,
    MessageType,
    SequencedDocumentMessage,
)

_RAW_MAGIC = 0x4F463152  # 'OF1R' little-endian-ish tag, raw frame
_SEQ_MAGIC = 0x4F463153  # sequenced frame


def row_contents(r: np.ndarray, texts: Sequence[str], text_idx: int) -> dict:
    """Decode ONE kernel row back to per-op wire contents — the single
    row→contents switch shared by SeqFrame expansion and any transport
    fallback (``text_idx`` is the row's ordinal among the frame's
    inserts; ignored for rem/ann)."""
    ty = int(r[F_TYPE])
    if ty == OP_INSERT:
        return {"k": "ins", "pos": int(r[F_POS1]),
                "text": texts[text_idx], "orig": int(r[F_ARG])}
    if ty == OP_REMOVE:
        return {"k": "rem", "start": int(r[F_POS1]), "end": int(r[F_POS2])}
    assert ty == OP_ANNOTATE, ty
    return {"k": "ann", "start": int(r[F_POS1]), "end": int(r[F_POS2]),
            "val": int(r[F_ARG])}


class OpFrame:
    """Client→service batch: n contiguous string-kernel ops from one
    client on one channel.

    ``rows`` is ``[n, OP_WIDTH] int32`` in the kernel-row layout with the
    fields the client owns filled in (type, pos1, pos2, arg, len, ref)
    and ``F_SEQ`` carrying the clientSequenceNumber (deli replaces it
    with the assigned total-order stamp); ``texts`` holds insert payload
    strings aligned, in row order, with the insert rows.
    """

    __slots__ = ("address", "rows", "texts")

    def __init__(self, address: str, rows: np.ndarray, texts: Tuple[str, ...]):
        assert rows.ndim == 2 and rows.shape[1] == OP_WIDTH, rows.shape
        self.address = address
        self.rows = rows
        self.texts = texts

    @property
    def n(self) -> int:
        return self.rows.shape[0]

    @property
    def csn0(self) -> int:
        return int(self.rows[0, F_SEQ])

    @classmethod
    def build(
        cls,
        address: str,
        kinds: Sequence[str],
        a: Sequence[int],
        b: Sequence[int],
        texts_or_vals: Sequence,
        csn0: int,
        ref: int,
    ) -> "OpFrame":
        """Vectorized builder: ``kinds[i]`` in {ins, rem, ann};
        ins: (pos, orig, text); rem: (start, end, _); ann: (start, end, val).
        All ops share one refSeq (the common case for a client-turn batch)."""
        n = len(kinds)
        rows = np.zeros((n, OP_WIDTH), np.int32)
        km = {"ins": OP_INSERT, "rem": OP_REMOVE, "ann": OP_ANNOTATE}
        types = np.fromiter((km[k] for k in kinds), np.int32, n)
        rows[:, F_TYPE] = types
        rows[:, F_POS1] = np.asarray(a, np.int32)
        texts: List[str] = []
        bs = np.asarray(b, np.int32)
        for i, k in enumerate(kinds):
            if k == "ins":
                rows[i, F_ARG] = bs[i]
                t = texts_or_vals[i]
                rows[i, F_LEN] = len(t)
                texts.append(t)
            elif k == "rem":
                rows[i, F_POS2] = bs[i]
            else:
                rows[i, F_POS2] = bs[i]
                rows[i, F_ARG] = texts_or_vals[i]
        rows[:, F_SEQ] = csn0 + np.arange(n, dtype=np.int32)
        rows[:, F_REF] = ref
        return cls(address, rows, tuple(texts))

    @classmethod
    def from_messages(
        cls, msgs: Sequence[DocumentMessage]
    ) -> Optional["OpFrame"]:
        """Lower a batch of per-op JSON-wire messages into one frame, or
        None if the batch is not frame-eligible (non-string ops, mixed
        addresses, non-contiguous clientSequenceNumbers). The client-side
        adapter for drivers that batch at the connection."""
        if not msgs:
            return None
        address = None
        kinds, a, b, tv, refs, csns = [], [], [], [], [], []
        for m in msgs:
            if m.type != MessageType.OPERATION:
                return None
            env = m.contents
            if not isinstance(env, dict) or "address" not in env:
                return None
            if address is None:
                address = env["address"]
            elif env["address"] != address:
                return None
            c = env.get("contents")
            if not isinstance(c, dict):
                return None
            k = c.get("k")
            if k == "ins":
                kinds.append("ins")
                a.append(c["pos"])
                b.append(c["orig"])
                tv.append(c["text"])
            elif k == "rem":
                kinds.append("rem")
                a.append(c["start"])
                b.append(c["end"])
                tv.append(None)
            elif k == "ann":
                kinds.append("ann")
                a.append(c["start"])
                b.append(c["end"])
                tv.append(c["val"])
            else:
                return None
            refs.append(m.reference_sequence_number)
            csns.append(m.client_sequence_number)
        if csns != list(range(csns[0], csns[0] + len(csns))):
            return None
        f = cls.build(address, kinds, a, b, tv, csns[0], refs[0])
        f.rows[:, F_REF] = np.asarray(refs, np.int32)
        return f

    def encode(self) -> bytes:
        """Length-prefixed planar binary form for the socket wire."""
        return _encode(_RAW_MAGIC, self.address, self.rows, self.texts)

    @classmethod
    def decode(cls, buf: bytes) -> "OpFrame":
        magic, address, rows, texts = _decode(buf)
        assert magic == _RAW_MAGIC, hex(magic)
        return cls(address, rows, texts)


class SeqFrame:
    """Service→consumers batch: a frame deli has ticketed. ``rows`` is
    fully stamped (seq, msn, client); seqs are contiguous. Consumers that
    need per-op ``SequencedDocumentMessage`` views (interactive clients,
    catch-up reads, moira) expand lazily via :meth:`message` — the
    service hot path never does."""

    __slots__ = ("address", "client_id", "csn0", "rows", "texts", "timestamp")

    def __init__(
        self,
        address: str,
        client_id: int,
        csn0: int,
        rows: np.ndarray,
        texts: Tuple[str, ...],
        timestamp: float,
    ):
        self.address = address
        self.client_id = client_id
        self.csn0 = csn0
        self.rows = rows
        self.texts = texts
        self.timestamp = timestamp

    @property
    def n(self) -> int:
        return self.rows.shape[0]

    @property
    def first_seq(self) -> int:
        return int(self.rows[0, F_SEQ])

    @property
    def last_seq(self) -> int:
        return int(self.rows[-1, F_SEQ])

    def _batch_meta(self, i: int) -> Optional[dict]:
        """A frame IS one client batch: per-op expansion re-synthesizes
        the batchBegin/batchEnd marks the JSON wire would have carried
        (op_lifecycle.pack_batch), so inbound batch atomicity
        (ScheduleManager semantics) survives the frame wire."""
        if self.n < 2:
            return None
        meta = {}
        if i == 0:
            meta["batchBegin"] = True
        if i == self.n - 1:
            meta["batchEnd"] = True
        return meta or None

    def message(self, i: int) -> SequencedDocumentMessage:
        """Expand op ``i`` to the per-op wire form (compat view)."""
        ti = int(np.count_nonzero(self.rows[:i, F_TYPE] == OP_INSERT))
        r = self.rows[i]
        return SequencedDocumentMessage(
            client_id=self.client_id,
            sequence_number=int(r[F_SEQ]),
            client_sequence_number=self.csn0 + i,
            reference_sequence_number=int(r[F_REF]),
            minimum_sequence_number=int(r[F_MSN]),
            type=MessageType.OPERATION,
            contents={"address": self.address,
                      "contents": row_contents(r, self.texts, ti)},
            metadata=self._batch_meta(i),
            timestamp=self.timestamp,
        )

    def messages(self, start: int = 0) -> List[SequencedDocumentMessage]:
        ti = int(np.count_nonzero(self.rows[:start, F_TYPE] == OP_INSERT))
        out = []
        for i in range(start, self.n):
            r = self.rows[i]
            c = row_contents(r, self.texts, ti)
            if int(r[F_TYPE]) == OP_INSERT:
                ti += 1
            out.append(SequencedDocumentMessage(
                client_id=self.client_id,
                sequence_number=int(r[F_SEQ]),
                client_sequence_number=self.csn0 + i,
                reference_sequence_number=int(r[F_REF]),
                minimum_sequence_number=int(r[F_MSN]),
                type=MessageType.OPERATION,
                contents={"address": self.address, "contents": c},
                metadata=self._batch_meta(i),
                timestamp=self.timestamp,
            ))
        return out

    def insert_payloads(self) -> Tuple[np.ndarray, Tuple[str, ...]]:
        """(origs, texts) for the frame's inserts — what the device stage
        records into the channel payload dict."""
        mask = self.rows[:, F_TYPE] == OP_INSERT
        return self.rows[mask, F_ARG], self.texts

    def encode(self) -> bytes:
        head = struct.pack("<iid", self.client_id, self.csn0, self.timestamp)
        return head + _encode(_SEQ_MAGIC, self.address, self.rows, self.texts)

    @classmethod
    def decode(cls, buf: bytes) -> "SeqFrame":
        client_id, csn0, ts = struct.unpack_from("<iid", buf, 0)
        magic, address, rows, texts = _decode(buf[16:])
        assert magic == _SEQ_MAGIC, hex(magic)
        return cls(address, client_id, csn0, rows, texts, ts)


def _encode(
    magic: int, address: str, rows: np.ndarray, texts: Tuple[str, ...]
) -> bytes:
    addr = address.encode()
    enc = [t.encode() for t in texts]
    lens = np.fromiter((len(e) for e in enc), np.int32, len(enc))
    blob = b"".join(enc)
    head = struct.pack(
        "<iiiii", magic, len(addr), rows.shape[0], len(texts), len(blob)
    )
    return (
        head + addr + np.ascontiguousarray(rows, np.int32).tobytes()
        + lens.tobytes() + blob
    )


def _decode(buf: bytes) -> Tuple[int, str, np.ndarray, Tuple[str, ...]]:
    magic, alen, n, ntext, bloblen = struct.unpack_from("<iiiii", buf, 0)
    off = 20
    address = buf[off : off + alen].decode()
    off += alen
    nbytes = n * OP_WIDTH * 4
    rows = np.frombuffer(
        buf[off : off + nbytes], np.int32
    ).reshape(n, OP_WIDTH).copy()
    off += nbytes
    lens = np.frombuffer(buf[off : off + ntext * 4], np.int32)
    off += ntext * 4
    texts = []
    for ln in lens.tolist():
        texts.append(buf[off : off + ln].decode())
        off += ln
    assert off == 20 + alen + nbytes + ntext * 4 + bloblen
    return magic, address, rows, tuple(texts)
