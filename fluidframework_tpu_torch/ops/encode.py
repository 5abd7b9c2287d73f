"""Functions that make int32 kernel op rows (the device-side op encoding).

A copy of ``fluidframework_tpu/ops/encode.py`` (the port imports nothing of
the reference package): the same rows, field for field.
"""

from __future__ import annotations

import numpy as np

from fluidframework_tpu_torch.protocol.constants import (
    F_ARG,
    F_CLIENT,
    F_LEN,
    F_LSEQ,
    F_MSN,
    F_POS1,
    F_POS2,
    F_REF,
    F_SEQ,
    F_TYPE,
    OP_ACK_ANNOTATE,
    OP_ACK_INSERT,
    OP_ACK_REMOVE,
    OP_ANNOTATE,
    OP_INSERT,
    OP_NOOP,
    OP_REMOVE,
    OP_WIDTH,
    UNASSIGNED_SEQ,
)


def _row(fields: dict) -> np.ndarray:
    r = np.zeros((OP_WIDTH,), np.int32)
    for k, v in fields.items():
        r[k] = v
    return r


def noop(msn: int = 0, seq: int = 0) -> np.ndarray:
    return _row({F_TYPE: OP_NOOP, F_SEQ: seq, F_MSN: msn})


def insert(
    pos: int,
    orig: int,
    length: int,
    *,
    seq: int = UNASSIGNED_SEQ,
    ref: int = 0,
    client: int = 0,
    lseq: int = 0,
    msn: int = 0,
) -> np.ndarray:
    return _row(
        {
            F_TYPE: OP_INSERT,
            F_POS1: pos,
            F_SEQ: seq,
            F_REF: ref,
            F_CLIENT: client,
            F_LSEQ: lseq,
            F_ARG: orig,
            F_LEN: length,
            F_MSN: msn,
        }
    )


def remove(
    start: int,
    end: int,
    *,
    seq: int = UNASSIGNED_SEQ,
    ref: int = 0,
    client: int = 0,
    lseq: int = 0,
    msn: int = 0,
) -> np.ndarray:
    return _row(
        {
            F_TYPE: OP_REMOVE,
            F_POS1: start,
            F_POS2: end,
            F_SEQ: seq,
            F_REF: ref,
            F_CLIENT: client,
            F_LSEQ: lseq,
            F_MSN: msn,
        }
    )


def annotate(
    start: int,
    end: int,
    value: int,
    *,
    seq: int = UNASSIGNED_SEQ,
    ref: int = 0,
    client: int = 0,
    lseq: int = 0,
    msn: int = 0,
) -> np.ndarray:
    return _row(
        {
            F_TYPE: OP_ANNOTATE,
            F_POS1: start,
            F_POS2: end,
            F_SEQ: seq,
            F_REF: ref,
            F_CLIENT: client,
            F_LSEQ: lseq,
            F_ARG: value,
            F_MSN: msn,
        }
    )


def ack(kind: str, lseq: int, seq: int, msn: int = 0) -> np.ndarray:
    ty = {
        "insert": OP_ACK_INSERT,
        "remove": OP_ACK_REMOVE,
        "annotate": OP_ACK_ANNOTATE,
    }[kind]
    return _row({F_TYPE: ty, F_LSEQ: lseq, F_SEQ: seq, F_MSN: msn})


def pad_batch(rows: list, k: int) -> np.ndarray:
    """Pad a list of op rows to [k, OP_WIDTH] with NOOPs."""
    out = np.zeros((k, OP_WIDTH), np.int32)
    for i, r in enumerate(rows):
        out[i] = r
    return out
