"""Compact binary snapshot format — the odsp-driver's wire encoding.

Reference: ``packages/drivers/odsp-driver`` ships snapshots in a compact
binary format with its own buffer reader/writer and parser
(``WriteBufferUtils.ts``, ``ReadBufferUtils.ts``,
``compactSnapshotParser.ts``) instead of JSON — the dominant cost of a
cold load at scale is snapshot bytes on the wire.

This codec serializes the runtime's summary dicts (and any JSON-able
value) into a length-delimited binary stream:

- varint (LEB128) lengths and integers — small ints cost one byte;
- type-tagged nodes: null/false/true, int, float, str (utf-8), bytes,
  list, dict (sorted keys for determinism);
- int32 ARRAYS (the segment-table lanes — the bulk of a kernel snapshot)
  get a dedicated packed tag: 4 bytes per element instead of JSON's
  ~6-12 chars, decoded straight into numpy.

Determinism: equal values encode to identical bytes, so binary snapshot
blobs content-address exactly like the JSON ones.

Counterpart of ``fluidframework_tpu/drivers/binary_snapshot.py``: equal
values encode to the same bytes in both packages. Summaries hold Python
values (the merge-tree DDSes read their lanes back with ``.tolist()``),
so a tensor reaching the encoder is a fault upstream: it raises
``TypeError`` naming the tensor, as any other unencodable value does,
rather than being converted.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

_T_NULL = 0
_T_FALSE = 1
_T_TRUE = 2
_T_INT = 3  # zigzag varint
_T_FLOAT = 4  # f64
_T_STR = 5
_T_BYTES = 6
_T_LIST = 7
_T_DICT = 8
_T_I32ARR = 9  # packed int32 little-endian


def _varint(n: int, out: bytearray) -> None:
    assert n >= 0
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _zigzag(n: int) -> int:
    # Arbitrary precision (Python ints are unbounded; a fixed-width shift
    # would silently corrupt values outside int64).
    return -2 * n - 1 if n < 0 else 2 * n


def _unzigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def _is_i32_list(v: list) -> bool:
    return (
        len(v) > 8
        and all(
            type(x) is int and -(2**31) <= x < 2**31 for x in v
        )
    )


def _encode(v: Any, out: bytearray) -> None:
    if v is None:
        out.append(_T_NULL)
    elif v is True:
        out.append(_T_TRUE)
    elif v is False:
        out.append(_T_FALSE)
    elif isinstance(v, int):
        out.append(_T_INT)
        _varint(_zigzag(v), out)
    elif isinstance(v, float):
        out.append(_T_FLOAT)
        out.extend(struct.pack("<d", v))
    elif isinstance(v, str):
        b = v.encode()
        out.append(_T_STR)
        _varint(len(b), out)
        out.extend(b)
    elif isinstance(v, (bytes, bytearray)):
        out.append(_T_BYTES)
        _varint(len(v), out)
        out.extend(v)
    elif isinstance(v, (list, tuple)):
        v = list(v)
        if _is_i32_list(v):
            out.append(_T_I32ARR)
            _varint(len(v), out)
            out.extend(np.asarray(v, "<i4").tobytes())
        else:
            out.append(_T_LIST)
            _varint(len(v), out)
            for x in v:
                _encode(x, out)
    elif isinstance(v, dict):
        out.append(_T_DICT)
        _varint(len(v), out)
        for k in sorted(v, key=str):
            kb = str(k).encode()
            _varint(len(kb), out)
            out.extend(kb)
            _encode(v[k], out)
    elif isinstance(v, torch.Tensor):
        raise TypeError(
            f"unencodable torch.Tensor (dtype {v.dtype}, device {v.device}): "
            "summaries hold Python values; read a tensor back with .tolist()"
        )
    else:
        raise TypeError(f"unencodable {type(v).__name__}")


def encode_snapshot(value: Any) -> bytes:
    """Value -> compact binary (b'FTS1' magic + node stream)."""
    out = bytearray(b"FTS1")
    _encode(value, out)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.d = data
        self.i = 0

    def varint(self) -> int:
        n = 0
        shift = 0
        while True:
            if self.i >= len(self.d):
                raise ValueError("truncated snapshot (varint)")
            b = self.d[self.i]
            self.i += 1
            n |= (b & 0x7F) << shift
            if not b & 0x80:
                return n
            shift += 7

    def take(self, n: int) -> bytes:
        b = self.d[self.i : self.i + n]
        if len(b) != n:
            raise ValueError("truncated snapshot")
        self.i += n
        return b

    def node(self) -> Any:
        if self.i >= len(self.d):
            raise ValueError("truncated snapshot (node)")
        t = self.d[self.i]
        self.i += 1
        if t == _T_NULL:
            return None
        if t == _T_FALSE:
            return False
        if t == _T_TRUE:
            return True
        if t == _T_INT:
            return _unzigzag(self.varint())
        if t == _T_FLOAT:
            return struct.unpack("<d", self.take(8))[0]
        if t == _T_STR:
            return self.take(self.varint()).decode()
        if t == _T_BYTES:
            return bytes(self.take(self.varint()))
        if t == _T_LIST:
            return [self.node() for _ in range(self.varint())]
        if t == _T_I32ARR:
            n = self.varint()
            return [
                int(x) for x in np.frombuffer(self.take(4 * n), "<i4")
            ]
        if t == _T_DICT:
            n = self.varint()
            out = {}
            for _ in range(n):
                k = self.take(self.varint()).decode()
                out[k] = self.node()
            return out
        raise ValueError(f"bad tag {t}")


def decode_snapshot(data: bytes) -> Any:
    # Explicit raises, not asserts: this decodes UNTRUSTED persisted bytes
    # and must keep validating under `python -O`.
    if data[:4] != b"FTS1":
        raise ValueError("not a compact snapshot")
    r = _Reader(data)
    r.i = 4
    out = r.node()
    if r.i != len(data):
        raise ValueError("trailing bytes in snapshot")
    return out
