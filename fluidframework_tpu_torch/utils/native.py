"""ctypes bindings for the native (C++) host components.

Counterpart of ``fluidframework_tpu/utils/native.py``: the deli ticket
loop (``native/ticket_loop.cpp``), the content-addressed blob store
(``native/ca_store.cpp``), the disk-backed partition log
(``native/partition_log.cpp``) and the lease coordination of multi-node
ordering (``native/coordination.cpp``).

Each library is compiled with ``g++`` and the flags of ``native/Makefile``
from the repository's ``native/`` source into this package's own
``_build/`` directory (listed in ``.gitignore``), one library per source,
named by the hash of the source and the flags so an edited source never
loads a stale build; nothing is written into ``native/``. When the compiler
or the source is missing, :class:`NativeTicketLoop` reports ``available =
False`` and its caller takes the Python path, while
:class:`NativeBlobStore`, :class:`NativePartitionLog` and
:class:`NativeCoordination` raise ``RuntimeError`` (probe with
:func:`native_store_available`, :func:`native_plog_available` and
:func:`native_coordination_available`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Optional, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(os.path.dirname(_PKG), "native")
BUILD_DIR = os.path.join(_PKG, "_build")
# native/Makefile's CXXFLAGS plus its -shared.
CXXFLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-shared")

_libs: Dict[str, Optional[ctypes.CDLL]] = {}  # None = tried and failed


def _build(source: str, lib_name: str) -> Optional[str]:
    """Compile ``native/<source>`` into ``_build/<lib_name>-<hash>.so``;
    the path, or None when the source or ``g++`` is missing or the build
    fails."""
    src = os.path.join(NATIVE_DIR, source)
    if not os.path.exists(src) or shutil.which("g++") is None:
        return None
    with open(src, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(CXXFLAGS).encode()
        ).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"{lib_name}-{digest}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    res = subprocess.run(
        ["g++", *CXXFLAGS, "-o", tmp, src], capture_output=True, timeout=120,
    )
    if res.returncode != 0:
        return None
    os.replace(tmp, so)
    return so


def _load(source: str, lib_name: str, declare) -> Optional[ctypes.CDLL]:
    """Build (once per process), load and declare one library; cached."""
    if lib_name not in _libs:
        so = _build(source, lib_name)
        try:
            lib = ctypes.CDLL(so) if so is not None else None
        except OSError:  # a build from another machine's toolchain
            lib = None
        if lib is not None:
            declare(lib)
        _libs[lib_name] = lib
    return _libs[lib_name]


# -- batch deli ticket loop (native/ticket_loop.cpp) -------------------------


def _declare_ticket(lib: ctypes.CDLL) -> None:
    lib.ticket_batch.restype = ctypes.c_int32
    lib.ticket_batch.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
    ]


def _load_ticket() -> Optional[ctypes.CDLL]:
    return _load("ticket_loop.cpp", "libticket", _declare_ticket)


class NativeTicketLoop:
    """Fleet-wide deli ticketing in C++ (the steady-state write-client fast
    path; see native/ticket_loop.cpp for the contract). Documents flagged
    in ``err`` must replay through a slow path that owns nacks."""

    def __init__(self):
        self._lib = _load_ticket()

    @property
    def available(self) -> bool:
        return self._lib is not None

    def ticket_batch(self, doc_state, clients, ops, out, err) -> int:
        """All arrays C-contiguous int32 numpy, shapes per ticket_loop.cpp.
        Returns the number of documents that need the slow path."""
        n_docs, k, _ = ops.shape
        max_writers = clients.shape[1]
        for a in (doc_state, clients, ops, out, err):
            if a.dtype != np.int32 or not a.flags.c_contiguous:
                raise ValueError("ticket arrays must be C-contiguous int32")
        if (doc_state.shape != (n_docs, 2) or out.shape != (n_docs, k, 2)
                or err.shape != (n_docs,) or clients.shape[0] != n_docs
                or clients.shape[2] != 3):
            raise ValueError("ticket array shapes disagree")
        return int(
            self._lib.ticket_batch(
                n_docs, k, max_writers,
                doc_state.ctypes.data, clients.ctypes.data,
                ops.ctypes.data, out.ctypes.data, err.ctypes.data,
            )
        )


# -- content-addressed blob store (native/ca_store.cpp) ----------------------


def _declare_castore(lib: ctypes.CDLL) -> None:
    lib.castore_new.restype = ctypes.c_void_p
    lib.castore_new.argtypes = [ctypes.c_char_p]
    lib.castore_free.argtypes = [ctypes.c_void_p]
    lib.castore_put.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
    ]
    lib.castore_size.restype = ctypes.c_int64
    lib.castore_size.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.castore_get.restype = ctypes.c_int64
    lib.castore_get.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t,
    ]
    lib.castore_has.restype = ctypes.c_int
    lib.castore_has.argtypes = [ctypes.c_void_p, ctypes.c_char_p]


def _load_castore() -> Optional[ctypes.CDLL]:
    return _load("ca_store.cpp", "libcastore", _declare_castore)


class NativeBlobStore:
    """C++ content-addressed blob store, in memory or persisted under
    ``directory`` as ``<dir>/ab/<hex>`` (raises if the library cannot be
    built — use :func:`native_store_available` to probe). Handles are the
    blobs' SHA-256, the same as the dict backend's."""

    def __init__(self, directory: Optional[str] = None):
        lib = _load_castore()
        if lib is None:
            raise RuntimeError("libcastore unavailable (native/ca_store.cpp "
                               "did not build)")
        self._lib = lib
        self._h = lib.castore_new(directory.encode() if directory else None)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.castore_free(self._h)
            self._h = None

    def put_blob(self, data: bytes) -> str:
        out = ctypes.create_string_buffer(65)
        self._lib.castore_put(self._h, data, len(data), out)
        return out.value.decode()

    def get_blob(self, handle: str) -> bytes:
        n = self._lib.castore_size(self._h, handle.encode())
        if n < 0:
            raise KeyError(handle)
        buf = ctypes.create_string_buffer(max(int(n), 1))
        got = self._lib.castore_get(self._h, handle.encode(), buf, n)
        if got != n:
            raise RuntimeError(f"blob {handle} changed size mid-read")
        return buf.raw[:n]

    def has(self, handle: str) -> bool:
        return bool(self._lib.castore_has(self._h, handle.encode()))


def native_ticket_available() -> bool:
    """Whether the native ticket loop builds and loads here."""
    return _load_ticket() is not None


def native_store_available() -> bool:
    return _load_castore() is not None


# -- disk-backed partition log (native/partition_log.cpp) --------------------


def _declare_plog(lib: ctypes.CDLL) -> None:
    lib.plog_new.restype = ctypes.c_void_p
    lib.plog_new.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.plog_free.argtypes = [ctypes.c_void_p]
    lib.plog_partition.restype = ctypes.c_int
    lib.plog_partition.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.plog_send.restype = ctypes.c_int64
    lib.plog_send.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_size_t,
    ]
    lib.plog_end_offset.restype = ctypes.c_int64
    lib.plog_end_offset.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.plog_value_size.restype = ctypes.c_int64
    lib.plog_value_size.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int64,
    ]
    lib.plog_key_size.restype = ctypes.c_int64
    lib.plog_key_size.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int64,
    ]
    lib.plog_read.restype = ctypes.c_int64
    lib.plog_read.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t,
    ]
    lib.plog_commit.restype = ctypes.c_int
    lib.plog_commit.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_int64,
    ]
    lib.plog_committed.restype = ctypes.c_int64
    lib.plog_committed.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
    ]


def _load_plog() -> Optional[ctypes.CDLL]:
    return _load("partition_log.cpp", "libplog", _declare_plog)


class NativePartitionLog:
    """C++ disk-persistent partitioned log + consumer offsets
    (``native/partition_log.cpp`` — the kafka-broker durability role).
    Framed appends fflush per record; a restarted process reloads every
    partition file and the commit table. The CRC32 partitioner matches
    ``service.queue.partition_of`` exactly (same polynomial), so native
    and Python routing agree on every key."""

    def __init__(self, directory: Optional[str], n_partitions: int):
        lib = _load_plog()
        if lib is None:
            raise RuntimeError("libplog unavailable (native/partition_log.cpp "
                               "did not build)")
        self._lib = lib
        self._h = lib.plog_new(
            directory.encode() if directory else None, n_partitions
        )

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.plog_free(self._h)
            self._h = None

    def send(self, topic: str, key: str, value: bytes) -> Tuple[int, int]:
        """Append; returns (partition, offset)."""
        p = self._lib.plog_partition(self._h, key.encode())
        off = self._lib.plog_send(
            self._h, topic.encode(), key.encode(), value, len(value)
        )
        return int(p), int(off)

    def end_offset(self, topic: str, partition: int) -> int:
        return int(
            self._lib.plog_end_offset(self._h, topic.encode(), partition)
        )

    def read(
        self, topic: str, partition: int, offset: int
    ) -> Optional[Tuple[str, bytes]]:
        t = topic.encode()
        vn = self._lib.plog_value_size(self._h, t, partition, offset)
        kn = self._lib.plog_key_size(self._h, t, partition, offset)
        if vn < 0 or kn < 0:
            return None
        kbuf = ctypes.create_string_buffer(max(int(kn), 1))
        vbuf = ctypes.create_string_buffer(max(int(vn), 1))
        got = self._lib.plog_read(
            self._h, t, partition, offset, kbuf, kn, vbuf, vn
        )
        if got != vn:
            raise RuntimeError("record changed size mid-read")
        return kbuf.raw[:kn].decode(), vbuf.raw[:vn]

    def commit(self, group: str, topic: str, partition: int,
               offset: int) -> None:
        self._lib.plog_commit(
            self._h, group.encode(), topic.encode(), partition, offset
        )

    def committed(self, group: str, topic: str, partition: int) -> int:
        return int(
            self._lib.plog_committed(
                self._h, group.encode(), topic.encode(), partition
            )
        )


def native_plog_available() -> bool:
    return _load_plog() is not None


# -- lease coordination (native/coordination.cpp) ----------------------------


def _declare_coord(lib: ctypes.CDLL) -> None:
    lib.coord_new.restype = ctypes.c_void_p
    lib.coord_new.argtypes = [ctypes.c_char_p]
    lib.coord_free.argtypes = [ctypes.c_void_p]
    lib.coord_acquire.restype = ctypes.c_int64
    lib.coord_acquire.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_int64, ctypes.c_int64,
    ]
    lib.coord_renew.restype = ctypes.c_int
    lib.coord_renew.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_int64, ctypes.c_int64,
    ]
    lib.coord_holder.restype = ctypes.c_int64
    lib.coord_holder.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_size_t,
    ]
    lib.coord_epoch.restype = ctypes.c_int64
    lib.coord_epoch.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.coord_release.restype = ctypes.c_int
    lib.coord_release.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64,
    ]


def _load_coord() -> Optional[ctypes.CDLL]:
    return _load("coordination.cpp", "libcoord", _declare_coord)


class NativeCoordination:
    """C++ lease coordination (the ZooKeeper-client equivalent): fenced
    epochs per document, a caller-supplied clock (seconds, passed to the
    library in ms) and optional append-log durability under ``path``. The
    same surface as ``service.pipeline.ReservationManager``; raises if
    the library cannot be built."""

    def __init__(self, clock, path: Optional[str] = None):
        lib = _load_coord()
        if lib is None:
            raise RuntimeError("libcoord unavailable (native/coordination.cpp "
                               "did not build)")
        self._lib = lib
        self._clock = clock
        self._h = lib.coord_new(path.encode() if path else None)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.coord_free(self._h)
            self._h = None

    def _now_ms(self) -> int:
        return int(self._clock() * 1000)

    def acquire(self, node: str, doc_id: str, ttl_s: float) -> Optional[int]:
        epoch = self._lib.coord_acquire(
            self._h, node.encode(), doc_id.encode(),
            int(ttl_s * 1000), self._now_ms(),
        )
        return int(epoch) if epoch > 0 else None

    def renew(self, node: str, doc_id: str, ttl_s: float) -> bool:
        return bool(
            self._lib.coord_renew(
                self._h, node.encode(), doc_id.encode(),
                int(ttl_s * 1000), self._now_ms(),
            )
        )

    def holder(self, doc_id: str) -> Optional[str]:
        out = ctypes.create_string_buffer(256)
        n = self._lib.coord_holder(
            self._h, doc_id.encode(), self._now_ms(), out, 256
        )
        return out.raw[:n].decode() if n >= 0 else None

    def release(self, node: str, doc_id: str) -> bool:
        """Voluntary surrender for load migration (fenced like a TTL lapse:
        the next acquire bumps the epoch)."""
        return bool(
            self._lib.coord_release(
                self._h, node.encode(), doc_id.encode(), self._now_ms()
            )
        )

    def epoch(self, doc_id: str) -> int:
        return int(self._lib.coord_epoch(self._h, doc_id.encode()))


def native_coordination_available() -> bool:
    return _load_coord() is not None
