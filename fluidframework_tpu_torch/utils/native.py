"""ctypes binding for the native deli ticket loop (``native/ticket_loop.cpp``).

The library is compiled with ``g++`` from the repository's ``native/``
source into this package's own ``_build/`` directory (listed in
``.gitignore``), named by the source's content hash so an edited source
never loads a stale build; nothing is written into ``native/``. When the
compiler or the source is missing, :class:`NativeTicketLoop` reports
``available = False`` and the caller takes its Python fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TICKET_SOURCE = os.path.join(os.path.dirname(_PKG), "native", "ticket_loop.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")

_ticket_lib: Optional[ctypes.CDLL] = None
_ticket_tried = False


def _build_ticket() -> Optional[str]:
    if not os.path.exists(TICKET_SOURCE) or shutil.which("g++") is None:
        return None
    with open(TICKET_SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"libticket-{digest}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    res = subprocess.run(
        ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp,
         TICKET_SOURCE],
        capture_output=True, timeout=120,
    )
    if res.returncode != 0:
        return None
    os.replace(tmp, so)
    return so


def _load_ticket() -> Optional[ctypes.CDLL]:
    global _ticket_lib, _ticket_tried
    if not _ticket_tried:
        _ticket_tried = True
        so = _build_ticket()
        try:
            lib = ctypes.CDLL(so) if so is not None else None
        except OSError:  # a build from another machine's toolchain
            lib = None
        if lib is not None:
            lib.ticket_batch.restype = ctypes.c_int32
            lib.ticket_batch.argtypes = [
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p,
            ]
            _ticket_lib = lib
    return _ticket_lib


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
