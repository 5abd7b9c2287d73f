"""Build and load the hand-written Hopper kernels (``csrc/merge_kernels.cu``).

The source compiles with ``nvcc`` into a shared library with a plain C
interface, at first use, into the package's ``_build/`` directory (listed
in ``.gitignore``); the library is named by the source's content hash, so
an edited source never loads a stale build. It is loaded with ``ctypes``:
pointers are ``c_void_p``, the stream is PyTorch's current CUDA stream,
and every entry returns ``cudaGetLastError()``, which :func:`launch` turns
into an exception. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "merge_kernels.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH = "arch=compute_90a,code=sm_90a"
# Largest table (rows per document) whose lanes fit one CTA's shared
# memory; must equal MAX_CAP in merge_kernels.cu.
MAX_CAPACITY = 2048

_lib: Optional[ctypes.CDLL] = None
build_log = ""  # ptxas report of the last build (registers, smem, spills)


def _nvcc() -> str:
    cands = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        cands.insert(0, os.path.join(home, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> str:
    """Compile the kernels if no build of this source exists; return the
    library path. Concurrent builds each write a private temp file and
    rename it into place."""
    global build_log
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"libmerge_kernels-{digest}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [
        _nvcc(), "-gencode", ARCH, "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, SOURCE,
    ]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}"
        )
    build_log = res.stderr
    os.replace(tmp, so)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        cdll = ctypes.CDLL(build())
        p, i = ctypes.c_void_p, ctypes.c_int
        for name, args in (
            ("merge_apply", [p, p, p, p, p, i, i, i, p]),
            ("merge_compact", [p, p, p, p, i, i, p]),
            ("merge_apply_compact", [p, p, p, p, p, i, i, i, p]),
        ):
            fn = getattr(cdll, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        cdll.merge_max_capacity.argtypes = []
        cdll.merge_max_capacity.restype = ctypes.c_int
        cdll.merge_error_string.argtypes = [ctypes.c_int]
        cdll.merge_error_string.restype = ctypes.c_char_p
        if cdll.merge_max_capacity() != MAX_CAPACITY:
            raise RuntimeError("merge_kernels.cu MAX_CAP != MAX_CAPACITY")
        _lib = cdll
    return _lib


def check_packed(tables, scalars, ops=None) -> None:
    """Validate a packed CUDA state (and op batch) before a launch."""
    from fluidframework_tpu_torch.ops.apply_kernel import N_LANES, N_SCALARS
    from fluidframework_tpu_torch.protocol.constants import OP_WIDTH

    ts = [tables, scalars] + ([ops] if ops is not None else [])
    for t in ts:
        if t.device.type != "cuda" or t.dtype != torch.int32:
            raise ValueError("kernel inputs must be int32 CUDA tensors")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    if len({t.device for t in ts}) != 1:
        raise ValueError("kernel inputs must share one device")
    if tables.dim() != 3 or tables.shape[0] != N_LANES:
        raise ValueError(f"tables must be [{N_LANES}, D, S], got "
                         f"{tuple(tables.shape)}")
    d, s = tables.shape[1], tables.shape[2]
    if tuple(scalars.shape) != (d, N_SCALARS):
        raise ValueError(f"scalars must be [{d}, {N_SCALARS}]")
    if ops is not None and (ops.dim() != 3 or ops.shape[0] != d
                            or ops.shape[2] != OP_WIDTH):
        raise ValueError(f"ops must be [{d}, K, {OP_WIDTH}]")
    if s > MAX_CAPACITY:
        raise ValueError(
            f"capacity tier {s} exceeds the shared-memory tier "
            f"(<= {MAX_CAPACITY} rows per document); the global-memory "
            "tiers are not ported yet"
        )


def launch(name: str, device: torch.device, *args) -> None:
    """Call one C entry on PyTorch's current stream of ``device``; raise on
    a CUDA error (a refused launch never runs, and a later synchronize
    would not say so)."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib(), name)(*args, stream)
    if err != 0:
        msg = lib().merge_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")
