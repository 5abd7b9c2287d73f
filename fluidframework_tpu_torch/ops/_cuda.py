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
# memory (the shared tier); must equal SMEM_MAX_CAP in merge_kernels.cu.
SMEM_MAX_CAPACITY = 2048
# Largest table the kernels split across a thread-block cluster's shared
# memory (the cluster tier, at most 16 CTAs of 1,024 rows); CLUSTER_MAX_CAP
# there.
CLUSTER_MAX_CAPACITY = 16384
# Largest table the kernels take at all (the global tier above the others;
# the reference fleet's max_capacity); must equal MAX_CAP there.
MAX_CAPACITY = 65536
# The C entries' tier argument.
TIER_CODES = {"smem": 0, "cluster": 1, "global": 2}
ENTRIES = ("merge_apply", "merge_compact", "merge_apply_compact")

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
    library path. Concurrent builds each write private temp files and
    rename them into place. The ptxas report is kept beside the library,
    so :data:`build_log` holds it after a reused build too."""
    global build_log
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"libmerge_kernels-{digest}.so")
    log = os.path.join(BUILD_DIR, f"libmerge_kernels-{digest}.ptxas")
    if os.path.exists(so):
        if os.path.exists(log):
            with open(log) as f:
                build_log = f.read()
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
    with open(f"{log}.{os.getpid()}.tmp", "w") as f:
        f.write(build_log)
    os.replace(f"{log}.{os.getpid()}.tmp", log)
    os.replace(tmp, so)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        cdll = ctypes.CDLL(build())
        p, i = ctypes.c_void_p, ctypes.c_int
        for name, args in (
            ("merge_apply", [p, p, p, p, p, p, i, i, i, i, p]),
            ("merge_compact", [p, p, p, p, p, i, i, i, p]),
            ("merge_apply_compact", [p, p, p, p, p, p, i, i, i, i, p]),
        ):
            fn = getattr(cdll, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        for name in ("merge_smem_max_capacity", "merge_cluster_max_capacity",
                     "merge_max_capacity"):
            getattr(cdll, name).argtypes = []
            getattr(cdll, name).restype = ctypes.c_int
        cdll.merge_work_ints.argtypes = [ctypes.c_int]
        cdll.merge_work_ints.restype = ctypes.c_longlong
        cdll.merge_error_string.argtypes = [ctypes.c_int]
        cdll.merge_error_string.restype = ctypes.c_char_p
        if (cdll.merge_smem_max_capacity() != SMEM_MAX_CAPACITY
                or cdll.merge_cluster_max_capacity() != CLUSTER_MAX_CAPACITY
                or cdll.merge_max_capacity() != MAX_CAPACITY):
            raise RuntimeError("merge_kernels.cu tier limits != _cuda.py's")
        _lib = cdll
    return _lib


def tier(s: int, entry: str) -> str:
    """The tier C entry ``entry`` runs tables of ``s`` rows per document
    on (the same for every entry): ``"smem"`` (the table in one CTA's
    shared memory) up to :data:`SMEM_MAX_CAPACITY`; ``"cluster"`` (the
    table split across a thread-block cluster's shared memory) up to
    :data:`CLUSTER_MAX_CAPACITY`; ``"global"`` (the table in global
    memory) up to :data:`MAX_CAPACITY`. Larger tables raise
    ``ValueError``."""
    if entry not in ENTRIES:
        raise ValueError(f"unknown kernel entry {entry!r}")
    if s > MAX_CAPACITY:
        raise ValueError(
            f"capacity tier {s} exceeds the largest kernel tier "
            f"(<= {MAX_CAPACITY} rows per document)"
        )
    if s <= SMEM_MAX_CAPACITY:
        return "smem"
    if s <= CLUSTER_MAX_CAPACITY:
        return "cluster"
    return "global"


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
    d = tables.shape[1]
    if tuple(scalars.shape) != (d, N_SCALARS):
        raise ValueError(f"scalars must be [{d}, {N_SCALARS}]")
    if ops is not None and (ops.dim() != 3 or ops.shape[0] != d
                            or ops.shape[2] != OP_WIDTH):
        raise ValueError(f"ops must be [{d}, K, {OP_WIDTH}]")


def launch(name: str, tables, scalars, ops, out) -> str:
    """Launch one C entry (``merge_apply``, ``merge_compact`` or
    ``merge_apply_compact``) on PyTorch's current stream of the tables'
    device, reading ``tables``/``scalars`` (and ``ops``) and writing the
    ``out`` pair; returns the tier it ran on (:func:`tier`). The global
    tier gets a fresh workspace from the caching allocator, sized by the
    kernel library (``merge_work_ints``). Raises on a CUDA error (a refused
    launch never runs, and a later synchronize would not say so; a cluster
    that cannot be scheduled is refused)."""
    check_packed(tables, scalars, ops)
    ot, os_ = out
    check_packed(ot, os_)
    d, s = tables.shape[1], tables.shape[2]
    t = tier(s, name)
    work = None
    if t == "global":
        work = torch.empty((d, lib().merge_work_ints(s)), dtype=torch.int32,
                           device=tables.device)
    args = [tables.data_ptr(), scalars.data_ptr(), ot.data_ptr(),
            os_.data_ptr(), work.data_ptr() if work is not None else None,
            d, s]
    if ops is not None:
        args = [ops.data_ptr()] + args + [ops.shape[1]]
    args.append(TIER_CODES[t])
    with torch.cuda.device(tables.device):
        stream = torch.cuda.current_stream(tables.device).cuda_stream
        err = getattr(lib(), name)(*args, stream)
    if err != 0:
        msg = lib().merge_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")
    return t


def count_launch(wrapper, t: str) -> None:
    """Add one launch to a wrapper's counters: ``launches`` (every tier)
    and ``launches_smem``, ``launches_cluster`` or ``launches_global``."""
    wrapper.launches += 1
    key = f"launches_{t}"
    setattr(wrapper, key, getattr(wrapper, key) + 1)


def reset_counts(*wrappers) -> None:
    """Zero every launch counter of the given wrappers."""
    for w in wrappers:
        w.launches = 0
        for t in TIER_CODES:
            setattr(w, f"launches_{t}", 0)
