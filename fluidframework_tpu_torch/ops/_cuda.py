"""Build and load the hand-written Hopper kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into a shared library of its own with a
plain C interface, at first use, into the package's ``_build/`` directory
(listed in ``.gitignore``): ``csrc/merge_kernels.cu`` (K1-K3, the merge
path, and X1/X2 and the two in one launch, the sharded document's per-op
exchange) and
``csrc/tree_kernels.cu`` (T1/T2, the SharedTree rebase scans, and A1-A4,
the changeset algebra).
Each library is named by its own source's content hash, so an edited
source never loads a stale build. It is loaded with ``ctypes``: pointers
are ``c_void_p``, the stream is PyTorch's current CUDA stream, and every
entry returns ``cudaGetLastError()``, which the wrappers turn into an
exception. Nothing here runs at import time.
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
# The merge kernels' source (an A/B run may point it at a variant).
SOURCE = os.path.join(_PKG, "csrc", "merge_kernels.cu")
TREE_SOURCE = os.path.join(_PKG, "csrc", "tree_kernels.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH = "arch=compute_90a,code=sm_90a"
# nvcc's flags for every library. ``-lineinfo`` adds line tables only (the
# code and each kernel's registers, spills and shared memory are the same
# without it), so a memory or race checker names a file and a line.
NVCC_FLAGS = ("-gencode", ARCH, "-std=c++17", "-O3", "-lineinfo", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Largest table (rows per document) whose lanes fit one CTA's shared
# memory (the shared tier); must equal SMEM_MAX_CAP in merge_kernels.cu.
SMEM_MAX_CAPACITY = 2048
# Largest table the kernels split across a thread-block cluster's shared
# memory (the cluster tier, at most 16 CTAs of 1,024 rows); CLUSTER_MAX_CAP
# there.
CLUSTER_MAX_CAPACITY = 16384
# Largest table of the global tier (K1 and K3 one CTA a document, the table
# in global memory); GLOBAL_MAX_CAP there.
GLOBAL_MAX_CAPACITY = 65536
# Largest table the kernels take at all (the split tier above the others: a
# cluster of CTAs a document, the table in global memory), the most the
# kernels' int row indices address; must equal MAX_CAP there.
MAX_CAPACITY = 1 << 30
# Largest table of the warp tier (K1 and K3 only: one warp a document,
# a CTA of one warp); WARP_MAX_CAP there.
WARP_MAX_CAPACITY = 512
# When K1 and K3 take the warp tier: for tables of up to each width's
# rows (and more than the width before), the fewest documents a launch
# takes it from; None: never. From chip_smoke.py --narrow's sweep on an
# H100 (132 SMs; PERF.md §6), K1 and K3 on both tiers on the same random
# states at 64, 128, 256 and 512 rows x 1, 8, 66, 132, 528, 2,048,
# 16,384 and 100,000 documents x K 1, 8, 16 and 64 (shared / warp device
# ms), re-run in PR 24 once the shared tier walked, loaded and stored
# only the rows below count: at 64 and 128 rows the warp tier wins every
# K from 2,048 documents (K1 1.18-2.00x, K3 1.10-1.97x; PR 23 1.16-2.13x)
# and loses at 8-528 (0.56-1.00x: one warp a document against a CTA of
# 2-4; at one document of 64 rows it wins 1.14-1.25x, which the rule
# leaves to the shared tier); at 256 rows K1 wins from 2,048 documents at
# K 1 (1.25-1.32x) and from 16,384 at K 64 (1.07-1.10x) but not at K 8-16
# (0.87-1.01x), K3 only at K 1 (1.18-1.25x, 0.78-0.97x at K 8-64); at 512
# rows both lose (0.23-0.62x: an SM holds 7 documents' tables).
WARP_MIN_DOCS = {64: 2048, 128: 2048, 256: None, 512: None}
# The C entries' tier argument.
TIER_CODES = {"smem": 0, "cluster": 1, "global": 2, "split": 3, "warp": 4}
# Every C entry of the kernel libraries and the library it lives in. The
# merge entries run on the tiers of :func:`tier`; the exchange entries have
# no tiers (``shard_exchange_kernel``); the tree entries' tiers depend on
# their widths (``tree_scan_kernel.tier``).
ENTRIES = {
    "merge_apply": "merge",
    "merge_compact": "merge",
    "merge_apply_compact": "merge",
    "shard_stats": "merge",
    "shard_resolve": "merge",
    "shard_exchange": "merge",
    "tree_trunk_scan": "tree",
    "tree_em_ring_scan": "tree",
    "tree_apply": "tree",
    "tree_rebase": "tree",
    "tree_invert": "tree",
    "tree_compose": "tree",
}
LIBRARIES = ("merge", "tree")
# The merge library's entries without tiers.
UNTIERED = ("shard_stats", "shard_resolve", "shard_exchange")

_libs: dict = {}
_logs: dict = {}
# The ptxas reports (registers, smem, spills) of the libraries built or
# found so far, merge first.
build_log = ""


def _nvcc() -> str:
    cands = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        cands.insert(0, os.path.join(home, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def source(name: str = "merge") -> str:
    """The source file of library ``name`` (``"merge"`` or ``"tree"``)."""
    if name not in LIBRARIES:
        raise ValueError(f"unknown kernel library {name!r}")
    return SOURCE if name == "merge" else TREE_SOURCE


def library_path(name: str = "merge") -> str:
    """Where library ``name``'s build lives: ``_build/lib<stem>-<hash>.so``,
    the stem the source's file name, the hash the first 16 hex digits of
    the SHA-256 of its content."""
    src = source(name)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")


def _keep_log(name: str, text: str) -> None:
    global build_log
    _logs[name] = text
    build_log = "".join(_logs[n] for n in LIBRARIES if n in _logs)


def build(name: str = "merge") -> str:
    """Compile library ``name`` if no build of its source exists; return
    the library path. Concurrent builds each write private temp files and
    rename them into place. The ptxas report is kept beside the library,
    so :data:`build_log` holds it after a reused build too."""
    so = library_path(name)
    log = so[:-3] + ".ptxas"
    if os.path.exists(so):
        if os.path.exists(log):
            with open(log) as f:
                _keep_log(name, f.read())
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, source(name)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}"
        )
    with open(f"{log}.{os.getpid()}.tmp", "w") as f:
        f.write(res.stderr)
    os.replace(f"{log}.{os.getpid()}.tmp", log)
    os.replace(tmp, so)
    _keep_log(name, res.stderr)
    return so


def bind(cdll: ctypes.CDLL, sigs) -> None:
    """Set the ctypes signature of each ``(entry, argtypes, restype)``."""
    for name, args, res in sigs:
        fn = getattr(cdll, name)
        fn.argtypes = args
        fn.restype = res


def lib(name: str = "merge") -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built on first call). The merge
    library's entries are bound and its tier limits checked here; the tree
    library's are bound by its wrapper modules (``tree_scan_kernel.lib``,
    ``tree_algebra_kernel.lib``)."""
    if name in _libs:
        return _libs[name]
    cdll = ctypes.CDLL(build(name))
    if name == "merge":
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        bind(cdll, [
            ("merge_apply", [p, p, p, p, p, p, i, i, i, i, p], i),
            ("merge_compact", [p, p, p, p, p, i, i, i, p], i),
            ("merge_apply_compact", [p, p, p, p, p, p, i, i, i, i, p], i),
            ("shard_stats", [p, p, p, p, p, i, i, p], i),
            ("shard_resolve", [p, p, p, p, p, p, i, i, p], i),
            ("shard_exchange", [p, p, p, p, p, p, i, i, p], i),
            ("merge_work_ints", [i], ll),
            ("merge_error_string", [i], ctypes.c_char_p),
        ] + [(f, [], i) for f in (
            "merge_smem_max_capacity", "merge_cluster_max_capacity",
            "merge_global_max_capacity", "merge_max_capacity",
            "merge_warp_max_capacity",
            "merge_split_max_ctas", "shard_max_shards",
            "shard_exchange_max_shards")])
        if (cdll.merge_smem_max_capacity() != SMEM_MAX_CAPACITY
                or cdll.merge_cluster_max_capacity() != CLUSTER_MAX_CAPACITY
                or cdll.merge_global_max_capacity() != GLOBAL_MAX_CAPACITY
                or cdll.merge_max_capacity() != MAX_CAPACITY
                or cdll.merge_warp_max_capacity() != WARP_MAX_CAPACITY):
            raise RuntimeError("merge_kernels.cu tier limits != _cuda.py's")
    _libs[name] = cdll
    return cdll


# Each card's SM count, by device index (:func:`sm_count`).
_SMS: dict = {}


def sm_count(device=None) -> int:
    """The SMs of CUDA card ``device`` (default: the current one), asked
    of the card once and kept."""
    idx = None if device is None else torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def tier(s: int, entry: str, n_docs: int, sms: Optional[int] = None) -> str:
    """The tier merge entry ``entry`` runs a launch of ``n_docs`` tables
    of ``s`` rows on, on a card of ``sms`` SMs (default: the current
    card's, :func:`sm_count`, asked only where it decides): for K1 and K3,
    ``"warp"`` (one warp a document, its table in its CTA's shared
    memory) where :data:`WARP_MIN_DOCS` lets it, up to
    :data:`WARP_MAX_CAPACITY`; ``"smem"``
    (the table in one CTA's shared memory) up to
    :data:`SMEM_MAX_CAPACITY`; ``"cluster"`` (the table split across a
    thread-block cluster's shared memory) up to
    :data:`CLUSTER_MAX_CAPACITY`; up to :data:`GLOBAL_MAX_CAPACITY`,
    ``"global"`` (the table in global memory, one CTA a document for K1
    and K3, a cluster of up to 8 for K2), for K1 and K3 only where the
    split tier would give each document one CTA, and ``"split"`` where it
    gives each at least 2; ``"split"`` (the table in global memory, a
    cluster of up to 16 CTAs a document) up to :data:`MAX_CAPACITY`.
    Larger tables raise ``ValueError``, and so does a tree or an exchange
    entry.

    The split tier spreads each document over C = min(16, ceil(sms / D))
    CTAs. chip_smoke.py --split's document-count sweep on an H100 (132
    SMs) found it faster than the one-CTA global tier while C >= 2 (up
    to 131 documents) and slower at C = 1, so K1 and K3 take the global
    tier from ``sms`` documents. K2's global tier already runs the split
    tier's code."""
    if entry not in ENTRIES:
        raise ValueError(f"unknown kernel entry {entry!r}")
    if s > MAX_CAPACITY:
        raise ValueError(
            f"capacity tier {s} exceeds the largest kernel tier "
            f"(<= {MAX_CAPACITY} rows per document)"
        )
    if ENTRIES[entry] != "merge":
        raise ValueError(f"{entry} runs on the tiers of its widths: "
                         "tree_scan_kernel.tier or tree_algebra_kernel.tier")
    if entry in UNTIERED:
        raise ValueError(f"{entry} runs on no tier: shard_exchange_kernel")
    if s <= SMEM_MAX_CAPACITY:
        if entry != "merge_compact" and s <= WARP_MAX_CAPACITY:
            fewest = WARP_MIN_DOCS[min(w for w in WARP_MIN_DOCS if s <= w)]
            if fewest is not None and n_docs >= fewest:
                return "warp"
        return "smem"
    if s <= CLUSTER_MAX_CAPACITY:
        return "cluster"
    if s <= GLOBAL_MAX_CAPACITY:
        if entry == "merge_compact":
            return "global"
        sms = sm_count() if sms is None else sms
        if -(-sms // max(n_docs, 1)) < 2:
            return "global"
    return "split"


def entry_tiers(entry: str) -> tuple:
    """The tiers merge entry ``entry`` runs on: every tier of
    :data:`TIER_CODES`, but K2 (``merge_compact``) has no warp tier (its
    C entry refuses it)."""
    return tuple(t for t in TIER_CODES
                 if not (entry == "merge_compact" and t == "warp"))


def live_rows(s: int, count: int, k: int) -> int:
    """The rows ``[0, live)`` every tier walks in a launch of ``k`` ops
    on a table of ``s`` rows whose count is ``count`` (the kernels'
    ``live_rows``): every row at or past count is free and an op adds at
    most 2 rows, so min(s, count + 2k), count clamped into [0, s]. K2
    alone walks min(s, count). The shared, cluster and warp tiers load
    only the rows below count and, in place, store only the rows below
    the larger of the input and output counts."""
    return min(s, min(max(count, 0), s) + 2 * k)


def split_slice_rows(live: int, d: int, sms: int) -> int:
    """Rows a CTA holds when the split tier runs ``d`` tables of
    ``live`` rows below :func:`live_rows` each on a card of ``sms`` SMs:
    the kernel's C = min(split CTAs, ceil(sms / d)), at least 1, and
    ceil(live / C) rounded up to 32 rows."""
    c = max(1, min(lib().merge_split_max_ctas(), -(-sms // d)))
    return (-(-live // c) + 31) // 32 * 32


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


def launch(name: str, tables, scalars, ops, out, t: Optional[str] = None
           ) -> str:
    """Launch one C entry (``merge_apply``, ``merge_compact`` or
    ``merge_apply_compact``) on PyTorch's current stream of the tables'
    device, reading ``tables``/``scalars`` (and ``ops``) and writing the
    ``out`` pair; returns the tier it ran on (:func:`tier`, unless ``t``
    names another that takes the size: a measurement's choice). The
    global and split tiers get a fresh workspace from the caching
    allocator, sized by the kernel library (``merge_work_ints``). Raises
    on a CUDA error (a refused launch never runs, and a later synchronize
    would not say so; a cluster that cannot be scheduled is refused)."""
    check_packed(tables, scalars, ops)
    ot, os_ = out
    check_packed(ot, os_)
    d, s = tables.shape[1], tables.shape[2]
    t = t or tier(s, name, d, sm_count(tables.device))
    work = None
    if t in ("global", "split"):
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
    and ``launches_smem``, ``launches_cluster``, ``launches_global``,
    ``launches_split`` or ``launches_warp``."""
    wrapper.launches += 1
    key = f"launches_{t}"
    setattr(wrapper, key, getattr(wrapper, key) + 1)


def reset_counts(*wrappers) -> None:
    """Zero every launch counter of the given wrappers."""
    for w in wrappers:
        w.launches = 0
        for t in TIER_CODES:
            setattr(w, f"launches_{t}", 0)
