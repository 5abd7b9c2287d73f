"""T1 and T2, the SharedTree rebase scans, as hand-written Hopper kernels.

T1 (``tree_trunk_scan``) replaces the reference's jitted positional trunk
scan, ``fluidframework_tpu/tree/device_trunk.py:161``
``batched_trunk_scan``; T2 (``tree_em_ring_scan``) replaces its jitted
EditManager ring scan, ``fluidframework_tpu/tree/device_em.py:129``
``batched_em_trunk_scan_ring``. Neither is a ``pl.pallas_call``: the
reference compiles each dispatch into one XLA program (``jit`` over ``vmap``
of a ``lax.scan``), and here each dispatch is one launch of
``csrc/tree_kernels.cu`` — one CTA per document, the document's whole
C-commit stream inside it. The kernels are bound by the commit loop's
barrier latency, not by bytes or operations; the source says how the
design keeps that short.

The plain versions are the Python loops over batched tensors that
``tree/device_trunk.py`` (``batched_trunk_scan_plain``) and
``tree/device_em.py`` (``batched_em_trunk_scan_ring_plain``) keep; the
scans take them for CPU tensors and these wrappers for CUDA tensors, and
never swap one for the other. A wrapper launches on PyTorch's current
stream, makes no host synchronisation, allocates its workspace (and its
outputs, unless ``out`` gives them) with ``torch.empty`` and raises on a
shape beyond its tiers or a CUDA error.

Tiers (:func:`tier`): ``"shared"`` holds a document's ring and scratch in
the CTA's dynamic shared memory, up to :data:`SMEM_BYTES`; ``"global"``
puts the ring in a per-document slice of a device workspace and keeps the
rest in shared memory while it fits (in the workspace after the ring
otherwise).
"""

from __future__ import annotations

import ctypes

import torch

from fluidframework_tpu_torch.ops import _cuda

# Dynamic shared memory a CTA may take: the H100's 227 KB opt-in (232,448
# bytes) less 1 KB for the kernels' static shared memory; SMEM_BYTES in
# tree_kernels.cu.
SMEM_BYTES = 231_424
# The kernels' limits (MAX_* in tree_kernels.cu): widths, ring depth,
# attach runs a commit and the interned id universe. At these limits one
# document's workspace stays below 2**31 ints.
MAX_LC = 65_536
MAX_PC = 65_536
MAX_W = 1024
MAX_R = 1024
MAX_U = 1 << 26
ENTRIES = ("tree_trunk_scan", "tree_em_ring_scan")
TIER_CODES = {"shared": 0, "global": 1}
_lib = None  # the bound and checked library (:func:`lib`)


def _regions(entry: str, lc: int, pc: int, W: int, U: int):
    """Ints a document's ring and the rest take (the layout of
    tree_kernels.cu's ``trunk_*_ints`` / ``em_*_ints``)."""
    if entry == "tree_trunk_scan":
        e = 4 * lc + 1 + 3 * pc  # one changeset's seven lanes
        return W * e + 2 * W, 2 * e + 2 * lc + 3 * (lc + 1) + lc + 4 * pc
    return W * lc + 2 * W, (U + 31) // 32 + 5 * lc + 2 * (lc + 1)


def placement(entry: str, lc: int, pc: int, W: int, U: int, t: str):
    """``(smem_bytes, work_ints)`` of tier ``t``: the dynamic shared memory
    a CTA takes and the workspace ints a document takes there (``None``
    where the shared tier cannot take the shape)."""
    ring, rest = _regions(entry, lc, pc, W, U)
    if t == "shared":
        smem = 4 * (ring + rest)
        return (smem, 0) if smem <= SMEM_BYTES else None
    if 4 * rest <= SMEM_BYTES:
        return 4 * rest, ring
    return 0, ring + rest


def tier(entry: str, lc: int, pc: int, W: int, R: int = 0, U: int = 1
         ) -> str:
    """The tier ``entry`` runs documents of width ``lc`` (pool ``pc``, ring
    depth ``W``; T2 also ``R`` attach runs a commit over ``U`` interned
    ids) on: ``"shared"`` where the whole per-document state fits
    :data:`SMEM_BYTES` of shared memory (T1 at config 3b's Lc 128, Pc 32,
    W 16 takes 47,572 bytes; T2 at Lc 2,048, W 16, U 8,192 takes 189,576),
    ``"global"`` above.
    A shape beyond the kernels' limits raises ``ValueError``."""
    if entry not in ENTRIES:
        raise ValueError(f"unknown tree kernel entry {entry!r}")
    for what, v, lo, hi in (("Lc", lc, 1, MAX_LC), ("Pc", pc, 1, MAX_PC),
                            ("W", W, 1, MAX_W), ("R", R, 0, MAX_R),
                            ("U", U, 1, MAX_U)):
        if not lo <= v <= hi:
            raise ValueError(f"{entry}: {what} {v} is outside the kernel's "
                             f"[{lo}, {hi}]")
    if placement(entry, lc, pc, W, U, "shared") is not None:
        return "shared"
    return "global"


def lib() -> ctypes.CDLL:
    """The tree kernel library (``_cuda.lib("tree")``, built at first use)
    with its entries bound and its budget and layout checked against this
    module's (once, at the first call)."""
    global _lib
    if _lib is None:
        cdll = _cuda.lib("tree")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        _cuda.bind(cdll, [
            ("tree_trunk_scan", [p] * 15 + [i] * 6 + [p], i),
            ("tree_em_ring_scan", [p] * 17 + [i] * 8 + [p], i),
            ("tree_trunk_work_ints", [i] * 4, ll),
            ("tree_trunk_smem_bytes", [i] * 4, ll),
            ("tree_em_work_ints", [i] * 4, ll),
            ("tree_em_smem_bytes", [i] * 4, ll),
            ("tree_smem_budget", [], ll),
            ("tree_error_string", [i], ctypes.c_char_p),
        ])
        check_library(cdll)
        _lib = cdll
    return _lib


def check_library(cdll) -> None:
    """Raise unless the built library's budget and layout are this
    module's."""
    if cdll.tree_smem_budget() != SMEM_BYTES:
        raise RuntimeError("tree_kernels.cu SMEM_BYTES != tree_scan_kernel's")
    for lc, pc, W, U in ((128, 32, 16, 512), (4096, 8, 16, 16384),
                         (65_536, 8, 3, 1 << 20)):
        for t, code in TIER_CODES.items():
            want = placement("tree_trunk_scan", lc, pc, W, U, t) or (-1, -1)
            got = (cdll.tree_trunk_smem_bytes(lc, pc, W, code),
                   cdll.tree_trunk_work_ints(lc, pc, W, code))
            want_em = placement("tree_em_ring_scan", lc, pc, W, U, t) or (
                -1, -1)
            got_em = (cdll.tree_em_smem_bytes(lc, W, U, code),
                      cdll.tree_em_work_ints(lc, W, U, code))
            if got != want or got_em != want_em:
                raise RuntimeError("tree_kernels.cu layout != "
                                   "tree_scan_kernel's")


def _check(ts, what: str) -> None:
    for x in ts:
        if x.device.type != "cuda" or x.dtype != torch.int32:
            raise ValueError(f"{what}: inputs must be int32 CUDA tensors")
        if not x.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")
    if len({x.device for x in ts}) != 1:
        raise ValueError(f"{what}: inputs must share one device")


def _shape(x, shape, what: str) -> None:
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{what} must be {tuple(shape)}, got "
                         f"{tuple(x.shape)}")


def _outputs(out, N: int, Lc: int, dev, what: str):
    """``(doc_ids [N, Lc], L [N], err [N])``: ``out`` checked, or fresh."""
    if out is None:
        return (torch.empty((N, Lc), dtype=torch.int32, device=dev),
                torch.empty(N, dtype=torch.int32, device=dev),
                torch.empty(N, dtype=torch.int32, device=dev))
    out = tuple(out)
    _check(out, what)
    if out[0].device != dev:
        raise ValueError(f"{what}: out must be on the inputs' device")
    for x, shp, name in zip(out, ((N, Lc), (N,), (N,)),
                            ("out doc_ids", "out L", "out err")):
        _shape(x, shp, name)
    return out


def _launch(entry: str, tensors, ints, dev, n: int, work_ints: int):
    """Call C entry ``entry``: the tensors' pointers, a fresh workspace of
    ``n * work_ints`` ints (none where 0), the int arguments and PyTorch's
    current stream of ``dev``; raise on a CUDA error."""
    work = (torch.empty(n * work_ints, dtype=torch.int32, device=dev)
            if work_ints else None)
    cdll = lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(cdll, entry)(
            *[x.data_ptr() for x in tensors],
            work.data_ptr() if work is not None else None, *ints, stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err}: "
                           f"{cdll.tree_error_string(err).decode()}")


def _count(wrapper, t: str) -> None:
    wrapper.launches += 1
    key = f"launches_{t}"
    setattr(wrapper, key, getattr(wrapper, key) + 1)


def reset_counts(*wrappers) -> None:
    """Zero every launch counter of the given wrappers (both by default)."""
    for w in wrappers or (trunk_scan_cuda, em_ring_scan_cuda):
        w.launches = 0
        for t in TIER_CODES:
            setattr(w, f"launches_{t}", 0)


def trunk_scan_cuda(doc_ids, L, commits, W: int, out=None):
    """T1: ``batched_trunk_scan`` on the card. ``doc_ids [N, Lc]``,
    ``L [N]`` and a ``device_trunk.CommitBatch`` with all nine lanes
    (``[N, C, Lc | Lc+1 | Pc]``, ``ref``/``seq`` ``[N, C]``), int32,
    contiguous, on one card. Returns ``(doc_ids [N, Lc], L [N], err [N])``,
    written into ``out`` where given (the kernel writes every lane)."""
    lanes = list(commits)
    if any(x is None for x in lanes):
        raise ValueError("tree_trunk_scan: every commit lane is needed")
    _check([doc_ids, L, *lanes], "tree_trunk_scan")
    N, C, Lc = lanes[0].shape
    Pc = lanes[2].shape[2]
    dm, ic, ii, ref, seq, mid, moff, pmid, poff = lanes
    for x, shp, name in ((doc_ids, (N, Lc), "doc_ids"), (L, (N,), "L"),
                         (ic, (N, C, Lc + 1), "ins_cnt"),
                         (ii, (N, C, Pc), "ins_ids"), (ref, (N, C), "ref"),
                         (seq, (N, C), "seq"), (mid, (N, C, Lc), "mov_id"),
                         (moff, (N, C, Lc), "mov_off"),
                         (pmid, (N, C, Pc), "pool_mid"),
                         (poff, (N, C, Pc), "pool_off")):
        _shape(x, shp, name)
    t = tier("tree_trunk_scan", Lc, Pc, W)
    pl = placement("tree_trunk_scan", Lc, Pc, W, 1, t)
    dev = doc_ids.device
    out, out_L, err = _outputs(out, N, Lc, dev, "tree_trunk_scan")
    if N == 0:
        return out, out_L, err
    _launch("tree_trunk_scan",
            [doc_ids, L, dm, ic, ii, mid, moff, pmid, poff, ref, seq, out,
             out_L, err], [N, C, Lc, Pc, W, TIER_CODES[t]], dev, N, pl[1])
    _count(trunk_scan_cuda, t)
    return out, out_L, err


def em_ring_scan_cuda(ring_ids, ring_L, ring_seq, mov_seq0, commits, U: int,
                      out=None):
    """T2: ``batched_em_trunk_scan_ring`` on the card. ``ring_ids
    [N, W, Lc]``, ``ring_L``/``ring_seq`` ``[N, W]``, ``mov_seq0 [N]`` and
    a ``device_em.EmCommitBatch`` with all nine lanes, int32, contiguous,
    on one card; ``U`` the interned id universe. Returns ``(doc_ids
    [N, Lc], L [N], err [N])``, written into ``out`` where given; the
    inputs are not modified."""
    lanes = list(commits)
    if any(x is None for x in lanes):
        raise ValueError("tree_em_ring_scan: every commit lane is needed")
    _check([ring_ids, ring_L, ring_seq, mov_seq0, *lanes],
           "tree_em_ring_scan")
    N, W, Lc = ring_ids.shape
    dm, ic, ii, rs, rl, ro, refs, seqs, mv = lanes
    C = refs.shape[1] if refs.dim() == 2 else -1
    Pc = ii.shape[2] if ii.dim() == 3 else -1
    R = rs.shape[2] if rs.dim() == 3 else -1
    for x, shp, name in ((ring_L, (N, W), "ring_L"),
                         (ring_seq, (N, W), "ring_seq"),
                         (mov_seq0, (N,), "mov_seq0"),
                         (dm, (N, C, Lc), "del_mask"),
                         (ic, (N, C, Lc + 1), "ins_cnt"),
                         (ii, (N, C, Pc), "ins_ids"),
                         (rs, (N, C, R), "run_start"),
                         (rl, (N, C, R), "run_len"),
                         (ro, (N, C, R), "run_off"), (refs, (N, C), "ref"),
                         (seqs, (N, C), "seq"), (mv, (N, C, Lc),
                                                 "mov_mask")):
        _shape(x, shp, name)
    U = int(U)
    t = tier("tree_em_ring_scan", Lc, Pc, W, R, U)
    pl = placement("tree_em_ring_scan", Lc, Pc, W, U, t)
    dev = ring_ids.device
    out, out_L, err = _outputs(out, N, Lc, dev, "tree_em_ring_scan")
    if N == 0:
        return out, out_L, err
    _launch("tree_em_ring_scan",
            [ring_ids, ring_L, ring_seq, mov_seq0, dm, ic, ii, rs, rl, ro,
             refs, seqs, mv, out, out_L, err],
            [N, C, Lc, Pc, W, R, U, TIER_CODES[t]], dev, N, pl[1])
    _count(em_ring_scan_cuda, t)
    return out, out_L, err


# CUDA launches, in all and by tier (the CPU path never counts).
reset_counts()
