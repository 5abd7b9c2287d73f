"""T1 and T2, the SharedTree rebase scans, as hand-written Hopper kernels.

T1 (``tree_trunk_scan``) replaces the reference's jitted positional trunk
scan, ``fluidframework_tpu/tree/device_trunk.py:161``
``batched_trunk_scan``; T2 (``tree_em_ring_scan``) replaces its jitted
EditManager ring scan, ``fluidframework_tpu/tree/device_em.py:129``
``batched_em_trunk_scan_ring``. Neither is a ``pl.pallas_call``: the
reference compiles each dispatch into one XLA program (``jit`` over ``vmap``
of a ``lax.scan``), and here each dispatch is one launch of
``csrc/tree_kernels.cu``, the document's whole C-commit stream inside it.
The kernels are bound by the commit loop's latency, not by bytes or
operations; the source says how each tier keeps that short.

The plain versions are the Python loops over batched tensors that
``tree/device_trunk.py`` (``batched_trunk_scan_plain``) and
``tree/device_em.py`` (``batched_em_trunk_scan_ring_plain``) keep; the
scans take them for CPU tensors and these wrappers for CUDA tensors, and
never swap one for the other. A wrapper launches on PyTorch's current
stream, makes no host synchronisation, allocates its workspace (and its
outputs, unless ``out`` gives them) with ``torch.empty`` and raises on a
shape beyond its tiers or a CUDA error.

Tiers (:func:`tier`): ``"warp"`` runs one warp a document, up to
:data:`WARP_MAX_D` documents a CTA, each in its own slice of the CTA's
shared memory, with the ring in the slice or in a per-document workspace
(:func:`warp_ring`); ``"shared"`` runs one CTA a document with its ring and
scratch in the CTA's dynamic shared memory, up to :data:`SMEM_BYTES`;
``"global"`` runs one CTA a document with the ring in the workspace and the
rest in shared memory while it fits (in the workspace after the ring
otherwise). The shape and the launch's document count pick the tier and
the ring's place; no switch does.
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
T1, T2 = ENTRIES
TIER_CODES = {"shared": 0, "global": 1, "warp": 2}
# Where the warp tier keeps a document's ring: in its shared-memory slice
# (the C entries' code TIER_CODES["warp"]) or in the workspace (that code
# plus one).
RINGS = ("shared", "global")
# Documents (warps) a CTA of the warp tier holds at most, and ring entries
# T1's warp tier caches in its slice at most with its ring in the
# workspace; WARP_MAX_D and WARP_CACHE_MAX in tree_kernels.cu.
WARP_MAX_D = 8
WARP_CACHE_MAX = 8
# When the warp tier runs a launch: (widest Lc, fewest documents) pairs,
# narrowest first (None: never at those widths); past the last width it
# does not. A warp gives one document a quarter to a sixteenth of a CTA's
# threads, so past the narrow widths it wins only once the CTA tiers would
# fill the card (chip_smoke 7h's sweep times every tier on the same inputs
# at 1 to 1,024 documents; PERF.md).
WARP_MIN_DOCS = {T1: ((128, 1), (512, 256)),
                 T2: ((64, 1), (128, None), (256, 1024), (512, 512))}
# The card the tier rules are measured on: an H100's SMs and the shared
# memory an SM holds (228 KB; each CTA also takes 1 KB of it).
SMS = 132
SM_SMEM_BYTES = 233_472
_lib = None  # the bound and checked library (:func:`lib`)


def _regions(entry: str, lc: int, pc: int, W: int, U: int):
    """Ints a document's ring and the rest take on the CTA tiers (the
    layout of tree_kernels.cu's ``trunk_*_ints`` / ``em_*_ints``)."""
    if entry == T1:
        e = 4 * lc + 1 + 3 * pc  # one changeset's seven lanes
        return W * e + 2 * W, 2 * e + 2 * lc + 3 * (lc + 1) + lc + 4 * pc
    return W * lc + 2 * W, (U + 31) // 32 + 5 * lc + 2 * (lc + 1)


def _warp_docs(slice_: int) -> int:
    """Documents a warp-tier CTA holds at ``slice_`` ints each."""
    return min(WARP_MAX_D, SMEM_BYTES // (4 * slice_))


def trunk_cache(lc: int, pc: int, W: int) -> int:
    """The newest ring entries T1's warp tier keeps in a document's slice
    with its ring in the workspace: as many (up to
    :data:`WARP_CACHE_MAX` and ``W``) as leave its documents a CTA as they
    are without them (config 3b: 5)."""
    e = 4 * lc + 1 + 3 * pc
    base = _warp_slice(T1, lc, pc, W, 0, 1, "global", cache=0)[0]
    d0, m = _warp_docs(base), 0
    while (d0 >= 1 and m < min(WARP_CACHE_MAX, W)
           and _warp_docs(base + (m + 1) * e) >= d0):
        m += 1
    return m


def _warp_slice(entry: str, lc: int, pc: int, W: int, R: int, U: int,
                ring: str, cache: int = None):
    """``(slice, ring_ints)``: the shared-memory ints of one document on
    the warp tier with its ring in ``ring``, and the ring's ints (the
    layouts above ``trunk_warp_kernel`` / ``em_warp_kernel``)."""
    g = ring == "global"
    if entry == T1:
        e = 4 * lc + 1 + 3 * pc
        if g and cache is None:
            cache = trunk_cache(lc, pc, W)
        return (((2 + cache) * e if g else W * e) + 2 * W + 3 * (e + 2)
                + 2 * lc + 3 * (lc + 1) + 4 * pc), W * e
    s = 3 * lc + 1 + pc + 3 * R + 2  # one staged commit's lanes
    return ((0 if g else W * lc) + 2 * W + (U + 31) // 32 + 4 * lc
            + 2 * (lc + 1) + 2 * s), W * lc


def _warp(entry, lc, pc, W, U, R, ring):
    """``(smem_bytes, work_ints, docs)`` of the warp tier, or ``None``."""
    if ring not in RINGS:
        raise ValueError(f"unknown ring placement {ring!r}")
    slice_, ring_ints = _warp_slice(entry, lc, pc, W, R, U, ring)
    d = _warp_docs(slice_)
    if d < 1:
        return None
    return 4 * slice_ * d, ring_ints if ring == "global" else 0, d


def wave_docs(smem: int, docs: int) -> int:
    """Documents the card runs at once in CTAs of ``docs`` warps (one
    document each) and ``smem`` bytes of shared memory."""
    per_sm = min(32, 64 // docs, SM_SMEM_BYTES // (smem + 1024))
    return SMS * per_sm * docs


def warp_ring(entry: str, lc: int, pc: int, W: int, R: int = 0, U: int = 1,
              n: int = None) -> str:
    """Where the warp tier keeps a document's ring for a launch of ``n``
    documents: ``"shared"`` (in its slice) while all ``n`` fit the card at
    once that way, ``"global"`` (in the workspace, each entry staged into
    the slice before it is read) past that. Config 3b's T1 ring is 39,104
    bytes a document and 7b's T2 ring 32,896, so with them in the slice an
    H100 runs 528 and 396 documents at once. With ``n`` ``None``, in the
    slice only where that costs no documents a CTA."""
    full = _warp(entry, lc, pc, W, U, R, "shared")
    if full is None:
        return "global"
    if n is None:
        return "shared" if full[2] == WARP_MAX_D else "global"
    return "shared" if n <= wave_docs(full[0], full[2]) else "global"


def placement(entry: str, lc: int, pc: int, W: int, U: int, t: str,
              R: int = 0, ring: str = None):
    """``(smem_bytes, work_ints)`` of tier ``t``: the dynamic shared memory
    a CTA takes and the workspace ints a document takes there (``None``
    where the tier cannot take the shape). The warp tier's ring lies where
    ``ring`` says (:func:`warp_ring` by default); T2's warp tier also
    stages ``R`` runs a commit."""
    if t == "warp":
        pl = _warp(entry, lc, pc, W, U, R,
                   ring or warp_ring(entry, lc, pc, W, R, U))
        return None if pl is None else pl[:2]
    ring_i, rest = _regions(entry, lc, pc, W, U)
    if t == "shared":
        smem = 4 * (ring_i + rest)
        return (smem, 0) if smem <= SMEM_BYTES else None
    if 4 * rest <= SMEM_BYTES:
        return 4 * rest, ring_i
    return 0, ring_i + rest


def docs_per_cta(entry: str, lc: int, pc: int, W: int, U: int, t: str,
                 R: int = 0, ring: str = None):
    """Documents a CTA of tier ``t`` runs: 1 on the CTA tiers, up to
    :data:`WARP_MAX_D` on the warp tier (``None`` where it cannot take
    the shape)."""
    if t != "warp":
        return None if placement(entry, lc, pc, W, U, t) is None else 1
    pl = _warp(entry, lc, pc, W, U, R,
               ring or warp_ring(entry, lc, pc, W, R, U))
    return None if pl is None else pl[2]


def code(t: str, ring: str = None) -> int:
    """The C entries' tier code of tier ``t`` (the warp tier's with its ring
    in ``ring``)."""
    if t == "warp":
        if ring not in RINGS:
            raise ValueError(f"unknown ring placement {ring!r}")
        return TIER_CODES["warp"] + RINGS.index(ring)
    return TIER_CODES[t]


def warp_min_docs(entry: str, lc: int):
    """The fewest documents a launch of width ``lc`` needs for the warp
    tier (:data:`WARP_MIN_DOCS`; ``None``: the warp tier never runs it)."""
    for widest, fewest in WARP_MIN_DOCS[entry]:
        if lc <= widest:
            return fewest
    return None


def tier(entry: str, lc: int, pc: int, W: int, R: int = 0, U: int = 1,
         n: int = None) -> str:
    """The tier ``entry`` runs a launch of ``n`` documents (a large batch
    where ``None``) of width ``lc`` (pool ``pc``, ring depth ``W``; T2 also
    ``R`` attach runs a commit over ``U`` interned ids) on: ``"warp"``
    where :data:`WARP_MIN_DOCS` lets it and a document's slice fits
    (config 3b's T1 and 7b's T2 run there), else ``"shared"`` where the
    whole per-document state fits :data:`SMEM_BYTES` of one CTA's shared
    memory (T2 at Lc 2,048, W 16, U 8,192 takes 189,576 bytes),
    ``"global"`` above. A shape beyond the kernels' limits raises
    ``ValueError``."""
    if entry not in ENTRIES:
        raise ValueError(f"unknown tree kernel entry {entry!r}")
    for what, v, lo, hi in (("Lc", lc, 1, MAX_LC), ("Pc", pc, 1, MAX_PC),
                            ("W", W, 1, MAX_W), ("R", R, 0, MAX_R),
                            ("U", U, 1, MAX_U)):
        if not lo <= v <= hi:
            raise ValueError(f"{entry}: {what} {v} is outside the kernel's "
                             f"[{lo}, {hi}]")
    fewest = warp_min_docs(entry, lc)
    if (fewest is not None and (n is None or n >= fewest)
            and placement(entry, lc, pc, W, U, "warp", R) is not None):
        return "warp"
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
            ("tree_trunk_docs", [i] * 4, ll),
            ("tree_em_work_ints", [i] * 6, ll),
            ("tree_em_smem_bytes", [i] * 6, ll),
            ("tree_em_docs", [i] * 6, ll),
            ("tree_smem_budget", [], ll),
            ("tree_error_string", [i], ctypes.c_char_p),
        ])
        check_library(cdll)
        _lib = cdll
    return _lib


# Shapes check_library compares the library's placements at: (Lc, Pc, W,
# R, U).
_CHECK_SHAPES = ((128, 32, 16, 16, 512), (512, 8, 16, 16, 512),
                 (4096, 8, 16, 16, 16384), (65_536, 8, 3, 16, 1 << 20))


def _placements(t: str, ring: str = None):
    """Every (entry, shape, code) check_library compares, with this
    module's ``(smem_bytes, work_ints, docs)`` (-1s where the tier cannot
    take the shape)."""
    for lc, pc, W, R, U in _CHECK_SHAPES:
        for entry in ENTRIES:
            pl = placement(entry, lc, pc, W, U, t, R, ring)
            want = (-1, -1, -1) if pl is None else (
                *pl, docs_per_cta(entry, lc, pc, W, U, t, R, ring))
            yield entry, (lc, pc, W, R, U), code(t, ring), want


def check_library(cdll) -> None:
    """Raise unless the built library's budget and layout are this
    module's, on every tier code."""
    if cdll.tree_smem_budget() != SMEM_BYTES:
        raise RuntimeError("tree_kernels.cu SMEM_BYTES != tree_scan_kernel's")
    for t, ring in (("shared", None), ("global", None), ("warp", "shared"),
                    ("warp", "global")):
        for entry, (lc, pc, W, R, U), c, want in _placements(t, ring):
            if entry == T1:
                args = (lc, pc, W, c)
                got = (cdll.tree_trunk_smem_bytes(*args),
                       cdll.tree_trunk_work_ints(*args),
                       cdll.tree_trunk_docs(*args))
            else:
                args = (lc, pc, W, R, U, c)
                got = (cdll.tree_em_smem_bytes(*args),
                       cdll.tree_em_work_ints(*args),
                       cdll.tree_em_docs(*args))
            if got != want:
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


def _run(wrapper, entry, tensors, shape, t, ring, out, dev):
    """Launch ``entry`` on tier ``t`` (:func:`tier`'s for the shape and
    document count where ``None``; the warp tier's ring where ``ring``
    says, :func:`warp_ring`'s where ``None``) into ``out`` (checked, or
    fresh) and count the launch.
    ``shape`` is ``(N, C, Lc, Pc, W, R, U)``."""
    N, C, Lc, Pc, W, R, U = shape
    if t is None:
        t = tier(entry, Lc, Pc, W, R, U, N)
    elif t not in TIER_CODES:
        raise ValueError(f"unknown tier {t!r}")
    if t == "warp":
        ring = ring or warp_ring(entry, Lc, Pc, W, R, U, N)
    pl = placement(entry, Lc, Pc, W, U, t, R, ring)
    if pl is None:
        raise ValueError(f"{entry}: tier {t} cannot take Lc {Lc}, Pc {Pc}, "
                         f"W {W}, R {R}, U {U}")
    out = _outputs(out, N, Lc, dev, entry)
    if N == 0:
        return out
    ints = [N, C, Lc, Pc, W] + ([R, U] if entry == T2 else [])
    _launch(entry, [*tensors, *out], ints + [code(t, ring)], dev, N, pl[1])
    _count(wrapper, t)
    return out


def _trunk_inputs(doc_ids, L, commits, W: int):
    """T1's inputs checked: ``(tensors, (N, C, Lc, Pc, W, 0, 1))``."""
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
    return ([doc_ids, L, dm, ic, ii, mid, moff, pmid, poff, ref, seq],
            (N, C, Lc, Pc, W, 0, 1))


def trunk_scan_cuda(doc_ids, L, commits, W: int, out=None):
    """T1: ``batched_trunk_scan`` on the card, on the tier :func:`tier`
    names. ``doc_ids [N, Lc]``, ``L [N]`` and a ``device_trunk.CommitBatch``
    with all nine lanes (``[N, C, Lc | Lc+1 | Pc]``, ``ref``/``seq``
    ``[N, C]``), int32, contiguous, on one card. Returns ``(doc_ids
    [N, Lc], L [N], err [N])``, written into ``out`` where given (the
    kernel writes every lane)."""
    tensors, shape = _trunk_inputs(doc_ids, L, commits, W)
    return _run(trunk_scan_cuda, T1, tensors, shape, None, None, out,
                doc_ids.device)


def trunk_scan_on(t: str, ring, doc_ids, L, commits, W: int, out=None):
    """T1 on tier ``t`` (the warp tier's ring in ``ring``, ``None`` for
    :func:`warp_ring`'s place), for the holds that hold every tier against
    the plain version and time two tiers on the same inputs; raises where
    the tier cannot take the shape. The scans never call it."""
    tensors, shape = _trunk_inputs(doc_ids, L, commits, W)
    return _run(trunk_scan_cuda, T1, tensors, shape, t, ring, out,
                doc_ids.device)


def _em_inputs(ring_ids, ring_L, ring_seq, mov_seq0, commits, U: int):
    """T2's inputs checked: ``(tensors, (N, C, Lc, Pc, W, R, U))``."""
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
    return ([ring_ids, ring_L, ring_seq, mov_seq0, dm, ic, ii, rs, rl, ro,
             refs, seqs, mv], (N, C, Lc, Pc, W, R, int(U)))


def em_ring_scan_cuda(ring_ids, ring_L, ring_seq, mov_seq0, commits, U: int,
                      out=None):
    """T2: ``batched_em_trunk_scan_ring`` on the card, on the tier
    :func:`tier` names. ``ring_ids [N, W, Lc]``, ``ring_L``/``ring_seq``
    ``[N, W]``, ``mov_seq0 [N]`` and a ``device_em.EmCommitBatch`` with all
    nine lanes, int32, contiguous, on one card; ``U`` the interned id
    universe. Returns ``(doc_ids [N, Lc], L [N], err [N])``, written into
    ``out`` where given; the inputs are not modified."""
    tensors, shape = _em_inputs(ring_ids, ring_L, ring_seq, mov_seq0,
                                commits, U)
    return _run(em_ring_scan_cuda, T2, tensors, shape, None, None, out,
                ring_ids.device)


def em_ring_scan_on(t: str, ring, ring_ids, ring_L, ring_seq, mov_seq0,
                    commits, U: int, out=None):
    """T2 on tier ``t``, as :func:`trunk_scan_on` is T1's."""
    tensors, shape = _em_inputs(ring_ids, ring_L, ring_seq, mov_seq0,
                                commits, U)
    return _run(em_ring_scan_cuda, T2, tensors, shape, t, ring, out,
                ring_ids.device)


# CUDA launches, in all and by tier (the CPU path never counts).
reset_counts()
