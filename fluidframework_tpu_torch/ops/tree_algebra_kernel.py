"""A1-A4, the SharedTree changeset algebra, as hand-written Hopper kernels.

A1 ``tree_apply``, A2 ``tree_rebase``, A3 ``tree_invert`` and A4
``tree_compose`` replace the reference's four jitted entry points of the
dense algebra, ``fluidframework_tpu/ops/tree_kernel.py:587-592``
(``batched_apply``, ``batched_rebase``, ``batched_invert`` and
``batched_compose``: jit over vmap of ``apply_change`` :238,
``rebase_change`` :258, ``invert_change`` :339 and ``compose_change`` :382;
XLA programs, no ``pl.pallas_call``). Each call is one launch of
``csrc/tree_kernels.cu``; the source says what bounds the kernels and how
compose ranks its attach pool.

``ops/tree_kernel.py``'s ``batched_*`` take these wrappers for CUDA tensors
and the plain functions beside them (``apply_change``, ``rebase_change``,
``invert_change``, ``compose_change``) for CPU tensors, and never swap one
for the other. A wrapper launches on PyTorch's current stream, makes no
host synchronisation, allocates its outputs (unless ``out`` gives them) and
its workspace with ``torch.empty``, reads each input lane's rows at their
own stride (so a lane sliced out of a commit batch, ``x[:, k]``, costs no
copy; a row's elements must be contiguous), writes every output lane, and
raises on a shape past the kernels' limits, lanes of mismatched widths or a
CUDA error.

Tiers (:func:`tier`): ``"warp"`` gives each document one warp and its
region a slice of a CTA's dynamic shared memory, up to :data:`WARP_MAX_D`
documents a CTA, where :data:`WARP_MIN_DOCS` lets it; ``"shared"`` holds a
document's whole region (rebase's and compose's staged input changes, their
output change and the scratch; apply's and invert's scratch alone, since
they read their inputs in place and scatter into their outputs) in one
CTA's dynamic shared memory, up to :data:`SMEM_BYTES`; ``"global"`` holds it
in the document's slice of a workspace.
"""

from __future__ import annotations

import ctypes

import torch

from fluidframework_tpu_torch.ops import _cuda
from fluidframework_tpu_torch.ops import tree_kernel as TK
from fluidframework_tpu_torch.ops.tree_scan_kernel import (
    MAX_LC,
    MAX_PC,
    SMEM_BYTES,
    WARP_MAX_D,
)

ENTRIES = ("tree_apply", "tree_rebase", "tree_invert", "tree_compose")
A1, A2, A3, A4 = ENTRIES
TIER_CODES = {"shared": 0, "global": 1, "warp": 2}
# When the warp tier (every entry has one) runs a launch: the fewest documents, at the widths
# (Lc, Pc) where the sweep timed it faster; at any other widths it does
# not. From chip_smoke 7h's document-count sweep, which times every tier on
# the same inputs at 1, 8, 64, 256, 528 and 1,024 documents of (128, 32)
# and (512, 8) (PERF.md §6): a warp a document wins only once the CTA tiers
# need more than a wave, rebase from 1,024 documents at (128, 32) (and at
# (512, 8) never: a tie in one tie form, a loss in the other), compose from
# 528 at (512, 8) and from 1,024 at (128, 32), where the sweep is a tie
# (1%) and 7a's commits run 6% faster on the warp tier; apply and invert
# from 1,024 at (128, 32) (about 0.005 ms against the shared tier's 0.006)
# and at (512, 8) never (a lane's 16 slots against a CTA of 128 threads'
# four, one wave: about 0.013 ms against 0.008).
WARP_MIN_DOCS = {A1: {(128, 32): 1024}, A2: {(128, 32): 1024},
                 A3: {(128, 32): 1024},
                 A4: {(128, 32): 1024, (512, 8): 528}}
# The seven lanes of a change: (field, width) with Lc and Pc as 0 and 1.
_LANES = tuple(zip(TK.DenseChange._fields, ((0, 0), (0, 1), (1, 0), (0, 0),
                                            (0, 0), (1, 0), (1, 0))))
_lib = None  # the bound and checked library (:func:`lib`)


def region_ints(entry: str, lc: int, pc: int, t: str) -> int:
    """Ints a document's region takes on tier ``t`` (the layouts above
    ``apply_alg``, ``invert_alg`` and ``alg_*_kernel`` in tree_kernels.cu):
    apply's and invert's scratch on every tier (bcum and dex [Lc + 1], the
    staged pool lanes, apply's move-in positions and sums); rebase's and
    compose's staged input changes of 4 Lc + 1 + 3 Pc ints (none on the
    global tier, which reads them where they lie), output change and
    scratch, rebase's landing positions only on the CTA tiers."""
    e, l1, nc = 4 * lc + 1 + 3 * pc, lc + 1, lc + 2 * pc
    if entry == A1:
        return 2 * l1 + 5 * pc
    if entry == A3:
        return 2 * l1 + 2 * pc
    if entry == A2:
        staged = 2 * e
        rest = e + 3 * l1 + 4 * pc + (0 if t == "warp" else lc)
    else:
        staged = 2 * e
        rest = e + 4 * l1 + 3 * pc + 4 * lc + 2 * nc + 6
    return rest + (0 if t == "global" else staged)


def placement(entry: str, lc: int, pc: int, t: str):
    """``(smem_bytes, work_ints)`` of tier ``t``: the dynamic shared memory
    a CTA takes and the workspace ints a document takes (``None`` where the
    tier cannot take the shape). A warp-tier CTA holds as many documents'
    slices as fit :data:`SMEM_BYTES`, at most :data:`WARP_MAX_D`."""
    if t not in TIER_CODES:
        raise ValueError(f"unknown tier {t!r}")
    if t == "global":
        return 0, region_ints(entry, lc, pc, t)
    smem = 4 * region_ints(entry, lc, pc, t)
    if t == "warp":
        d = min(WARP_MAX_D, SMEM_BYTES // smem)
        return (smem * d, 0) if d >= 1 else None
    return (smem, 0) if smem <= SMEM_BYTES else None


def tier(entry: str, lc: int, pc: int, n: int = None) -> str:
    """The tier ``entry`` runs a launch of ``n`` documents (a large batch
    where ``None``) of widths ``lc`` and ``pc`` on: ``"warp"`` where
    :data:`WARP_MIN_DOCS` lets it and a slice fits, else ``"shared"`` where
    a document's region fits :data:`SMEM_BYTES` (config 3b's compose, the
    largest, takes 13,364 bytes at Lc 128, Pc 32; apply and invert stay
    there to Lc 28,000 and more), ``"global"`` above.
    Widths outside ``[1, MAX_LC]`` / ``[1, MAX_PC]`` raise
    ``ValueError``."""
    if entry not in ENTRIES:
        raise ValueError(f"unknown tree algebra entry {entry!r}")
    for what, v, hi in (("Lc", lc, MAX_LC), ("Pc", pc, MAX_PC)):
        if not 1 <= v <= hi:
            raise ValueError(f"{entry}: {what} {v} is outside the kernel's "
                             f"[1, {hi}]")
    fewest = WARP_MIN_DOCS.get(entry, {}).get((lc, pc))
    if (fewest is not None and (n is None or n >= fewest)
            and placement(entry, lc, pc, "warp") is not None):
        return "warp"
    return "shared" if placement(entry, lc, pc, "shared") else "global"


def _bind(cdll) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    common = [p, p, p, p, i, i, i]
    _cuda.bind(cdll, [
        (A1, common + [i, p], i),
        (A2, common + [i, i, p], i),
        (A3, common + [i, p], i),
        (A4, common + [i, p], i),
        ("tree_algebra_work_ints", [i] * 4, ll),
        ("tree_algebra_smem_bytes", [i] * 4, ll),
        ("tree_smem_budget", [], ll),
        ("tree_error_string", [i], ctypes.c_char_p),
    ])


# Widths check_library compares the library's placements at: (Lc, Pc).
_CHECK_SHAPES = ((16, 8), (128, 32), (512, 8), (2048, 8), (4096, 32),
                 (MAX_LC, MAX_PC))


def check_library(cdll) -> None:
    """Raise unless the built library's budget and every placement at
    :data:`_CHECK_SHAPES` (the warp tier's slices included) are this
    module's."""
    if cdll.tree_smem_budget() != SMEM_BYTES:
        raise RuntimeError("tree_kernels.cu SMEM_BYTES != "
                           "tree_algebra_kernel's")
    for op, entry in enumerate(ENTRIES):
        for lc, pc in _CHECK_SHAPES:
            for t, c in TIER_CODES.items():
                pl = placement(entry, lc, pc, t) or (-1, -1)
                got = (cdll.tree_algebra_smem_bytes(op, lc, pc, c),
                       cdll.tree_algebra_work_ints(op, lc, pc, c))
                if got != pl:
                    raise RuntimeError("tree_kernels.cu algebra layout != "
                                       "tree_algebra_kernel's")


def lib() -> ctypes.CDLL:
    """The tree kernel library (``_cuda.lib("tree")``, built at first use)
    with A1-A4 bound and their layout checked (once)."""
    global _lib
    if _lib is None:
        cdll = _cuda.lib("tree")
        _bind(cdll)
        check_library(cdll)
        _lib = cdll
    return _lib


def _check(ts, what: str) -> None:
    """Inputs are int32 CUDA tensors on one device, each row's elements
    contiguous."""
    for x in ts:
        if x.device.type != "cuda" or x.dtype != torch.int32:
            raise ValueError(f"{what}: inputs must be int32 CUDA tensors")
        if x.dim() == 2 and x.shape[1] > 1 and x.stride(1) != 1:
            raise ValueError(f"{what}: a lane's rows must be contiguous")
    if len({x.device for x in ts}) != 1:
        raise ValueError(f"{what}: inputs must share one device")


def _shape(x, shape, what: str) -> None:
    if not torch.is_tensor(x) or tuple(x.shape) != tuple(shape):
        got = tuple(x.shape) if torch.is_tensor(x) else type(x).__name__
        raise ValueError(f"{what} must be {tuple(shape)}, got {got}")


def _widths(changes, docs, L, what: str):
    """``(N, Lc, Pc)`` of the inputs; raises ``ValueError`` where a lane's
    shape is not the change's (``[N, Lc | Lc+1 | Pc]``), the document's
    ``[N, Lc]`` or L's ``[N]``."""
    if not (torch.is_tensor(changes[0].del_mask)
            and changes[0].del_mask.dim() == 2
            and torch.is_tensor(changes[0].ins_ids)
            and changes[0].ins_ids.dim() == 2):
        raise ValueError(f"{what}: a change's lanes must be [N, width]")
    N, Lc = changes[0].del_mask.shape
    Pc = changes[0].ins_ids.shape[1]
    for c in changes:
        for x, (name, (p, extra)) in zip(c, _LANES):
            _shape(x, (N, (Pc if p else Lc) + extra), f"{what} {name}")
    if docs is not None:
        _shape(docs, (N, Lc), f"{what} doc_ids")
    _shape(L, (N,), f"{what} L")
    return N, Lc, Pc


def out_shapes(entry: str, N: int, Lc: int, Pc: int) -> list:
    """The shapes of ``entry``'s output lanes, in the C entry's order."""
    if entry == A1:
        return [(N, Lc), (N,)]
    lanes = [(N, (Pc if p else Lc) + extra) for _n, (p, extra) in _LANES]
    return lanes + ([(N,)] if entry == A4 else [])


def _outputs(entry: str, out, N: int, Lc: int, Pc: int, dev) -> list:
    """The output lanes: ``out`` (flattened, checked) or fresh."""
    shapes = out_shapes(entry, N, Lc, Pc)
    if out is None:
        return [torch.empty(s, dtype=torch.int32, device=dev) for s in shapes]
    if entry == A4:
        out = [*out[0], out[1]]
    out = list(out)
    if len(out) != len(shapes):
        raise ValueError(f"{entry}: out must hold {len(shapes)} lanes")
    _check(out, f"{entry} out")
    for x, s in zip(out, shapes):
        _shape(x, s, f"{entry} out")
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"{entry}: out must be contiguous, on the "
                             "inputs' device")
    return out


def _stream(dev):
    """PyTorch's current CUDA stream of ``dev``, as a pointer."""
    return torch.cuda.current_stream(dev).cuda_stream


def launch(cdll, entry, t, ins, outs, dev, shape, extra=(),
           work_ints=None) -> None:
    """Call C entry ``entry`` of library ``cdll`` on tier ``t``: the input
    lanes' pointers and row strides, the output lanes' pointers, a fresh
    workspace of ``work_ints`` a document (``placement``'s by default)
    where the tier takes one, ``N, Lc, Pc``, ``extra`` ints and the stream;
    raise on a CUDA error."""
    N, Lc, Pc = shape
    if work_ints is None:
        work_ints = placement(entry, Lc, Pc, t)[1]
    work = (torch.empty(N * work_ints, dtype=torch.int32, device=dev)
            if work_ints else None)
    vp = ctypes.c_void_p
    err = getattr(cdll, entry)(
        (vp * len(ins))(*[x.data_ptr() for x in ins]),
        (ctypes.c_longlong * len(ins))(*[x.stride(0) for x in ins]),
        (vp * len(outs))(*[x.data_ptr() for x in outs]),
        work.data_ptr() if work is not None else None, N, Lc, Pc, *extra,
        TIER_CODES[t], _stream(dev))
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err}: "
                           f"{cdll.tree_error_string(err).decode()}")


def _run(wrapper, entry, t, changes, docs, L, out, extra=()):
    """Launch ``entry`` on tier ``t`` (:func:`tier`'s where ``None``) into
    ``out`` (checked, or fresh), count the launch, return the outputs as
    the plain function returns them."""
    changes = [TK.DenseChange(*c) for c in changes]
    N, Lc, Pc = _widths(changes, docs, L, entry)
    ins = [x for c in changes for x in c]
    ins = [docs, L, *ins] if docs is not None else [*ins, L]
    _check(ins, entry)
    dev = ins[0].device
    picked = tier(entry, Lc, Pc, N)
    if t is None:
        t = picked
    elif placement(entry, Lc, Pc, t) is None:
        raise ValueError(f"{entry}: tier {t} cannot take Lc {Lc}, Pc {Pc}")
    outs = _outputs(entry, out, N, Lc, Pc, dev)
    if N:
        launch(lib(), entry, t, ins, outs, dev, (N, Lc, Pc), extra)
        wrapper.launches += 1
        key = f"launches_{t}"
        setattr(wrapper, key, getattr(wrapper, key) + 1)
    if entry == A1:
        return tuple(outs)
    change = TK.DenseChange(*outs[:7])
    return (change, outs[7]) if entry == A4 else change


def apply_cuda(doc_ids, L, c, out=None, t=None):
    """A1: ``apply_change`` on the card. ``doc_ids [N, Lc]``, ``L [N]``
    and a ``DenseChange`` of ``[N, ...]`` lanes, int32, on one card.
    Returns ``(doc_ids [N, Lc], L [N])``, written into ``out`` where given.
    ``t`` names a tier (the holds'; :func:`tier`'s by default)."""
    return _run(apply_cuda, A1, t, [c], doc_ids, L, out)


def rebase_cuda(c, over, L, c_after: bool = False, out=None, t=None):
    """A2: ``rebase_change(c, over, L, c_after)`` on the card; returns a
    ``DenseChange``, written into ``out`` where given."""
    return _run(rebase_cuda, A2, t, [c, over], None, L, out,
                (int(bool(c_after)),))


def invert_cuda(doc_ids, L, c, out=None, t=None):
    """A3: ``invert_change`` on the card; returns a ``DenseChange``,
    written into ``out`` where given."""
    return _run(invert_cuda, A3, t, [c], doc_ids, L, out)


def compose_cuda(a, b, L, out=None, t=None):
    """A4: ``compose_change`` on the card; returns ``(DenseChange,
    overflow [N])``, written into ``out`` (a change and a lane) where
    given."""
    return _run(compose_cuda, A4, t, [a, b], None, L, out)


WRAPPERS = (apply_cuda, rebase_cuda, invert_cuda, compose_cuda)


def reset_counts(*wrappers) -> None:
    """Zero every launch counter (in all and by tier) of the given wrappers
    (all four by default)."""
    for w in wrappers or WRAPPERS:
        w.launches = 0
        for t in TIER_CODES:
            setattr(w, f"launches_{t}", 0)


# CUDA launches, in all and by tier (the CPU path never counts).
reset_counts()
