"""Every hand kernel on every tier it has, held bit for bit against its
plain version: the case table a memory or race checker runs, and the
repeated-launch holds.

Run on a machine with a card, from the repository's root:

    python3 -m tools.kernel_sanitize [--repeat N] [--poison] [--only TEXT]

(``--ptxas PARENT_CSRC`` compares instead every kernel's ptxas report
with an earlier tree's ``csrc/`` built without ``-lineinfo``), and under
NVIDIA's Compute Sanitizer, once a tool:

    PYTORCH_NO_CUDA_MEMORY_CACHING=1 /usr/local/cuda/bin/compute-sanitizer \\
        --tool memcheck --error-exitcode 1 python3 -m tools.kernel_sanitize

(``racecheck``, ``synccheck`` and ``initcheck`` the same way; without the
caching allocator each tensor is an allocation of its own, so a read past
one is not hidden inside another.)

:data:`CASES` holds every C entry of ``csrc/merge_kernels.cu`` and
``csrc/tree_kernels.cu`` that launches a kernel, on every tier the entry
has, at shapes small enough for the sanitizer: K1-K3 (``merge_apply``,
``merge_compact``, ``merge_apply_compact``) on the shared tier (both of
its kernels: up to 512 rows and past them), the cluster, global and split
tiers at each one's lower edge, K1 and K3 on the warp tier (one warp a
document: a table of one partial tile, 301 documents of 128 rows, 512
rows), with several documents, inserts, removes
and annotates and tombstones on both sides of the collab window, and on
every tier but the warp tier where the rows below count + 2K meet their
seams (:func:`live_cases`: one live op beside NOOPs, count 0 and count =
S, live rows that end on a slice edge); X1
(``shard_stats``) over two device groups of C > 1 CTAs a shard, two ops
in a row so the second launch finds the accumulators the first reset; X2
(``shard_resolve``) for a group of two of four shards, an op past the
document's end among its ops (ERR_RANGE); ``shard_exchange`` on one group
of C > 1 CTAs a shard; T1 and T2 (``tree_trunk_scan``,
``tree_em_ring_scan``) on the warp tier (its ring in shared memory and in
the workspace: 9 documents, a full CTA of 8 and one alone), the shared
and the global tier, T1 with moves and T2 with attach runs at 1 and 9
documents; A1-A4 (``tree_apply``, ``tree_rebase`` in both tie forms,
``tree_invert``, ``tree_compose``) on the warp, shared and global tiers
on raw lanes with duplicate move tags, compose's with tied keys and
overflowing pools.

Each case launches through the wrappers (the tier forced with ``t=``)
into outputs filled with :data:`SENTINEL`, so a lane the kernel does not
write fails, and compares every lane with the plain version on the same
inputs (the exchange kernels' accumulators too, which each launch must
leave reset). One line a case; the exit code is 1 on any mismatch, and a
CUDA error raises. ``--repeat N`` launches each case at least N times
against one plain run, round robin over the cases (so each kernel finds
the shared memory other kernels left), each call into fresh sentinel
outputs; ``--poison`` fills the caching allocator's free blocks with one
of two byte patterns before each call (in turns), so a kernel that reads
a workspace word it did not write sees a value that changes from call to
call.

The case builders (:func:`random_case`, :func:`exchange_case`,
:func:`trunk_case`, :func:`em_case`, :func:`algebra_case`) are also the
smoke's (``chip_smoke.py`` holds every kernel with them at its paths'
shapes), and the runners (:func:`merge_run` and the others) its repeat
phase's. Nothing here runs at import time, and no case needs the card to
build: on the CPU the plain versions run
(``tests/test_torch_kernel_sanitize.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import re
import subprocess
import sys
import tempfile
from typing import Callable

import numpy as np
import torch

from fluidframework_tpu_torch.ops import _cuda
from fluidframework_tpu_torch.ops import apply_kernel as K1
from fluidframework_tpu_torch.ops import compact_kernel as K2
from fluidframework_tpu_torch.ops import encode as E
from fluidframework_tpu_torch.ops import shard_exchange_kernel as SX
from fluidframework_tpu_torch.ops import tree_algebra_kernel as TAK
from fluidframework_tpu_torch.ops import tree_kernel as TK
from fluidframework_tpu_torch.ops import tree_scan_kernel as TSK
from fluidframework_tpu_torch.ops.segment_state import SEGMENT_LANES
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
    KIND_TEXT,
    NO_CLIENT,
    OP_ANNOTATE,
    OP_INSERT,
    OP_REMOVE,
    OP_WIDTH,
    RSEQ_NONE,
    UNASSIGNED_SEQ,
)
from fluidframework_tpu_torch.testing import tree_streams as TS
from fluidframework_tpu_torch.tree import device_em as DEM
from fluidframework_tpu_torch.tree import device_trunk as DT
from fluidframework_tpu_torch.utils import pow2_at_least

# What an output holds before a launch: a lane the kernel leaves unwritten
# keeps it, and no plain lane of these cases holds it.
SENTINEL = -0x5EED
# The two byte patterns --poison leaves in the allocator's free blocks.
POISON = (0x5A, 0xA5)
# Every C entry that launches a kernel, with its label.
MERGE = {"merge_apply": "K1", "merge_compact": "K2",
         "merge_apply_compact": "K3"}
EXCHANGE = {"shard_stats": "X1", "shard_resolve": "X2",
            "shard_exchange": "X12"}
TREE_SCAN = {TSK.T1: "T1", TSK.T2: "T2"}
ALGEBRA = {TAK.A1: "A1", TAK.A2: "A2", TAK.A3: "A3", TAK.A4: "A4"}
LABELS = {**MERGE, **EXCHANGE, **TREE_SCAN, **ALGEBRA}
# The tiers each entry has (the tree scans' warp tier once with its ring
# in shared memory and once in the workspace).
SCAN_TIERS = tuple(f"warp/{r}" for r in TSK.RINGS) + tuple(
    t for t in TSK.TIER_CODES if t != "warp")


def entry_tiers(entry: str) -> tuple:
    """The tiers C entry ``entry`` has: the merge tiers, none for the
    exchange, the scans' four, the algebra's three."""
    if entry in MERGE:
        return _cuda.entry_tiers(entry)
    if entry in EXCHANGE:
        return ("-",)
    if entry in TREE_SCAN:
        return SCAN_TIERS
    return tuple(TAK.TIER_CODES)


@dataclasses.dataclass
class Run:
    """One case's launch and plain version on built inputs: ``kernel()``
    launches (``launches`` a call) into fresh sentinel outputs and returns
    the lanes; ``plain()`` returns the same lanes from the plain version."""
    kernel: Callable[[], list]
    plain: Callable[[], list]
    launches: int = 1


@dataclasses.dataclass
class Case:
    """A C entry on one tier at one shape: ``make(dev)`` builds the inputs
    on ``dev`` and returns a :class:`Run`."""
    entry: str
    tier: str
    shape: str
    make: Callable[[torch.device], Run]

    @property
    def label(self) -> str:
        return LABELS[self.entry]


def _full(shape, dev):
    return torch.full(tuple(shape), SENTINEL, dtype=torch.int32, device=dev)


# -- the runners: one entry at given inputs -----------------------------------

_MERGE_FNS = {
    "merge_apply": (K1.apply_ops_packed, K1.apply_plain),
    "merge_compact": (K2.compact_packed, K2.compact_plain),
    "merge_apply_compact": (K2.apply_compact_packed, K2.apply_compact_plain),
}


def merge_run(entry: str, tables, scalars, ops, tier: str) -> Run:
    """K1, K2 or K3 on ``tier`` into sentinel tables and scalars."""
    fn, plain = _MERGE_FNS[entry]
    args = () if entry == "merge_compact" else (ops,)

    def kernel():
        out = (_full(tables.shape, tables.device),
               _full(scalars.shape, tables.device))
        fn(tables, scalars, *args, out=out, t=tier)
        return list(out)

    return Run(kernel, lambda: list(plain(tables, scalars, *args)))


def stats_run(tables, scalars, ops, groups) -> Run:
    """X1 over device groups (each a list of shard indices, its own packed
    pair and accumulators), every op of ``ops`` in a row on each: the
    stats, and the accumulators after each launch (reset)."""
    dev = tables.device
    packs = [(tables[:, g].contiguous(), scalars[g].contiguous())
             for g in groups]

    def kernel():
        lanes = []
        for t, s in packs:
            acc = SX.new_accumulators(t.shape[1], dev)
            for k in range(ops.shape[0]):
                out = _full((t.shape[1], SX.N_STATS), dev)
                SX.shard_stats(t, s, ops, k, out=out, acc=acc)
                lanes += [out, acc.clone()]
        return lanes

    def plain():
        lanes = []
        for t, s in packs:
            for k in range(ops.shape[0]):
                lanes += [SX.shard_stats_plain(t, s, ops[k]),
                          SX.new_accumulators(t.shape[1], dev)]
        return lanes

    return Run(kernel, plain, len(packs) * ops.shape[0])


def resolve_run(tables, scalars, ops, at, row_of) -> Run:
    """X2 for the group of shards ``at``, every op of ``ops``, from the
    plain stats of every shard (shard ``j`` in row ``row_of[j]``): the
    group's rows and err lanes."""
    dev = tables.device
    held = torch.argsort(row_of)
    stats = [SX.shard_stats_plain(tables, scalars, ops[k]).index_select(
        0, held) for k in range(ops.shape[0])]
    sc = scalars.index_select(0, at.long())

    def kernel():
        lanes = []
        for k in range(ops.shape[0]):
            out = _full((at.shape[0], 1, OP_WIDTH), dev)
            sck = sc.clone()
            SX.shard_resolve(stats[k], ops, k, at, row_of, sck, out=out)
            lanes += [out, sck]
        return lanes

    def plain():
        lanes = []
        for k in range(ops.shape[0]):
            lanes += list(SX.shard_resolve_plain(stats[k], ops[k], at,
                                                 row_of, sc))
        return lanes

    return Run(kernel, plain, ops.shape[0])


def exchange_run(tables, scalars, ops) -> Run:
    """``shard_exchange`` on one device group, every op of ``ops`` in a
    row on one set of accumulators: stats, rows, err lanes and the
    accumulators after each launch."""
    dev, n_g = tables.device, tables.shape[1]

    def kernel():
        lanes = []
        acc = SX.new_accumulators(n_g, dev)
        for k in range(ops.shape[0]):
            sc = scalars.clone()
            stats = _full((n_g, SX.N_STATS), dev)
            out = _full((n_g, 1, OP_WIDTH), dev)
            SX.shard_exchange(tables, sc, ops, k, stats=stats, out=out,
                              acc=acc)
            lanes += [stats, out, sc, acc.clone()]
        return lanes

    def plain():
        lanes = []
        for k in range(ops.shape[0]):
            lanes += list(SX.shard_exchange_plain(tables, scalars, ops[k]))
            lanes.append(SX.new_accumulators(n_g, dev))
        return lanes

    return Run(kernel, plain, ops.shape[0])


def _scan_out(n: int, lc: int, dev) -> tuple:
    return _full((n, lc), dev), _full((n,), dev), _full((n,), dev)


def scan_run(entry: str, args, tier: str) -> Run:
    """T1 (``args`` = docs, L, commits, W) or T2 (ring ids, ring L, ring
    seq, move watermark, commits, U) on ``tier`` (``warp/<ring>`` for the
    warp tier with its ring there) into sentinel outputs."""
    t, _, ring = tier.partition("/")
    on, plain = ((TSK.trunk_scan_on, DT.batched_trunk_scan_plain)
                 if entry == TSK.T1 else
                 (TSK.em_ring_scan_on, DEM.batched_em_trunk_scan_ring_plain))
    first = args[0]
    n, lc = first.shape[0], first.shape[-1]

    def kernel():
        return list(on(t, ring or None, *args,
                       out=_scan_out(n, lc, first.device)))

    return Run(kernel, lambda: list(plain(*args, device=first.device)))


_ALGEBRA_FNS = {
    TAK.A1: (TAK.apply_cuda, TK.apply_change),
    TAK.A2: (TAK.rebase_cuda, TK.rebase_change),
    TAK.A3: (TAK.invert_cuda, TK.invert_change),
    TAK.A4: (TAK.compose_cuda, TK.compose_change),
}


def flat(r) -> list:
    """An algebra result's lanes in the C entry's order: apply's
    ``(doc_ids, L)``, a change's seven lanes, compose's and its overflow."""
    if isinstance(r, tuple) and len(r) == 2 and isinstance(r[0],
                                                           TK.DenseChange):
        return [*r[0], r[1]]
    return list(r)


def algebra_sentinel(entry: str, args, dev):
    """Outputs of algebra entry ``entry`` at ``args`` filled with
    :data:`SENTINEL`, in the structure its wrapper's ``out`` takes."""
    c = next(x for x in args if isinstance(x, TK.DenseChange))
    N, Lc = c.del_mask.shape
    lanes = [_full(s, dev) for s in TAK.out_shapes(entry, N, Lc,
                                                    c.ins_ids.shape[1])]
    if entry == TAK.A1:
        return tuple(lanes)
    if entry == TAK.A4:
        return TK.DenseChange(*lanes[:7]), lanes[7]
    return TK.DenseChange(*lanes)


def algebra_args(entry: str, docs, L, a, b, c_after=False) -> tuple:
    """The arguments of algebra entry ``entry`` (and of its plain version
    and entry point): apply and invert take the documents and ``a``,
    rebase ``a`` over ``b`` in tie form ``c_after``, compose ``a`` then
    ``b``."""
    if entry in (TAK.A1, TAK.A3):
        return docs, L, a
    if entry == TAK.A2:
        return a, b, L, bool(c_after)
    return a, b, L


def algebra_run(entry: str, args, tier: str) -> Run:
    """A1-A4 on ``tier`` into sentinel outputs."""
    fn, plain = _ALGEBRA_FNS[entry]
    dev = next(x for x in args if torch.is_tensor(x)).device

    def kernel():
        return flat(fn(*args, out=algebra_sentinel(entry, args, dev),
                       t=tier))

    return Run(kernel, lambda: flat(plain(*args)))


# -- holding a run ------------------------------------------------------------

def first_difference(got: list, want: list):
    """``None`` where every lane is equal, else ``(lane, index, want,
    got)`` of the first differing element (a shape mismatch as index
    ``"shape"``)."""
    for i, (x, y) in enumerate(zip(got, want)):
        if x.shape != y.shape:
            return i, "shape", tuple(y.shape), tuple(x.shape)
        if not torch.equal(x, y.to(x.device)):
            bad = (x != y.to(x.device)).nonzero()[0]
            idx = tuple(int(v) for v in bad)
            return i, idx, int(y[idx]), int(x[idx])
    if len(got) != len(want):
        return len(want), "count", len(want), len(got)
    return None


def poison(dev, pattern: int, mib: int = 256) -> None:
    """Leave ``pattern`` in the caching allocator's free blocks of
    ``dev``: one large block and 64 blocks of the small pool, filled and
    freed, which the next allocations split."""
    big = torch.full((mib << 20,), pattern, dtype=torch.uint8, device=dev)
    small = [torch.full((1 << 20,), pattern, dtype=torch.uint8, device=dev)
             for _ in range(64)]
    del big, small


def hold_all(runs, launches: int = 1, poison_dev=None) -> list:
    """Run each plain version once, then launch the kernels round robin,
    one call of each a round, each into fresh sentinel outputs (the
    allocator poisoned before each call where ``poison_dev`` is given),
    until each has made at least ``launches`` launches, holding every lane
    of every call; a kernel thus finds the shared memory another case's
    kernel left. Returns ``{launches, mismatches, first}`` a run, with the
    first difference seen."""
    wants = []
    for r in runs:
        want = r.plain()
        if any(bool((y == SENTINEL).any()) for y in want):
            raise AssertionError("a plain lane holds the sentinel")
        wants.append(want)
    calls = [-(-launches // r.launches) for r in runs]
    out = [dict(launches=0, mismatches=0, first=None) for _ in runs]
    for i in range(max(calls, default=0)):
        for r, want, n, o in zip(runs, wants, calls, out):
            if i >= n:
                continue
            if poison_dev is not None:
                poison(poison_dev, POISON[i % 2])
            diff = first_difference(r.kernel(), want)
            o["launches"] += r.launches
            if diff is not None:
                o["mismatches"] += 1
                o["first"] = o["first"] or diff
    return out


# -- the case table -----------------------------------------------------------

# K1-K3's shapes a tier: (rows S, documents, ops K). The shared tier twice:
# its kernel up to 512 rows and its kernel past them (K2 has one).
MERGE_SHAPES = (("smem", 8, 3, 4), ("smem", 1024, 3, 4),
                ("cluster", 4096, 3, 4), ("global", 32_768, 3, 4),
                ("split", 131_072, 2, 4))
# K1's and K3's warp-tier shapes: (rows S, documents, ops K). One partial
# tile; more documents of 128 rows than an H100 has SMs; the widest
# table.
WARP_SHAPES = ((8, 9, 4), (128, 301, 4), (512, 9, 4))
# X1's groups: 4 shards of 8,192 rows in two device groups (2 CTAs a shard
# on a 132-SM card), counts past one CTA's share in every shard.
X1_ROWS = (8192, 5000, 8192, 6000)
X1_GROUPS = ((0, 1), (2, 3))
# T1: 9 documents x 6 commits, Lc 32, Pc 8, a ring of W 8 under the
# streams' lag window of 8, 20% moves. T2: 4 commits at Lc 32, 1 and 9
# documents. A1-A4: 9 documents at Lc 32, Pc 8 on raw lanes.
T1_SHAPE = (9, 6, 8, 32, 8, 0.2, 8)
T2_SHAPES = ((1, 4, 32), (9, 4, 32))
ALGEBRA_SHAPE = (9, 32, 8)


def merge_inputs(dev, cap: int, n_docs: int, k: int, seed: int = 0):
    """:func:`random_case`'s state and ops, the first three ops of every
    document (of as many as ``k`` gives) an insert, a remove and an
    annotate."""
    t, s, ops = random_case(np.random.default_rng(seed + cap), n_docs, cap,
                            k, "cpu")
    first = [OP_INSERT, OP_REMOVE, OP_ANNOTATE][:k]
    ops[:, :len(first), F_TYPE] = torch.tensor(first, dtype=torch.int32)
    return t.to(dev), s.to(dev), ops.to(dev)


def live_inputs(dev, cap: int, counts, k: int, live_doc=None,
                seed: int = 0):
    """:func:`merge_inputs` with document d's count set to ``counts[d]``
    (its rows from there on free), and, where ``live_doc`` is given, every
    other document's ops NOOPs (a sharded document's launch: one owner)."""
    t, s, ops = merge_inputs("cpu", cap, len(counts), k, seed)
    for d, c in enumerate(counts):
        t[:, d, c:] = 0
        t[SEGMENT_LANES.index("rseq"), d, c:] = RSEQ_NONE
        s[d, K1.SC_COUNT] = c
        if live_doc is not None and d != live_doc:
            ops[d, :, F_TYPE] = 0
    return t.to(dev), s.to(dev), ops.to(dev)


def with_past_op(ops, i: int = 1):
    """``ops`` and one more row: a copy of op ``i`` at positions past any
    document (ERR_RANGE)."""
    past = ops[i:i + 1].clone()
    past[:, F_POS1] = past[:, F_POS2] = (1 << 31) - 1
    return torch.cat([ops, past]).contiguous()


def _merge_case(entry, tier, cap, n, k):
    def make(dev):
        return merge_run(entry, *merge_inputs(dev, cap, n, k), tier)
    return Case(entry, tier, f"{n} docs x {cap:,} rows, K {k}", make)


def _live_case(entry, tier, what, cap, counts, k, live_doc=None):
    def make(dev):
        return merge_run(entry, *live_inputs(dev, cap, counts, k, live_doc),
                         tier)
    return Case(entry, tier, f"{len(counts)} docs x {cap:,} rows, K {k}, "
                f"{what}", make)


# Where live_cases meets the seams of the tiers that hold the table in
# shared memory: (tier, rows S, the row the live range ends at). The
# shared tier's kernel past 512 rows (8 warps of 64 rows at 512) and up to
# them (4 of its 8 warps of 32 rows at 128, 4 empty); the cluster tier's 4
# CTAs (4 slices of 512 rows at 2,048).
SHARED_LIVE_SHAPES = (("smem", 1024, 512), ("smem", 256, 128),
                      ("cluster", 4096, 2048))


def live_cases() -> list:
    """K1-K3 on the global and split tiers where the rows they walk
    (below min(S, count + 2K)) meet their seams: 8 documents, NOOPs in 7
    beside one live op (a sharded document's launch); count 0 and count =
    S; and live ranges that end on the last slice's edge at 2 documents
    on a 132-SM card: K1's and K3's in the first document (count + 2K =
    16,384, 16 CTAs of 1,024 rows), K2's in the second (count = 16,384: 16
    CTAs of 1,024 on the split tier, 8 of 2,048 on the global). Then the
    same on the shared and cluster tiers at :data:`SHARED_LIVE_SHAPES`
    (count 0, where every warp and CTA holds no row)."""
    cap, k = 32_768, 4
    edge = 16 * 1024 - 2 * k
    out = []
    for e in MERGE:
        for t in ("global", "split"):
            out += [_live_case(e, t, "one live op", cap, [cap // 8] * 8, 1,
                               live_doc=3),
                    _live_case(e, t, "count 0 and S", cap, [0, cap], k),
                    _live_case(e, t, "live rows end on a slice edge", cap,
                               [edge, edge + 2 * k], k)]
    return out + shared_live_cases()


def shared_live_cases() -> list:
    """K1-K3 on the shared and cluster tiers at
    :data:`SHARED_LIVE_SHAPES`: 8 documents, NOOPs in 7 beside one live
    op; count 0, 1 and S; and live ranges that end on the last warp's or
    slice's edge (K1's and K3's count + 2K in the first document, K2's
    count in the second)."""
    k = 4
    out = []
    for e in MERGE:
        for t, cap, end in SHARED_LIVE_SHAPES:
            out += [_live_case(e, t, "one live op", cap, [cap // 8] * 8, 1,
                               live_doc=3),
                    _live_case(e, t, "count 0, 1 and S", cap, [0, 1, cap], k),
                    _live_case(e, t, "live rows end on a slice edge", cap,
                               [end - 2 * k, end], k)]
    return out


def _stats_case():
    def make(dev):
        t, s, ops = exchange_case(dev, len(X1_ROWS), X1_ROWS[0], k=4,
                                  rows=np.array(X1_ROWS))
        return stats_run(t, s, ops, [list(g) for g in X1_GROUPS])
    return Case("shard_stats", "-", f"{len(X1_GROUPS)} groups x 2 shards "
                f"x {X1_ROWS[0]:,} rows, 4 ops", make)


def _resolve_case(at, row_of):
    def make(dev):
        t, s, ops = exchange_case(dev, 4, 64, k=4)
        i32 = dict(dtype=torch.int32, device=dev)
        return resolve_run(t, s, with_past_op(ops),
                           torch.tensor(at, **i32),
                           torch.tensor(row_of, **i32))
    return Case("shard_resolve", "-", f"group {list(at)} of 4 shards, "
                f"row_of {list(row_of)}, 5 ops (one past the end)", make)


def _exchange_case(n, rows):
    def make(dev):
        t, s, ops = exchange_case(dev, n, rows[0], k=4, rows=np.array(rows))
        return exchange_run(t, s, with_past_op(ops))
    return Case("shard_exchange", "-", f"1 group x {n} shard{'s' * (n > 1)} x "
                f"{rows[0]:,} rows, 5 ops (one past the end)", make)


def trunk_args(dev, n, c, W, lc, pc, move_prob, lag_w, seed=0):
    docs, L, cb = trunk_case(dev, n, c, lag_w, lc, pc, move_prob, seed)
    return docs, L, cb, W


def em_args(dev, n, c, lc, seed=0):
    rings, cb, U = em_case(dev, n, c, lc, seed=seed)
    return (*rings, cb, U)


def _scan_case(entry, tier, shape):
    if entry == TSK.T1:
        n, c, W, lc, pc, mp, lag = shape
        words = f"{n} docs x {c} commits, Lc {lc}, Pc {pc}, W {W}, moves"

        def make(dev):
            return scan_run(entry, trunk_args(dev, *shape), tier)
    else:
        n, c, lc = shape
        words = f"{n} docs x {c} commits, Lc {lc}, W 16, R 16"

        def make(dev):
            return scan_run(entry, em_args(dev, *shape), tier)
    return Case(entry, tier, words, make)


def algebra_inputs(dev, shape=ALGEBRA_SHAPE, lanes="raw"):
    n, lc, pc = shape
    return algebra_case(dev, n, lc, pc, lanes)


def _algebra_case(entry, tier, c_after=False):
    n, lc, pc = ALGEBRA_SHAPE

    def make(dev):
        return algebra_run(entry, algebra_args(entry, *algebra_inputs(dev),
                                               c_after), tier)
    form = " c_after" if c_after else ""
    return Case(entry, tier, f"{n} docs, Lc {lc}, Pc {pc}, raw lanes{form}",
                make)


def cases() -> list:
    """Every launching C entry on every tier it has (module docstring)."""
    out = [_merge_case(e, t, cap, n, k) for e in MERGE
           for t, cap, n, k in MERGE_SHAPES
           if not (e == "merge_compact" and t == "smem" and cap > 512)]
    out += [_merge_case(e, "warp", cap, n, k) for e in MERGE
            if "warp" in _cuda.entry_tiers(e) for cap, n, k in WARP_SHAPES]
    out += [_stats_case(), _resolve_case((2, 3), (3, 2, 1, 0)),
            _resolve_case((0, 1, 2, 3), (0, 1, 2, 3)),
            _exchange_case(2, (8192, 5000)), _exchange_case(1, (8192,))]
    out += [_scan_case(TSK.T1, t, T1_SHAPE) for t in SCAN_TIERS]
    out += [_scan_case(TSK.T2, t, s) for s in T2_SHAPES for t in SCAN_TIERS]
    for entry in ALGEBRA:
        for t in TAK.TIER_CODES:
            for c_after in ((False, True) if entry == TAK.A2 else (False,)):
                out.append(_algebra_case(entry, t, c_after))
    return out + live_cases()


def scan_placement(entry: str, tier: str, args):
    """The tree scans' placement of ``tier`` at ``args`` (None where the
    tier cannot take the shape)."""
    t, _, ring = tier.partition("/")
    first = args[0]
    if entry == TSK.T1:
        docs, _L, cb, W = args
        return TSK.placement(entry, docs.shape[1], cb.ins_ids.shape[2], W, 1,
                             t, 0, ring or None)
    ring_ids, _l, _s, _m, cb, U = args
    return TSK.placement(entry, first.shape[2], cb.ins_ids.shape[2],
                         first.shape[1], U, t, cb.run_start.shape[2],
                         ring or None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeat", type=int, default=1,
                    help="launches of each case at least, round robin over "
                         "the cases, each into fresh outputs")
    ap.add_argument("--poison", action="store_true",
                    help="poison the allocator's free blocks before each "
                         "launch, two byte patterns in turns")
    ap.add_argument("--only", default="",
                    help="run the cases whose label, entry or tier holds "
                         "this text")
    ap.add_argument("--list", action="store_true",
                    help="print the case table and stop")
    ap.add_argument("--ptxas", metavar="PARENT_CSRC",
                    help="compare each kernel's ptxas report with an earlier "
                         "tree's sources (built without -lineinfo) and stop")
    args = ap.parse_args(argv)
    if args.ptxas:
        return ptxas_against(args.ptxas)
    table = [c for c in cases() if args.only in
             f"{c.label} {c.entry} {c.tier}"]
    if args.list:
        for c in table:
            print(f"{c.label} {c.entry} {c.tier}: {c.shape}")
        return 0
    if not torch.cuda.is_available():
        print("kernel_sanitize: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    results = hold_all([c.make(dev) for c in table], args.repeat,
                       dev if args.poison else None)
    torch.cuda.synchronize()
    for c, r in zip(table, results):
        print(report_line(c, r), flush=True)
    bad = sum(r["mismatches"] > 0 for r in results)
    print(f"kernel_sanitize: {len(table)} cases, {bad} with mismatches on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    return 1 if bad else 0


def ptxas_kernels(report: str) -> dict:
    """``{kernel: "registers, spills, stack, shared memory"}`` from a
    ``-Xptxas -v`` report, each kernel's name without the anonymous
    namespace's hash (it depends on the source's path)."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}",
                          "_GLOBAL__N_", m.group(1))
            out[name] = ""
        elif name and ("spill" in line or "Used" in line):
            out[name] += line.split(":", 1)[-1].strip() + "; "
    return out


def ptxas_against(parent: str) -> int:
    """Build each library's source from ``parent`` (a copy of an earlier
    tree's ``fluidframework_tpu_torch/csrc``) with this tree's flags but
    ``-lineinfo``, and this tree's with :data:`_cuda.NVCC_FLAGS`; print
    each kernel whose report (registers, spills, stack, shared memory)
    differs, and a line a library. Returns 1 where any differs."""
    bare = [f for f in _cuda.NVCC_FLAGS if f != "-lineinfo"]
    differ = 0
    with tempfile.TemporaryDirectory() as tmp:
        for lib in _cuda.LIBRARIES:
            src = os.path.basename(_cuda.source(lib))
            reports = []
            for flags, path in ((bare, os.path.join(parent, src)),
                                (list(_cuda.NVCC_FLAGS), _cuda.source(lib))):
                res = subprocess.run(
                    [_cuda._nvcc(), *flags, "-o",
                     os.path.join(tmp, f"{lib}{len(reports)}.so"), path],
                    capture_output=True, text=True, timeout=600)
                if res.returncode:
                    raise RuntimeError(f"nvcc failed on {path}:\n"
                                       f"{res.stderr}")
                reports.append(ptxas_kernels(res.stderr))
            old, new = reports
            for k in sorted(set(old) | set(new)):
                if old.get(k) != new.get(k):
                    differ += 1
                    print(f"ptxas {lib} {k}: parent {old.get(k)} | this "
                          f"tree {new.get(k)}")
            print(f"ptxas {lib}: {len(new)} kernels, "
                  f"{sum(old.get(k) != new.get(k) for k in new)} differ "
                  "from the parent's", flush=True)
    return 1 if differ else 0


def report_line(case: Case, r: dict) -> str:
    """One case's line: entry, tier, shape, launches and mismatches."""
    first = f"; first difference {r['first']}" if r["first"] else ""
    return (f"case {case.label} {case.entry} {case.tier} ({case.shape}): "
            f"{r['launches']} launches, {r['mismatches']} mismatches{first}")


# -- the case builders --------------------------------------------------------

def random_case(rng, n_docs: int, cap: int, k: int, device):
    """A random packed state and op batch that reach every kernel branch:
    tables up to full (capacity overflow), positions past the visible
    length (ERR_RANGE), writer slots past the cap (ERR_CLIENT), pending
    local rows with acks of them, tombstones below and above min_seq."""
    d, s = n_docs, cap
    count = rng.integers(0, s + 1, d)
    near_full = rng.random(d) < 0.25
    count[near_full] = s - rng.integers(0, 3, near_full.sum())
    live = np.arange(s)[None, :] < count[:, None]
    shape = (d, s)
    lanes = {}
    lanes["kind"] = np.ones(shape, np.int64)
    lanes["orig"] = rng.integers(1, 40, shape)
    lanes["off"] = rng.integers(0, 6, shape)
    lanes["length"] = rng.integers(1, 6, shape)
    local_ins = rng.random(shape) < 0.1
    lanes["seq"] = np.where(local_ins, UNASSIGNED_SEQ,
                            rng.integers(1, 200, shape))
    lanes["client"] = rng.integers(0, 8, shape)
    lanes["lseq"] = np.where(local_ins, rng.integers(1, 20, shape), 0)
    rsel = rng.random(shape)
    lanes["rseq"] = np.where(rsel < 0.7, RSEQ_NONE, np.where(
        rsel < 0.8, UNASSIGNED_SEQ, rng.integers(1, 200, shape)))
    lanes["rlseq"] = np.where((rsel >= 0.7) & (rsel < 0.8),
                              rng.integers(1, 20, shape), 0)
    removed = lanes["rseq"] != RSEQ_NONE
    lanes["rbits"] = np.where(removed, 1 << rng.integers(0, 8, shape), 0)
    lanes["rbits2"] = np.zeros(shape, np.int64)
    lanes["rbits3"] = np.zeros(shape, np.int64)
    ann = rng.random(shape) < 0.2
    lanes["aseq"] = np.where(ann, rng.integers(1, 200, shape), 0)
    lanes["alseq"] = np.where(ann & (rng.random(shape) < 0.3),
                              rng.integers(1, 20, shape), 0)
    lanes["aval"] = np.where(ann, rng.integers(1, 9, shape), 0)
    fills = {"kind": 0, "rseq": RSEQ_NONE}
    tables = np.stack([
        np.where(live, lanes[n], fills.get(n, 0)) for n in SEGMENT_LANES
    ]).astype(np.int32)
    scalars = np.zeros((d, K1.N_SCALARS), np.int32)
    scalars[:, K1.SC_COUNT] = count
    scalars[:, K1.SC_MIN_SEQ] = rng.integers(0, 120, d)
    scalars[:, K1.SC_CUR_SEQ] = 200
    scalars[:, K1.SC_SELF] = np.where(rng.random(d) < 0.5, NO_CLIENT, 2)

    ops = np.zeros((d, k, OP_WIDTH), np.int32)
    ty = rng.choice(8, size=(d, k), p=[.04, .4, .2, .15, .07, .07, .05, .02])
    pos1 = rng.integers(0, 3 * s + 20, (d, k))
    local = rng.random((d, k)) < 0.2
    ops[:, :, F_TYPE] = ty
    ops[:, :, F_POS1] = pos1
    ops[:, :, F_POS2] = pos1 + rng.integers(1, 40, (d, k))
    ops[:, :, F_SEQ] = np.where(local, UNASSIGNED_SEQ,
                                201 + np.arange(k)[None, :])
    ops[:, :, F_REF] = rng.integers(100, 201, (d, k))
    ops[:, :, F_CLIENT] = np.where(rng.random((d, k)) < 0.03,
                                   rng.integers(93, 100, (d, k)),
                                   rng.integers(0, 8, (d, k)))
    ops[:, :, F_LSEQ] = rng.integers(1, 20, (d, k))
    ops[:, :, F_ARG] = rng.integers(1, 40, (d, k))
    ops[:, :, F_LEN] = rng.integers(1, 6, (d, k))
    ops[:, :, F_MSN] = 100 + np.cumsum(rng.integers(0, 4, (d, k)), axis=1)
    as_t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return as_t(tables), as_t(scalars), as_t(ops)


def exchange_case(dev, n: int, s: int, seed: int = 0, k: int = 8,
                  rows=None):
    """A packed pair of ``n`` shards of ``s`` rows and ``k`` op rows
    ``[k, OP_WIDTH]`` on ``dev`` for holding the exchange kernels: live
    rows up to each shard's count (``rows`` each where given, else random
    with one shard full), free rows past it,
    random stamps, some rows removed or unsequenced, every shard ending
    in zero-length tombstones, and inserts, removes and annotates whose
    seq, ref and writer span the stamps (some unsequenced, some the self
    client's), at positions on the shards' ends and past the document's
    end."""
    rng = np.random.default_rng(seed)
    lanes = {name: np.full((n, s), fill, np.int32) for name, fill in (
        ("kind", 0), ("length", 0), ("seq", 0), ("client", 0),
        ("rseq", RSEQ_NONE), ("rbits", 0))}
    counts = rng.integers(0, s + 1, n)
    counts[0] = s
    if rows is not None:
        counts[:] = rows
    top = 64
    for d, c in enumerate(counts):
        c = int(c)
        lanes["kind"][d, :c] = KIND_TEXT
        lanes["length"][d, :c] = rng.integers(0, 5, c)
        seq = rng.integers(1, top, c).astype(np.int32)
        seq[rng.random(c) < 0.05] = UNASSIGNED_SEQ
        lanes["seq"][d, :c] = seq
        lanes["client"][d, :c] = rng.integers(0, 4, c)
        rseq = np.where(rng.random(c) < 0.3, rng.integers(1, top, c),
                        RSEQ_NONE).astype(np.int32)
        if c:
            tail = int(rng.integers(1, min(c, 3) + 1))
            rseq[c - tail:] = rng.integers(1, 4, tail)
        lanes["rseq"][d, :c] = rseq
        lanes["rbits"][d, :c] = np.where(rseq != RSEQ_NONE,
                                         rng.integers(0, 16, c), 0)
    t = torch.zeros((K1.N_LANES, n, s), dtype=torch.int32)
    t[SEGMENT_LANES.index("rseq")] = RSEQ_NONE
    for name, arr in lanes.items():
        t[SEGMENT_LANES.index(name)] = torch.from_numpy(arr)
    sc = torch.zeros((n, K1.N_SCALARS), dtype=torch.int32)
    sc[:, K1.SC_COUNT] = torch.from_numpy(counts.astype(np.int32))
    sc[:, K1.SC_MIN_SEQ] = torch.from_numpy(rng.integers(0, 3, n).astype(
        np.int32))
    sc[:, K1.SC_SELF] = torch.from_numpy(rng.choice([NO_CLIENT, 1], n)
                                         .astype(np.int32))
    ends = np.cumsum(lanes["length"].sum(1))
    rows = []
    for i in range(k):
        seq = UNASSIGNED_SEQ if i % 4 == 3 else int(rng.integers(1, top))
        pos = int(ends[i % n]) if i % 3 != 2 else int(ends[-1]) + 1 + i
        kw = dict(seq=seq, ref=int(rng.integers(0, top + 8)),
                  client=int(rng.integers(0, 3)), lseq=i + 1)
        if i % 4 == 1:
            rows.append(E.remove(max(pos - 3, 0), pos + 5, **kw))
        elif i % 4 == 2:
            rows.append(E.annotate(max(pos - 2, 0), pos + 2, 3, **kw))
        else:
            rows.append(E.insert(pos, 1, 1, **kw))
    ops = torch.from_numpy(np.stack(rows).astype(np.int32))
    return t.to(dev), sc.to(dev), ops.to(dev)


def trunk_case(dev, n_docs, n_commits, lag_w, Lc, Pc, move_prob, seed=0):
    """T1's inputs: ``gen_streams`` streams (3 sessions lagging within
    ``lag_w``, up to 8 ids a commit, ``move_prob`` of moves), at most 64
    distinct scripts tiled over ``n_docs`` documents, empty documents."""
    scripts = min(n_docs, 64)
    streams = TS.gen_streams(np.random.default_rng(seed), scripts,
                             n_commits, n_sessions=3, W=lag_w, Lc=Lc,
                             max_ins=min(8, Pc), move_prob=move_prob)
    reps = -(-n_docs // scripts)
    cb = DT.CommitBatch(*[
        torch.from_numpy(np.ascontiguousarray(
            np.concatenate([x] * reps)[:n_docs])).to(dev)
        for x in TS.to_device_batch(streams, Lc, Pc)])
    docs = torch.zeros((n_docs, Lc), dtype=torch.int32, device=dev)
    return docs, torch.zeros(n_docs, dtype=torch.int32, device=dev), cb


def em_case(dev, n_docs, n_commits, lc, W=16, R=16, seed=0, U=None):
    """T2's inputs at one bucket, sized as ``batch_ingest`` sizes them (Pc
    a power of two >= 8, U a power of two over the ids): rings of W trunk
    states of distinct ids, 1/2 to 3/4 of Lc long, seqs rising to the
    newest at slot W-1 (every third ring starts with empty slots, seq -1);
    commits whose refs lag the head by 1-6 states; 4% deletes and 1%
    move-outs over the author view; 0-4 attach runs of 1-2 fresh ids (all R
    on commit 1). Document 1 misses the ring halfway with a move watermark
    above its ref, document 4 without one (no move-outs); the last
    document's runs carry the whole pool each, so it passes Lc. Ring ids
    lie below 2 Lc, inserted ids in [2 Lc, U) (``U`` a power of two over
    4 Lc by default)."""
    rng = np.random.default_rng(seed)
    N, C = n_docs, n_commits
    pc = pow2_at_least(max(8, lc // 8))
    U = U or pow2_at_least(4 * lc + 2)
    base = 100
    ring_ids = np.zeros((N, W, lc), np.int32)
    ring_L = np.zeros((N, W), np.int32)
    ring_seq = np.full((N, W), -1, np.int32)
    for d in range(N):
        n_empty = int(rng.integers(1, W // 2)) if d % 3 == 0 else 0
        for w in range(n_empty, W):
            n = int(rng.integers(lc // 2, 3 * lc // 4 + 1))
            ring_ids[d, w, :n] = rng.choice(np.arange(1, 2 * lc), n,
                                            replace=False)
            ring_L[d, w] = n
            ring_seq[d, w] = base - 2 * (W - 1 - w)
    seqs = np.tile(base + 3 * np.arange(1, C + 1), (N, 1)).astype(np.int32)
    lag = rng.integers(1, 7, (N, C))
    k_ago = np.arange(C)[None, :] - lag
    refs = np.where(k_ago >= 0, base + 3 * (k_ago + 1), base - 2 * lag)
    mov0 = np.full(N, -1, np.int32)
    for d in (1, 4):
        if d < N:
            refs[d, C // 2] = base - 2 * W - 5
    if N > 1:
        mov0[1] = base + 10 * C
    dm = (rng.random((N, C, lc)) < 0.04).astype(np.int32)
    mv = (rng.random((N, C, lc)) < 0.01).astype(np.int32)
    if N > 4:
        mv[4] = 0
    ic = np.zeros((N, C, lc + 1), np.int32)
    ii = rng.integers(2 * lc, U, (N, C, pc)).astype(np.int32)
    rs = np.full((N, C, R), -1, np.int32)
    rl = np.zeros((N, C, R), np.int32)
    ro = np.zeros((N, C, R), np.int32)
    for d in range(N):
        for k in range(C):
            n_runs = R if k == 1 else int(rng.integers(0, 5))
            off = 0
            for r in range(n_runs):
                n = pc if d == N - 1 else int(rng.integers(1, 3))
                at = int(rng.integers(0, 3 * lc // 4 + 1))
                rs[d, k, r], rl[d, k, r], ro[d, k, r] = at, n, off % pc
                ic[d, k, at] += n
                off += n
    lanes = (dm, ic, ii, rs, rl, ro, refs.astype(np.int32), seqs, mv)
    cb = DEM.EmCommitBatch(*[torch.from_numpy(np.ascontiguousarray(x)).to(
        dev) for x in lanes])
    rings = [torch.from_numpy(x).to(dev) for x in (ring_ids, ring_L,
                                                   ring_seq, mov0)]
    return rings, cb, U


def algebra_case(dev, n, lc, pc, lanes, seed=0, W=16) -> tuple:
    """``(docs, L, a, b)`` for the algebra holds: documents of random ids
    and lengths in [0, Lc]; ``a`` and ``b`` commits 1 and 2 of
    :func:`trunk_case`'s streams (5% moves; lane slices, rows strided) or
    raw random lanes (the card tests' ``lanes()``)."""
    rng = np.random.default_rng(seed)
    docs = torch.from_numpy(rng.integers(1, 1 << 20, (n, lc)).astype(
        np.int32)).to(dev)
    L = torch.from_numpy(rng.integers(0, lc + 1, n).astype(np.int32)).to(dev)
    if lanes == "commits":
        _d, _l, cb = trunk_case(dev, n, 3, W, lc, pc, 0.05, seed)
        ch = (cb.del_mask, cb.ins_cnt, cb.ins_ids, cb.mov_id, cb.mov_off,
              cb.pool_mid, cb.pool_off)
        return (docs, L, TK.DenseChange(*[x[:, 1] for x in ch]),
                TK.DenseChange(*[x[:, 2] for x in ch]))

    def raw():
        def sparse(shape, hi):
            return (rng.integers(0, hi, shape)
                    * (rng.random(shape) < 0.3)).astype(np.int32)
        return TK.DenseChange(*[torch.from_numpy(x).to(dev) for x in (
            sparse((n, lc), 2), sparse((n, lc + 1), 3),
            rng.integers(1, 1 << 20, (n, pc)).astype(np.int32),
            sparse((n, lc), 4), sparse((n, lc), 4), sparse((n, pc), 4),
            sparse((n, pc), 4))])

    return docs, L, raw(), raw()


def compose_ties(a, b, L) -> tuple:
    """``(ties, overflows)`` of compose's candidate keys at these inputs:
    live keys (below Lc + 2 Pc + 2) equal to an earlier live key of their
    document, and documents with more live keys than Pc."""
    keys = TK.compose_keys(a, b, L)
    big = keys.shape[1] + 2
    srt = torch.sort(keys, dim=1).values
    live = srt < big
    ties = int(((srt[:, 1:] == srt[:, :-1]) & live[:, 1:]).sum())
    over = int((live.sum(1) > a.ins_ids.shape[1]).sum())
    return ties, over


if __name__ == "__main__":
    sys.exit(main())
