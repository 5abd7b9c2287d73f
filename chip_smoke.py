"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --ab PARENT_DIR [NAME=VALUE,... ...]

Builds the hand-written kernels (``nvcc``, into the package's ``_build/``)
and the native ticket loop (``g++``), then:

1. kernels — holds K1 (merge apply), K2 (compact) and K3 (apply+compact)
   bit-exactly against their plain PyTorch versions on the card, at
   D=4096 docs x K=16 ops and S in {128, 512, 2048} rows, on random states
   and op streams that include capacity overflow, out-of-range positions,
   unknown writers, and local ops with acks; times each (median of
   CUDA-event timings) beside its byte-floor bound;
1b. the tiers above — the same at S = 4,096 and 8,192 (D=256), 16,384
   (D=64) and 65,536 (D=16) rows: all three kernels split tables of up to
   16,384 rows across a thread-block cluster and keep larger ones in
   global memory; the shared tier at S = 2,048 (D=256) beside it. At
   every shape of 1 and 1b K2 and K3 are also held, untimed, on
   :func:`compact_edge_case` (merge runs across tile and slice edges, all
   rows reclaimed, none reclaimed);
2. fleet service — drives ``TpuFleetService`` at 100,000 docs x capacity
   128 x 16 ops/doc/round: a warm-up round plus 3 timed rounds at
   compact_every=1 (a scribe sweep of n_docs/3 docs in each), then 2 rounds
   at compact_every=2 with a standalone compaction between them, so K1 and
   K2 launch too; asserts zero ticket errors, a clean device err lane, and
   final tables/scalars bit-equal to a replay through the plain versions
   from a copy of the start state; then times each kernel against its plain
   version at the main path's shapes;
3a. DocFleet, config 6 — 10,240 docs x K=32 grown from the 256-row tier to
   >= 320 live rows each through apply + compact + check_and_migrate,
   warmed to promotion quiescence, then 3 timed rounds (big_doc_ops_per_sec)
   with apply_sparse rounds on a 10% busy subset between them;
3b. DocFleet, deep tiers — 256 docs grown to >= 4,263 rows each (through
   the cluster tiers 4,096 and 8,192), then remove-heavy rounds with
   check_and_demote until a doc steps down from 4,096 to 2,048.
   Each phase-3 run is replayed op for op through a ``kernel="plain"``
   DocFleet on the card and must match it bit for bit.

Launch counts (in all, and by tier: smem / cluster / global) are reset
before each main path (2, then 3a+3b) and read after it; the DocFleet
path must launch K1 and K2 on the cluster tier. Prints the ptxas report
of every kernel entry, each phase's wall time, the card's name and power
limit, a ``{"kernels": [...]}`` line, and last ``{"ok": true, "device":
{...}}``. Any failure exits non-zero. A longer record goes to
``chip_smoke.json`` in the output directory (``OUT_DIR``).

With ``--ab PARENT_DIR``, it times instead phases 1 and 1b (and the
kernels at the DocFleet cells' other widths), the kernels at phase 2's
main shape and phases 3a and 3b's per-tier medians, for the tree unpacked
at PARENT_DIR and for this one, in turns on one card (parent, change,
change, parent; see :func:`ab`), and writes ``ab.json``.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from fluidframework_tpu_torch.ops import _cuda
from fluidframework_tpu_torch.ops import apply_kernel as K1
from fluidframework_tpu_torch.ops import compact_kernel as K2
from fluidframework_tpu_torch.ops import encode as E
from fluidframework_tpu_torch.protocol.constants import (
    ERR_CAPACITY,
    ERR_CLIENT,
    ERR_RANGE,
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
    NO_CLIENT,
    OP_INSERT,
    OP_REMOVE,
    OP_WIDTH,
    RSEQ_NONE,
    UNASSIGNED_SEQ,
)
from fluidframework_tpu_torch.ops.segment_state import SEGMENT_LANES
from fluidframework_tpu_torch.parallel.fleet import DocFleet, _Pool
from fluidframework_tpu_torch.service.fleet_service import TpuFleetService
from fluidframework_tpu_torch.utils import pow2_at_least
from fluidframework_tpu_torch.utils.native import _load_ticket

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published HBM3 rate
# (rows S, docs D) of phase 1 (the shared tier) and 1b (every tier above it
# at the widths DocFleet's deep tiers reach, the shared tier beside them).
PHASE1_SHAPES = ((128, 4096), (512, 4096), (2048, 4096))
PHASE1B_SHAPES = ((2048, 256), (4096, 256), (8192, 256), (16384, 64),
                  (65536, 16))
# The other widths the DocFleet cells compact at (config 6's pools of
# 16,384 slots, the deep cell's of 256), timed by --ab alone: the cells'
# per-tier medians mix calls on full and (in the parent) empty pools.
AB_WIDTH_SHAPES = ((256, 16384), (512, 16384), (1024, 16384), (256, 256),
                   (512, 256), (1024, 256))
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chiprun_out")

KERNELS = {
    "K1_merge_apply": dict(
        wrapper=K1.apply_ops_packed, plain=K1.apply_plain, takes_ops=True,
        entry="merge_apply",
        replaces="fluidframework_tpu/ops/pallas_kernel.py:389",
    ),
    "K2_zamboni_compact": dict(
        wrapper=K2.compact_packed, plain=K2.compact_plain, takes_ops=False,
        entry="merge_compact",
        replaces="fluidframework_tpu/ops/pallas_compact.py:186",
    ),
    "K3_fused_apply_compact": dict(
        wrapper=K2.apply_compact_packed, plain=K2.apply_compact_plain,
        takes_ops=True, entry="merge_apply_compact",
        replaces="fluidframework_tpu/ops/pallas_compact.py:273",
    ),
}


class RoundGen:
    """Config 5's ``generate_round`` (bench_configs.py): per doc, K-1
    inserts/removes at random positions and a closing whole-doc remove, so
    device tables stay bounded. Host content only — ticketing is the
    service's job."""

    def __init__(self, n_docs: int, k: int, seed: int):
        self.n, self.k = n_docs, k
        self.rng = np.random.default_rng(seed)
        self.lengths = np.zeros(n_docs, np.int64)
        self.cseqs = np.zeros(n_docs, np.int64)

    def __call__(self, svc):
        n, k = self.n, self.k
        rows = np.zeros((n, k, OP_WIDTH), np.int32)
        intents = np.zeros((n, k, 3), np.int32)
        start_seq = svc.fseq.doc_state[:, 0].astype(np.int64)
        for i in range(k):
            self.cseqs[:] += 1
            intents[:, i, 0] = 0
            intents[:, i, 1] = self.cseqs
            intents[:, i, 2] = start_seq + i
            if i == k - 1:
                rows[:, i, F_TYPE] = OP_REMOVE
                rows[:, i, F_POS1] = 0
                rows[:, i, F_POS2] = self.lengths
                self.lengths[:] = 0
            else:
                roll = self.rng.random(n)
                pos = self.rng.random(n)
                rem = (self.lengths >= 6) & (roll < 0.4)
                a = (pos * np.maximum(self.lengths - 2, 1)).astype(np.int64)
                rows[:, i, F_TYPE] = np.where(rem, OP_REMOVE, OP_INSERT)
                rows[:, i, F_POS1] = np.where(
                    rem, a, (pos * (self.lengths + 1)).astype(np.int64)
                )
                rows[:, i, F_POS2] = np.where(rem, a + 2, 0)
                rows[:, i, F_ARG] = np.where(rem, 0, 10 + i)
                rows[:, i, F_LEN] = np.where(rem, 0, 3)
                self.lengths[:] += np.where(rem, -2, 3)
        return intents, rows


class Config6Gen:
    """Config 6's traffic (``config6_big_docs`` in bench_configs.py): 16 op
    scripts tiled across the fleet, K = 32 ops per doc per round, numpy
    seed 0; 4-char inserts at random positions and 4-char removes (5% of
    ops while growing, else 50%), 8 writer slots, the collab window 64 seqs
    behind. Two extra round kinds drive the lifecycle's other paths:
    ``remove_p``/``span`` give remove-heavy rounds of wider removes (the
    shrink that leads to demotion), and :meth:`annotate_round` gives rows
    for a busy subset only (annotates change no text length, so the
    docs that sit out a round stay in step with their script)."""

    def __init__(self, n_docs: int, k: int = 32, seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self.n, self.k = n_docs, k
        self.scripts = min(16, n_docs)
        self.seqs = [0] * self.scripts
        self.lens = [0] * self.scripts

    def _tile(self, ops):
        ops[self.scripts:] = ops[np.arange(self.scripts, self.n)
                                 % self.scripts]
        return ops

    def round(self, grow: bool, remove_p=None, span: int = 4):
        p = remove_p if remove_p is not None else (0.05 if grow else 0.5)
        rng, seqs, lens = self.rng, self.seqs, self.lens
        ops = np.zeros((self.n, self.k, OP_WIDTH), np.int32)
        for d in range(self.scripts):
            for i in range(self.k):
                seqs[d] += 1
                msn = max(0, seqs[d] - 64)
                if lens[d] > 8 and rng.random() < p:
                    w = min(span, lens[d] - 4)
                    a = int(rng.integers(0, lens[d] - w))
                    ops[d, i] = E.remove(
                        a, a + w, seq=seqs[d], ref=seqs[d] - 1,
                        client=int(rng.integers(0, 8)), msn=msn,
                    )
                    lens[d] -= w
                else:
                    ops[d, i] = E.insert(
                        int(rng.integers(0, lens[d] + 1)), 10 + seqs[d], 4,
                        seq=seqs[d], ref=seqs[d] - 1,
                        client=int(rng.integers(0, 8)), msn=msn,
                    )
                    lens[d] += 4
        return self._tile(ops)

    def annotate_round(self, docs):
        """[len(docs), K, OP_WIDTH] rows for ``docs`` only: 8-char
        annotates at random positions. Idle docs skip these seqs."""
        rng, seqs, lens = self.rng, self.seqs, self.lens
        per = np.zeros((self.scripts, self.k, OP_WIDTH), np.int32)
        for d in range(self.scripts):
            for i in range(self.k):
                seqs[d] += 1
                a = int(rng.integers(0, max(lens[d] - 8, 1)))
                per[d, i] = E.annotate(
                    a, a + 8, int(rng.integers(1, 9)), seq=seqs[d],
                    ref=seqs[d] - 1, client=int(rng.integers(0, 8)),
                    msn=max(0, seqs[d] - 64),
                )
        return per[np.asarray(docs) % self.scripts]


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


def edge_case(cap: int, device, k: int = 4):
    """A packed state and op batch whose moves land exactly on the edges
    the kernels cut a table at: each doc holds ``cap - 10`` live 4-char
    rows (row r starts at visible position 4r), and its first op splits
    row e (an insert at 4e+2), places a row at e (an insert at 4e), splits
    row e twice (a remove of 4e+1..4e+3), splits rows e and e+1 (a remove
    or annotate of 4e+1..4e+5), or inserts at the very end (the new row at
    ``count``), for e at row 0, the 32-row tile edges, the edges of the
    cluster tier's first slices (SL rows each, as merge_kernels.cu cuts a
    table into slices of at most 1,024 rows), the middle and the last rows.
    The next ``k - 1`` ops hit the rows next to e."""
    count = cap - 10
    n_slices = -(-cap // 1024)
    sl = (-(-cap // n_slices) + 31) // 32 * 32
    edges = sorted({e for e in (0, 1, 30, 31, 32, 33, 63, 64, sl - 1, sl,
                                sl + 1, 2 * sl - 1, 2 * sl, 2 * sl + 1,
                                cap // 2, count - 2, count - 1)
                    if 0 <= e < count})
    firsts = []
    for e in edges:
        p = 4 * e
        firsts += [E.insert(p + 2, 7, 3, seq=101, ref=100, client=1),
                   E.insert(p, 7, 3, seq=101, ref=100, client=1),
                   E.remove(p + 1, p + 3, seq=101, ref=100, client=1),
                   E.remove(p + 1, p + 5, seq=101, ref=100, client=1),
                   E.annotate(p + 1, p + 5, 5, seq=101, ref=100, client=1),
                   E.insert(4 * count, 7, 3, seq=101, ref=100, client=1)]
    d = len(firsts)
    ops = np.zeros((d, k, OP_WIDTH), np.int32)
    for i, row in enumerate(firsts):
        ops[i, 0] = row
        p = int(row[F_POS1])
        for j in range(1, k):
            q = max(p + (j % 3) - 1, 0)
            ops[i, j] = (E.insert(q, 8 + j, 2, seq=101 + j, ref=100 + j,
                                  client=2) if j % 2 else
                         E.remove(q, q + 3, seq=101 + j, ref=100 + j,
                                  client=2))
    live = np.arange(cap)[None, :] < count
    lanes = {n: np.zeros((d, cap), np.int64) for n in SEGMENT_LANES}
    lanes["kind"][:] = 1
    lanes["orig"][:] = 1 + np.arange(cap) % 7
    lanes["length"][:] = 4
    lanes["seq"][:] = 1 + np.arange(cap) % 50
    lanes["rseq"][:] = RSEQ_NONE
    fills = {"kind": 0, "rseq": RSEQ_NONE}
    tables = np.stack([np.where(live, lanes[n], fills.get(n, 0))
                       for n in SEGMENT_LANES]).astype(np.int32)
    scalars = np.zeros((d, K1.N_SCALARS), np.int32)
    scalars[:, K1.SC_COUNT] = count
    scalars[:, K1.SC_CUR_SEQ] = 100
    scalars[:, K1.SC_SELF] = NO_CLIENT
    as_t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return as_t(tables), as_t(scalars), as_t(ops)


def compact_edge_case(cap: int, device):
    """A packed state whose compaction meets every seam the kernels cut a
    table at (32-row tiles, cluster slices of SL rows): each doc holds
    ``cap - 3`` live rows, min_seq 10, and one of nine patterns. Rows are
    splits of one insert (contiguous offsets) unless a pattern breaks the
    run; reclaimed rows are acked removals at seq 6. Patterns: none
    reclaimed (one merge run over the whole table); all reclaimed; runs
    that break one row before each tile edge; every other row reclaimed
    (no merges); zero-length reclaimed rows at the tile and slice edges (the
    run merges across them); the first slice reclaimed; only the edge rows
    kept, the rest zero-length and reclaimed (a warp's first kept row
    merges into a row many warps or CTAs back); the same with reclaimed
    rows of length 1 (nothing merges); pending stamps, local removes and
    UNASSIGNED seqs on rows that would otherwise go. Returns (tables,
    scalars, ops), ops all no-ops (K=1), for K3."""
    count = cap - 3
    n_slices = -(-cap // 1024)
    sl = (-(-cap // n_slices) + 31) // 32 * 32
    r = np.arange(cap)
    edge = np.zeros(cap, bool)
    edge[[e for e in (0, 1, 31, 32, 33, 63, 64, sl - 1, sl, sl + 1,
                      2 * sl - 1, 2 * sl, count - 1) if 0 <= e < count]] = True
    tile_edge = (r % 32 == 0) | (r % 32 == 31) | (r % sl == 0) | \
        (r % sl == sl - 1)
    pats = []
    for p in range(9):
        rec = np.zeros(cap, bool)
        length = np.full(cap, 2)
        orig = np.full(cap, 3)
        if p == 1:
            rec[:] = True
        elif p == 2:
            orig = 3 + (r + 1) // 32
        elif p == 3:
            rec = r % 2 == 1
        elif p == 4:
            rec = tile_edge & (r > 0)
            length[rec] = 0
        elif p == 5:
            rec = r <= sl
        elif p in (6, 7):
            rec = ~edge
            length[rec] = 0 if p == 6 else 1
        pats.append((rec, length, orig))
    d = len(pats)
    lanes = {n: np.zeros((d, cap), np.int64) for n in SEGMENT_LANES}
    for i, (rec, length, orig) in enumerate(pats):
        lanes["kind"][i] = 1
        lanes["orig"][i] = orig
        lanes["length"][i] = length
        lanes["off"][i] = np.concatenate([[0], np.cumsum(length)[:-1]])
        lanes["seq"][i] = 5
        lanes["client"][i] = 1
        lanes["rseq"][i] = np.where(rec, 6, RSEQ_NONE)
    # The last pattern: every row acked-removed at seq 6, but some carry a
    # pending stamp or are local removes, and some seqs are unassigned.
    last = d - 1
    lanes["rseq"][last] = np.where(r % 13 == 0, UNASSIGNED_SEQ, 6)
    lanes["rlseq"][last] = np.where((r % 7 == 0) | (r % 13 == 0), 1, 0)
    lanes["lseq"][last] = np.where(r % 11 == 0, 2, 0)
    lanes["seq"][last] = np.where(r % 11 == 0, UNASSIGNED_SEQ, 5)
    lanes["alseq"][last] = np.where(r % 17 == 0, 3, 0)
    live = r[None, :] < count
    fills = {"kind": 0, "rseq": RSEQ_NONE}
    tables = np.stack([np.where(live, lanes[n], fills.get(n, 0))
                       for n in SEGMENT_LANES]).astype(np.int32)
    scalars = np.zeros((d, K1.N_SCALARS), np.int32)
    scalars[:, K1.SC_COUNT] = count
    scalars[:, K1.SC_MIN_SEQ] = 10
    scalars[:, K1.SC_CUR_SEQ] = 100
    scalars[:, K1.SC_SELF] = NO_CLIENT
    ops = np.zeros((d, 1, OP_WIDTH), np.int32)
    as_t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return as_t(tables), as_t(scalars), as_t(ops)


def _median_ms(fn, reset, reps: int) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` launches, each on a
    freshly reset input (the reset runs outside the timed window)."""
    times = []
    for _ in range(reps):
        reset()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def reset_counts() -> None:
    _cuda.reset_counts(*(spec["wrapper"] for spec in KERNELS.values()))


def read_counts() -> dict:
    """Each kernel's launches since the last reset: in all and by tier."""
    out = {}
    for name, spec in KERNELS.items():
        w = spec["wrapper"]
        out[name] = {"all": w.launches, "smem": w.launches_smem,
                     "cluster": w.launches_cluster,
                     "global": w.launches_global}
    return out


def bound_bytes(name: str, d: int, s: int, k: int) -> int:
    """Bytes the function must move: the tables and scalars read once and
    written once, the ops read once."""
    nbytes = 2 * (K1.N_LANES * d * s * 4 + d * K1.N_SCALARS * 4)
    if KERNELS[name]["takes_ops"]:
        nbytes += d * k * OP_WIDTH * 4
    return nbytes


def hold_kernel(name: str, t0, s0, ops, kernel_reps=10, plain_reps=3):
    """Run one kernel wrapper and its plain version on the same input on
    the card; assert bit equality; return (max_abs_err, ms, plain_ms), the
    times None with ``kernel_reps=0``."""
    spec = KERNELS[name]
    args = (ops,) if spec["takes_ops"] else ()
    want = spec["plain"](t0, s0, *args)
    t, s = t0.clone(), s0.clone()
    spec["wrapper"](t, s, *args)
    torch.cuda.synchronize()
    err = max(int((t.long() - want[0].long()).abs().max()),
              int((s.long() - want[1].long()).abs().max()))
    if not (torch.equal(t, want[0]) and torch.equal(s, want[1])):
        bad = (t != want[0]).nonzero()[:5].tolist()
        raise AssertionError(f"{name}: kernel != plain, max_abs_err {err}, "
                             f"first [lane, doc, row] {bad}")
    del want

    def reset():
        t.copy_(t0)
        s.copy_(s0)

    if kernel_reps == 0:
        return err, None, None
    ms = _median_ms(lambda: spec["wrapper"](t, s, *args), reset, kernel_reps)
    plain_ms = _median_ms(lambda: spec["plain"](t0, s0, *args), lambda: None,
                          plain_reps)
    return err, ms, plain_ms


def phase_kernels(device, report, key, shapes, seed_offset=0):
    """Hold K1/K2/K3 bit for bit against their plain versions at each
    (S rows, D docs) of ``shapes`` with K = 16, on :func:`random_case`
    states; time each beside its byte-floor bound. Returns the rows."""
    rows = []
    for cap, d in shapes:
        rng = np.random.default_rng(cap + seed_offset)
        t0, s0, ops = random_case(rng, d, cap, 16, device)
        for name in KERNELS:
            err, ms, plain_ms = hold_kernel(name, t0, s0, ops)
            b = bound_bytes(name, d, cap, 16)
            tier = _cuda.tier(cap, KERNELS[name]["entry"])
            rows.append(dict(kernel=name, tier=tier, docs=d,
                             cap=cap, k=16, max_abs_err=err, ms=ms,
                             plain_ms=plain_ms,
                             bound_ms=b / HBM_BYTES_PER_S * 1e3,
                             bound_bytes=b, library_ms=None))
            print(f"kernels S={cap} D={d} ({rows[-1]['tier']}) {name}: "
                  f"exact, {ms:.4f} ms (plain {plain_ms:.3f} ms, bound "
                  f"{rows[-1]['bound_ms']:.4f} ms, library_ms null)",
                  flush=True)
        # The same kernels on moves at the tile and slice edges, untimed.
        edges = edge_case(cap, device)
        for name in KERNELS:
            hold_kernel(name, *edges, kernel_reps=0, plain_reps=0)
        # K2 and K3 on compactions that meet the tile and slice edges.
        edges = compact_edge_case(cap, device)
        for name in ("K2_zamboni_compact", "K3_fused_apply_compact"):
            hold_kernel(name, *edges, kernel_reps=0, plain_reps=0)
        del edges
        t, s = t0.clone(), s0.clone()
        K1.apply_ops_packed(t, s, ops)
        errs = s[:, K1.SC_ERR]
        cov = {bit: float(((errs & v) != 0).float().mean())
               for bit, v in (("capacity", ERR_CAPACITY),
                              ("range", ERR_RANGE), ("client", ERR_CLIENT))}
        print(f"kernels S={cap} err-bit coverage (share of docs): {cov}",
              flush=True)
        rows[-1]["err_coverage"] = cov
        del t0, s0, ops, t, s
        torch.cuda.empty_cache()
    report[key] = rows
    return rows


def print_tier_step(rows) -> None:
    """The step from the shared tier (2,048 rows) to the next tier up
    (4,096 rows, the cluster tier) at 256 docs."""
    for name in KERNELS:
        smem, up = (next(r for r in rows
                         if r["kernel"] == name and r["cap"] == cap)
                    for cap in (2048, 4096))
        print(f"tier step {name} at D=256: shared S=2048 {smem['ms']:.4f} "
              f"ms -> {up['tier']} S=4096 {up['ms']:.4f} ms "
              f"({up['ms'] / smem['ms']:.2f}x)", flush=True)


def phase_main_path(device, report, n_docs=100_000, cap=128, k=16):
    """Config 5 through the service API; returns the inputs the main-path
    kernel timings use."""
    svc = TpuFleetService(n_docs, capacity=cap, compact_every=1,
                          device=device)
    svc.join_writer(0)
    print(f"main path: {n_docs} docs x {cap} rows x {k} ops/doc/round, "
          f"native_ticket={svc.fseq.native_available}", flush=True)
    gen = RoundGen(n_docs, k, seed=0)
    start = (svc.tables.clone(), svc.scalars.clone())
    replay = []  # (plain version, ops on the card) per state update

    def commit(tok):
        due = (svc.rounds_applied + 1) % svc.compact_every == 0
        replay.append((K2.apply_compact_plain if due else K1.apply_plain,
                       tok[2]))
        err, stamped = svc.commit_round(tok)
        if err.any():
            raise AssertionError(f"{int((err != 0).sum())} docs refused")
        return stamped

    def sweep_round(tok, next_batch):
        stamped = commit(tok)
        pend = svc.begin_summarize_dirty(threshold=1, max_docs=n_docs // 3)
        nxt = svc.stage_round(*next_batch) if next_batch else None
        pend.stage()
        done = pend.finish()
        return stamped, nxt, done

    reset_counts()
    # Warm-up round (config 5: a full round, then scribe sweeps).
    t_w = time.perf_counter()
    tok = svc.stage_round(*gen(svc))
    _, tok, _ = sweep_round(tok, gen(svc))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t_w

    rounds = 3
    ev = []
    summaries = []
    # Host wall per stage of the loop, summed over the timed rounds:
    # gen = traffic generation (the client side, not the service),
    # stage_round = ticketing + stamping + op-wire upload, commit = kernel
    # enqueue, sweep = the scribe's begin + stage + finish.
    host = dict(gen=0.0, stage_round=0.0, ticket=0.0, commit=0.0, sweep=0.0)
    sweep_parts: dict = {}
    clock = time.perf_counter
    t0 = clock()
    for r in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        th = clock()
        a.record()
        stamped = commit(tok)
        b.record()
        host["commit"] += clock() - th
        ev.append((a, b))
        th = clock()
        pend = svc.begin_summarize_dirty(threshold=1, max_docs=n_docs // 3)
        host["sweep"] += clock() - th
        th = clock()
        batch = gen(svc)
        host["gen"] += clock() - th
        th = clock()
        tok = svc.stage_round(*batch)
        host["stage_round"] += clock() - th
        host["ticket"] += svc.last_ticket_s
        th = clock()
        pend.stage()
        summaries.append(pend.finish())
        host["sweep"] += clock() - th
        for key, v in pend.breakdown.items():
            sweep_parts[key] = sweep_parts.get(key, 0.0) + v
    torch.cuda.synchronize()
    dt = clock() - t0
    commit_ms = [x.elapsed_time(y) for x, y in ev]
    if int(svc.device_errors().sum()) != 0:
        raise AssertionError("device err lane is set after the timed rounds")

    # Two rounds at compact_every=2: the first applies with K1 alone and a
    # standalone compaction (K2) follows it. The state before the last
    # round and its ops are the inputs of the main-path kernel timings.
    svc.compact_every = 2
    stamped = commit(tok)
    tok = svc.stage_round(*gen(svc))
    svc.compact()
    replay.append((K2.compact_plain, None))
    pre = (svc.tables.clone(), svc.scalars.clone())
    stamped = commit(tok)
    torch.cuda.synchronize()
    launches = read_counts()
    errs = int(svc.device_errors().sum())
    if errs != 0:
        raise AssertionError(f"device err lane sum {errs} != 0")
    tele = svc.telemetry_slice(4)
    text_rows = int(svc.doc_state(0).count)
    del stamped

    # Replay every committed round through the plain versions, on the card,
    # from a copy of the start state.
    t, s = start
    for plain, ops in replay:
        t, s = plain(t, s) if ops is None else plain(t, s, ops)
    if not (torch.equal(t, svc.tables) and torch.equal(s, svc.scalars)):
        raise AssertionError("service state != plain replay")
    del t, s, start
    torch.cuda.empty_cache()

    ops_total = n_docs * k * rounds
    main = dict(
        n_docs=n_docs, cap=cap, k=k, rounds_timed=rounds,
        ops_per_s=ops_total / dt, ms_per_round=dt / rounds * 1e3,
        warmup_s=warm_s,
        host_ms_per_round={key: v / rounds * 1e3 for key, v in host.items()},
        sweep_ms_per_round={key: v / rounds for key, v in
                            sweep_parts.items()},
        k3_share_of_round=sum(commit_ms) / (dt * 1e3),
        commit_event_ms=commit_ms, launches=launches,
        summaries=summaries, native_ticket=svc.fseq.native_available,
        wire16_rounds=svc.wire16_rounds, wire32_rounds=svc.wire32_rounds,
        telemetry_rows_in_use=int(tele[:, 1].sum()), doc0_count=text_rows,
        replay_exact=True,
    )
    report["main_path"] = main
    print(f"main path: {main['ops_per_s']:.0f} ops/s, "
          f"{main['ms_per_round']:.2f} ms/round, K3 commit "
          f"{np.median(commit_ms):.4f} ms (CUDA events), host ms/round "
          f"{ {k2: round(v, 2) for k2, v in main['host_ms_per_round'].items()} }, "
          f"native_ticket={main['native_ticket']}, summaries {summaries}, "
          "replay exact", flush=True)
    print(f"main path launches: {launches}", flush=True)
    for name, n in launches.items():
        if n["all"] <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    return pre, replay[-1][1], launches


class TierTimer:
    """CUDA-event times of every DocFleet pool step (K1, or the plain
    version on a plain fleet) and compaction (K2), grouped by tier. Used as
    a context around a fleet's run; the events do not synchronize."""

    def __enter__(self):
        self.events = []
        self._step, self._compact = _Pool._step, _Pool._compact
        timer = self

        def step(pool, ops):
            timer._timed("K1", pool, ops.shape[1],
                         lambda: timer._step(pool, ops))

        def compact(pool):
            timer._timed("K2", pool, 0, lambda: timer._compact(pool))

        _Pool._step, _Pool._compact = step, compact
        return self

    def __exit__(self, *exc):
        _Pool._step, _Pool._compact = self._step, self._compact

    def _timed(self, name, pool, k, fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        kernel = "K1_merge_apply" if name == "K1" else "K2_zamboni_compact"
        bound = bound_bytes(kernel, pool.n_slots, pool.capacity, k)
        self.events.append((name, pool.capacity, pool.n_slots, bound, a, b))

    def summary(self, since: int = 0) -> dict:
        """{"K1@4096": {calls, max_slots, median_ms, total_ms,
        median_bound_ms}, ...} over the events from index ``since`` on
        (the bound is each call's byte floor at its pool's shape)."""
        torch.cuda.synchronize()
        by = {}
        for name, cap, slots, bound, a, b in self.events[since:]:
            ent = by.setdefault((name, cap), {"slots": 0, "ms": [], "b": []})
            ent["slots"] = max(ent["slots"], slots)
            ent["ms"].append(a.elapsed_time(b))
            ent["b"].append(bound / HBM_BYTES_PER_S * 1e3)
        return {f"{name}@{cap}": dict(calls=len(e["ms"]), max_slots=e["slots"],
                                      median_ms=float(np.median(e["ms"])),
                                      total_ms=float(np.sum(e["ms"])),
                                      median_bound_ms=float(np.median(e["b"])))
                for (name, cap), e in sorted(by.items())}


class Recorded:
    """A DocFleet whose calls are logged with their results, so the run can
    be replayed op for op through a second fleet. A call is a method name
    or a function of (fleet, *args)."""

    def __init__(self, fleet):
        self.fleet = fleet
        self.log = []

    def __call__(self, fn, *args):
        out = _invoke(self.fleet, fn, args)
        self.log.append((fn, args, out))
        return out


def _invoke(fleet, fn, args):
    return (getattr(fleet, fn) if isinstance(fn, str) else
            lambda *a: fn(fleet, *a))(*args)


def _same(a, b) -> bool:
    """Deep equality of call results (dicts, lists, tuples, SegmentStates,
    numpy arrays and scalars)."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, (np.ndarray, np.generic)):
        return np.asarray(a).dtype == np.asarray(b).dtype and \
            np.array_equal(a, b)
    return a == b


def scan(fleet):
    """One begin_scan / finish_scan round trip (the serving path's
    asynchronous health readback)."""
    return fleet.finish_scan(fleet.begin_scan())


def replay_and_compare(rec: Recorded, make_plain, sample):
    """Replay ``rec``'s log through a fresh ``kernel="plain"`` fleet on the
    card; every call's result, every pool's tables and scalars, the slot
    bookkeeping, placement and counters, and ``doc_states`` of ``sample``
    must match bit for bit."""
    fleet, plain = rec.fleet, make_plain()
    for fn, args, want in rec.log:
        got = _invoke(plain, fn, args)
        if not _same(want, got):
            raise AssertionError(f"plain replay: {fn} gave {got!r}, the "
                                 f"kernels gave {want!r}")
    if list(fleet.pools) != list(plain.pools):
        raise AssertionError("plain replay: pool tiers differ")
    for cap, pool in fleet.pools.items():
        other = plain.pools[cap]
        if not (torch.equal(pool.tables, other.tables)
                and torch.equal(pool.scalars, other.scalars)
                and np.array_equal(pool.doc_of_slot, other.doc_of_slot)
                and np.array_equal(pool.slot_gen, other.slot_gen)):
            raise AssertionError(f"plain replay: pool {cap} differs")
    if (fleet.placement != plain.placement
            or fleet.migrations != plain.migrations
            or fleet.demotions != plain.demotions):
        raise AssertionError("plain replay: placement or counters differ")
    if not _same(fleet.doc_states(sample), plain.doc_states(sample)):
        raise AssertionError(f"plain replay: doc_states({sample}) differ")
    del plain
    torch.cuda.empty_cache()


def _sample_docs(n_docs: int) -> list:
    return sorted({d for d in (0, 1, 17, n_docs // 3, n_docs // 2,
                               n_docs - 1) if d < n_docs})


def phase_docfleet_config6(device, report, n_docs=10_240, target=320):
    """Phase 3a: config 6 through DocFleet's entry points at its full shape
    (10,240 docs grown from the 256-row tier to >= 320 live rows each),
    then 3 timed apply + compact + check_and_migrate rounds with
    apply_sparse rounds on a 10% busy subset between them."""
    gen = Config6Gen(n_docs)
    kw = dict(n_docs=n_docs, capacity=256, high_water=0.7, device=device)
    rec = Recorded(DocFleet(**kw))
    t_grow = time.perf_counter()
    with TierTimer() as timer:
        rounds = 0
        while True:
            rec("apply", gen.round(grow=True))
            rec("compact")
            rec("check_and_migrate")
            rounds += 1
            counts = rec("doc_counts", list(range(gen.scripts)))
            if int(counts.min()) >= target:
                break
        stats = rec("stats")
        if stats["docs_with_errors"] != 0:
            raise AssertionError(f"config 6 growth: {stats}")
        for _ in range(12):  # warm up to promotion quiescence
            rec("apply", gen.round(grow=False))
            rec("compact")
            rounds += 1
            if not rec("check_and_migrate"):
                break
        grow_s = time.perf_counter() - t_grow
        busy = list(range(0, n_docs, 10))
        iters, dt, routing, gen_s, sparse = 3, 0.0, 0.0, 0.0, 0
        timed_events = []
        for it in range(iters):
            i0 = len(timer.events)
            tg = time.perf_counter()
            ops = gen.round(grow=False)
            gen_s += time.perf_counter() - tg
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec("apply", ops)
            routing += rec.fleet.last_routing_s
            rec("compact")
            rec("check_and_migrate")
            torch.cuda.synchronize()
            dt += time.perf_counter() - t0
            timed_events += timer.events[i0:]
            if it < iters - 1:
                for _ in range(2):
                    rec("apply_sparse", busy, gen.annotate_round(busy))
                    sparse += 1
        stats = rec("stats")
        if stats["docs_with_errors"] != 0:
            raise AssertionError(f"config 6 timed rounds: {stats}")
        tiers = timer.summary()
        kernel_ms = sum(ev[-2].elapsed_time(ev[-1]) for ev in timed_events)
    serving_tail(rec, gen, busy, device)
    k = gen.k
    out = dict(
        n_docs=n_docs, k=k, target_rows=target, rounds_untimed=rounds,
        big_doc_ops_per_sec=n_docs * k * iters / dt,
        timed_s=dt, ms_per_round=dt / iters * 1e3,
        live_rows_per_doc=stats["rows_in_use"] // n_docs,
        capacity_tiers=stats["pools"], migrations=stats["migrations"],
        docs_with_errors=stats["docs_with_errors"],
        routing_s=routing, routing_share=routing / dt, gen_s=gen_s,
        sparse_rounds=sparse, busy_docs=len(busy), grow_s=grow_s,
        kernel_ms_timed=kernel_ms,
        kernel_share_of_timed=kernel_ms / (dt * 1e3), tiers=tiers,
    )
    print(f"docfleet config6: {out['big_doc_ops_per_sec']:.0f} merge ops/s "
          f"({n_docs} docs x {k} ops x {iters} rounds in {dt:.3f} s), "
          f"{out['live_rows_per_doc']} rows/doc, tiers {stats['pools']}, "
          f"migrations {stats['migrations']}, host routing share "
          f"{out['routing_share']:.4f}, K1+K2 {kernel_ms:.3f} ms of the "
          f"timed rounds (share {out['kernel_share_of_timed']:.4f}), "
          f"{sparse} apply_sparse rounds over {len(busy)} busy docs, "
          f"growth {grow_s:.1f} s", flush=True)
    print(f"docfleet config6 kernel times by tier: {tiers}", flush=True)
    replay_and_compare(rec, lambda: DocFleet(kernel="plain", **kw),
                       _sample_docs(n_docs))
    out["replay_exact"] = True
    print("docfleet config6: plain replay exact", flush=True)
    report["docfleet_config6"] = out
    return out


def serving_tail(rec: Recorded, gen: Config6Gen, busy, device) -> None:
    """The entry points the serving path calls between rounds, once each
    on the card (untimed; part of the replay): a boxcar staged on the
    device through dispatch_staged, the asynchronous scan feeding
    check_and_migrate, compact_aot, the telemetry scrape, eviction and
    restore of a few docs, the overflow scan, and add_doc."""
    docs = busy[:100]
    rows = np.zeros((pow2_at_least(len(docs)), gen.k, OP_WIDTH), np.int32)
    rows[: len(docs)] = gen.annotate_round(docs)
    rec("dispatch_staged", docs, torch.from_numpy(rows).to(device))
    counts = rec(scan)
    rec("check_and_migrate", {c: a[0] for c, a in counts.items()})
    rec("compact_aot")
    rec("telemetry_slice")
    gone = rec("evict_docs", busy[100:104])
    one = rec("evict_doc", busy[104])
    for d, st in sorted(gone.items()):
        rec("restore_doc", d, st)
    rec("restore_doc", busy[104], one)
    rec("overflowing_docs")
    rec("add_doc")
    rec("doc_state", busy[101])


def phase_docfleet_deep(device, report, n_docs=256, target=4263):
    """Phase 3b: 256 docs grown to >= 4,263 live rows each, through the
    shared tiers into the global tiers 4,096 and 8,192; then remove-heavy
    rounds with check_and_demote until a doc steps down from 4,096 to
    2,048 (compacting a global-tier pool first)."""
    gen = Config6Gen(n_docs)
    kw = dict(n_docs=n_docs, capacity=256, high_water=0.7, device=device)
    rec = Recorded(DocFleet(**kw))
    t0 = time.perf_counter()
    with TierTimer() as timer:
        grow_rounds = 0
        while True:
            rec("apply", gen.round(grow=True))
            rec("compact")
            rec("check_and_migrate")
            grow_rounds += 1
            if int(rec("doc_counts", list(range(gen.scripts))).min()) \
                    >= target:
                break
        grown = rec("stats")
        if grown["docs_with_errors"] != 0:
            raise AssertionError(f"deep growth: {grown}")
        shrink_rounds = 0
        # Every doc sits at 4,096 rows or above now and demotion steps one
        # tier at a time, so a doc at 2,048 or below has crossed from the
        # global tier into the shared one (one pass may step it twice).
        while not any(p is not None and p[0] <= 2048
                      for p in rec.fleet.placement):
            if shrink_rounds >= 60:
                raise AssertionError("no doc stepped down to 2048 rows")
            rec("apply", gen.round(grow=False, remove_p=0.9, span=64))
            rec("compact")
            rec("check_and_demote")
            shrink_rounds += 1
        stats = rec("stats")
        if stats["docs_with_errors"] != 0:
            raise AssertionError(f"deep shrink: {stats}")
        tiers = timer.summary()
    wall = time.perf_counter() - t0
    caps = sorted({p[0] for p in rec.fleet.placement if p is not None})
    out = dict(n_docs=n_docs, target_rows=target, grow_rounds=grow_rounds,
               shrink_rounds=shrink_rounds, tiers_reached=grown["pools"],
               rows_grown=grown["rows_in_use"] // n_docs,
               migrations=stats["migrations"], demotions=stats["demotions"],
               doc_tiers_now=caps, wall_s=wall, tiers=tiers)
    print(f"docfleet deep: {grow_rounds} growth rounds to "
          f"{out['rows_grown']} rows/doc, tiers {grown['pools']}, "
          f"{shrink_rounds} shrink rounds, migrations {stats['migrations']}, "
          f"demotions {stats['demotions']}, docs now in tiers {caps}",
          flush=True)
    print(f"docfleet deep kernel times by tier: {tiers}", flush=True)
    replay_and_compare(rec, lambda: DocFleet(kernel="plain", **kw),
                       _sample_docs(n_docs))
    out["replay_exact"] = True
    print("docfleet deep: plain replay exact", flush=True)
    report["docfleet_deep"] = out
    return out


_AB_RUN = """
import json, torch
import chip_smoke as c
{patch}
dev = torch.device("cuda", 0)
rep = {{}}
rows = c.phase_kernels(dev, rep, "k", {p1})
rows += c.phase_kernels(dev, rep, "g", {p1b}, 1)
rows += c.phase_kernels(dev, rep, "w", {pw}, 2)
(t0, s0), ops, _ = c.phase_main_path(dev, rep)
for name in c.KERNELS:
    err, ms, plain_ms = c.hold_kernel(name, t0, s0, ops)
    rows.append(dict(kernel=name, cap=t0.shape[2], docs=t0.shape[1], ms=ms))
del t0, s0, ops
torch.cuda.empty_cache()
cfg6 = c.phase_docfleet_config6(dev, rep)
deep = c.phase_docfleet_deep(dev, rep)
ptxas = [x.strip() for x in c._cuda.build_log.splitlines()
         if "registers" in x or "spill" in x or "Compiling" in x]
print("AB_JSON " + json.dumps(dict(rows=rows, config6=cfg6["tiers"],
                                   deep=deep["tiers"], ptxas=ptxas)))
"""


def _variant_source(spec: str, tag: str) -> str:
    """A copy of this tree's kernel source with the ``constexpr int``
    constants of ``spec`` ("NAME=VALUE,NAME=VALUE") changed, written under
    ``OUT_DIR``; returns its path."""
    with open(_cuda.SOURCE) as f:
        src = f.read()
    for item in spec.split(","):
        name, value = item.split("=")
        pat = re.compile(rf"constexpr int {name} = -?\d+;")
        if len(pat.findall(src)) != 1:
            raise AssertionError(f"kernel source has no one {name} constant")
        src = pat.sub(f"constexpr int {name} = {int(value)};", src)
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, f"merge_kernels_{tag}.cu")
    with open(path, "w") as f:
        f.write(src)
    return path


def ab(parent: str, variants=()) -> int:
    """Phase 1 and 1b kernel times, the same at :data:`AB_WIDTH_SHAPES`,
    the kernels' times at phase 2's main shape and phases 3a and 3b's
    per-tier medians (and calls) of the tree
    at ``parent`` (an unpacked earlier commit) and of this tree, each
    run in its own process on this card in turns: parent, change, then
    each variant twice, then change, parent. A variant is this tree with
    the kernel constants of one spec of ``variants`` ("NAME=VALUE,...")
    changed; a variant that fails is reported and skipped. Prints the
    times of each tree and their ratios to the parent's means, and writes
    every run (with its ptxas report) to ``ab.json`` in the output
    directory."""
    here = os.path.dirname(os.path.abspath(__file__))
    trees = {"parent": (os.path.abspath(parent), ""), "change": (here, "")}
    order = ["parent", "change"]
    for i, spec in enumerate(variants):
        label = f"v{i + 1}"
        trees[label] = (here, "import fluidframework_tpu_torch.ops._cuda "
                        "as cu; cu.SOURCE = "
                        f"{_variant_source(spec, label)!r}")
        order += [label, label]
        print(f"ab: {label} = {spec}", flush=True)
    order += ["change", "parent"]
    runs = []
    for label in order:
        tree, patch = trees[label]
        code = _AB_RUN.format(patch=patch, p1=PHASE1_SHAPES,
                              p1b=PHASE1B_SHAPES, pw=AB_WIDTH_SHAPES)
        t = time.perf_counter()
        res = subprocess.run([sys.executable, "-c", code], cwd=tree,
                             env=dict(os.environ, PYTHONPATH=tree),
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            if label.startswith("v"):  # a trial; the parent/change pair stands
                print(f"ab: {label} failed", flush=True)
                continue
            raise AssertionError(f"A/B run of {label} failed")
        line = next(x for x in res.stdout.splitlines()
                    if x.startswith("AB_JSON "))
        runs.append(dict(label=label, wall_s=time.perf_counter() - t,
                         **json.loads(line[len("AB_JSON "):])))
        print(f"ab: {label} run in {runs[-1]['wall_s']:.1f} s", flush=True)
    means, calls = {}, {}
    for run in runs:
        for r in run["rows"]:
            key = (r["kernel"], r["cap"], r["docs"])
            means.setdefault(key, {}).setdefault(run["label"], []).append(
                r["ms"])
        for cell in ("config6", "deep"):
            for key, v in run[cell].items():
                means.setdefault((f"{cell} {key}", 0, 0), {}).setdefault(
                    run["label"], []).append(v["median_ms"])
                calls.setdefault(f"{cell} {key}", {}).setdefault(
                    run["label"], []).append(v["calls"])
    for (name, cap, docs), by in means.items():
        m = {label: float(np.mean(v)) for label, v in by.items()}
        ratios = ", ".join(f"{label} {m[label] / m['parent']:.3f}"
                           for label in m if label != "parent"
                           and "parent" in m)
        print(f"ab {name} S={cap} D={docs}: " + ", ".join(
            f"{label} {v}" for label, v in by.items())
            + f" (/parent: {ratios})", flush=True)
    for key, by in calls.items():
        print(f"ab calls {key}: " + ", ".join(
            f"{label} {v}" for label, v in by.items()), flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "ab.json"), "w") as f:
        json.dump(runs, f, indent=1)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    report = {"torch": torch.__version__, "cuda": torch.version.cuda,
              "python": sys.version.split()[0]}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    report["card"] = smi

    t_b = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        so = pool.submit(_cuda.build)
        ticket = pool.submit(_load_ticket)
        so.result()
        ticket.result()
    report["build_s"] = time.perf_counter() - t_b
    print(f"build: {report['build_s']:.1f} s", flush=True)
    for line in _cuda.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("ptxas:", line.strip(), flush=True)

    wall = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        wall[name] = time.perf_counter() - t
        print(f"phase {name}: {wall[name]:.1f} s", flush=True)
        return out

    # Phase 1: the shared tier at 4,096 docs. Phase 1b: the tiers above it
    # (the cluster tier up to 16,384 rows, the global tier) at the widths
    # DocFleet's deep tiers reach, with the shared tier at the same 256
    # docs beside them.
    timed("1_kernels", phase_kernels, device, report, "phase_kernels",
          PHASE1_SHAPES)
    glob = timed("1b_global_kernels", phase_kernels, device, report,
                 "phase_global_kernels", PHASE1B_SHAPES, 1)
    print_tier_step(glob)
    # Each main path runs with every launch count set to 0 just before it
    # and read just after.
    (t0, s0), ops, launches2 = timed("2_fleet_service", phase_main_path,
                                     device, report)
    torch.cuda.empty_cache()

    # Each kernel against its plain version at the main path's shapes.
    d, cap = t0.shape[1], t0.shape[2]
    k = ops.shape[1]
    main_shape = {}
    for name in KERNELS:
        err, ms, plain_ms = hold_kernel(name, t0, s0, ops)
        main_shape[name] = (err, ms, plain_ms, bound_bytes(name, d, cap, k))
        print(f"main-path shape {name}: {ms:.4f} ms (plain {plain_ms:.2f} "
              f"ms, bound {main_shape[name][3] / HBM_BYTES_PER_S * 1e3:.4f} "
              "ms)", flush=True)
    del t0, s0, ops
    torch.cuda.empty_cache()

    reset_counts()
    timed("3a_docfleet_config6", phase_docfleet_config6, device, report)
    timed("3b_docfleet_deep", phase_docfleet_deep, device, report)
    launches3 = read_counts()
    print(f"docfleet launches: {launches3}", flush=True)
    for name, tier in (("K1_merge_apply", "cluster"),
                       ("K2_zamboni_compact", "cluster")):
        if launches3[name][tier] <= 0:
            raise AssertionError(f"{name}: no {tier}-tier launch on the "
                                 "DocFleet path")
    report["wall_s"] = wall

    kernels = []
    for name, spec in KERNELS.items():
        err, ms, plain_ms, b = main_shape[name]
        by_path = {"fleet_service": launches2[name],
                   "docfleet": launches3[name]}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "fluidframework_tpu_torch/csrc/merge_kernels.cu",
            "replaces": spec["replaces"],
            "launches": sum(p["all"] for p in by_path.values()),
            "launches_smem": sum(p["smem"] for p in by_path.values()),
            "launches_cluster": sum(p["cluster"] for p in by_path.values()),
            "launches_global": sum(p["global"] for p in by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(err, max(r["max_abs_err"] for r in glob
                                        if r["kernel"] == name)),
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None,
            "by_tier": [{key: r[key] for key in
                         ("tier", "docs", "cap", "k", "ms", "plain_ms",
                          "bound_ms")}
                        for r in glob if r["kernel"] == name],
        })
    report["kernels"] = kernels
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)

    print(f"phase wall s: { {n: round(v, 1) for n, v in wall.items()} }")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--ab":
        if not torch.cuda.is_available():
            sys.exit("chip_smoke: no CUDA device; nothing was run")
        sys.exit(ab(sys.argv[2], sys.argv[3:]))
    sys.exit(main())
