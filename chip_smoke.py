"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --ab PARENT_DIR [NAME=VALUE,... ...]
    python3 chip_smoke.py --tree [NAME=VALUE ...]
    python3 chip_smoke.py --client
    python3 chip_smoke.py --mesh
    python3 chip_smoke.py --load [reference]

Builds the hand-written kernels (``nvcc``, into the package's ``_build/``)
and the native ticket loop, blob store, partition log and lease
coordination (``g++``), all at once, then:

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
   DocFleet on the card and must match it bit for bit;
4. serving stage — config 7 (``config7_pipeline_serving``): a
   ``DeviceFleetBackend`` (capacity 128, boxcars up to 131,072 rows,
   compaction every 8th flush, the pump with a ring of 2) fed through
   12,288 ``TpuDeliLambda``s 16 rounds of one 8-op ``SeqFrame`` per
   document (inserts at position 0, removes on every 4th document from
   round 12; every document promotes from 128 to 256 rows), a redelivered
   round, a JSON-wire round for 64 documents, one batched read of 4,096
   channels, texts and summaries of 64, a telemetry scrape; then a
   residency sub-run (512 channels, 128 hibernated, parked and woken,
   against a twin that never hibernated). Both runs are replayed call for
   call through a ``kernel="plain"`` backend on the card, bit for bit.
   Prints merge ops/s and ms per round over rounds 2-16, the flush split
   (staging / dispatch / routing), the device idle share ``1 -
   pump_busy_s / wall``, K1/K2 CUDA-event times per call and launches;
5. ordering pipeline — config 7 through ``PipelineFluidService``
   (``config7_pipeline_serving``): 8 partitions, 12,288 writers joined
   through deli, a warm-up round and 8 timed rounds of one 8-op
   ``OpFrame`` per document through the bulk front door, deli, the
   deltas log, scribe, scriptorium, broadcaster, signals, foreman and the
   device stage (each stage's wall timed), ``flush_device`` per round;
   texts and summaries of 64 documents, every durable log contiguous, the
   run's deltas replayed through a ``kernel="plain"`` backend (every
   channel bit for bit), and the JSON wire at 1,024 documents on a second
   service;
6. socket front door — the ``docker-compose.yml`` deployment at config
   7's scale: a store node subprocess (``service/store_server.py`` on the
   native disk log and blob store), the front door built by
   ``server_main`` from ``config/config.json`` over it, 12,288 channels
   loaded before it starts, then a client subprocess (``--socket-client``:
   the port's network driver on the CPU) with 96 websocket writers (a
   warm-up and 4 timed bursts of one 8-op frame each) and 1,024
   concurrent REST channel reads; the served state replayed from the
   store node's deltas log through a ``kernel="plain"`` backend and
   restored by a replacement front door (both bit for bit by key), and
   ``python3 -m fluidframework_tpu_torch.service.server_main`` run as a
   subprocess (listening line, one acked frame, ``/metrics``, exit 0 on
   SIGTERM);
7. SharedTree rebase path — no hand kernel of its own (its device code is
   plain PyTorch): 7a config 3b, ``batched_trunk_scan`` over 1,024 docs
   (Lc 128, Pc 32, W 16) staged on the card once, a warm-up and 3 timed
   scans, every distinct script held to the host trunk; 7b configs 3c and
   3c-moves through ``batch_ingest`` over ``EditManager(device=cuda)``s,
   every distinct script held to the host EditManager; 7c config 3
   through ``ContainerRuntime`` + ``SharedTree(device=cuda)``, replicas
   converged. The scans run under ``torch.cuda.set_sync_debug_mode(
   "error")`` and are held bit for bit to the same function on the CPU
   for 16 documents; launches and device time a step come from
   ``torch.profiler``;
8. client merge path — under ``torch.cuda.set_sync_debug_mode("warn")``:
   8a config 1 (``config1_single_doc_replay``): the 10,000-op author with
   ``SharedString(device=cuda)``, readers replaying its deltas log through
   ``ReplayDocumentService`` on the card (timed, syncs counted over 1,000
   messages; every op timed, launches counted by table width) and on the
   CPU, the card equal to the author's text and the CPU's lanes; 8b config
   2b (2,048 docs x 256 x K 16, 50 steps, K3 every 4th) and 8c config 4
   (20,000 kernel docs x 256 x K 64 through ``merge_kernel``'s batched
   API), each replayed through the plain versions; 8d three runtimes with
   a SharedString (two interval collections), SharedMatrix, SparseMatrix
   and SharedMap, undo-redo and a reconnect, converged and equal to the
   same script on the CPU; 8e ``server_main`` and the port's smoke client;
   then K1/K2/K3 held against their plain versions at one document on
   every tier and at 8b's and 8c's shapes;
9. scale-out — the port's device list set to 8 x ``cuda:0`` (the
   counterpart of the reference's 8-device test mesh): 9a
   ``fleet_mesh_comparison``'s shape (bench.py:319-383), DocFleet(12,288,
   128) x K 8 x 3 rounds with and without ``mesh=``, on that list and on
   the list of every visible card, every mesh pool equal to the no-mesh
   fleet's; 9b ``serving_pump_benchmark``'s shape (bench.py:387-510),
   DeviceFleetBackend(capacity=1,024, max_batch=1<<20) with 4,096
   channels x K 16 x 12 rounds after a compaction cadence of warm-up,
   pump and one-shot on the mesh and the pump without it, all equal to a
   ``kernel="plain"`` replay; 9c ``config/config.json`` with
   ``device_sharded_overflow=True`` through PipelineFluidService's bulk
   front door: one document grows through every tier, re-homes past
   49,152 live rows into a ShardedDoc of 8 x 65,536 rows and goes on past
   80,000, its text equal to a host string, the 1,000 ops after promotion
   replayed through ``kernel="plain"`` from a clone shard for shard, one
   apply and one compaction under sync-debug "error", and on the list of
   every visible card (one card: 524,288 rows a shard) the promotion
   refused before anything moves: the document keeps its top-tier slot
   and lanes, then trips ERR_CAPACITY as a backend without sharded
   overflow does; 9d tests/test_multinode.py's failover and fencing at 3
   nodes x 1,024 documents over ``NativeCoordination``. K1/K2 held
   against their plain versions at the mesh shard's and the sharded
   document's shapes;
10. the oracle, the load harness and the other DDS models — 10a
   bench.py's ``device_state_parity`` at 4,096 docs x 256 rows and 256
   docs x 4,096 rows (the shared and the cluster tier), 96 ops a document
   from the port's ``random_acked_stream`` (msn lag 24, refs caught up):
   K1 half, K2, K1 half, K2 on the card, every document's text equal to
   its ``OracleDoc``'s, err lanes clear, lanes equal to the plain
   versions'; 10b ``CHAOS_STRESS_FULL_PROFILE`` (48 clients, trees, the
   elected summarizer, GC, client offline windows and service chaos; its
   3,000 ops cut to ``SMOKE_LOAD_OPS`` here, all of them with ``--load``)
   through the port's ``LoadRunner`` over
   ``PipelineFluidService(n_partitions=4)``, the device stage and every
   replica's string and tree on the card: converged, the counts of the
   profile, a late joiner's text; the card's busy share sampled from
   ``nvidia-smi``; then the CI-sized full-stack profile (16 x 600) on the
   card and on the CPU (a spawned process), reports and late joiners
   equal; 10c three runtimes with the twelve models of ``models/``
   beyond the merge path and a ``SharedString`` on the card, a seeded
   script with an offline window, converged and equal to the CPU run.

Launch counts (in all, and by tier: smem / cluster / global) are reset
before each main path (2, then 3a+3b, then 4, then 5, then 6's client
run, then each of 8a-8e, then each run of 9a-9c, then each of 10a-10c)
and read after it;
the DocFleet path must launch K1 and K2 on the cluster tier. Prints the
ptxas report of every kernel entry, each phase's wall time, the card's
name and power limit, a ``{"kernels": [...]}`` line, and last ``{"ok":
true, "device": {...}}``. Any failure exits non-zero. A longer record goes to
``chip_smoke.json`` in the output directory (``OUT_DIR``).

With ``--ab PARENT_DIR``, it times instead phases 1 and 1b (and the
kernels at the DocFleet cells' other widths), the kernels at phase 2's
main shape and phases 3a and 3b's per-tier medians, for the tree unpacked
at PARENT_DIR and for this one, in turns on one card (parent, change,
change, parent; see :func:`ab`), and writes ``ab.json``.

With ``--server N``, it builds the kernels and native libraries and runs
only phase 6, ``N`` times in one process (the socket path's repeat check;
see :func:`server_repeat`), and writes ``server_repeat.json``.

With ``--tree``, it runs only phase 7 (``phase_tree``'s keyword arguments
as ``NAME=VALUE``, e.g. ``b_commits=1000``) and writes ``tree.json``.

With ``--client``, it builds the kernels and native libraries and runs
only phase 8, and writes ``client.json``.

With ``--mesh``, it builds the kernels and native libraries and runs only
phase 9, and writes ``mesh.json``.

With ``--load``, it builds the kernels and native libraries and runs only
phase 10, and writes ``load.json``; ``--load reference`` runs instead
10b's harness on ``CHAOS_REFERENCE_PROFILE`` (120 clients x 10,000 ops,
the upstream ci profile) and writes ``load_reference.json``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import signal
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
    KIND_TEXT,
    NO_CLIENT,
    OP_INSERT,
    OP_REMOVE,
    OP_WIDTH,
    RSEQ_NONE,
    UNASSIGNED_SEQ,
)
from fluidframework_tpu_torch.ops import tree_kernel as TK
from fluidframework_tpu_torch.ops.segment_state import SEGMENT_LANES
from fluidframework_tpu_torch.parallel.fleet import DocFleet, _Pool
from fluidframework_tpu_torch.protocol.opframe import OpFrame, SeqFrame
from fluidframework_tpu_torch.protocol.types import (
    DocumentMessage,
    MessageType,
    SequencedDocumentMessage,
)
from fluidframework_tpu_torch.runtime.op_lifecycle import pack_batch
from fluidframework_tpu_torch.service.device_backend import DeviceFleetBackend
from fluidframework_tpu_torch.service.device_lambda import TpuDeliLambda
from fluidframework_tpu_torch.service.fleet_service import TpuFleetService
from fluidframework_tpu_torch.service.lambdas import (
    DELTAS_TOPIC,
    RAW_TOPIC,
    CheckpointStore,
    DocumentLambda,
    PartitionRunner,
)
from fluidframework_tpu_torch.service.pipeline import (
    PipelineConnection,
    PipelineFluidService,
)
from fluidframework_tpu_torch.testing import tree_streams as TS
from fluidframework_tpu_torch.tree import device_em as DEM
from fluidframework_tpu_torch.tree import device_trunk as DT
from fluidframework_tpu_torch.tree import edit_manager as TEM
from fluidframework_tpu_torch.tree import marks as TM
from fluidframework_tpu_torch.utils import pow2_at_least
from fluidframework_tpu_torch.utils.native import (
    _load_ticket,
    native_coordination_available,
    native_plog_available,
    native_store_available,
)

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

# Every library the smoke builds, all started together: the kernels
# (nvcc) and the native ticket loop, blob store, partition log and lease
# coordination (g++).
BUILDS = (_cuda.build, _load_ticket, native_store_available,
          native_plog_available, native_coordination_available)

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


ALPHABET = "abcdefghijklmnopqrstuvwxyz"


class ServingTraffic:
    """Config 7's traffic (``_config7_measure`` in bench_configs.py) as
    deli hands it to the device stage: per round, one ``SeqFrame`` of ``k``
    single-character inserts at position 0 per document on channel
    ``"s"``; seqs, refs and the collab window advance per document, the
    content id (``orig``) is the seq and the text its letter. From round
    ``remove_from`` on, every 4th document's last two ops are removes (so
    compaction reclaims rows). :meth:`json_round` gives a few ops per
    document on the per-op JSON wire, compressed for every other
    document. :meth:`expected` is a document's text."""

    def __init__(self, n_docs: int, k: int = 8, remove_from: int = 12,
                 prefix: str = "d"):
        self.n, self.k, self.remove_from = n_docs, k, remove_from
        self.docs = [f"{prefix}{i}" for i in range(n_docs)]
        self.heads = np.zeros(n_docs, np.int64)
        self.rounds = 0
        self.texts = [[] for _ in range(n_docs)]  # expected text per doc

    def frames(self):
        """One round: [(doc, SeqFrame)] for every document."""
        n, k = self.n, self.k
        ar = np.arange(k, dtype=np.int64)
        seqs = self.heads[:, None] + 1 + ar[None, :]
        rows = np.zeros((n, k, OP_WIDTH), np.int32)
        rows[:, :, F_TYPE] = OP_INSERT
        rows[:, :, F_LEN] = 1
        rows[:, :, F_SEQ] = seqs
        rows[:, :, F_REF] = self.heads[:, None]
        rows[:, :, F_MSN] = self.heads[:, None]
        rows[:, :, F_ARG] = seqs
        rem = (self.rounds >= self.remove_from) & (np.arange(n) % 4 == 0)
        for j in (k - 2, k - 1):
            rows[rem, j, F_TYPE] = OP_REMOVE
            rows[rem, j, F_POS1] = 2
            rows[rem, j, F_POS2] = 3
            rows[rem, j, F_LEN] = 0
            rows[rem, j, F_ARG] = 0
        cache = {}
        out = []
        for i, doc in enumerate(self.docs):
            h, r = int(self.heads[i]), bool(rem[i])
            texts = cache.get((h, r))
            if texts is None:
                texts = cache[(h, r)] = tuple(
                    ALPHABET[(h + 1 + j) % 26] for j in range(k - 2 * r))
            t = self.texts[i]
            t[0:0] = texts[::-1]
            if r:
                del t[2:4]
            out.append((doc, SeqFrame("s", 0, h + 1, rows[i], texts, 0.0)))
        self.heads += k
        self.rounds += 1
        return out

    def json_round(self, docs, n_ops: int = 5):
        """[(doc, wire message)]: ``n_ops`` inserts at position 0 for each
        doc index of ``docs``, as sequenced per-op JSON wire messages,
        packed compressed (one head and placeholders) for every other
        doc."""
        out = []
        for j, i in enumerate(docs):
            h = int(self.heads[i])
            envs = [{"address": "s", "contents": {
                "k": "ins", "pos": 0, "orig": h + 1 + o,
                "text": ALPHABET[(h + 1 + o) % 26]}} for o in range(n_ops)]
            wire = pack_batch(envs,
                              compression_threshold=64 if j % 2 else None)
            for o, w in enumerate(wire):
                out.append((self.docs[i], SequencedDocumentMessage(
                    client_id=0, sequence_number=h + 1 + o,
                    client_sequence_number=o + 1,
                    reference_sequence_number=h, minimum_sequence_number=h,
                    type=MessageType.OPERATION, contents=w.contents,
                    metadata=w.metadata)))
            self.texts[i][0:0] = [e["contents"]["text"] for e in envs][::-1]
            self.heads[i] += len(wire)
        return out

    def expected(self, i: int) -> str:
        return "".join(self.texts[i])


class ServingRun:
    """A ``DeviceFleetBackend`` behind one ``TpuDeliLambda`` per document,
    whose calls are logged with their results, so the run can be replayed
    call for call through a second backend (:func:`replay_serving`)."""

    def __init__(self, backend):
        self.be = backend
        self.lams = {}
        self.log = []

    def handle(self, doc, value):
        lam = self.lams.get(doc)
        if lam is None:
            lam = self.lams[doc] = TpuDeliLambda(doc, self.be)
        out = lam.handler(doc, value)
        self.log.append(("handle", (doc, value), out))
        return out

    def __call__(self, name, *args):
        out = getattr(self.be, name)(*args)
        self.log.append((name, args, out))
        return out


# Calls whose results depend on the wall clock, not on the state: the
# feed deadline decides how a round's work splits between pump_feed and
# the next flush, and stats carry the trigger counts.
_CLOCKED = ("pump_feed", "stats")


def replay_serving(run: ServingRun, make_plain, sample_keys) -> None:
    """Replay ``run``'s log through a fresh ``kernel="plain"`` backend on
    the card: every result (but :data:`_CLOCKED`'s), every pool's tables,
    scalars and slot bookkeeping, placement, the watermarks, the payloads,
    and the texts and summaries of ``sample_keys`` must match bit for
    bit."""
    plain = ServingRun(make_plain())
    for name, args, want in run.log:
        got = plain.handle(*args) if name == "handle" else plain(name, *args)
        if name not in _CLOCKED and not _same(want, got):
            raise AssertionError(f"serving replay: {name} gave {got!r}, "
                                 f"the kernels gave {want!r}")
    a, b = run.be, plain.be
    if list(a.fleet.pools) != list(b.fleet.pools):
        raise AssertionError("serving replay: pool tiers differ")
    for cap, pool in a.fleet.pools.items():
        other = b.fleet.pools[cap]
        if not (torch.equal(pool.tables, other.tables)
                and torch.equal(pool.scalars, other.scalars)
                and np.array_equal(pool.doc_of_slot, other.doc_of_slot)
                and np.array_equal(pool.slot_gen, other.slot_gen)):
            raise AssertionError(f"serving replay: pool {cap} differs")
    if a.fleet.placement != b.fleet.placement:
        raise AssertionError("serving replay: placement differs")
    for name in ("_applied_a", "_buffseq_a", "_since_a"):
        if not np.array_equal(getattr(a, name), getattr(b, name)):
            raise AssertionError(f"serving replay: {name} differs")
    if a.payloads != b.payloads or a._keys != b._keys:
        raise AssertionError("serving replay: channels or payloads differ")
    for doc, addr in sample_keys:
        if a.text(doc, addr) != b.text(doc, addr):
            raise AssertionError(f"serving replay: text of {doc} differs")
        if not _same(a.channel_summary(doc, addr),
                     b.channel_summary(doc, addr)):
            raise AssertionError(f"serving replay: summary of {doc} "
                                 "differs")
    del plain, b
    torch.cuda.empty_cache()


def _serving_round(run: ServingRun, frames) -> tuple:
    """One round as the service runs it: every frame through its lambda,
    the continuous-feed tick, the quiescence flush, the nack drain.
    Returns the host wall of (lambdas, pump_feed, flush + drain)."""
    clock = time.perf_counter
    t0 = clock()
    for doc, frame in frames:
        run.handle(doc, {"t": "seqframe", "frame": frame})
    t1 = clock()
    run("pump_feed")
    t2 = clock()
    run("flush")
    run("take_errors")
    return t1 - t0, t2 - t1, clock() - t2


# Config 7's backend (bench_configs.py:893-896 and the pipeline's
# defaults): capacity 128, boxcars of up to max(2^17, docs x ops) rows,
# compaction every 8th flush, the pump with a ring of 2.
SERVING_KW = dict(capacity=128, max_batch=131_072, compact_every=8,
                  pump_mode=True, ring_depth=2)


def phase_serving(device, report, n_docs=12_288, rounds=16, k=8,
                  n_json=64, n_reads=4096, res_docs=512):
    """Phase 4: the device-apply serving stage at config 7's shape
    (``bench_configs.py:861-912,1276-1285``): a ``DeviceFleetBackend`` of
    :data:`SERVING_KW` fed through ``n_docs`` ``TpuDeliLambda``s ``rounds``
    rounds of ``k``-op frames (each doc grows to 128 rows and promotes to
    the 256-row tier; removes on every 4th doc from round 12), the last
    round redelivered, a JSON-wire round for ``n_json`` docs, one batched
    read of ``n_reads`` channels, texts and summaries of 64, and a
    telemetry scrape; then the residency sub-run
    (:func:`serving_residency`). Every round's frames (the client and
    deli side, not the stage) are built before the first; rounds 2 on are
    timed. The launch counts are set to 0 just before the main run and
    read just after its telemetry scrape. Both runs are replayed through
    a ``kernel="plain"`` backend on the card and must match bit for
    bit."""
    traffic = ServingTraffic(n_docs, k)
    run = ServingRun(DeviceFleetBackend(device=device, **SERVING_KW))
    be = run.be
    split = ("staging_s", "dispatch_s", "routing_s")
    t0 = time.perf_counter()
    all_frames = [traffic.frames() for _ in range(rounds)]
    gen_s = time.perf_counter() - t0
    per_round = []
    # Host wall of the timed rounds: lambdas = the TpuDeliLambda handler
    # calls (enqueue_frame), pump_feed = the feed tick (its stage and
    # dispatch), flush = the quiescence flush and the nack drain.
    host = dict(lambdas=0.0, pump_feed=0.0, flush=0.0)
    reset_counts()
    with TierTimer() as timer:
        for r, frames in enumerate(all_frames):
            if r == 1:
                torch.cuda.synchronize()
                t_start = time.perf_counter()
                busy0, tot0 = be.pump_busy_s, dict(be.flush_totals)
            t0 = time.perf_counter()
            parts = _serving_round(run, frames)
            per_round.append(time.perf_counter() - t0)
            if r >= 1:
                for key, v in zip(("lambdas", "pump_feed", "flush"), parts):
                    host[key] += v
        run("collect_now")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        busy = be.pump_busy_s - busy0
        totals = {key: be.flush_totals[key] - tot0[key] for key in split}
        timed = rounds - 1
        applied = be.ops_applied
        # The last round again: every row sits at or below its watermark.
        _serving_round(run, frames)
        if be.ops_applied != applied or be.needs_flush():
            raise AssertionError("serving: redelivered frames applied")
        json_docs = list(range(2, n_docs, 4))[:n_json]
        for doc, msg in traffic.json_round(json_docs):
            run.handle(doc, {"t": "seq", "msg": msg})
        run("pump_feed")
        run("flush")
        run("collect_now")
        kernel_tiers = timer.summary()
    stats = run("stats")
    if stats["docs_with_errors"] != 0 or run("take_errors"):
        raise AssertionError(f"serving: docs with errors: {stats}")
    want_ops = n_docs * k * rounds + len(json_docs) * 5
    if be.ops_applied != want_ops:
        raise AssertionError(f"serving: {be.ops_applied} ops applied, "
                             f"{want_ops} sent")
    caps = {p[0] for p in be.fleet.placement}
    if be.fleet.migrations < n_docs or caps != {256}:
        raise AssertionError(f"serving: not every doc promoted once "
                             f"({be.fleet.migrations} migrations, tiers "
                             f"{sorted(caps)})")
    keys = [(traffic.docs[i], "s") for i in range(n_reads)]
    g0, s0 = be.read_gathers, be.reads_served
    t0 = time.perf_counter()
    run("doc_states", keys)
    read_s = time.perf_counter() - t0
    per_gather = (be.reads_served - s0) / (be.read_gathers - g0)
    if per_gather < n_reads:
        raise AssertionError(f"serving: {per_gather} reads per gather")
    sample = list(range(0, n_docs, 193))[:64]
    for i in sample:
        doc = traffic.docs[i]
        if run("text", doc, "s") != traffic.expected(i):
            raise AssertionError(f"serving: text of {doc} is wrong")
        if run("channel_summary", doc, "s")["count"] < len(traffic.texts[i]):
            raise AssertionError(f"serving: summary of {doc} is short")
    tele = run("telemetry")
    launches = read_counts()
    reset_counts()
    residency = serving_residency(device, res_docs, k)
    residency["launches"] = read_counts()
    # The replay runs the plain versions at the same shapes: their
    # CUDA-event times per call are the plain column of the kernel table.
    with TierTimer() as plain_timer:
        replay_serving(run, lambda: DeviceFleetBackend(
            device=device, kernel="plain", **SERVING_KW),
            [(traffic.docs[i], "s") for i in sample])
        plain_tiers = plain_timer.summary()
    print(f"serving: plain replay exact; plain versions by tier (CUDA "
          f"events): {plain_tiers}", flush=True)
    del run, be
    torch.cuda.empty_cache()
    out = dict(
        n_docs=n_docs, k=k, rounds=rounds, rounds_timed=timed,
        ops_per_s=n_docs * k * timed / wall, ms_per_round=wall / timed * 1e3,
        timed_s=wall, first_round_ms=per_round[0] * 1e3,
        round_ms=[x * 1e3 for x in per_round[1:]],
        flush_ms_per_round={key: v / timed * 1e3 for key, v in totals.items()},
        host_ms_per_round={key: v / timed * 1e3 for key, v in host.items()},
        gen_ms_per_round=gen_s / rounds * 1e3,
        pump_busy_s=busy, device_idle_share=1 - busy / wall,
        migrations=stats["migrations"], demotions=stats["demotions"],
        docs_with_errors=stats["docs_with_errors"], pools=stats["pools"],
        rows_in_use=stats["rows_in_use"],
        feed_triggers={"size": stats["feed_size_triggers"],
                       "deadline": stats["feed_deadline_triggers"]},
        pump_dispatches=stats["pump_dispatches"],
        pump_backpressure=stats["pump_backpressure"],
        json_docs=len(json_docs), read_batch=n_reads,
        reads_per_device_dispatch=per_gather, read_batch_ms=read_s * 1e3,
        telemetry_rows_in_use=int(sum(a[:, 1].sum()
                                      for a in tele["shards"].values())),
        kernel_tiers=kernel_tiers, plain_tiers=plain_tiers,
        launches=launches, residency=residency, replay_exact=True,
    )
    report["serving"] = out
    print(f"serving: {out['ops_per_s']:.0f} merge ops/s through "
          f"DeviceFleetBackend ({n_docs} channels x {k} ops x {timed} timed "
          f"rounds in {wall:.3f} s, {out['ms_per_round']:.2f} ms/round; "
          f"first round {out['first_round_ms']:.1f} ms)", flush=True)
    print("serving host ms/round: "
          f"{ {key: round(v, 3) for key, v in out['host_ms_per_round'].items()} }"
          f"; frame generation (outside the window) "
          f"{out['gen_ms_per_round']:.3f} ms/round", flush=True)
    print("serving flush split ms/round: "
          f"{ {key: round(v, 3) for key, v in out['flush_ms_per_round'].items()} }"
          f", device idle share {out['device_idle_share']:.4f} (pump_busy "
          f"{busy:.4f} s of {wall:.4f} s)", flush=True)
    print(f"serving: migrations {stats['migrations']}, demotions "
          f"{stats['demotions']}, pools {stats['pools']}, docs_with_errors "
          f"{stats['docs_with_errors']}, feed_triggers "
          f"{out['feed_triggers']}, pump_dispatches "
          f"{stats['pump_dispatches']}, pump_backpressure "
          f"{stats['pump_backpressure']}; one read of {n_reads} channels: "
          f"{per_gather:.0f} reads/gather in {read_s * 1e3:.2f} ms",
          flush=True)
    print(f"serving kernel times by tier (CUDA events): {kernel_tiers}",
          flush=True)
    print(f"serving launches (main run): {launches}", flush=True)
    print(f"serving launches (residency run): {residency['launches']}",
          flush=True)
    for name in ("K1_merge_apply", "K2_zamboni_compact"):
        if launches[name]["all"] <= 0:
            raise AssertionError(f"{name} never launched on the serving "
                                 "path")
    return out


def serving_residency(device, n_docs=512, k=8, rounds=6, hibernate=128):
    """The residency sub-run: a backend whose ``max_resident`` is below
    its channel count hibernates ``hibernate`` idle documents after 4
    rounds; the next round's frame for each parks and wakes it. Every
    channel's state must equal a ``kernel="plain"`` twin that never
    hibernated (so only this run launches kernels), and the run is
    replayed through a ``kernel="plain"`` backend."""
    kw = dict(SERVING_KW, max_batch=4096)
    traffic = ServingTraffic(n_docs, k, remove_from=2, prefix="r")
    run = ServingRun(DeviceFleetBackend(
        device=device, max_resident=n_docs - hibernate, **kw))
    twin = ServingRun(DeviceFleetBackend(device=device, kernel="plain",
                                         **kw))
    cold = traffic.docs[:hibernate]
    for r in range(rounds):
        frames = traffic.frames()
        _serving_round(run, frames)
        _serving_round(twin, frames)
        if r == 3:
            run("collect_now")
            for doc in cold:
                if not run("hibernate_doc", doc):
                    raise AssertionError(f"residency: {doc} stayed")
            keys = [(d, "s") for d in cold[:8]]
            if not _same(run("doc_states", keys), twin("doc_states", keys)):
                raise AssertionError("residency: cold reads differ")
    run("pump_drain")
    twin("pump_drain")
    be = run.be
    wakes = be.residency.wakes["ok"]
    if be.hibernations != hibernate or wakes != hibernate or be._cold:
        raise AssertionError(f"residency: {be.hibernations} hibernations, "
                             f"{wakes} wakes, {len(be._cold)} still cold")
    keys = [(d, "s") for d in traffic.docs]
    if not _same(run("doc_states", keys), twin("doc_states", keys)):
        raise AssertionError("residency: states differ from the twin that "
                             "never hibernated")
    for i in range(0, n_docs, 37):
        if run("text", traffic.docs[i], "s") != traffic.expected(i):
            raise AssertionError(f"residency: text of {traffic.docs[i]}")
    out = dict(n_docs=n_docs, max_resident=n_docs - hibernate,
               hibernations=be.hibernations, wakes=wakes)
    del twin
    replay_serving(run, lambda: DeviceFleetBackend(
        device=device, kernel="plain", max_resident=n_docs - hibernate,
        **kw), keys[::37])
    print(f"serving residency: {n_docs} channels, max_resident "
          f"{n_docs - hibernate}: {be.hibernations} hibernated and woke on "
          "a parked frame; states equal the twin that never hibernated; "
          "plain replay exact", flush=True)
    return out


# -- phase 5: the ordering pipeline at config 7 -------------------------------


def bulk_connect(svc, doc_ids, prefix="c"):
    """One writer connection per document through the service's join path
    (a sequenced ClientJoin through deli), batched as config 7 connects
    (``_bulk_connect`` in bench_configs.py): every join record lands on
    rawdeltas first, one pump sequences them all, then each connection
    takes its ``client_id``, ``join_seq`` and ``conn_no`` from its own
    sequenced join."""
    conns = {}
    for i, d in enumerate(doc_ids):
        token = f"{prefix}-{i}"
        conn = PipelineConnection(svc, d, token)
        svc.rooms.setdefault(d, []).append(conn)
        svc.log.send(RAW_TOPIC, d, {"t": "join", "mode": "write",
                                    "token": token})
        conns[d] = conn
    svc.pump()
    for d, conn in conns.items():
        # The one pump above sequenced every join: no pump per connection
        # (over a store node each sweep is ~28 round trips).
        for msg in conn.take_inbox(pump=False):
            if (msg.type == MessageType.CLIENT_JOIN
                    and msg.contents.get("token") == conn.token):
                conn.client_id = msg.contents["clientId"]
                conn.join_seq = msg.sequence_number
                conn.conn_no = msg.contents.get("connNo", 0)
        if conn.client_id < 0:
            raise AssertionError(f"pipeline: {d} never joined")
    return conns


def pipeline_stages(svc):
    """The runners ``_config7_measure`` times, in its order."""
    return [("deli", svc._deli), ("scribe", svc._scribe),
            ("scriptorium", svc._scriptorium),
            ("broadcaster", svc._broadcaster), ("signals", svc._signals),
            ("device_decode", svc._device_runner),
            ("foreman", svc._foreman)]


def pipeline_round(svc, conns, send, stage_s) -> float:
    """One config-7 round: ``send()`` onto rawdeltas, every stage pumped
    in turn until the pipeline is quiescent (each stage's wall added to
    ``stage_s``), then ``flush_device``; the inboxes are dropped, as a
    room's sockets would drain them. Returns the wall of ``send``."""
    clock = time.perf_counter
    t0 = clock()
    send()
    submit = clock() - t0
    stages = [(n, r) for n, r in pipeline_stages(svc) if r is not None]
    while True:
        n = 0
        for name, runner in stages:
            ts = clock()
            n += runner.pump()
            stage_s[name] += clock() - ts
        if n == 0:
            break
    svc.flush_device()
    for c in conns.values():
        c.inbox.clear()
    return submit


def pipeline_frames(doc_ids, conns, k: int, n_rounds: int):
    """Every round's front-door items, built before the first round (the
    client side, not the service): per round and document one ``OpFrame``
    of ``k`` single-letter inserts at position 0 whose content ids scope
    to the connection, refSeq at the document's head (config 7's
    ``send_frames``)."""
    n = len(doc_ids)
    mint = 1 << 14
    clients = [conns[d].client_id for d in doc_ids]
    heads = np.array([conns[d].join_seq for d in doc_ids], np.int64)
    connno = np.array([conns[d].conn_no for d in doc_ids], np.int64)
    ar = np.arange(k, dtype=np.int64)
    out = []
    for r in range(n_rounds):
        o0 = r * k
        texts = tuple(ALPHABET[(o0 + 1 + i) % 26] for i in range(k))
        rows = np.zeros((n, k, OP_WIDTH), np.int32)
        rows[:, :, F_TYPE] = OP_INSERT
        rows[:, :, F_LEN] = 1
        rows[:, :, F_SEQ] = o0 + 1 + ar[None, :]
        rows[:, :, F_REF] = heads[:, None]
        rows[:, :, F_ARG] = connno[:, None] * mint + o0 + 1 + ar[None, :]
        out.append([(d, clients[i], OpFrame("s", rows[i], texts))
                    for i, d in enumerate(doc_ids)])
        heads += k
    return out


class _LogPrefix:
    """A read-only view of a ``PartitionedLog`` that ends, per partition,
    at ``upto``: a runner over it consumes exactly the records a run had
    consumed at some point, and no more."""

    def __init__(self, log):
        self.log = log
        self.n_partitions = log.n_partitions
        self.upto = {p: 0 for p in range(log.n_partitions)}

    def read(self, topic, partition, from_offset, limit=None):
        end = self.upto[partition]
        recs = self.log.read(topic, partition, from_offset)
        recs = recs[: max(0, end - from_offset)]
        return recs if limit is None else recs[:limit]


def replay_pipeline(svc, make_plain, offsets, text_keys=()) -> dict:
    """Feed the deltas records of ``svc``'s run, read back from its log
    partition by partition, through the port's own device-stage runner
    (``DocumentLambda`` of ``TpuDeliLambda``s) into a ``kernel="plain"``
    backend: up to ``offsets[0]`` (the joins), then up to each later
    snapshot followed by ``flush`` and ``collect_now``, as the run
    flushed after each round (so the boxcars, and with them the
    compaction cadence, are the run's). Every channel's lanes and scalars,
    looked up by channel key, its applied watermark and its payloads must
    match bit for bit. Returns the plain backend's text of each channel
    key in ``text_keys``."""
    plain = make_plain()
    view = _LogPrefix(svc.log)
    runner = PartitionRunner(
        view, DELTAS_TOPIC, "tpu-deli-replay",
        lambda p, s: DocumentLambda(
            lambda doc_id, _s: TpuDeliLambda(doc_id, plain),
            wants=frozenset({"seq", "seqframe"})),
        CheckpointStore(), checkpoint_every=1 << 30)
    for i, offs in enumerate(offsets):
        view.upto = dict(offs)
        runner.pump()
        if i:
            plain.flush()
            plain.collect_now()
    be = svc.device
    keys = be.channels()
    if sorted(keys) != sorted(plain.channels()):
        raise AssertionError("pipeline replay: channels differ")
    for lo in range(0, len(keys), 4096):
        chunk = keys[lo: lo + 4096]
        got, want = be.doc_states(chunk), plain.doc_states(chunk)
        for key in chunk:
            for f, x, y in zip(got[key]._fields, got[key], want[key]):
                if not np.array_equal(np.asarray(x), np.asarray(y)):
                    raise AssertionError(f"pipeline replay: {key} {f} "
                                         "differs from the plain versions")
    for key in keys:
        if (be._applied_a[be._index[key]]
                != plain._applied_a[plain._index[key]]
                or be.payloads[key] != plain.payloads[key]):
            raise AssertionError(f"pipeline replay: {key} watermark or "
                                 "payloads differ")
    texts = {key: plain.text(*key) for key in text_keys}
    del plain, runner
    torch.cuda.empty_cache()
    return texts


def phase_pipeline(device, report, n_docs=12_288, rounds=8, k=8,
                   json_docs=1024, n_sample=64):
    """Phase 5: config 7 through the port's ordering pipeline
    (``config7_pipeline_serving`` and ``_config7_measure``,
    bench_configs.py:861-1093): ``PipelineFluidService(n_partitions=8,
    device_max_batch=max(2^17, n_docs x k), checkpoint_every=500)`` on the
    card, ``n_docs`` writers connected through their sequenced joins, an
    untimed warm-up round and ``rounds`` timed rounds of one ``k``-op
    ``OpFrame`` per document through ``submit_frames_bulk(pump=False)``,
    every stage pumped to quiescence and ``flush_device`` (each stage's
    wall timed). ``rounds`` = 8 makes nine boxcars, so the compaction
    (every 8th) runs once. Every round's frames are built before the
    first. The launch counts are set to 0 just before the warm-up round
    and read just after the last timed round. Then: texts and summaries
    of ``n_sample`` documents, every document's durable log contiguous
    from its join, the run's deltas replayed through a ``kernel="plain"``
    backend (bit for bit), and the JSON wire at ``json_docs`` documents
    on a second service (``device_max_batch=4096``, ``rounds - 1`` timed
    rounds)."""
    svc = PipelineFluidService(
        n_partitions=8, device_max_batch=max(1 << 17, n_docs * k),
        checkpoint_every=500, device_torch=device)
    doc_ids = [f"d{i}" for i in range(n_docs)]
    t0 = time.perf_counter()
    conns = bulk_connect(svc, doc_ids)
    connect_s = time.perf_counter() - t0
    offsets = [dict(svc._device_runner._offsets)]
    t0 = time.perf_counter()
    all_items = pipeline_frames(doc_ids, conns, k, rounds + 1)
    gen_s = time.perf_counter() - t0
    be = svc.device
    stage_s = {name: 0.0 for name, _r in pipeline_stages(svc)}
    warm_s = dict(stage_s)
    split = ("staging_s", "dispatch_s", "routing_s")
    submit_s = 0.0
    reset_counts()
    with TierTimer() as timer:
        for r, items in enumerate(all_items):
            if r == 1:
                torch.cuda.synchronize()
                since = len(timer.events)
                warm_s = dict(stage_s)
                stage_s = {name: 0.0 for name in stage_s}
                busy0, tot0 = be.pump_busy_s, dict(be.flush_totals)
                t_start = time.perf_counter()
            s = pipeline_round(
                svc, conns,
                lambda: svc.submit_frames_bulk(items, pump=False), stage_s)
            offsets.append(dict(svc._device_runner._offsets))
            if r >= 1:
                submit_s += s
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        busy = be.pump_busy_s - busy0
        totals = {key: be.flush_totals[key] - tot0[key] for key in split}
        kernel_tiers = timer.summary(since)
    launches = read_counts()
    stats = be.stats()
    if stats["docs_with_errors"] != 0:
        raise AssertionError(f"pipeline: docs with errors: {stats}")
    want_ops = n_docs * k * (rounds + 1)
    if be.ops_applied != want_ops:
        raise AssertionError(f"pipeline: {be.ops_applied} ops applied, "
                             f"{want_ops} sent")
    for d in doc_ids:
        log, join = svc.ops_store[d], conns[d].join_seq
        want = join + 1
        for f in log.frames:
            if f.first_seq != want:
                raise AssertionError(f"pipeline: {d}'s log jumps to "
                                     f"{f.first_seq} at {want}")
            want = f.last_seq + 1
        if list(log.ops) != [join] or log.head != join + k * (rounds + 1):
            raise AssertionError(f"pipeline: {d}'s log is not its join and "
                                 f"{rounds + 1} frames")
    text = "".join(ALPHABET[o % 26] for o in range((rounds + 1) * k, 0, -1))
    sample = doc_ids[:: max(1, n_docs // n_sample)][:n_sample]
    t0 = time.perf_counter()
    for d in sample:
        if svc.device_text(d, "s") != text:
            raise AssertionError(f"pipeline: text of {d} is wrong")
    t_text = time.perf_counter() - t0
    t0 = time.perf_counter()
    for d in sample:
        if not svc.device_summary(d, "s")["count"]:
            raise AssertionError(f"pipeline: summary of {d} is empty")
    t_summary = time.perf_counter() - t0
    with TierTimer() as plain_timer:
        replay_pipeline(svc, lambda: DeviceFleetBackend(
            device=device, kernel="plain", capacity=128,
            max_batch=be.max_batch, compact_every=be.compact_every,
            pump_mode=be.pump_mode, ring_depth=2), offsets)
        plain_tiers = plain_timer.summary()
    print(f"pipeline: plain replay exact ({len(be.channels())} channels by "
          f"key); plain versions by tier (CUDA events): {plain_tiers}",
          flush=True)
    del svc, conns, all_items, be
    torch.cuda.empty_cache()
    json_out = pipeline_json_wire(device, min(json_docs, n_docs),
                                  max(1, rounds - 1), k)
    kernel_ms = sum(v["total_ms"] for v in kernel_tiers.values())
    out = dict(
        n_docs=n_docs, k=k, rounds_timed=rounds, n_partitions=8,
        ops_per_s=n_docs * k * rounds / wall,
        ms_per_round=wall / rounds * 1e3, timed_s=wall,
        connect_s=connect_s, gen_ms_per_round=gen_s / (rounds + 1) * 1e3,
        submit_s=submit_s, stage_s=stage_s, warmup_stage_s=warm_s,
        stage_share={name: v / wall for name, v in stage_s.items()},
        submit_share=submit_s / wall,
        flush_ms_per_round={key: v / rounds * 1e3
                            for key, v in totals.items()},
        pump_busy_s=busy, device_idle_share=1 - busy / wall,
        kernel_ms=kernel_ms, kernel_share=kernel_ms / 1e3 / wall,
        kernel_tiers=kernel_tiers, plain_tiers=plain_tiers,
        launches=launches, docs_with_errors=stats["docs_with_errors"],
        ops_applied=stats["ops_applied"], flushes=stats["flushes"],
        read_text_ms_per_doc=t_text / len(sample) * 1e3,
        read_summary_ms_per_doc=t_summary / len(sample) * 1e3,
        replay_exact=True, json_wire=json_out,
    )
    report["pipeline"] = out
    print(f"pipeline: {out['ops_per_s']:.0f} merge ops/s through "
          f"PipelineFluidService ({n_docs} channels x {k} ops x {rounds} "
          f"timed rounds in {wall:.3f} s, {out['ms_per_round']:.2f} "
          f"ms/round; connect {connect_s:.2f} s)", flush=True)
    print(f"pipeline submit_s {submit_s:.4f} ({out['submit_share']:.4f} of "
          f"the window); stage wall s: "
          f"{ {n: round(v, 4) for n, v in stage_s.items()} }; shares: "
          f"{ {n: round(v, 4) for n, v in out['stage_share'].items()} }; "
          f"frame generation (outside the window) "
          f"{out['gen_ms_per_round']:.3f} ms/round", flush=True)
    split_ms = {key: round(v, 3)
                for key, v in out["flush_ms_per_round"].items()}
    print(f"pipeline flush split ms/round: {split_ms}"
          f", device idle share {out['device_idle_share']:.4f} (pump_busy "
          f"{busy:.4f} s of {wall:.4f} s)", flush=True)
    print(f"pipeline K1 + K2 (CUDA events) {kernel_ms:.3f} ms of the timed "
          f"window, share {out['kernel_share']:.5f}; by tier: {kernel_tiers}",
          flush=True)
    print(f"pipeline launches (main run): {launches}", flush=True)
    print(f"pipeline reads: text {out['read_text_ms_per_doc']:.3f} ms/doc, "
          f"summary {out['read_summary_ms_per_doc']:.3f} ms/doc "
          f"({len(sample)} docs); docs_with_errors "
          f"{stats['docs_with_errors']}, ops_applied {stats['ops_applied']}",
          flush=True)
    print(f"pipeline_serving_json_wire_ops_per_sec "
          f"{json_out['ops_per_s']:.0f} ({json_out['n_docs']} docs x {k} ops "
          f"x {json_out['rounds_timed']} timed rounds, "
          f"{json_out['ms_per_round']:.2f} ms/round)", flush=True)
    for name in ("K1_merge_apply", "K2_zamboni_compact"):
        if launches[name]["all"] <= 0:
            raise AssertionError(f"{name} never launched on the pipeline "
                                 "path")
    return out


def pipeline_json_wire(device, n_docs=1024, rounds=7, k=8) -> dict:
    """The compat wire of config 7 (``wire="json"``): ``n_docs`` writers
    on a second service (``device_max_batch=4096``) send ``k`` per-op JSON
    inserts each per round straight onto rawdeltas, one record per op, an
    untimed warm-up round and ``rounds`` timed ones; the messages are
    built before the first round."""
    svc = PipelineFluidService(n_partitions=8, device_max_batch=4096,
                               device_torch=device)
    doc_ids = [f"j{i}" for i in range(n_docs)]
    conns = bulk_connect(svc, doc_ids, prefix="j")
    mint = 1 << 14
    heads = {d: conns[d].join_seq for d in doc_ids}
    texts = {d: [] for d in doc_ids}
    all_recs = []
    for r in range(rounds + 1):
        recs = []
        for d in doc_ids:
            c = conns[d]
            for i in range(k):
                o = r * k + i + 1
                letter = ALPHABET[o % 26]
                recs.append((d, {"t": "op", "client": c.client_id,
                                 "msg": DocumentMessage(
                                     client_sequence_number=o,
                                     reference_sequence_number=heads[d],
                                     type=MessageType.OPERATION,
                                     contents={"address": "s", "contents": {
                                         "k": "ins", "pos": 0,
                                         "text": letter,
                                         "orig": c.conn_no * mint + o}})}))
                texts[d].insert(0, letter)
            heads[d] += k
        all_recs.append(recs)
    stage_s = {name: 0.0 for name, _r in pipeline_stages(svc)}

    def sender(recs):
        def send():
            for d, rec in recs:
                svc.log.send(RAW_TOPIC, d, rec)
        return send

    for r, recs in enumerate(all_recs):
        if r == 1:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        pipeline_round(svc, conns, sender(recs), stage_s)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    stats = svc.device.stats()
    if stats["docs_with_errors"] or \
            svc.device.ops_applied != n_docs * k * (rounds + 1):
        raise AssertionError(f"pipeline json wire: {stats}")
    for d in doc_ids[:: max(1, n_docs // 16)]:
        if svc.device_text(d, "s") != "".join(texts[d]):
            raise AssertionError(f"pipeline json wire: text of {d}")
    del svc
    torch.cuda.empty_cache()
    return dict(n_docs=n_docs, rounds_timed=rounds,
                ops_per_s=n_docs * k * rounds / wall,
                ms_per_round=wall / rounds * 1e3, timed_s=wall)


# -- phase 6: config 7 through the socket front door ---------------------------

REPO_DIR = os.path.dirname(os.path.abspath(__file__))
CONFIG_PATH = os.path.join(REPO_DIR, "config", "config.json")


def raise_nofile() -> tuple:
    """Raise this process's open-file limit to its hard limit; returns
    (soft, hard) after. Phase 6 holds two sockets per socket writer, the
    read threads' sockets and the store node's connections."""
    import resource

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft != hard:
        resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    return resource.getrlimit(resource.RLIMIT_NOFILE)


def _pct(xs, q) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else 0.0


def _after_503(fn, counts, what, deadline):
    """``fn()``, retried while the server's overload envelope answers 503
    (a refused connection or a shed read), each time after its
    Retry-After, as a client of that envelope must; ``counts[what]``
    counts the retries. Past ``deadline`` the 503 is raised."""
    from urllib.error import HTTPError

    while True:
        try:
            return fn()
        except HTTPError as e:
            if e.code != 503 or time.perf_counter() > deadline:
                raise
            wait = float(e.headers.get("Retry-After") or 1)
        except ConnectionError as e:
            if " 503 " not in str(e) or time.perf_counter() > deadline:
                raise
            wait = 1.0
        counts[what] += 1
        time.sleep(wait)


def socket_client(argv) -> int:
    """The client process of phase 6 (``python3 chip_smoke.py
    --socket-client HOST PORT N_WRITERS K BURSTS READ_DOCS THREADS OUT``):
    the port's network driver only, on the CPU (it touches no tensor and
    no device). ``N_WRITERS`` writers (``push=True``), one per new
    document ``s<i>``, each send one ``K``-op frame of inserts at position
    0 per burst, refSeq at the highest sequence number the writer has
    seen, on the binary frame wire: a warm-up burst and ``BURSTS`` timed
    ones. A burst has converged when every writer has seen each of its
    own ops come back sequenced; a frame's ack latency runs from its
    first submit until its last op comes back. Then ``THREADS`` threads
    issue one concurrent REST channel read for each document of
    ``READ_DOCS`` (comma-separated). The client keeps the server's
    overload contract as the container runtime does: a frame nacked with
    a throttle (429 and a retry-after) is sent again, with the same
    client sequence numbers, once its retry-after has passed; a connect
    or read answered 503 is retried after its Retry-After. Any other nack
    fails the run. Writes its record, with those counts, to ``OUT``."""
    from concurrent.futures import ThreadPoolExecutor as Pool

    from fluidframework_tpu_torch.drivers.network_driver import (
        NetworkFluidService,
    )
    from fluidframework_tpu_torch.protocol.types import NackErrorType

    host, port, n, k, bursts = (argv[0], int(argv[1]), int(argv[2]),
                                int(argv[3]), int(argv[4]))
    read_docs = [d for d in argv[5].split(",") if d]
    threads, out_path = int(argv[6]), argv[7]
    nofile = raise_nofile()
    retries = {"connects_refused": 0, "reads_shed": 0}
    cli = NetworkFluidService(host, port, push=True)
    t0 = time.perf_counter()
    conns = [_after_503(lambda i=i: cli.connect(f"s{i}"), retries,
                        "connects_refused", t0 + 120) for i in range(n)]
    connect_s = time.perf_counter() - t0
    acked = [dict() for _ in conns]  # csn -> arrival time of own op

    def tap(c, seen):
        ingest = c._ingest

        def _ingest(m):
            if (m.client_id == c.client_id
                    and m.client_sequence_number not in seen):
                seen[m.client_sequence_number] = time.perf_counter()
            ingest(m)
        return _ingest

    for c, seen in zip(conns, acked):
        c._ingest = tap(c, seen)

    def frame(c, csn0):
        return OpFrame.build(
            "s", ["ins"] * k, [0] * k,
            [c.conn_no * (1 << 14) + csn0 + j for j in range(k)],
            [ALPHABET[(csn0 + j) % 26] for j in range(k)], csn0=csn0,
            ref=c._seq_watermark)

    nacks = []  # (burst, writer, message) of every throttle nack
    lat_ms, walls = [], []
    for b in range(bursts + 1):
        csn0 = b * k + 1
        last = csn0 + k - 1
        sent = []
        t_b = time.perf_counter()
        for c in conns:
            sent.append(time.perf_counter())
            c.submit_frame(frame(c, csn0))
        again = {}  # writer -> when its throttled frame is sent again
        deadline = time.perf_counter() + 120
        while not all(last in seen for seen in acked):
            now = time.perf_counter()
            for i, c in enumerate(conns):
                while c.nacks:
                    nk = c.nacks.pop(0)
                    if (nk.error_type != NackErrorType.THROTTLING
                            or nk.retry_after_s <= 0
                            or nk.client_sequence_number != csn0):
                        raise AssertionError(
                            f"socket burst {b}: writer {i} nacked: {nk}")
                    nacks.append((b, i, nk.message))
                    again[i] = now + nk.retry_after_s
                if i in again and now >= again[i]:
                    del again[i]
                    c.submit_frame(frame(c, csn0))
            if now > deadline:
                behind = [i for i, seen in enumerate(acked)
                          if last not in seen]
                raise AssertionError(
                    f"socket burst {b} did not converge: "
                    f"{len(behind)} of {n} writers short of csn {last}; "
                    + "; ".join(
                        f"writer {i}: csns seen {sorted(acked[i])[-3:]}, "
                        f"seq watermark {conns[i]._seq_watermark}, "
                        f"stashed {len(conns[i]._stash)}, frames received "
                        f"{conns[i].frames_received}, closed "
                        f"{conns[i].closed}, resend due {i in again}"
                        for i in behind[:4])
                    + f"; throttle nacks so far {len(nacks)} "
                    f"({nacks[-3:]}); {retries}")
            time.sleep(0.0005)
        t_e = max(seen[last] for seen in acked)
        if b:
            walls.append(t_e - t_b)
            lat_ms.extend((seen[last] - ts) * 1e3
                          for seen, ts in zip(acked, sent))
    converge_s = float(sum(walls))

    def read(d):
        t = time.perf_counter()
        text = _after_503(lambda: cli.get_channel_text(d, "s"), retries,
                          "reads_shed", t + 120)
        return d, text, (time.perf_counter() - t) * 1e3

    t0 = time.perf_counter()
    with Pool(threads) as pool:
        reads = list(pool.map(read, read_docs))
    reads_s = time.perf_counter() - t0
    for c in conns:
        c.disconnect()
    rec = dict(
        n_writers=n, k=k, bursts=bursts, nofile=list(nofile),
        connect_s=connect_s, converge_s=converge_s, burst_s=walls,
        socket_ingest_ops_per_sec=n * k * bursts / converge_s,
        ack_p50_ms=_pct(lat_ms, 50), ack_p99_ms=_pct(lat_ms, 99),
        throttle_nacks=len(nacks),
        throttle_nacks_timed=sum(1 for x in nacks if x[0]),
        nack_reasons=sorted({x[2] for x in nacks}), **retries,
        n_reads=len(reads), read_threads=threads, reads_s=reads_s,
        read_p50_ms=_pct([r[2] for r in reads], 50),
        read_p99_ms=_pct([r[2] for r in reads], 99),
        read_texts={d: t for d, t, _ms in reads},
    )
    with open(out_path, "w") as f:
        json.dump(rec, f)
    return 0


def _on_loop(srv, fn, timeout=600):
    """Run ``fn()`` on the started server's loop thread (the one thread
    that may drive its service) and return its result."""
    import asyncio

    async def call():
        return fn()

    return asyncio.run_coroutine_threadsafe(call(), srv._loop).result(timeout)


def _envelope(srv, before=None) -> dict:
    """The overload envelope of a front door: its tier, its tier
    transitions by kind (the process's counter family), writes denied,
    connections refused and reads shed; with ``before`` (an earlier
    reading), the counts since it."""
    svc = srv.service
    now = dict(transitions=svc.overload.transition_counts(),
               writes_denied=svc.admission.denied,
               connections_refused=srv.connections_refused,
               reads_shed=srv.reads_shed)
    if before is not None:
        for key, v in now.items():
            if isinstance(v, dict):
                now[key] = {t: n - before[key].get(t, 0) for t, n in v.items()
                            if n != before[key].get(t, 0)}
            else:
                now[key] = v - before[key]
    return dict(tier=svc.overload.tier.name, **now)


def _snapshot(svc) -> dict:
    """Every channel's state (host copies, by key), its applied watermark
    and payloads, after the pipeline is pumped and flushed."""
    svc.pump()
    svc.flush_device()
    be = svc.device
    be.collect_now()
    keys = be.channels()
    out = {}
    for lo in range(0, len(keys), 4096):
        out.update(be.doc_states(keys[lo: lo + 4096]))
    return {key: (tuple(np.asarray(x).copy() for x in out[key]),
                  int(be._applied_a[be._index[key]]),
                  dict(be.payloads[key])) for key in keys}


def _same_states(a: dict, b: dict, what: str) -> None:
    if sorted(a) != sorted(b):
        raise AssertionError(f"{what}: channels differ ({len(a)} vs "
                             f"{len(b)})")
    for key, (lanes, applied, payloads) in a.items():
        lanes2, applied2, payloads2 = b[key]
        for i, (x, y) in enumerate(zip(lanes, lanes2)):
            if not np.array_equal(x, y):
                raise AssertionError(f"{what}: {key} field {i} differs")
        if applied != applied2 or payloads != payloads2:
            raise AssertionError(f"{what}: {key} watermark or payloads "
                                 "differ")


def _start_store_node(d: str, env: dict):
    proc = subprocess.Popen(
        [sys.executable, "-m", "fluidframework_tpu_torch.service.store_server",
         "--host", "127.0.0.1", "--port", "0", "--dir", d,
         "--partitions", "4"],
        stdout=subprocess.PIPE, text=True, cwd=REPO_DIR, env=env)
    line = proc.stdout.readline()
    if not line.startswith("store node on "):
        proc.kill()
        raise AssertionError(f"store node did not start: {line!r}")
    return proc, int(line.rsplit(":", 1)[1])


def _stop(proc, timeout=30) -> int:
    """SIGTERM ``proc`` and wait for it (killed past ``timeout``)."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=timeout)
        raise


def _timed_runners(svc, stage_s: dict) -> None:
    """Time each stage runner's pump (the stages ``_config7_measure``
    times) wherever the server calls it: each runner's ``pump`` is wrapped
    on the instance, adding its wall to ``stage_s``."""
    for name, runner in pipeline_stages(svc):
        if runner is None:
            continue

        def timed(pump=runner.pump, name=name):
            t = time.perf_counter()
            try:
                return pump()
            finally:
                stage_s[name] += time.perf_counter() - t

        runner.pump = timed


def entry_point_check(device) -> dict:
    """``python3 -m fluidframework_tpu_torch.service.server_main --config
    config/config.json --port 0 --host 127.0.0.1`` as users run it: it
    must print its ``listening`` line, sequence one writer's frame, answer
    ``/metrics`` and exit 0 on SIGTERM."""
    from urllib.request import urlopen

    from fluidframework_tpu_torch.drivers.network_driver import (
        NetworkFluidService,
    )

    cmd = [sys.executable, "-m", "fluidframework_tpu_torch.service.server_main",
           "--config", CONFIG_PATH, "--port", "0", "--host", "127.0.0.1"]
    if device.type != "cuda":
        cmd += ["--device", device.type]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True,
                            cwd=REPO_DIR,
                            env=dict(os.environ, PYTHONPATH=REPO_DIR))
    try:
        info = json.loads(proc.stdout.readline())
        if info.get("event") != "listening" or info.get("port", 0) <= 0:
            raise AssertionError(f"server_main: no listening line: {info}")
        listen_s = time.perf_counter() - t0
        c = NetworkFluidService("127.0.0.1", info["port"]).connect("ep")
        frame = OpFrame.build("s", ["ins"] * 4, [0] * 4,
                              [c.conn_no * (1 << 14) + 1 + j
                               for j in range(4)], list("abcd"), csn0=1,
                              ref=c.join_seq)
        c.submit_frame(frame)
        if not c.wait_for(lambda cc: any(
                m.client_id == cc.client_id and m.client_sequence_number == 4
                for m in cc.inbox), 120):
            raise AssertionError("server_main: the frame was not acked")
        c.disconnect()
        with urlopen(f"http://127.0.0.1:{info['port']}/metrics",
                     timeout=120) as r:
            if r.status != 200 or b"# TYPE" not in r.read():
                raise AssertionError("server_main: /metrics failed")
    finally:
        rc = _stop(proc)
    if rc != 0:
        raise AssertionError(f"server_main exited {rc} on SIGTERM")
    return dict(listening_s=listen_s, exit_code=rc)


def phase_server(device, report, n_docs=12_288, socket_docs=96, k=8,
                 bursts=4, n_reads=1024, read_threads=16):
    """Phase 6: config 7 through the socket front door, deployed as
    ``docker-compose.yml`` deploys it. A store node subprocess (``python3
    -m fluidframework_tpu_torch.service.store_server --dir``: the native
    disk log and blob store, 4 partitions); the front door in this
    process from ``config/config.json`` (``server_main.load_config`` +
    ``build_server(cfg, device_torch=...)``: 4 partitions,
    checkpoint_every 10, device_capacity 128, device_flush_min_rows 64)
    over that store node. Before ``start()``, ``n_docs`` channels are
    loaded through the server's own service (``bulk_connect``, one
    ``k``-op ``OpFrame`` each through ``submit_frames_bulk``, a flush).
    Then a client subprocess (:func:`socket_client`, the port's network
    driver on the CPU) runs ``socket_docs`` writers over websockets (a
    warm-up and ``bursts`` timed bursts) and ``n_reads`` concurrent REST
    channel reads of loaded channels from ``read_threads`` threads. The
    launch counts are set to 0 just before the client starts and read
    just after it ends. Then every channel is read (on the server's loop),
    the deltas log is replayed from the store node through a
    ``kernel="plain"`` backend on the same device (every channel bit for
    bit), the front door is stopped and replaced by a new one over the
    same store node (it replays the log from offset 0; every channel bit
    for bit again), and ``server_main`` runs as a subprocess."""
    import shutil
    import tempfile
    from urllib.request import urlopen

    from fluidframework_tpu_torch.service import server_main

    if not (native_store_available() and native_plog_available()):
        raise AssertionError("server: the native store or log did not build")
    nofile = raise_nofile()
    print(f"server: RLIMIT_NOFILE {nofile}", flush=True)
    need_fds = 2 * socket_docs + read_threads + 64
    if nofile[0] < need_fds:
        raise AssertionError(f"server: RLIMIT_NOFILE {nofile[0]} below the "
                             f"{need_fds} descriptors the phase needs")
    env = dict(os.environ, PYTHONPATH=REPO_DIR)
    tmp = tempfile.mkdtemp(prefix="fluid-store-")
    store, store_port = _start_store_node(os.path.join(tmp, "node"), env)
    srv = srv2 = None
    try:
        cfg = server_main.load_config(CONFIG_PATH, overrides={
            "host": "127.0.0.1", "port": 0, "store_host": "127.0.0.1",
            "store_port": store_port})
        srv = server_main.build_server(cfg, device_torch=device)
        svc = srv.service
        be = svc.device
        doc_ids = [f"d{i}" for i in range(n_docs)]
        t0 = time.perf_counter()
        conns = bulk_connect(svc, doc_ids)
        offsets = [dict(svc._device_runner._offsets)]
        svc.submit_frames_bulk(pipeline_frames(doc_ids, conns, k, 1)[0])
        svc.flush_device()
        for c in conns.values():
            c.inbox.clear()
        load_s = time.perf_counter() - t0
        print(f"server: loaded {n_docs} channels through the store node in "
              f"{load_s:.2f} s", flush=True)
        stage_s = {name: 0.0 for name, _r in pipeline_stages(svc)}
        _timed_runners(svc, stage_s)
        srv.start()
        step = max(1, n_docs // n_reads)
        read_docs = doc_ids[::step][:n_reads]
        writers = [f"s{i}" for i in range(socket_docs)]
        out_path = os.path.join(tmp, "client.json")
        reads0 = srv.read_batches
        envelope0 = _envelope(srv)
        reset_counts()
        busy0 = be.pump_busy_s
        with TierTimer() as timer:
            t_c = time.perf_counter()
            client = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--socket-client",
                 "127.0.0.1", str(srv.port), str(socket_docs), str(k),
                 str(bursts), ",".join(read_docs), str(read_threads),
                 out_path],
                capture_output=True, text=True, timeout=600, cwd=REPO_DIR,
                env=dict(env, CUDA_VISIBLE_DEVICES=""))
            client_s = time.perf_counter() - t_c
            launches = read_counts()
            busy = be.pump_busy_s - busy0
            kernel_tiers = timer.summary()
        envelope = _envelope(srv, envelope0)
        if client.returncode != 0:
            raise AssertionError(
                "server: socket client failed: " + client.stderr[-3000:]
                + f"\nserver side: frames_received {srv.frames_received}, "
                f"pump_ticks {srv.pump_ticks}, stalls_seen "
                f"{srv.stalls_seen}, overload envelope {envelope}")
        with open(out_path) as f:
            rec = json.load(f)
        read_batches = srv.read_batches - reads0
        stalls, frames, ticks = (srv.stalls_seen, srv.frames_received,
                                 srv.pump_ticks)
        kernel_ms = sum(v["total_ms"] for v in kernel_tiers.values())
        states = _on_loop(srv, lambda: _snapshot(svc))
        offsets.append(dict(svc._device_runner._offsets))
        srv.stop()
        if srv._thread.is_alive():
            raise AssertionError("server: the front door did not stop")
        if len(states) != n_docs + socket_docs:
            raise AssertionError(f"server: {len(states)} channels served")
        stats = be.stats()
        if stats["docs_with_errors"]:
            raise AssertionError(f"server: docs with errors: {stats}")

        # Plain replay of the store node's deltas log, channel by channel.
        t0 = time.perf_counter()
        with TierTimer() as plain_timer:
            plain_texts = replay_pipeline(svc, lambda: DeviceFleetBackend(
                device=device, kernel="plain",
                capacity=cfg["device_capacity"], max_batch=be.max_batch,
                compact_every=be.compact_every, pump_mode=be.pump_mode,
                ring_depth=2), offsets,
                text_keys=[(d, "s") for d in read_docs + writers])
            plain_tiers = plain_timer.summary()
        replay_s = time.perf_counter() - t0
        bad = [d for d, t in rec["read_texts"].items()
               if t != plain_texts[(d, "s")]]
        # Each writer inserted its ops at position 0, in csn order.
        want = "".join(ALPHABET[o % 26] for o in range((bursts + 1) * k, 0,
                                                       -1))
        bad += [d for d in writers if plain_texts[(d, "s")] != want]
        if bad:
            raise AssertionError(f"server: texts differ from the plain "
                                 f"replay or the writers' ops: {bad[:4]}")
        print(f"server: plain replay of the store node's deltas log exact "
              f"({len(states)} channels by key, {replay_s:.2f} s); "
              f"{len(rec['read_texts'])} REST texts equal the replay's; "
              f"plain versions by tier (CUDA events): {plain_tiers}",
              flush=True)
        svc = be = conns = srv = None
        torch.cuda.empty_cache()

        # The replacement front door over the same store node.
        t0 = time.perf_counter()
        srv2 = server_main.build_server(cfg, device_torch=device)
        srv2.start()
        # Its first read replays the whole log from the store node on the
        # loop before it is served: wait past the network driver's 10 s.
        shed2 = {"reads_shed": 0}

        def first_read():
            with urlopen(f"http://127.0.0.1:{srv2.port}/documents/"
                         f"{doc_ids[0]}/channels/s", timeout=900) as r:
                return json.loads(r.read())["text"]

        first = _after_503(first_read, shed2, "reads_shed", t0 + 900)
        first_read_s = time.perf_counter() - t0
        states2 = _on_loop(srv2, lambda: _snapshot(srv2.service))
        srv2.stop()
        _same_states(states, states2, "server replacement")
        if first != plain_texts[(doc_ids[0], "s")]:
            raise AssertionError("server: the replacement's first read")
        print(f"server: replacement front door replayed the store node and "
              f"served its first read in {first_read_s:.2f} s "
              f"({shed2['reads_shed']} shed and retried); all "
              f"{len(states2)} channels equal bit for bit", flush=True)
        srv2 = states2 = None
        torch.cuda.empty_cache()
    finally:
        for s in (srv, srv2):
            if s is not None and s._loop is not None and \
                    not s._loop.is_closed():
                s.stop()
        store_rc = _stop(store)
        shutil.rmtree(tmp, ignore_errors=True)
    if store_rc not in (0, -signal.SIGTERM):  # it has no SIGTERM handler
        raise AssertionError(f"server: the store node exited {store_rc}")
    entry = entry_point_check(device)
    print(f"server: server_main printed its listening line after "
          f"{entry['listening_s']:.2f} s, acked a frame, served /metrics and "
          f"exited {entry['exit_code']} on SIGTERM", flush=True)
    client = {key: v for key, v in rec.items() if key != "read_texts"}
    out = dict(
        n_docs=n_docs, socket_docs=socket_docs, k=k, bursts=bursts,
        load_s=load_s, client_s=client_s, nofile=list(nofile),
        client=client, frames_received=frames, pump_ticks=ticks,
        read_batches=read_batches,
        reads_per_batch=client["n_reads"] / max(1, read_batches),
        stalls_seen=stalls, envelope=envelope, stage_s=stage_s,
        pump_busy_s=busy, device_idle_share=1 - busy / client_s,
        kernel_ms=kernel_ms, kernel_tiers=kernel_tiers, launches=launches,
        plain_tiers=plain_tiers, replay_s=replay_s, replay_exact=True,
        replacement_first_read_s=first_read_s, replacement_exact=True,
        channels=len(states), store_exit_code=store_rc, entry_point=entry,
    )
    report["server"] = out
    print(f"socket_ingest_ops_per_sec {client['socket_ingest_ops_per_sec']:.0f}"
          f" ({socket_docs} writers x {k} ops x {bursts} timed bursts over "
          f"websockets; connect_s {client['connect_s']:.3f}, converge_s "
          f"{client['converge_s']:.4f}, bursts s "
          f"{[round(b, 4) for b in client['burst_s']]}; ack latency p50 "
          f"{client['ack_p50_ms']:.2f} ms p99 {client['ack_p99_ms']:.2f} ms;"
          f" client RLIMIT_NOFILE {client['nofile']})", flush=True)
    print(f"server overload envelope (client run): {envelope}; the client "
          f"resent {client['throttle_nacks']} throttled frames "
          f"({client['throttle_nacks_timed']} in the timed bursts; "
          f"{client['nack_reasons']}), retried "
          f"{client['connects_refused']} refused connects and "
          f"{client['reads_shed']} shed reads", flush=True)
    print(f"server: frames_received {frames}, pump_ticks {ticks}, "
          f"stalls_seen {stalls}, device idle share "
          f"{out['device_idle_share']:.4f} (pump_busy {busy:.4f} s of the "
          f"client's {client_s:.3f} s), K1 + K2 (CUDA events) "
          f"{kernel_ms:.3f} ms; by tier: {kernel_tiers}", flush=True)
    print(f"server stage wall s (client run): "
          f"{ {n: round(v, 4) for n, v in stage_s.items()} }", flush=True)
    print(f"server reads: {client['n_reads']} REST channel reads from "
          f"{read_threads} threads in {read_batches} batches "
          f"({out['reads_per_batch']:.1f} reads/batch), p50 "
          f"{client['read_p50_ms']:.2f} ms p99 {client['read_p99_ms']:.2f} "
          f"ms, {client['reads_s']:.3f} s in all", flush=True)
    print(f"server launches (client run): {launches}", flush=True)
    for name in ("K1_merge_apply", "K2_zamboni_compact"):
        if device.type == "cuda" and launches[name]["all"] <= 0:
            raise AssertionError(f"{name} never launched on the server path")
    return out


# -- phase 7: the SharedTree rebase path -------------------------------------


TREE_LC, TREE_PC, TREE_W = 128, 32, 16  # config 3b's dense shape


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _no_sync(dev, fn, *args, **kw):
    """``fn(*args)`` with any host synchronisation on the card an error
    (``torch.cuda.set_sync_debug_mode("error")``), reset after."""
    if dev.type != "cuda":
        return fn(*args, **kw)
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _host_lanes(ts) -> list:
    return [t.to("cpu", copy=True).numpy() for t in ts]


def _same_lanes(a, b, what: str) -> None:
    for i, (x, y) in enumerate(zip(a, b)):
        if x.dtype != y.dtype or x.shape != y.shape or not np.array_equal(
                x, y):
            raise AssertionError(f"{what}: lane {i} differs between the "
                                 "card and the CPU")


def _profile(dev, fn) -> dict:
    """Launches and device time of one call of ``fn`` under
    ``torch.profiler``: device activities (kernels, copies, sets) and
    their summed µs on the card, and the top-level ATen ops the host
    dispatched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        fn()
        _sync(dev)
    events = prof.events()
    kern = [e for e in events if e.device_type == DeviceType.CUDA]
    return dict(
        launches=len(kern),
        device_us=float(sum(e.time_range.elapsed_us() for e in kern)),
        aten_ops=sum(1 for e in events if e.device_type == DeviceType.CPU
                     and e.name.startswith("aten::")
                     and e.cpu_parent is None),
    )


def _per_step(dev, scan, c_lo=2, steps=4) -> dict:
    """Launches, device µs and ATen ops of one scan step: the difference
    between a profiled scan over ``c_lo + steps`` commits and one over
    ``c_lo``, over ``steps`` (the set-up cancels; every step runs the same
    branchless ops)."""
    a = _profile(dev, lambda: scan(c_lo))
    b = _profile(dev, lambda: scan(c_lo + steps))
    return {k: (b[k] - a[k]) / steps for k in a}


def _event_ms(dev, fn, reps=10) -> float:
    """Median CUDA-event ms of ``fn`` (host wall on the CPU)."""
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts
               if torch.is_tensor(t))


def tree_functions(dev, batch, docs, L) -> list:
    """The dense algebra's batched entry points at config 3b's shape (N =
    1,024 docs, Lc 128, Pc 32), on real commits of its streams: ms a call
    (CUDA events), launches a call (profiler), and the byte floor — each
    input read once, each output written once — at 3.35 TB/s."""
    lanes = (batch.del_mask, batch.ins_cnt, batch.ins_ids, batch.mov_id,
             batch.mov_off, batch.pool_mid, batch.pool_off)
    c = TK.DenseChange(*[x[:, 1] for x in lanes])
    over = TK.DenseChange(*[x[:, 2] for x in lanes])
    calls = {
        "batched_apply": (lambda: TK.batched_apply(docs, L, c, device=dev),
                          (docs, L, *c)),
        "batched_rebase": (lambda: TK.batched_rebase(c, over, L, False,
                                                     device=dev),
                           (*c, *over, L)),
        "batched_invert": (lambda: TK.batched_invert(docs, L, c, device=dev),
                           (docs, L, *c)),
        "batched_compose": (lambda: TK.batched_compose(c, over, L,
                                                       device=dev),
                            (*c, *over, L)),
    }
    rows = []
    for name, (fn, ins) in calls.items():
        out = fn()
        if name == "batched_compose":  # (change, overflow)
            out = (*out[0], out[1])
        prof = _profile(dev, fn)
        b = _nbytes(*ins) + _nbytes(*out)
        rows.append(dict(name=name, ms=_event_ms(dev, fn), **prof,
                         bytes=b, bound_ms=b / HBM_BYTES_PER_S * 1e3))
        print(f"tree fn {name}: {rows[-1]['ms']:.4f} ms, "
              f"{prof['launches']} launches ({prof['aten_ops']} ATen ops), "
              f"device {prof['device_us']:.1f} us, bound "
              f"{rows[-1]['bound_ms']:.5f} ms", flush=True)
    return rows


def tree_3b(dev, n_docs=1024, n_commits=1000, scripts=64, cpu_docs=16,
            cpu_commits=None):
    """7a: ``config3b_tree_rebase_device`` through the port — 64 distinct
    concurrent 3-session streams (``gen_streams``, seed 0) tiled over the
    document batch, staged on the card once, one warm-up and 3 timed
    ``batched_trunk_scan`` runs (W 16) under sync-debug "error"; the err
    lane must be clear and every distinct script equal ``host_trunk``."""
    Lc, Pc, W = TREE_LC, TREE_PC, TREE_W
    scripts = min(scripts, n_docs)
    t0 = time.perf_counter()
    streams = TS.gen_streams(np.random.default_rng(0), scripts, n_commits,
                             n_sessions=3, W=W, Lc=Lc)
    base = TS.to_device_batch(streams, Lc, Pc)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_states = [TS.host_trunk(s) for s in streams]
    cpu_rate = scripts * n_commits / (time.perf_counter() - t0)
    reps = n_docs // scripts
    n_docs = scripts * reps
    batch = DT.CommitBatch(*[
        torch.from_numpy(np.ascontiguousarray(x)).to(dev).repeat(
            (reps,) + (1,) * (x.ndim - 1)) for x in base])
    staged_gb = _nbytes(*batch) / 1e9
    docs = torch.zeros((n_docs, Lc), dtype=torch.int32, device=dev)
    L0 = torch.zeros(n_docs, dtype=torch.int32, device=dev)

    def scan(cb=batch, d=docs, l0=L0, device=dev):
        return DT.batched_trunk_scan(d, l0, cb, W, device=device)

    t0 = time.perf_counter()
    out = _no_sync(dev, scan)
    _sync(dev)
    warm_s = time.perf_counter() - t0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = _no_sync(dev, scan)
        _sync(dev)
        times.append(time.perf_counter() - t0)
    rate = n_docs * n_commits * len(times) / sum(times)
    out_ids, out_L, err = _host_lanes(out)
    if err.any():
        raise AssertionError("7a: ring-window overflow in config 3b")
    for d in range(scripts):
        if TK.dense_to_doc(out_ids[d], out_L[d]) != host_states[d]:
            raise AssertionError(f"7a: device/host divergence on doc {d}")
    step = _per_step(dev, lambda c: scan(DT.CommitBatch(
        *[x[:, :c] for x in batch])))
    # The same function on the CPU for cpu_docs documents (over the first
    # cpu_commits commits, all by default), bit for bit.
    cpu_commits = cpu_commits or n_commits
    sub = DT.CommitBatch(*[x[:cpu_docs, :cpu_commits] for x in batch])
    got = _host_lanes(scan(sub, docs[:cpu_docs], L0[:cpu_docs]))
    want = _host_lanes(scan(DT.CommitBatch(*[x.cpu() for x in sub]),
                            docs[:cpu_docs].cpu(), L0[:cpu_docs].cpu(),
                            torch.device("cpu")))
    _same_lanes(got, want, "7a")
    fns = tree_functions(dev, batch, torch.from_numpy(out_ids).to(dev),
                         torch.from_numpy(out_L).to(dev))
    scan_ms = float(np.median(times)) * 1e3
    bound = (_nbytes(*batch) + 2 * _nbytes(docs, L0)) / HBM_BYTES_PER_S * 1e3
    res = dict(
        n_docs=n_docs, commits_per_doc=n_commits, scripts=scripts, window=W,
        Lc=Lc, Pc=Pc, staged_gb=staged_gb, gen_s=gen_s, warm_s=warm_s,
        scan_s=times, edits_per_sec=rate, ms_per_scan=scan_ms,
        us_per_step=scan_ms * 1e3 / n_commits, step=step,
        cpu_trunk_edits_per_sec=cpu_rate, scan_bound_ms=bound,
        cpu_check=f"{cpu_docs} docs x {cpu_commits} commits",
        functions=fns)
    print(f"7a config 3b: {rate:,.0f} edits/s, {scan_ms:.1f} ms a scan "
          f"({res['us_per_step']:.1f} us a step; {step['launches']:.1f} "
          f"launches, device {step['device_us']:.1f} us, "
          f"{step['aten_ops']:.1f} ATen ops a step), warm-up "
          f"{warm_s:.1f} s, streams {gen_s:.1f} s, staged "
          f"{staged_gb:.2f} GB, host trunk {cpu_rate:,.0f} edits/s",
          flush=True)
    return res


def em_stream(seed: int, n: int, move_prob: float = 0.0):
    """``config3c_em_kernel_concurrent``'s stream (``bench_configs.py``):
    3 sessions authoring on views lagged up to 6 commits, each commit a
    delete-biased pass over the view plus a 2-cell insert, or with
    probability ``move_prob`` a first-class move of 1-3 cells."""
    r = np.random.default_rng(seed)
    sessions = [TEM.EditManager(session=100 + s) for s in range(3)]
    processed = [0, 0, 0]
    log = []
    nid = [1]
    for k in range(1, n + 1):
        s = int(r.integers(0, 3))
        em = sessions[s]
        target = max(
            processed[s],
            max((c.seq for c in log if c.session == em.session), default=0),
            len(log) - 6,
        )
        for c in log[processed[s]:target]:
            em.add_sequenced(c)
        processed[s] = target
        view = em.local_view()
        if move_prob and len(view) >= 4 and r.random() < move_prob:
            i0 = int(r.integers(0, len(view) - 1))
            cnt = int(r.integers(1, min(3, len(view) - i0) + 1))
            dest = int(r.integers(0, len(view) - cnt + 1))
            cells = view[i0:i0 + cnt]
            if dest <= i0:
                change = [TM.skip(dest), TM.move_in(0, cnt),
                          TM.skip(i0 - dest), TM.move_out(0, cells)]
            else:
                change = [TM.skip(i0), TM.move_out(0, cells),
                          TM.skip(dest - i0), TM.move_in(0, cnt)]
            change = TM.normalize(change)
            em.add_local(change)
            log.append(TEM.Commit(session=em.session, seq=k, ref=target,
                                  change=change))
            continue
        change = []
        i = 0
        while i < len(view):
            roll = r.random()
            run = min(int(r.integers(1, 3)), len(view) - i)
            if roll < 0.45 and len(view) > 24:
                change.append(TM.delete(view[i:i + run]))
            else:
                change.append(TM.skip(run))
            i += run
        cells = [((100 + s) * 1000000 + nid[0] + j, nid[0] + j)
                 for j in range(2)]
        nid[0] += 2
        change.append(TM.insert(cells))
        change = TM.normalize(change)
        em.add_local(change)
        log.append(TEM.Commit(session=em.session, seq=k, ref=target,
                              change=change))
    return log


def tree_3c(dev, n_docs=1024, n_commits=512, scripts=16, wave=128,
            move_prob=0.0, cpu_docs=16, single_base=False):
    """7b: ``config3c_em_kernel_concurrent`` through the port — the
    production ``batch_ingest`` over ``EditManager(device=cuda)``s, one
    ``batched_em_trunk_scan_ring`` dispatch a wave for the whole document
    batch; parity of every distinct script against the per-commit host
    EditManager; then the first timed dispatch's scan again under
    sync-debug "error", and on the CPU for ``cpu_docs`` documents."""
    t0 = time.perf_counter()
    streams = [em_stream(1000 + i, n_commits, move_prob)
               for i in range(scripts)]
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_ems = []
    for log in streams:
        em = TEM.EditManager(session=1, device=dev)
        for c in log:
            em.add_sequenced(c)
            em.host_commits += 1
        host_ems.append(em)
    cpu_rate = scripts * n_commits / (time.perf_counter() - t0)
    reps = max(1, n_docs // scripts)
    n_docs = scripts * reps
    logs = [streams[d % scripts] for d in range(n_docs)]

    real = TEM._em_dispatch
    dispatch_s = []
    recorded = []

    def timed_dispatch(rings, mov_seq0, arrays, U, device):
        t = time.perf_counter()
        out = real(rings, mov_seq0, arrays, U, device)
        dispatch_s.append(time.perf_counter() - t)
        if not recorded:
            recorded.append((rings, mov_seq0, arrays, U))
        return out

    TEM._em_dispatch = timed_dispatch
    try:
        warm = [TEM.EditManager(session=1, device=dev) for _ in range(n_docs)]
        t0 = time.perf_counter()
        TEM.batch_ingest([(em, list(log[:wave]), log[wave - 1].seq)
                          for em, log in zip(warm, logs)])
        warm_s = time.perf_counter() - t0
        del warm
        dispatch_s.clear()
        recorded.clear()
        ems = [TEM.EditManager(session=1, device=dev) for _ in range(n_docs)]
        wave_s = []
        device_commits = total = 0
        for w0 in range(0, n_commits, wave):
            items = []
            for em, log in zip(ems, logs):
                chunk = log[w0:w0 + wave]
                items.append((em, chunk, max(0, chunk[-1].seq - 8)))
            t0 = time.perf_counter()
            stats = TEM.batch_ingest(items)
            wave_s.append(time.perf_counter() - t0)
            device_commits += stats["device_commits"]
            total += stats["device_commits"] + stats["host_commits"]
    finally:
        TEM._em_dispatch = real
    rate = total / sum(wave_s)
    for d in range(scripts):
        if ems[d].trunk_state != host_ems[d].trunk_state:
            raise AssertionError(f"7b: device/host divergence on script {d}")
    if device_commits <= 0:
        raise AssertionError("7b: no commit rode the device")
    reasons = {}
    for em in ems:
        for k, v in em.host_fallback_reason.items():
            reasons[k] = reasons.get(k, 0) + v

    # The first timed dispatch's scan, staged on the card, under
    # sync-debug "error"; then on the CPU for cpu_docs documents.
    (ring_ids, ring_L, ring_seq), mov0, arrays, U = recorded[0]
    lanes = (arrays["dm"], arrays["ic"], arrays["ii"], arrays["rs"],
             arrays["rl"], arrays["ro"], arrays["refs"], arrays["seqs"],
             arrays["mv"])

    def on(x, d=dev):
        return torch.from_numpy(np.ascontiguousarray(x)).to(d)

    def scan(n, device=dev):
        cb = DEM.EmCommitBatch(*[on(x[:n], device) for x in lanes])
        rings = [on(x[:n], device) for x in (ring_ids, ring_L, ring_seq)]
        return DEM.batched_em_trunk_scan_ring(*rings, on(mov0[:n], device),
                                              cb, U, device=device)

    N = ring_ids.shape[0]
    staged = DEM.EmCommitBatch(*[on(x) for x in lanes])
    rings = [on(x) for x in (ring_ids, ring_L, ring_seq)]
    mov_t = on(mov0)
    _sync(dev)
    t0 = time.perf_counter()
    out = _no_sync(dev, DEM.batched_em_trunk_scan_ring, *rings, mov_t,
                   staged, U, device=dev)
    _sync(dev)
    scan_only_s = time.perf_counter() - t0
    step = _per_step(dev, lambda c: DEM.batched_em_trunk_scan_ring(
        *rings, mov_t, DEM.EmCommitBatch(*[x[:, :c] for x in staged]), U,
        device=dev))
    got = _host_lanes(scan(cpu_docs))
    want = _host_lanes(scan(cpu_docs, device=torch.device("cpu")))
    _same_lanes(got, want, "7b")
    first = _host_lanes(out)
    C = lanes[0].shape[1]
    W = ring_ids.shape[1]
    single_ms = None
    if single_base:
        # The one-shot catch-up form on the same commits, from the
        # newest seeded state alone.
        t0 = time.perf_counter()
        DEM.batched_em_trunk_scan(rings[0][:, -1], rings[1][:, -1],
                                  rings[2][:, -1], staged, W, U, device=dev)
        _sync(dev)
        single_ms = (time.perf_counter() - t0) * 1e3
    b = (sum(x.nbytes for x in lanes) + ring_ids.nbytes + ring_L.nbytes
         + ring_seq.nbytes + first[0].nbytes + first[1].nbytes
         + first[2].nbytes)
    disp_ms = float(np.median(dispatch_s)) * 1e3
    res = dict(
        n_docs=n_docs, commits_per_doc=n_commits, scripts=scripts,
        wave=wave, move_prob=move_prob, waves=len(wave_s), gen_s=gen_s,
        warm_s=warm_s, wave_s=wave_s, edits_per_sec=rate,
        device_fraction=device_commits / max(total, 1),
        device_commits=device_commits, total_commits=total,
        host_fallback_reason=reasons, dispatches=len(dispatch_s),
        ms_per_dispatch=disp_ms, dispatch_s=dispatch_s,
        host_share=1 - sum(dispatch_s) / sum(wave_s),
        scan_shape=dict(N=N, C=C, W=W, Lc=ring_ids.shape[2],
                        Pc=lanes[2].shape[2], R=lanes[3].shape[2], U=U),
        scan_only_ms=scan_only_s * 1e3, single_base_scan_ms=single_ms,
        us_per_step=scan_only_s * 1e6 / C, step=step,
        scan_bound_ms=b / HBM_BYTES_PER_S * 1e3,
        cpu_em_edits_per_sec=cpu_rate,
        cpu_check=f"{cpu_docs} docs x {C} commits")
    print(f"7b config {'3c-moves' if move_prob else '3c'}: {rate:,.0f} "
          f"edits/s, device_fraction {res['device_fraction']:.3f}, "
          f"{len(dispatch_s)} dispatches of {disp_ms:.1f} ms (the first's "
          f"scan under sync-debug {res['scan_only_ms']:.1f} ms, "
          f"single-base form {single_ms} ms, {res['us_per_step']:.1f} us a "
          f"step; {step['launches']:.1f} launches, device "
          f"{step['device_us']:.1f} us, {step['aten_ops']:.1f} ATen ops a "
          f"step), host share of the waves {res['host_share']:.3f}, "
          f"fallbacks {reasons}, scan shape {res['scan_shape']}, warm-up "
          f"{warm_s:.1f} s, streams {gen_s:.1f} s, host EM "
          f"{cpu_rate:,.0f} edits/s", flush=True)
    return res


def tree_3(dev, n_edits=1000, budget_s=60.0, min_docs=16, max_docs=1000):
    """7c: ``config3_tree_rebase`` through the port's ``ContainerRuntime``
    + ``SharedTree(device=cuda)`` over ``LocalFluidService``: 3 sessions
    per document, a flush every 4 edits, ``process_incoming`` every 8,
    ``n_edits`` edits a document; documents one after another until
    ``budget_s`` has passed (at least ``min_docs``). All replicas must
    converge."""
    from fluidframework_tpu_torch.runtime.container import ContainerRuntime
    from fluidframework_tpu_torch.service.local_server import (
        LocalFluidService,
    )
    from fluidframework_tpu_torch.tree.shared_tree import SharedTree

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    total = 0
    stats = {}
    d = 0
    while d < max_docs and (d < min_docs
                            or time.perf_counter() - t0 < budget_s):
        svc = LocalFluidService()
        rts = [ContainerRuntime(svc, "t",
                                channels=(SharedTree("tree", device=dev),))
               for _ in range(3)]
        trees = [rt.get_channel("tree") for rt in rts]
        for i in range(n_edits):
            k = int(rng.integers(0, 3))
            t = trees[k]
            if len(t) > 2 and rng.random() < 0.3:
                t.delete_nodes(int(rng.integers(0, len(t) - 1)), 1)
            else:
                t.insert_nodes(int(rng.integers(0, len(t) + 1)), [i])
            total += 1
            if i % 4 == 0:
                rts[k].flush()
            if i % 8 == 0:
                for rt in rts:
                    rt.process_incoming()
        for rt in rts:
            rt.flush()
        busy = True
        while busy:
            busy = any(rt.process_incoming() for rt in rts)
        if not trees[0].get() == trees[1].get() == trees[2].get():
            raise AssertionError(f"7c: replicas diverged on doc {d}")
        for t in trees:
            for k, v in t.ingest_stats.items():
                if isinstance(v, dict):
                    agg = stats.setdefault(k, {})
                    for r, n in v.items():
                        agg[r] = agg.get(r, 0) + n
                else:
                    stats[k] = stats.get(k, 0) + v
        d += 1
    dt = time.perf_counter() - t0
    res = dict(n_docs=d, edits_per_doc=n_edits, wall_s=dt,
               edits_per_sec=total / dt, ingest_stats=stats)
    print(f"7c config 3: {res['edits_per_sec']:,.0f} edits/s over {d} docs "
          f"x {n_edits} edits ({dt:.1f} s), ingest {stats}", flush=True)
    return res


def phase_tree(device, report, b_docs=1024, b_commits=125, c_docs=1024,
               c_commits=128, m_docs=512, m_commits=128, wave=128,
               c3_budget_s=15.0, c3_min_docs=16):
    """Phase 7: the SharedTree rebase path on the card — 7a config 3b,
    7b configs 3c and 3c-moves, 7c config 3. Depth is cut to keep the
    phase near 130 s on one H100 (and the smoke, with phase 10, well
    inside its limit): 7a runs 125 of the bench's 1,000 commits a
    document (a step costs the same at every depth), 7b's configs 3c and
    3c-moves 128 of their 512 (one wave; a wave's host work grows with
    its index, so later waves are slower), 7c documents for 15 s (at
    least 16). Every width, the document batches and the move mix are
    the bench's."""
    out = {}
    t = time.perf_counter()
    out["3b"] = tree_3b(device, n_docs=b_docs, n_commits=b_commits)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out["3c"] = tree_3c(device, n_docs=c_docs, n_commits=c_commits,
                        scripts=16, wave=wave)
    out["3c-moves"] = tree_3c(device, n_docs=m_docs, n_commits=m_commits,
                              scripts=8, wave=wave, move_prob=0.05,
                              single_base=True)
    out["3"] = tree_3(device, budget_s=c3_budget_s, min_docs=c3_min_docs)
    out["wall_s"] = time.perf_counter() - t
    report["tree"] = out
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


# ---------------------------------------------------------------------------
# Phase 8: the client merge path (SharedString, SharedMatrix, SparseMatrix,
# undo-redo, the replay driver and the smoke client) on the card.

# Rows of the one-document tables phase 8 holds K1/K2 at: the shared tier,
# the cluster tier (one document over 4-16 CTAs) and the global tier.
CLIENT_D1_CAPS = (256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536)


class _Uncounted:
    """Launches inside this block (holding a kernel against its plain
    version) leave every launch count as it was."""

    def __enter__(self):
        self._saved = [(spec["wrapper"], dict(vars(spec["wrapper"])))
                       for spec in KERNELS.values()]

    def __exit__(self, *exc):
        for w, attrs in self._saved:
            for key, v in attrs.items():
                if key.startswith("launches"):
                    setattr(w, key, v)


class _ByWidth:
    """Counts the client API's K1/K2 launches by table width (rows) and
    the DDS modules' compactions and grows, by wrapping the names the
    modules call; the wrapped functions run unchanged."""

    def __init__(self):
        from collections import Counter

        self.k1, self.k2 = Counter(), Counter()
        self.compacts = self.grows = 0

    def __enter__(self):
        from fluidframework_tpu_torch.models import shared_string as SS
        from fluidframework_tpu_torch.ops import merge_kernel as MK

        self._saved = [(MK, "apply_ops_packed", MK.apply_ops_packed),
                       (MK, "compact_packed", MK.compact_packed),
                       (SS, "compact", SS.compact), (SS, "grow", SS.grow)]
        k1, k2, compact, grow = (f for _m, _n, f in self._saved)

        def apply_w(t, s, ops, **kw):
            self.k1[t.shape[2]] += 1
            return k1(t, s, ops, **kw)

        def compact_w(t, s, **kw):
            self.k2[t.shape[2]] += 1
            return k2(t, s, **kw)

        def compact_dds(state):
            self.compacts += 1
            return compact(state)

        def grow_dds(state, cap):
            self.grows += 1
            return grow(state, cap)

        MK.apply_ops_packed, MK.compact_packed = apply_w, compact_w
        SS.compact, SS.grow = compact_dds, grow_dds
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def _count_syncs(fn, *args):
    """Run ``fn`` with every warning recorded; return (result, how many
    were CUDA synchronizations, which ``set_sync_debug_mode("warn")``
    reports)."""
    import warnings

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        out = fn(*args)
    return out, sum("synchroniz" in str(w.message) for w in seen)


def config1_author(device, n_ops: int, sync_window=(1000, 2000)):
    """``config1_single_doc_replay``'s author (bench_configs.py): a
    ``ContainerRuntime`` + ``SharedString`` over ``LocalFluidService``,
    seed 0, 45% removes of 1-2 chars, 2-char inserts, flush and
    ``process_incoming`` every 16 ops. Returns (service, runtime, wall s,
    syncs in the ops of ``sync_window``)."""
    from fluidframework_tpu_torch.models.shared_string import SharedString
    from fluidframework_tpu_torch.runtime.container import ContainerRuntime
    from fluidframework_tpu_torch.service.local_server import (
        LocalFluidService,
    )

    rng = np.random.default_rng(0)
    svc = LocalFluidService()
    author = ContainerRuntime(
        svc, "doc", channels=(SharedString("text", device=device),))
    s = author.get_channel("text")

    def edit(lo, hi):
        for i in range(lo, hi):
            length = len(s.get_text())
            if length > 8 and rng.random() < 0.45:
                a = int(rng.integers(0, length - 2))
                s.remove_range(a, a + int(rng.integers(1, 3)))
            else:
                s.insert_text(int(rng.integers(0, length + 1)), "ab")
            if i % 16 == 0:
                author.flush()
                author.process_incoming()

    w0, w1 = (min(w, n_ops) for w in sync_window)
    t0 = time.perf_counter()
    edit(0, w0)
    syncs = _count_syncs(edit, w0, w1)[1]
    edit(w1, n_ops)
    author.flush()
    author.process_incoming()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return svc, author, time.perf_counter() - t0, syncs


def replay_reader(deltas, device, window=None):
    """A reader ``ContainerRuntime`` replaying the deltas log through
    ``ReplayDocumentService`` (``config1_single_doc_replay``'s reader; the
    runtime catches up while it is built). With ``window`` (lo, hi) the
    replay controller stops the catch-up at seq lo, releases lo..hi to one
    ``process_incoming``, then the rest. Returns (channel, wall s with the
    card synchronized, syncs counted in each of those steps, messages in
    the window)."""
    from fluidframework_tpu_torch.drivers.replay_driver import (
        ReplayDocumentService,
    )
    from fluidframework_tpu_torch.models.shared_string import SharedString
    from fluidframework_tpu_torch.runtime.container import ContainerRuntime

    replay = ReplayDocumentService(deltas, doc_id="doc",
                                   replay_to=window[0] if window else None)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    reader, built = _count_syncs(lambda: ContainerRuntime(
        replay, "doc", channels=(SharedString("text", device=device),)))
    syncs, in_window = [built], 0
    if window:
        replay.replay_to(window[1])
        in_window, n = _count_syncs(reader.process_incoming)
        syncs.append(n)
        replay.replay_all()
        syncs.append(_count_syncs(reader.process_incoming)[1])
    if device.type == "cuda":
        torch.cuda.synchronize()
    return (reader.get_channel("text"), time.perf_counter() - t0, syncs,
            in_window)


def _lanes_equal(a, b, what: str) -> None:
    """Two states (or their ``segment_state_to_numpy`` lanes) equal in
    every lane and scalar."""
    from fluidframework_tpu_torch.interop import segment_state_to_numpy

    a, b = (segment_state_to_numpy(x) if isinstance(x[0], torch.Tensor)
            else x for x in (a, b))
    for name, x, y in zip(SEGMENT_LANES + ("count", "min_seq", "cur_seq",
                                           "self_client", "err"), a, b):
        if x.shape != y.shape or not np.array_equal(x, y):
            raise AssertionError(f"{what}: {name} differs")


def _cpu_replay(deltas):
    """The CPU reader of 8a, run in a process of its own (one torch
    thread) beside the card's work: (text, lanes, wall s)."""
    from fluidframework_tpu_torch.interop import segment_state_to_numpy

    torch.set_num_threads(1)
    reader, dt = replay_reader(deltas, torch.device("cpu"))[:2]
    return reader.get_text(), segment_state_to_numpy(reader._state), dt


def client_8a(device, out, n_ops=10_000):
    """Config 1: the author on the card, a card reader (timed as the bench
    times it, syncs counted over sequence numbers 2,001-3,000), a card
    reader with every op timed (CUDA events, host wall with a synchronize)
    and its launches counted by width, and a CPU reader (in a spawned
    process beside the card readers); the card readers equal the author's text
    and the CPU reader's lanes bit for bit."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from fluidframework_tpu_torch.models.shared_string import SharedString
    from fluidframework_tpu_torch.ops.segment_state import capacity_of

    svc, author, author_s, author_syncs = config1_author(device, n_ops)
    text = author.get_channel("text").get_text()
    deltas = svc.get_deltas("doc")
    pool = ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    try:
        cpu = pool.submit(_cpu_replay, deltas)
        reader, dt, syncs, window_msgs = replay_reader(
            deltas, device, window=(2000, 3000))
        timed_reader, host_ms, dev_ms, widths = _timed_replay(deltas,
                                                              device)
        cpu_text, cpu_lanes, cpu_s = cpu.result()
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    if reader.get_text() != text or cpu_text != text:
        raise AssertionError("8a: a reader's text != the author's")
    _lanes_equal(reader._state, cpu_lanes, "8a card reader vs CPU")
    _lanes_equal(timed_reader._state, cpu_lanes, "8a timed reader vs CPU")
    out.update(
        n_ops=len(deltas), single_doc_replay_ops_per_sec=len(deltas) / dt,
        replay_s=dt, author_s=author_s, author_ops_per_sec=n_ops / author_s,
        cpu_replay_ops_per_sec=len(deltas) / cpu_s,
        apply_ms_p50=_pct(host_ms, 50), apply_ms_p99=_pct(host_ms, 99),
        apply_event_ms_p50=_pct(dev_ms, 50),
        apply_event_ms_p99=_pct(dev_ms, 99),
        syncs_reader_window=syncs[1], window_msgs=window_msgs,
        syncs_reader_all=sum(syncs),
        syncs_author_1000_ops=author_syncs,
        compactions=widths.compacts, grows=widths.grows,
        peak_capacity=capacity_of(reader._state),
        author_capacity=capacity_of(author.get_channel("text")._state),
        k1_by_width=dict(widths.k1), k2_by_width=dict(widths.k2),
        text_len=len(text),
    )
    print(f"8a config 1: {len(deltas)} msgs, card replay "
          f"{out['single_doc_replay_ops_per_sec']:.0f} ops/s ({dt:.3f} s), "
          f"CPU replay {out['cpu_replay_ops_per_sec']:.0f} ops/s, author "
          f"{out['author_ops_per_sec']:.0f} ops/s; apply p50/p99 host "
          f"{out['apply_ms_p50']:.4f}/{out['apply_ms_p99']:.4f} ms, events "
          f"{out['apply_event_ms_p50']:.4f}/{out['apply_event_ms_p99']:.4f} "
          f"ms; syncs: reader {syncs[1]} in {window_msgs} msgs (seqs "
          f"2,001-3,000; {sum(syncs)} in all), author "
          f"{author_syncs} in 1,000 ops; compactions {widths.compacts}, "
          f"grows {widths.grows}, peak capacity {out['peak_capacity']}; "
          f"K1 by width {dict(widths.k1)}, K2 by width {dict(widths.k2)}; "
          "card == CPU bit for bit", flush=True)
    return reader._state


def _timed_replay(deltas, device):
    """A card reader with every op timed on its own (CUDA events around
    the op, host wall up to a synchronize after it) and its K1/K2 launches,
    compactions and grows counted: (channel, host ms, event ms,
    :class:`_ByWidth`)."""
    from fluidframework_tpu_torch.models.shared_string import SharedString

    host_ms, ev = [], []
    orig = SharedString._apply

    def timed(self, row):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        a.record()
        orig(self, row)
        b.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t) * 1e3)
        ev.append((a, b))

    SharedString._apply = timed
    try:
        with _ByWidth() as widths:
            reader = replay_reader(deltas, device)[0]
    finally:
        SharedString._apply = orig
    return reader, host_ms, [a.elapsed_time(b) for a, b in ev], widths


def client_8b(device, out, n_docs=2048, k=16, steps=50):
    """Config 2b (``config2b_apply_latency``): 2,048 docs x 256 rows x
    K 16, a warm-up of each kernel, then 50 steps with K3 every 4th, each
    step ending in the err lane's readback; replayed through the plain
    versions from the same start, bit for bit."""
    from fluidframework_tpu_torch.ops.segment_state import make_batched_state
    from fluidframework_tpu_torch.testing.merge_streams import (
        build_op_stream,
    )

    ops = torch.from_numpy(build_op_stream(
        n_docs, k, np.random.default_rng(0))).to(device)
    t, s = K1.pack_state(make_batched_state(n_docs, 256, NO_CLIENT,
                                            device=device))
    t0, s0 = t.clone(), s.clone()
    K1.apply_ops_packed(t, s, ops)
    K2.apply_compact_packed(t, s, ops)
    s[:, K1.SC_ERR].cpu()
    mid = (t.clone(), s.clone())
    times = []
    for i in range(steps):
        a = time.perf_counter()
        if i % 4 == 3:
            K2.apply_compact_packed(t, s, ops)
        else:
            K1.apply_ops_packed(t, s, ops)
        s[:, K1.SC_ERR].cpu()
        times.append((time.perf_counter() - a) * 1e3)
    errs = int(s[:, K1.SC_ERR].sum())
    pt, ps = K1.apply_plain(t0, s0, ops)
    pt, ps = K2.apply_compact_plain(pt, ps, ops)
    for i in range(steps):
        fn = K2.apply_compact_plain if i % 4 == 3 else K1.apply_plain
        pt, ps = fn(pt, ps, ops)
    if errs or not (torch.equal(pt, t) and torch.equal(ps, s)):
        raise AssertionError(f"8b: errs {errs} or kernels != plain replay")
    arr = np.asarray(times)
    out.update(
        apply_step_latency_ms=float(np.median(arr)),
        p99_ms=_pct(times, 99),
        apply_step_median_ms=float(np.median(np.delete(arr, np.s_[3::4]))),
        fused_zamboni_step_median_ms=float(np.median(arr[3::4])),
        ops_per_sec=n_docs * k * steps / (arr.sum() / 1e3), errs=errs,
        n_docs=n_docs, k=k,
    )
    print(f"8b config 2b: {n_docs} docs x 256 x K {k}: step median "
          f"{out['apply_step_latency_ms']:.4f} ms, p99 {out['p99_ms']:.4f}, "
          f"plain-step median {out['apply_step_median_ms']:.4f}, fused-step "
          f"median {out['fused_zamboni_step_median_ms']:.4f}, "
          f"{out['ops_per_sec']:.0f} ops/s, errs 0, plain replay exact",
          flush=True)
    return mid, ops


def client_8c(device, out, n_matrices=10_000, k=64, iters=3, sample=64):
    """Config 4 (``config4_matrix_axis_merge``): 10,000 matrices, 20,000
    kernel docs x 256 rows x K 64, through ``merge_kernel``'s batched API on
    a packed state: a warm-up apply, then 3 timed iterations of
    ``jit_batched_apply_ops`` + ``batched_compact``, each ending in the err
    readback; a sample of docs (the 16 scripts and random tiled copies)
    replayed through the plain versions, bit for bit."""
    from fluidframework_tpu_torch.ops import merge_kernel as MK
    from fluidframework_tpu_torch.ops.segment_state import (
        make_batched_state,
        packed_of,
        packed_views,
    )
    from fluidframework_tpu_torch.testing.merge_streams import (
        matrix_axis_stream,
    )

    docs = 2 * n_matrices
    ops = torch.from_numpy(matrix_axis_stream(
        docs, k, np.random.default_rng(0))).to(device)
    state = packed_views(*K1.pack_state(make_batched_state(
        docs, 256, NO_CLIENT, device=device)))
    state = MK.jit_batched_apply_ops(state, ops)
    errs = int(state.err.sum())
    mid = tuple(x.clone() for x in packed_of(state))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        state = MK.jit_batched_apply_ops(state, ops)
        state = MK.batched_compact(state)
        errs = int(state.err.sum())
    dt = time.perf_counter() - t0
    rng = np.random.default_rng(1)
    idx = torch.from_numpy(np.concatenate([
        np.arange(16), rng.choice(np.arange(16, docs), sample - 16, False)
    ])).to(device)
    pt, ps = K1.pack_state(make_batched_state(sample, 256, NO_CLIENT,
                                              device=device))
    pops = ops[idx]
    pt, ps = K1.apply_plain(pt, ps, pops)
    for _ in range(iters):
        pt, ps = K1.apply_plain(pt, ps, pops)
        pt, ps = K2.compact_plain(pt, ps)
    t, s = packed_of(state)
    if errs or not (torch.equal(pt, t[:, idx]) and torch.equal(ps, s[idx])):
        raise AssertionError(f"8c: errs {errs} or sample != plain replay")
    out.update(matrix_axis_ops_per_sec=docs * k * iters / dt, errs=errs,
               n_matrices=n_matrices, kernel_docs=docs, k=k, seconds=dt,
               sample_docs=sample)
    print(f"8c config 4: {n_matrices} matrices ({docs} kernel docs) x 256 "
          f"x K {k}: {out['matrix_axis_ops_per_sec']:.0f} matrix axis "
          f"ops/s, errs 0, {sample} sampled docs == plain replay",
          flush=True)
    return mid, ops


def client_family(device, seed=0, steps=300, offline=(70, 100)):
    """Three ``ContainerRuntime``s, each with a ``SharedString`` (two
    interval collections), a ``SharedMatrix``, a ``SparseMatrix`` and a
    ``SharedMap`` on ``device``, over ``LocalFluidService``: a seeded
    concurrent script, an ``UndoRedoStackManager`` on runtime 0 (string
    and map handlers) undoing and redoing, and runtime 1 offline from step
    ``offline[0]`` to ``offline[1]`` with pending string, interval,
    sparse-row and map ops. Returns each replica's observable state, its
    kernel lanes and its summaries (after a drain)."""
    from fluidframework_tpu_torch.framework import undo_redo as UR
    from fluidframework_tpu_torch.interop import segment_state_to_numpy
    from fluidframework_tpu_torch.models.shared_map import SharedMap
    from fluidframework_tpu_torch.models.shared_matrix import SharedMatrix
    from fluidframework_tpu_torch.models.shared_string import SharedString
    from fluidframework_tpu_torch.models.sparse_matrix import SparseMatrix
    from fluidframework_tpu_torch.runtime.container import ContainerRuntime
    from fluidframework_tpu_torch.service.local_server import (
        LocalFluidService,
    )

    svc = LocalFluidService()
    rts = [ContainerRuntime(svc, "doc", channels=(
        SharedString("text", capacity=64, device=device),
        SharedMatrix("m", capacity=32, device=device),
        SparseMatrix("s", capacity=32, device=device),
        SharedMap("map"))) for _ in range(3)]
    stack = UR.UndoRedoStackManager()
    UR.SharedStringUndoRedoHandler(stack).attach(rts[0].get_channel("text"))
    UR.SharedMapUndoRedoHandler(stack).attach(rts[0].get_channel("map"))
    rng = np.random.default_rng(seed)
    labels = ("comments", "marks")
    for step in range(steps):
        if step == offline[0]:
            rts[1].flush()
            rts[1].disconnect()
        if step == offline[1]:
            rts[1].reconnect()
        i = int(rng.integers(0, 3))
        rt = rts[i]
        s, m, sp, mp = (rt.get_channel(c) for c in ("text", "m", "s", "map"))
        n = len(s.get_text())
        r = rng.random()
        offline_now = not rt.connected
        if i == 0 and r < 0.08:
            stack.undo_operation()
        elif i == 0 and r < 0.12:
            stack.redo_operation()
        elif r < 0.35 or n < 6:
            s.insert_text(int(rng.integers(0, n + 1)), "".join(
                chr(97 + int(x)) for x in rng.integers(0, 26, 3)))
        elif r < 0.45:
            a = int(rng.integers(0, n - 2))
            s.remove_range(a, a + int(rng.integers(1, 3)))
        elif r < 0.5:
            a = int(rng.integers(0, n - 3))
            s.annotate(a, a + 3, int(rng.integers(1, 6)))
        elif r < 0.58:
            col = s.get_interval_collection(labels[step % 2])
            a = int(rng.integers(0, n - 3))
            col.add(a, a + 2, props={"k": step})
        elif r < 0.66 and not offline_now:
            if m.row_count < 24 and rng.random() < 0.5:
                m.insert_rows(int(rng.integers(0, m.row_count + 1)), 2)
            elif m.col_count < 12 and rng.random() < 0.5:
                m.insert_cols(int(rng.integers(0, m.col_count + 1)), 1)
            elif m.row_count > 2:
                m.remove_rows(int(rng.integers(0, m.row_count - 1)), 1)
        elif r < 0.72 and not offline_now and m.row_count and m.col_count:
            m.set_cell(int(rng.integers(0, m.row_count)),
                       int(rng.integers(0, m.col_count)), step)
        elif r < 0.8:
            if sp.row_count < 20 or rng.random() < 0.5:
                sp.insert_rows(int(rng.integers(0, sp.row_count + 1)), 1)
            elif sp.row_count > 1:
                sp.remove_rows(int(rng.integers(0, sp.row_count - 1)), 1)
        elif r < 0.85 and not offline_now and sp.row_count:
            sp.set_cell(int(rng.integers(0, sp.row_count)),
                        int(rng.integers(0, 1 << 14)), step)
        else:
            mp.set(f"k{int(rng.integers(0, 6))}", step)
        if i == 0 and rng.random() < 0.5:
            stack.close_current_operation()
        if rng.random() < 0.4 and rt.connected:
            rt.flush()
        k = int(rng.integers(0, 3))
        if rng.random() < 0.4 and rts[k].connected:
            rts[k].process_incoming(int(rng.integers(1, 6)))
    for rt in rts:
        rt.flush()
    while any(rt.process_incoming() for rt in rts):
        pass
    snap = []
    for rt in rts:
        s, m, sp, mp = (rt.get_channel(c) for c in ("text", "m", "s", "map"))
        snap.append(dict(
            text=s.get_text(), annotations=s.annotations(),
            intervals=[s.get_interval_collection(lb).all() for lb in labels],
            matrix=m.to_list(),
            sparse=[sp.row_values(r) for r in range(sp.row_count)],
            map=sorted(mp.items()),
            summaries=[json.dumps(rt.get_channel(c).summarize_core())
                       for c in ("text", "m", "s", "map")],
            lanes=[segment_state_to_numpy(st) for st in (
                s._state, m._rows.state, m._cols.state, sp._rows.state)],
        ))
    return snap


def client_8d(device, out):
    """The DDS family on the card: every replica converges (text,
    annotations, grid, sparse cells, map), and every replica's state
    equals the same script on the CPU bit for bit (lanes, intervals,
    summaries)."""
    t = time.perf_counter()
    card = client_family(device)
    card_s = time.perf_counter() - t
    cpu = client_family(torch.device("cpu"))
    # Interval positions are held card to CPU only: the reference's own
    # replicas need not agree on them (ROADMAP, section 3).
    for key in ("text", "annotations", "matrix", "sparse", "map"):
        if any(r[key] != card[0][key] for r in card):
            raise AssertionError(f"8d: replicas did not converge on {key}")
    for i, (a, b) in enumerate(zip(card, cpu)):
        for key in a:
            if key == "lanes":
                for la, lb in zip(a[key], b[key]):
                    if not all(np.array_equal(x, y) for x, y in zip(la, lb)):
                        raise AssertionError(f"8d: rt {i} lanes card != CPU")
            elif a[key] != b[key]:
                raise AssertionError(f"8d: rt {i} {key} card != CPU")
    out.update(wall_s=card_s, text_len=len(card[0]["text"]),
               matrix_shape=[len(card[0]["matrix"]),
                             len(card[0]["matrix"][0]) if card[0]["matrix"]
                             else 0])
    print(f"8d DDS family: 3 runtimes converged on the card in {card_s:.2f}"
          f" s (text {out['text_len']} chars, grid {out['matrix_shape']}), "
          "every replica == the CPU run bit for bit", flush=True)


def client_8e(device, out):
    """``python3 -m fluidframework_tpu_torch.service.server_main`` as a
    subprocess, then the port's deployment smoke
    (``service/smoke_client.run``) against it: 0 or the phase fails."""
    from fluidframework_tpu_torch.service import smoke_client

    cmd = [sys.executable, "-m", "fluidframework_tpu_torch.service.server_main",
           "--config", CONFIG_PATH, "--port", "0", "--host", "127.0.0.1"]
    if device.type != "cuda":
        cmd += ["--device", device.type]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True,
                            cwd=REPO_DIR,
                            env=dict(os.environ, PYTHONPATH=REPO_DIR))
    try:
        info = json.loads(proc.stdout.readline())
        if info.get("event") != "listening":
            raise AssertionError(f"8e: server_main did not listen: {info}")
        t = time.perf_counter()
        rc = smoke_client.run("127.0.0.1", info["port"], timeout=120.0,
                              device=device.type)
        out.update(smoke_rc=rc, smoke_s=time.perf_counter() - t)
    finally:
        server_rc = _stop(proc)
    if rc != 0 or server_rc != 0:
        raise AssertionError(f"8e: smoke client {rc}, server {server_rc}")
    print(f"8e smoke client: 0 in {out['smoke_s']:.2f} s against "
          "server_main on the card", flush=True)


def _client_holds(device, reader_state, b_mid, b_ops, c_mid, c_ops):
    """Each kernel against its plain version at phase 8's shapes, with its
    time and byte floor: K1/K2 at one document (random cases, K 1, at
    every width of :data:`CLIENT_D1_CAPS`, and the moves at the tile and
    cluster-slice edges and the compactions that meet them, one document
    a launch), the end state of 8a's reader with its next ops; K1/K3 at
    8b's shape; K1/K2 at 8c's. Launch counts are left as they were."""
    from fluidframework_tpu_torch.ops.segment_state import to_packed

    rows = []

    def hold(name, t, s, ops, cell, reps=10, plain_reps=3):
        d, cap = t.shape[1], t.shape[2]
        k = ops.shape[1] if ops is not None else 0
        err, ms, plain_ms = hold_kernel(name, t, s, ops, reps, plain_reps)
        b = bound_bytes(name, d, cap, k)
        rows.append(dict(kernel=name, cell=cell, docs=d, cap=cap, k=k,
                         tier=_cuda.tier(cap, KERNELS[name]["entry"]),
                         max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b / HBM_BYTES_PER_S * 1e3, bound_bytes=b,
                         library_ms=None))
        if ms is not None:
            print(f"client kernels {cell} S={cap} D={d} K={k} "
                  f"({rows[-1]['tier']}) {name}: exact, {ms:.4f} ms (plain "
                  f"{plain_ms:.3f} ms, bound {rows[-1]['bound_ms']:.5f} ms)",
                  flush=True)

    with _Uncounted():
        for cap in CLIENT_D1_CAPS:
            for seed in range(4):
                t, s, ops = random_case(np.random.default_rng(cap + seed), 1,
                                        cap, 1, device)
                reps = 10 if seed == 0 else 0
                hold("K1_merge_apply", t, s, ops, "D1", reps)
                hold("K2_zamboni_compact", t, s, None, "D1", reps)
            t, s, ops = edge_case(cap, device, k=2)
            for i in range(t.shape[1]):
                hold("K1_merge_apply", t[:, i:i + 1].contiguous(),
                     s[i:i + 1].contiguous(), ops[i:i + 1].contiguous(),
                     "D1 edge", 0, 0)
            t, s, _ = compact_edge_case(cap, device)
            for i in range(t.shape[1]):
                hold("K2_zamboni_compact", t[:, i:i + 1].contiguous(),
                     s[i:i + 1].contiguous(), None, "D1 edge", 0, 0)
        t, s, _single = to_packed(reader_state)
        nxt = torch.from_numpy(np.stack([
            E.insert(3, 10**6, 2, seq=10**6, ref=10**6 - 1, client=1),
        ])[None]).to(device)
        hold("K1_merge_apply", t, s, nxt, "8a end state")
        hold("K2_zamboni_compact", t, s, None, "8a end state")
        hold("K1_merge_apply", *b_mid, b_ops, "8b config 2b")
        hold("K3_fused_apply_compact", *b_mid, b_ops, "8b config 2b")
        hold("K1_merge_apply", *c_mid, c_ops, "8c config 4", 5, 1)
        hold("K2_zamboni_compact", *c_mid, None, "8c config 4", 5, 1)
    return [r for r in rows if r["ms"] is not None] + [dict(
        kernel="all", cell="D1 edge", held=sum(
            1 for r in rows if r["cell"] == "D1 edge"))]


def phase_client(device, report):
    """Phase 8: the client merge path on the card, under
    ``torch.cuda.set_sync_debug_mode("warn")``: 8a config 1, 8b config 2b,
    8c config 4, 8d the DDS family through the runtime, 8e the smoke
    client; then each kernel held against its plain version at these
    shapes. Launch counts are read per sub-phase; returns their sum."""
    out = {key: {} for key in ("8a", "8b", "8c", "8d", "8e")}
    launches = {}
    wall = {}
    torch.cuda.set_sync_debug_mode("warn")
    try:
        steps = (("8a", client_8a), ("8b", client_8b), ("8c", client_8c),
                 ("8d", client_8d), ("8e", client_8e))
        results = {}
        for key, fn in steps:
            reset_counts()
            t = time.perf_counter()
            results[key] = fn(device, out[key])
            wall[key] = time.perf_counter() - t
            launches[key] = read_counts()
            print(f"8 {key}: {wall[key]:.1f} s, launches "
                  f"{ {n: c for n, c in launches[key].items() if c['all']} }",
                  flush=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    total = {name: {t: sum(launches[k][name][t] for k in launches)
                    for t in ("all", "smem", "cluster", "global")}
             for name in KERNELS}
    for name, c in total.items():
        if c["all"] <= 0:
            raise AssertionError(f"{name} never launched on the client path")
    print(f"client launches by tier: {total}", flush=True)
    t = time.perf_counter()
    holds = _client_holds(device, results["8a"], *results["8b"],
                          *results["8c"])
    wall["holds"] = time.perf_counter() - t
    report["phase_client"] = dict(out, launches=launches, total=total,
                                  holds=holds, wall_s=wall)
    return dict(launches=total, holds=holds)


# -- phase 9: scale-out (the mesh fleet, the serving pump on the mesh,
# sharded overflow, multi-node ordering) ----------------------------------------


def mesh_op_stream(n_docs: int, k: int, rng) -> np.ndarray:
    """``build_op_stream`` of bench.py: 16 scripts tiled over the fleet,
    inserts/removes with fully acked refs, each closed by a whole-document
    remove that the collab window passes, so the stream replays forever."""
    ops = np.zeros((n_docs, k, OP_WIDTH), np.int32)
    for d in range(min(n_docs, 16)):
        length = seq = 0
        for i in range(k - 1):
            seq += 1
            if length >= 8 and rng.random() < 0.45:
                a = int(rng.integers(0, length - 2))
                b = a + int(rng.integers(1, 3))
                ops[d, i] = E.remove(a, b, seq=seq, ref=seq - 1,
                                     client=int(rng.integers(0, 8)))
                length -= b - a
            else:
                ops[d, i] = E.insert(int(rng.integers(0, length + 1)),
                                     1000 + i, 4, seq=seq, ref=seq - 1,
                                     client=int(rng.integers(0, 8)))
                length += 4
        ops[d, k - 1] = E.remove(0, length, seq=k, ref=k - 1, client=0,
                                 msn=k)
    for d in range(16, n_docs):
        ops[d] = ops[d % 16]
    return ops


def _same_pools(a, b, what: str) -> None:
    """Every pool of fleet ``b`` equals ``a``'s lane for lane (a mesh
    pool's shards gathered on its first device)."""
    if sorted(a.pools) != sorted(b.pools):
        raise AssertionError(f"{what}: pools {sorted(a.pools)} != "
                             f"{sorted(b.pools)}")
    for cap, pa in a.pools.items():
        pb = b.pools[cap]
        if not (torch.equal(pa.tables, pb.tables.to(pa.device))
                and torch.equal(pa.scalars, pb.scalars.to(pa.device))
                and np.array_equal(pa.doc_of_slot, pb.doc_of_slot)):
            raise AssertionError(f"{what}: pool {cap} differs")


def _sum_counts(*counts) -> dict:
    return {name: {t: sum(c[name][t] for c in counts)
                   for t in ("all", "smem", "cluster", "global")}
            for name in KERNELS}


def mesh_9a(device, lists, n_docs=12_288, cap=128, k=8, rounds=3):
    """9a: ``fleet_mesh_comparison``'s TPU shape (bench.py:319-383) —
    DocFleet(n_docs, cap) with and without ``mesh=``, the same sparse
    boxcars of k ops to every document + a compaction, two warm steps,
    then ``rounds`` timed, in turns (no mesh, each list, no mesh again);
    every mesh pool equal to the no-mesh fleet's."""
    from fluidframework_tpu_torch.parallel.mesh import Mesh

    ops = mesh_op_stream(n_docs, k, np.random.default_rng(3))
    docs = np.arange(n_docs)

    def step(fleet):
        fleet.apply_sparse(docs, ops)
        fleet.compact()

    def run(fleet):
        step(fleet)
        step(fleet)
        _sync(device)
        reset_counts()
        t = time.perf_counter()
        for _ in range(rounds):
            step(fleet)
        _sync(device)
        wall = time.perf_counter() - t
        launches = read_counts()
        step_ms = _event_ms(device, lambda: step(fleet), reps=3)
        st = fleet.stats()
        if st["docs_with_errors"]:
            raise AssertionError(f"9a: {st['docs_with_errors']} docs erred")
        return dict(ops_per_s=n_docs * k * rounds / wall,
                    ms_per_step=wall / rounds * 1e3, event_ms_per_step=step_ms,
                    launches=launches,
                    launches_per_step={n: c["all"] / rounds
                                       for n, c in launches.items()})

    base = DocFleet(n_docs, cap, device=device)
    out = {"no_mesh": run(base)}
    holds = []
    for name, devs in lists.items():
        fleet = DocFleet(n_docs, cap, mesh=Mesh(devs))
        per = fleet.pools[cap].per
        if name == "8x":
            # K1/K2 against their plain versions at one shard's shape.
            t0, s0 = (x.clone() for x in fleet.pools[cap].parts[0])
            o0 = torch.from_numpy(ops[:per]).to(device)
        out[name] = run(fleet)
        out[name]["shards"] = len(devs)
        _same_pools(base, fleet, f"9a mesh {name}")
        if name == "8x":
            for kname in ("K1_merge_apply", "K2_zamboni_compact"):
                err, ms, plain_ms = hold_kernel(kname, t0, s0, o0)
                holds.append(dict(
                    kernel=kname, cell="9a", docs=per, cap=cap, k=k,
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_bytes(kname, per, cap, k)
                    / HBM_BYTES_PER_S * 1e3))
            del t0, s0, o0
        del fleet
        torch.cuda.empty_cache()
    # The no-mesh fleet again, last: the lists ran between its two turns.
    out["no_mesh_again"] = run(base)
    for name, r in out.items():
        print(f"9a {name}: {r['ops_per_s']:,.0f} ops/s, "
              f"{r['ms_per_step']:.3f} ms a step (event "
              f"{r['event_ms_per_step']:.3f}), launches a step "
              f"{r['launches_per_step']}", flush=True)
    return out, holds


def mesh_9b(device, mesh_devs, n_ch=4096, k=16, rounds=12, cap=1024,
            compact_every=8):
    """9b: ``serving_pump_benchmark``'s TPU shape (bench.py:387-510) —
    DeviceFleetBackend(capacity=1,024, max_batch=1<<20) fed n_ch channels
    of one k-op SeqFrame a round (a compaction cadence of warm-up, then
    ``rounds`` timed), pump and one-shot on the mesh, the pump without it,
    and a ``kernel="plain"`` replay: every final pool equal."""
    from fluidframework_tpu_torch.parallel.mesh import Mesh

    base_rows = np.zeros((n_ch, k, OP_WIDTH), np.int32)
    base_rows[:, :, F_TYPE] = OP_INSERT
    base_rows[:, :, F_LEN] = 1
    ar = np.arange(k, dtype=np.int32)

    def feed(be, r):
        rows = base_rows.copy()
        rows[:, :, F_SEQ] = r * k + 1 + ar[None, :]
        rows[:, :, F_REF] = r * k
        rows[:, :, F_ARG] = r * k + 1 + ar[None, :]
        for i in range(n_ch):
            be.enqueue_frame(f"d{i}", SeqFrame("s", 0, 1, rows[i], (), 0.0))

    def run(pump, mesh=None, kernel="auto"):
        be = DeviceFleetBackend(
            capacity=cap, max_batch=1 << 20, mesh=mesh, pump_mode=pump,
            compact_every=compact_every, kernel=kernel,
            device=None if mesh is not None else device)
        for r in range(compact_every):
            feed(be, r)
            be.flush()
        be.collect_now()
        _sync(device)
        reset_counts()
        busy0 = be.pump_busy_s
        t = time.perf_counter()
        for r in range(compact_every, compact_every + rounds):
            feed(be, r)
            if pump:
                be.pump_stage()
                be.pump_dispatch()
            else:
                be.flush()
        if pump:
            be.pump_drain()
        else:
            be.collect_now()
        _sync(device)
        wall = time.perf_counter() - t
        st = be.stats()
        if st["docs_with_errors"] or st["ops_applied"] != \
                n_ch * k * (rounds + compact_every):
            raise AssertionError(f"9b: {st}")
        return be, dict(
            ops_per_s=n_ch * k * rounds / wall,
            ms_per_round=wall / rounds * 1e3,
            idle_share=max(0.0, 1 - (be.pump_busy_s - busy0) / wall)
            if pump else None,
            launches=read_counts())

    mesh = Mesh(mesh_devs)
    out, fleets = {}, {}
    for name, pump, m in (("mesh_pump", True, mesh),
                          ("mesh_oneshot", False, mesh),
                          ("no_mesh_pump", True, None)):
        be, out[name] = run(pump, m)
        fleets[name] = be.fleet
        print(f"9b {name}: {out[name]['ops_per_s']:,.0f} ops/s, "
              f"{out[name]['ms_per_round']:.2f} ms a round, idle share "
              f"{out[name]['idle_share']}, launches "
              f"{ {n: c['all'] for n, c in out[name]['launches'].items()} }",
              flush=True)
    plain, _r = run(False, None, "plain")
    for name, fleet in fleets.items():
        _same_pools(plain.fleet, fleet, f"9b {name} vs the plain replay")
    del fleets, plain
    torch.cuda.empty_cache()
    return out


def _overflow_state(n_rows: int, cap: int):
    """A host single-document state of ``n_rows`` distinct acked one-char
    inserts in a ``cap``-row table (no two rows merge on compaction)."""
    from fluidframework_tpu_torch.ops.segment_state import (
        LANE_FILLS,
        SegmentState,
    )

    lanes = {k: np.full(cap, LANE_FILLS.get(k, 0), np.int32)
             for k in SEGMENT_LANES}
    lanes["kind"][:n_rows] = KIND_TEXT
    lanes["orig"][:n_rows] = np.arange(1, n_rows + 1)
    lanes["length"][:n_rows] = 1
    lanes["seq"][:n_rows] = np.arange(1, n_rows + 1)
    return SegmentState(**lanes, count=np.int32(n_rows), min_seq=np.int32(0),
                        cur_seq=np.int32(n_rows),
                        self_client=np.int32(NO_CLIENT),
                        err=np.int32(0))


def mesh_9c(device, window=1000, frame_ops=512, target_rows=80_000,
            **overrides):
    """9c: ``config/config.json`` (capacity 128, max capacity 65,536) with
    ``device_sharded_overflow=True`` through PipelineFluidService's bulk
    front door: one document of frames of 4-character inserts at random
    positions (most split a row, so a row costs ~0.6 ops) grows
    through every tier, re-homes past 49,152 live rows into a ShardedDoc
    of 8 x 65,536 rows and goes on past ``target_rows``; its text equals a
    host string of the same inserts. The ``window`` ops after promotion
    are replayed from a clone through ``kernel="plain"``, every shard bit
    for bit; one apply and one compaction run under sync-debug "error".
    ``overrides`` replace config keys (a CPU rehearsal's small tiers)."""
    from fluidframework_tpu_torch.service.server_main import load_config

    cfg = load_config(os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "config", "config.json"),
        overrides=overrides)
    svc = PipelineFluidService(
        n_partitions=cfg["partitions"],
        checkpoint_every=cfg["checkpoint_every"],
        device_capacity=cfg["device_capacity"],
        device_max_capacity=cfg["device_max_capacity"],
        device_sharded_overflow=True, device_torch=device)
    be = svc.device
    doc = "big"
    conn = svc.connect(doc)
    rng = np.random.default_rng(9)
    text: list = []
    orig = csn = 0
    ops_total = 0
    promoted_at = None
    sharded = None
    record: list = []
    twin = None
    t_start = time.perf_counter()
    t_promo = None
    apply_wall = [0.0, 0]

    def frame(n):
        nonlocal orig, csn
        kinds, pos, origs, texts = [], [], [], []
        for _ in range(n):
            p = int(rng.integers(0, len(text) + 1))
            orig += 1
            t = "".join(chr(97 + (orig + j) % 26) for j in range(4))
            text[p:p] = t
            kinds.append("ins")
            pos.append(p)
            origs.append(orig)
            texts.append(t)
        f = OpFrame.build("s", kinds, pos, origs, texts, csn0=csn + 1,
                          ref=svc.doc_head(doc))
        csn += n
        return f

    reset_counts()
    launches_pre = None
    while True:
        if ops_total > 4 * target_rows:
            raise AssertionError(f"9c: no promotion past {ops_total} ops")
        idx = be._index.get((doc, "s"))
        rows_now = (sharded.rows_in_use() if sharded is not None
                    else 0 if idx is None
                    else int(be.fleet.doc_counts([idx])[0]))
        if sharded is not None and rows_now >= target_rows \
                and len(record) >= 1 and twin is None:
            break
        svc.submit_frames_bulk([(doc, conn.client_id, frame(frame_ops))])
        svc.flush_device()
        ops_total += frame_ops
        conn.inbox.clear()
        if sharded is None and be.stats()["sharded_docs"]:
            promoted_at = ops_total
            t_promo = time.perf_counter()
            launches_pre = read_counts()
            reset_counts()
            sharded = be._sharded[idx]
            twin = sharded.clone(kernel="plain")
            real = dict(apply=sharded.apply, compact=sharded.compact,
                        rebalance=sharded.rebalance)

            def apply(rows):
                t = time.perf_counter()
                if twin is not None:
                    record.append(("apply", np.array(rows)))
                real["apply"](rows)
                apply_wall[0] += time.perf_counter() - t
                apply_wall[1] += len(rows)

            def compact():
                if twin is not None:
                    record.append(("compact", None))
                real["compact"]()

            def rebalance(trigger=0.8):
                if twin is not None:
                    record.append(("rebalance", trigger))
                return real["rebalance"](trigger)

            sharded.apply, sharded.compact = apply, compact
            sharded.rebalance = rebalance
            print(f"9c: promoted at {ops_total} ops ({rows_now} live rows "
                  f"before), shard cap {sharded.shard_cap} x "
                  f"{sharded.n_shards}", flush=True)
        if twin is not None and sum(len(r[1]) for r in record
                                    if r[0] == "apply") >= window:
            # The plain replay of the window from the clone.
            for what, arg in record:
                if what == "apply":
                    twin.apply(arg)
                elif what == "compact":
                    twin.compact()
                else:
                    twin.rebalance(arg)
            for f, a, b in zip(SEGMENT_LANES + ("scalars",),
                               [*sharded.state[:15],
                                np.stack(sharded.state[15:])],
                               [*twin.state[:15],
                                np.stack(twin.state[15:])]):
                if not np.array_equal(a, b):
                    raise AssertionError(f"9c: the card != the plain replay "
                                         f"over {window} ops ({f})")
            print(f"9c: {sum(len(r[1]) for r in record if r[0] == 'apply')}"
                  f" ops after promotion equal the plain replay, every "
                  "shard", flush=True)
            twin = None
    _sync(device)
    wall_post = time.perf_counter() - t_promo
    launches_post = read_counts()
    ops_post = ops_total - promoted_at
    st = be.stats()
    if st["sharded_docs"] != 1 or st["docs_with_errors"]:
        raise AssertionError(f"9c: {st}")
    rows = sharded.rows_in_use()
    if rows < target_rows:
        raise AssertionError(f"9c: {rows} live rows < {target_rows}")
    got = svc.device_text(doc, "s")
    if got != "".join(text):
        raise AssertionError("9c: the device text != the host string")
    # No host sync in apply and compact of a clone.
    probe = sharded.clone()
    probe_rows = frame(64).rows.copy()
    probe_rows[:, F_SEQ] = np.arange(64) + int(probe.state.cur_seq.max()) + 1
    _no_sync(device, probe.apply, probe_rows)
    _no_sync(device, probe.compact)
    # One op's launches and device time (torch.profiler), and its host
    # wall with a synchronize.
    one = probe_rows[:1].copy()
    one[0, F_SEQ] += 64
    prof = _profile(device, lambda: probe.apply(one))
    one[0, F_SEQ] += 1
    t = time.perf_counter()
    probe.apply(one)
    _sync(device)
    op_wall_ms = (time.perf_counter() - t) * 1e3
    # K1/K2 against their plain versions at the sharded shape: one insert
    # owner, every other shard a NOOP.
    g = sharded._groups[0]
    t0, s0 = g.tables.clone(), g.scalars.clone()
    o1 = torch.zeros((sharded.n_shards, 1, OP_WIDTH), dtype=torch.int32,
                     device=device)
    o1[:, 0, F_SEQ] = int(s0[:, 2].max()) + 1
    o1[3, 0] = torch.from_numpy(E.insert(int(s0[3, 0]) // 2, 1, 1,
                                         seq=int(s0[:, 2].max()) + 1,
                                         ref=0, client=0))
    holds = []
    for kname in ("K1_merge_apply", "K2_zamboni_compact"):
        err, ms, plain_ms = hold_kernel(kname, t0, s0, o1)
        holds.append(dict(
            kernel=kname, cell="9c", docs=sharded.n_shards,
            cap=sharded.shard_cap, k=1, max_abs_err=err, ms=ms,
            plain_ms=plain_ms,
            bound_ms=bound_bytes(kname, sharded.n_shards, sharded.shard_cap,
                                 1) / HBM_BYTES_PER_S * 1e3))
    del t0, s0, probe
    out = dict(
        ops_total=ops_total, promoted_at_ops=promoted_at,
        live_rows=rows, shard_rows=[int(c) for c in sharded.state.count],
        ops_per_s_after_promotion=ops_post / wall_post,
        ms_per_op_after_promotion=wall_post / ops_post * 1e3,
        apply_ms_per_op=apply_wall[0] / max(apply_wall[1], 1) * 1e3,
        launches_before_promotion=launches_pre,
        launches_after_promotion=launches_post,
        launches_per_op={n: c["all"] / ops_post
                         for n, c in launches_post.items()},
        one_op=dict(prof, host_ms_synced=op_wall_ms),
        wall_s=time.perf_counter() - t_start, stats=dict(
            sharded_docs=st["sharded_docs"], sharded_rows=st["sharded_rows"],
            docs_with_errors=st["docs_with_errors"]))
    print(f"9c: {ops_total} ops, {rows} live rows over "
          f"{sharded.n_shards} shards {out['shard_rows']}; after promotion "
          f"{out['ops_per_s_after_promotion']:,.0f} ops/s "
          f"({out['ms_per_op_after_promotion']:.3f} ms an op, apply "
          f"{out['apply_ms_per_op']:.3f} ms), launches an op "
          f"{out['launches_per_op']}; one op: {prof['launches']} device "
          f"launches, {prof['device_us']:.1f} µs busy, {prof['aten_ops']} "
          f"ATen ops, {op_wall_ms:.3f} ms synced", flush=True)
    del svc, be, sharded
    torch.cuda.empty_cache()
    return out, holds


def mesh_9c_one_entry(device, visible, cap=65536,
                      frame_ops=2048) -> dict:
    """9c on the list of every visible card. With one card the backend's
    overflow promotion would ask for 8 x ``cap`` / 1 rows a shard, past
    K1's largest tier: the promotion is refused before anything moves.
    A document of 0.75 ``cap`` + 1 distinct rows, placed at the top
    tier's high water, keeps its top-tier slot and its lanes, is not
    sharded, and a second scan neither compacts nor counts it again. It
    then takes one-character appends until it trips ERR_CAPACITY, reported
    once, exactly as a backend without sharded overflow given the same
    frames (lanes equal at every frame). With more cards the shard fits
    and nothing is refused."""
    from fluidframework_tpu_torch.interop import segment_state_to_numpy
    from fluidframework_tpu_torch.parallel import mesh as M
    from fluidframework_tpu_torch.parallel.sharded_doc import check_shard_cap

    shard_cap = -(-8 * cap // len(visible))
    try:
        check_shard_cap(shard_cap, "auto", visible)
    except ValueError as e:
        reason = str(e)
    else:
        return dict(cards=len(visible), shard_cap=shard_cap, refused=False)
    n0 = cap * 3 // 4 + 1
    bes = []
    for overflow in (True, False):
        be = DeviceFleetBackend(capacity=cap, max_capacity=cap,
                                sharded_overflow=overflow, device=device)
        idx = be.ensure("one", "s")
        be.fleet.evict_doc(idx)
        be.fleet.restore_doc(idx, _overflow_state(n0, cap))
        bes.append(be)
    be, off = bes
    idx = be._index[("one", "s")]
    place = be.fleet.placement[idx]

    def lanes(b):
        return list(segment_state_to_numpy(b.fleet.doc_state(idx)))

    M.set_devices(visible)
    try:
        before = lanes(be)
        compacts = []
        real = be.fleet.compact
        be.fleet.compact = lambda: (compacts.append(1), real())[1]
        for call in range(2):
            be._promote_overflow()
            if (be.fleet.placement[idx] != place or idx in be._sharded
                    or compacts or be._promotion_refused != {idx}):
                raise AssertionError(
                    f"9c one card, call {call}: placement "
                    f"{be.fleet.placement[idx]} (was {place}), sharded "
                    f"{idx in be._sharded}, compactions {len(compacts)}, "
                    f"refused {be._promotion_refused}")
            _same_lanes(lanes(be), before, "9c refused promotion")
        del be.fleet.compact  # the class's again for the scheduled ones
        seq, n_ops, reported = n0, 0, []
        while not reported:
            if n_ops > cap:
                raise AssertionError("9c one card: no ERR_CAPACITY")
            rows = np.stack([E.insert(seq + j, seq + j + 1, 1,
                                      seq=seq + j + 1, ref=seq + j, client=0)
                             for j in range(frame_ops)]).astype(np.int32)
            got = []
            for b in (be, off):
                b.enqueue_frame("one", SeqFrame("s", 0, seq + 1, rows, (),
                                                0.0))
                got.append(b.flush() + b.collect_now())
            if got[0] != got[1]:
                raise AssertionError(f"9c one card: reports {got}")
            _same_lanes(lanes(be), lanes(off), "9c refused vs no overflow")
            reported = got[0]
            seq += frame_ops
            n_ops += frame_ops
        st = be.stats()
        if (reported != [("one", "s")] or be.fleet.placement[idx] != place
                or st["docs_with_errors"] != 1 or st["sharded_docs"]
                or st["promotions_refused"] != 1):
            raise AssertionError(f"9c one card: reported {reported}, stats "
                                 f"{st}")
        if be.flush() + be.collect_now():
            raise AssertionError("9c one card: ERR_CAPACITY reported twice")
    finally:
        M.set_devices([device] * 8)
    out = dict(cards=len(visible), shard_cap=shard_cap, refused=True,
               reason=reason, rows_at_refusal=n0, ops_to_capacity=n_ops,
               placement=list(place))
    print(f"9c list {[str(d) for d in visible]}: promotion refused "
          f"({reason}); the doc kept its {place} slot and lanes, no "
          f"compaction, refused once; ERR_CAPACITY after {n_ops} more ops, "
          "reported once, lanes == the backend without sharded overflow",
          flush=True)
    return out


def mesh_9d(n_nodes=3, n_docs=1024, fenced=16):
    """9d: tests/test_multinode.py's failover and fencing at 3 nodes x
    1,024 documents over NativeCoordination (``native/coordination.cpp``):
    two replicas of a SharedMap per document, the node holding the most
    documents killed, its documents sequenced again by the survivors
    (the failover time), stale owners fenced; every log contiguous and
    fenced, every replica pair equal."""
    from fluidframework_tpu_torch.models.shared_map import SharedMap
    from fluidframework_tpu_torch.protocol.types import (
        DocumentMessage as DM,
        NackMessage,
    )
    from fluidframework_tpu_torch.runtime.container import ContainerRuntime
    from fluidframework_tpu_torch.service.multinode import (
        MultiNodeFluidService,
    )
    from fluidframework_tpu_torch.utils.native import NativeCoordination

    now = [1000.0]

    def clock():
        return now[0]

    svc = MultiNodeFluidService(
        n_nodes=n_nodes, clock=clock,
        reservations=NativeCoordination(clock), lease_ttl_s=5.0,
        rebalance_every=0)
    docs = [f"doc-{i}" for i in range(n_docs)]
    rts = {}
    t = time.perf_counter()
    for d in docs:
        a = ContainerRuntime(svc, d, channels=(SharedMap("m"),))
        b = ContainerRuntime(svc, d, channels=(SharedMap("m"),))
        a.get_channel("m").set("k", "before")
        for rt in (a, b):
            rt.flush()
        while a.process_incoming() or b.process_incoming():
            pass
        rts[d] = (a, b)
    setup_s = time.perf_counter() - t
    owners = {d: svc.cluster.reservations.holder(d) for d in docs}
    per_node = {n.name: sum(1 for o in owners.values() if o == n.name)
                for n in svc.cluster.nodes}
    victim = max(per_node, key=per_node.get)
    moved = [d for d in docs if owners[d] == victim]
    next(n for n in svc.cluster.nodes if n.name == victim).kill()
    now[0] += 10  # the victim's leases lapse
    t = time.perf_counter()
    for d in moved:
        a, b = rts[d]
        b.get_channel("m").set("k", "after")
        b.flush()
        while a.process_incoming() or b.process_incoming():
            pass
    failover_s = time.perf_counter() - t
    # Stale owners: a paused holder loses its lease to a survivor and its
    # next (valid) ticket is fenced off the log.
    fences = 0
    picks = [d for d in docs if d not in moved][:fenced]
    stale_of = {d: svc.cluster.owner(d) for d in picks}  # renews the lease
    now[0] += 10  # the holders pause past their leases
    for d in picks:
        stale = stale_of[d]
        other = next(n for n in svc.cluster.nodes
                     if n.alive and n is not stale)
        if not other.try_own(d):
            raise AssertionError(f"9d: no takeover of {d}")
        a = rts[d][0]
        zombie = stale._docs[d]
        res = stale.ticket(d, a.client_id, DM(
            zombie.clients[a.client_id].client_seq + 1, zombie.seq,
            MessageType.OPERATION, contents={"address": "m",
                                              "contents": None}))
        fences += isinstance(res, NackMessage)
    for d in docs:
        seqs = [m.sequence_number for m in svc.get_deltas(d)]
        if seqs != list(range(1, len(seqs) + 1)):
            raise AssertionError(f"9d: {d}'s log is not contiguous")
        a, b = rts[d]
        if a.get_channel("m").get("k") != b.get_channel("m").get("k"):
            raise AssertionError(f"9d: {d}'s replicas differ")
    if any(svc.cluster.op_log._epochs[d] < 2 for d in moved) or \
            fences != fenced:
        raise AssertionError("9d: a takeover was not fenced")
    out = dict(nodes=n_nodes, docs=n_docs, per_node=per_node,
               killed=victim, migrated=len(moved), setup_s=setup_s,
               failover_s=failover_s,
               failover_ms_per_doc=failover_s / max(len(moved), 1) * 1e3,
               fenced=fences)
    print(f"9d: {n_nodes} nodes x {n_docs} docs {per_node}; killed "
          f"{victim}: {len(moved)} docs failed over in {failover_s:.3f} s "
          f"({out['failover_ms_per_doc']:.3f} ms a doc); {fences} stale "
          "owners fenced; every log contiguous", flush=True)
    return out


def phase_mesh(device, report):
    """Phase 9: scale-out. The port's device list is set to 8 x
    ``cuda:0`` (the counterpart of the reference's 8-device test mesh);
    9a also runs the 1-entry list of every visible card. Launch counts are
    reset before each sub-phase and read after it; returns the mesh path's
    (9a's and 9b's mesh runs) and the sharded path's (9c) launches and the
    kernel holds at their shapes."""
    from fluidframework_tpu_torch.parallel import mesh as M

    visible = [torch.device("cuda", i)
               for i in range(torch.cuda.device_count())]
    lists = {"8x": [device] * 8, "visible": visible}
    M.set_devices(lists["8x"])
    wall = {}
    try:
        t = time.perf_counter()
        r9a, holds = mesh_9a(device, lists)
        wall["9a"] = time.perf_counter() - t
        t = time.perf_counter()
        r9b = mesh_9b(device, lists["8x"])
        wall["9b"] = time.perf_counter() - t
        t = time.perf_counter()
        r9c, holds_c = mesh_9c(device)
        r9c["one_entry"] = mesh_9c_one_entry(device, visible)
        wall["9c"] = time.perf_counter() - t
        t = time.perf_counter()
        r9d = mesh_9d()
        wall["9d"] = time.perf_counter() - t
    finally:
        M.set_devices(None)
    mesh_launches = _sum_counts(r9a["8x"]["launches"],
                                r9a["visible"]["launches"],
                                r9b["mesh_pump"]["launches"],
                                r9b["mesh_oneshot"]["launches"])
    sharded_launches = _sum_counts(r9c["launches_before_promotion"],
                                   r9c["launches_after_promotion"])
    for name in ("K1_merge_apply", "K2_zamboni_compact"):
        for path, c in (("mesh", mesh_launches),
                        ("sharded", sharded_launches)):
            if c[name]["all"] <= 0:
                raise AssertionError(f"{name} never launched on the {path} "
                                     "path")
    print(f"9 wall s: { {k: round(v, 1) for k, v in wall.items()} }",
          flush=True)
    report["phase_mesh"] = dict(fleet=r9a, serving=r9b, sharded=r9c,
                                multinode=r9d, holds=holds + holds_c,
                                wall_s=wall)
    return dict(mesh=mesh_launches, sharded=sharded_launches,
                holds=holds + holds_c)


# -- phase 10: the oracle, the load harness and the other DDS models ---------

# (rows S, docs D) of 10a: the shared tier and the cluster tier, 96 ops a
# document (bench.py's device_state_parity at larger sizes).
ORACLE_SHAPES = ((256, 4096), (4096, 256))
ORACLE_OPS = 96
# 10b's ops in the default smoke: CHAOS_STRESS_FULL_PROFILE at its full
# width (48 clients, trees, the summarizer every 150, GC every 300,
# chaos) cut from 3,000 ops, whose run takes ~700 s on the card (the
# replicas' tree ingest is host- and launch-bound; PERF.md), more than
# the smoke's budget leaves; 320 keeps one GC pass. ``--load`` runs all
# 3,000.
SMOKE_LOAD_OPS = 320


def oracle_streams(n_docs: int, n_ops: int, seed0: int):
    """bench.py's parity streams: one ``random_acked_stream`` a document
    (msn lag 24, refs caught up, seed ``seed0 + d``), evolved beside its
    ``OracleDoc``, one payload table. Returns (int32 ops [D, K, W],
    payloads, oracles)."""
    from fluidframework_tpu_torch.testing.fuzz import random_acked_stream
    from fluidframework_tpu_torch.testing.oracle import OracleDoc

    payloads: dict = {}
    oracles = [OracleDoc(NO_CLIENT) for _ in range(n_docs)]
    batch = np.stack([np.stack(random_acked_stream(
        np.random.default_rng(seed0 + d), n_ops, payloads, oracles[d],
        msn_lag=24, caught_up=True)) for d in range(n_docs)])
    return batch.astype(np.int32), payloads, oracles


def oracle_rate(batch: np.ndarray, n_docs: int = 256) -> float:
    """The oracle's host ops/s replaying ``n_docs`` of the streams
    (bench.py's ``cpu_oracle_baseline``)."""
    from fluidframework_tpu_torch.testing.oracle import OracleDoc

    t = time.perf_counter()
    for row_set in batch[:n_docs]:
        doc = OracleDoc(NO_CLIENT)
        for row in row_set:
            doc.apply(row)
    return min(n_docs, len(batch)) * batch.shape[1] / (
        time.perf_counter() - t)


def load_10a(device, cap: int, n_docs: int, seed0: int, n_ops=ORACLE_OPS):
    """One 10a shape: the streams through K1 (first half), K2, K1 (second
    half), K2 on the card; every document's text equals its oracle's,
    every err lane is clear, and the lanes equal the plain versions' on
    the same inputs. K1 and K2 are then timed at the shape beside their
    plain versions. Returns (record, holds)."""
    from fluidframework_tpu_torch.ops import segment_state as SS

    t = time.perf_counter()
    batch, payloads, oracles = oracle_streams(n_docs, n_ops, seed0)
    gen_s = time.perf_counter() - t
    rate = oracle_rate(batch)
    t0, s0, _ = SS.to_packed(SS.make_batched_state(n_docs, cap, NO_CLIENT,
                                                   device=device))
    ops = torch.from_numpy(batch).to(device)
    half = n_ops // 2
    first, second = ops[:, :half].contiguous(), ops[:, half:].contiguous()
    t, s = t0.clone(), s0.clone()
    reset_counts()
    K1.apply_ops_packed(t, s, first)
    K2.compact_packed(t, s)
    t_mid, s_mid = t.clone(), s.clone()
    K1.apply_ops_packed(t, s, second)
    K2.compact_packed(t, s)
    torch.cuda.synchronize()
    launches = read_counts()
    pt, ps = K1.apply_plain(t0, s0, first)
    pt, ps = K2.compact_plain(pt, ps)
    pt, ps = K1.apply_plain(pt, ps, second)
    pt, ps = K2.compact_plain(pt, ps)
    if not (torch.equal(t, pt) and torch.equal(s, ps)):
        raise AssertionError(f"10a S={cap}: card lanes != plain lanes")
    host = SS.to_host(SS.packed_views(t, s, False))
    if int((host.err != 0).sum()):
        raise AssertionError(f"10a S={cap}: err lanes set")
    bad = [d for d in range(n_docs) if SS.materialize(
        SS.SegmentState(*[x[d] for x in host]), payloads)
        != oracles[d].text(payloads)]
    if bad:
        raise AssertionError(f"10a S={cap}: {len(bad)} docs != their "
                             f"oracles, first {bad[:5]}")
    holds = []
    for name, (tt, ss, oo) in (("K1_merge_apply", (t0, s0, first)),
                               ("K2_zamboni_compact", (t_mid, s_mid, None))):
        err, ms, plain_ms = hold_kernel(name, tt, ss, oo)
        b = bound_bytes(name, n_docs, cap, half)
        holds.append(dict(kernel=name, cell=f"10a S={cap}",
                          tier=_cuda.tier(cap, KERNELS[name]["entry"]),
                          docs=n_docs, cap=cap, k=half, max_abs_err=err,
                          ms=ms, plain_ms=plain_ms,
                          bound_ms=b / HBM_BYTES_PER_S * 1e3,
                          bound_bytes=b, library_ms=None))
    rows = int(host.count.max())
    out = dict(docs=n_docs, cap=cap, ops=n_ops, gen_s=gen_s,
               oracle_ops_per_sec=rate, max_rows=rows, launches=launches,
               k1_ms=holds[0]["ms"], k2_ms=holds[1]["ms"])
    print(f"10a S={cap} D={n_docs} ({holds[0]['tier']}): {n_docs} docs x "
          f"{n_ops} ops == their oracles, err lanes clear, lanes == plain; "
          f"oracle host {rate:.0f} ops/s; K1 {holds[0]['ms']:.4f} ms a "
          f"{half}-op call (plain {holds[0]['plain_ms']:.3f}, bound "
          f"{holds[0]['bound_ms']:.4f}), K2 {holds[1]['ms']:.4f} ms (plain "
          f"{holds[1]['plain_ms']:.3f}, bound {holds[1]['bound_ms']:.4f}); "
          f"rows <= {rows}; streams built in {gen_s:.1f} s", flush=True)
    del t0, s0, t, s, pt, ps, t_mid, s_mid, ops, first, second
    torch.cuda.empty_cache()
    return out, holds


class UtilSampler:
    """``nvidia-smi``'s utilization.gpu (the share of each sample period in
    which a kernel ran) sampled every 200 ms while the ``with`` block
    runs; ``share`` is their mean over 100, None where it reads nothing."""

    def __enter__(self):
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=utilization.gpu",
                 "--format=csv,noheader,nounits", "-lms", "200", "-i", "0"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None
        return self

    def __exit__(self, *exc):
        self.samples, self.share = 0, None
        if self.proc is None:
            return False
        self.proc.terminate()
        try:
            out = self.proc.communicate(timeout=10)[0]
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out = self.proc.communicate()[0]
        vals = [int(x) for x in out.split() if x.strip().isdigit()]
        self.samples = len(vals)
        self.share = sum(vals) / len(vals) / 100 if vals else None
        return False


def load_profile_full_smoke():
    """tests/test_load.py's CI-sized full-stack chaos shape (16 clients x
    600 ops, trees, the elected summarizer, GC, chaos 0.02)."""
    from fluidframework_tpu_torch.testing.load import CHAOS_SMOKE_PROFILE

    return dataclasses.replace(
        CHAOS_SMOKE_PROFILE, doc_id="chaos-full-smoke", tree_weight=0.25,
        summary_interval=60, gc_every=120, total_ops=600)


def load_run(device, profile, n_partitions: int, exact: bool = False):
    """One ``LoadRunner`` profile over ``PipelineFluidService`` with the
    device stage and every replica's string and tree on ``device``; then
    a late-joining runtime loads the document (summary + deltas). With
    ``exact``, no wall clock decides a boxcar or a nack (feed deadline 0,
    overload lag reference infinite), so a card run and a CPU run can be
    compared. Returns (report fields, the late joiner's state, wall s)."""

    from fluidframework_tpu_torch.models.shared_map import SharedMap
    from fluidframework_tpu_torch.models.shared_string import SharedString
    from fluidframework_tpu_torch.runtime.container import ContainerRuntime
    from fluidframework_tpu_torch.service.admission import (
        OverloadController,
    )
    from fluidframework_tpu_torch.testing import faults
    from fluidframework_tpu_torch.testing.load import LoadRunner
    from fluidframework_tpu_torch.tree.shared_tree import SharedTree

    faults.REGISTRY.reset()
    kw = dict(n_partitions=n_partitions, device_torch=device)
    if exact:
        kw.update(device_feed_deadline_ms=0.0, overload=OverloadController(
            lag_ref_ms=float("inf")))
    svc = PipelineFluidService(**kw)
    t = time.perf_counter()
    report = LoadRunner(svc, profile, device=device).run()
    wall = time.perf_counter() - t
    chans = [SharedString("text", device=device), SharedMap("map")]
    if profile.tree_weight > 0:
        chans.append(SharedTree("tree", device=device))
    late = ContainerRuntime(svc, profile.doc_id, channels=tuple(chans))
    while late.process_incoming():
        pass
    state = dict(text=late.get_channel("text").get_text(),
                 annotations=late.get_channel("text").annotations(),
                 map=sorted(late.get_channel("map").items()),
                 tree=(late.get_channel("tree").get()
                       if profile.tree_weight > 0 else None))
    late.disconnect()
    fields = dataclasses.asdict(report)
    for key in ("elapsed_s", "journal_dump"):
        fields.pop(key)
    return fields, state, wall


def _cpu_load_run(profile, n_partitions):
    """The CPU half of 10b's card-vs-CPU check, in a process of its own
    beside the card's work."""
    torch.set_num_threads(1)
    return load_run(torch.device("cpu"), profile, n_partitions, exact=True)


def load_10b(device, profile=None, compare=True):
    """10b: ``profile`` (``CHAOS_STRESS_FULL_PROFILE`` by default) through
    the port's ``LoadRunner`` over ``PipelineFluidService(n_partitions=4)``
    on the card, with no wall clock deciding a boxcar or a nack (so the
    counts it checks are the same in every run, and the same as on the
    CPU): converged, every op submitted, chaos and client faults
    injected, summaries and GC ran, tree ingest recorded (the last three
    where the profile asks for them); wall, ops/s, K1/K2 launches and the
    card's busy share (``nvidia-smi``). With ``compare``, the CI-sized
    full-stack profile also runs on the card and on the CPU (in a spawned
    process, beside the card runs): reports and late joiners equal."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from fluidframework_tpu_torch.testing.load import (
        CHAOS_STRESS_FULL_PROFILE,
    )

    profile = profile or CHAOS_STRESS_FULL_PROFILE
    small = load_profile_full_smoke()
    pool = cpu = None
    if compare:
        pool = ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn"))
    try:
        if compare:
            cpu = pool.submit(_cpu_load_run, small, 2)
        reset_counts()
        with UtilSampler() as util:
            rep, state, wall = load_run(device, profile, 4, exact=True)
        torch.cuda.synchronize()
        launches = read_counts()
        checks = dict(converged=rep["converged"],
                      ops=rep["ops_submitted"] == profile.total_ops,
                      chaos=rep["chaos_injected"] > 0,
                      faults=rep["faults_injected"] > 0)
        if profile.summary_interval:
            checks.update(summaries=rep["summaries"] > 0,
                          gc=rep["gc_runs"] > 0)
        if profile.tree_weight > 0:
            checks["tree_ingest"] = bool(rep["tree_ingest"])
        if not all(checks.values()):
            counts = {k: v for k, v in rep.items()
                      if k not in ("texts", "annotations", "trees")}
            raise AssertionError(f"10b {profile.doc_id}: {checks}; "
                                 f"report {counts}")
        if state["text"] != rep["texts"][0]:
            raise AssertionError("10b: the late joiner's text != the "
                                 "replicas'")
        out = dict(
            profile=profile.doc_id, clients=profile.n_clients,
            ops=profile.total_ops, wall_s=wall,
            ops_per_sec=profile.total_ops / wall, launches=launches,
            busy_share=util.share, util_samples=util.samples,
            **{k: rep[k] for k in (
                "faults_injected", "chaos_injected", "reconnects", "nacks",
                "summaries", "gc_runs", "tree_ops_submitted",
                "tree_moves_submitted", "final_text_len", "tree_ingest")})
        busy = ("not measured" if util.share is None
                else f"{util.share:.3f}")
        print(f"10b {profile.doc_id} ({profile.n_clients} clients x "
              f"{profile.total_ops} ops) on the card: converged in "
              f"{wall:.1f} s ({out['ops_per_sec']:.1f} ops/s); faults "
              f"{rep['faults_injected']}, chaos {rep['chaos_injected']}, "
              f"nacks {rep['nacks']}, summaries {rep['summaries']}, GC "
              f"{rep['gc_runs']}, tree ops {rep['tree_ops_submitted']} "
              f"(moves {rep['tree_moves_submitted']}), tree ingest "
              f"{rep['tree_ingest']}; K1 {launches['K1_merge_apply']['all']}"
              f", K2 {launches['K2_zamboni_compact']['all']}; card busy {busy} "
              f"({util.samples} samples)", flush=True)
        if compare:
            t = time.perf_counter()
            card_rep, card_state, card_wall = load_run(device, small, 2,
                                                       exact=True)
            cpu_rep, cpu_state, cpu_wall = cpu.result()
            if card_rep != cpu_rep or card_state != cpu_state:
                diff = sorted(k for k in card_rep
                              if card_rep[k] != cpu_rep[k])
                raise AssertionError(f"10b CI-sized profile: card != CPU "
                                     f"(report fields {diff}; late joiner "
                                     f"{card_state == cpu_state})")
            if not card_rep["converged"]:
                raise AssertionError("10b CI-sized profile did not converge")
            out["ci_profile"] = dict(card_wall_s=card_wall,
                                     cpu_wall_s=cpu_wall,
                                     chaos_injected=card_rep[
                                         "chaos_injected"],
                                     summaries=card_rep["summaries"])
            print(f"10b CI-sized full-stack profile (16 x 600): card "
                  f"{card_wall:.1f} s, CPU {cpu_wall:.1f} s; reports "
                  "(every count, text, annotation and tree) and late "
                  "joiners (text, map, tree) card == CPU", flush=True)
    finally:
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)
    return out


class _CountingUuid:
    """``uuid.uuid4`` from a counter, so two runs draw the same ids."""

    def __init__(self):
        self.n = 0

    def uuid4(self):
        self.n += 1
        from types import SimpleNamespace

        return SimpleNamespace(hex=f"{self.n:032x}")


def dds_models(device, seed=0, steps=240, offline=(60, 100)):
    """10c: three ``ContainerRuntime``s over ``LocalFluidService``, each
    with the twelve models of ``models/`` beyond the client merge path
    and a ``SharedString`` on ``device``: a seeded concurrent script
    (consensus writes, acquires, volunteers and pacts resolved through
    sequencing, quorum and MSN; directory subtrees; ID ranges across three
    sessions; ink strokes; OT json and PropertyDDS changesets; text), with
    runtime 1 offline from step ``offline[0]`` to ``offline[1]`` with
    pending ops on every model that buffers them. Returns each replica's
    observable state and summaries after a drain."""
    from fluidframework_tpu_torch.models import consensus_register as CR
    from fluidframework_tpu_torch.models import id_compressor as IC
    from fluidframework_tpu_torch.models import ink as INK
    from fluidframework_tpu_torch.models import ordered_collection as OC
    from fluidframework_tpu_torch.models import ot_json as OT
    from fluidframework_tpu_torch.models import pact_map as PM
    from fluidframework_tpu_torch.models import property_dds as PD
    from fluidframework_tpu_torch.models import shared_cell as CELL
    from fluidframework_tpu_torch.models import shared_counter as CNT
    from fluidframework_tpu_torch.models import shared_directory as DIR
    from fluidframework_tpu_torch.models import summary_block as SB
    from fluidframework_tpu_torch.models import task_manager as TMG
    from fluidframework_tpu_torch.models.shared_string import SharedString
    from fluidframework_tpu_torch.runtime.container import ContainerRuntime
    from fluidframework_tpu_torch.service.local_server import (
        LocalFluidService,
    )

    real_uuid = OC.uuid
    OC.uuid = _CountingUuid()
    try:
        svc = LocalFluidService()

        def channels(i):
            return (CNT.SharedCounter("n"), CELL.SharedCell("c"),
                    CR.ConsensusRegisterCollection("r"),
                    OC.ConsensusOrderedCollection("q"),
                    TMG.TaskManager("t"), PM.PactMap("p"),
                    SB.SharedSummaryBlock("sb"), DIR.SharedDirectory("d"),
                    IC.IdCompressor("ids", cluster_capacity=8,
                                    session_id=f"sess-{i}"),
                    INK.Ink("ink"),
                    OT.SharedOTJson("j", initial={"items": [], "n": 0}),
                    PD.SharedPropertyTree("pt"),
                    SharedString("text", capacity=64, device=device))

        rts = [ContainerRuntime(svc, "doc", channels=channels(i))
               for i in range(3)]
        rng = np.random.default_rng(seed)
        strokes = {i: [] for i in range(3)}
        for step in range(steps):
            if step == offline[0]:
                rts[1].flush()
                rts[1].disconnect()
            if step == offline[1]:
                rts[1].reconnect()
            i = int(rng.integers(0, 3))
            rt = rts[i]
            ch = rt.get_channel
            r = int(rng.integers(0, 16))
            if r == 0:
                ch("n").increment(int(rng.integers(-3, 6)))
            elif r == 1:
                if rng.random() < 0.8:
                    ch("c").set(step)
                else:
                    ch("c").delete()
            elif r == 2:
                ch("r").write(f"k{int(rng.integers(0, 3))}", step)
            elif r == 3:
                q = ch("q")
                held = sorted(q.acquired())
                x = rng.random()
                if held and x < 0.3:
                    (q.complete if x < 0.15 else q.release)(held[0])
                elif x < 0.65:
                    q.acquire()
                else:
                    q.add(f"job{step}")
            elif r == 4:
                task = f"t{int(rng.integers(0, 2))}"
                if rt.connected and ch("t").queued(task):
                    ch("t").abandon(task)
                elif rt.connected:
                    ch("t").volunteer(task)
            elif r == 5:
                ch("p").set(f"k{int(rng.integers(0, 3))}", step)
            elif r == 6:
                ch("sb").set(f"k{i}", step)
            elif r == 7:
                d = ch("d")
                sub = f"s{int(rng.integers(0, 3))}"
                x = rng.random()
                if x < 0.3:
                    d.set(f"k{int(rng.integers(0, 4))}", step)
                elif x < 0.6:
                    d.create_subdirectory(sub).set("v", step)
                elif x < 0.85 and d.get_subdirectory(sub) is not None:
                    d.get_subdirectory(sub).create_subdirectory(
                        "deep").set("w", step)
                else:
                    d.root.delete_subdirectory(sub)
            elif r == 8:
                ids = ch("ids")
                ids.generate_ids(int(rng.integers(1, 6)))
                if rng.random() < 0.6:
                    ids.take_id_range()
            elif r == 9:
                ink = ch("ink")
                if not strokes[i] or rng.random() < 0.3:
                    strokes[i].append(ink.create_stroke(
                        {"w": int(rng.integers(1, 4))}).id)
                else:
                    ink.append_points(strokes[i][-1], [
                        [float(step), float(x), 0.5, 1.0]
                        for x in range(int(rng.integers(1, 4)))])
            elif r == 10:
                j = ch("j")
                items = j.get("items")
                x = rng.random()
                if x < 0.45 or not items:
                    j.list_insert(["items"],
                                  int(rng.integers(0, len(items) + 1)),
                                  f"s{step}")
                elif x < 0.7:
                    j.list_delete(["items"], int(rng.integers(0, len(items))))
                elif x < 0.85:
                    j.number_add(["n"], int(rng.integers(1, 5)))
                else:
                    j.set_key([f"k{int(rng.integers(0, 3))}"], step)
            elif r == 11:
                pt = ch("pt")
                arr = pt.get("arr")
                x = rng.random()
                if arr is None:
                    pt.insert_array_property("arr", [step])
                elif x < 0.4:
                    pt.array_insert("arr", int(rng.integers(0, len(arr) + 1)),
                                    [step])
                elif x < 0.6 and arr:
                    pt.array_remove("arr", int(rng.integers(0, len(arr))))
                elif pt.get(f"p{i}.v") is None:
                    pt.insert_property(f"p{i}.v", "Int32", step)
                else:
                    pt.set_value(f"p{i}.v", step)
                pt.commit()
            elif r == 12 and rt.connected:
                rt.propose("code", f"v{step}")
            elif r in (13, 14):
                s = ch("text")
                n = len(s.get_text())
                if n > 6 and rng.random() < 0.3:
                    a = int(rng.integers(0, n - 2))
                    s.remove_range(a, a + 2)
                else:
                    s.insert_text(int(rng.integers(0, n + 1)), "".join(
                        chr(97 + int(c)) for c in rng.integers(0, 26, 3)))
            elif rt.connected:
                rt.send_noop()
            if rng.random() < 0.4 and rt.connected:
                rt.flush()
            k = int(rng.integers(0, 3))
            if rng.random() < 0.4 and rts[k].connected:
                rts[k].process_incoming(int(rng.integers(1, 6)))
        for rt in rts:
            if not rt.connected:
                rt.reconnect()
        for _ in range(3):  # noops move the MSN past every proposal and pact
            for rt in rts:
                rt.flush()
                rt.send_noop()
            while any(rt.process_incoming() for rt in rts):
                pass
        snap = []
        for rt in rts:
            ch = rt.get_channel
            snap.append(dict(
                counter=ch("n").value, cell=(ch("c").empty, ch("c").get()),
                registers={k: (ch("r").read(k), ch("r").read_versions(k))
                           for k in sorted(ch("r").keys())},
                queue=ch("q").summarize_core(),
                tasks={t: ch("t").assigned_to(t) for t in ("t0", "t1")},
                pacts=ch("p").summarize_core(),
                directory=ch("d").summarize_core(),
                ids=ch("ids").summarize_core(),
                ink=[(st.id, st.pen, st.points.tolist())
                     for st in ch("ink").strokes()],
                ot=ch("j").as_data(),
                props=ch("pt").summarize_core(),
                text=ch("text").get_text(),
                proposals=dict(rt.approved_proposals),
                local=dict(block=ch("sb").summarize_core(),
                           acquired=ch("q").acquired(),
                           summaries=[json.dumps(ch(c).summarize_core(),
                                                 sort_keys=True, default=repr)
                                      for c in ("n", "c", "r", "q", "t", "p",
                                                "sb", "d", "ids", "ink", "j",
                                                "pt", "text")]),
            ))
        return snap
    finally:
        OC.uuid = real_uuid


def load_10c(device) -> dict:
    """10c: the other DDS models on the card: every replica converges
    (everything but each replica's own summary block and held queue
    items, which by design stay with their writer, and the directory, as
    the reference's), and each replica's state and summaries equal the
    same script on the CPU."""
    t = time.perf_counter()
    reset_counts()
    card = dds_models(device)
    torch.cuda.synchronize()
    launches = read_counts()
    card_s = time.perf_counter() - t
    cpu = dds_models(torch.device("cpu"))
    # Directory replicas are held card to CPU only: the reference's own
    # replicas differ after a delete of a path races a remote create of
    # it (ROADMAP, section 3), and this script makes that race.
    for key in card[0]:
        if key not in ("local", "directory") and any(
                r[key] != card[0][key] for r in card):
            raise AssertionError(f"10c: replicas did not converge on {key}")
    dir_agree = all(r["directory"] == card[0]["directory"] for r in card)
    for i, (a, b) in enumerate(zip(card, cpu)):
        if a != b:
            diff = [k for k in a if a[k] != b[k]]
            raise AssertionError(f"10c: rt {i} card != CPU on {diff}")
    r = card[0]
    out = dict(wall_s=card_s, launches=launches, counter=r["counter"],
               text_len=len(r["text"]), strokes=len(r["ink"]),
               id_clusters=len(r["ids"]["clusters"]),
               proposals=r["proposals"],
               committed_pacts=len(r["pacts"]["committed"]),
               directory_replicas_agree=dir_agree)
    print(f"10c DDS models: 3 runtimes x 12 models + SharedString converged "
          f"on the card in {card_s:.2f} s (counter {r['counter']}, text "
          f"{out['text_len']} chars, {out['strokes']} strokes, "
          f"{out['id_clusters']} id clusters, {out['committed_pacts']} "
          f"pacts, proposals {r['proposals']}); K1 "
          f"{launches['K1_merge_apply']['all']}, K2 "
          f"{launches['K2_zamboni_compact']['all']}; directory replicas "
          f"agree: {dir_agree}; every replica == the CPU run", flush=True)
    return out


def phase_load(device, report, stress=None):
    """Phase 10: 10a oracle parity at the two shapes, 10b the load
    harness (``stress``: the profile of its main run), 10c the other DDS
    models. Launch counts are reset before each and read after it;
    returns the path's launches and the holds of 10a."""
    wall = {}
    t = time.perf_counter()
    r10a, holds = {}, []
    for j, (cap, d) in enumerate(ORACLE_SHAPES):
        rec, h = load_10a(device, cap, d, seed0=1000 + 10_000 * j)
        r10a[f"S{cap}"] = rec
        holds += h
    wall["10a"] = time.perf_counter() - t
    t = time.perf_counter()
    r10b = load_10b(device, stress)
    wall["10b"] = time.perf_counter() - t
    t = time.perf_counter()
    r10c = load_10c(device)
    wall["10c"] = time.perf_counter() - t
    launches = _sum_counts(*[r["launches"] for r in r10a.values()],
                           r10b["launches"], r10c["launches"])
    for name in ("K1_merge_apply", "K2_zamboni_compact"):
        if launches[name]["all"] <= 0:
            raise AssertionError(f"{name} never launched on the load path")
    print(f"10 wall s: { {k: round(v, 1) for k, v in wall.items()} }; "
          f"launches {launches}", flush=True)
    report["phase_load"] = dict(oracle=r10a, load=r10b, dds=r10c,
                                holds=holds, wall_s=wall)
    return dict(launches=launches, holds=holds)


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
    with ThreadPoolExecutor(5) as pool:
        builds = [pool.submit(fn) for fn in BUILDS]
        for b in builds:
            b.result()
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

    # Phase 4: the device-apply serving stage at config 7's shape.
    launches4 = timed("4_serving", phase_serving, device, report)["launches"]
    # Phase 5: config 7 through the ordering pipeline.
    launches5 = timed("5_pipeline", phase_pipeline, device,
                      report)["launches"]
    # Phase 6: config 7 through the socket front door over a store node.
    launches6 = timed("6_server", phase_server, device, report)["launches"]
    # Phase 7: the SharedTree rebase path (no hand kernel of its own).
    torch.cuda.empty_cache()
    timed("7_tree", phase_tree, device, report)
    # Phase 8: the client merge path.
    torch.cuda.empty_cache()
    client = timed("8_client", phase_client, device, report)
    # Phase 9: scale-out (the mesh fleet, the serving pump on the mesh,
    # sharded overflow, multi-node ordering).
    torch.cuda.empty_cache()
    scale = timed("9_mesh", phase_mesh, device, report)
    # Phase 10: the oracle on the card, the load harness over the
    # pipeline, the other DDS models.
    torch.cuda.empty_cache()
    from fluidframework_tpu_torch.testing.load import (
        CHAOS_STRESS_FULL_PROFILE,
    )

    load = timed("10_load", phase_load, device, report, dataclasses.replace(
        CHAOS_STRESS_FULL_PROFILE, total_ops=SMOKE_LOAD_OPS))
    report["wall_s"] = wall

    kernels = []
    for name, spec in KERNELS.items():
        err, ms, plain_ms, b = main_shape[name]
        by_path = {"fleet_service": launches2[name],
                   "docfleet": launches3[name], "serving": launches4[name],
                   "pipeline": launches5[name], "server": launches6[name],
                   "client": client["launches"][name],
                   "mesh": scale["mesh"][name],
                   "sharded": scale["sharded"][name],
                   "load": load["launches"][name]}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "fluidframework_tpu_torch/csrc/merge_kernels.cu",
            "replaces": spec["replaces"],
            "launches": sum(p["all"] for p in by_path.values()),
            "launches_smem": sum(p["smem"] for p in by_path.values()),
            "launches_cluster": sum(p["cluster"] for p in by_path.values()),
            "launches_global": sum(p["global"] for p in by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max([err] + [r["max_abs_err"]
                                        for r in glob + scale["holds"]
                                        + load["holds"]
                                        if r["kernel"] == name]),
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None,
            "by_tier": [{key: r[key] for key in
                         ("tier", "docs", "cap", "k", "ms", "plain_ms",
                          "bound_ms")}
                        for r in glob if r["kernel"] == name],
            "client_shapes": [{key: r[key] for key in
                               ("cell", "tier", "docs", "cap", "k", "ms",
                                "plain_ms", "bound_ms")}
                              for r in client["holds"]
                              if r["kernel"] == name],
            "mesh_shapes": [{key: r[key] for key in
                             ("cell", "docs", "cap", "k", "ms", "plain_ms",
                              "bound_ms")}
                            for r in scale["holds"] if r["kernel"] == name],
            "load_shapes": [{key: r[key] for key in
                             ("cell", "tier", "docs", "cap", "k", "ms",
                              "plain_ms", "bound_ms")}
                            for r in load["holds"] if r["kernel"] == name],
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


def tree_alone(**kw) -> int:
    """Phase 7 alone (the tree path builds nothing); its record goes to
    ``tree.json`` in the output directory."""
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    report = {"card": smi, "torch": torch.__version__}
    t = time.perf_counter()
    phase_tree(device, report, **kw)
    print(f"phase 7_tree: {time.perf_counter() - t:.1f} s", flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "tree.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(smi)
    return 0


def client_alone() -> int:
    """Phase 8 alone, after the builds (the kernels, and the native
    libraries 8e's server uses); its record goes to ``client.json`` in the
    output directory."""
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    with ThreadPoolExecutor(5) as pool:
        for b in [pool.submit(fn) for fn in BUILDS]:
            b.result()
    report = {"card": smi, "torch": torch.__version__}
    t = time.perf_counter()
    phase_client(device, report)
    print(f"phase 8_client: {time.perf_counter() - t:.1f} s", flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "client.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(smi)
    return 0


def mesh_alone() -> int:
    """Phase 9 alone, after the builds; its record goes to ``mesh.json``
    in the output directory."""
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    with ThreadPoolExecutor(5) as pool:
        for b in [pool.submit(fn) for fn in BUILDS]:
            b.result()
    report = {"card": smi, "torch": torch.__version__}
    t = time.perf_counter()
    out = phase_mesh(device, report)
    print(f"phase 9_mesh: {time.perf_counter() - t:.1f} s", flush=True)
    print(f"mesh launches {out['mesh']}; sharded launches "
          f"{out['sharded']}", flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "mesh.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(smi)
    return 0


def load_alone(which: str = "") -> int:
    """Phase 10 alone after the builds, or with ``which="reference"`` only
    10b's run of ``CHAOS_REFERENCE_PROFILE`` (120 clients x 10,000 ops,
    the upstream ci profile); its record goes to ``load.json`` (or
    ``load_reference.json``) in the output directory."""
    from fluidframework_tpu_torch.testing.load import CHAOS_REFERENCE_PROFILE

    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    with ThreadPoolExecutor(5) as pool:
        for b in [pool.submit(fn) for fn in BUILDS]:
            b.result()
    report = {"card": smi, "torch": torch.__version__}
    t = time.perf_counter()
    if which == "reference":
        report["reference"] = load_10b(device, CHAOS_REFERENCE_PROFILE,
                                       compare=False)
        name = "load_reference.json"
    else:
        out = phase_load(device, report)
        print(f"load launches {out['launches']}", flush=True)
        name = "load.json"
    print(f"phase 10_load: {time.perf_counter() - t:.1f} s", flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, name), "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(smi)
    return 0


def server_repeat(n: int) -> int:
    """Phase 6 alone, ``n`` times in one process after the builds: each
    run's client numbers, overload envelope and launches are printed and
    written to ``server_repeat.json`` in the output directory; the first
    failure ends the run with its error."""
    device = torch.device("cuda", 0)
    with ThreadPoolExecutor(5) as pool:
        for b in [pool.submit(fn) for fn in BUILDS]:
            b.result()
    runs = []
    try:
        for i in range(n):
            t = time.perf_counter()
            out = phase_server(device, {})
            runs.append(dict(wall_s=time.perf_counter() - t, **{
                key: out[key] for key in (
                    "client", "envelope", "stalls_seen", "pump_ticks",
                    "frames_received", "launches", "device_idle_share")}))
            print(f"server run {i}: {runs[-1]['wall_s']:.1f} s", flush=True)
    finally:
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "server_repeat.json"), "w") as f:
            json.dump(runs, f, indent=1)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--server":
        if not torch.cuda.is_available():
            sys.exit("chip_smoke: no CUDA device; nothing was run")
        sys.exit(server_repeat(int(sys.argv[2])))
    if len(sys.argv) > 1 and sys.argv[1] == "--tree":
        if not torch.cuda.is_available():
            sys.exit("chip_smoke: no CUDA device; nothing was run")
        sys.exit(tree_alone(**{k: float(v) if "." in v else int(v)
                               for k, v in (a.split("=", 1)
                                            for a in sys.argv[2:])}))
    if len(sys.argv) > 1 and sys.argv[1] == "--client":
        if not torch.cuda.is_available():
            sys.exit("chip_smoke: no CUDA device; nothing was run")
        sys.exit(client_alone())
    if len(sys.argv) > 1 and sys.argv[1] == "--mesh":
        if not torch.cuda.is_available():
            sys.exit("chip_smoke: no CUDA device; nothing was run")
        sys.exit(mesh_alone())
    if len(sys.argv) > 1 and sys.argv[1] == "--load":
        if not torch.cuda.is_available():
            sys.exit("chip_smoke: no CUDA device; nothing was run")
        sys.exit(load_alone(*sys.argv[2:3]))
    if len(sys.argv) > 1 and sys.argv[1] == "--socket-client":
        sys.exit(socket_client(sys.argv[2:]))
    if len(sys.argv) > 2 and sys.argv[1] == "--ab":
        if not torch.cuda.is_available():
            sys.exit("chip_smoke: no CUDA device; nothing was run")
        sys.exit(ab(sys.argv[2], sys.argv[3:]))
    sys.exit(main())
