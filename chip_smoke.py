"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --ab PARENT_DIR [NAME=VALUE,... ...]
    python3 chip_smoke.py --split [--parent DIR] [NAME=VALUE,... ...]
    python3 chip_smoke.py --narrow [--parent DIR] [NAME=VALUE,... ...]
    python3 chip_smoke.py --tree [NAME=VALUE ...]
    python3 chip_smoke.py --client
    python3 chip_smoke.py --mesh
    python3 chip_smoke.py --load [reference]
    python3 chip_smoke.py --framework

Builds the hand-written kernels (one ``nvcc`` for each of
``csrc/merge_kernels.cu`` and ``csrc/tree_kernels.cu``, into the
package's ``_build/``) and the native ticket loop, blob store, partition
log and lease coordination (``g++``), all at once, then:

1. kernels — holds K1 (merge apply), K2 (compact) and K3 (apply+compact)
   bit-exactly against their plain PyTorch versions on the card, at
   D=4096 docs x K=16 ops and S in {128, 512, 2048} rows, on random states
   and op streams that include capacity overflow, out-of-range positions,
   unknown writers, and local ops with acks; times each (median of
   CUDA-event timings) beside its byte-floor bound; K1 and K3 at 128 and
   512 rows on the warp tier and the shared tier both (the one not routed
   forced), on random states and on the edge cases below;
1b. the tiers above — the same at S = 4,096 and 8,192 (D=256), 16,384
   (D=64), 65,536 (D=16), 131,072 (D=2) and 524,288 (D=1) rows: all
   three kernels split tables of up to 16,384 rows across a thread-block
   cluster, keep larger ones in global memory, and past 65,536 rows (K1
   and K3 also past 16,384 in launches of fewer documents than the card
   has SMs) split each document over a
   cluster of up to 16 CTAs there (the split tier);
   the shared tier at S = 2,048 (D=256) beside it. At every shape of 1
   and 1b all three are also held, untimed, on :func:`edge_case` (moves
   on the tile and slice edges) and K2 and K3 on
   :func:`compact_edge_case` (merge runs across tile and slice edges, all
   rows reclaimed, none reclaimed), on the split tier in launches of up
   to 8 documents cut at its slices (:func:`edge_batches`);
1c. repeated launches — every kernel entry (K1-K3, X1, X2,
   ``shard_exchange``, T1, T2, A1-A4, rebase in both tie forms) on every
   tier it has, at the shape its path launches it (:data:`REPEAT_MERGE`,
   :func:`repeat_cases`; T1 and T2 cut in depth), launched at least
   :data:`REPEAT_LAUNCHES` times round robin, each into fresh outputs
   filled with the sentinel, the allocator's free blocks poisoned before
   each, each held bit for bit against one plain run
   (``tools/kernel_sanitize.py``'s runners; 9c's K1 and K2 at its rows
   below count, one live op beside NOOPs, on the tiers they are routed
   to); one line each with its launches and mismatches, any mismatch
   fails;
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
7. SharedTree rebase path — the hand kernels T1 (the positional trunk
   scan) and T2 (the EditManager ring scan) of ``csrc/tree_kernels.cu``,
   one launch a scan: 7h holds each against its plain version on the
   card at edge shapes (T1 at W 3/8/16, Lc 32/128/512/1,024, Pc 8/32,
   moves or none, the ring-window err, N 1/7/1,024; T2 at every Lc bucket
   from 32 to 4,096 with R 16, ring misses with and without a move
   watermark and a capacity overflow, at 7 documents and at one), at
   7a's and 7b's shapes and across the document counts where the warp
   tier meets the CTA tiers, each shape on every tier that takes it (the
   warp tier with its ring in the slice and in the workspace, the shared
   and global tiers) and timed there on the same inputs, under
   ``torch.cuda.set_sync_debug_mode("error")``, and A1-A4 (the dense
   changeset algebra's kernels) held against their plain versions on
   every tier (the warp, shared and global tiers) at 3b's and 3c's widths
   on commits and raw lanes (rebase in both tie forms; compose's ties and
   overflowing pools) and at Lc 8,192, then each timed on every tier at 1
   to 1,024 documents of both widths, the source of the warp tier's
   document-count rule; 7a config 3b,
   ``batched_trunk_scan`` over 1,024 docs (Lc 128, Pc 32, W 16) staged
   on the card once, a warm-up and 3 timed scans, every distinct script
   held to the host trunk, the whole batch to T1's plain version on the
   card; 7b configs 3c and 3c-moves through ``batch_ingest`` over
   ``EditManager(device=cuda)``s, every distinct script held to the host
   EditManager, the first dispatch to T2's plain version on the card; 7c
   config 3 through ``ContainerRuntime`` + ``SharedTree(device=cuda)``,
   replicas converged (its commits take the host path); 7a also calls the
   algebra's four entry points on its commits, one launch of A1-A4 each.
   The scans run
   under sync-debug "error" and are held bit for bit to the same function
   on the CPU for 16 documents, and 7a's and 7b's scans again on every
   tier (held and timed, outside the counts); each sub-path's T1/T2
   launches are counted, and a scan's launches and device time come from
   the kernels' counts and ``torch.profiler``;
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
   8f a full 65,536-row document ``grow``n to 131,072 rows on the card and
   256 fuzz ops through ``merge_kernel`` on the split tier, equal to the
   CPU; then K1/K2/K3 held against their plain versions at one document
   on every tier (up to 524,288 rows) and at 8b's and 8c's shapes;
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
   apply and one compaction under sync-debug "error", one op's launches
   by name (``shard_exchange``, X1 and X2 in one launch, and K1 on one
   device group) and its ATen ops, and on
   the list of
   every visible card (one card: 524,288 rows a shard, the split tier) a
   document of 65,000 rows promoted at the first scan and carried past
   65,536 live rows by mixed frames, equal to a ``kernel="plain"`` twin
   at every frame (:func:`mesh_9c_one_entry`); 9d
   tests/test_multinode.py's failover and fencing at 3
   nodes x 1,024 documents over ``NativeCoordination``. K1/K2 held
   against their plain versions at the mesh shard's and the sharded
   document's shapes, and X1, X2 and ``shard_exchange`` (the sharded
   document's per-op exchange) at 9c's 8 x 65,536 rows and the one card's
   1 x 524,288, into outputs filled with a sentinel
   (:func:`hold_exchange`);
10. the oracle, the load harness and the other DDS models — 10a
   bench.py's ``device_state_parity`` at 4,096 docs x 256 rows and 256
   docs x 4,096 rows (the shared and the cluster tier), 96 ops a document
   from the port's ``random_acked_stream`` (msn lag 24, refs caught up):
   K1 half, K2, K1 half, K2 on the card, every document's text equal to
   its ``OracleDoc``'s, err lanes clear, lanes equal to the plain
   versions'; 10b ``CHAOS_STRESS_FULL_PROFILE`` (48 clients, trees, the
   elected summarizer, GC, client offline windows and service chaos; all
   3,000 ops, its replicas' tree ingest on T2)
   through the port's ``LoadRunner`` over
   ``PipelineFluidService(n_partitions=4)``, the device stage and every
   replica's string and tree on the card: converged, the counts of the
   profile, a late joiner's text; the card's busy share sampled from
   ``nvidia-smi``; then the CI-sized full-stack profile (16 x 600) on the
   card and on the CPU (a spawned process), reports and late joiners
   equal; 10c three runtimes with the twelve models of ``models/``
   beyond the merge path and a ``SharedString`` on the card, a seeded
   script with an offline window, converged and equal to the CPU run;
11. the framework layer, the hierarchy trees and the drivers — 11a
   three ``TpuFluidClient(device=cuda)`` containers of one schema (a
   ``SharedString``, a ``SharedMap``, a ``HierarchicalTree``, a
   ``LegacySharedTree``, an ``AgentScheduler``; a dynamic
   ``SharedString``) and a ``DataObject`` through
   ``ContainerRuntimeFactoryWithDefaultDataStore`` author config 1's
   10,000 string ops (not cut) and 313 other edits, with
   ``mixin_attributor``, ``OldestClientObserver`` and interception
   wrappers over the stream; K1 and K2 must launch; 11b a 16,384-point
   field chunked by ``chunk_field`` and its columns ``to_device``d, dtype
   and bytes equal to the CPU's, the integer sum exact; 11c
   ``save_document`` / ``load_document`` and a read-mode replay equal to
   a live loader lane for lane, ``encode_snapshot`` round-tripped, a
   paused ``DebuggerFluidService`` stepped to 3 checkpoints, a
   ``CachingFluidService`` cold load and a warm one that fetches only the
   ops past its cached head; 11d ``perspective``, ``insert_place_mask``,
   ``trunk_scan``, ``em_trunk_scan_one``, ``em_trunk_scan_ring_one`` and
   ``sharded_apply_ops`` on the card against the CPU, at the shapes
   their paths give them (7a's batch, a recorded config-3c dispatch, 9c's
   8 x 65,536-row shards). 11a and 11c equal
   the same script on the CPU, run in a spawned process that the smoke
   starts after phase 6 (:func:`start_framework_twin`); K1/K2 are held
   against their plain versions at 11a's end state.

Launch counts (in all, and by tier: smem / cluster / global / split) are reset
before each main path (2, then 3a+3b, then 4, then 5, then 6's client
run, then each of 8a-8e, then each run of 9a-9c, then each of 10a-10c,
then 11a)
and read after it; T1's and T2's counts (in all, shared, global) the
same way around 7a, 7b, 7b-moves, 7c, 10b and 11d's tree scans, and 7a
must launch T1, 7b T2; the exchange kernels' around 9c and the one
card's run after promotion and 11d's sharded functions, each of which
must launch ``shard_exchange`` and neither X1 nor X2 (one device group:
those two launch only on several groups, so here only in the holds). The
DocFleet path must launch K1 and K2 on the cluster tier. Prints the ptxas report of every kernel entry, each phase's
wall time, the card's name and power limit, a ``{"kernels": [...]}`` line
(K1, K2, K3, T1, T2, A1, A2, A3, A4, X1, X2, ``shard_exchange``: every
kernel entry), and last ``{"ok":
true, "device": {...}}``. Any failure exits non-zero. A longer record goes to
``chip_smoke.json`` in the output directory (``OUT_DIR``).

With ``--ab PARENT_DIR``, it times instead phases 1 and 1b (and the
kernels at the DocFleet cells' other widths), the kernels at phase 2's
main shape and phases 3a and 3b's per-tier medians, for the tree unpacked
at PARENT_DIR and for this one, in turns on one card (parent, change,
change, parent; see :func:`ab`), and writes ``ab.json``.

With ``--narrow [--parent DIR]``, it holds and times instead K1 and K3
on the warp tier and the shared tier at the paths' narrow launches
(:data:`NARROW_PATHS`) for this tree, each variant of its kernel
constants and the merge kernel source of the tree unpacked at DIR (the
shared tier alone), in turns, then the width x document-count sweep
behind ``_cuda.WARP_MIN_DOCS`` for this tree alone (see
:func:`narrow_ab`), and writes ``narrow.json``.

With ``--split [--parent DIR]``, it times instead K1/K2/K3 on the split
tier at 524,288 x 1 and 131,072 x 2, K1/K3 on the global and the split
tier at 32,768 x 16 and 65,536 x 8, and K1 and K2 at 9c's rows below
count, each held bit for bit, for this tree, for each variant with its
kernel constants changed and for the merge kernel source of the tree
unpacked at DIR, in turns, then the document-count sweep behind
``_cuda.tier``'s rule (see :func:`split_ab`), and writes
``split.json``. With ``--exchange [NAME=VALUE,...]``, it holds and times
X1, X2 and ``shard_exchange`` at the sharded paths' shapes the same way,
for this tree and each variant (see :func:`exchange_ab`), and writes
``exchange.json``.

With ``--server N``, it builds the kernels and native libraries and runs
only phase 6, ``N`` times in one process (the socket path's repeat check;
see :func:`server_repeat`), and writes ``server_repeat.json``.

With ``--tree``, it builds the tree kernels and runs only phase 7, the
holds of T1, T2 and A1-A4 first (``phase_tree``'s keyword arguments as
``NAME=VALUE``, e.g. ``b_commits=1000`` or ``holds=0``), and writes
``tree.json``.

With ``--client``, it builds the kernels and native libraries and runs
only phase 8, and writes ``client.json``.

With ``--mesh``, it builds the kernels and native libraries and runs only
phase 9, and writes ``mesh.json``.

With ``--framework``, it builds the kernels and native libraries and runs
only phase 11 (its CPU twin starting with it), and writes
``framework.json``.

With ``--load``, it builds the kernels and native libraries and runs only
phase 10, and writes ``load.json``; ``--load reference`` runs instead
10b's harness on ``CHAOS_REFERENCE_PROFILE`` (120 clients x 10,000 ops,
the upstream ci profile) and writes ``load_reference.json``.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
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
from fluidframework_tpu_torch.ops import shard_exchange_kernel as SX
from fluidframework_tpu_torch.protocol.constants import (
    ERR_CAPACITY,
    ERR_CLIENT,
    ERR_RANGE,
    F_ARG,
    F_LEN,
    F_MSN,
    F_POS1,
    F_POS2,
    F_REF,
    F_SEQ,
    F_TYPE,
    KIND_TEXT,
    NO_CLIENT,
    OP_INSERT,
    OP_NOOP,
    OP_REMOVE,
    OP_WIDTH,
    RSEQ_NONE,
    UNASSIGNED_SEQ,
)
from fluidframework_tpu_torch.ops import tree_algebra_kernel as TAK
from fluidframework_tpu_torch.ops import tree_kernel as TK
from fluidframework_tpu_torch.ops import tree_scan_kernel as TSK
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
from tools import kernel_sanitize as KS
from tools.kernel_sanitize import (
    algebra_case,
    compose_ties,
    em_case,
    exchange_case,
    random_case,
    trunk_case,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published HBM3 rate
# (rows S, docs D) of phase 1 (the shared tier) and 1b (every tier above it
# at the widths DocFleet's deep tiers reach, the shared tier beside them).
PHASE1_SHAPES = ((128, 4096), (512, 4096), (2048, 4096))
PHASE1B_SHAPES = ((2048, 256), (4096, 256), (8192, 256), (16384, 64),
                  (65536, 16), (131_072, 2), (524_288, 1))
# Documents an edge-case launch holds past the global tier: up to 8 docs
# a launch get C = 16 CTAs a document on a 132-SM card, the split tier's
# slices at their widest count.
SPLIT_EDGE_DOCS = 8
# The other widths the DocFleet cells compact at (config 6's pools of
# 16,384 slots, the deep cell's of 256), timed by --ab alone: the cells'
# per-tier medians mix calls on full and (in the parent) empty pools.
AB_WIDTH_SHAPES = ((256, 16384), (512, 16384), (1024, 16384), (256, 256),
                   (512, 256), (1024, 256))
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chiprun_out")

# Every library the smoke builds, all started together: the merge and tree
# kernels (one nvcc each) and the native ticket loop, blob store, partition
# log and lease coordination (g++).
BUILDS = (_cuda.build, functools.partial(_cuda.build, "tree"),
          _load_ticket, native_store_available, native_plog_available,
          native_coordination_available)

# The keys of a launch count: in all, then each tier.
COUNT_KEYS = ("all",) + tuple(_cuda.TIER_CODES)

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
# The SharedTree rebase scans' hand kernels (csrc/tree_kernels.cu), each
# the counterpart of a jitted XLA scan of the reference (no pl.pallas_call).
TREE_KERNELS = {
    "T1_trunk_scan": dict(
        wrapper=TSK.trunk_scan_cuda, on=TSK.trunk_scan_on, entry=TSK.T1,
        plain=DT.batched_trunk_scan_plain,
        replaces="fluidframework_tpu/tree/device_trunk.py:161",
    ),
    "T2_em_ring_scan": dict(
        wrapper=TSK.em_ring_scan_cuda, on=TSK.em_ring_scan_on, entry=TSK.T2,
        plain=DEM.batched_em_trunk_scan_ring_plain,
        replaces="fluidframework_tpu/tree/device_em.py:129",
    ),
}
# The dense changeset algebra's hand kernels (csrc/tree_kernels.cu), each
# the counterpart of one jitted entry point of the reference (no
# pl.pallas_call): ``fn`` the batched entry point a user calls, ``wrapper``
# the kernel's own, ``plain`` its plain version.
ALGEBRA_KERNELS = {
    "A1_tree_apply": dict(
        wrapper=TAK.apply_cuda, plain=TK.apply_change, fn=TK.batched_apply,
        entry=TAK.A1, replaces="fluidframework_tpu/ops/tree_kernel.py:587",
    ),
    "A2_tree_rebase": dict(
        wrapper=TAK.rebase_cuda, plain=TK.rebase_change,
        fn=TK.batched_rebase, entry=TAK.A2,
        replaces="fluidframework_tpu/ops/tree_kernel.py:588",
    ),
    "A3_tree_invert": dict(
        wrapper=TAK.invert_cuda, plain=TK.invert_change,
        fn=TK.batched_invert, entry=TAK.A3,
        replaces="fluidframework_tpu/ops/tree_kernel.py:591",
    ),
    "A4_tree_compose": dict(
        wrapper=TAK.compose_cuda, plain=TK.compose_change,
        fn=TK.batched_compose, entry=TAK.A4,
        replaces="fluidframework_tpu/ops/tree_kernel.py:592",
    ),
}
# The sharded document's per-op exchange (csrc/merge_kernels.cu, beside
# K1): the exchange half of the reference's jitted shard_map body (two
# all_gathers, no pl.pallas_call). One device group (every layout of one
# card) runs X1 and X2 as one launch, shard_exchange; several groups run
# them apart.
SHARD_KERNELS = {
    "X1_shard_stats": dict(
        wrapper=SX.shard_stats, kernel="shard_stats_kernel",
        replaces="fluidframework_tpu/parallel/sharded_doc.py:71",
    ),
    "X2_shard_resolve": dict(
        wrapper=SX.shard_resolve, kernel="shard_resolve_kernel",
        replaces="fluidframework_tpu/parallel/sharded_doc.py:71",
    ),
    "X12_shard_exchange": dict(
        wrapper=SX.shard_exchange, kernel="shard_exchange_kernel",
        replaces="fluidframework_tpu/parallel/sharded_doc.py:71",
    ),
}
# The exchange kernel of one device group, the path every layout of one
# card runs; the others launch only on several groups.
ONE_GROUP_EXCHANGE = "X12_shard_exchange"
# Every (tier, ring) a tree kernel may run on: the warp tier with its ring
# in the document's shared-memory slice or in the workspace, the CTA tiers.
TREE_TIER_OPTIONS = tuple(("warp", r) for r in TSK.RINGS) + tuple(
    (t, None) for t in TSK.TIER_CODES if t != "warp")


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


def _slice_rows(cap: int, sl) -> int:
    """``sl``, or the cluster tier's slice for ``cap`` rows (at most 1,024
    rows, rounded up to 32)."""
    if sl is not None:
        return sl
    n_slices = -(-cap // 1024)
    return (-(-cap // n_slices) + 31) // 32 * 32


def _edge_firsts(cap: int, sl: int) -> list:
    """edge_case's first op of each document (see there)."""
    count = cap - 10
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
    return firsts


def edge_case(cap: int, device, k: int = 4, sl=None, picks=None):
    """A packed state and op batch whose moves land exactly on the edges
    the kernels cut a table at: each doc holds ``cap - 10`` live 4-char
    rows (row r starts at visible position 4r), and its first op splits
    row e (an insert at 4e+2), places a row at e (an insert at 4e), splits
    row e twice (a remove of 4e+1..4e+3), splits rows e and e+1 (a remove
    or annotate of 4e+1..4e+5), or inserts at the very end (the new row at
    ``count``), for e at row 0, the 32-row tile edges, the edges of the
    first slices (``sl`` rows each: by default the cluster tier's, as
    merge_kernels.cu cuts a table into slices of at most 1,024 rows; the
    split tier's from :func:`_cuda.split_slice_rows`), the middle and the
    last rows. The next ``k - 1`` ops hit the rows next to e. ``picks``
    (a slice or index list) keeps those documents only."""
    count = cap - 10
    firsts = _edge_firsts(cap, _slice_rows(cap, sl))
    if picks is not None:
        firsts = list(np.asarray(firsts)[picks])
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
    # Every document holds the same table.
    live = np.arange(cap) < count
    lanes = {n: np.zeros(cap, np.int32) for n in SEGMENT_LANES}
    lanes["kind"][:] = 1
    lanes["orig"][:] = 1 + np.arange(cap) % 7
    lanes["length"][:] = 4
    lanes["seq"][:] = 1 + np.arange(cap) % 50
    lanes["rseq"][:] = RSEQ_NONE
    fills = {"kind": 0, "rseq": RSEQ_NONE}
    one = np.stack([np.where(live, lanes[n], fills.get(n, 0))
                    for n in SEGMENT_LANES]).astype(np.int32)
    tables = np.broadcast_to(one[:, None], (K1.N_LANES, d, cap)).copy()
    scalars = np.zeros((d, K1.N_SCALARS), np.int32)
    scalars[:, K1.SC_COUNT] = count
    scalars[:, K1.SC_CUR_SEQ] = 100
    scalars[:, K1.SC_SELF] = NO_CLIENT
    as_t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return as_t(tables), as_t(scalars), as_t(ops)


def compact_edge_case(cap: int, device, sl=None, picks=None):
    """A packed state whose compaction meets every seam the kernels cut a
    table at (32-row tiles, slices of ``sl`` rows, by default the cluster
    tier's): each doc holds ``cap - 3`` live rows, min_seq 10, and one of
    nine patterns. Rows are splits of one insert (contiguous offsets)
    unless a pattern breaks the run; reclaimed rows are acked removals at
    seq 6. Patterns: none reclaimed (one merge run over the whole table);
    all reclaimed; runs that break one row before each tile edge; every
    other row reclaimed (no merges); zero-length reclaimed rows at the tile
    and slice edges (the run merges across them); the first slice
    reclaimed; only the edge rows kept, the rest zero-length and reclaimed
    (a warp's first kept row merges into a row many warps or CTAs back);
    the same with reclaimed rows of length 1 (nothing merges); pending
    stamps, local removes and UNASSIGNED seqs on rows that would otherwise
    go. ``picks`` (a slice or index list of patterns) keeps those
    documents only. Returns (tables, scalars, ops), ops all no-ops (K=1),
    for K3."""
    count = cap - 3
    sl = _slice_rows(cap, sl)
    r = np.arange(cap)
    edge = np.zeros(cap, bool)
    edge[[e for e in (0, 1, 31, 32, 33, 63, 64, sl - 1, sl, sl + 1,
                      2 * sl - 1, 2 * sl, count - 1) if 0 <= e < count]] = True
    tile_edge = (r % 32 == 0) | (r % 32 == 31) | (r % sl == 0) | \
        (r % sl == sl - 1)
    live = r < count
    fills = {"kind": 0, "rseq": RSEQ_NONE}
    pats = list(range(9))
    if picks is not None:
        pats = list(np.asarray(pats)[picks])
    d = len(pats)
    tables = np.empty((K1.N_LANES, d, cap), np.int32)
    for i, p in enumerate(pats):
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
        lanes = {n: np.zeros(cap, np.int64) for n in SEGMENT_LANES}
        lanes["kind"][:] = 1
        lanes["orig"][:] = orig
        lanes["length"][:] = length
        lanes["off"][:] = np.concatenate([[0], np.cumsum(length)[:-1]])
        lanes["seq"][:] = 5
        lanes["client"][:] = 1
        lanes["rseq"][:] = np.where(rec, 6, RSEQ_NONE)
        if p == 8:
            # Every row acked-removed at seq 6, but some carry a pending
            # stamp or are local removes, and some seqs are unassigned.
            lanes["rseq"][:] = np.where(r % 13 == 0, UNASSIGNED_SEQ, 6)
            lanes["rlseq"][:] = np.where((r % 7 == 0) | (r % 13 == 0), 1, 0)
            lanes["lseq"][:] = np.where(r % 11 == 0, 2, 0)
            lanes["seq"][:] = np.where(r % 11 == 0, UNASSIGNED_SEQ, 5)
            lanes["alseq"][:] = np.where(r % 17 == 0, 3, 0)
        for j, n in enumerate(SEGMENT_LANES):
            tables[j, i] = np.where(live, lanes[n], fills.get(n, 0))
    scalars = np.zeros((d, K1.N_SCALARS), np.int32)
    scalars[:, K1.SC_COUNT] = count
    scalars[:, K1.SC_MIN_SEQ] = 10
    scalars[:, K1.SC_CUR_SEQ] = 100
    scalars[:, K1.SC_SELF] = NO_CLIENT
    ops = np.zeros((d, 1, OP_WIDTH), np.int32)
    as_t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return as_t(tables), as_t(scalars), as_t(ops)


def edge_batches(cap: int, device, k: int = 4, launch_docs=None):
    """:func:`edge_case` and :func:`compact_edge_case` as the holds take
    them: whole where a launch of the whole case runs on the shared,
    cluster or global tier; where it runs on the split tier (past 65,536
    rows, or fewer documents than the card has SMs past 16,384),
    in batches of :data:`SPLIT_EDGE_DOCS` documents, each cut at the split
    tier's slices of its rows below count + 2K for a launch of
    ``launch_docs`` documents (default: a whole batch; C = 16 CTAs a
    document on an H100 for up to 8 documents, so a shorter last batch is
    cut alike), so the slice edges the cases name are the kernel's.
    Yields ("apply" or "compact", (tables, scalars, ops))."""
    per = SPLIT_EDGE_DOCS
    n_apply = len(_edge_firsts(cap, _slice_rows(cap, None)))
    for kind, n, live in (("apply", n_apply, cap - 10 + 2 * k),
                          ("compact", 9, cap - 3)):
        if _cuda.tier(cap, "merge_apply", n) != "split":
            yield kind, (edge_case(cap, device, k) if kind == "apply"
                         else compact_edge_case(cap, device))
            continue
        sl = _cuda.split_slice_rows(live, launch_docs or per,
                                    _cuda.sm_count(device))
        if kind == "apply":
            n = len(_edge_firsts(cap, sl))
        for i in range(0, n, per):
            picks = slice(i, i + per)
            yield kind, (edge_case(cap, device, k, sl, picks)
                         if kind == "apply"
                         else compact_edge_case(cap, device, sl, picks))


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
    SX.reset_counts()


def read_shard_counts() -> dict:
    """The exchange kernels' launches since the last
    :func:`reset_counts`."""
    return {name: spec["wrapper"].launches
            for name, spec in SHARD_KERNELS.items()}


def reset_tree_counts() -> None:
    TSK.reset_counts(*(spec["wrapper"] for spec in TREE_KERNELS.values()))
    TAK.reset_counts()


def read_tree_counts() -> dict:
    """Each tree kernel's launches since the last reset (T1, T2 and
    A1-A4): in all and by tier."""
    return {name: {"all": spec["wrapper"].launches,
                   **{t: getattr(spec["wrapper"], f"launches_{t}", 0)
                      for t in TSK.TIER_CODES}}
            for name, spec in {**TREE_KERNELS, **ALGEBRA_KERNELS}.items()}


def read_counts() -> dict:
    """Each kernel's launches since the last reset: in all and by tier."""
    out = {}
    for name, spec in KERNELS.items():
        w = spec["wrapper"]
        out[name] = {"all": w.launches}
        out[name].update((t, getattr(w, f"launches_{t}"))
                         for t in _cuda.TIER_CODES)
    return out


def bound_bytes(name: str, d: int, s: int, k: int) -> int:
    """Bytes the function must move: the tables and scalars read once and
    written once, the ops read once."""
    nbytes = 2 * (K1.N_LANES * d * s * 4 + d * K1.N_SCALARS * 4)
    if KERNELS[name]["takes_ops"]:
        nbytes += d * k * OP_WIDTH * 4
    return nbytes


def hold_kernel(name: str, t0, s0, ops, kernel_reps=10, plain_reps=3,
                t=None, scalars_out=None):
    """Run one kernel wrapper (on tier ``t`` where given) and its plain
    version on the same input on the card; assert bit equality; return
    (max_abs_err, ms, plain_ms), the times None with ``kernel_reps=0``.
    The output scalars are appended to the list ``scalars_out`` where
    given (for :func:`live_bound_bytes`)."""
    spec = KERNELS[name]
    args = (ops,) if spec["takes_ops"] else ()
    want = spec["plain"](t0, s0, *args)
    tier = t
    t, s = t0.clone(), s0.clone()
    spec["wrapper"](t, s, *args, t=tier)
    torch.cuda.synchronize()
    err = max(int((t.long() - want[0].long()).abs().max()),
              int((s.long() - want[1].long()).abs().max()))
    if not (torch.equal(t, want[0]) and torch.equal(s, want[1])):
        bad = (t != want[0]).nonzero()[:5].tolist()
        raise AssertionError(f"{name}: kernel != plain, max_abs_err {err}, "
                             f"first [lane, doc, row] {bad}")
    if scalars_out is not None:
        scalars_out.append(want[1])
    del want

    def reset():
        t.copy_(t0)
        s.copy_(s0)

    if kernel_reps == 0:
        return err, None, None
    ms = _median_ms(lambda: spec["wrapper"](t, s, *args, t=tier), reset,
                    kernel_reps)
    plain_ms = _median_ms(lambda: spec["plain"](t0, s0, *args), lambda: None,
                          plain_reps)
    return err, ms, plain_ms


def narrow_tiers(name: str, cap: int) -> tuple:
    """The tiers phase 1 holds and times ``name`` on, forced, beside the
    one it is routed to: K1 and K3 at the warp tier's widths on the warp
    and the shared tier; none elsewhere."""
    if name == "K2_zamboni_compact" or cap > _cuda.WARP_MAX_CAPACITY:
        return ()
    return ("smem", "warp")


def phase_kernels(device, report, key, shapes, seed_offset=0):
    """Hold K1/K2/K3 bit for bit against their plain versions at each
    (S rows, D docs) of ``shapes`` with K = 16, on :func:`random_case`
    states; time each beside its byte-floor bound (K1 and K3 at the warp
    tier's widths on the warp and the shared tier both, the one not
    routed forced; :func:`narrow_tiers`). Returns the rows."""
    rows = []
    for cap, d in shapes:
        t_shape = time.perf_counter()
        rng = np.random.default_rng(cap + seed_offset)
        t0, s0, ops = random_case(rng, d, cap, 16, device)
        for name in KERNELS:
            b = bound_bytes(name, d, cap, 16)
            routed = _cuda.tier(cap, KERNELS[name]["entry"], d)
            for tier in (routed,) + tuple(
                    t for t in narrow_tiers(name, cap) if t != routed):
                outs = []
                err, ms, plain_ms = hold_kernel(
                    name, t0, s0, ops, t=None if tier == routed else tier,
                    scalars_out=outs)
                live = live_bound_bytes(name, s0, cap, ops, outs[0])
                rows.append(dict(kernel=name, tier=tier, docs=d,
                                 cap=cap, k=16, max_abs_err=err, ms=ms,
                                 plain_ms=plain_ms,
                                 bound_ms=live / HBM_BYTES_PER_S * 1e3,
                                 all_rows_bound_ms=b / HBM_BYTES_PER_S * 1e3,
                                 bound_bytes=live, library_ms=None,
                                 routed=tier == routed))
                print(f"kernels S={cap} D={d} ({tier}"
                      f"{'' if tier == routed else ', forced'}) {name}: "
                      f"exact, {ms:.4f} ms (plain {plain_ms:.3f} ms, bound "
                      f"{rows[-1]['bound_ms']:.4f} ms, all rows "
                      f"{rows[-1]['all_rows_bound_ms']:.4f}, library_ms "
                      "null)", flush=True)
        # The same kernels on moves at the tile and slice edges, and K2 and
        # K3 on compactions that meet them, untimed (K1 and K3 at the
        # narrow widths on both narrow tiers).
        for kind, edges in edge_batches(cap, device):
            for name in KERNELS:
                if kind == "apply" or name != "K1_merge_apply":
                    for tier in narrow_tiers(name, cap) or (None,):
                        hold_kernel(name, *edges, kernel_reps=0,
                                    plain_reps=0, t=tier)
        if _cuda.CLUSTER_MAX_CAPACITY < cap <= _cuda.GLOBAL_MAX_CAPACITY:
            # K1 and K3 on the global tier too, which launches of fewer
            # documents of this width than the card has SMs do not take.
            for kind, edges in (("apply", edge_case(cap, device)),
                                ("compact", compact_edge_case(cap, device))):
                for name in ("K1_merge_apply", "K3_fused_apply_compact"):
                    if kind == "apply" or name != "K1_merge_apply":
                        hold_kernel(name, *edges, kernel_reps=0,
                                    plain_reps=0, t="global")
        del edges
        t, s = t0.clone(), s0.clone()
        K1.apply_ops_packed(t, s, ops)
        errs = s[:, K1.SC_ERR]
        cov = {bit: float(((errs & v) != 0).float().mean())
               for bit, v in (("capacity", ERR_CAPACITY),
                              ("range", ERR_RANGE), ("client", ERR_CLIENT))}
        print(f"kernels S={cap} err-bit coverage (share of docs): {cov}; "
              f"{time.perf_counter() - t_shape:.1f} s", flush=True)
        rows[-1]["err_coverage"] = cov
        del t0, s0, ops, t, s
        torch.cuda.empty_cache()
    report[key] = rows
    return rows


# Phase 1c: every kernel entry on every tier it has, at the shape its path
# launches it, REPEAT_LAUNCHES launches against one plain run (an ordering
# fault in shared memory shows only over repeated launches). Merge entries:
# (entry, tier, rows S, docs D, ops K, the path), K3's shared tier cut from
# the fleet service's 100,000 documents to 16,384, and its tiers no path
# runs at phase 1b's shapes; then the shared and cluster tiers' seams of
# the rows below count (``tools.kernel_sanitize.shared_live_cases``). The
# exchange at 9c's 8 shards of 65,536 rows
# (X1 and X2 as two device groups of 4) and the one card's shard; T1 at
# 7a's widths cut to 40 of its 125 commits, T2 at 7b's cut to 32 of 128;
# A1-A4 at 7a's widths on raw lanes (duplicate move tags, compose's ties
# and overflowing pools).
REPEAT_LAUNCHES = 200
# Rows below count a shard of 9c holds after promotion (about 80,400 live
# rows over 8 shards) and the one card's shard (65,681).
ROWS_9C = 10_050
ROWS_9C_ONE_CARD = 65_681
REPEAT_MERGE = (
    ("merge_apply", "warp", 128, 16_384, 8, "serving"),
    ("merge_apply", "warp", 128, 100_000, 16, "fleet service"),
    ("merge_apply", "warp", 256, 20_000, 64, "8c"),
    ("merge_apply_compact", "warp", 128, 100_000, 16, "fleet service"),
    ("merge_apply", "smem", 128, 16_384, 8, "serving"),
    ("merge_apply", "smem", 2048, 256, 16, "deep"),
    ("merge_apply", "cluster", 4096, 256, 16, "deep"),
    ("merge_apply", "global", 65_536, 8, 1, "9c on the global tier"),
    ("merge_apply", "split", 65_536, 8, 1, "9c"),
    ("merge_apply", "split", 524_288, 1, 1, "9c one card"),
    ("merge_compact", "smem", 128, 16_384, 0, "serving"),
    ("merge_compact", "cluster", 4096, 256, 0, "deep"),
    ("merge_compact", "global", 65_536, 8, 0, "9c"),
    ("merge_compact", "split", 524_288, 1, 0, "9c one card"),
    ("merge_apply_compact", "smem", 128, 16_384, 16, "fleet service"),
    ("merge_apply_compact", "smem", 2048, 256, 16, "1b"),
    ("merge_apply_compact", "cluster", 4096, 256, 16, "1b"),
    ("merge_apply_compact", "global", 65_536, 16, 16, "1b"),
    ("merge_apply_compact", "split", 131_072, 2, 16, "1b"),
)
# The rows below count of the sharded paths' cases above (one live op, the
# other shards' NOOPs), the rest random.
REPEAT_ROWS = {"9c": ROWS_9C, "9c on the global tier": ROWS_9C,
               "9c one card": ROWS_9C_ONE_CARD}
# (docs, commits, W, Lc, Pc, move share, lag window): 7a's widths.
REPEAT_T1 = (1024, 40, 16, 128, 32, 0.0, 16)
REPEAT_T2 = (1024, 32, 512)


def _sharing_plain(runs) -> list:
    """``runs`` (one entry's tiers on the same inputs) with one plain run
    between them."""
    want = runs[0].plain()
    for r in runs:
        r.plain = lambda want=want: want
    return runs


def repeat_cases(dev) -> list:
    """Phase 1c's ``(case, run)`` pairs on ``dev``: every C entry on every
    tier it has, at its path's shape (above)."""
    out = []
    for entry, tier, cap, n, k, path in REPEAT_MERGE:
        if path in REPEAT_ROWS:
            t, s, ops = KS.live_inputs(dev, cap, [REPEAT_ROWS[path]] * n,
                                       max(k, 1), live_doc=n // 2)
        else:
            t, s, ops = KS.merge_inputs(dev, cap, n, max(k, 1))
        case = KS.Case(entry, tier, f"{n:,} docs x {cap:,} rows, K {k} "
                       f"({path})", None)
        out.append((case, KS.merge_run(entry, t, s, ops, tier)))
    # The shared and cluster tiers where the rows below count meet their
    # seams (count 0, 1 and S, a live range ending on a slice's edge, one
    # live op beside NOOPs).
    out += [(case, case.make(dev)) for case in KS.shared_live_cases()]
    i32 = dict(dtype=torch.int32, device=dev)
    t, s, ops = exchange_case(dev, 8, 65_536, k=1)
    ops2 = KS.with_past_op(ops, 0)
    ar = torch.arange(8, **i32)
    for case, run in (
            (KS.Case("shard_stats", "-", "9c: 2 groups x 4 shards x 65,536 "
                     "rows, 1 op", None),
             KS.stats_run(t, s, ops, [[0, 1, 2, 3], [4, 5, 6, 7]])),
            (KS.Case("shard_resolve", "-", "9c: group of shards 4-7 of 8, "
                     "an op and one past the end", None),
             KS.resolve_run(t, s, ops2, ar[4:].contiguous(), ar)),
            (KS.Case("shard_exchange", "-", "9c: 1 group x 8 shards x "
                     "65,536 rows, 1 op", None),
             KS.exchange_run(t, s, ops))):
        out.append((case, run))
    t1, s1, op1 = exchange_case(dev, 1, 524_288, k=1)
    out.append((KS.Case("shard_exchange", "-", "9c one card: 1 shard x "
                        "524,288 rows, 1 op", None),
                 KS.exchange_run(t1, s1, op1)))
    for entry, args, words in (
            (TSK.T1, KS.trunk_args(dev, *REPEAT_T1),
             "7a: 1,024 docs x 40 commits, Lc 128, Pc 32, W 16"),
            (TSK.T2, KS.em_args(dev, *REPEAT_T2),
             "7b: 1,024 docs x 32 commits, Lc 512, W 16, R 16")):
        tiers = [t for t in KS.SCAN_TIERS
                 if KS.scan_placement(entry, t, args) is not None]
        runs = _sharing_plain([KS.scan_run(entry, args, t) for t in tiers])
        out += [(KS.Case(entry, t, words, None), r)
                for t, r in zip(tiers, runs)]
    docs, L, a, b = algebra_case(dev, 1024, TREE_LC, TREE_PC, "raw")
    for entry in KS.ALGEBRA:
        for c_after in ((False, True) if entry == TAK.A2 else (False,)):
            args = KS.algebra_args(entry, docs, L, a, b, c_after)
            runs = _sharing_plain([KS.algebra_run(entry, args, t)
                                   for t in TAK.TIER_CODES])
            out += [(KS.Case(entry, t, "7a: 1,024 docs, Lc 128, Pc 32, raw"
                             " lanes" + (", c_after" if c_after else ""),
                             None), r)
                    for t, r in zip(TAK.TIER_CODES, runs)]
    return out


def phase_repeat(device, report) -> list:
    """Phase 1c: each of :func:`repeat_cases` launched at least
    :data:`REPEAT_LAUNCHES` times round robin, each call into fresh
    outputs filled with the sentinel and held bit for bit against one
    plain run on the same inputs (``tools.kernel_sanitize.hold_all``),
    the allocator's free blocks poisoned before each call (two byte
    patterns in turns, as ``--poison``); one line each with its launches
    and mismatches. Launches here count nowhere. Any mismatch fails the
    phase once every case has run."""
    with _Uncounted():
        pairs = repeat_cases(device)
        results = KS.hold_all([r for _c, r in pairs], REPEAT_LAUNCHES,
                              device)
        torch.cuda.synchronize()
    rows = []
    for (case, _r), res in zip(pairs, results):
        print("repeat " + KS.report_line(case, res), flush=True)
        rows.append(dict(kernel=case.label, entry=case.entry,
                         tier=case.tier, shape=case.shape, **res))
    del pairs
    report["repeat"] = rows
    covered = {(r["entry"], r["tier"]) for r in rows}
    missing = [(e, t) for e in KS.LABELS for t in KS.entry_tiers(e)
               if (e, t) not in covered]
    bad = [r for r in rows if r["mismatches"] or r["launches"]
           < REPEAT_LAUNCHES]
    if missing or bad:
        raise AssertionError(f"phase 1c: tiers not held {missing}; "
                             f"failing cases {bad}")
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
TREE_7A_SCRIPTS, TREE_7A_COMMITS = 64, 1000  # 7a's distinct scripts, depth
# The commits of 7a's prefix held against T1's plain version (~36 ms a step
# on one H100) and on the CPU, and of 11d's trunk_scan.
TREE_PLAIN_COMMITS = 125
# What a hold fills a tree kernel's outputs with before the launch: the
# plain versions never produce it on the holds' inputs, so a lane the kernel
# leaves unwritten cannot pass.
TREE_SENTINEL = -0x5EED
# 9c's sharded document: 8 shards of 8 x config.json's top tier / 8 rows,
# fed frames of 512 ops.
SHARDED_SHARD_CAP, SHARDED_FRAME_OPS = 65_536, 512
SHARDED_CPU_OPS = 64  # 11d's CPU twin of sharded_apply_ops: the frame's head


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
    their summed µs on the card, the kernels among them by name, and the
    top-level ATen ops the host dispatched (count and names)."""
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
    aten = [e.name for e in events if e.device_type == DeviceType.CPU
            and e.name.startswith("aten::") and e.cpu_parent is None]
    named = [(_kernel_name(e.name), e.time_range.elapsed_us()) for e in kern
             if not e.name.startswith(("Memcpy", "Memset"))]
    kernel_us = collections.defaultdict(float)
    for name, us in named:
        kernel_us[name] += us
    return dict(
        launches=len(kern),
        device_us=float(sum(e.time_range.elapsed_us() for e in kern)),
        kernels=dict(collections.Counter(name for name, _us in named)),
        kernel_us=dict(kernel_us),
        aten_ops=len(aten), aten_names=sorted(set(aten)),
    )


def _kernel_name(name: str) -> str:
    """A device kernel's name without its return type, namespace and
    parameter list (``merge_kernel<0, 2, false>``)."""
    name = name.replace("(anonymous namespace)::", "")
    name = name.removeprefix("void ").split("(", 1)[0].strip()
    head, sep, tail = name.partition("<")
    return head.rsplit("::", 1)[-1] + sep + tail


def _queued_ms(dev, fn, reps: int = 50, spin_cycles: int = 50_000_000,
               reset=None):
    """Device ms a call of ``fn`` over ``reps`` calls launched back to
    back behind a spin kernel (``torch.cuda._sleep``, ~25 ms at the H100's
    clock), so the host has queued every launch before the first runs and
    the CUDA events between them see the device's own time, not the
    host's launch cost. Where queueing took longer than the spin (a host
    slowed by its neighbours) it measures once more behind a spin four
    times as long, and raises if that too is outrun. With ``reset`` (a
    call that restores the state ``fn`` works on in place), every call of
    ``fn`` is queued behind a reset, so each works on a fresh input and
    not on the state the last one left, and the time is that of reset
    and call less that of the reset alone, queued the same way. Host wall
    a call on the CPU."""
    if reset is not None:
        def both():
            reset()
            fn()
        return (_queued_ms(dev, both, reps, spin_cycles)
                - _queued_ms(dev, reset, reps, spin_cycles))
    if dev.type != "cuda":
        return _event_ms(dev, fn, reps)
    for cycles in (spin_cycles, 4 * spin_cycles):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        spin = torch.cuda.Event(enable_timing=True)
        spin.record()
        torch.cuda._sleep(cycles)
        t = time.perf_counter()
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        queued_ms = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize()
        if queued_ms < spin.elapsed_time(a):
            return a.elapsed_time(b) / reps
    raise AssertionError(f"_queued_ms: queueing took {queued_ms:.2f} ms, the"
                         f" spin {spin.elapsed_time(a):.2f} ms")


def _device_ms(dev, fn, reps: int, kernel: str):
    """Median device time (ms) of the launches of ``kernel`` (a kernel's
    short name) over ``reps`` calls of ``fn`` under ``torch.profiler``:
    the kernel's own time, without the host's launch cost. None on the CPU
    or when the profiler records no such launch."""
    if dev.type != "cuda":
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        _sync(dev)
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA
          and _kernel_name(e.name) == kernel]
    return float(np.median(us)) / 1e3 if us else None


def _scan_launches(dev, fn) -> dict:
    """One call of ``fn`` under ``torch.profiler`` (:func:`_profile`: the
    device activities it saw and their µs), plus ``kernel_launches``, the
    tree kernels' own launch counts over the call. Run it inside
    :class:`_Uncounted`."""
    before = {n: s["wrapper"].launches for n, s in TREE_KERNELS.items()}
    prof = _profile(dev, fn)
    prof["kernel_launches"] = sum(s["wrapper"].launches - before[n]
                                  for n, s in TREE_KERNELS.items())
    return prof


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


def _sentinel_out(like, dev):
    """``(doc_ids [N, Lc], L [N], err [N])`` filled with
    :data:`TREE_SENTINEL`, for a tree kernel whose first input is ``like``
    (``[N, Lc]`` or ``[N, W, Lc]``)."""
    n, lc = like.shape[0], like.shape[-1]
    return tuple(torch.full(s, TREE_SENTINEL, dtype=torch.int32, device=dev)
                 for s in ((n, lc), (n,), (n,)))


def _held(got, want, what: str) -> int:
    """Assert a tree kernel's lanes ``got`` (written into
    :func:`_sentinel_out`) equal the plain version's ``want`` in every
    lane; the plain lanes must not hold the sentinel, so an unwritten lane
    fails. Returns the largest absolute error (0)."""
    if any(bool((y == TREE_SENTINEL).any()) for y in want):
        raise AssertionError(f"{what}: the plain lanes hold the sentinel")
    err = max(int((x.long() - y.long()).abs().max()) if x.numel() else 0
              for x, y in zip(got, want))
    if err or not all(torch.equal(x, y) for x, y in zip(got, want)):
        raise AssertionError(f"{what}: kernel != plain at "
                             f"{[tuple(x.shape) for x in got]}, max_abs_err "
                             f"{err}")
    return err


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts
               if torch.is_tensor(t))


def _flat(r) -> list:
    """A tree algebra result's lanes in the C entry's order: apply's
    ``(doc_ids, L)``, a change's seven lanes, compose's and its overflow."""
    if isinstance(r, tuple) and len(r) == 2 and isinstance(r[0],
                                                           TK.DenseChange):
        return [*r[0], r[1]]
    return list(r)


def _algebra_lanes(args) -> list:
    """The tensors among an algebra call's arguments (a change's lanes)."""
    out = []
    for x in args:
        if isinstance(x, TK.DenseChange):
            out += list(x)
        elif torch.is_tensor(x):
            out.append(x)
    return out


def algebra_args(name, docs, L, a, b, c_after=False) -> tuple:
    """The arguments of algebra kernel ``name`` (and of its plain version
    and entry point): apply and invert take the documents and ``a``,
    rebase ``a`` over ``b`` in tie form ``c_after``, compose ``a`` then
    ``b``."""
    if name in ("A1_tree_apply", "A3_tree_invert"):
        return docs, L, a
    if name == "A2_tree_rebase":
        return a, b, L, bool(c_after)
    return a, b, L


def _algebra_sentinel(name, args, dev):
    """Outputs of algebra kernel ``name`` at ``args`` filled with
    :data:`TREE_SENTINEL`, in the structure its wrapper's ``out`` takes."""
    entry = ALGEBRA_KERNELS[name]["entry"]
    c = next(x for x in args if isinstance(x, TK.DenseChange))
    N, Lc = c.del_mask.shape
    lanes = [torch.full(s, TREE_SENTINEL, dtype=torch.int32, device=dev)
             for s in TAK.out_shapes(entry, N, Lc, c.ins_ids.shape[1])]
    if entry == TAK.A1:
        return tuple(lanes)
    if entry == TAK.A4:
        return TK.DenseChange(*lanes[:7]), lanes[7]
    return TK.DenseChange(*lanes)


def hold_algebra(dev, name, args, reps=5) -> dict:
    """Algebra kernel ``name`` on every tier that takes its shape (the one
    ``tier()`` picks first), each one launch under sync-debug "error" into
    sentinel-filled outputs, held against its plain version on the same
    inputs on the card in every lane (:func:`_held`); each tier's device
    ms a call (``ms``: 50 calls queued behind a spin, :func:`_queued_ms`)
    and CUDA-event ms a call with the wrapper's host work (``event_ms``,
    median of ``reps``), one plain call's CUDA-event ms, and the byte
    floor (inputs read once, outputs written once). Launches made here
    count nowhere."""
    spec = ALGEBRA_KERNELS[name]
    w, entry = spec["wrapper"], spec["entry"]
    c = next(x for x in args if isinstance(x, TK.DenseChange))
    N, Lc = c.del_mask.shape
    Pc = c.ins_ids.shape[1]
    picked = TAK.tier(entry, Lc, Pc, N)
    tiers = [picked] + [t for t in TAK.TIER_CODES if t != picked
                        and TAK.placement(entry, Lc, Pc, t) is not None]
    rows = {}
    with _Uncounted():
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        want = spec["plain"](*args)
        b.record()
        torch.cuda.synchronize()
        plain_ms = a.elapsed_time(b)
        for t in tiers:
            before = w.launches
            got = _no_sync(dev, w, *args, out=_algebra_sentinel(name, args,
                                                                dev), t=t)
            if w.launches != before + 1:
                raise AssertionError(f"{name} on {t}: "
                                     f"{w.launches - before} launches")
            err = _held(_flat(got), _flat(want), f"{name} on {t}")
            del got
            rows[t] = dict(ms=_queued_ms(dev, lambda: w(*args, t=t)),
                           event_ms=_event_ms(dev, lambda: w(*args, t=t),
                                              reps),
                           max_abs_err=err)
    nbytes = _nbytes(*_algebra_lanes(args), *_flat(want))
    return dict(kernel=name, tier=picked, docs=N, Lc=Lc, Pc=Pc,
                c_after=args[3] if entry == TAK.A2 else None,
                ms=rows[picked]["ms"], plain_ms=plain_ms, bytes=nbytes,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, tiers=rows,
                max_abs_err=max(r["max_abs_err"] for r in rows.values()))


def _calls(name) -> tuple:
    """The tie forms a hold or the main path runs algebra kernel ``name``
    in: both for rebase, one for the others."""
    return (False, True) if name == "A2_tree_rebase" else (False,)


def tree_functions(dev, batch, docs, L) -> list:
    """The dense algebra's batched entry points at config 3b's shape (N =
    1,024 docs, Lc 128, Pc 32) on real commits of 7a's streams: commit 1
    as the change, commit 2 as the concurrent or following one (lane
    slices of the commit batch, so every row is strided). Each entry point
    is called once on the main path (rebase in both tie forms) under
    sync-debug "error"; its launches a call come from the kernels' own
    counters and must be one launch of its kernel (A1-A4) on the card.
    Outside the counts, each kernel held against its plain version into
    sentinel outputs on every tier that takes the shape
    (:func:`hold_algebra`), the entry point's ms a call (CUDA events) and
    the byte floor — each input read once, each output written once — at
    3.35 TB/s."""
    lanes = (batch.del_mask, batch.ins_cnt, batch.ins_ids, batch.mov_id,
             batch.mov_off, batch.pool_mid, batch.pool_off)
    a = TK.DenseChange(*[x[:, 1] for x in lanes])
    b = TK.DenseChange(*[x[:, 2] for x in lanes])
    rows = []
    for name, spec in ALGEBRA_KERNELS.items():
        for c_after in _calls(name):
            args = algebra_args(name, docs, L, a, b, c_after)

            def fn(args=args, spec=spec):
                return spec["fn"](*args, device=dev)

            before = {n: s["wrapper"].launches
                      for n, s in ALGEBRA_KERNELS.items()}
            out = _no_sync(dev, fn)
            launches = {n: s["wrapper"].launches - before[n]
                        for n, s in ALGEBRA_KERNELS.items()}
            if dev.type == "cuda" and launches != {
                    n: int(n == name) for n in ALGEBRA_KERNELS}:
                raise AssertionError(f"7a {spec['fn'].__name__}: launches "
                                     f"{launches}")
            b_ = _nbytes(*_algebra_lanes(args), *_flat(out))
            row = dict(name=spec["fn"].__name__, kernel=name,
                       c_after=c_after if name == "A2_tree_rebase" else None,
                       launches=launches[name], bytes=b_,
                       bound_ms=b_ / HBM_BYTES_PER_S * 1e3)
            with _Uncounted():
                row["ms"] = _event_ms(dev, fn)
                if dev.type == "cuda":
                    row["hold"] = hold_algebra(dev, name, args)
            if name == "A4_tree_compose":
                row["ties"], row["overflows"] = compose_ties(a, b, L)
            rows.append(row)
            h = row.get("hold") or {}
            form = f" c_after={c_after}" if row["c_after"] is not None else ""
            print(f"tree fn {row['name']}{form}: {row['ms']:.4f} ms a call, "
                  f"{row['launches']} launch of {name}; kernel "
                  f"{h.get('ms')} ms on {h.get('tier')} (every tier "
                  f"{ {k: v['ms'] for k, v in h.get('tiers', {}).items()} }),"
                  f" plain {h.get('plain_ms')} ms, bound "
                  f"{row['bound_ms']:.5f} ms", flush=True)
    return rows


# The algebra holds of 7h beside 7a's: (label, documents, Lc, Pc, lanes):
# 7a's and 7b's widths (config 3b's Lc 128, Pc 32 and 3c's Lc 512, Pc 8)
# on gen_streams commits with 5% moves and on raw lanes (several writers to
# a slot, duplicate tags, compose's ties and overflowing pools), and a
# width past every kernel's shared tier on raw lanes.
ALGEBRA_HOLDS = (("3b", 1024, TREE_LC, TREE_PC, "commits"),
                 ("3c", 1024, 512, 8, "commits"),
                 ("3b-raw", 1024, TREE_LC, TREE_PC, "raw"),
                 ("3c-raw", 1024, 512, 8, "raw"),
                 ("global-raw", 64, 8192, 32, "raw"))


def algebra_holds(dev) -> list:
    """A1-A4 against their plain versions at :data:`ALGEBRA_HOLDS`, rebase
    in both tie forms, each on every tier that takes the shape
    (:func:`hold_algebra`); compose's raw holds must hold ties and
    overflowing pools, and the holds together must reach every tier of
    every kernel."""
    rows = []
    for label, n, lc, pc, lanes in ALGEBRA_HOLDS:
        docs, L, a, b = algebra_case(dev, n, lc, pc, lanes)
        ties, over = compose_ties(a, b, L)
        if lanes == "raw" and not (ties and over):
            raise AssertionError(f"algebra hold {label}: {ties} ties, "
                                 f"{over} overflowing pools")
        for name in ALGEBRA_KERNELS:
            for c_after in _calls(name):
                r = hold_algebra(dev, name, algebra_args(name, docs, L, a, b,
                                                         c_after))
                r.update(cell=label, lanes=lanes)
                if name == "A4_tree_compose":
                    r.update(ties=ties, overflows=over)
                rows.append(r)
                print(f"algebra hold {label} {name}"
                      f"{' c_after' if c_after else ''} N {n} Lc {lc} Pc "
                      f"{pc}: {r['ms']:.4f} ms on {r['tier']} (plain "
                      f"{r['plain_ms']:.2f} ms, bound {r['bound_ms']:.5f} "
                      f"ms), every tier " + ", ".join(
                          f"{k} {v['ms']:.4f}" for k, v in r["tiers"].items())
                      + f"; max_abs_err {r['max_abs_err']}", flush=True)
        del docs, L, a, b
    for name in ALGEBRA_KERNELS:
        if {t for r in rows if r["kernel"] == name
                for t in r["tiers"]} != set(TAK.TIER_CODES):
            raise AssertionError(f"{name}'s holds miss a tier")
    return rows


# 7h's document-count sweep of A1-A4 across their tiers, the source of
# tree_algebra_kernel.WARP_MIN_DOCS: 7a's widths (config 3b's Lc 128, Pc
# 32) and 7b's (3c's Lc 512, Pc 8), the first n documents of one batch of
# gen_streams commits (5% moves). At ALGEBRA_SWEEP_HELD's counts each call
# is also held against its plain version (algebra_holds holds 1,024): one
# document, a lone warp in its CTA, and 528, which leaves a warp-tier CTA
# partly filled at Lc 512 for rebase and compose (7 and 5 documents a CTA;
# apply and invert take 8).
ALGEBRA_SWEEP_WIDTHS = ((TREE_LC, TREE_PC), (512, 8))
ALGEBRA_SWEEP_DOCS = (1, 8, 64, 256, 528, 1024)
ALGEBRA_SWEEP_HELD = (1, 528)


def algebra_ms(dev, name, args) -> dict:
    """Algebra kernel ``name``'s device ms a call at ``args`` on every tier
    that takes the shape (50 calls queued behind a spin,
    :func:`_queued_ms`); launches made here count nowhere."""
    spec = ALGEBRA_KERNELS[name]
    w, entry = spec["wrapper"], spec["entry"]
    c = next(x for x in args if isinstance(x, TK.DenseChange))
    Lc, Pc = c.del_mask.shape[1], c.ins_ids.shape[1]
    with _Uncounted():
        return {t: _queued_ms(dev, lambda t=t: w(*args, t=t))
                for t in TAK.TIER_CODES
                if TAK.placement(entry, Lc, Pc, t) is not None}


def algebra_sweep(dev) -> list:
    """A1-A4 (rebase in both tie forms) at :data:`ALGEBRA_SWEEP_WIDTHS` x
    :data:`ALGEBRA_SWEEP_DOCS`, each timed on every tier on the same inputs
    (:func:`algebra_ms`; at :data:`ALGEBRA_SWEEP_HELD` also held,
    :func:`hold_algebra`); a row per call with each tier's device ms, the
    fastest and ``tier()``'s pick."""
    rows = []
    for lc, pc in ALGEBRA_SWEEP_WIDTHS:
        docs, L, a, b = algebra_case(dev, max(ALGEBRA_SWEEP_DOCS), lc, pc,
                                     "commits")
        for n in ALGEBRA_SWEEP_DOCS:
            cut = (docs[:n], L[:n], TK.DenseChange(*[x[:n] for x in a]),
                   TK.DenseChange(*[x[:n] for x in b]))
            for name in ALGEBRA_KERNELS:
                for c_after in _calls(name):
                    args = algebra_args(name, *cut, c_after)
                    err = None
                    if n in ALGEBRA_SWEEP_HELD:
                        r = hold_algebra(dev, name, args)
                        ms = {t: v["ms"] for t, v in r["tiers"].items()}
                        err = r["max_abs_err"]
                    else:
                        ms = algebra_ms(dev, name, args)
                    row = dict(kernel=name,
                               c_after=c_after if name == "A2_tree_rebase"
                               else None, docs=n, Lc=lc, Pc=pc, tiers_ms=ms,
                               tier=TAK.tier(ALGEBRA_KERNELS[name]["entry"],
                                             lc, pc, n),
                               fastest=min(ms, key=ms.get),
                               max_abs_err=err)
                    rows.append(row)
                    print(f"algebra sweep {name}"
                          f"{' c_after' if c_after else ''} N {n} Lc {lc} "
                          f"Pc {pc}: " + ", ".join(
                              f"{t} {v:.4f}" for t, v in ms.items())
                          + f" ms (fastest {row['fastest']}, tier() "
                          f"{row['tier']}{', held' if err is not None else ''}"
                          ")", flush=True)
        del docs, L, a, b
    return rows


def tree_3b_batch(scripts, n_commits):
    """7a's ``scripts`` distinct concurrent 3-session streams
    (``gen_streams``, seed 0) and their host CommitBatch at config 3b's
    dense shape."""
    streams = TS.gen_streams(np.random.default_rng(0), scripts, n_commits,
                             n_sessions=3, W=TREE_W, Lc=TREE_LC)
    return streams, TS.to_device_batch(streams, TREE_LC, TREE_PC)


def tree_3b(dev, n_docs=1024, n_commits=TREE_7A_COMMITS,
            scripts=TREE_7A_SCRIPTS, cpu_docs=16,
            plain_commits=TREE_PLAIN_COMMITS):
    """7a: ``config3b_tree_rebase_device`` through the port — 64 distinct
    concurrent 3-session streams (``gen_streams``, seed 0) tiled over the
    document batch, staged on the card once, one warm-up and 3 timed
    ``batched_trunk_scan`` runs (W 16; on the card each one launch of T1)
    under sync-debug "error"; the err lane must be clear, every distinct
    script equal ``host_trunk`` and every tile its script. Outside the
    counts: the run again into sentinel-filled outputs, equal to it; the
    launches and device time of one scan from ``torch.profiler``; the
    first ``plain_commits`` commits of the whole batch through T1 and its
    plain version on the card (the plain loop takes ~36 ms a step on one
    H100), equal, and ``cpu_docs`` documents of them equal on the CPU.
    Then the algebra's entry points on the scan's documents and commits 1
    and 2 (:func:`tree_functions`)."""
    Lc, Pc, W = TREE_LC, TREE_PC, TREE_W
    scripts = min(scripts, n_docs)
    plain_commits = min(plain_commits, n_commits)
    t0 = time.perf_counter()
    streams, base = tree_3b_batch(scripts, n_commits)
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
    pre = DT.CommitBatch(*[x[:, :plain_commits].contiguous() for x in batch])
    with _Uncounted():
        if dev.type == "cuda":
            again = TSK.trunk_scan_cuda(docs, L0, batch, W,
                                        out=_sentinel_out(docs, dev))
            _held(again, out, "7a T1 into sentinel outputs")
            del again
        prof = _scan_launches(dev, scan)
        event_ms = _event_ms(dev, scan, reps=5)
        prefix_ms = _event_ms(dev, lambda: scan(pre), reps=5)
        plain_ms = prefix_tiers = scan_tiers = None
        if dev.type == "cuda":
            # The prefix of the whole batch against T1's plain version.
            got = TSK.trunk_scan_cuda(docs, L0, pre, W,
                                      out=_sentinel_out(docs, dev))
            t0 = time.perf_counter()
            want = DT.batched_trunk_scan_plain(docs, L0, pre, W,
                                               device=dev)
            _sync(dev)
            plain_ms = (time.perf_counter() - t0) * 1e3
            _held(got, want, "7a T1 vs plain")
            # Every tier on the same inputs: the prefix against the plain
            # version, the whole scan against the main path's result.
            prefix_tiers = tiers_held(dev, "T1_trunk_scan",
                                      (docs, L0, pre, W), want, "7a prefix")
            scan_tiers = tiers_held(dev, "T1_trunk_scan",
                                    (docs, L0, batch, W), out, "7a scan")
            del got, want
        # The same function on the CPU for cpu_docs documents of the
        # prefix, bit for bit.
        sub = DT.CommitBatch(*[x[:cpu_docs] for x in pre])
        got = _host_lanes(scan(sub, docs[:cpu_docs], L0[:cpu_docs]))
    want = _host_lanes(scan(DT.CommitBatch(*[x.cpu() for x in sub]),
                            docs[:cpu_docs].cpu(), L0[:cpu_docs].cpu(),
                            torch.device("cpu")))
    _same_lanes(got, want, "7a")
    out_ids, out_L, err = _host_lanes(out)
    if err.any():
        raise AssertionError("7a: ring-window overflow in config 3b")
    for d in range(scripts):
        if TK.dense_to_doc(out_ids[d], out_L[d]) != host_states[d]:
            raise AssertionError(f"7a: device/host divergence on doc {d}")
    if not (np.array_equal(out_ids.reshape(reps, scripts, Lc),
                           np.broadcast_to(out_ids[:scripts],
                                           (reps, scripts, Lc)))
            and np.array_equal(out_L.reshape(reps, scripts),
                               np.broadcast_to(out_L[:scripts],
                                               (reps, scripts)))):
        raise AssertionError("7a: a tiled document differs from its script")
    fns = tree_functions(dev, batch, torch.from_numpy(out_ids).to(dev),
                         torch.from_numpy(out_L).to(dev))
    scan_ms = float(np.median(times)) * 1e3
    b = _nbytes(*batch) + 2 * _nbytes(docs, L0) + _nbytes(err)
    b_pre = _nbytes(*pre) + 2 * _nbytes(docs, L0) + _nbytes(err)
    res = dict(
        n_docs=n_docs, commits_per_doc=n_commits, scripts=scripts, window=W,
        Lc=Lc, Pc=Pc, staged_gb=staged_gb, gen_s=gen_s, warm_s=warm_s,
        scan_s=times, edits_per_sec=rate, ms_per_scan=scan_ms,
        event_ms_per_scan=event_ms, us_per_step=event_ms * 1e3 / n_commits,
        scan=prof,
        tier=tier_label(*tree_options("T1_trunk_scan",
                                      (docs, L0, batch, W))[0]),
        cpu_trunk_edits_per_sec=cpu_rate, scan_bytes=b,
        scan_bound_ms=b / HBM_BYTES_PER_S * 1e3,
        prefix_commits=plain_commits, prefix_event_ms=prefix_ms,
        plain_ms_per_prefix=plain_ms,
        prefix_bound_ms=b_pre / HBM_BYTES_PER_S * 1e3,
        prefix_tiers=prefix_tiers, scan_tiers=scan_tiers,
        cpu_check=f"{cpu_docs} docs x {plain_commits} commits",
        functions=fns)
    print(f"7a config 3b: {rate:,.0f} edits/s, {scan_ms:.2f} ms a scan of "
          f"{n_commits} commits (CUDA events {event_ms:.3f} ms, "
          f"{res['us_per_step']:.2f} us a step; {prof['kernel_launches']} "
          f"kernel launch a scan, the profiler's {prof['launches']} device "
          f"activities, {prof['device_us']:.1f} us, {prof['aten_ops']} ATen "
          f"ops); the first {plain_commits} commits: T1 {prefix_ms:.3f} ms, "
          f"plain {plain_ms} ms; warm-up {warm_s:.1f} s, streams "
          f"{gen_s:.1f} s, staged {staged_gb:.2f} GB, host trunk "
          f"{cpu_rate:,.0f} edits/s", flush=True)
    if scan_tiers:
        print("7a T1 on every tier (ms): the first "
              f"{plain_commits} commits {_tier_ms(prefix_tiers)}; the whole "
              f"scan {_tier_ms(scan_tiers)}", flush=True)
    return res


def _tier_ms(tiers) -> str:
    return ", ".join(f"{k} {v['ms']:.4f}" for k, v in tiers.items())


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
    with _Uncounted():
        _sync(dev)
        t0 = time.perf_counter()
        out = _no_sync(dev, DEM.batched_em_trunk_scan_ring, *rings, mov_t,
                       staged, U, device=dev)
        _sync(dev)
        scan_only_s = time.perf_counter() - t0

        def rescan():
            return DEM.batched_em_trunk_scan_ring(*rings, mov_t, staged, U,
                                                  device=dev)

        prof = _scan_launches(dev, rescan)
        event_ms = _event_ms(dev, rescan, reps=5)
        plain_ms = scan_tiers = None
        if dev.type == "cuda":
            # The whole dispatch against T2's plain version on the card,
            # T2 run again into sentinel-filled outputs (a reused block
            # cannot hold this dispatch's result for it).
            got = TSK.em_ring_scan_cuda(*rings, mov_t, staged, U,
                                        out=_sentinel_out(rings[0], dev))
            t0 = time.perf_counter()
            want = DEM.batched_em_trunk_scan_ring_plain(*rings, mov_t,
                                                        staged, U,
                                                        device=dev)
            _sync(dev)
            plain_ms = (time.perf_counter() - t0) * 1e3
            _held(got, want, "7b T2 vs plain")
            _held(out, want, "7b T2 (the dispatch under sync-debug)")
            scan_tiers = tiers_held(dev, "T2_em_ring_scan",
                                    (*rings, mov_t, staged, U), want, "7b")
            del got, want
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
        with _Uncounted():
            t0 = time.perf_counter()
            DEM.batched_em_trunk_scan(rings[0][:, -1], rings[1][:, -1],
                                      rings[2][:, -1], staged, W, U,
                                      device=dev)
            _sync(dev)
            single_ms = (time.perf_counter() - t0) * 1e3
    b = (sum(x.nbytes for x in lanes) + ring_ids.nbytes + ring_L.nbytes
         + ring_seq.nbytes + mov0.nbytes + first[0].nbytes
         + first[1].nbytes + first[2].nbytes)
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
        event_ms_per_scan=event_ms, plain_ms_per_scan=plain_ms,
        us_per_step=event_ms * 1e3 / C, scan=prof, scan_tiers=scan_tiers,
        tier=tier_label(*tree_options("T2_em_ring_scan",
                                      (*rings, mov_t, staged, U))[0]),
        scan_bytes=b, scan_bound_ms=b / HBM_BYTES_PER_S * 1e3,
        cpu_em_edits_per_sec=cpu_rate,
        cpu_check=f"{cpu_docs} docs x {C} commits")
    print(f"7b config {'3c-moves' if move_prob else '3c'}: {rate:,.0f} "
          f"edits/s, device_fraction {res['device_fraction']:.3f}, "
          f"{len(dispatch_s)} dispatches of {disp_ms:.1f} ms (the first's "
          f"scan under sync-debug {res['scan_only_ms']:.1f} ms, CUDA "
          f"events {event_ms:.3f} ms, plain {plain_ms} ms, single-base form "
          f"{single_ms} ms, {res['us_per_step']:.2f} us a step; "
          f"{prof['kernel_launches']} kernel launch a scan, the profiler's "
          f"{prof['launches']} device activities, {prof['device_us']:.1f} "
          f"us, {prof['aten_ops']} ATen ops), host share of the waves "
          f"{res['host_share']:.3f}, "
          f"fallbacks {reasons}, scan shape {res['scan_shape']}, warm-up "
          f"{warm_s:.1f} s, streams {gen_s:.1f} s, host EM "
          f"{cpu_rate:,.0f} edits/s", flush=True)
    if scan_tiers:
        print(f"7b T2 on every tier (ms): {_tier_ms(scan_tiers)}", flush=True)
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


# T1's holds: (docs, commits, ring W, Lc, Pc, move_prob, the streams' lag
# window). A ring shallower than the streams' lag (W 3 under a lag window
# of 8) trips the ring-window err lane; Lc 1,024 at W 16 is past the shared
# tier (its ring alone is 268,480 bytes), so it runs on the global tier.
T1_HOLDS = (
    (1, 40, 3, 32, 8, 0.2, 8),
    (7, 40, 8, 32, 8, 0.0, 8),
    (7, 40, 8, 128, 32, 0.2, 8),
    (7, 40, 16, 512, 32, 0.2, 16),
    (7, 40, 16, 512, 8, 0.0, 16),
    (7, 40, 16, 1024, 32, 0.2, 16),
    (1024, 40, 16, 128, 32, 0.0, 16),
    (1024, 40, 3, 128, 32, 0.2, 8),
)
# T2's holds: every Lc bucket batch_ingest makes (W 16, R 16), 7 documents
# x 16 commits of em_case's lanes; Lc 4,096 runs on the global tier.
T2_HOLD_LCS = (32, 64, 128, 256, 512, 1024, 2048, 4096)
T2_HOLD_DOCS, T2_HOLD_COMMITS = 7, 16


def _tree_shape(name, args):
    """``(Lc, Pc, W, R, U, N)`` of tree kernel ``name``'s arguments."""
    if name == "T1_trunk_scan":
        docs, _, cb, W = args
        return docs.shape[1], cb[2].shape[2], W, 0, 1, docs.shape[0]
    ring_ids, _, _, _, cb, U = args
    return (ring_ids.shape[2], cb[2].shape[2], ring_ids.shape[1],
            cb[3].shape[2], int(U), ring_ids.shape[0])


def tier_label(t, ring) -> str:
    return f"{t}/{ring}" if ring else t


def tree_options(name, args) -> list:
    """``(tier, ring)`` of every tier that takes tree kernel ``name``'s
    shape at ``args`` (:data:`TREE_TIER_OPTIONS`), the wrapper's own pick
    (``tier()``, ``warp_ring()``) first."""
    entry = TREE_KERNELS[name]["entry"]
    lc, pc, W, R, U, n = _tree_shape(name, args)
    t = TSK.tier(entry, lc, pc, W, R, U, n)
    chosen = (t, TSK.warp_ring(entry, lc, pc, W, R, U, n) if t == "warp"
              else None)
    return [chosen] + [o for o in TREE_TIER_OPTIONS if o != chosen
                       and TSK.placement(entry, lc, pc, W, U, o[0], R, o[1])
                       is not None]


def tiers_held(dev, name, args, want, what: str, reps=5) -> dict:
    """Tree kernel ``name`` on every tier that takes its shape
    (:func:`tree_options`), each under sync-debug "error" into
    sentinel-filled outputs and held against ``want`` in every lane;
    ``{tier label: {ms, max_abs_err}}`` with the CUDA-event ms (median of
    ``reps``) on the same inputs, the wrapper's pick first. Launches made
    here count nowhere."""
    spec = TREE_KERNELS[name]
    rows = {}
    with _Uncounted():
        for t, ring in tree_options(name, args):
            lab = tier_label(t, ring)
            got = _no_sync(dev, spec["on"], t, ring, *args,
                           out=_sentinel_out(args[0], dev))
            err = _held(got, want, f"{what} on {lab}")
            del got
            rows[lab] = dict(ms=_event_ms(
                dev, lambda: spec["on"](t, ring, *args), reps),
                max_abs_err=err)
    return rows


def hold_tree(dev, name, args, reps=5) -> dict:
    """Run tree kernel ``name`` (the wrapper, on the tier ``tier()``
    picks) under sync-debug "error" into sentinel-filled outputs and its
    plain version on the same inputs on the card; assert every lane equal
    (:func:`_held`), and every other tier that takes the shape too
    (:func:`tiers_held`); return the row: tier and ring, max_abs_err,
    CUDA-event ms of the kernel (median of ``reps``) and of one plain run,
    the byte floor (inputs read once, outputs written once), each tier's
    ms and error (``tiers``) and the fastest."""
    spec = TREE_KERNELS[name]
    with _Uncounted():
        got = _no_sync(dev, spec["wrapper"], *args,
                       out=_sentinel_out(args[0], dev))
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        want = spec["plain"](*args, device=dev)
        b.record()
        torch.cuda.synchronize()
        plain_ms = a.elapsed_time(b)
        err = _held(got, want, name)
        ms = _event_ms(dev, lambda: spec["wrapper"](*args), reps)
    tiers = tiers_held(dev, name, args, want, name, reps)
    t, ring = tree_options(name, args)[0]
    nbytes = _nbytes(*args[:-2], *args[-2]) + _nbytes(*got)
    return dict(kernel=name, tier=t, ring=ring,
                max_abs_err=max([err] + [r["max_abs_err"]
                                         for r in tiers.values()]),
                ms=ms, plain_ms=plain_ms, bytes=nbytes,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, tiers=tiers,
                fastest=min(tiers, key=lambda k: tiers[k]["ms"]),
                err_lane=_host_lanes([want[2]])[0].tolist())


# 7h's holds at the main paths' shapes, each timing every tier on the same
# inputs: T1 at 7a's (1,024 docs x the 125 commits 7a holds against the
# plain version, Lc 128, Pc 32, W 16, gen_streams' lanes) and T2 at 7b's
# (1,024 docs x 128 commits, Lc 512, W 16, R 16, em_case's lanes); and T2
# at N = 1, the EditManager's one-document dispatch, at every bucket.
T1_MAIN_HOLD = (1024, TREE_PLAIN_COMMITS, TREE_W, TREE_LC, TREE_PC, 0.0,
                TREE_W)
T2_MAIN_HOLD = (1024, 128, 512)
# 7h's document-count sweep where the warp tier meets the CTA tiers, on
# both sides of each threshold of tree_scan_kernel.WARP_MIN_DOCS: T1 at
# Lc 512 from 256 documents; T2 at Lc 256 from 1,024, at Lc 512 from 512,
# never at Lc 128 or 1,024.
T1_SWEEP = tuple((n, 40, TREE_W, lc, TREE_PC, 0.0, TREE_W)
                 for n, lc in ((128, 512), (256, 512), (256, 128)))
T2_SWEEP = tuple((n, T2_HOLD_COMMITS, lc)
                 for n, lc in ((528, 256), (1024, 256), (256, 512),
                               (528, 512), (1024, 128), (1024, 1024)))


def tree_holds(dev) -> list:
    """T1 and T2 against their plain versions on the card at the edge
    shapes (``T1_HOLDS``, ``T2_HOLD_LCS``), the main paths' shapes
    (``T1_MAIN_HOLD``, ``T2_MAIN_HOLD``) and T2 at one document a launch,
    each on every tier that takes the shape, under sync-debug "error";
    the T1 ring-window err and T2's three err bits must show where the
    inputs call for them, and each kernel's holds must reach every tier."""
    rows = []
    for (n, c, w, lc, pc, mp, lag_w) in T1_HOLDS + (T1_MAIN_HOLD,) + T1_SWEEP:
        docs, L0, cb = trunk_case(dev, n, c, lag_w, lc, pc, mp)
        r = hold_tree(dev, "T1_trunk_scan", (docs, L0, cb, w))
        r.update(docs=n, commits=c, W=w, Lc=lc, Pc=pc, move_prob=mp)
        if (w < lag_w) != any(r["err_lane"]):
            raise AssertionError(f"T1 hold {r}: the ring-window err lane")
        rows.append(r)
        del docs, L0, cb
    for n, c, lc in ([(T2_HOLD_DOCS, T2_HOLD_COMMITS, lc)
                      for lc in T2_HOLD_LCS] + [T2_MAIN_HOLD]
                     + [(1, T2_HOLD_COMMITS, lc) for lc in T2_HOLD_LCS]
                     + list(T2_SWEEP)):
        rings, cb, U = em_case(dev, n, c, lc)
        r = hold_tree(dev, "T2_em_ring_scan", (*rings, cb, U))
        pc, R = cb.ins_ids.shape[2], cb.run_start.shape[2]
        r.update(docs=n, commits=c, W=16, Lc=lc, Pc=pc, R=R, U=U)
        e = r["err_lane"]
        if not (e[-1] & DEM.ERR_CAPACITY and (n == 1 or (
                e[1] & DEM.ERR_MOVE_EVICTED and e[4] & DEM.ERR_RING_MISS
                and not e[4] & DEM.ERR_MOVE_EVICTED))):
            raise AssertionError(f"T2 hold at N {n}, Lc {lc}: err lane {e}")
        rows.append(r)
        del rings, cb
    for name, entry in (("T1_trunk_scan", "tree_trunk_scan"),
                        ("T2_em_ring_scan", "tree_em_ring_scan")):
        if {lab.split("/")[0] for r in rows if r["kernel"] == name
                for lab in r["tiers"]} != set(TSK.TIER_CODES):
            raise AssertionError(f"{name}'s holds miss a tier of {entry}")
    for r in rows:
        r.pop("err_lane")
        print(f"tree hold {r['kernel']} {tier_label(r['tier'], r['ring'])}"
              f" N {r['docs']} C {r['commits']} W {r['W']} Lc {r['Lc']} Pc "
              f"{r['Pc']}{' U ' + str(r['U']) if 'U' in r else ''}: "
              f"{r['ms']:.4f} ms (plain {r['plain_ms']:.1f} ms, bound "
              f"{r['bound_ms']:.5f} ms), max_abs_err {r['max_abs_err']}; "
              f"every tier: " + ", ".join(
                  f"{k} {v['ms']:.4f}" for k, v in r["tiers"].items())
              + f" (fastest {r['fastest']})", flush=True)
    return rows


def phase_tree(device, report, b_docs=1024, b_commits=TREE_7A_COMMITS,
               c_docs=1024,
               c_commits=128, m_docs=512, m_commits=128, wave=128,
               c3_budget_s=15.0, c3_min_docs=16, holds=True):
    """Phase 7: the SharedTree rebase path on the card — 7h T1, T2 and
    A1-A4 held against their plain versions at edge shapes (``holds``), 7a
    config 3b (T1, then A1-A4 through the algebra's entry points), 7b
    configs 3c and 3c-moves (T2 through ``batch_ingest``), 7c config 3.
    Each sub-path runs with the tree kernels' launch counts set to 0 just
    before it and read just after; 7a must launch T1 and each of A1-A4, 7b
    T2. 7a runs the bench's whole 1,000 commits a document (its plain
    hold the first 125). Depth is cut elsewhere to keep the phase short on
    one H100: 7b's configs 3c and 3c-moves run 128 of their 512 commits
    (one wave; a wave's host work grows with its index, so later waves are
    slower), 7c documents for 15 s (at least 16). Every width, the
    document batches and the move mix are the bench's."""
    out = {}
    launches = {}
    t = time.perf_counter()
    if holds and device.type == "cuda":
        out["holds"] = tree_holds(device)
        out["algebra_holds"] = algebra_holds(device)
        out["algebra_sweep"] = algebra_sweep(device)
        out["holds_s"] = time.perf_counter() - t
    for key, fn, kw in (
            ("7a", tree_3b, dict(n_docs=b_docs, n_commits=b_commits)),
            ("7b", tree_3c, dict(n_docs=c_docs, n_commits=c_commits,
                                 scripts=16, wave=wave)),
            ("7b-moves", tree_3c, dict(n_docs=m_docs, n_commits=m_commits,
                                       scripts=8, wave=wave, move_prob=0.05,
                                       single_base=True)),
            ("7c", tree_3, dict(budget_s=c3_budget_s,
                                min_docs=c3_min_docs))):
        if device.type == "cuda":
            torch.cuda.empty_cache()
        reset_tree_counts()
        out[{"7a": "3b", "7b": "3c", "7b-moves": "3c-moves",
             "7c": "3"}[key]] = fn(device, **kw)
        launches[key] = read_tree_counts()
    for key, name in (("7a", "T1_trunk_scan"), ("7b", "T2_em_ring_scan"),
                      ("7b-moves", "T2_em_ring_scan"),
                      *(("7a", a) for a in ALGEBRA_KERNELS)):
        if device.type == "cuda" and launches[key][name]["all"] <= 0:
            raise AssertionError(f"{name} never launched on {key}")
    out["launches"] = launches
    out["wall_s"] = time.perf_counter() - t
    print(f"7 tree kernel launches by sub-path: {launches}", flush=True)
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
            key = (r["kernel"], r["cap"], r["docs"], r.get("tier", ""))
            means.setdefault(key, {}).setdefault(run["label"], []).append(
                r["ms"])
        for cell in ("config6", "deep"):
            for key, v in run[cell].items():
                means.setdefault((f"{cell} {key}", 0, 0, ""), {}).setdefault(
                    run["label"], []).append(v["median_ms"])
                calls.setdefault(f"{cell} {key}", {}).setdefault(
                    run["label"], []).append(v["calls"])
    for (name, cap, docs, tier), by in means.items():
        m = {label: float(np.mean(v)) for label, v in by.items()}
        ratios = ", ".join(f"{label} {m[label] / m['parent']:.3f}"
                           for label in m if label != "parent"
                           and "parent" in m)
        print(f"ab {name} S={cap} D={docs} {tier}: " + ", ".join(
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
# the cluster tier (one document over 4-16 CTAs), the global tier and the
# split tier (one document over 16 CTAs).
CLIENT_D1_CAPS = (256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536,
                  131_072, 524_288)


class _Uncounted:
    """Launches inside this block (holding a kernel against its plain
    version) leave every launch count as it was."""

    def __enter__(self):
        self._saved = [(spec["wrapper"], dict(vars(spec["wrapper"])))
                       for spec in (*KERNELS.values(),
                                    *TREE_KERNELS.values(),
                                    *ALGEBRA_KERNELS.values(),
                                    *SHARD_KERNELS.values())]

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


CLIENT_GROW_OPS = 256  # 8f's ops after the grow past 65,536 rows


def client_8f(device, out, n_ops=CLIENT_GROW_OPS):
    """8f: a full one-document ``SegmentState`` of 65,536 distinct rows on
    the card, ``grow``n to 131,072 rows (past the one-CTA global tier),
    then ``n_ops`` of ``random_acked_stream`` (refs caught up, collab
    window 32 seqs behind) through ``ops/merge_kernel.py``'s
    ``jit_apply_ops`` in calls of 32 ops, each followed by ``compact``:
    every K1/K2 launch on the split tier. The inserts land at the head, so
    each moves every row. Its lanes equal the same run on the CPU."""
    from fluidframework_tpu_torch.interop import (
        segment_state_from_numpy,
        segment_state_to_numpy,
    )
    from fluidframework_tpu_torch.ops import merge_kernel as MK
    from fluidframework_tpu_torch.ops.segment_state import grow
    from fluidframework_tpu_torch.testing.fuzz import random_acked_stream
    from fluidframework_tpu_torch.testing.oracle import OracleDoc

    n = 65536
    start = list(_overflow_state(n, n))
    ops = np.stack(random_acked_stream(
        np.random.default_rng(8), n_ops, {}, OracleDoc(NO_CLIENT),
        msn_lag=32, caught_up=True, seq0=n + 1)).astype(np.int32)
    lanes, wall = {}, {}
    for side, dev in (("card", device), ("cpu", torch.device("cpu"))):
        t = time.perf_counter()
        st = grow(segment_state_from_numpy(start, dev), 2 * n)
        for i in range(0, n_ops, 32):
            MK.jit_apply_ops(st, torch.from_numpy(ops[i:i + 32]).to(dev))
            MK.compact(st)
        lanes[side] = segment_state_to_numpy(st)
        wall[side] = time.perf_counter() - t
    _lanes_equal(lanes["card"], lanes["cpu"], "8f grow past 65,536")
    rows = int(lanes["card"][15])
    if rows <= n or lanes["card"][19] != 0:
        raise AssertionError(f"8f: {rows} rows, err {lanes['card'][19]}")
    out.update(rows=rows, ops=n_ops, card_s=wall["card"],
               cpu_s=wall["cpu"])
    print(f"8f grow 65,536 -> 131,072 rows on the card, {n_ops} ops, "
          f"{rows} rows: card == CPU lane for lane (card {wall['card']:.2f} "
          f"s, CPU {wall['cpu']:.2f} s)", flush=True)


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
        outs = []
        err, ms, plain_ms = hold_kernel(name, t, s, ops, reps, plain_reps,
                                        scalars_out=outs)
        b = live_bound_bytes(name, s, cap, ops, outs[0])
        b_all = bound_bytes(name, d, cap, k)
        rows.append(dict(kernel=name, cell=cell, docs=d, cap=cap, k=k,
                         tier=_cuda.tier(cap, KERNELS[name]["entry"], d),
                         max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b / HBM_BYTES_PER_S * 1e3, bound_bytes=b,
                         all_rows_bound_ms=b_all / HBM_BYTES_PER_S * 1e3,
                         library_ms=None))
        if ms is not None:
            print(f"client kernels {cell} S={cap} D={d} K={k} "
                  f"({rows[-1]['tier']}) {name}: exact, {ms:.4f} ms (plain "
                  f"{plain_ms:.3f} ms, bound {rows[-1]['bound_ms']:.6f} ms, "
                  f"all rows {rows[-1]['all_rows_bound_ms']:.5f})",
                  flush=True)

    with _Uncounted():
        for cap in CLIENT_D1_CAPS:
            t_cap = time.perf_counter()
            for seed in range(4):
                t, s, ops = random_case(np.random.default_rng(cap + seed), 1,
                                        cap, 1, device)
                reps = 10 if seed == 0 else 0
                hold("K1_merge_apply", t, s, ops, "D1", reps)
                hold("K2_zamboni_compact", t, s, None, "D1", reps)
            for kind, (t, s, ops) in edge_batches(cap, device, k=2,
                                                  launch_docs=1):
                for i in range(t.shape[1]):
                    if kind == "apply":
                        hold("K1_merge_apply", t[:, i:i + 1].contiguous(),
                             s[i:i + 1].contiguous(),
                             ops[i:i + 1].contiguous(), "D1 edge", 0, 0)
                    else:
                        hold("K2_zamboni_compact",
                             t[:, i:i + 1].contiguous(),
                             s[i:i + 1].contiguous(), None, "D1 edge", 0, 0)
            print(f"client holds D1 S={cap}: "
                  f"{time.perf_counter() - t_cap:.1f} s", flush=True)
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
    out = {key: {} for key in ("8a", "8b", "8c", "8d", "8e", "8f")}
    launches = {}
    wall = {}
    torch.cuda.set_sync_debug_mode("warn")
    try:
        steps = (("8a", client_8a), ("8b", client_8b), ("8c", client_8c),
                 ("8d", client_8d), ("8e", client_8e), ("8f", client_8f))
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
                    for t in COUNT_KEYS}
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
                   for t in COUNT_KEYS}
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
                outs = []
                err, ms, plain_ms = hold_kernel(kname, t0, s0, o0,
                                                scalars_out=outs)
                holds.append(dict(
                    kernel=kname, cell="9a", docs=per, cap=cap, k=k,
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=live_bound_bytes(kname, s0, cap, o0, outs[0])
                    / HBM_BYTES_PER_S * 1e3,
                    all_rows_bound_ms=bound_bytes(kname, per, cap, k)
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


def exchange_bound_bytes(tables, scalars=None) -> tuple:
    """Bytes X1, X2 and ``shard_exchange`` must move on a group's packed
    pair ``tables`` (this run's data): X1 reads the kind of each row below
    its shard's count (every row at or past it is free, so the function
    needs no more), the length, seq, writer and removed seq of each live
    row and one removers lane of each removed one, three scalars a shard
    and the op row, and writes 3 ints a shard; X2 (the group of every
    shard) reads 3 stats and a row index a shard, a shard index and the
    err lane of each shard and the op row, and writes the err lane and a
    rewritten op row a shard; ``shard_exchange`` is X1 and then, from X1's
    stats, each shard's err lane read and written and its op row written.
    Without ``scalars``, the same three with the kind of every row read:
    the earlier all-rows floor, kept for comparison."""
    n, s = tables.shape[1], tables.shape[2]
    live = tables[SEGMENT_LANES.index("kind")] != 0
    removed = live & (tables[SEGMENT_LANES.index("rseq")] != RSEQ_NONE)
    rows = n * s
    if scalars is not None:
        rows = int(scalars[:, K1.SC_COUNT].clamp(0, s).sum())
    x1 = 4 * (rows + 4 * int(live.sum()) + int(removed.sum()) + 3 * n
              + OP_WIDTH + 3 * n)
    x2 = 4 * (4 * n + OP_WIDTH + n * (1 + 2 + OP_WIDTH))
    return x1, x2, x1 + 4 * n * (2 + OP_WIDTH)


def hold_exchange(dev, tables, scalars, ops, cell: str, reps=10,
                  plain_reps=3) -> list:
    """X1, X2 and ``shard_exchange`` against their plain versions on
    ``dev`` for every op row of ``ops`` ([K, OP_WIDTH], read in place),
    their outputs filled with :data:`TREE_SENTINEL` before each launch so
    an unwritten lane fails; the accumulators (the group's ticket among
    them) must come back reset. X2 runs as the group of all shards in
    order, as a group of every other shard with the stats in reversed row
    order (``row_of``; from two shards on), and with ``shard_exchange`` on
    a copy of each op past the document's end (ERR_RANGE). With ``reps``,
    times each on op 0 (CUDA events; host wall on the CPU) beside its
    byte floor (the rows below each shard's count) and the all-rows floor
    of the first design. Launch
    counts stay as they were. Returns the three rows."""
    with _Uncounted():
        return _hold_exchange(dev, tables, scalars, ops, cell, reps,
                              plain_reps)


def _hold_exchange(dev, tables, scalars, ops, cell, reps, plain_reps):
    n_g = tables.shape[1]
    i32 = dict(dtype=torch.int32, device=dev)
    acc = SX.new_accumulators(n_g, dev)
    reset = SX.new_accumulators(n_g, dev)
    ar = torch.arange(n_g, **i32)
    flip = torch.flip(ar, (0,))
    # (the group's shards, the shard each stats row holds)
    groups = ((ar, ar), (ar[1::2].contiguous(), flip))[:1 + (n_g > 1)]
    past = ops.clone()
    past[:, F_POS1] = past[:, F_POS2] = (1 << 31) - 1

    def sentinel(*shape):
        return torch.full(shape, TREE_SENTINEL, **i32)

    def accumulators_reset(what):
        _sync(dev)
        if not torch.equal(acc, reset):
            raise AssertionError(f"{what} {cell}: accumulators left set")

    err = dict.fromkeys(SHARD_KERNELS, 0)
    for k in range(ops.shape[0]):
        want = SX.shard_stats_plain(tables, scalars, ops[k])
        out = sentinel(n_g, SX.N_STATS)
        SX.shard_stats(tables, scalars, ops, k, out=out, acc=acc)
        accumulators_reset("X1")
        err["X1_shard_stats"] = max(err["X1_shard_stats"], _held(
            [out], [want], f"X1 {cell} op {k}"))
        for buf in (ops, past):
            for at, held in groups:
                stats = want.index_select(0, held.long())
                row_of = torch.argsort(held).to(torch.int32)
                sc = scalars.index_select(0, at.long())
                rows, sc_want = SX.shard_resolve_plain(stats, buf[k], at,
                                                       row_of, sc)
                out = sentinel(at.shape[0], 1, OP_WIDTH)
                SX.shard_resolve(stats, buf, k, at, row_of, sc, out=out)
                _sync(dev)
                err["X2_shard_resolve"] = max(err["X2_shard_resolve"], _held(
                    [out, sc], [rows, sc_want], f"X2 {cell} op {k}"))
            sc = scalars.clone()
            plain = SX.shard_exchange_plain(tables, scalars, buf[k])
            stats, out = sentinel(n_g, SX.N_STATS), sentinel(n_g, 1, OP_WIDTH)
            SX.shard_exchange(tables, sc, buf, k, stats=stats, out=out,
                              acc=acc)
            accumulators_reset("shard_exchange")
            err["X12_shard_exchange"] = max(err["X12_shard_exchange"], _held(
                [stats, out, sc], list(plain),
                f"shard_exchange {cell} op {k}"))
    stats = SX.shard_stats_plain(tables, scalars, ops[0])
    sc = scalars.clone()
    rows_out = torch.empty((n_g, 1, OP_WIDTH), **i32)
    stats_out = torch.empty_like(stats)
    timed = {
        "X1_shard_stats": (
            lambda: SX.shard_stats(tables, scalars, ops, 0, out=stats_out,
                                   acc=acc),
            lambda: SX.shard_stats_plain(tables, scalars, ops[0])),
        "X2_shard_resolve": (
            lambda: SX.shard_resolve(stats, ops, 0, ar, ar, sc,
                                     out=rows_out),
            lambda: SX.shard_resolve_plain(stats, ops[0], ar, ar, sc)),
        "X12_shard_exchange": (
            lambda: SX.shard_exchange(tables, sc, ops, 0, stats=stats_out,
                                      out=rows_out, acc=acc),
            lambda: SX.shard_exchange_plain(tables, sc, ops[0])),
    }
    bounds = dict(zip(timed, exchange_bound_bytes(tables, scalars)))
    all_rows = dict(zip(timed, exchange_bound_bytes(tables)))
    rows = []
    for name, (fn, plain) in timed.items():
        row = dict(kernel=name, cell=cell, shards=n_g, cap=tables.shape[2],
                   live_rows=int(scalars[:, K1.SC_COUNT].sum()),
                   ops=ops.shape[0], max_abs_err=err[name],
                   ms=None, profiler_ms=None, event_ms=None, plain_ms=None,
                   bound_ms=bounds[name] / HBM_BYTES_PER_S * 1e3,
                   all_rows_bound_ms=all_rows[name] / HBM_BYTES_PER_S * 1e3)
        if reps:
            # ms: a launch's device time, launched back to back (CUDA
            # events); profiler_ms: the profiler's median kernel time
            # (None where it records no device activity); event_ms: one
            # call between CUDA events, the host's launch cost included.
            row.update(ms=_queued_ms(dev, fn),
                       profiler_ms=_device_ms(dev, fn, reps,
                                              SHARD_KERNELS[name]["kernel"]),
                       event_ms=_event_ms(dev, fn, reps),
                       plain_ms=_event_ms(dev, plain, plain_reps))
            print(f"{cell} {name} at {n_g} x {tables.shape[2]:,} "
                  f"({row['live_rows']:,} rows below count): exact over "
                  f"{ops.shape[0]} ops, {row['ms']:.4f} ms a launch on the "
                  f"device (profiler {row['profiler_ms']}), "
                  f"{row['event_ms']:.4f} ms a call (plain "
                  f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.5f} "
                  f"ms, all rows {row['all_rows_bound_ms']:.5f})",
                  flush=True)
        rows.append(row)
    accumulators_reset("timed launches")
    return rows


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


def mesh_9c(device, window=1000, frame_ops=SHARDED_FRAME_OPS,
            target_rows=80_000,
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
    exchange_post = read_shard_counts()
    ops_post = ops_total - promoted_at
    # K1 and K2 ran on the tiers the routing names for one launch of the
    # device's shards (K1 on the split tier below one shard an SM).
    routed = {k: _cuda.tier(sharded.shard_cap, KERNELS[k]["entry"],
                            sharded.n_shards)
              for k in ("K1_merge_apply", "K2_zamboni_compact")}
    for kname, tier in routed.items():
        c = launches_post[kname]
        if device.type == "cuda" and (c["all"] <= 0 or c[tier] != c["all"]):
            raise AssertionError(f"9c: {kname} after promotion {c}, not "
                                 f"all on the {tier} tier")
    # One device group: every op the one-launch exchange, X1 and X2 never.
    for name, c in exchange_post.items():
        if device.type == "cuda" and (c > 0) != (name == ONE_GROUP_EXCHANGE):
            raise AssertionError(f"9c: {name} launched {c} times after "
                                 "promotion")
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
    # One op's launches by name and device time (torch.profiler), the
    # wrappers' counts over it, and its host wall with a synchronize. On
    # one device group an op is the exchange and K1 and nothing else.
    one = probe_rows[:1].copy()
    one[0, F_SEQ] += 64
    before = dict(read_shard_counts(), K1=K1.apply_ops_packed.launches)
    prof = _profile(device, lambda: probe.apply(one))
    after = dict(read_shard_counts(), K1=K1.apply_ops_packed.launches)
    prof["kernel_launches"] = {n: after[n] - before[n] for n in after}
    names = " ".join(prof["kernels"])
    one_op = {n: int(n in ("K1", ONE_GROUP_EXCHANGE)) for n in after}
    if device.type == "cuda" and prof["kernel_launches"] != one_op or (
            prof["kernels"] and (sum(prof["kernels"].values()) != 2 or not
                                 all(k in names for k in (
                                     "shard_exchange_kernel",
                                     "merge_kernel<0")))):
        raise AssertionError(f"9c: one op launched {prof['kernels']} "
                             f"({prof['kernel_launches']})")
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
        outs = []
        err, ms, plain_ms = hold_kernel(kname, t0, s0, o1, scalars_out=outs)
        holds.append(dict(
            kernel=kname, cell="9c", docs=sharded.n_shards,
            cap=sharded.shard_cap, k=1, tier=routed[kname], max_abs_err=err,
            ms=ms,
            plain_ms=plain_ms,
            bound_ms=live_bound_bytes(kname, s0, sharded.shard_cap, o1,
                                      outs[0])
            / HBM_BYTES_PER_S * 1e3,
            all_rows_bound_ms=bound_bytes(kname, sharded.n_shards,
                                          sharded.shard_cap, 1)
            / HBM_BYTES_PER_S * 1e3))
    # X1, X2 and the exchange against their plain versions at the sharded
    # shape, on the document's state and eight ops of the probe's frame.
    xholds = hold_exchange(device, g.tables, g.scalars,
                           torch.from_numpy(probe_rows[:8]).to(device), "9c")
    del t0, s0, probe
    out = dict(
        ops_total=ops_total, promoted_at_ops=promoted_at,
        live_rows=rows, shard_rows=[int(c) for c in sharded.state.count],
        ops_per_s_after_promotion=ops_post / wall_post,
        ms_per_op_after_promotion=wall_post / ops_post * 1e3,
        apply_ms_per_op=apply_wall[0] / max(apply_wall[1], 1) * 1e3,
        launches_before_promotion=launches_pre,
        launches_after_promotion=launches_post,
        exchange_launches=exchange_post,
        launches_per_op={**{n: c["all"] / ops_post
                            for n, c in launches_post.items()},
                         **{n: c / ops_post
                            for n, c in exchange_post.items()}},
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
          f"activities, kernels (µs) {prof['kernel_us']}, wrapper launches "
          f"{prof['kernel_launches']}, {prof['device_us']:.1f} µs busy, "
          f"{prof['aten_ops']} ATen ops {prof['aten_names']}, "
          f"{op_wall_ms:.3f} ms synced", flush=True)
    del svc, be, sharded
    torch.cuda.empty_cache()
    return out, holds, xholds


# The stats 9c's one-card run holds equal to its plain twin's.
ONE_CARD_STATS = ("channels", "ops_applied", "docs_with_errors",
                  "sharded_docs", "sharded_rows", "promotions_refused")


def one_card_frame(rng, n: int, seq0: int, length: int, msn_lag: int = 64):
    """``n`` sequenced rows from seq ``seq0`` on, every writer caught up:
    70% inserts of 1-4 characters, 15% removes of 1-2 and 15% annotates of
    1-6, at random positions across the whole document of ``length``
    visible characters; the collab window ``msn_lag`` seqs behind. Returns
    (rows, the length after them)."""
    rows = []
    for i in range(n):
        s = seq0 + i
        msn = max(0, s - msn_lag)
        r = rng.random()
        if r < 0.7 or length < 8:
            k = int(rng.integers(1, 5))
            rows.append(E.insert(int(rng.integers(0, length + 1)),
                                 10**6 + s, k, seq=s, ref=s - 1,
                                 client=int(rng.integers(0, 4)), msn=msn))
            length += k
        elif r < 0.85:
            a = int(rng.integers(0, length - 2))
            b = a + int(rng.integers(1, 3))
            rows.append(E.remove(a, b, seq=s, ref=s - 1,
                                 client=int(rng.integers(0, 4)), msn=msn))
            length -= b - a
        else:
            a = int(rng.integers(0, length - 6))
            rows.append(E.annotate(a, a + int(rng.integers(1, 7)),
                                   int(rng.integers(1, 9)), seq=s,
                                   ref=s - 1, client=int(rng.integers(0, 4)),
                                   msn=msn))
    return np.stack(rows).astype(np.int32), length


def mesh_9c_one_entry(device, visible, cap=65536, n0=65_000, first_ops=256,
                      frame_ops=512, min_frames=2) -> dict:
    """9c on the list of every visible card. With one card the backend's
    overflow promotion asks for 8 x ``cap`` rows in one shard, as the
    reference's one-device mesh does, and the kernels' split tier takes
    it: a document of ``n0`` distinct rows placed in its top-tier slot
    (``config/config.json``'s 65,536 rows) takes a first frame of
    ``first_ops``, is promoted at the scan after it into a one-shard
    ShardedDoc of 8 x ``cap`` rows, then takes frames of ``frame_ops``
    (:func:`one_card_frame`) until it holds more than ``cap`` live rows,
    at least ``min_frames`` of them. A twin backend with
    ``kernel="plain"`` on the card takes the same frames: their reports,
    lanes (the fleet slot's, then the shard's) and stats are equal after
    every frame; nothing is refused or errored. K1 and K2 are held against
    their plain versions at the shard's shape, K1's time being its time an
    op. With more cards the shard is smaller and nothing is refused."""
    from fluidframework_tpu_torch.interop import (
        mesh_state_to_numpy,
        segment_state_to_numpy,
    )
    from fluidframework_tpu_torch.parallel import mesh as M
    from fluidframework_tpu_torch.parallel.sharded_doc import check_shard_cap

    shard_cap = -(-8 * cap // len(visible))
    check_shard_cap(shard_cap, "auto", visible)
    if len(visible) > 1:
        return dict(cards=len(visible), shard_cap=shard_cap)
    t_start = time.perf_counter()
    bes = []
    for kernel in ("auto", "plain"):
        be = DeviceFleetBackend(capacity=cap, max_capacity=cap,
                                compact_every=1, sharded_overflow=True,
                                kernel=kernel, device=device)
        idx = be.ensure("one", "s")
        be.fleet.evict_doc(idx)
        be.fleet.restore_doc(idx, _overflow_state(n0, cap))
        bes.append(be)
    be, twin = bes
    idx = be._index[("one", "s")]

    def lanes(b):
        if idx in b._sharded:
            return list(mesh_state_to_numpy(b._sharded[idx]))
        return list(segment_state_to_numpy(b.fleet.doc_state(idx)))

    rng = np.random.default_rng(11)
    seq, length, frames, promoted_at = n0, n0, 0, None
    apply_s, ops_after = 0.0, 0
    launches = {}
    M.set_devices(visible)
    reset_counts()
    try:
        while True:
            rows_now = (be._sharded[idx].rows_in_use() if idx in be._sharded
                        else 0)
            if rows_now > cap and frames >= min_frames:
                break
            if seq - n0 > 16 * frame_ops:
                raise AssertionError(f"9c one card: {rows_now} live rows "
                                     f"after {seq - n0} ops")
            n = first_ops if promoted_at is None else frame_ops
            rows, length = one_card_frame(rng, n, seq + 1, length)
            got = []
            for b in (be, twin):
                t = time.perf_counter()
                b.enqueue_frame("one", SeqFrame("s", 0, seq + 1, rows, (),
                                                0.0))
                got.append(b.flush() + b.collect_now())
                if b is be and promoted_at is not None:
                    _sync(device)
                    apply_s += time.perf_counter() - t
            if promoted_at is not None:
                ops_after += n
                frames += 1
            seq += n
            if got[0] != got[1] or got[0]:
                raise AssertionError(f"9c one card: reports {got}")
            _same_lanes(lanes(be), lanes(twin), "9c one card vs plain")
            st, st_twin = ({k: b.stats()[k] for k in ONE_CARD_STATS}
                           for b in (be, twin))
            if st != st_twin:
                raise AssertionError(f"9c one card: stats {st} != {st_twin}")
            if promoted_at is None and idx in be._sharded:
                promoted_at = seq - n0
                launches["before_promotion"] = read_counts()
                reset_counts()
                doc = be._sharded[idx]
                if doc.n_shards != 1 or doc.shard_cap != shard_cap:
                    raise AssertionError(f"9c one card: {doc.n_shards} x "
                                         f"{doc.shard_cap}")
                print(f"9c one card: promoted at the scan after the first "
                      f"{promoted_at} ops into 1 x {doc.shard_cap} rows",
                      flush=True)
        launches["after_promotion"] = read_counts()
        exchange = read_shard_counts()
    finally:
        M.set_devices([device] * 8)
    after = launches["after_promotion"]
    for kname in ("K1_merge_apply", "K2_zamboni_compact"):
        c = after[kname]
        if c["all"] <= 0 or c["split"] != c["all"]:
            raise AssertionError(f"9c one card: {kname} after promotion "
                                 f"{c}, not all on the split tier")
    # One device group: every op the one-launch exchange, X1 and X2 never.
    for name, c in exchange.items():
        if device.type == "cuda" and (c > 0) != (name == ONE_GROUP_EXCHANGE):
            raise AssertionError(f"9c one card: {name} launched {c} times "
                                 "after promotion")
    st = be.stats()
    if (st["sharded_docs"] != 1 or st["promotions_refused"] != 0
            or st["docs_with_errors"] != 0 or promoted_at != first_ops):
        raise AssertionError(f"9c one card: promoted at {promoted_at}, "
                             f"stats {st}")
    doc = be._sharded[idx]
    live = doc.rows_in_use()
    # K1 (one insert, K 1: its time is the time an op) and K2 against their
    # plain versions at the shard's shape.
    g = doc._groups[0]
    t0, s0 = g.tables.clone(), g.scalars.clone()
    o1 = torch.from_numpy(one_card_frame(rng, 1, seq + 1, length)[0][None])
    o1 = o1.to(device)
    holds = []
    for kname in ("K1_merge_apply", "K2_zamboni_compact"):
        outs = []
        err, ms, plain_ms = hold_kernel(kname, t0, s0, o1, scalars_out=outs)
        holds.append(dict(
            kernel=kname, cell="9c one card", docs=1, cap=shard_cap, k=1,
            tier=_cuda.tier(shard_cap, KERNELS[kname]["entry"], 1),
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=live_bound_bytes(kname, s0, shard_cap, o1, outs[0])
            / HBM_BYTES_PER_S * 1e3,
            all_rows_bound_ms=bound_bytes(kname, 1, shard_cap, 1)
            / HBM_BYTES_PER_S * 1e3))
    xops = torch.from_numpy(one_card_frame(rng, 8, seq + 2, length)[0])
    xholds = hold_exchange(device, g.tables, g.scalars, xops.to(device),
                           "9c one card")
    del t0, s0, bes, be, twin, doc, g
    torch.cuda.empty_cache()
    out = dict(cards=1, shard_cap=shard_cap, rows_at_start=n0, promoted_at_ops=promoted_at,
               live_rows=live, ops=seq - n0, frames_after_promotion=frames,
               ops_per_s_after_promotion=ops_after / apply_s,
               launches=launches, exchange_launches=exchange,
               k1_ms_per_op=holds[0]["ms"],
               wall_s=time.perf_counter() - t_start, holds=holds,
               exchange_holds=xholds,
               stats=dict(sharded_docs=st["sharded_docs"],
                          promotions_refused=st["promotions_refused"],
                          docs_with_errors=st["docs_with_errors"]))
    print(f"9c one card [{visible[0]}]: {n0} rows, promoted after "
          f"{promoted_at} ops into 1 x {shard_cap} rows, {frames} frames "
          f"of {frame_ops} ops after it to {live} live rows; "
          f"{out['ops_per_s_after_promotion']:,.0f} ops/s after promotion; "
          f"== the plain twin at every frame; launches by tier after "
          f"promotion { {n: c for n, c in after.items() if c['all']} }, "
          f"{exchange}; K1 "
          f"{holds[0]['ms']:.4f} ms an op at 1 x {shard_cap} (plain "
          f"{holds[0]['plain_ms']:.3f} ms, bound {holds[0]['bound_ms']:.5f} "
          f"ms); {out['wall_s']:.1f} s", flush=True)
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
        r9c, holds_c, xholds = mesh_9c(device)
        wall["9c"] = time.perf_counter() - t
        t = time.perf_counter()
        r9c["one_entry"] = one = mesh_9c_one_entry(device, visible)
        wall["9c_one_card"] = time.perf_counter() - t
        holds_c = holds_c + one.get("holds", [])
        xholds = xholds + one.get("exchange_holds", [])
        t = time.perf_counter()
        r9d = mesh_9d()
        wall["9d"] = time.perf_counter() - t
    finally:
        M.set_devices(None)
    mesh_launches = _sum_counts(r9a["8x"]["launches"],
                                r9a["visible"]["launches"],
                                r9b["mesh_pump"]["launches"],
                                r9b["mesh_oneshot"]["launches"])
    sharded_launches = _sum_counts(
        r9c["launches_before_promotion"], r9c["launches_after_promotion"],
        *one.get("launches", {}).values())
    for name in ("K1_merge_apply", "K2_zamboni_compact"):
        for path, c in (("mesh", mesh_launches),
                        ("sharded", sharded_launches)):
            if c[name]["all"] <= 0:
                raise AssertionError(f"{name} never launched on the {path} "
                                     "path")
    exchange = dict(launches={"9c": r9c["exchange_launches"],
                              "9c_one_card": one.get(
                                  "exchange_launches",
                                  dict.fromkeys(SHARD_KERNELS, 0))},
                    holds=xholds)
    print(f"9 wall s: { {k: round(v, 1) for k, v in wall.items()} }",
          flush=True)
    report["phase_mesh"] = dict(fleet=r9a, serving=r9b, sharded=r9c,
                                multinode=r9d, holds=holds + holds_c,
                                exchange_holds=xholds, wall_s=wall)
    return dict(mesh=mesh_launches, sharded=sharded_launches,
                holds=holds + holds_c, exchange=exchange)


# -- phase 10: the oracle, the load harness and the other DDS models ---------

# (rows S, docs D) of 10a: the shared tier and the cluster tier, 96 ops a
# document (bench.py's device_state_parity at larger sizes).
ORACLE_SHAPES = ((256, 4096), (4096, 256))
ORACLE_OPS = 96
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
        outs = []
        err, ms, plain_ms = hold_kernel(name, tt, ss, oo, scalars_out=outs)
        b = live_bound_bytes(name, ss, cap, oo, outs[0])
        b_all = bound_bytes(name, n_docs, cap, half)
        holds.append(dict(kernel=name, cell=f"10a S={cap}",
                          tier=_cuda.tier(cap, KERNELS[name]["entry"],
                                          n_docs),
                          docs=n_docs, cap=cap, k=half, max_abs_err=err,
                          ms=ms, plain_ms=plain_ms,
                          bound_ms=b / HBM_BYTES_PER_S * 1e3,
                          all_rows_bound_ms=b_all / HBM_BYTES_PER_S * 1e3,
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
        reset_tree_counts()
        with UtilSampler() as util:
            rep, state, wall = load_run(device, profile, 4, exact=True)
        torch.cuda.synchronize()
        launches = read_counts()
        tree_launches = read_tree_counts()
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
            tree_launches=tree_launches,
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
              f", K2 {launches['K2_zamboni_compact']['all']}, T2 "
              f"{tree_launches['T2_em_ring_scan']['all']}; card busy {busy} "
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
    return dict(launches=launches, holds=holds,
                tree_launches=r10b["tree_launches"])


# -- phase 11: the framework layer, the hierarchy trees and the drivers ----------

FRAMEWORK_OPS = 10_000  # config 1's string stream, not cut
FRAMEWORK_EDIT_EVERY = 32  # one map/directory/tree/scheduler edit per 32
FRAMEWORK_TAIL = 512  # string ops after the summary 11c loads
FRAMEWORK_POINTS = 16_384


class _CounterClock:
    """``time.time`` of the sequencer from a counter: the card run and its
    CPU twin stamp the same timestamps (the attributor records them)."""

    def __init__(self):
        self.t = 1_700_000_000.0

    def time(self):
        self.t += 0.001
        return self.t


def framework_schema():
    """11a's container: the merge-tree string, a map, both hierarchy
    trees and the agent scheduler; SharedString also as a dynamic type."""
    from fluidframework_tpu_torch.framework.agent_scheduler import (
        AgentScheduler,
    )
    from fluidframework_tpu_torch.framework.fluid_static import (
        ContainerSchema,
    )
    from fluidframework_tpu_torch.models.shared_map import SharedMap
    from fluidframework_tpu_torch.models.shared_string import SharedString
    from fluidframework_tpu_torch.tree.hierarchical_tree import (
        HierarchicalTree,
    )
    from fluidframework_tpu_torch.tree.legacy_tree import LegacySharedTree

    return ContainerSchema(
        initial_objects={"text": SharedString, "map": SharedMap,
                         "tree": HierarchicalTree,
                         "legacy": LegacySharedTree,
                         "scheduler": AgentScheduler},
        dynamic_object_types=(SharedString,))


def _side_edit(k, c, board, dyn, rng, i, own_edits) -> None:
    """One map, directory, tree, legacy-tree, scheduler or dynamic-string
    edit by client ``k`` (``c`` its container, ``board`` its data object)."""
    o = c.initial_objects
    r = rng.random()
    if r < 0.2:
        o["map"].set(f"k{int(rng.integers(0, 12))}", i)
    elif r < 0.4:
        d = board.root if rng.random() < 0.5 else \
            board.root.get_subdirectory("ws")
        d.set(f"d{int(rng.integers(0, 8))}", [k, i])
    elif r < 0.6:
        items = o["tree"].root["items"]
        if len(items) < 6 or rng.random() < 0.4:
            items.append({"type": "item", "value": i})
        elif rng.random() < 0.7:
            items[int(rng.integers(0, len(items)))].value = i
        else:
            o["tree"].move_node(items[int(rng.integers(0, len(items)))]
                                .node_id, 0, "done", 0)
    elif r < 0.75:
        lt = o["legacy"]
        kids = lt.children(0, "kids")
        done = [e for e in own_edits if e in lt.edit_log._by_id]
        if done and rng.random() < 0.15:
            lt.undo(done[int(rng.integers(0, len(done)))])
        elif kids and rng.random() < 0.5:
            own_edits.append(lt.apply_edit({
                "k": "val", "id": kids[int(rng.integers(0, len(kids)))],
                "value": i}))
        else:
            lt.insert_node(0, "kids", {"type": "n", "value": i})
    elif r < 0.9:
        task = f"task{int(rng.integers(0, 3))}"
        if rng.random() < 0.7:
            o["scheduler"].pick(task)
        else:
            o["scheduler"].release(task)
    else:
        dyn.insert_text(int(rng.integers(0, len(dyn.get_text()) + 1)), "z")


def _pump(rts) -> None:
    for rt in rts:
        rt.flush()
    for rt in rts:
        rt.process_incoming()


def _drain(rts) -> None:
    for rt in rts:
        rt.flush()
    while any(rt.process_incoming() for rt in rts):
        pass


def _dir_digest(d: str) -> dict:
    """{relative path: sha256} of every file under ``d``."""
    import hashlib

    out = {}
    for root, _dirs, files in os.walk(d):
        for name in files:
            p = os.path.join(root, name)
            with open(p, "rb") as f:
                out[os.path.relpath(p, d)] = hashlib.sha256(
                    f.read()).hexdigest()
    return out


def framework_script(device, n_ops=FRAMEWORK_OPS, tail=FRAMEWORK_TAIL,
                     keep=None, after_11a=None):
    """11a and 11c on ``device`` (the card run and its CPU twin run this
    alike; the sequencer's clock is a counter). Returns what the two are
    compared on; ``keep`` (a dict) receives the live objects of the card
    run, and ``after_11a()`` runs between 11a and 11c.

    11a: ``TpuFluidClient(device=)`` creates one document of
    :func:`framework_schema`; two more clients open it with
    ``get_container``; a ``DataObject`` through
    ``ContainerRuntimeFactoryWithDefaultDataStore(device=)`` lives in a
    second document on the same service, on three runtimes. The three
    clients author config 1's stream (``config1_single_doc_replay``: seed
    0, 45% removes of 1-2 chars, 2-char inserts; op ``i`` by client ``i %
    3`` on its own view, all pumped every 16 ops) and, every
    ``FRAMEWORK_EDIT_EVERY`` ops, a map, directory, tree, legacy-tree,
    scheduler or dynamic-string edit; ``tail`` string ops before the end
    client 1 summarizes (after a drain). ``mixin_attributor``, an
    ``OldestClientObserver`` on each runtime and interception wrappers (the
    map of client 1, the string of client 3) run over the whole stream.

    11c: a read-mode runtime loads the live document (summary + tail),
    then ``save_document`` / ``load_document`` and a read-mode runtime
    over ``as_replay_service()`` on ``device``, which must equal it lane
    for lane; ``encode_snapshot`` of client 1's summary round-trips; a paused
    ``DebuggerFluidService`` reader is stepped to 3 checkpoints of the
    tail, each equal to a file replay to that seq; a
    ``CachingFluidService`` cold load and snapshot, 48 more ops, then a
    warm load from the cache directory that fetches only the ops past the
    cached head."""
    import tempfile

    from fluidframework_tpu_torch.drivers.binary_snapshot import (
        decode_snapshot,
        encode_snapshot,
    )
    from fluidframework_tpu_torch.drivers.caching_driver import (
        CachingFluidService,
        PersistentCache,
    )
    from fluidframework_tpu_torch.drivers.debugger_driver import (
        DebuggerController,
        DebuggerFluidService,
    )
    from fluidframework_tpu_torch.drivers.file_driver import (
        load_document,
        save_document,
    )
    from fluidframework_tpu_torch.framework.attributor import (
        mixin_attributor,
    )
    from fluidframework_tpu_torch.framework.client import TpuFluidClient
    from fluidframework_tpu_torch.framework.data_object import (
        ContainerRuntimeFactoryWithDefaultDataStore,
        DataObject,
        DataObjectFactory,
    )
    from fluidframework_tpu_torch.framework.fluid_static import (
        FluidContainer,
        build_root_datastore,
        schema_type_registry,
    )
    from fluidframework_tpu_torch.framework.helpers import (
        OldestClientObserver,
    )
    from fluidframework_tpu_torch.framework.interceptions import (
        create_shared_map_with_interception,
        create_shared_string_with_interception,
    )
    from fluidframework_tpu_torch.interop import segment_state_to_numpy
    from fluidframework_tpu_torch.models.shared_string import SharedString
    from fluidframework_tpu_torch.runtime.container import ContainerRuntime
    from fluidframework_tpu_torch.service import sequencer

    saved_time = sequencer.time
    sequencer.time = _CounterClock()
    try:
        schema = framework_schema()
        client = TpuFluidClient(device=device)
        svc = client.service
        c1, doc_id = client.create_container(schema, doc_id="framework")
        cs = [c1] + [client.get_container(doc_id, schema) for _ in range(2)]
        factory = ContainerRuntimeFactoryWithDefaultDataStore(
            DataObjectFactory("board", DataObject), device=device)
        boards = [factory.instantiate(svc, "framework-board",
                                      existing=i > 0) for i in range(3)]
        rts = [c.runtime for c in cs] + [rt for rt, _ in boards]
        boards = [b for _, b in boards]
        boards[0].root.create_subdirectory("ws")
        dyn = c1.create(SharedString)
        dyn.insert_text(0, "dynamic")
        c1.initial_objects["map"].set("dyn", c1.handle_of(dyn))
        _drain(rts)
        dyns = [c.resolve_handle(c.initial_objects["map"].get("dyn"))
                for c in cs]
        attributor = mixin_attributor(cs[1].runtime)
        observers = [OldestClientObserver(c.runtime) for c in cs]
        events = [[] for _ in cs]
        for o, ev in zip(observers, events):
            o.on_change(ev.append)
        stamped = [0, 0]

        def stamp_map(contents):
            stamped[0] += 1
            return {"stamp": "c1"}

        def stamp_text(contents):
            if contents.get("k") != "ins":
                return {}
            stamped[1] += 1
            return {"stamp": "c3"}

        create_shared_map_with_interception(c1.initial_objects["map"],
                                            stamp_map)
        create_shared_string_with_interception(cs[2].initial_objects["text"],
                                               stamp_text)
        texts = [c.initial_objects["text"] for c in cs]
        rng = np.random.default_rng(0)  # config 1's draws
        side = np.random.default_rng(11)
        own_edits = [[] for _ in cs]
        summary_at = max(0, n_ops - tail)
        summary_seq = 0
        t0 = time.perf_counter()
        for i in range(n_ops):
            k = i % 3
            s = texts[k]
            length = len(s.get_text())
            if length > 8 and rng.random() < 0.45:
                a = int(rng.integers(0, length - 2))
                s.remove_range(a, a + int(rng.integers(1, 3)))
            else:
                s.insert_text(int(rng.integers(0, length + 1)), "ab")
            if i % FRAMEWORK_EDIT_EVERY == 0:
                _side_edit(k, cs[k], boards[k], dyns[k], side, i,
                           own_edits[k])
            if i % 16 == 0:
                _pump(rts)
            if i == summary_at:
                _drain(rts)
                c1.runtime.submit_summary()
                _drain(rts)
                summary_seq = svc.docs[doc_id].latest_summary[1]
        _drain(rts)
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall_11a = time.perf_counter() - t0
        n_msgs = len(svc.get_deltas(doc_id))
        for name, got in (
                ("texts", [x.get_text() for x in texts]),
                ("dynamic texts", [x.get_text() for x in dyns]),
                ("maps", [sorted(c.initial_objects["map"].items())
                          for c in cs]),
                ("directories", [json.dumps(b.root.summarize_core(),
                                            sort_keys=True)
                                 for b in boards]),
                ("trees", [json.dumps(c.initial_objects["tree"].root
                                      .as_data(), sort_keys=True)
                           for c in cs]),
                ("legacy trees", [(json.dumps(
                    c.initial_objects["legacy"].current_view(),
                    sort_keys=True), len(c.initial_objects["legacy"]
                                         .edit_log)) for c in cs]),
                ("scheduler", [json.dumps(
                    c.initial_objects["scheduler"].summarize_core(),
                    sort_keys=True) for c in cs])):
            if any(x != got[0] for x in got):
                raise AssertionError(f"11a: replicas did not converge on "
                                     f"{name}")
        obs = dict(
            text=texts[0].get_text(), dyn=dyns[0].get_text(),
            lanes=[segment_state_to_numpy(x._state) for x in texts + dyns],
            map=repr(sorted(c1.initial_objects["map"].items())),
            directory=json.dumps(boards[0].root.summarize_core(),
                                 sort_keys=True),
            tree=json.dumps(c1.initial_objects["tree"].root.as_data(),
                            sort_keys=True),
            legacy=json.dumps(c1.initial_objects["legacy"]
                              .summarize_core(), sort_keys=True),
            scheduler=json.dumps(c1.initial_objects["scheduler"]
                                 .summarize_core(), sort_keys=True),
            attributor=attributor.serialize(),
            oldest=[o.is_oldest for o in observers], oldest_events=events,
            stamped=list(stamped), msgs=n_msgs, summary_seq=summary_seq)
        if keep is not None:
            keep.update(texts=texts, wall_11a=wall_11a)
        if after_11a is not None:
            after_11a()

        # -- 11c: the drivers over 11a's document ---------------------------
        t0 = time.perf_counter()

        def reader(service, mode="read"):
            rt = ContainerRuntime(
                service, doc_id,
                channels=(build_root_datastore(schema, device),),
                channel_types=schema_type_registry(schema, device),
                mode=mode)
            return FluidContainer(rt, schema, device=device)

        def lanes_of(c):
            return segment_state_to_numpy(c.initial_objects["text"]._state)

        def same_doc(a, b, what):
            """Every lane and scalar equal but ``self_client``, the
            loader's own slot (a replay reads as client -2)."""
            x, y = list(lanes_of(a)), list(lanes_of(b))
            x[len(SEGMENT_LANES) + 3] = y[len(SEGMENT_LANES) + 3]
            _lanes_equal(x, y, what)

        with tempfile.TemporaryDirectory() as work:
            live = reader(svc)  # a live loader, read-only as the replay
            _drain(rts + [live.runtime])
            save_dir = os.path.join(work, "saved")
            save_document(svc, doc_id, save_dir)
            fds = load_document(save_dir, doc_id=doc_id)
            replayed = reader(fds.as_replay_service())
            if replayed.initial_objects["text"].get_text() != obs["text"]:
                raise AssertionError("11c: file replay text != the live "
                                     "document's")
            same_doc(replayed, live, "11c file replay vs a live loader")
            for key in ("map", "tree", "legacy"):
                a, b = (c.initial_objects[key].summarize_core()
                        for c in (replayed, live))
                if a != b:
                    raise AssertionError(f"11c: file replay {key} != live")
            summary = c1.runtime.summarize()
            blob = encode_snapshot(summary)
            if decode_snapshot(blob) != json.loads(json.dumps(summary)):
                raise AssertionError("11c: encode_snapshot did not "
                                     "round-trip the summary")
            # The debugger: a paused reader stepped through the tail.
            tail_n = sum(1 for m in fds.ops
                         if m.sequence_number > summary_seq)
            ctl = DebuggerController()
            ctl.pause()
            stepped = reader(DebuggerFluidService(svc, ctl))
            checkpoints, released = [], 0
            for j in (1, 2, 3):
                target = tail_n * j // 3
                ctl.step(target - released)
                stepped.runtime.process_incoming()
                released = target
                seq = stepped.runtime.ref_seq
                at = reader(fds.as_replay_service(replay_to=seq))
                got = stepped.initial_objects["text"].get_text()
                if got != at.initial_objects["text"].get_text():
                    raise AssertionError(f"11c: debugger text at seq {seq} "
                                         "!= the replay to it")
                same_doc(stepped, at, f"11c debugger vs replay at {seq}")
                checkpoints.append((seq, len(got)))
            # The caching driver: cold load, snapshot, 48 more ops, warm.
            fetched = []
            inner_connect = svc.connect

            def recording_connect(doc, mode="write", from_seq=0, **kw):
                conn = inner_connect(doc, mode, from_seq=from_seq, **kw)
                fetched.append((from_seq, len(conn.inbox)))
                return conn

            svc.connect = recording_connect
            try:
                cache_dir = os.path.join(work, "cache")
                cold = CachingFluidService(svc, PersistentCache(cache_dir))
                cold_c = reader(cold)
                cold.snapshot_to_cache(
                    doc_id, initial_summary=svc.docs[doc_id].latest_summary)
                head = cold.cache.get_doc(doc_id)["head"]
                for j in range(48):
                    t = texts[1]
                    t.insert_text(int(rng.integers(0, len(t.get_text())
                                                   + 1)), "c")
                    if j % 16 == 15:
                        _pump(rts)
                _drain(rts + [live.runtime])
                warm = CachingFluidService(svc, PersistentCache(cache_dir))
                warm_c = reader(warm)
            finally:
                del svc.connect
            past_head = sum(1 for m in svc.get_deltas(doc_id)
                            if m.sequence_number > head) - 1  # its own join
            if fetched[-1] != (head, past_head + 1):
                raise AssertionError(f"11c: the warm load fetched "
                                     f"{fetched[-1]}, expected ops past the "
                                     f"cached head {head} only")
            want = texts[0].get_text()
            for name, c in (("cold", cold_c), ("warm", warm_c)):
                c.runtime.process_incoming()
                if c.initial_objects["text"].get_text() != want:
                    raise AssertionError(f"11c: {name} cache load text != "
                                         "live")
            obs.update(
                snapshot=blob, saved=_dir_digest(save_dir),
                cache_files=_dir_digest(cache_dir),
                replayed_lanes=lanes_of(replayed), checkpoints=checkpoints,
                cold_stats=dict(cold.stats), warm_stats=dict(warm.stats),
                fetched=fetched, tail_msgs=tail_n,
                final_text=want)
        if keep is not None:
            keep.update(wall_11c=time.perf_counter() - t0,
                        snapshot_bytes=len(blob))
        return obs
    finally:
        sequencer.time = saved_time


def _framework_cpu_twin(n_ops=FRAMEWORK_OPS, tail=FRAMEWORK_TAIL):
    """11a and 11c on the CPU, in a process of its own (one torch
    thread): (observations, wall s)."""
    torch.set_num_threads(1)
    t = time.perf_counter()
    obs = framework_script(torch.device("cpu"), n_ops, tail)
    return obs, time.perf_counter() - t


def start_framework_twin(n_ops=FRAMEWORK_OPS, tail=FRAMEWORK_TAIL):
    """Start 11a/11c's CPU twin in a spawned process; it needs no card, so
    the full smoke starts it after phase 6 and collects it in phase 11.
    Returns (pool, future)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    pool = ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    return pool, pool.submit(_framework_cpu_twin, n_ops, tail)


def stop_framework_twin(twin) -> None:
    """End the twin's process at once (a failed run does not wait for
    it)."""
    pool, fut = twin
    fut.cancel()
    for proc in list((getattr(pool, "_processes", None) or {}).values()):
        proc.terminate()
    pool.shutdown(wait=True, cancel_futures=True)


def _same_obs(card: dict, cpu: dict, what: str) -> None:
    for key, a in card.items():
        b = cpu[key]
        if key in ("lanes",):
            for i, (x, y) in enumerate(zip(a, b)):
                _lanes_equal(x, y, f"{what} {key}[{i}] card vs CPU")
        elif key == "replayed_lanes":
            _lanes_equal(a, b, f"{what} {key} card vs CPU")
        elif a != b:
            raise AssertionError(f"{what}: {key} card != CPU")


def framework_11b(device, n_points=FRAMEWORK_POINTS) -> dict:
    """11b: a ``HierarchicalTree`` field of ``n_points`` uniform ``point``
    nodes (an integer ``x``, a float ``y``), authored through a runtime in
    runs of 2,048; ``chunk_field`` gives one ``UniformChunk``; ``to_device``
    puts each column on the card and on the CPU: dtype (the JAX rule,
    int32 / float32) and bytes equal; the integer column's sum on the card
    equals numpy's exactly. Transfer and sum timed with CUDA events."""
    from fluidframework_tpu_torch.runtime.container import ContainerRuntime
    from fluidframework_tpu_torch.service.local_server import (
        LocalFluidService,
    )
    from fluidframework_tpu_torch.tree.chunked import (
        UniformChunk,
        chunk_field,
        device_dtype,
    )
    from fluidframework_tpu_torch.tree.hierarchical_tree import (
        HierarchicalTree,
    )

    t0 = time.perf_counter()
    rt = ContainerRuntime(LocalFluidService(), "points",
                          channels=(HierarchicalTree("tree"),))
    tree = rt.get_channel("tree")
    # Runs of 2,048 points (6,144 node ids: a connection mints 16,384; a
    # reconnect refreshes them), last run first, each at the front of the
    # field (placement scans from the field's start for its anchor, so a
    # run costs its length squared, and each acked run reclones the view).
    step = 2048
    for lo in reversed(range(0, n_points, step)):
        tree.root["points"].insert(0, *[{
            "type": "point",
            "fields": {"x": [{"type": "num", "value": i * 7 - 3}],
                       "y": [{"type": "num", "value": i * 0.1}]},
        } for i in range(lo, min(n_points, lo + step))])
        _drain([rt])
        rt.disconnect()
        rt.reconnect()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    chunks = chunk_field(tree._view, 0, "points")
    chunk_s = time.perf_counter() - t0
    if len(chunks) != 1 or not isinstance(chunks[0], UniformChunk) \
            or chunks[0].count != n_points:
        raise AssertionError("11b: the field did not chunk as one run")
    ch = chunks[0]
    out = dict(points=n_points, build_s=build_s, chunk_s=chunk_s)
    for path, want_dtype in (("x[0]", np.int32), ("y[0]", np.float32)):
        col = ch.columns[path]
        card = ch.to_device(path, device)
        cpu = ch.to_device(path, "cpu")
        host = card.cpu().numpy()
        if device_dtype(col.dtype) != np.dtype(want_dtype) or \
                host.dtype != np.dtype(want_dtype) or \
                host.tobytes() != cpu.numpy().tobytes() or \
                host.tobytes() != col.astype(want_dtype).tobytes():
            raise AssertionError(f"11b: column {path} on the card != the "
                                 "CPU twin / the JAX dtype rule")
        copy_ms = _event_ms(device, lambda: ch.to_device(path, device))
        out[path] = dict(dtype=host.dtype.str, nbytes=host.nbytes,
                         to_device_ms=copy_ms)
        if path == "x[0]":
            total = int(card.sum())
            if total != int(col.sum()) or total != int(cpu.sum()):
                raise AssertionError("11b: the integer column's sum on the "
                                     "card != numpy's")
            out[path].update(sum=total, sum_ms=_event_ms(
                device, lambda: card.sum()))
    print(f"11b chunked forest: {n_points} points built in {build_s:.2f} s, "
          f"chunked in {chunk_s:.2f} s; columns x int32 / y float32 equal "
          f"to the CPU twin; to_device "
          f"{out['x[0]']['to_device_ms']:.4f} / "
          f"{out['y[0]']['to_device_ms']:.4f} ms, x sum "
          f"{out['x[0]']['sum']} in {out['x[0]']['sum_ms']:.4f} ms (exact)",
          flush=True)
    return out


def _record_em_dispatch(n_docs=4, wave=128):
    """7b's first dispatch at its own shapes: config 3c's stream
    (``em_stream``, 7b's seeds), one wave of ``wave`` commits through the
    production ``batch_ingest`` over fresh ``EditManager``s on the CPU.
    Returns ``((rings, mov_seq0, arrays, U), rows)``: the dispatch as
    ``_em_dispatch`` received it (host arrays) and the batched ring scan's
    rows it returned."""
    logs = [em_stream(1000 + i, wave) for i in range(n_docs)]
    ems = [TEM.EditManager(session=1, device="cpu") for _ in logs]
    real = TEM._em_dispatch
    recorded = []

    def record(rings, mov_seq0, arrays, U, device):
        out = real(rings, mov_seq0, arrays, U, device)
        recorded.append(((rings, mov_seq0, arrays, U), out))
        return out

    TEM._em_dispatch = record
    try:
        TEM.batch_ingest([(em, log, max(0, log[-1].seq - 8))
                          for em, log in zip(ems, logs)])
    finally:
        TEM._em_dispatch = real
    return recorded[0]


def framework_11d(device) -> dict:
    """11d: the thin functions of the public surface on the card against
    the same calls on the CPU, at the widths their paths give them:
    ``merge_kernel.perspective`` and ``insert_place_mask`` on a 4,096-row
    state; ``device_trunk.trunk_scan`` on a document of 7a's batch (its 64
    distinct scripts, Lc 128, Pc 32, W 16, the first 125 commits: the
    CPU side's plain loop is the cost) against the
    batched scan's row and the CPU (T1 on the card);
    ``device_em.em_trunk_scan_ring_one`` / ``em_trunk_scan_one`` on a
    document of 7b's first dispatch against the batched scans' rows on
    the CPU (T2 on the card); and
    ``sharded_doc.sharded_apply_ops`` at 9c's shard shape (8 x 65,536 rows
    on 8 x the card) against ``ShardedDoc.apply`` on the same ops."""
    from fluidframework_tpu_torch.ops import merge_kernel as MK
    from fluidframework_tpu_torch.parallel.mesh import Mesh
    from fluidframework_tpu_torch.parallel.sharded_doc import (
        ShardedDoc,
        sharded_apply_ops,
    )
    from fluidframework_tpu_torch.testing.fuzz import random_acked_stream
    from fluidframework_tpu_torch.testing.oracle import OracleDoc

    cpu = torch.device("cpu")
    checked = []
    shapes = {}
    part_s = {}

    def same(a, b, what):
        for i, (x, y) in enumerate(zip(a, b)):
            if not torch.equal(torch.as_tensor(x).cpu(),
                               torch.as_tensor(y).cpu()):
                raise AssertionError(f"11d: {what}[{i}] card != CPU")
        checked.append(what)

    # perspective / insert_place_mask on a 4,096-row state.
    t0 = time.perf_counter()
    with _Uncounted():
        t, s, ops = random_case(np.random.default_rng(4096), 1, 4096, 16,
                                device)
        K1.apply_ops_packed(t, s, ops)
    state = K1.unpack_state(t, s)
    state = type(state)(*[x[0] for x in state])
    cpu_state = type(state)(*[x.cpu() for x in state])
    top = int(state.cur_seq)
    for ref in (0, top // 2, top):
        for client in (0, 1, 5):
            for local in (False, True):
                got = MK.perspective(state, ref, client, local)
                want = MK.perspective(cpu_state, ref, client, local)
                same(got, want, f"perspective({ref}, {client}, {local})")
                op = ops[0, 0]
                rem = op[F_POS1] - K1.excl_cumsum(got[1])
                same([MK.insert_place_mask(state, op, *got, rem)],
                     [MK.insert_place_mask(cpu_state, op.cpu(), *want,
                                           rem.cpu())],
                     f"insert_place_mask({ref}, {client}, {local})")
    shapes["perspective"] = "4,096 rows"
    part_s["perspective"] = time.perf_counter() - t0
    # trunk_scan on a document of 7a's batch: its 64 distinct scripts (the
    # batch tiles them to 1,024 documents, so each row equals its copies'),
    # at 7a's widths and plain-held depth.
    t0 = time.perf_counter()
    reset_tree_counts()
    _streams, base = tree_3b_batch(TREE_7A_SCRIPTS, TREE_PLAIN_COMMITS)
    batch = DT.CommitBatch(*[torch.from_numpy(np.ascontiguousarray(
        x)).to(device) for x in base])
    docs = torch.zeros((TREE_7A_SCRIPTS, TREE_LC), dtype=torch.int32,
                       device=device)
    L0 = torch.zeros(TREE_7A_SCRIPTS, dtype=torch.int32, device=device)
    rows = DT.batched_trunk_scan(docs, L0, batch, TREE_W, device=device)
    d = TREE_7A_SCRIPTS - 1
    one = DT.CommitBatch(*[x[d] for x in batch])
    got = DT.trunk_scan(docs[d], 0, one, TREE_W, device=device)
    same(got, [x[d] for x in rows], f"trunk_scan doc {d} vs batched")
    same(got, DT.trunk_scan(docs[d].cpu(), 0,
                            DT.CommitBatch(*[x.cpu() for x in one]),
                            TREE_W, device=cpu),
         f"trunk_scan doc {d}")
    shapes["trunk_scan"] = (f"64 scripts, {TREE_PLAIN_COMMITS} commits, Lc "
                            f"{TREE_LC}, Pc {TREE_PC}, W {TREE_W}")
    part_s["trunk_scan"] = time.perf_counter() - t0
    # The EM scans on the last document of 7b's first dispatch, recorded on
    # the CPU: the ring form against the dispatch's batched rows, the
    # one-base form against the batched one-base scan, both on the CPU.
    t0 = time.perf_counter()
    ((ring_ids, ring_L, ring_seq), mov0, arrays, U), ring_rows = \
        _record_em_dispatch()
    lanes = [arrays[k] for k in ("dm", "ic", "ii", "rs", "rl", "ro", "refs",
                                 "seqs", "mv")]
    W = ring_ids.shape[1]
    d = len(mov0) - 1
    cb = DEM.EmCommitBatch(*[x[d] for x in lanes])
    ring = [x[d] for x in (ring_ids, ring_L, ring_seq)]
    got = DEM.em_trunk_scan_ring_one(*ring, int(mov0[d]), cb, U,
                                     device=device)
    same(got, [x[d] for x in ring_rows], f"em ring one doc {d} vs batched")
    base_rows = DEM.batched_em_trunk_scan(
        ring_ids[:, -1], ring_L[:, -1], ring_seq[:, -1],
        DEM.EmCommitBatch(*lanes), W, U, device=cpu)
    got = DEM.em_trunk_scan_one(ring_ids[d, -1], ring_L[d, -1],
                                ring_seq[d, -1], cb, W, U, device=device)
    same(got, [x[d] for x in base_rows], f"em one doc {d} vs batched (CPU)")
    shapes["em"] = (f"C {lanes[0].shape[1]}, Lc {ring_ids.shape[2]}, "
                    f"Pc {lanes[2].shape[2]}, R {lanes[3].shape[2]}, W {W}, "
                    f"U {U}")
    part_s["em"] = time.perf_counter() - t0
    tree_launches = read_tree_counts()
    # sharded_apply_ops at 9c's shard shape against ShardedDoc.apply on 9c's
    # frame of ops; against the CPU on the frame's first SHARDED_CPU_OPS ops
    # (the plain exchange on the host is slow at this shape). The exchange
    # kernels' launches are counted over it.
    t0 = time.perf_counter()
    SX.reset_counts()
    rng = np.random.default_rng(8)
    payloads = {}
    track = OracleDoc(NO_CLIENT)
    first = np.stack(random_acked_stream(rng, SHARDED_FRAME_OPS, payloads,
                                         track, caught_up=True)
                     ).astype(np.int32)
    more = np.stack(random_acked_stream(rng, SHARDED_FRAME_OPS, payloads,
                                        track, caught_up=True,
                                        seq0=SHARDED_FRAME_OPS + 1)
                    ).astype(np.int32)
    doc = ShardedDoc(SHARDED_SHARD_CAP, Mesh([device] * 8, "seg"))
    doc.apply(first)
    start = type(state)(*[torch.from_numpy(np.array(x)).to(device)
                          for x in doc.state])
    got = sharded_apply_ops(start, more)
    doc.apply(more)
    same(got, [torch.from_numpy(np.asarray(x)) for x in doc.state],
         "sharded_apply_ops vs ShardedDoc.apply")
    if int(got.err.max()) != 0:
        raise AssertionError("11d: the sharded stream set an err bit")
    head = more[:SHARDED_CPU_OPS]
    same(sharded_apply_ops(start, head),
         sharded_apply_ops(type(state)(*[x.cpu() for x in start]), head),
         "sharded_apply_ops")
    exchange_launches = read_shard_counts()
    shapes["sharded"] = (f"8 x {SHARDED_SHARD_CAP:,} rows, "
                         f"{SHARDED_FRAME_OPS} ops ({SHARDED_CPU_OPS} "
                         "against the CPU)")
    part_s["sharded"] = time.perf_counter() - t0
    print(f"11d thin functions: {len(checked)} calls on the card equal "
          f"the CPU; shapes {shapes}; s "
          f"{ {k: round(v, 2) for k, v in part_s.items()} }", flush=True)
    return dict(calls=len(checked), shapes=shapes, part_s=part_s,
                tree_launches=tree_launches,
                exchange_launches=exchange_launches)


def phase_framework(device, report, twin=None, n_ops=FRAMEWORK_OPS,
                    tail=FRAMEWORK_TAIL, n_points=FRAMEWORK_POINTS):
    """Phase 11: the framework layer, the hierarchy trees and the drivers
    on the card. 11a and 11c run :func:`framework_script` on the card (K1
    and K2 launches counted over 11a, both above 0) and compare it with
    its CPU twin (``twin``: a (pool, future) from
    :func:`start_framework_twin`, started here if None); 11b the chunked
    forest; 11d the thin functions; then K1/K2 held against their plain
    versions at the end state of a replica's string."""
    from fluidframework_tpu_torch.ops.segment_state import to_packed

    if twin is None:
        twin = start_framework_twin(n_ops, tail)
    wall = {}
    keep = {}
    counts = {}

    def after_11a():
        torch.cuda.synchronize()
        counts.update(read_counts())

    try:
        reset_counts()
        t = time.perf_counter()
        card = framework_script(device, n_ops, tail, keep=keep,
                                after_11a=after_11a)
        wall["11a+11c"] = time.perf_counter() - t
        for name in ("K1_merge_apply", "K2_zamboni_compact"):
            if counts[name]["all"] <= 0:
                raise AssertionError(f"{name} never launched on the "
                                     "framework path")
        t = time.perf_counter()
        r11b = framework_11b(device, n_points)
        wall["11b"] = time.perf_counter() - t
        t = time.perf_counter()
        r11d = framework_11d(device)
        wall["11d"] = time.perf_counter() - t
        t = time.perf_counter()
        cpu, cpu_s = twin[1].result()
        wall["twin_wait"] = time.perf_counter() - t
    except BaseException:
        stop_framework_twin(twin)
        raise
    twin[0].shutdown(wait=True)
    _same_obs(card, cpu, "11a/11c")
    # Each kernel against its plain version at the end state of client
    # 1's string, with its time and byte floor.
    holds = []
    tt, ss, _single = to_packed(keep["texts"][0]._state)
    nxt = torch.from_numpy(np.stack([
        E.insert(3, 10**6, 2, seq=10**6, ref=10**6 - 1, client=1),
    ])[None]).to(device)
    with _Uncounted():
        for name, ops in (("K1_merge_apply", nxt),
                          ("K2_zamboni_compact", None)):
            outs = []
            err, ms, plain_ms = hold_kernel(name, tt, ss, ops,
                                            scalars_out=outs)
            d, cap = tt.shape[1], tt.shape[2]
            b = live_bound_bytes(name, ss, cap, ops, outs[0])
            b_all = bound_bytes(name, d, cap, 1 if ops is not None else 0)
            holds.append(dict(kernel=name, cell="11a end state", docs=d,
                              cap=cap, k=1 if ops is not None else 0,
                              tier=_cuda.tier(cap, KERNELS[name]["entry"],
                                              d),
                              max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              bound_ms=b / HBM_BYTES_PER_S * 1e3,
                              all_rows_bound_ms=b_all / HBM_BYTES_PER_S * 1e3,
                              library_ms=None))
            print(f"framework kernels 11a end state S={cap} {name}: exact, "
                  f"{ms:.4f} ms (plain {plain_ms:.3f} ms, bound "
                  f"{holds[-1]['bound_ms']:.6f} ms, all rows "
                  f"{holds[-1]['all_rows_bound_ms']:.6f})", flush=True)
    ops_s = card["msgs"] / keep["wall_11a"]
    print(f"11a framework: {n_ops} string ops by 3 clients + "
          f"{-(-n_ops // FRAMEWORK_EDIT_EVERY)} other edits, "
          f"{card['msgs']} msgs sequenced in {keep['wall_11a']:.1f} s "
          f"({ops_s:.0f} msgs/s), text {len(card['text'])} chars; "
          f"attributor {len(card['attributor']['seqDeltas'])} entries, "
          f"scheduler {card['scheduler']}, oldest {card['oldest']}, "
          f"stamped {card['stamped']}; K1 "
          f"{counts['K1_merge_apply']['all']}, K2 "
          f"{counts['K2_zamboni_compact']['all']}; card == CPU twin "
          f"({cpu_s:.1f} s in its own process)", flush=True)
    print(f"11c drivers: {len(card['saved'])} files saved, file replay == a "
          f"live loader lane for lane, snapshot {len(card['snapshot'])} "
          f"bytes (== CPU), debugger checkpoints {card['checkpoints']}, "
          f"cold {card['cold_stats']}, warm {card['warm_stats']}, inner "
          f"fetches {card['fetched']}; {keep['wall_11c']:.1f} s", flush=True)
    out = dict(msgs=card["msgs"], text_len=len(card["text"]),
               wall_11a_s=keep["wall_11a"], wall_11c_s=keep["wall_11c"],
               msgs_per_sec=ops_s, cpu_twin_s=cpu_s,
               snapshot_bytes=len(card["snapshot"]),
               checkpoints=card["checkpoints"],
               cold_stats=card["cold_stats"], warm_stats=card["warm_stats"],
               fetched=card["fetched"], oldest=card["oldest"],
               stamped=card["stamped"], points=r11b, thin=r11d,
               launches=counts, holds=holds, wall_s=wall)
    print(f"11 wall s: { {k: round(v, 1) for k, v in wall.items()} }; "
          f"launches {counts}", flush=True)
    report["phase_framework"] = out
    return dict(launches=counts, holds=holds,
                tree_launches=r11d["tree_launches"],
                exchange_launches=r11d["exchange_launches"])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    twins = []
    try:
        return _main(device, twins)
    except BaseException:
        for twin in twins:
            stop_framework_twin(twin)
        raise


def _main(device, twins) -> int:
    report = {"torch": torch.__version__, "cuda": torch.version.cuda,
              "python": sys.version.split()[0]}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    report["card"] = smi

    t_b = time.perf_counter()
    with ThreadPoolExecutor(len(BUILDS)) as pool:
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
    # Phase 1c: every entry on every tier, repeated at its path's shape.
    timed("1c_repeat", phase_repeat, device, report)
    torch.cuda.empty_cache()
    # Each main path runs with every launch count set to 0 just before it
    # and read just after.
    (t0, s0), ops, launches2 = timed("2_fleet_service", phase_main_path,
                                     device, report)
    torch.cuda.empty_cache()

    # Each kernel against its plain version at the main path's shapes.
    d, cap = t0.shape[1], t0.shape[2]
    k = ops.shape[1]
    main_shape = {}
    report["main_shape_tiers"] = []
    for name in KERNELS:
        outs = []
        err, ms, plain_ms = hold_kernel(name, t0, s0, ops, scalars_out=outs)
        main_shape[name] = (err, ms, plain_ms,
                            live_bound_bytes(name, s0, cap, ops, outs[0]),
                            bound_bytes(name, d, cap, k))
        routed = _cuda.tier(cap, KERNELS[name]["entry"], d)
        print(f"main-path shape {name} ({routed}): {ms:.4f} ms (plain "
              f"{plain_ms:.2f} ms, bound "
              f"{main_shape[name][3] / HBM_BYTES_PER_S * 1e3:.4f} ms, all "
              f"rows {main_shape[name][4] / HBM_BYTES_PER_S * 1e3:.4f})",
              flush=True)
        # The other narrow tier on the same states, forced.
        for tier in narrow_tiers(name, cap):
            if tier != routed:
                _e, t_ms, _p = hold_kernel(name, t0, s0, ops, plain_reps=1,
                                           t=tier)
                report["main_shape_tiers"].append(
                    dict(kernel=name, tier=tier, ms=t_ms))
                print(f"main-path shape {name} ({tier}, forced): "
                      f"{t_ms:.4f} ms", flush=True)
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
    # Phase 11's CPU twin needs no card: it runs in its own process from
    # here on, beside phases 7-10, once the timed windows of the
    # host-bound serving phases 4-6 have closed.
    twins.append(start_framework_twin())
    # Phase 7: the SharedTree rebase path (T1, T2 and their holds).
    torch.cuda.empty_cache()
    tree = timed("7_tree", phase_tree, device, report)
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
    load = timed("10_load", phase_load, device, report)
    # Phase 11: the framework layer, the hierarchy trees and the drivers.
    torch.cuda.empty_cache()
    framework = timed("11_framework", phase_framework, device, report,
                      twins[0])
    report["wall_s"] = wall

    kernels = []
    for name, spec in KERNELS.items():
        err, ms, plain_ms, b, b_all = main_shape[name]
        by_path = {"fleet_service": launches2[name],
                   "docfleet": launches3[name], "serving": launches4[name],
                   "pipeline": launches5[name], "server": launches6[name],
                   "client": client["launches"][name],
                   "mesh": scale["mesh"][name],
                   "sharded": scale["sharded"][name],
                   "load": load["launches"][name],
                   "framework": framework["launches"][name]}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "fluidframework_tpu_torch/csrc/merge_kernels.cu",
            "replaces": spec["replaces"],
            "launches": sum(p["all"] for p in by_path.values()),
            **{f"launches_{t}": sum(p[t] for p in by_path.values())
               for t in _cuda.TIER_CODES},
            "launches_by_path": by_path,
            "max_abs_err": max([err] + [r["max_abs_err"]
                                        for r in glob + scale["holds"]
                                        + load["holds"]
                                        + framework["holds"]
                                        if r["kernel"] == name]),
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "all_rows_bound_ms": b_all / HBM_BYTES_PER_S * 1e3,
            "library_ms": None,
            "by_tier": [{key: r[key] for key in
                         ("tier", "docs", "cap", "k", "ms", "plain_ms",
                          "bound_ms", "all_rows_bound_ms")}
                        for r in glob if r["kernel"] == name],
            "client_shapes": [{key: r[key] for key in
                               ("cell", "tier", "docs", "cap", "k", "ms",
                                "plain_ms", "bound_ms",
                                "all_rows_bound_ms")}
                              for r in client["holds"]
                              if r["kernel"] == name],
            "mesh_shapes": [{key: r.get(key) for key in
                             ("cell", "docs", "cap", "k", "ms", "plain_ms",
                              "bound_ms", "all_rows_bound_ms")}
                            for r in scale["holds"] if r["kernel"] == name],
            "load_shapes": [{key: r[key] for key in
                             ("cell", "tier", "docs", "cap", "k", "ms",
                              "plain_ms", "bound_ms", "all_rows_bound_ms")}
                            for r in load["holds"] if r["kernel"] == name],
            "framework_shapes": [{key: r[key] for key in
                                  ("cell", "tier", "docs", "cap", "k", "ms",
                                   "plain_ms", "bound_ms",
                                   "all_rows_bound_ms")}
                                 for r in framework["holds"]
                                 if r["kernel"] == name],
        })
    kernels += tree_kernel_rows(tree, load, framework)
    kernels += algebra_kernel_rows(tree)
    kernels += exchange_kernel_rows(scale["exchange"],
                                    framework["exchange_launches"])
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


def tree_kernel_rows(tree, load, framework) -> list:
    """The kernels line's T1 and T2 entries: launches by path (7a, 7b,
    7b-moves, 7c, 10b, 11d), the time, plain time and byte floor on the
    same inputs of the main path (7a's whole batch over the commits held
    against the plain version for T1, with the time of the whole 7a scan
    beside them; 7b's first dispatch for T2), the largest error of every
    hold, and the holds' rows. No PyTorch call computes a rebase scan, so
    ``library_ms`` is null."""
    b3 = tree["3b"]
    main = {"T1_trunk_scan": dict(
        b3, event_ms_per_scan=b3["prefix_event_ms"],
        plain_ms_per_scan=b3["plain_ms_per_prefix"],
        scan_bound_ms=b3["prefix_bound_ms"]),
        "T2_em_ring_scan": tree["3c"]}
    rows = []
    for name, spec in TREE_KERNELS.items():
        by_path = {**{k: v[name] for k, v in tree["launches"].items()},
                   "10b": load["tree_launches"][name],
                   "11d": framework["tree_launches"][name]}
        m = main[name]
        holds = [r for r in tree.get("holds", []) if r["kernel"] == name]
        rows.append({
            "name": name, "route": "cuda",
            "source": "fluidframework_tpu_torch/csrc/tree_kernels.cu",
            "replaces": spec["replaces"],
            "launches": sum(p["all"] for p in by_path.values()),
            **{f"launches_{t}": sum(p[t] for p in by_path.values())
               for t in TSK.TIER_CODES},
            "launches_by_path": by_path,
            "max_abs_err": max([0] + [r["max_abs_err"] for r in holds]),
            "ms": m["event_ms_per_scan"], "plain_ms": m["plain_ms_per_scan"],
            "bound_ms": m["scan_bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            "main_shape": {
                "n_docs": m["n_docs"], "tier": m["tier"],
                "commits": m.get("prefix_commits", m["commits_per_doc"]),
                "tiers_ms": {k: v["ms"] for k, v in (
                    m.get("prefix_tiers") or m.get("scan_tiers")
                    or {}).items()},
                **({"whole_scan": {"commits": m["commits_per_doc"],
                                   "ms": b3["event_ms_per_scan"],
                                   "bound_ms": b3["scan_bound_ms"],
                                   "tiers_ms": {k: v["ms"] for k, v in (
                                       b3.get("scan_tiers") or {}).items()}}}
                   if m is main["T1_trunk_scan"] else {})},
            "holds": [{**{k: r[k] for k in ("tier", "ring", "docs",
                                            "commits", "W", "Lc", "Pc", "ms",
                                            "plain_ms", "bound_ms",
                                            "fastest")},
                       "tiers_ms": {k: v["ms"]
                                    for k, v in r["tiers"].items()}}
                      for r in holds],
        })
    return rows


def algebra_kernel_rows(tree) -> list:
    """The kernels line's A1-A4 entries: launches by path (7a's calls of
    the batched entry points, rebase in both tie forms; no other path calls
    them), the kernel's ms on the tier it runs, the plain version's ms and
    the byte floor at 7a's shape (1,024 docs x Lc 128 x Pc 32 on 7a's
    commits; rebase's default tie form), the largest error of every hold
    and the holds' rows. No PyTorch call computes these functions, so
    ``library_ms`` is null."""
    fns = tree["3b"]["functions"]
    rows = []
    for name, spec in ALGEBRA_KERNELS.items():
        main = [f for f in fns if f["kernel"] == name]
        by_path = {k: v[name] for k, v in tree["launches"].items()}
        holds = ([f["hold"] for f in main]
                 + [r for r in tree.get("algebra_holds", [])
                    if r["kernel"] == name])
        m = main[0]["hold"]
        rows.append({
            "name": name, "route": "cuda",
            "source": "fluidframework_tpu_torch/csrc/tree_kernels.cu",
            "replaces": spec["replaces"],
            "launches": sum(p["all"] for p in by_path.values()),
            **{f"launches_{t}": sum(p[t] for p in by_path.values())
               for t in TAK.TIER_CODES},
            "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in holds),
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            "main_shape": {"n_docs": m["docs"], "Lc": m["Lc"],
                           "Pc": m["Pc"], "tier": m["tier"],
                           "entry_point_ms": [f["ms"] for f in main],
                           "launches_a_call": [f["launches"] for f in main],
                           "tiers_ms": {k: v["ms"]
                                        for k, v in m["tiers"].items()}},
            "holds": [{**{k: r.get(k) for k in (
                "cell", "lanes", "docs", "Lc", "Pc", "c_after", "tier", "ms",
                "plain_ms", "bound_ms", "ties", "overflows")},
                "tiers_ms": {k: v["ms"] for k, v in r["tiers"].items()}}
                for r in holds],
        })
    return rows


def exchange_kernel_rows(exchange, framework_launches) -> list:
    """The kernels line's X1, X2 and ``shard_exchange`` entries: launches
    by path (9c and 9c on one card after promotion, 11d), the time, plain
    time, byte floor (rows below count) and all-rows floor of the hold at
    9c's shape (8 x 65,536 rows on 8 x the card, one device group; the
    first hold), the largest error of every hold, and the holds' rows. Every
    path a card runs alone is one device group, so there the exchange is
    ``shard_exchange`` on every op and X1 and X2 launch only in the holds
    (and on several groups: two cards). No PyTorch call computes the
    exchange, so ``library_ms`` is null."""
    rows = []
    for name, spec in SHARD_KERNELS.items():
        by_path = {**{p: c[name] for p, c in exchange["launches"].items()},
                   "11d": framework_launches[name]}
        holds = [r for r in exchange["holds"] if r["kernel"] == name]
        one_group = name == ONE_GROUP_EXCHANGE
        if any((v > 0) != one_group for p, v in by_path.items()
               if p != "9c_one_card" or not one_group):
            raise AssertionError(f"{name}: launches by path {by_path}")
        rows.append({
            "name": name, "route": "cuda",
            "source": "fluidframework_tpu_torch/csrc/merge_kernels.cu",
            "replaces": spec["replaces"],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in holds),
            "ms": holds[0]["ms"], "plain_ms": holds[0]["plain_ms"],
            "bound_ms": holds[0]["bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            "all_rows_bound_ms": holds[0]["all_rows_bound_ms"],
            "event_ms": holds[0]["event_ms"],
            "profiler_ms": holds[0]["profiler_ms"],
            "holds": [{k: r[k] for k in ("cell", "shards", "cap",
                                         "live_rows", "ops", "ms",
                                         "profiler_ms", "event_ms",
                                         "plain_ms", "bound_ms",
                                         "all_rows_bound_ms")}
                      for r in holds],
        })
    return rows


def tree_alone(**kw) -> int:
    """Phase 7 alone, after building the tree kernels (T1, T2); its record
    goes to ``tree.json`` in the output directory."""
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    report = {"card": smi, "torch": torch.__version__}
    t = time.perf_counter()
    _cuda.build("tree")
    report["build_s"] = time.perf_counter() - t
    print(f"build: {report['build_s']:.1f} s", flush=True)
    for line in _cuda.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("ptxas:", line.strip(), flush=True)
    t = time.perf_counter()
    phase_tree(device, report, **kw)
    print(f"phase 7_tree: {time.perf_counter() - t:.1f} s", flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "tree.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(smi)
    return 0


# The split tier's widths (--split): phase 1b's shapes past the global
# tier, then the global tier's shapes K1 and K3 could also take it at
# (config 6's deep tier at 16 docs, 9c's 8 shards of 65,536 rows), then the
# sharded paths' launches at their rows below count (9c's 8 shards, one
# live op beside 7 NOOPs; the live shard alone, what its 7 NOOP neighbours
# cost; the one card's shard), as (rows S, docs D, rows below count).
SPLIT_SHAPES = ((524_288, 1), (131_072, 2))
SPLIT_VS_GLOBAL_SHAPES = ((32_768, 16), (65_536, 8))
SPLIT_9C_SHAPES = ((65_536, 8, ROWS_9C), (65_536, 1, ROWS_9C),
                  (524_288, 1, ROWS_9C_ONE_CARD))
# The document-count sweep behind _cuda.tier's rule (the split tier while
# it gives each document 2 CTAs or more): K1 (K 1 and 16) and K2 on the
# global and the split tier at these widths and counts.
SWEEP_CAPS = (32_768, 65_536)
SWEEP_DOCS = (1, 2, 4, 8, 16, 24, 33, 48, 66, 100, 132, 200, 264)

_SPLIT_RUN = """
import json, os, torch
import chip_smoke as c
{patch}
print("SPLIT_JSON " + json.dumps(c.split_times(
    torch.device("cuda", 0), sweep=os.environ.get("SPLIT_SWEEP") == "1")))
"""


def _entry_ms(name: str, t0, s0, ops, tier: str, reps: int) -> tuple:
    """A kernel's C entry forced onto ``tier``, held bit for bit against
    its plain version on the same input; its median CUDA-event time a
    launch on a fresh input (the host's launch cost included), and its
    device time a launch over 50 launches queued behind a spin, each on
    a fresh copy of the input (:func:`_queued_ms` with a reset, the
    copy's own time taken off). Nothing is counted."""
    spec = KERNELS[name]
    args = (ops,) if spec["takes_ops"] else ()
    want = spec["plain"](t0, s0, *args)
    t, s = t0.clone(), s0.clone()

    def run():
        _cuda.launch(spec["entry"], t, s, ops if args else None, (t, s),
                     t=tier)

    run()
    torch.cuda.synchronize()
    if not (torch.equal(t, want[0]) and torch.equal(s, want[1])):
        raise AssertionError(f"{name} on the {tier} tier != plain")
    s_out = want[1]
    del want

    def reset():
        t.copy_(t0)
        s.copy_(s0)

    ms = _median_ms(run, reset, reps)
    reset()
    return ms, _queued_ms(t.device, run, reset=reset), s_out


def live_bound_bytes(name: str, scalars, s: int, ops, scalars_out) -> int:
    """:func:`bound_bytes` over the rows this run's data needs, given the
    launch's input and output scalars: each document's 15 lanes of its
    rows below its input count read once and, in place, of its rows below
    the larger of its input and output counts written once (every row at
    or past count is free before and after), the scalars, and the ops
    (``ops`` [D, K, OP_WIDTH]; K2 reads none). K1 needs no row of a
    document whose ops are all NOOPs (9c's shards but the owner); K3
    still compacts such a document's rows below count."""
    takes_ops = KERNELS[name]["takes_ops"]
    k = ops.shape[1] if takes_ops else 0
    d = scalars.shape[0]
    noop = ((ops[:, :, F_TYPE] == OP_NOOP).all(dim=1).tolist() if takes_ops
            else [False] * d)
    c_in = scalars[:, K1.SC_COUNT].clamp(0, s).tolist()
    c_out = scalars_out[:, K1.SC_COUNT].clamp(0, s).tolist()
    rows = 0  # rows read plus rows written
    for c, c2, idle in zip(c_in, c_out, noop):
        if not (idle and name == "K1_merge_apply"):
            rows += c + max(c, c2)
    return (K1.N_LANES * rows * 4 + 2 * d * K1.N_SCALARS * 4
            + d * k * OP_WIDTH * 4)


def _split_row(name, t0, s0, ops, tier, reps, **key) -> dict:
    d, cap = t0.shape[1], t0.shape[2]
    k = ops.shape[1] if KERNELS[name]["takes_ops"] else 0
    ms, device_ms, s_out = _entry_ms(name, t0, s0, ops, tier, reps)
    row = dict(kernel=name, cap=cap, docs=d, k=k, tier=tier, ms=ms,
               device_ms=device_ms,
               bound_ms=live_bound_bytes(name, s0, cap, ops, s_out)
               / HBM_BYTES_PER_S * 1e3,
               all_rows_bound_ms=bound_bytes(name, d, cap, k)
               / HBM_BYTES_PER_S * 1e3, **key)
    print(f"split S={cap} D={d} K={k} {name} {tier}"
          f"{' ' + key['cell'] if 'cell' in key else ''}: {ms:.4f} ms, "
          f"device {device_ms:.4f} (bound {row['bound_ms']:.5f}, all rows "
          f"{row['all_rows_bound_ms']:.5f})", flush=True)
    return row


def split_times(device, reps=10, sweep=False) -> dict:
    """K1, K2 and K3 at :data:`SPLIT_SHAPES` (random cases, K 16, and K1
    with one op, the sharded document's launch), K1 and K3 at
    :data:`SPLIT_VS_GLOBAL_SHAPES` on the global tier and on the split
    tier, and K1 (one op) and K2 at :data:`SPLIT_9C_SHAPES` on the tiers
    that take them, each held bit for bit against its plain version;
    median CUDA-event ms of each beside its bound on the rows below count
    and the all-rows floor. With ``sweep``, also the document-count sweep
    (:data:`SWEEP_CAPS` x :data:`SWEEP_DOCS`: K1 at K 1 and 16 and K2 on
    both tiers, 5 launches each)."""
    rows = []
    for cap, d in SPLIT_SHAPES + SPLIT_VS_GLOBAL_SHAPES:
        t0, s0, ops = random_case(np.random.default_rng(cap + 1), d, cap,
                                  16, device)
        tiers = (("split",) if cap > _cuda.GLOBAL_MAX_CAPACITY
                 else ("global", "split"))
        for name in KERNELS:
            for tier in tiers:
                if tier == "split" and len(tiers) == 2 and \
                        name == "K2_zamboni_compact":
                    continue  # K2's global tier is already split
                for k in ((16, 1) if name == "K1_merge_apply" else (16,)):
                    rows.append(_split_row(name, t0, s0,
                                           ops[:, :k].contiguous(), tier,
                                           reps))
        del t0, s0, ops
        torch.cuda.empty_cache()
    for cap, d, live in SPLIT_9C_SHAPES:
        t0, s0, ops = KS.live_inputs(device, cap, [live] * d, 1,
                                     live_doc=d // 2)
        tiers = (("split",) if cap > _cuda.GLOBAL_MAX_CAPACITY
                 else ("global", "split"))
        for name in ("K1_merge_apply", "K2_zamboni_compact"):
            for tier in tiers:
                rows.append(_split_row(name, t0, s0, ops, tier, reps,
                                       cell=f"9c counts ({live:,} rows)"))
        del t0, s0, ops
        torch.cuda.empty_cache()
    out = dict(split_max_ctas=_cuda.lib().merge_split_max_ctas(),
               rows=rows)
    if sweep:
        out["sweep"] = []
        for cap in SWEEP_CAPS:
            for d in SWEEP_DOCS:
                t0, s0, ops = random_case(np.random.default_rng(cap + d), d,
                                          cap, 16, device)
                for name, k in (("K1_merge_apply", 1), ("K1_merge_apply", 16),
                                ("K2_zamboni_compact", 0)):
                    for tier in ("global", "split"):
                        out["sweep"].append(_split_row(
                            name, t0, s0, ops[:, :max(k, 1)].contiguous(),
                            tier, 5, cell="sweep"))
                del t0, s0, ops
                torch.cuda.empty_cache()
    return out


# The parent's merge kernel source under this tree's wrappers: built as
# this tree builds it and bound by hand to the entries every version has,
# so an entry or tier limit this tree added does not stop it loading.
_PARENT_PATCH = """
import ctypes
import fluidframework_tpu_torch.ops._cuda as cu
cu.SOURCE = {src!r}
_p, _i = ctypes.c_void_p, ctypes.c_int
_lib = ctypes.CDLL(cu.build())
cu.bind(_lib, [
    ("merge_apply", [_p] * 6 + [_i] * 4 + [_p], _i),
    ("merge_compact", [_p] * 5 + [_i] * 3 + [_p], _i),
    ("merge_apply_compact", [_p] * 6 + [_i] * 4 + [_p], _i),
    ("merge_work_ints", [_i], ctypes.c_longlong),
    ("merge_error_string", [_i], ctypes.c_char_p),
    ("merge_split_max_ctas", [], _i)])
cu._libs["merge"] = _lib
"""


def _sweep_run(code: str, tag: str, timeout: int) -> dict:
    """Run ``code`` (as for :func:`_runs_in_turn`, no patch) once for this
    tree with ``<tag>_SWEEP=1`` set; returns its record labelled
    ``sweep``."""
    here = os.path.dirname(os.path.abspath(__file__))
    res = subprocess.run([sys.executable, "-c", code.format(patch="")],
                         cwd=here, env=dict(os.environ, PYTHONPATH=here,
                                            **{f"{tag}_SWEEP": "1"}),
                         capture_output=True, text=True, timeout=timeout)
    if res.returncode != 0:
        print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
        raise AssertionError(f"{tag.lower()}: the sweep failed")
    line = next(x for x in res.stdout.splitlines()
                if x.startswith(f"{tag}_JSON "))
    return dict(label="sweep", **json.loads(line[len(tag) + 6:]))


def _runs_in_turn(code: str, tag: str, variants, parent=None) -> list:
    """Run ``code`` (a script with a ``{patch}`` slot that prints one line
    ``<tag>_JSON <json>``) in its own process on this card for this tree,
    for each variant (this tree with the kernel constants of one spec
    changed, as for :func:`ab`) and, where ``parent`` (an unpacked earlier
    commit) is given, for this tree's Python with the parent's merge
    kernel source, in turns: the parent and each variant, this tree
    twice, each variant and the parent again. Returns each run's record,
    with its label and wall seconds."""
    here = os.path.dirname(os.path.abspath(__file__))
    trees = {"change": ""}
    if parent:
        src = os.path.join(os.path.abspath(parent), "fluidframework_tpu_torch",
                           "csrc", "merge_kernels.cu")
        trees["parent"] = _PARENT_PATCH.format(src=src)
    for i, spec in enumerate(variants):
        trees[f"v{i + 1}"] = ("import fluidframework_tpu_torch.ops._cuda "
                              "as cu; cu.SOURCE = "
                              f"{_variant_source(spec, f'v{i + 1}')!r}")
        print(f"{tag.lower()}: v{i + 1} = {spec}", flush=True)
    labels = [x for x in trees if x != "change"]
    runs = []
    for label in labels + ["change", "change"] + labels[::-1]:
        t = time.perf_counter()
        res = subprocess.run([sys.executable, "-c",
                              code.format(patch=trees[label])], cwd=here,
                             env=dict(os.environ, PYTHONPATH=here),
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            raise AssertionError(f"{tag.lower()} run of {label} failed")
        line = next(x for x in res.stdout.splitlines()
                    if x.startswith(f"{tag}_JSON "))
        runs.append(dict(label=label, wall_s=time.perf_counter() - t,
                         **json.loads(line[len(tag) + 6:])))
        print(f"{tag.lower()}: {label} in {runs[-1]['wall_s']:.1f} s",
              flush=True)
    return runs


def split_ab(variants=(), parent=None, sweep=True) -> int:
    """:func:`split_times` of this tree, of each variant and of the
    parent's kernel source (:func:`_runs_in_turn`), then, with ``sweep``,
    the document-count sweep of this tree alone (``SPLIT_SWEEP=1``).
    Prints each row's times by tree and the sweep's, and writes every run
    to ``split.json`` in the output directory."""
    runs = _runs_in_turn(_SPLIT_RUN, "SPLIT", variants, parent)
    if sweep:
        runs.append(_sweep_run(_SPLIT_RUN, "SPLIT", 1800))
    by = {}
    for run in runs:
        if run["label"] == "sweep":
            continue
        for r in run["rows"]:
            key = (r["kernel"], r["cap"], r["docs"], r["k"], r["tier"],
                   r.get("cell", ""))
            by.setdefault(key, {}).setdefault(run["label"], []).append(
                (round(r["ms"], 4), round(r["device_ms"], 4)))
    for (name, cap, d, k, tier, cell), v in by.items():
        print(f"split {name} S={cap} D={d} K={k} {tier} {cell} "
              "(ms, device ms): " + ", ".join(f"{label} {ms}"
                                              for label, ms in v.items()),
              flush=True)
    cells = {}
    for r in runs[-1]["sweep"] if sweep else ():
        cells.setdefault((r["kernel"], r["cap"], r["k"], r["docs"]), {})[
            r["tier"]] = (r["ms"], r["device_ms"])
    for (name, cap, k, d), v in cells.items():
        (g, gd), (sp, sd) = v["global"], v["split"]
        print(f"sweep {name} S={cap} K={k} D={d}: global {g:.4f} split "
              f"{sp:.4f} ms ({g / sp:.2f}x); device {gd:.4f} / {sd:.4f} "
              f"({gd / sd:.2f}x)", flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "split.json"), "w") as f:
        json.dump(runs, f, indent=1)
    return 0


# --narrow: K1 and K3 on the warp tier and the shared tier at the narrow
# widths. The paths' launches (kernel, rows S, docs D, ops K, path), timed
# for this tree, each variant and the parent in turns on random states
# (:func:`random_case`): config 5's fleet service, the serving, pipeline
# and server pools (and the serving pool promoted to 256 rows), 8c, 9a's
# shards, 8b.
NARROW_PATHS = (
    ("K1_merge_apply", 128, 100_000, 16, "fleet service"),
    ("K3_fused_apply_compact", 128, 100_000, 16, "fleet service"),
    ("K1_merge_apply", 128, 16_384, 8, "serving, pipeline, server"),
    ("K1_merge_apply", 256, 16_384, 8, "serving at 256 rows"),
    ("K1_merge_apply", 256, 20_000, 64, "8c"),
    ("K1_merge_apply", 128, 2_048, 8, "9a, a shard"),
    ("K1_merge_apply", 256, 2_048, 16, "8b"),
    ("K3_fused_apply_compact", 256, 2_048, 16, "8b"),
)
# The sweep behind _cuda.WARP_MIN_DOCS: widths x document counts x ops
# (K 16 and the paths' own: serving's 8, 8c's 64, the client's 1), K1 and
# K3 on both tiers; a width's counts stop where one table set passes
# NARROW_MAX_BYTES. Held against the plain versions up to
# NARROW_PLAIN_DOCS documents, past them tier against tier.
NARROW_CAPS = (64, 128, 256, 512)
NARROW_DOCS = (1, 8, 66, 132, 528, 2048, 16_384, 100_000)
NARROW_KS = (16, 8, 64, 1)
NARROW_MAX_BYTES = 8 << 30
NARROW_PLAIN_DOCS = 16_384
NARROW_KERNELS = ("K1_merge_apply", "K3_fused_apply_compact")

_NARROW_RUN = """
import json, os, torch
import chip_smoke as c
{patch}
print("NARROW_JSON " + json.dumps(c.narrow_times(
    torch.device("cuda", 0), sweep=os.environ.get("NARROW_SWEEP") == "1")))
"""


def _narrow_rows(name, t0, s0, ops, tiers, want, **key) -> list:
    """``name`` on each of ``tiers`` (forced) on the same input, held bit
    for bit against ``want`` (a (tables, scalars) pair; None: against the
    first tier's output); each tier's device ms a launch (:func:`_queued_ms`
    with a fresh copy of the input before each launch, the copy's time
    taken off) beside the all-rows byte floor and the floor of the rows
    the data needs (:func:`live_bound_bytes`). Nothing is counted."""
    spec = KERNELS[name]
    dev = t0.device
    ops = ops if spec["takes_ops"] else None
    d, cap = t0.shape[1], t0.shape[2]
    k = ops.shape[1] if ops is not None else 0
    t, s = t0.clone(), s0.clone()
    rows = []
    for tier in tiers:
        def run():
            _cuda.launch(spec["entry"], t, s, ops, (t, s), t=tier)

        def reset():
            t.copy_(t0)
            s.copy_(s0)

        reset()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        torch.cuda.synchronize()
        if want is None:
            want = (t.clone(), s.clone())
        elif not (torch.equal(t, want[0]) and torch.equal(s, want[1])):
            bad = (t != want[0]).nonzero()[:5].tolist()
            raise AssertionError(f"narrow {name} S={cap} D={d} K={k} on "
                                 f"{tier}: first [lane, doc, row] {bad}")
        reps = int(min(50, max(3, 100.0 / max(a.elapsed_time(b), 1e-3))))
        ms = _queued_ms(dev, run, reps, reset=reset)
        rows.append(dict(
            kernel=name, tier=tier, cap=cap, docs=d, k=k, device_ms=ms,
            reps=reps, bound_ms=bound_bytes(name, d, cap, k)
            / HBM_BYTES_PER_S * 1e3,
            live_bound_ms=live_bound_bytes(name, s0, cap, ops, want[1])
            / HBM_BYTES_PER_S * 1e3, **key))
        print(f"narrow {name} S={cap} D={d} K={k} {tier}"
              f"{' ' + key['path'] if 'path' in key else ''}: device "
              f"{ms:.4f} ms (bound {rows[-1]['live_bound_ms']:.5f}, all "
              f"rows {rows[-1]['bound_ms']:.5f})", flush=True)
    del t, s
    return rows


# The client path's one-document launches (K1 at 256 rows, K 1) whose
# host cost host_launch_ms takes: launches a run, runs.
HOST_LAUNCHES = (200, 5)


def host_launch_ms(device, tiers) -> dict:
    """Host ms a launch of K1 at one document of 256 rows, K 1 (the client
    path's launches), on each of ``tiers``: the median over
    :data:`HOST_LAUNCHES` runs of the host wall time of its launches, each
    a call of the library's C entry (its host calls and the launch; the
    arguments made once, outside the runs), queued behind a spin so that
    no launch waits for the card. Nothing is counted."""
    n, runs = HOST_LAUNCHES
    t, s, ops = random_case(np.random.default_rng(7), 1, 256, 1, device)
    entry = _cuda.lib().merge_apply
    stream = torch.cuda.current_stream(device).cuda_stream
    out = {}
    for tier in tiers:
        args = (ops.data_ptr(), t.data_ptr(), s.data_ptr(), t.data_ptr(),
                s.data_ptr(), None, 1, 256, 1, _cuda.TIER_CODES[tier],
                stream)
        if entry(*args) != 0:  # the warm-up; a refused launch fails here
            raise AssertionError(f"host_launch_ms: {tier} launch refused")
        torch.cuda.synchronize()
        times = []
        for _ in range(runs):
            torch.cuda._sleep(200_000_000)
            a = time.perf_counter()
            for _ in range(n):
                entry(*args)
            times.append((time.perf_counter() - a) * 1e3 / n)
            torch.cuda.synchronize()
        out[tier] = float(np.median(times))
        print(f"narrow host ms a launch, K1 256 x 1 x K 1 {tier}: "
              f"{out[tier]:.5f} (runs {[round(x, 5) for x in times]})",
              flush=True)
    return out


# The shared and cluster tiers' other launches on the main path, timed by
# --narrow on their own tier beside the narrow paths (kernel, rows S, docs
# D, ops K, path, tier; random states): K2 at config 5's, the serving
# pools', config 6's and the deep cell's widths, K1 at the deep cell's
# (shared and cluster) and K3 at phase 1b's cluster width.
WIDE_PATHS = (
    ("K2_zamboni_compact", 128, 100_000, 0, "fleet service", "smem"),
    ("K2_zamboni_compact", 128, 16_384, 0, "serving, pipeline, server",
     "smem"),
    ("K2_zamboni_compact", 256, 16_384, 0, "serving, cfg 6", "smem"),
    ("K2_zamboni_compact", 512, 16_384, 0, "cfg 6", "smem"),
    ("K2_zamboni_compact", 1024, 16_384, 0, "cfg 6", "smem"),
    ("K2_zamboni_compact", 2048, 256, 0, "deep", "smem"),
    ("K1_merge_apply", 2048, 256, 16, "deep", "smem"),
    ("K1_merge_apply", 4096, 256, 16, "deep", "cluster"),
    ("K1_merge_apply", 8192, 256, 16, "deep", "cluster"),
    ("K2_zamboni_compact", 4096, 256, 0, "deep", "cluster"),
    ("K2_zamboni_compact", 8192, 256, 0, "deep", "cluster"),
    ("K3_fused_apply_compact", 4096, 256, 16, "1b", "cluster"),
)


def narrow_times(device, sweep=False) -> dict:
    """K1 and K3 at :data:`NARROW_PATHS` on the shared tier and, where this
    library has it, the warp tier, and each launch of :data:`WIDE_PATHS` on
    its tier, each held bit for bit against its plain version, and the
    host ms a one-document launch (:func:`host_launch_ms`); with
    ``sweep``, the sweep instead (:data:`NARROW_CAPS` x
    :data:`NARROW_DOCS` x :data:`NARROW_KS`, both kernels on both tiers).
    Returns the rows, the host ms and the ptxas report."""
    tiers = ("smem", "warp") if hasattr(_cuda.lib(),
                                        "merge_warp_max_capacity") \
        else ("smem",)
    rows, host_ms = [], {}
    if not sweep:
        host_ms = host_launch_ms(device, tiers)
        for name, cap, d, k, path, *tier in (
                NARROW_PATHS + WIDE_PATHS):
            t0, s0, ops = random_case(np.random.default_rng(cap + d + k), d,
                                      cap, max(k, 1), device)
            args = (ops,) if KERNELS[name]["takes_ops"] else ()
            want = KERNELS[name]["plain"](t0, s0, *args)
            rows += _narrow_rows(name, t0, s0, ops, tuple(tier) or tiers,
                                 want, path=path)
            del t0, s0, ops, want
            torch.cuda.empty_cache()
    else:
        for cap in NARROW_CAPS:
            for d in NARROW_DOCS:
                if K1.N_LANES * d * cap * 4 > NARROW_MAX_BYTES:
                    break
                t0, s0, ops = random_case(np.random.default_rng(cap + d), d,
                                          cap, max(NARROW_KS), device)
                for k in NARROW_KS:
                    ok = ops[:, :k].contiguous()
                    for name in NARROW_KERNELS:
                        want = (KERNELS[name]["plain"](t0, s0, ok)
                                if d <= NARROW_PLAIN_DOCS else None)
                        rows += _narrow_rows(name, t0, s0, ok, tiers, want,
                                             cell="sweep")
                        del want
                del t0, s0, ops
                torch.cuda.empty_cache()
    ptxas = [x.strip() for x in _cuda.build_log.splitlines()
             if "registers" in x or "spill" in x or "Compiling" in x]
    return dict(tiers=tiers, rows=rows, host_launch_ms=host_ms, ptxas=ptxas)


def narrow_ab(variants=(), parent=None, sweep=True) -> int:
    """:func:`narrow_times` at the paths' shapes for this tree, each
    variant and the parent's kernel source (the shared tier alone) in
    turns (:func:`_runs_in_turn`), then, with ``sweep``, the sweep of this
    tree alone (``NARROW_SWEEP=1``). Prints each path's device ms by tree
    and tier beside its floors (the rows the data needs, and all rows)
    and each sweep cell's warp / shared ratio, and writes every run to
    ``narrow.json`` in the output directory."""
    runs = _runs_in_turn(_NARROW_RUN, "NARROW", variants, parent)
    if sweep:
        runs.append(_sweep_run(_NARROW_RUN, "NARROW", 2400))
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "narrow.json"), "w") as f:
        json.dump(runs, f, indent=1)
    by, floors = {}, {}
    for run in runs:
        if run["label"] == "sweep":
            continue
        for r in run["rows"]:
            key = (r["kernel"], r["cap"], r["docs"], r["k"], r["path"])
            by.setdefault(key, {}).setdefault(
                f"{run['label']} {r['tier']}", []).append(
                    round(r["device_ms"], 4))
            floors[key] = (r["live_bound_ms"], r["bound_ms"])
    for run in runs:
        if run["label"] != "sweep":
            print(f"narrow host ms a launch ({run['label']}): "
                  f"{run['host_launch_ms']}", flush=True)
    for key, v in by.items():
        name, cap, d, k, path = key
        print(f"narrow {name} S={cap} D={d} K={k} ({path}) device ms: "
              + ", ".join(f"{label} {ms}" for label, ms in v.items())
              + f" (bound {floors[key][0]:.5f}, all rows "
              f"{floors[key][1]:.5f})", flush=True)
    cells = {}
    for r in runs[-1]["rows"] if sweep else ():
        cells.setdefault((r["kernel"], r["cap"], r["k"], r["docs"]), {})[
            r["tier"]] = r["device_ms"]
    for (name, cap, k, d), v in cells.items():
        print(f"sweep {name} S={cap} K={k} D={d}: smem {v['smem']:.4f} "
              f"warp {v['warp']:.4f} ms ({v['smem'] / v['warp']:.2f}x)",
              flush=True)
    return 0


# The exchange's shapes on the sharded paths: 9c's 8 shards of 65,536 rows
# (~10,000 live rows each after promotion), the one card's shard of 524,288
# rows (~80,000 live), and 9c's shards at the most they hold before a
# rebalance (0.8 of the cap), as (shards, rows a shard, rows below count).
EXCHANGE_SHAPES = ((8, 65_536, 10_000), (1, 524_288, 80_000),
                   (8, 65_536, 52_428))

_EXCHANGE_RUN = """
import json, torch
import chip_smoke as c
{patch}
dev = torch.device("cuda", 0)
rows = []
for n, s, live in c.EXCHANGE_SHAPES:
    rows += c.hold_exchange(dev, *c.exchange_case(dev, n, s, seed=s,
                                                  rows=live),
                            f"{{n}} x {{s}}, {{live}} live")
# The floor of a launch queued behind others: a one-thread kernel that
# returns at once.
launch_ms = c._queued_ms(dev, lambda: torch.cuda._sleep(0))
print("EXCHANGE_JSON " + json.dumps(dict(rows=rows, launch_ms=launch_ms)))
"""


def exchange_ab(variants=()) -> int:
    """The exchange kernels held and timed (:func:`hold_exchange`) at
    :data:`EXCHANGE_SHAPES` on :func:`exchange_case` states, and the time
    of an empty launch queued the same way, for this tree and each
    variant (:func:`_runs_in_turn`; e.g. ``X1_UNROLL=1``,
    ``X1_MIN_ROWS=1024``, ``X1_THREADS=128``). Prints each kernel's times by
    tree and writes every run to ``exchange.json`` in the output
    directory."""
    runs = _runs_in_turn(_EXCHANGE_RUN, "EXCHANGE", variants)
    by = {("empty launch", ""): {}}
    for run in runs:
        by["empty launch", ""].setdefault(run["label"], []).append(
            run["launch_ms"])
        for r in run["rows"]:
            by.setdefault((r["kernel"], r["cell"]), {}).setdefault(
                run["label"], []).append(r["ms"])
    for (name, cell), v in by.items():
        print(f"exchange {name} at {cell}: " + ", ".join(
            f"{label} {ms}" for label, ms in v.items()), flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "exchange.json"), "w") as f:
        json.dump(runs, f, indent=1)
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
    with ThreadPoolExecutor(len(BUILDS)) as pool:
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
    with ThreadPoolExecutor(len(BUILDS)) as pool:
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
    with ThreadPoolExecutor(len(BUILDS)) as pool:
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


def framework_alone() -> int:
    """Phase 11 alone, after the builds (its CPU twin starts with it); its
    record goes to ``framework.json`` in the output directory."""
    device = torch.device("cuda", 0)
    twin = start_framework_twin()
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()[0]
        with ThreadPoolExecutor(len(BUILDS)) as pool:
            for b in [pool.submit(fn) for fn in BUILDS]:
                b.result()
        report = {"card": smi, "torch": torch.__version__}
        t = time.perf_counter()
        phase_framework(device, report, twin)
    except BaseException:
        stop_framework_twin(twin)
        raise
    print(f"phase 11_framework: {time.perf_counter() - t:.1f} s", flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "framework.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(smi)
    return 0


def server_repeat(n: int) -> int:
    """Phase 6 alone, ``n`` times in one process after the builds: each
    run's client numbers, overload envelope and launches are printed and
    written to ``server_repeat.json`` in the output directory; the first
    failure ends the run with its error."""
    device = torch.device("cuda", 0)
    with ThreadPoolExecutor(len(BUILDS)) as pool:
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
    if len(sys.argv) > 1 and sys.argv[1] == "--framework":
        if not torch.cuda.is_available():
            sys.exit("chip_smoke: no CUDA device; nothing was run")
        sys.exit(framework_alone())
    if len(sys.argv) > 1 and sys.argv[1] == "--socket-client":
        sys.exit(socket_client(sys.argv[2:]))
    if len(sys.argv) > 1 and sys.argv[1] == "--split":
        if not torch.cuda.is_available():
            sys.exit("chip_smoke: no CUDA device; nothing was run")
        rest = [a for a in sys.argv[2:] if a != "--no-sweep"]
        parent = None
        if rest[:1] == ["--parent"]:
            parent, rest = rest[1], rest[2:]
        sys.exit(split_ab(rest, parent, "--no-sweep" not in sys.argv))
    if len(sys.argv) > 1 and sys.argv[1] == "--narrow":
        if not torch.cuda.is_available():
            sys.exit("chip_smoke: no CUDA device; nothing was run")
        rest = [a for a in sys.argv[2:] if a != "--no-sweep"]
        parent = None
        if rest[:1] == ["--parent"]:
            parent, rest = rest[1], rest[2:]
        sys.exit(narrow_ab(rest, parent, "--no-sweep" not in sys.argv))
    if len(sys.argv) > 1 and sys.argv[1] == "--exchange":
        if not torch.cuda.is_available():
            sys.exit("chip_smoke: no CUDA device; nothing was run")
        _cuda.build()
        sys.exit(exchange_ab(sys.argv[2:]))
    if len(sys.argv) > 2 and sys.argv[1] == "--ab":
        if not torch.cuda.is_available():
            sys.exit("chip_smoke: no CUDA device; nothing was run")
        sys.exit(ab(sys.argv[2], sys.argv[3:]))
    sys.exit(main())
