"""Stress/load harness with fault injection.

Reference: ``packages/test/test-service-load`` — configurable client
count/op rates (``testConfig.json`` profiles, e.g. the ci profile's 120
clients x 10k ops), random client kill/offline windows via
``faultInjectionDriver.ts``, and end-of-run convergence verification.

A :class:`LoadProfile` drives N ``ContainerRuntime`` clients against any
service (in-proc, partitioned pipeline, or network sockets — the harness
only needs the ``connect``/``store`` duck surface). Faults are offline
windows: a client disconnects mid-run, keeps editing (buffered for
resubmission), then reconnects and rebases. The run report carries
throughput and fault counts; the final assertion is the only one that
matters — every replica converged to identical channel state.

Every replica's ``SharedString`` and ``SharedTree`` hold their state on
the runner's ``device``: the card by default (raising without one), the
CPU (the kernels' plain versions) when named.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

from fluidframework_tpu_torch.models.shared_map import SharedMap
from fluidframework_tpu_torch.models.shared_string import SharedString
from fluidframework_tpu_torch.protocol.types import MessageType
from fluidframework_tpu_torch.runtime.container import ContainerRuntime
from fluidframework_tpu_torch.telemetry import journal
from fluidframework_tpu_torch.telemetry import metrics as _metrics
from fluidframework_tpu_torch.testing import faults
from fluidframework_tpu_torch.tree.shared_tree import SharedTree
from fluidframework_tpu_torch.utils import resolve_device

ALPHABET = "abcdefghijklmnopqrstuvwxyz"


@dataclass
class LoadProfile:
    """The testConfig.json analog."""

    n_clients: int = 4
    total_ops: int = 400
    seed: int = 0
    # Probability per scheduled op that the acting client starts an offline
    # window (disconnect -> keep editing -> reconnect after `offline_ops`
    # further global steps).
    fault_rate: float = 0.0
    offline_ops: int = 20
    flush_every: int = 3
    process_every: int = 5
    string_weight: float = 0.7  # vs map ops
    # Probability an op targets a SharedTree channel instead: the
    # tree mix includes first-class MOVE edits (mout/min on the wire), so
    # the load envelope exercises the device-native move path and its
    # rebase/convergence under faults — not just string/map traffic.
    tree_weight: float = 0.0
    tree_move_weight: float = 0.35  # of tree ops, how many are moves
    doc_id: str = "load-doc"
    # Service-side chaos: per-invocation probability that an armed
    # injection site faults (testing/faults.py FailProb, seeded from
    # chaos_seed — deterministic schedule per run). Only sites whose
    # recovery is transparent to clients belong here; crash-at-boundary
    # cases live in the targeted matrix (tests/test_faults.py) where the
    # harness plays the restart supervisor.
    chaos_rate: float = 0.0
    chaos_sites: tuple = ("store.append", "queue.send", "pump.dispatch")
    chaos_seed: int = 0
    # Full client stack under chaos: every runtime gets the
    # auto-summarize interval (the quorum-elected client actually
    # summarizes, the reference SummaryManager shape) and the acting
    # client runs a GC pass every
    # ``gc_every`` global steps — so summaries, GC sweeps, and (with the
    # service's default foreman) service task assignment all ride the
    # faulted pipeline, not just raw op traffic.
    summary_interval: Optional[int] = None
    gc_every: int = 0


@dataclass
class LoadReport:
    ops_submitted: int = 0
    faults_injected: int = 0
    chaos_injected: int = 0  # service-side faults injected (chaos_rate)
    reconnects: int = 0
    nacks: int = 0
    elapsed_s: float = 0.0
    converged: bool = False
    final_text_len: int = 0
    texts: list = field(default_factory=list)  # per-replica, for divergence triage
    annotations: list = field(default_factory=list)
    tree_ops_submitted: int = 0
    tree_moves_submitted: int = 0
    trees: list = field(default_factory=list)  # per-replica tree views
    summaries: int = 0  # summarize ops sequenced during the run
    gc_runs: int = 0
    # Flight recorder: on a convergence/parity failure the journal
    # auto-dumps into its configured dump_dir (the chaos harness points
    # it at the test artifact dir) and the path lands here — "replicas
    # diverged" arrives with the event stream that explains it.
    journal_dump: Optional[str] = None
    # tree_ingest_commits_total{path,reason} DELTA over the run — the
    # host_fallback_reason burn-down view.
    tree_ingest: dict = field(default_factory=dict)

    @property
    def ops_per_sec(self) -> float:
        return self.ops_submitted / self.elapsed_s if self.elapsed_s else 0.0


# Chaos envelopes: service-side fault injection on top of the client
# offline windows. The smoke profile is CI-sized; the stress profile is
# slow-marked in tests/test_torch_load.py; the reference profile is the
# upstream ci shape (120 clients x 10k ops, test-service-load
# testConfig.json) — the target the stress profile grows toward.
CHAOS_SMOKE_PROFILE = LoadProfile(
    n_clients=16, total_ops=400, seed=13, fault_rate=0.01, offline_ops=20,
    chaos_rate=0.02, doc_id="chaos-smoke",
)
CHAOS_STRESS_PROFILE = LoadProfile(
    n_clients=48, total_ops=3000, seed=17, fault_rate=0.005, offline_ops=40,
    chaos_rate=0.01, doc_id="chaos-stress",
)
CHAOS_REFERENCE_PROFILE = LoadProfile(
    n_clients=120, total_ops=10_000, seed=23, fault_rate=0.005,
    offline_ops=60, chaos_rate=0.01, doc_id="chaos-reference",
)
# The stress shape with the
# FULL client stack active — tree traffic (move-bearing, so the device
# EM path and its host_fallback_reason buckets are exercised), the
# elected summarizer, periodic GC, and the service-side foreman (on by
# default in PipelineFluidService) — all under the standard chaos mix.
CHAOS_STRESS_FULL_PROFILE = LoadProfile(
    n_clients=48, total_ops=3000, seed=17, fault_rate=0.005,
    offline_ops=40, chaos_rate=0.01, doc_id="chaos-stress-full",
    tree_weight=0.25, summary_interval=150, gc_every=300,
)


class LoadRunner:
    """Runs one profile against one service instance; the replicas'
    string and tree state lives on ``device``."""

    def __init__(self, service, profile: LoadProfile,
                 service_for_client: Optional[Callable[[int], object]] = None,
                 device="cuda"):
        self.service = service
        self.profile = profile
        self.device = resolve_device(device)
        # Network runs need one client-side facade per client; in-proc runs
        # share the service object.
        self._svc_for = service_for_client or (lambda i: service)

    def run(self) -> LoadReport:
        p = self.profile
        if p.chaos_rate > 0:
            pre_injected = faults.REGISTRY.injected_total()
            for i, site in enumerate(p.chaos_sites):
                faults.arm(
                    site, faults.FailProb(p.chaos_rate, seed=p.chaos_seed + i)
                )
            try:
                report = self._run(p)
            finally:
                for site in p.chaos_sites:
                    faults.disarm(site)
            report.chaos_injected = (
                faults.REGISTRY.injected_total() - pre_injected
            )
            return report
        return self._run(p)

    def _run(self, p: LoadProfile) -> LoadReport:
        rng = np.random.default_rng(p.seed)
        report = LoadReport()
        t0 = time.monotonic()

        def channels():
            chans = [SharedString("text", device=self.device),
                     SharedMap("map")]
            if p.tree_weight > 0:
                chans.append(SharedTree("tree", device=self.device))
            return tuple(chans)

        runtimes: List[ContainerRuntime] = [
            ContainerRuntime(self._svc_for(i), p.doc_id, channels=channels())
            for i in range(p.n_clients)
        ]
        for rt in runtimes:
            rt.on_nack_count = 0
            if p.summary_interval:
                # Every client is summarize-eligible; the quorum
                # election picks the actual summarizer (oldest writer),
                # exactly the reference SummaryManager shape.
                rt.summary_interval = p.summary_interval

        def _ingest_buckets() -> dict:
            c = _metrics.REGISTRY.get("tree_ingest_commits_total")
            if c is None:
                return {}
            return {
                f"{dict(k)['path']}:{dict(k)['reason']}": v
                for k, _s, v in c.samples()
            }

        pre_ingest = _ingest_buckets()
        offline_until: dict = {}  # runtime index -> step to reconnect at

        def one_tree_op(rt: ContainerRuntime) -> None:
            t = rt.get_channel("tree")
            n = len(t.get())
            report.tree_ops_submitted += 1
            if n >= 4 and rng.random() < p.tree_move_weight:
                i0 = int(rng.integers(0, n - 1))
                cnt = int(rng.integers(1, min(3, n - i0) + 1))
                dest = int(rng.integers(0, n - cnt + 1))
                t.move_nodes(i0, cnt, dest)
                report.tree_moves_submitted += 1
            elif n > 12 and rng.random() < 0.5:
                i0 = int(rng.integers(0, n - 1))
                t.delete_nodes(i0, min(int(rng.integers(1, 3)), n - i0))
            else:
                pos = int(rng.integers(0, n + 1))
                t.insert_nodes(
                    pos, [int(rng.integers(0, 1000))
                          for _ in range(int(rng.integers(1, 3)))]
                )

        def one_op(rt: ContainerRuntime) -> None:
            if p.tree_weight > 0 and rng.random() < p.tree_weight:
                one_tree_op(rt)
                return
            s = rt.get_channel("text")
            length = len(s.get_text())
            if rng.random() < p.string_weight:
                if length > 4 and rng.random() < 0.4:
                    a = int(rng.integers(0, length - 1))
                    b = min(length, a + int(rng.integers(1, 4)))
                    if rng.random() < 0.3:
                        s.annotate(a, b, int(rng.integers(1, 9)))
                    else:
                        s.remove_range(a, b)
                else:
                    pos = int(rng.integers(0, length + 1))
                    txt = "".join(
                        rng.choice(list(ALPHABET), int(rng.integers(1, 4)))
                    )
                    s.insert_text(pos, txt)
            else:
                m = rt.get_channel("map")
                m.set(str(int(rng.integers(0, 12))), int(rng.integers(0, 100)))

        for step in range(p.total_ops):
            # Scheduled reconnects first.
            for i, until in list(offline_until.items()):
                if step >= until:
                    runtimes[i].reconnect()
                    report.reconnects += 1
                    del offline_until[i]

            i = int(rng.integers(0, p.n_clients))
            rt = runtimes[i]
            one_op(rt)
            report.ops_submitted += 1

            online = i not in offline_until
            if online and p.fault_rate > 0 and rng.random() < p.fault_rate:
                # Offline window: drain in-flight state, then drop.
                rt.flush()
                self._settle(runtimes, offline_until)
                rt.process_incoming()
                rt.disconnect()
                offline_until[i] = step + 1 + int(rng.integers(1, p.offline_ops))
                report.faults_injected += 1
                continue
            if online and step % p.flush_every == 0:
                rt.flush()
            if (
                p.gc_every and online and step
                and step % p.gc_every == 0
            ):
                # Periodic GC on the acting client: the sweep rides the
                # same faulted pipeline as the op traffic. GC summarizes
                # every channel, so it needs a locally-quiesced client
                # (the same bar the auto-summarizer applies) — settle
                # first and skip if in-flight state survives the drain.
                rt.flush()
                self._settle(runtimes, offline_until)
                rt.process_incoming()
                if not rt._has_unacked_local_state():
                    rt.run_gc()
                    report.gc_runs += 1
            if step % p.process_every == 0:
                self._settle(runtimes, offline_until)

        # Drain: reconnect everyone, flush, process to quiescence.
        for i in sorted(offline_until):
            runtimes[i].reconnect()
            report.reconnects += 1
        offline_until.clear()
        for rt in runtimes:
            rt.flush()
        deadline = time.monotonic() + 30
        quiet = 0
        while quiet < 3 and time.monotonic() < deadline:
            progressed = False
            for rt in runtimes:
                if rt.process_incoming():
                    progressed = True
                rt.flush()
            if progressed:
                quiet = 0
            else:
                quiet += 1
                time.sleep(0.005)

        texts = [rt.get_channel("text").get_text() for rt in runtimes]
        annos = [rt.get_channel("text").annotations() for rt in runtimes]
        maps = [
            {k: rt.get_channel("map").get(k) for k in rt.get_channel("map").keys()}
            for rt in runtimes
        ]
        report.texts = texts
        report.annotations = annos
        trees = (
            [rt.get_channel("tree").get() for rt in runtimes]
            if p.tree_weight > 0
            else []
        )
        report.trees = trees
        report.converged = (
            all(t == texts[0] for t in texts)
            and all(a == annos[0] for a in annos)
            and all(m == maps[0] for m in maps)
            and all(t == trees[0] for t in trees)
        )
        if not report.converged:
            report.journal_dump = journal.auto_dump("load-divergence")
        report.final_text_len = len(texts[0])
        report.nacks = sum(len(rt.connection.nacks) for rt in runtimes)
        post_ingest = _ingest_buckets()
        report.tree_ingest = {
            k: int(v - pre_ingest.get(k, 0))
            for k, v in post_ingest.items()
            if v - pre_ingest.get(k, 0) > 0
        }
        if p.summary_interval:
            get_deltas = getattr(self.service, "get_deltas", None)
            if get_deltas is not None:
                report.summaries = sum(
                    1 for m in get_deltas(p.doc_id)
                    if m.type == MessageType.SUMMARIZE
                )
        report.elapsed_s = time.monotonic() - t0
        for rt in runtimes:
            if rt.connected:
                rt.disconnect()
        return report

    def _settle(self, runtimes, offline_until) -> None:
        for j, other in enumerate(runtimes):
            if j not in offline_until:
                other.process_incoming()
