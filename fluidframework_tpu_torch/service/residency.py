"""Fleet-as-cache: per-document residency lifecycle for the serving fleet.

Reference: deli expires idle clients (ClientSequenceTimeout) and emits a
NoClient system op when the last one departs (PAPER.md §2.5 — the
service's end-of-session trigger); routerlicious then summarizes and
lets the in-memory session lapse, because a service addressing millions
of documents cannot keep every one of them materialized. This repo had
the durable tier for that already — the scribe summary pointer in
historian's ``LatestSummaryCache`` plus the ``DocOpLog`` delta tail —
but every document ever served held a DocFleet slot forever, so fleet
HBM capped the *addressable* corpus, not the *working set*.

This module turns fleet memory into a managed cache over that durable
tier — the residency/paging discipline an inference stack applies to KV
caches. Two pieces:

- :class:`HeatTracker` — the decayed per-document op-rate signal,
  extracted from the multi-node rebalancer (``service/multinode.py``) so
  single-node residency and multi-node placement score heat IDENTICALLY.
  The tracker also fixes the rebalancer's cold-start bias: raw decayed
  accumulators are only comparable between documents of equal age (an
  aged doc at a steady r ops/window accumulates ``r/(1-decay)`` while a
  brand-new doc's first window scores its raw count), so :meth:`rate`
  normalizes by the observed decay-window mass — an unbiased per-window
  rate estimate whatever the document's age.

- :class:`ResidencyManager` — the per-document lifecycle

      RESIDENT -> IDLE -> HIBERNATING -> COLD -> WAKING -> RESIDENT

  RESIDENT documents serve from fleet slots; IDLE means the sequencer's
  client lifecycle reports no live clients (``maybe_no_client`` /
  ``expire_idle`` — the deli idleness signal, not a guess from traffic);
  HIBERNATING is the off-loop summarize→durable-pointer→evict walk;
  COLD documents hold no fleet slot (durable form: latest summary +
  delta tail); the first op to a COLD document begins a WAKE — restore
  through the crash-rebuild path, admitted as a normal boxcar, with
  in-flight ops parked in a bounded pending queue (never dropped, never
  reordered) until the slot is live again.

The manager is deliberately mechanism-free: it owns states, heat,
hit/miss accounting, and the telemetry contract (``residency_docs``,
``residency_wakes_total``, ``residency_hit_ratio``, the wake-latency
histogram, journal events ``doc.hibernate``/``doc.wake``); the actual
summarize/evict/restore mechanics live with their owners
(``DeviceFleetBackend.hibernate_doc``/``wake_doc``, the fleet's
demotion walk, the pipeline's sweep).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from fluidframework_tpu_torch.telemetry import journal

# -- the lifecycle vocabulary -------------------------------------------------

RESIDENT = "resident"
IDLE = "idle"
HIBERNATING = "hibernating"
COLD = "cold"
WAKING = "waking"

#: Every state the manager may report — the ``residency_docs{state}``
#: gauge exposes exactly these labels (telemetry/README.md).
STATES: Tuple[str, ...] = (RESIDENT, IDLE, HIBERNATING, COLD, WAKING)

#: Wake outcomes for ``residency_wakes_total{outcome}``: ``ok`` (slot
#: restored), ``retry`` (a faulted wake left durable state unchanged —
#: the next op re-attempts), ``noop`` (raced: already resident).
WAKE_OUTCOMES: Tuple[str, ...] = ("ok", "retry", "noop")


class HeatTracker:
    """Decayed per-document op rate, shared by the multi-node rebalancer
    and the residency manager.

    ``touch`` adds raw weight; ``observe_window`` closes one decay
    window (raw ``*= decay``, window count ``+= 1``). :meth:`rate`
    returns the window-normalized estimate::

        rate(d) = raw(d) * (1 - decay) / (1 - decay ** (windows(d) + 1))

    i.e. the raw accumulator divided by the geometric mass of the
    windows the document was actually observed for (the current partial
    window counts at full mass — conservative for brand-new documents).
    A steady r-ops/window document scores r at ANY age; under the raw
    scheme it scored anywhere from r (first window) to r/(1-decay)
    (aged), so rankings mixed ages incomparably — the cold-start bias
    this extraction fixes (regression-tested for both consumers in
    tests/test_residency.py).
    """

    # Past ~60 windows the geometric mass is 1/(1-decay) to double
    # precision; capping keeps ``decay ** w`` out of denormal territory.
    _W_CAP = 60

    def __init__(self, decay: float = 0.5):
        assert 0.0 < decay < 1.0, decay
        self.decay = float(decay)
        self._raw: Dict[str, float] = {}
        self._windows: Dict[str, int] = {}

    def touch(self, doc: str, n: float = 1.0) -> None:
        self._raw[doc] = self._raw.get(doc, 0.0) + float(n)

    def observe_window(self, decay: Optional[float] = None,
                       prune_below: float = 1e-4) -> None:
        """Close one decay window for every tracked document. Entries
        whose raw weight decays below ``prune_below`` are dropped — at a
        million-document corpus the tracker must not retain every id
        ever touched (a pruned doc that comes back is simply new)."""
        d = self.decay if decay is None else float(decay)
        for doc in list(self._raw):
            raw = self._raw[doc] * d
            if raw < prune_below:
                del self._raw[doc]
                self._windows.pop(doc, None)
            else:
                self._raw[doc] = raw
                w = self._windows.get(doc, 0)
                if w < self._W_CAP:
                    self._windows[doc] = w + 1

    def raw(self, doc: str) -> float:
        return self._raw.get(doc, 0.0)

    def rate(self, doc: str) -> float:
        raw = self._raw.get(doc)
        if raw is None:
            return 0.0
        w = self._windows.get(doc, 0)
        return raw * (1.0 - self.decay) / (1.0 - self.decay ** (w + 1))

    def docs(self) -> List[str]:
        return list(self._raw)

    def forget(self, doc: str) -> None:
        self._raw.pop(doc, None)
        self._windows.pop(doc, None)

    # -- migration hand-off (multi-node rebalance) ---------------------------

    def export(self, doc: str) -> Tuple[float, int]:
        """(raw, windows) for handing a document's heat to its new
        owner — a migrated document must not restart cold-start
        normalization from zero on the destination node."""
        return self._raw.get(doc, 0.0), self._windows.get(doc, 0)

    def adopt(self, doc: str, raw: float, windows: int) -> None:
        self._raw[doc] = float(raw)
        if windows > 0:
            self._windows[doc] = min(int(windows), self._W_CAP)

    def __len__(self) -> int:
        return len(self._raw)


# -- the telemetry contract (registered in ONE place, the
#    tree_ingest_counter idiom: benches and tests resolve the same
#    family through these, so /metrics can never miss them) -------------------


def residency_docs_gauge(registry=None):
    from fluidframework_tpu_torch.telemetry import metrics

    reg = registry or metrics.REGISTRY
    return reg.gauge(
        "residency_docs",
        "documents per residency lifecycle state",
        labelnames=("state",),
    )


def residency_wakes_counter(registry=None):
    from fluidframework_tpu_torch.telemetry import metrics

    reg = registry or metrics.REGISTRY
    return reg.counter(
        "residency_wakes_total",
        "cold-document wakes by outcome (ok / retry / noop)",
        labelnames=("outcome",),
    )


def residency_hit_gauge(registry=None):
    from fluidframework_tpu_torch.telemetry import metrics

    reg = registry or metrics.REGISTRY
    return reg.gauge(
        "residency_hit_ratio",
        "fraction of ops that found their document fleet-resident",
    )


def wake_latency_histogram(registry=None):
    from fluidframework_tpu_torch.telemetry import metrics

    reg = registry or metrics.REGISTRY
    return reg.histogram(
        "residency_wake_latency_ms",
        "cold-op wake latency: first parked op to slot restored",
    )


class ResidencyManager:
    """Owns the residency lifecycle for every document the service has
    seen. Pure host state — no device access, no locks needed beyond the
    callers' existing serialization (the backend mutates it from the
    serving thread; the sweep runs off-loop but only through the
    backend's hibernate entry points, which the service serializes).

    ``max_resident`` is the slot budget the sweep steers toward (0 =
    unbounded: hibernation only happens for idle+cold documents).
    ``wake_pending_max`` bounds the per-document parked-op queue a
    WAKING document may accumulate — the bound is backpressure (the
    enqueue path forces the wake to completion rather than park more),
    NEVER a drop.
    """

    def __init__(
        self,
        max_resident: int = 0,
        heat: Optional[HeatTracker] = None,
        heat_floor: float = 0.5,
        wake_pending_max: int = 4096,
    ):
        self.heat = heat if heat is not None else HeatTracker()
        self.max_resident = int(max_resident)
        self.heat_floor = float(heat_floor)
        self.wake_pending_max = int(wake_pending_max)
        self._state: Dict[str, str] = {}
        self.hits = 0
        self.misses = 0
        self.hibernations = 0
        self.wakes: Dict[str, int] = {k: 0 for k in WAKE_OUTCOMES}
        self._wake_t0: Dict[str, float] = {}
        self.wake_ms: List[float] = []  # in-process latency record

    # -- queries --------------------------------------------------------------

    def state(self, doc: str) -> str:
        """The document's lifecycle state (an untracked document reads
        RESIDENT: it has never been evicted, so ops route normally)."""
        return self._state.get(doc, RESIDENT)

    def known(self, doc: str) -> bool:
        return doc in self._state

    def is_cold(self, doc: str) -> bool:
        return self._state.get(doc) in (COLD, HIBERNATING, WAKING)

    def counts(self) -> Dict[str, int]:
        out = {s: 0 for s in STATES}
        for s in self._state.values():
            out[s] += 1
        return out

    def resident_docs(self) -> List[str]:
        return [
            d for d, s in self._state.items() if s in (RESIDENT, IDLE)
        ]

    def hit_ratio(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 1.0

    # -- the op path ----------------------------------------------------------

    def note_admit(self, doc: str) -> None:
        """A document entered the fleet (first channel registered)."""
        self._state.setdefault(doc, RESIDENT)

    def note_op(self, doc: str, n: float = 1.0) -> bool:
        """Account one (or n) sequenced ops against the document. Returns
        True when the document is fleet-resident (cache hit) — False
        means the op just missed (COLD/HIBERNATING/WAKING) and the
        caller must run the wake path."""
        self.heat.touch(doc, n)
        s = self._state.get(doc)
        if s is None:
            self._state[doc] = RESIDENT
            self.hits += 1
            return True
        if s in (RESIDENT, IDLE):
            if s == IDLE:
                self._state[doc] = RESIDENT
            self.hits += 1
            return True
        self.misses += 1
        return False

    def mark_idle(self, doc: str) -> bool:
        """The sequencer's client lifecycle reports no live clients
        (NoClient emitted / every client expired): a RESIDENT document
        steps to IDLE — the only state hibernation may start from."""
        if self._state.get(doc) == RESIDENT:
            self._state[doc] = IDLE
            return True
        return False

    # -- hibernation ----------------------------------------------------------

    def hibernation_candidates(self, want: int = 0) -> List[str]:
        """IDLE documents cold enough to hibernate, coldest-first (the
        age-normalized heat rate — NOT the raw accumulator, which would
        order brand-new documents ahead of aged equal-rate ones). With a
        ``max_resident`` budget, enough candidates to come back under
        budget; otherwise every idle doc under the heat floor."""
        idle = [d for d, s in self._state.items() if s == IDLE]
        idle.sort(key=lambda d: (self.heat.rate(d), d))
        over = 0
        if self.max_resident > 0:
            over = len(self.resident_docs()) - self.max_resident
        out = [d for d in idle if self.heat.rate(d) < self.heat_floor]
        if over > len(out):
            # Budget pressure overrides the heat floor: take the
            # coldest idle docs until the fleet fits.
            out = idle[:over]
        if want > 0:
            out = out[:want]
        return out

    def begin_hibernate(self, doc: str) -> bool:
        if self._state.get(doc) not in (RESIDENT, IDLE):
            return False
        self._state[doc] = HIBERNATING
        return True

    def finish_hibernate(self, doc: str, ok: bool, head: int = -1) -> None:
        """``ok``: the summarize→pointer→evict walk completed — the doc
        is COLD. Not ok (a faulted hibernate): the doc stays RESIDENT —
        the documented ``doc.hibernate`` recovery (a crashed hibernate
        never strands a document half-evicted)."""
        if ok:
            self._state[doc] = COLD
            self.hibernations += 1
            if journal._ON:
                journal.record("doc.hibernate", doc=doc, seq=head)
        else:
            self._state[doc] = RESIDENT

    # -- wake -----------------------------------------------------------------

    def begin_wake(self, doc: str) -> None:
        """First op landed on a COLD document: the wake clock starts at
        the first PARKED op, so the latency histogram measures what the
        client experienced, not what the restore cost."""
        if self._state.get(doc) != WAKING:
            self._state[doc] = WAKING
            self._wake_t0[doc] = time.perf_counter()

    def finish_wake(self, doc: str, outcome: str = "ok",
                    head: int = -1) -> float:
        """Record a wake attempt's outcome. ``ok`` restores RESIDENT and
        observes the latency histogram; ``retry`` keeps the doc WAKING
        (durable state unchanged — the next op re-attempts, the
        documented ``doc.wake`` recovery); ``noop`` means a raced wake
        found the slot already live. Returns the measured latency in ms
        (0 when no wake clock was running)."""
        assert outcome in WAKE_OUTCOMES, outcome
        self.wakes[outcome] += 1
        residency_wakes_counter().inc(outcome=outcome)
        ms = 0.0
        t0 = self._wake_t0.get(doc)
        if outcome == "retry":
            return ms
        if t0 is not None:
            ms = (time.perf_counter() - t0) * 1e3
            del self._wake_t0[doc]
        if outcome == "ok":
            self._state[doc] = RESIDENT
            self.wake_ms.append(ms)
            wake_latency_histogram().observe(ms)
            if journal._ON:
                journal.record(
                    "doc.wake", doc=doc, seq=head,
                    latency_ms=round(ms, 3),
                )
        return ms

    # -- migration hand-off ---------------------------------------------------

    def export_doc(self, doc: str) -> Tuple[str, float, int]:
        """(state, heat raw, heat windows) — the residency state a
        migrating document carries to its new owner node."""
        return (self.state(doc), *self.heat.export(doc))

    def adopt_doc(self, doc: str, state: str, raw: float,
                  windows: int) -> None:
        assert state in STATES, state
        self._state[doc] = state
        self.heat.adopt(doc, raw, windows)

    def forget(self, doc: str) -> None:
        """Drop a document entirely (released to another owner)."""
        self._state.pop(doc, None)
        self._wake_t0.pop(doc, None)
        self.heat.forget(doc)

    # -- exposition -----------------------------------------------------------

    def publish_metrics(self, registry=None) -> None:
        g = residency_docs_gauge(registry)
        for s, n in self.counts().items():
            g.set(n, state=s)
        residency_hit_gauge(registry).set(round(self.hit_ratio(), 6))

    def wake_p99_ms(self) -> float:
        """p99 over the in-process wake latency record (the bench
        headline; /metrics serves the histogram form)."""
        if not self.wake_ms:
            return 0.0
        xs = sorted(self.wake_ms)
        i = min(len(xs) - 1, int(round(0.99 * (len(xs) - 1))))
        return xs[i]

    def stats(self) -> dict:
        return {
            "states": self.counts(),
            "hits": self.hits,
            "misses": self.misses,
            "hit_ratio": round(self.hit_ratio(), 6),
            "hibernations": self.hibernations,
            "wakes": dict(self.wakes),
            "wake_p99_ms": round(self.wake_p99_ms(), 3),
            "tracked_heat": len(self.heat),
        }
