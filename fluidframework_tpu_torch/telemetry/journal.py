"""Flight recorder: a bounded op-lineage journal with auto-dump on failure.

The trace spine and the metrics registry answer *how fast*; nothing in
the process could answer *what happened* after a failure — a chaos parity
miss, a ``retry_attempts_total{outcome=fatal|exhausted}`` event, or an
err-bitmask lane trip left only aggregate counters. Reference: alfred's
``ITrace[]`` ride-along plus the per-lambda ``Lumberjack`` completion
events are exactly this kind of black box (PAPER.md §telemetry) — a typed
event stream a human reads *after* the crash, not a dashboard.

One process-global, bounded, lock-cheap ring (:data:`JOURNAL`) of typed
:class:`Event` records:

- **Typed vocabulary** (:data:`EVENTS`): frame/op lifecycle at every
  stage boundary the trace spine names (submit → admit → ticket →
  append → stage → dispatch → commit → broadcast), plus fault
  injections, retry outcomes, shed-tier transitions, lease epoch
  fences, backpressure readings, and ``host_fallback_reason``
  attributions. An undeclared kind raises — the same static discipline
  as ``faults.SITES``.
- **Correlated**: every entry carries ``(doc, seq, csn, client)`` keys
  (ranges for frames/boxcars — device events carry per-channel
  ``spans``), so :func:`lineage` reconstructs one op's full path from
  whatever reached the ring.
- **Bounded**: a ``deque(maxlen=capacity)`` ring — oldest entries evict
  first, eviction is O(1), and the journal can never grow the process.
- **Near-zero when disabled**: every producer site is gated on the
  module-global :data:`_ON` predicate (the ``faults._ARMED``
  discipline); disabled, a site costs one attribute read and allocates
  NOTHING (counting-shim-tested).
- **Zero device readbacks**: the journal consumes host state only — the
  existing one-boxcar-stale scan results and /metrics scrape data. A
  journal producer that runs its own device→host transfer is a
  graftlint host-sync failure, not a design option.

Three dump surfaces:

- ``GET /debugz`` on the network front door and the store node
  (:func:`render` — replica-DETERMINISTIC: two replicas that observed
  the same events render byte-equal text, so wall timestamps are file-
  dump-only; exempt from shed tiers exactly like ``/metrics``).
- :func:`auto_dump` — fired on any fatal/exhausted retry outcome
  (service/retry.py), a fail-closed admission crash
  (service/admission.py), or an err-lane trip
  (service/device_backend.py). Writes one JSON file (WITH wall
  timestamps) into the configured ``dump_dir``; budget-capped so a
  crash loop cannot fill a disk. The file write is the ``journal.dump``
  fault site: a failed dump is counted
  (``retry_attempts_total{journal.dump,fallback}``) and absorbed — the
  flight recorder must never take down the flight.
- The chaos harness (tests/test_faults.py, testing/load.py) dumps into
  the test artifact dir on any parity failure, turning "bit-exact
  assertion failed" into a diagnosable event stream.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from fluidframework_tpu_torch.telemetry.metrics import _fmt as _metrics_fmt
from fluidframework_tpu_torch.testing.faults import inject_fault

# Dump filenames must never collide with an EARLIER post-mortem file —
# reset() zeroes the per-run budget, so the name rides this never-reset
# process-wide sequence (plus the pid for shared dump dirs): a later
# failure must not overwrite the evidence of an earlier one.
_DUMP_SEQ = itertools.count()

# ---------------------------------------------------------------------------
# Event vocabulary: every kind a producer may record, with its meaning.
# Like ``faults.SITES``, this is the static acceptance mechanism — an
# unknown kind raises at record time, so the /debugz surface can never
# grow an undocumented event stream.

EVENTS: Dict[str, str] = {
    # -- the op lifecycle (the lineage path) --------------------------------
    "frame.submit": "front-door write submit (doc, client, csn range)",
    "admission.admit": "admission check passed for a write submit",
    "admission.deny": "admission denied: throttling nack + retry_after",
    "frame.ticket": "deli vectorized ticket: csn range -> seq range",
    "frame.nack": "deli nacked the frame (dup / cap / order)",
    "log.append": "scriptorium durable DocOpLog append (seq range)",
    "device.stage": "boxcar staged into the ingest ring (channel spans)",
    "device.dispatch": "boxcar dispatched to the device (channel spans)",
    "device.commit": "health scan consumed: boxcar committed (spans)",
    "broadcast": "room fan-out of a sequenced frame (seq range)",
    # -- failure / recovery -------------------------------------------------
    "device.err": "sticky err lane tripped for a channel",
    "fault.injected": "a chaos fault fired at a named site",
    "retry.outcome": "a recovery event (retry_attempts_total mirror)",
    "shed.transition": "overload shed-tier transition",
    "pressure": "backpressure reading (ring/queue/feed-lag)",
    "lease.fence": "epoch fence rejected a stale lease owner",
    "tree.fallback": "SharedTree ingest host-fallback attribution",
    "journal.dump": "the flight recorder dumped itself to a file",
    # The loop-stall watchdog (telemetry/profiler.py + the network
    # server's lag sentinel): the asyncio serving loop overshot its
    # expected tick by more than the stall threshold — a blocking call
    # (a readback regression, a synchronous compile) landed on the loop.
    "loop.stall": "asyncio serving-loop tick overshot the stall threshold",
    # -- document residency -------------------------------------------
    "doc.hibernate": "doc summarized, durable pointer updated, slot evicted",
    "doc.wake": "COLD doc restored to a fleet slot on first op (latency_ms)",
}


def _fmt(v) -> str:
    """One shared value formatter — floats delegate to the metrics
    exposition's formatter so /debugz and /metrics can never diverge on
    the same value — so two replicas render byte-equal text."""
    return _metrics_fmt(v) if isinstance(v, float) else str(v)


class Event:
    """One journal entry. ``seq``/``csn`` default to -1 (absent); range
    events set ``seq_hi``/``csn_hi`` (inclusive); boxcar-level device
    events carry per-channel ``spans`` — a tuple of ``(doc, lo, hi)``
    seq runs — instead of a single doc. ``detail`` is a sorted tuple of
    ``(key, value)`` pairs (deterministic render order). ``ts`` is wall
    time for file dumps only: the deterministic /debugz render excludes
    it by contract."""

    __slots__ = (
        "eid", "ts", "kind", "doc", "seq", "seq_hi", "csn", "csn_hi",
        "client", "spans", "detail",
    )

    def __init__(
        self, eid: int, ts: float, kind: str, doc: str, seq: int,
        seq_hi: int, csn: int, csn_hi: int, client: int,
        spans: Tuple[Tuple[str, int, int], ...], detail: Tuple,
    ):
        self.eid = eid
        self.ts = ts
        self.kind = kind
        self.doc = doc
        self.seq = seq
        self.seq_hi = seq_hi
        self.csn = csn
        self.csn_hi = csn_hi
        self.client = client
        self.spans = spans
        self.detail = detail

    def covers(self, doc: str, seq: int, client: int, csn: int) -> bool:
        """Does this entry belong to op ``(doc, seq)`` (with the op's
        resolved ``(client, csn)`` identity, -1 when unknown)?"""
        if self.spans:
            return any(
                d == doc and lo <= seq <= hi for d, lo, hi in self.spans
            )
        if self.doc != doc:
            return False
        if self.seq >= 0:
            return self.seq <= seq <= self.seq_hi
        if self.csn >= 0 and client >= 0:
            return self.client == client and self.csn <= csn <= self.csn_hi
        return False

    def format(self) -> str:
        """Deterministic one-line render (no wall timestamp)."""
        parts = [f"{self.eid:06d}", self.kind]
        if self.doc:
            parts.append(f"doc={self.doc}")
        if self.seq >= 0:
            parts.append(
                f"seq={self.seq}" if self.seq_hi == self.seq
                else f"seq={self.seq}..{self.seq_hi}"
            )
        if self.csn >= 0:
            parts.append(
                f"csn={self.csn}" if self.csn_hi == self.csn
                else f"csn={self.csn}..{self.csn_hi}"
            )
        if self.client >= 0:
            parts.append(f"client={self.client}")
        if self.spans:
            parts.append(
                "spans="
                + ",".join(f"{d}:{lo}..{hi}" for d, lo, hi in self.spans)
            )
        for k, v in self.detail:
            parts.append(f"{k}={_fmt(v)}")
        return " ".join(parts)

    def to_dict(self) -> dict:
        """The file-dump form (WITH the wall timestamp)."""
        out = {"eid": self.eid, "ts": round(self.ts, 6), "kind": self.kind}
        if self.doc:
            out["doc"] = self.doc
        if self.seq >= 0:
            out["seq"] = self.seq
            out["seq_hi"] = self.seq_hi
        if self.csn >= 0:
            out["csn"] = self.csn
            out["csn_hi"] = self.csn_hi
        if self.client >= 0:
            out["client"] = self.client
        if self.spans:
            out["spans"] = [list(s) for s in self.spans]
        if self.detail:
            out["detail"] = {k: v for k, v in self.detail}
        return out


class Journal:
    """A bounded ring of :class:`Event`. All mutation is lock-guarded
    (the websocket server records from its event-loop thread while the
    test/bench thread reads); the lock covers one id increment and one
    deque append — lock-cheap by construction."""

    def __init__(self, capacity: int = 4096):
        self.capacity = max(16, int(capacity))
        self._ring: Deque[Event] = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._next = 0
        # Auto-dump budget: a crash loop must not fill a disk. The
        # budget resets with reset() (per test / per run).
        self.dump_dir: Optional[str] = None
        self.max_dumps = 8
        self._dumps = 0

    # -- recording -------------------------------------------------------------

    def record(
        self,
        kind: str,
        doc: str = "",
        seq: int = -1,
        seq_hi: Optional[int] = None,
        csn: int = -1,
        csn_hi: Optional[int] = None,
        client: int = -1,
        spans: Tuple[Tuple[str, int, int], ...] = (),
        **detail,
    ) -> None:
        if kind not in EVENTS:
            raise ValueError(
                f"unknown journal event kind {kind!r} "
                f"(vocabulary: {', '.join(sorted(EVENTS))})"
            )
        ev = Event(
            0, time.time(), kind, doc, seq,
            seq if seq_hi is None else seq_hi,
            csn, csn if csn_hi is None else csn_hi, client, spans,
            tuple(sorted(detail.items())),
        )
        with self._lock:
            ev.eid = self._next
            self._next += 1
            self._ring.append(ev)  # maxlen evicts oldest-first

    # -- reading ---------------------------------------------------------------

    def events(self) -> List[Event]:
        with self._lock:
            return list(self._ring)

    @property
    def seen(self) -> int:
        """Total events ever recorded (evicted = seen - len(events))."""
        return self._next

    @property
    def evicted(self) -> int:
        with self._lock:
            return self._next - len(self._ring)

    def lineage(self, doc: str, seq: int) -> List[Event]:
        """Every ring entry belonging to op ``(doc, seq)``, in record
        order: the ticket event resolves the op's ``(client, csn)``
        identity, which then pulls in the pre-sequencing half (submit /
        admit — stamped before a sequence number exists); seq-ranged and
        span-carrying events match directly. The reconstruction is best-
        effort by design: entries that aged out of the ring are gone
        (the ring is bounded), and whatever remains renders in order."""
        evs = self.events()
        client = csn = -1
        for ev in evs:
            if (
                ev.kind == "frame.ticket"
                and ev.doc == doc
                and ev.seq <= seq <= ev.seq_hi
            ):
                client = ev.client
                csn = ev.csn + (seq - ev.seq)
                break
        return [ev for ev in evs if ev.covers(doc, seq, client, csn)]

    # -- rendering / dumping ---------------------------------------------------

    def render(self) -> str:
        """The ``GET /debugz`` payload: replica-deterministic text — two
        replicas that observed the same events render byte-equal output
        (event ids are logical, wall timestamps are excluded; the same
        bar as the /metrics exposition)."""
        with self._lock:
            evs = list(self._ring)
            seen = self._next
        lines = [
            "# flight-recorder "
            f"events={len(evs)} seen={seen} "
            f"evicted={seen - len(evs)} capacity={self.capacity}"
        ]
        lines.extend(ev.format() for ev in evs)
        return "\n".join(lines) + "\n"

    @inject_fault("journal.dump")
    def _write_dump(self, path: str, payload: str) -> None:
        """The file-write boundary (the ``journal.dump`` fault site): a
        failed dump is counted and ABSORBED by :meth:`auto_dump` — the
        flight recorder is best-effort and must never become the outage
        it exists to explain."""
        with open(path, "w", encoding="utf-8") as f:
            f.write(payload)

    def dump_payload(self, reason: str) -> str:
        """One dump document (JSON, WITH wall timestamps — the post-
        mortem form; /debugz stays timestamp-free for determinism)."""
        with self._lock:
            evs = list(self._ring)
            seen = self._next
        return json.dumps(
            {
                "reason": reason,
                "seen": seen,
                "evicted": seen - len(evs),
                "capacity": self.capacity,
                "events": [ev.to_dict() for ev in evs],
            },
            indent=None,
            sort_keys=True,
        )

    def auto_dump(self, reason: str) -> Optional[str]:
        """Dump the ring to ``dump_dir`` (if configured and the budget
        allows); returns the file path or None. Never raises: a failed
        write lands on ``retry_attempts_total{journal.dump,fallback}``
        and is swallowed."""
        if not _ON or self.dump_dir is None:
            return None
        with self._lock:
            if self._dumps >= self.max_dumps:
                return None
            self._dumps += 1
        safe = "".join(c if c.isalnum() or c in "-_" else "_" for c in reason)
        path = os.path.join(
            self.dump_dir,
            f"journal-{os.getpid()}-{next(_DUMP_SEQ):04d}-{safe}.json",
        )
        payload = self.dump_payload(reason)
        try:
            self._write_dump(path, payload)
        except Exception:
            from fluidframework_tpu_torch.service import retry

            retry.retry_counter().inc(site="journal.dump", outcome="fallback")
            return None
        dumps_counter().inc(reason=reason)
        # Reason only — the path embeds pid + the process dump sequence,
        # and a ring entry carrying it would break the byte-equal
        # /debugz contract between replicas that observed the same
        # failure (the path is returned to the caller and named in the
        # file itself).
        self.record("journal.dump", reason=reason)
        return path

    # -- lifecycle -------------------------------------------------------------

    def reset(self) -> None:
        """Clear the ring, the id counter, and the dump budget (test
        isolation); configuration (capacity, dump_dir) persists."""
        with self._lock:
            self._ring.clear()
            self._next = 0
            self._dumps = 0


# The process-global journal (the metrics.REGISTRY idiom: module state,
# explicit reset for tests).
JOURNAL = Journal()

# Hot-path gate: a plain module global read by every producer site (the
# ``faults._ARMED`` discipline). False short-circuits before any kwargs
# build or Event allocation — the counting-shim test pins zero-alloc.
_ON = True


def enabled() -> bool:
    return _ON


def enable() -> None:
    global _ON
    _ON = True


def disable() -> None:
    global _ON
    _ON = False


def configure(
    dump_dir: Optional[str] = None,
    capacity: Optional[int] = None,
    max_dumps: Optional[int] = None,
) -> Journal:
    """Configure the process journal (dump directory for auto-dumps,
    ring capacity, dump budget). Resizing re-homes the ring's tail."""
    if dump_dir is not None:
        JOURNAL.dump_dir = dump_dir
    if max_dumps is not None:
        JOURNAL.max_dumps = int(max_dumps)
    if capacity is not None and int(capacity) != JOURNAL.capacity:
        with JOURNAL._lock:
            JOURNAL.capacity = max(16, int(capacity))
            JOURNAL._ring = deque(JOURNAL._ring, maxlen=JOURNAL.capacity)
    return JOURNAL


def record(kind: str, **kw) -> None:
    """Record one event on the process journal (producers gate on
    :data:`_ON` BEFORE building kwargs; this re-check makes direct calls
    safe too)."""
    if not _ON:
        return
    JOURNAL.record(kind, **kw)


def lineage(doc: str, seq: int) -> List[Event]:
    return JOURNAL.lineage(doc, seq)


def render() -> str:
    return JOURNAL.render()


def auto_dump(reason: str) -> Optional[str]:
    return JOURNAL.auto_dump(reason)


def reset() -> None:
    JOURNAL.reset()


def retry_outcome(site: str, outcome: str, doc: str = "") -> None:
    """Journal one recovery event (the ``retry_attempts_total`` mirror)
    and fire the auto-dump on the outcomes that mean an op needed its
    stage's replay contract: ``fatal`` (a crash propagated to the
    supervisor) and ``exhausted`` (a retry budget spent). The counter
    inc stays at the call site — this is the post-mortem side-channel,
    not the ledger."""
    if not _ON:
        return
    JOURNAL.record("retry.outcome", doc=doc, site=site, outcome=outcome)
    if outcome in ("fatal", "exhausted"):
        JOURNAL.auto_dump(f"{site}-{outcome}")


def dumps_counter(registry=None):
    """``journal_dumps_total{reason}``, registered in ONE place (the
    ``tree_ingest_counter`` idiom)."""
    from fluidframework_tpu_torch.telemetry import metrics

    reg = registry or metrics.REGISTRY
    return reg.counter(
        "journal_dumps_total",
        "flight-recorder auto-dumps written, by trigger reason",
        labelnames=("reason",),
    )


def debugz_spans(
    stages: Sequence[str] = (),
) -> str:  # pragma: no cover - convenience wrapper
    """Convenience: the /debugz text plus the stage-quantile summary —
    what an operator pastes into an incident doc."""
    from fluidframework_tpu_torch.telemetry import metrics

    qs = metrics.stage_span_summary(quantiles=(0.5, 0.95, 0.99))
    lines = [render()]
    for stage, row in sorted(qs.items()):
        if not stages or stage in stages:
            lines.append(f"# {stage}: {row}")
    return "\n".join(lines)
