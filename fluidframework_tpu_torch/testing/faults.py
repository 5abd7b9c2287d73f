"""Deterministic, seeded fault injection for the serving pipeline.

Reference: ``packages/test/test-service-load``'s ``faultInjectionDriver.ts``
injects faults at the DRIVER seam only (client disconnect/offline windows);
the service itself is exercised against real Kafka/Mongo outages in
integration rigs. This repo's chaos story is in-proc and deterministic
instead: every stage boundary the trace spine names carries a NAMED
injection site (the ``@inject_fault`` decorator below), a test arms a
seeded policy per site, and the recovery semantics the service wires —
retry with backoff, host-path fallback, ring requeue + drain replay,
epoch-fence reroute — must reproduce the un-faulted run bit-exactly
(``tests/test_faults.py``).

Design rules:

- **Default no-op.** Sites compile to one module-global predicate check
  (``_ARMED``) plus a call indirection; with nothing armed the registry is
  never consulted and the serving hot path pays nothing else.
- **Named vocabulary.** Every site name must be declared in :data:`SITES`
  with its recovery contract — an undeclared site raises at import time,
  and the graftlint ``fault-site`` pass enforces the same statically (a
  production injection point with no documented recovery is a lint
  failure, not a latent surprise).
- **Deterministic.** Probabilistic policies carry their own seeded
  ``random.Random``; fail/crash counts are plain counters. Given the same
  workload and arm() calls, the same invocations fault.
- **Nothing silent.** Every injected fault increments
  ``faults_injected_total{site,kind}`` on the process metrics registry,
  and every recovery increments ``retry_attempts_total{site,outcome}``
  (service/retry.py) — the chaos suite asserts both.

The per-site recovery contract table lives in
``docs/failure-semantics.md``.
"""

from __future__ import annotations

import functools
import random
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# Site vocabulary: every injection site in production code, with the
# recovery contract its stage wires (docs/failure-semantics.md).

#: site name -> recovery contract kind. The graftlint ``fault-site`` pass
#: parses this dict STATICALLY: adding an ``@inject_fault`` site to a
#: production module without declaring it here fails CI.
SITES: Dict[str, str] = {
    # Durable op-log append (DocOpLog.add_frame/add_msg, the store node's
    # log.send): scriptorium retries with backoff; exhaustion raises so
    # the partition runner's offset never advances past the frame — the
    # record replays (at-least-once) and the head watermark dedups.
    "store.append": "retry",
    # Partition-queue produce (PartitionedLog.send/send_batch and the
    # remote adapter): the runner's emit and the front door retry with
    # backoff; a front-door exhaustion surfaces to the client as a
    # submit failure (the nack analog — resubmission dedups by csn).
    "queue.send": "retry",
    # Pump ring staging (DeviceFleetBackend.pump_stage): a crash leaves
    # buffers/ring consistent either side of the boundary; pump_drain()
    # replays everything staged with no lost/dup ops.
    "pump.stage": "drain",
    # Continuous-feed trigger (DeviceFleetBackend.pump_feed — the hybrid
    # size/deadline boxcar trigger the front door rides): a crashed
    # deadline tick leaves every row buffered (crash-before/fail) or the
    # feed complete (crash-after); the next tick — or the quiescence
    # flush / pump_drain — re-fires over exactly the buffered rows, so
    # nothing is lost and the stage-time watermarks prevent duplicates.
    "pump.feed": "drain",
    # Device dispatch (the AOT donated dispatch inside _dispatch_one):
    # failure falls back to the one-shot host-staged apply path from the
    # slot's retained host copy — never silent; a crash BEFORE the
    # dispatch requeues the slot for the drain to replay.
    "pump.dispatch": "fallback",
    # Websocket delivery (network_server._drain_all): the unsent tail is
    # requeued at the inbox head — delivery watermarks only advance with
    # a successful write, so the client sees each op exactly once.
    "ws.deliver": "requeue",
    # Lease acquisition (ReservationManager.acquire): the cluster router
    # treats an injected failure as not-owned and retries/falls through
    # to the next candidate node.
    "lease.acquire": "retry",
    # Lease renewal (ReservationManager.renew): an owner that cannot
    # renew loses the document; the epoch fence rejects its in-flight
    # writes and the multinode submit path reroutes to the new owner.
    "lease.renew": "fence",
    # Admission check (AdmissionController.decide — the overload
    # front door): a crashed or failed check FAILS CLOSED — the op is
    # denied and nacked with ThrottlingError + retry_after, NEVER
    # silently admitted (an unaccounted admit under overload is the
    # cliff the envelope exists to prevent); the client's nack-resubmit
    # loop re-offers the op after the retry-after pace.
    "admission.decide": "nack",
    # Load-shed tier evaluation (OverloadController.observe —
    # tiered shedding controller): a crashed evaluation HOLDS the last
    # known tier (fail-static: a blip must not flap the envelope open or
    # slam it shut); the next observation re-evaluates from live
    # pressure.
    "shed.tier": "fallback",
    # Batched snapshot gather (DeviceFleetBackend._gather_start — the
    # read tier's one-readback multi-doc device gather): a failed or
    # crashed gather falls back to per-doc host gathers (counted
    # retry_attempts_total{read.gather,fallback}) — reads are idempotent
    # and side-effect-free on device state, so re-reading after any
    # boundary crash serves the same bytes; the reader never sees the
    # fault, only the amortization counter does.
    "read.gather": "fallback",
    # Encode-once push fan-out write (FluidNetworkServer._push_write —
    # one subscriber's delivery of shared pre-encoded bytes): a failed
    # write requeues ONLY that subscriber's already-encoded tail at its
    # tail head (watermarks advance only with a successful write; a
    # crash AFTER the write advances past the delivered entry — the
    # ws.deliver exactly-once rule per socket), and every other
    # subscriber in the fan-out group keeps draining.
    "push.fanout": "requeue",
    # Flight-recorder auto-dump (telemetry/journal.py _write_dump — the
    # post-mortem file write): the journal is best-effort by
    # contract — a failed or crashed dump is counted
    # (retry_attempts_total{journal.dump,fallback}) and ABSORBED by
    # auto_dump, so the flight recorder can never become the outage it
    # exists to explain. The in-memory ring (and /debugz) still holds
    # the events; crash-after leaves the file durable with only the
    # bookkeeping event lost.
    "journal.dump": "fallback",
    # Serving-profiler capture arm (telemetry/profiler.py _arm —
    # timeline profiler's /profilez window): arming allocates (ring
    # reset/resize for the bounded window), so the arm is the injectable
    # boundary — a failed or crashed arm is counted
    # (retry_attempts_total{profiler.arm,fallback}) and ABSORBED by
    # arm(), which returns False so /profilez replies 503 instead of
    # capturing; the serving path itself never sees the fault (the
    # journal.dump contract: observability must never become the
    # outage). Crash-after leaves the window armed — it self-disarms at
    # the window deadline, so the capture stays bounded either way.
    "profiler.arm": "fallback",
    # Residency hibernate commit (DeviceFleetBackend._hibernate_commit —
    # the summarize→durable-pointer→evict walk for one idle doc): a
    # failed or crashed-before hibernate did NOTHING — the document keeps
    # its fleet slot, stays RESIDENT, and serves normally (the sweep may
    # simply re-pick it later). A crash AFTER the commit left the doc
    # durably COLD behind the LatestSummaryCache pointer — the first op
    # wakes it through the normal miss path. Either way no op is lost
    # and no document is stranded half-evicted.
    "doc.hibernate": "fallback",
    # Residency wake commit (DeviceFleetBackend._wake_commit — restoring
    # a COLD document's slot on the first op that misses): a failed wake
    # leaves the durable/cold state untouched and the triggering op
    # PARKED (gapless, never dropped); the next op — or the quiescence
    # flush — re-attempts the identical wake. A crash AFTER the restore
    # is caught by the idempotence check (the slot is already live), so
    # the retry lands as a counted noop, never a double-restore.
    "doc.wake": "retry",
}

#: The recovery kinds the contract table documents. A site mapped to
#: anything else has no registered recovery policy (lint failure).
RECOVERY_KINDS = frozenset(
    {"retry", "nack", "fallback", "fence", "drain", "requeue"}
)


class InjectedFault(RuntimeError):
    """A fault injected at a named site (the ``fail``/probability
    policies). ``site`` names the boundary; ``completed`` is True when the
    wrapped operation ran before the fault fired (crash-after)."""

    def __init__(self, site: str, kind: str = "fail", completed: bool = False):
        super().__init__(f"injected {kind} at {site!r}")
        self.site = site
        self.kind = kind
        self.completed = completed


class InjectedCrash(InjectedFault):
    """Crash-at-boundary: the 'process died here' fault. Unlike
    :class:`InjectedFault` it is NOT retryable in place (service/retry.py
    treats it as fatal) — recovery is the stage's replay/drain contract,
    exactly as after a real crash."""


# ---------------------------------------------------------------------------
# Policies: one armed per site; ``plan()`` is called once per site
# invocation and returns the action to take (None = pass through).


class FaultPolicy:
    def plan(self) -> Optional[Tuple]:
        return None


class FailN(FaultPolicy):
    """Fail the next ``times`` invocations, then pass."""

    def __init__(self, times: int = 1):
        self.remaining = int(times)

    def plan(self) -> Optional[Tuple]:
        if self.remaining > 0:
            self.remaining -= 1
            return ("fail",)
        return None


class FailProb(FaultPolicy):
    """Fail each invocation with probability ``p`` (own seeded RNG — the
    fault schedule is a pure function of the seed and the call order)."""

    def __init__(self, p: float, seed: int = 0):
        self.p = float(p)
        self._rng = random.Random(seed)

    def plan(self) -> Optional[Tuple]:
        return ("fail",) if self._rng.random() < self.p else None


class LatencySpike(FaultPolicy):
    """Sleep ``delay_s`` before the next ``times`` invocations (None =
    every invocation) — the slow-dependency fault."""

    def __init__(self, delay_s: float = 0.01, times: Optional[int] = None):
        self.delay_s = float(delay_s)
        self.remaining = times

    def plan(self) -> Optional[Tuple]:
        if self.remaining is not None:
            if self.remaining <= 0:
                return None
            self.remaining -= 1
        return ("latency", self.delay_s)


class CrashAt(FaultPolicy):
    """Crash-at-boundary: raise :class:`InjectedCrash` ``times`` times,
    either BEFORE the wrapped operation runs (side effect never happened)
    or AFTER it returned (side effect durable, acknowledgment lost — the
    classic at-least-once window)."""

    def __init__(self, boundary: str = "before", times: int = 1):
        assert boundary in ("before", "after"), boundary
        self.boundary = boundary
        self.remaining = int(times)

    def plan(self) -> Optional[Tuple]:
        if self.remaining > 0:
            self.remaining -= 1
            return ("crash", self.boundary)
        return None


# ---------------------------------------------------------------------------
# Registry


class FaultRegistry:
    """Process-global site registry: armed policies + invocation/injection
    counters. All mutation is lock-guarded (the websocket server injects
    from its event-loop thread while tests arm from the test thread)."""

    def __init__(self) -> None:
        self._armed: Dict[str, FaultPolicy] = {}
        self._lock = threading.Lock()
        self.invocations: Dict[str, int] = {}
        self.injected: Dict[Tuple[str, str], int] = {}

    def arm(self, site: str, policy: FaultPolicy) -> None:
        if site not in SITES:
            raise ValueError(
                f"unknown injection site {site!r} "
                f"(vocabulary: {', '.join(sorted(SITES))})"
            )
        with self._lock:
            self._armed[site] = policy
        _set_armed(True)

    def disarm(self, site: Optional[str] = None) -> None:
        with self._lock:
            if site is None:
                self._armed.clear()
            else:
                self._armed.pop(site, None)
            armed = bool(self._armed)
        _set_armed(armed)

    def reset(self) -> None:
        """Disarm everything and zero the counters (test isolation)."""
        with self._lock:
            self._armed.clear()
            self.invocations.clear()
            self.injected.clear()
        _set_armed(False)

    def stats(self) -> dict:
        with self._lock:
            return {
                "armed": sorted(self._armed),
                "invocations": dict(self.invocations),
                "injected": {
                    f"{site}:{kind}": n
                    for (site, kind), n in sorted(self.injected.items())
                },
            }

    def injected_total(self, site: Optional[str] = None) -> int:
        with self._lock:
            return sum(
                n
                for (s, _k), n in self.injected.items()
                if site is None or s == site
            )

    # -- the injection point ---------------------------------------------------

    def _record(self, site: str, kind: str) -> None:
        # Already under self._lock? No — called outside; take it briefly.
        with self._lock:
            self.injected[(site, kind)] = (
                self.injected.get((site, kind), 0) + 1
            )
        injected_counter().inc(site=site, kind=kind)
        # Flight recorder: every injection is a journal event, so
        # an auto-dump after the recovery shows WHICH fault preceded it.
        # Never for journal.dump itself — an armed dump site would
        # journal-from-within-the-dump path recursively.
        from fluidframework_tpu_torch.telemetry import journal

        if journal._ON and site != "journal.dump":
            journal.record("fault.injected", site=site, fault=kind)

    def _invoke(self, site: str, fn: Callable, args: tuple, kwargs: dict):
        with self._lock:
            self.invocations[site] = self.invocations.get(site, 0) + 1
            pol = self._armed.get(site)
            action = pol.plan() if pol is not None else None
        if action is None:
            return fn(*args, **kwargs)
        kind = action[0]
        if kind == "latency":
            self._record(site, "latency")
            time.sleep(action[1])
            return fn(*args, **kwargs)
        if kind == "fail":
            self._record(site, "fail")
            raise InjectedFault(site)
        # crash-at-boundary
        if action[1] == "before":
            self._record(site, "crash_before")
            raise InjectedCrash(site, "crash", completed=False)
        result = fn(*args, **kwargs)
        self._record(site, "crash_after")
        del result  # the 'ack' is lost with the crash
        raise InjectedCrash(site, "crash", completed=True)


REGISTRY = FaultRegistry()

# Hot-path gate: a plain module global read by every site wrapper. False
# (the default, and whenever nothing is armed) short-circuits straight
# into the wrapped callable.
_ARMED = False


def _set_armed(value: bool) -> None:
    global _ARMED
    _ARMED = value


def arm(site: str, policy: FaultPolicy) -> None:
    REGISTRY.arm(site, policy)


def disarm(site: Optional[str] = None) -> None:
    REGISTRY.disarm(site)


def reset() -> None:
    REGISTRY.reset()


def stats() -> dict:
    return REGISTRY.stats()


def injected_counter(registry=None):
    """The injection counter, registered in ONE place (the
    ``tree_ingest_counter`` idiom): chaos runs assert injected faults are
    visible on /metrics, never only in test-local state."""
    from fluidframework_tpu_torch.telemetry import metrics

    reg = registry or metrics.REGISTRY
    return reg.counter(
        "faults_injected_total",
        "faults injected at named sites, by site and fault kind",
        labelnames=("site", "kind"),
    )


def inject_fault(site: str):
    """Declare a named injection site on a callable (a stage-boundary
    function or method). With nothing armed the wrapper is one global
    predicate away from the raw call; with a policy armed on ``site`` the
    registry decides per invocation (fail / latency / crash / pass)."""
    if site not in SITES:
        raise ValueError(
            f"unknown injection site {site!r} "
            f"(vocabulary: {', '.join(sorted(SITES))})"
        )

    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any):
            if not _ARMED:
                return fn(*args, **kwargs)
            return REGISTRY._invoke(site, fn, args, kwargs)

        wrapper.__fault_site__ = site  # type: ignore[attr-defined]
        wrapper.__wrapped__ = fn
        return wrapper

    return deco
