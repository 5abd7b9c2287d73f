"""Overload envelope: admission control + tiered load-shedding.

Reference: the front door throttles ahead of sequencing — alfred nacks
over-budget submits with ``NackErrorType.ThrottlingError`` and a
retry-after (``lambdas/src/alfred``, the alfred/deli admission seam of
PAPER.md §2.3) precisely because client merge is deterministic only if
the server never silently drops a *sequenced* op: overload handling must
live BEFORE the ticket loop, where refusing work is cheap and the
client's nack-resubmit loop (``runtime/container.py``) carries the
recovery contract. The reference's throttler
(``services-shared/src/throttler.ts``) is a token-rate limiter per
tenant/document; its scaler reads the same occupancy signals this module
exports.

Two coupled controllers:

- :class:`AdmissionController` — per-tenant and per-doc token buckets
  checked at every write submit (``pipeline.submit*``), with refill
  rates optionally retargeted from the metrics registry's live rates
  (:meth:`AdmissionController.autotune` reads the device backend's
  applied-ops gauge the registry already tracks). An over-budget
  write is DENIED, never dropped: the caller turns the decision into a
  429 ``ThrottlingError`` nack carrying ``retry_after``, and the
  client resubmits after the pace. The check itself is a chaos site
  (``admission.decide``): a crashed or failed check FAILS CLOSED — deny
  and nack, never silently admit.

- :class:`OverloadController` — explicit load-shedding tiers
  (``NORMAL → SHED_READS → THROTTLE_WRITES → REFUSE_CONNECTIONS``)
  driven by the typed :class:`PressureSignal` the device backend
  surfaces (ring occupancy, queue depth, feed latency). Reads and
  snapshot requests shed FIRST (503 + retry-after at ``SHED_READS``),
  writes pay a token surcharge and throttle with retry-after next
  (``THROTTLE_WRITES``), and only the LAST tier refuses new sockets —
  in-flight writes still nack-with-retry-after there, so a sequenced op
  is never lost at any tier. Every transition is counted
  (``serving_overload_tier_transitions_total{from_tier,to_tier}``) and
  the current tier is exported as the ``serving_overload_tier`` gauge —
  the autoscaling signal for the k8s layer. Tier evaluation is a chaos
  site too (``shed.tier``): a crashed evaluation HOLDS the last known
  tier (fail-static) so a blip can neither flap the envelope open nor
  slam it shut.

Goodput contract (ROADMAP "Overload & tenancy envelope"): at 2x the
admitted capacity the envelope degrades LINEARLY — goodput stays pinned
near admitted capacity while the excess receives paced nacks — instead
of the cliff an unbounded queue produces. ``bench.py
overload_benchmark`` measures the curve; ``docs/failure-semantics.md``
§"Overload semantics" is the per-tier client-visible contract table.
"""

from __future__ import annotations

import enum
import math
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

from fluidframework_tpu_torch.service import retry
from fluidframework_tpu_torch.telemetry import journal
from fluidframework_tpu_torch.testing import faults
from fluidframework_tpu_torch.testing.faults import inject_fault

_INF = float("inf")


class Tier(enum.IntEnum):
    """Load-shedding tiers, in shed order: reads go first, writes
    throttle next, and only the last tier refuses new sockets."""

    NORMAL = 0
    SHED_READS = 1
    THROTTLE_WRITES = 2
    REFUSE_CONNECTIONS = 3


#: Token surcharge per write op at each tier: at ``THROTTLE_WRITES`` a
#: write costs double (the budget halves without a second knob). At
#: ``REFUSE_CONNECTIONS`` writes stop admitting entirely (every write is
#: throttle-nacked with retry-after — the last-ditch valve before
#: memory exhaustion), but they are still NACKED, never dropped: the
#: accepted writer keeps its socket and resubmits once the tier clears.
TIER_WRITE_COST: Dict[Tier, float] = {
    Tier.NORMAL: 1.0,
    Tier.SHED_READS: 1.0,
    Tier.THROTTLE_WRITES: 2.0,
}


# -- metric families (registered in ONE place, the tree_ingest_counter
# idiom: two inline registrations drifting labelnames would raise at
# decide time, not scrape time) -----------------------------------------------


def tier_gauge(registry=None):
    from fluidframework_tpu_torch.telemetry import metrics

    reg = registry or metrics.REGISTRY
    return reg.gauge(
        "serving_overload_tier",
        "current load-shedding tier (0=NORMAL 1=SHED_READS "
        "2=THROTTLE_WRITES 3=REFUSE_CONNECTIONS) — the autoscaling signal",
    )


def transitions_counter(registry=None):
    from fluidframework_tpu_torch.telemetry import metrics

    reg = registry or metrics.REGISTRY
    return reg.counter(
        "serving_overload_tier_transitions_total",
        "load-shedding tier transitions, by from/to tier",
        labelnames=("from_tier", "to_tier"),
    )


def shed_counter(registry=None):
    from fluidframework_tpu_torch.telemetry import metrics

    reg = registry or metrics.REGISTRY
    return reg.counter(
        "overload_shed_total",
        "requests shed by the overload envelope, by kind "
        "(read/connection/subscribe)",
        labelnames=("kind",),
    )


def admission_denied_counter(registry=None):
    from fluidframework_tpu_torch.telemetry import metrics

    reg = registry or metrics.REGISTRY
    return reg.counter(
        "admission_denied_total",
        "writes denied admission (throttling nack + retry_after), "
        "by reason",
        labelnames=("reason",),
    )


def admission_tokens_gauge(registry=None):
    from fluidframework_tpu_torch.telemetry import metrics

    reg = registry or metrics.REGISTRY
    return reg.gauge(
        "admission_tokens",
        "remaining per-tenant admission tokens (finite buckets only)",
        labelnames=("tenant",),
    )


# -- token buckets -------------------------------------------------------------


class TokenBucket:
    """One refillable budget. ``rate`` is tokens/second (``inf`` =
    unlimited, the default-permissive serving config — ``take`` is then
    two comparisons); ``burst`` is the bucket depth (defaults to one
    second of refill). Refill happens lazily on the caller's clock, so a
    manual clock makes chaos/bench schedules deterministic."""

    __slots__ = ("rate", "burst", "tokens", "custom", "_t", "_clock")

    def __init__(
        self,
        rate: float,
        burst: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
        custom: bool = False,
    ):
        self.rate = float(rate)
        self.burst = float(
            burst if burst is not None
            else (self.rate if self.rate != _INF else 1.0)
        )
        self.tokens = self.burst
        self.custom = custom  # explicitly configured: autotune keeps off
        self._clock = clock
        self._t = clock()

    def _refill(self) -> None:
        now = self._clock()
        dt = now - self._t
        self._t = now
        if dt > 0:
            self.tokens = min(self.burst, self.tokens + dt * self.rate)

    def take(self, n: float) -> bool:
        """Take ``n`` tokens. A request LARGER than the burst admits
        once the bucket is full and goes into token DEBT (tokens go
        negative; refills pay it down before anything else admits) —
        without this, a client whose paced resubmission coalesced its
        pending tail into one over-burst batch could NEVER be admitted:
        retry-after would promise a refill the bucket depth cannot hold
        (a livelock the e2e drive actually hit). Long-run rate is
        unchanged — debt throttles exactly as many future tokens as the
        oversized batch borrowed."""
        if self.rate == _INF:
            return True
        self._refill()
        if self.tokens >= min(n, self.burst):
            self.tokens -= n
            return True
        return False

    def give_back(self, n: float) -> None:
        """Refund a provisional take (the doc-bucket-denied unwind)."""
        if self.rate != _INF:
            self.tokens = min(self.burst, self.tokens + n)

    def retry_after_ms(self, n: float) -> float:
        """Milliseconds until ``n`` tokens (or a full bucket, for an
        over-burst request) will be available — the retry-after
        formula: ``ceil(1000 * deficit / refill_rate)`` with
        ``deficit = min(n, burst) - tokens`` (clamped by the
        controller's min/max)."""
        if self.rate == _INF:
            return 0.0
        self._refill()
        deficit = min(n, self.burst) - self.tokens
        if deficit <= 0:
            return 0.0
        if self.rate <= 0:
            return _INF
        return math.ceil(1e3 * deficit / self.rate)


@dataclass
class AdmissionDecision:
    """One front-door verdict. ``admitted=False`` NEVER means dropped:
    the caller nacks with ``ThrottlingError`` + ``retry_after_ms`` and
    the client's nack-resubmit loop re-offers the op after the pace."""

    admitted: bool
    retry_after_ms: float = 0.0
    reason: str = "ok"  # ok|tenant_budget|doc_budget|failed_closed


#: The shared admit verdict (read-only by contract): the permissive
#: fast path must not allocate per submitted frame.
_ADMITTED = AdmissionDecision(True)


class AdmissionController:
    """Per-tenant + per-doc token buckets checked ahead of sequencing.

    Defaults are PERMISSIVE (``inf`` rates): an unconfigured service
    admits everything at the cost of two comparisons per submit, so the
    envelope is a deployment knob, not a tax on every test. Configure
    ``tenant_rate``/``doc_rate`` (ops/s) to engage, or set
    ``autotune_headroom`` and call :meth:`autotune` periodically (the
    network server's deadline ticker does) to feed the refill rates from
    the metrics registry's live applied-ops rate.
    """

    FAILED_CLOSED_RETRY_MS = 25.0

    def __init__(
        self,
        tenant_rate: float = _INF,
        tenant_burst: Optional[float] = None,
        doc_rate: float = _INF,
        doc_burst: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
        min_retry_ms: float = 5.0,
        max_retry_ms: float = 5_000.0,
        autotune_headroom: Optional[float] = None,
        autotune_floor: float = 64.0,
        autotune_min_interval_s: float = 1.0,
        max_buckets: int = 4096,
    ):
        self.tenant_rate = float(tenant_rate)
        self.tenant_burst = tenant_burst
        self.doc_rate = float(doc_rate)
        self.doc_burst = doc_burst
        self.min_retry_ms = float(min_retry_ms)
        self.max_retry_ms = float(max_retry_ms)
        # autotune: default refill <- headroom x measured downstream
        # ops/s (never below the floor — a stall must not wedge the
        # front door shut).
        self.autotune_headroom = autotune_headroom
        self.autotune_floor = float(autotune_floor)
        self.autotune_min_interval_s = float(autotune_min_interval_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._tenants: Dict[str, TokenBucket] = {}
        self._docs: Dict[str, TokenBucket] = {}
        self._tune_last: Optional[Tuple[float, float]] = None
        self._has_custom = False
        self.max_buckets = int(max_buckets)
        self.denied = 0  # host-side total (the counter is the ledger)

    # -- bucket registry -------------------------------------------------------

    def permissive(self) -> bool:
        """True while the envelope is fully disengaged (inf default
        rates, no pinned buckets): callers may skip tenant resolution
        and decide() rides its allocation-free fast path."""
        return (
            self.tenant_rate == _INF
            and self.doc_rate == _INF
            and not self._has_custom
        )

    def _bucket(
        self, table: Dict[str, TokenBucket], key: str, rate: float,
        burst: Optional[float],
    ) -> TokenBucket:
        b = table.get(key)
        if b is None:
            if len(table) >= self.max_buckets:
                # Bounded tables under key churn (docs come and go for
                # the process lifetime): a refilled-full non-custom
                # bucket carries no state worth keeping — dropping it
                # and re-creating later is identity-preserving.
                for k in [
                    k for k, bb in table.items()
                    if not bb.custom
                    and (bb._refill() or bb.tokens >= bb.burst)
                ]:
                    del table[k]
                # HARD bound: under adversarial same-window churn (a
                # fresh key per request, every bucket mid-refill)
                # nothing above evicts — drop oldest non-custom entries
                # (dict = insertion order) until the bound holds.
                # A returning evicted key restarts with a full burst;
                # that bounded unfairness beats unbounded memory at the
                # 4096th distinct key, and spoof-minted tenant keys are
                # an auth configuration issue (HMAC mode binds them).
                if len(table) >= self.max_buckets:
                    for k in [
                        k for k, bb in table.items() if not bb.custom
                    ][: len(table) - self.max_buckets + 1]:
                        del table[k]
            b = table[key] = TokenBucket(rate, burst, clock=self._clock)
        return b

    def set_tenant_rate(
        self, tenant: str, rate: float, burst: Optional[float] = None
    ) -> None:
        """Pin one tenant's budget explicitly (autotune keeps off it)."""
        with self._lock:
            self._tenants[tenant] = TokenBucket(
                rate, burst, clock=self._clock, custom=True
            )
            self._has_custom = True

    def set_doc_rate(
        self, doc_id: str, rate: float, burst: Optional[float] = None
    ) -> None:
        with self._lock:
            self._docs[doc_id] = TokenBucket(
                rate, burst, clock=self._clock, custom=True
            )
            self._has_custom = True

    def tenant_tokens(self, tenant: str) -> float:
        b = self._tenants.get(tenant)
        if b is None or b.rate == _INF:
            return _INF
        b._refill()
        return b.tokens

    # -- the decision ----------------------------------------------------------

    def _clamp(self, ms: float) -> float:
        return min(self.max_retry_ms, max(self.min_retry_ms, ms))

    @inject_fault("admission.decide")
    def _decide(
        self, tenant: str, doc_id: str, n_ops: int, tier: Tier
    ) -> AdmissionDecision:
        if (
            self.tenant_rate == _INF
            and self.doc_rate == _INF
            and tenant not in self._tenants
            and doc_id not in self._docs
        ):
            # The permissive serving default: four probes, no lock, no
            # bucket allocation, one shared verdict object — the hot
            # bulk path pays essentially nothing until the envelope is
            # engaged. (Still inside the ``admission.decide`` boundary:
            # an armed chaos policy fails this path closed like any
            # other.)
            return _ADMITTED
        cost = n_ops * TIER_WRITE_COST.get(tier, 1.0)
        with self._lock:
            tb = self._bucket(
                self._tenants, tenant, self.tenant_rate, self.tenant_burst
            )
            db = self._bucket(self._docs, doc_id, self.doc_rate, self.doc_burst)
            if not tb.take(cost):
                return AdmissionDecision(
                    False, self._clamp(tb.retry_after_ms(cost)),
                    "tenant_budget",
                )
            if not db.take(cost):
                tb.give_back(cost)
                return AdmissionDecision(
                    False, self._clamp(db.retry_after_ms(cost)), "doc_budget"
                )
        return AdmissionDecision(True)

    def decide(
        self,
        tenant: str,
        doc_id: str,
        n_ops: int = 1,
        tier: Tier = Tier.NORMAL,
    ) -> AdmissionDecision:
        """The front-door admission check (the ``admission.decide``
        chaos site). FAIL CLOSED: an injected fault or crash at the
        boundary — even a crash AFTER the inner decision computed (the
        ack-lost window) — denies with a retry-after, never silently
        admits; the denial is counted
        (``retry_attempts_total{admission.decide,nack}``) and the
        client resubmits after the pace, so nothing is lost.

        At ``REFUSE_CONNECTIONS`` every write denies outright (reason
        ``tier_refuse``) with one lag-reference window per tier as the
        retry-after — the budget question is moot once the envelope is
        refusing sockets."""
        if tier >= Tier.REFUSE_CONNECTIONS:
            d = AdmissionDecision(
                False, self._clamp(self.FAILED_CLOSED_RETRY_MS * int(tier)),
                "tier_refuse",
            )
            self.denied += 1
            admission_denied_counter().inc(reason=d.reason)
            return d
        try:
            d = self._decide(tenant, doc_id, n_ops, tier)
        except faults.InjectedFault as e:
            if e.site != "admission.decide":
                raise  # a nested site's fault keeps its own contract
            if journal._ON:
                journal.record(
                    "retry.outcome", doc=doc_id, site="admission.decide",
                    outcome="nack",
                )
            if isinstance(e, faults.InjectedCrash):
                # A fail-closed CRASH is a flight-recorder trigger: the
                # dump shows which ops were in flight when the front
                # door slammed shut.
                journal.auto_dump("admission-failed-closed")
            if isinstance(e, faults.InjectedCrash) and e.completed:
                # Crash-AFTER: the inner decision ran — if it admitted,
                # its tokens are spent on an op we are about to deny,
                # double-charging the resubmit. The verdict died with
                # the crash, so refund unconditionally: over-refunding
                # a denied inner decision is bounded by one op's cost
                # and capped at the burst, while the double-charge
                # compounds with every faulted admit under a sustained
                # chaos rate.
                cost = n_ops * TIER_WRITE_COST.get(tier, 1.0)
                with self._lock:
                    tb = self._tenants.get(tenant)
                    if tb is not None:
                        tb.give_back(cost)
                    db = self._docs.get(doc_id)
                    if db is not None:
                        db.give_back(cost)
            retry.retry_counter().inc(site="admission.decide", outcome="nack")
            d = AdmissionDecision(
                False, self._clamp(self.FAILED_CLOSED_RETRY_MS),
                "failed_closed",
            )
        if not d.admitted:
            self.denied += 1
            admission_denied_counter().inc(reason=d.reason)
        # Export the tenant budget for the scaler — finite buckets only
        # (the permissive default pays no gauge write per submit).
        b = self._tenants.get(tenant)
        if b is not None and b.rate != _INF:
            admission_tokens_gauge().set(max(0.0, b.tokens), tenant=tenant)
        return d

    # -- registry-fed refill (the live-rate seam) ------------------------------

    def autotune(
        self,
        applied_total: Optional[float] = None,
        registry=None,
        now: Optional[float] = None,
    ) -> Optional[float]:
        """Retarget the DEFAULT refill rates from a live applied-ops
        counter. Callers with a device backend pass its host-side
        ``ops_applied`` total as ``applied_total`` (the network ticker
        does) — that counter advances with every boxcar, so the measured
        rate is real between any two calls. The registry fallback reads
        ``device_backend_totals{key="ops_applied"}``, which is only
        refreshed by a /metrics scrape: correct when autotune runs AT
        scrape cadence, but a fast ticker on the gauge would read
        delta=0 between scrapes and pin the rates to the floor — hence
        the explicit parameter. Calls inside
        ``autotune_min_interval_s`` of the last measurement return None
        without consuming the window (a 50ms ticker accumulates into
        1s measurements instead of measuring noise). Buckets pinned via
        ``set_*_rate`` (``custom``) keep their configured budget;
        everything else retargets to
        ``max(floor, headroom × measured_rate)`` — admission tracks the
        capacity the device actually delivers, so the envelope tightens
        itself as downstream slows."""
        if self.autotune_headroom is None:
            return None
        if applied_total is None:
            from fluidframework_tpu_torch.telemetry import metrics

            g = (registry or metrics.REGISTRY).get("device_backend_totals")
            if g is None:
                return None
            applied_total = g.value(key="ops_applied")
        now = self._clock() if now is None else now
        if self._tune_last is None:
            self._tune_last = (now, float(applied_total))
            return None
        t0, v0 = self._tune_last
        dt = now - t0
        if dt < max(self.autotune_min_interval_s, 1e-9):
            return None  # window still accumulating; keep the anchor
        measured = max(0.0, (float(applied_total) - v0) / dt)
        self._tune_last = (now, float(applied_total))
        rate = max(self.autotune_floor, self.autotune_headroom * measured)
        with self._lock:
            self.doc_rate = rate
            self.tenant_rate = rate
            for table in (self._tenants, self._docs):
                for b in table.values():
                    if not b.custom:
                        b.rate = rate
                        # Burst tracks the rate BOTH ways: ratcheting it
                        # only upward would let a bucket sized during a
                        # fast period dump its old giant burst into a
                        # now-degraded backend in one spike — the exact
                        # queue-buildup cliff the envelope prevents.
                        b.burst = rate
                        b.tokens = min(b.tokens, b.burst)
        return measured


# -- pressure + tiers ----------------------------------------------------------


@dataclass
class PressureSignal:
    """The typed backpressure signal the device backend surfaces
    (:meth:`DeviceFleetBackend.pressure`): ring-full pressure is no
    longer relieved only by oldest-dispatches-first inside the pump —
    it propagates here, to the pump sweep, the deadline ticker, and the
    accept loop."""

    ring_frac: float = 0.0  # staged ring slots / ring depth
    queue_frac: float = 0.0  # buffered rows / max_batch
    feed_lag_ms: float = 0.0  # age of the oldest buffered row
    scan_inflight: bool = False

    def score(self, lag_ref_ms: float) -> float:
        """Scalar pressure: the max-loaded dimension (a single saturated
        axis is overload even when the others are idle)."""
        lag = self.feed_lag_ms / lag_ref_ms if lag_ref_ms > 0 else 0.0
        return max(self.ring_frac, self.queue_frac, lag)


class OverloadController:
    """Tiered load-shedding driven by :class:`PressureSignal` scores.

    Enter thresholds step up through the tiers; stepping DOWN requires
    the score to fall below ``hysteresis ×`` the current tier's enter
    threshold (flap damping — a boundary-riding signal must not toggle
    shed decisions every tick). Every transition lands on
    ``serving_overload_tier_transitions_total{from_tier,to_tier}`` and
    the ``serving_overload_tier`` gauge; the bounded ``transitions``
    tail is the bench/test view."""

    def __init__(
        self,
        shed_at: float = 0.65,
        throttle_at: float = 0.9,
        refuse_at: float = 1.2,
        hysteresis: float = 0.75,
        lag_ref_ms: float = 50.0,
        keep_transitions: int = 64,
    ):
        assert 0 < shed_at <= throttle_at <= refuse_at
        self._enter = {
            Tier.SHED_READS: float(shed_at),
            Tier.THROTTLE_WRITES: float(throttle_at),
            Tier.REFUSE_CONNECTIONS: float(refuse_at),
        }
        self.hysteresis = float(hysteresis)
        self.lag_ref_ms = float(lag_ref_ms)
        self.tier = Tier.NORMAL
        self._pinned: Optional[Tier] = None
        self.transitions: list = []  # bounded (from_name, to_name) tail
        self._keep = int(keep_transitions)
        self.last_score = 0.0
        self._last_jscore = 0.0  # last pressure score journaled
        # The tier gauge/transition counter are PROCESS-GLOBAL (one
        # serving envelope per process is the deployment shape);
        # deliberately no gauge write here — constructing a second
        # controller (a bench lane, a test fixture) must not zero the
        # exported tier of a live shedding service. The gauge gets its
        # value at the first transition.

    # -- evaluation ------------------------------------------------------------

    def _target(self, score: float) -> Tier:
        tier = Tier.NORMAL
        for t in (
            Tier.SHED_READS, Tier.THROTTLE_WRITES, Tier.REFUSE_CONNECTIONS
        ):
            if score >= self._enter[t]:
                tier = t
        return tier

    @inject_fault("shed.tier")
    def _evaluate(self, pressure: PressureSignal) -> Tier:
        score = self.last_score = pressure.score(self.lag_ref_ms)
        target = self._target(score)
        if target >= self.tier:
            return target
        # Stepping down: only once the score clears the hysteresis band
        # under the CURRENT tier's enter threshold.
        if score < self._enter[self.tier] * self.hysteresis:
            return target
        return self.tier

    def observe(self, pressure: PressureSignal) -> Tier:
        """One tier evaluation (the ``shed.tier`` chaos site). A crashed
        evaluation HOLDS the last known tier — fail-static, counted
        (``retry_attempts_total{shed.tier,fallback}``), never silent —
        and the next observation re-evaluates from live pressure."""
        if self._pinned is not None:
            # Pinned (force()): live observations cannot move the tier —
            # the deterministic lever bench/chaos drivers walk the
            # envelope with.
            return self.tier
        try:
            new = self._evaluate(pressure)
        except faults.InjectedFault as e:
            if e.site != "shed.tier":
                raise
            retry.retry_counter().inc(site="shed.tier", outcome="fallback")
            if journal._ON:
                journal.record(
                    "retry.outcome", site="shed.tier", outcome="fallback"
                )
            return self.tier
        if journal._ON and (
            new != self.tier
            or abs(self.last_score - self._last_jscore) >= 0.05
        ):
            # Pressure readings journal on CHANGE, not per tick: the
            # observe cadence is every pump sweep + every deadline tick,
            # and a flat idle signal would churn the bounded ring out of
            # exactly the lineage entries a post-mortem needs.
            self._last_jscore = self.last_score
            journal.record(
                "pressure",
                ring_frac=round(pressure.ring_frac, 4),
                queue_frac=round(pressure.queue_frac, 4),
                feed_lag_ms=round(pressure.feed_lag_ms, 3),
                score=round(self.last_score, 4),
            )
        if new != self.tier:
            self._transition(self.tier, new)
        return self.tier

    def force(self, tier: Optional[Tier]) -> None:
        """Deterministic tier override (bench/chaos drivers walk the
        envelope without synthesizing exact pressure curves): PINS the
        tier — live observations cannot move it until ``force(None)``
        unpins — and transitions count exactly like observed ones."""
        self._pinned = tier
        if tier is not None and tier != self.tier:
            self._transition(self.tier, tier)

    def _transition(self, old: Tier, new: Tier) -> None:
        transitions_counter().inc(from_tier=old.name, to_tier=new.name)
        tier_gauge().set(int(new))
        if journal._ON:
            journal.record(
                "shed.transition", from_tier=old.name, to_tier=new.name,
                score=round(self.last_score, 4),
            )
        self.transitions.append((old.name, new.name))
        if len(self.transitions) > self._keep:
            # (an explicit length check: `del lst[:-keep]` is a silent
            # no-op at keep=0 — the tail would grow forever)
            del self.transitions[: len(self.transitions) - self._keep]
        self.tier = new

    # -- the per-tier contract surface ----------------------------------------

    def shed_reads(self) -> bool:
        return self.tier >= Tier.SHED_READS

    def refuse_connections(self) -> bool:
        return self.tier >= Tier.REFUSE_CONNECTIONS

    def retry_after_ms(self) -> float:
        """Retry-after suggestion for shed reads/refused connections:
        one pressure-reference window per tier above normal — deeper
        overload asks clients to back off longer."""
        return self.lag_ref_ms * max(1, int(self.tier))

    def transition_counts(self, registry=None) -> Dict[str, float]:
        """``{"FROM->TO": n}`` from the counter family — the bench
        artifact form (``serving_overload_tier_transitions``)."""
        c = transitions_counter(registry)
        return {
            f"{dict(key)['from_tier']}->{dict(key)['to_tier']}": v
            for key, _suffix, v in c.samples()
        }
