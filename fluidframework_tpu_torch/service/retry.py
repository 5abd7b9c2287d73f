"""Unified retry/backoff policy for every service stage boundary.

Reference: routerlicious retries its external dependencies with one shared
helper (``server/routerlicious/packages/services-core/src/runWithRetry.ts``:
jittered exponential backoff, a retryable-error predicate, per-call
telemetry) rather than ad-hoc loops per call site. This module is that
helper for the TPU service: every boundary the fault-injection layer names
(``testing/faults.py``) recovers through :func:`call_with_retry` or
increments the same counter family when its recovery is not an in-place
retry (host-path fallback, ring requeue, epoch-fence reroute), so
``retry_attempts_total{site,outcome}`` on the metrics registry is the
complete, never-silent ledger of recovery activity.

Semantics:

- **Backoff** is exponential with full-range jitter
  (``delay * [1-jitter, 1+jitter]``) clamped to ``max_delay_s``; the
  jitter RNG is module-seeded so a chaos run's schedule is reproducible.
- **Deadline budgets** bound the TOTAL time a call may spend retrying:
  once ``deadline_s`` elapses no further attempt is scheduled.
- **Per-attempt timeouts** are cooperative: synchronous in-proc calls
  cannot be preempted, so ``per_attempt_timeout_s`` is passed through to
  transports that accept a timeout kwarg (``timeout_kwarg``) and bounds
  retry scheduling — the same contract the reference producer wrappers
  offer.
- **Crashes are not retried.** ``faults.InjectedCrash`` (and anything in
  ``fatal``) propagates immediately with ``outcome="fatal"``: a crash's
  recovery is its stage's replay/drain contract, and an in-place retry
  would double-apply the completed side effect.

Outcome vocabulary (the counter's second label):

====================  =======================================================
``retry``             one failed attempt, another will be scheduled
``ok``                success after at least one retry
``exhausted``         attempts or deadline spent; the error propagates
``fatal``             non-retryable error (including injected crashes)
``fallback``          recovery took an alternate path (device dispatch ->
                      one-shot host-staged apply)
``requeue``           work was requeued for a later tick (ws delivery tail,
                      a crashed dispatch's ring slot)
``fence``             an epoch fence rejected a stale writer; the op was
                      rerouted to the new lease owner
====================  =======================================================
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Type

from fluidframework_tpu_torch.testing import faults

# Seeded module RNG: backoff jitter is reproducible run-to-run (chaos
# parity runs compare faulted vs un-faulted state, and a wall-clock-seeded
# schedule would make latency-sensitive interleavings flaky).
_RNG = random.Random(0x5EED)


@dataclass(frozen=True)
class RetryPolicy:
    """One boundary's retry budget. The defaults suit in-proc stage
    boundaries (milliseconds); remote adapters pass wider budgets."""

    max_attempts: int = 4
    base_delay_s: float = 0.002
    max_delay_s: float = 0.25
    multiplier: float = 2.0
    jitter: float = 0.5  # +/- fraction of the nominal delay
    deadline_s: Optional[float] = None  # total budget across attempts
    per_attempt_timeout_s: Optional[float] = None

    def delay(self, attempt: int, rng: Optional[random.Random] = None) -> float:
        """Jittered backoff before retry number ``attempt`` (1-based)."""
        nominal = min(
            self.max_delay_s, self.base_delay_s * self.multiplier ** (attempt - 1)
        )
        r = rng or _RNG
        lo = max(0.0, 1.0 - self.jitter)
        return nominal * (lo + (1.0 + self.jitter - lo) * r.random())


DEFAULT_POLICY = RetryPolicy()

# Transient-shaped failures retry by default (the runWithRetry predicate):
# injected faults and I/O-flavored errors. Deterministic programming
# errors (KeyError, AttributeError, ...) surface immediately as
# ``fatal`` — retrying a bug with backoff sleeps on the serving path
# only delays the crash and misreports it as outage recovery. Callers
# with richer transports widen this explicitly (the remote store adapter
# adds RuntimeError for store-node error responses).
RETRYABLE_DEFAULT: Tuple[Type[BaseException], ...] = (
    faults.InjectedFault,
    ConnectionError,
    TimeoutError,
    OSError,
)


def retry_counter(registry=None):
    """``retry_attempts_total{site,outcome}``, registered in ONE place
    (the ``tree_ingest_counter`` idiom) — every recovery path in the
    service increments this family, so labelnames drift between two
    inline registrations would raise at recovery time, not scrape time."""
    from fluidframework_tpu_torch.telemetry import metrics

    reg = registry or metrics.REGISTRY
    return reg.counter(
        "retry_attempts_total",
        "unified retry/backoff recovery events by injection site and outcome",
        labelnames=("site", "outcome"),
    )


def call_with_retry(
    site: str,
    fn: Callable,
    *args,
    policy: RetryPolicy = DEFAULT_POLICY,
    retryable: Tuple[Type[BaseException], ...] = RETRYABLE_DEFAULT,
    fatal: Tuple[Type[BaseException], ...] = (faults.InjectedCrash,),
    sleep: Callable[[float], None] = time.sleep,
    rng: Optional[random.Random] = None,
    registry=None,
    timeout_kwarg: Optional[str] = None,
    **kwargs,
):
    """Run ``fn(*args, **kwargs)`` under ``policy``, counting every
    recovery event on ``retry_attempts_total{site,outcome}``.

    The first attempt is inline and uncounted (a clean call is not a
    recovery; the serving path must not pay a counter lock per frame) —
    failures route to the slow path, which owns the backoff loop."""
    if timeout_kwarg is not None and policy.per_attempt_timeout_s is not None:
        kwargs[timeout_kwarg] = policy.per_attempt_timeout_s
    try:
        return fn(*args, **kwargs)
    except BaseException as e:
        return _retry_slow(
            site, fn, args, kwargs, e, policy, retryable, fatal, sleep,
            rng, registry,
        )


def _retry_slow(
    site, fn, args, kwargs, first_exc, policy, retryable, fatal, sleep,
    rng, registry,
):
    from fluidframework_tpu_torch.telemetry import journal

    if not isinstance(first_exc, Exception):
        raise first_exc  # KeyboardInterrupt etc.: not a recovery event
    counter = retry_counter(registry)
    t0 = time.monotonic()
    exc = first_exc
    attempt = 1
    while True:
        if isinstance(exc, fatal) or not isinstance(exc, retryable):
            counter.inc(site=site, outcome="fatal")
            # Flight recorder: a fatal outcome means the op needs
            # its stage's replay/drain contract — journal it AND fire
            # the auto-dump, so the post-mortem file holds the lineage
            # that led here (the counter alone says only "it happened").
            journal.retry_outcome(site, "fatal")
            raise exc
        # ``retry`` counts only attempts that schedule a follow-up (the
        # documented meaning); the final failure counts once, as
        # ``exhausted``.
        if attempt >= policy.max_attempts:
            counter.inc(site=site, outcome="exhausted")
            journal.retry_outcome(site, "exhausted")
            raise exc
        delay = policy.delay(attempt, rng)
        if (
            policy.deadline_s is not None
            and time.monotonic() - t0 + delay > policy.deadline_s
        ):
            counter.inc(site=site, outcome="exhausted")
            journal.retry_outcome(site, "exhausted")
            raise exc
        counter.inc(site=site, outcome="retry")
        if journal._ON:
            journal.record("retry.outcome", site=site, outcome="retry")
        if delay > 0:
            sleep(delay)
        attempt += 1
        try:
            result = fn(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001 - classified above
            exc = e
            continue
        counter.inc(site=site, outcome="ok")
        if journal._ON:
            journal.record("retry.outcome", site=site, outcome="ok")
        return result
