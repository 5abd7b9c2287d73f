"""Serving timeline profiler: per-boxcar host-tax attribution.

The ROADMAP's one-dispatch item names the serving path's remaining tax —
"the per-frame host Python" between the native ticketer and the device
dispatch — but nothing in the repo could MEASURE it: ``pump_busy_s`` is
a single interval union, the stage spans are aggregate histograms, and a
fuse-vs-don't-fuse decision needs to know WHERE a boxcar round's wall
goes. Reference: the server stack ships op-level ``traces`` on every
sequenced message (``protocol.ts:173/:279``) precisely so operators can
decompose the sequencing path; this module is the timeline view over the
same spine.

One process-global, bounded, lock-cheap ring (:data:`PROFILER`) of typed
:class:`Interval` records — the ``journal.py`` EVENTS discipline applied
to timing lanes:

- **Typed lane vocabulary** (:data:`LANES`): one lane per serving-path
  phase a boxcar round passes through, plus the two watchdog lanes. An
  undeclared lane raises at record time, so the /profilez surface can
  never grow an undocumented timing stream.
- **Per-boxcar**: every pump interval carries the boxcar id its round
  belongs to, so :func:`summarize` can attribute the DERIVED gap — the
  time inside a boxcar round covered by NO named lane, i.e. the host
  Python between the instrumented seams — per boxcar (`loop_other`),
  and report ``serving_host_tax_ms`` as p50/p99 of per-boxcar
  ``loop_other + host_stage``.
- **Bounded, on-demand**: the profiler is DISARMED by default and arms
  for a bounded window (:func:`arm`); the ring is a ``deque(maxlen)``
  so even a pathological window cannot grow the process.
- **Near-zero disabled**: every producer site is gated on the
  module-global :data:`_ON` predicate (the ``journal._ON`` discipline);
  disarmed, a site costs one attribute read and allocates NOTHING
  (counting-shim-tested).
- **One clock, one record site**: producers take their
  ``time.perf_counter()`` stamps ONCE and feed both the interval ring
  and the legacy counters (``pump_busy_s``,
  ``flush_totals["staging_s"]``) from the same floats — the legacy
  counters are derived views, not parallel instrumentation
  (equivalence regression-tested).
- **Zero device readbacks**: the profiler consumes host timestamps
  only; ``device_step`` closes on the pump's EXISTING one-boxcar-stale
  scan consume. A profiler producer running its own device→host
  transfer is a graftlint host-sync failure, not a design option.

Export surfaces:

- ``GET /profilez?duration_ms=N`` on the network front door arms a
  bounded window, sleeps it out, and returns :func:`chrome_trace` —
  Chrome trace-event / Perfetto JSON (pid = process, one tid per lane,
  wall timestamps in microseconds). The armed capture ALLOCATES, so
  /profilez is deliberately NOT shed-exempt: at ``SHED_READS`` and
  above it 503s with Retry-After (unlike /metrics and /debugz). The
  arm itself is the ``profiler.arm`` fault site — a failed arm is
  counted (``retry_attempts_total{profiler.arm,fallback}``) and
  absorbed, like ``journal.dump``.
- :func:`render` — the deterministic test surface: interval ORDER and
  lane/boxcar/rows content with NO wall timestamps (two replicas that
  observed the same logical intervals render byte-equal text); the
  timestamps appear only in the exported trace file.
- :func:`summarize` — per-lane totals, the global ``loop_other`` gap,
  ``serving_host_tax_ms``, and the timeline-derived device-idle
  fraction the bench reconciles against ``serving_pump_device_idle_frac``
  (two instruments, one truth).

Runtime watchdogs (fed from here, visible as their own lanes):

- the asyncio **loop-lag sentinel** (``network_server._lag_sentinel``)
  measures expected-vs-actual tick delta, exports the
  ``event_loop_lag_ms`` gauge, journals a ``loop.stall`` event past the
  threshold (a blocking readback regression is caught BY NAME), and
  records a ``loop_lag`` interval while a capture is armed;
- the **gc pause hooks** (:func:`install_gc_hooks`, ``gc.callbacks``)
  export the ``gc_pause_ms`` histogram + gen-labelled
  ``gc_pauses_total`` counter and record ``gc_pause`` intervals while
  armed.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

from fluidframework_tpu_torch.testing.faults import inject_fault

# ---------------------------------------------------------------------------
# Lane vocabulary: every lane a producer may record, with its meaning.
# Like ``journal.EVENTS``, this is the static acceptance mechanism — an
# unknown lane raises at record time.

LANES: Dict[str, str] = {
    # -- the boxcar round (pump path) ---------------------------------------
    "host_stage": "the _stage_host host Python: buffer drain + boxcar "
                  "assembly + watermark bookkeeping",
    "ring_put": "async device_put of the assembled boxcar into a ring slot",
    "ticket": "the native/vectorized ticket_frame call (deli)",
    "dispatch": "AOT donated dispatch submission + scan begin "
                "(_dispatch_one's device half — enqueue cost)",
    "device_step": "dispatch issued → that boxcar's health-scan readback "
                   "consumed (the interval pump_busy_s unions, kept "
                   "per-boxcar)",
    "scan_consume": "the blocking one-boxcar-stale scan readback wait",
    "feed_wait": "oldest buffered row → the feed trigger stages its boxcar",
    # -- derived ------------------------------------------------------------
    "loop_other": "DERIVED gap: wall inside a boxcar round covered by no "
                  "named lane — the per-frame host tax (never recorded "
                  "directly; summarize()/chrome_trace() synthesize it)",
    # -- watchdogs ----------------------------------------------------------
    "loop_lag": "asyncio loop-lag sentinel: measured tick overshoot past "
                "the expected period",
    "gc_pause": "a gc.callbacks-bracketed collector pause",
}

#: Deterministic Perfetto thread id per lane (tid = declaration order).
LANE_TIDS: Dict[str, int] = {lane: i for i, lane in enumerate(LANES)}

#: Lanes that belong to a boxcar round (the host-tax attribution set);
#: watchdog lanes and the derived gap are excluded from round spans.
ROUND_LANES = frozenset(
    ("host_stage", "ring_put", "ticket", "dispatch", "device_step",
     "scan_consume", "feed_wait")
)

#: /profilez window clamp: an armed capture allocates, so the window a
#: client can request is bounded (ms).
MAX_WINDOW_MS = 10_000.0


class Interval:
    """One recorded timeline interval: ``(lane, t0, t1)`` on the
    ``time.perf_counter()`` clock, plus the boxcar id it belongs to
    (-1 for watchdog/off-round intervals) and the row count it covers.
    ``iid`` is the logical record order — the deterministic test
    surface's ordering key (wall timestamps are export-only)."""

    __slots__ = ("iid", "lane", "t0", "t1", "boxcar", "rows")

    def __init__(
        self, iid: int, lane: str, t0: float, t1: float, boxcar: int,
        rows: int,
    ):
        self.iid = iid
        self.lane = lane
        self.t0 = t0
        self.t1 = t1
        self.boxcar = boxcar
        self.rows = rows

    @property
    def dur(self) -> float:
        return self.t1 - self.t0

    def format(self) -> str:
        """Deterministic one-line render (no timestamps)."""
        parts = [f"{self.iid:06d}", self.lane]
        if self.boxcar >= 0:
            parts.append(f"boxcar={self.boxcar}")
        if self.rows:
            parts.append(f"rows={self.rows}")
        return " ".join(parts)


def _union_s(spans: List[Any]) -> float:
    """Total wall covered by the union of (t0, t1) spans."""
    if not spans:
        return 0.0
    total = 0.0
    edge = -float("inf")
    for t0, t1 in sorted((s.t0, s.t1) for s in spans):
        if t1 <= edge:
            continue
        total += t1 - max(t0, edge)
        edge = t1
    return total


class Profiler:
    """A bounded ring of :class:`Interval`. All mutation is lock-guarded
    (the socket loop records from its thread while a bench/test thread
    reads); the lock covers one id increment and one deque append."""

    def __init__(self, capacity: int = 65536):
        self.capacity = max(64, int(capacity))
        self._ring: Deque[Interval] = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._next = 0
        self._until = 0.0  # capture-window deadline (perf_counter)

    # -- recording -------------------------------------------------------------

    def record(
        self, lane: str, t0: float, t1: float, boxcar: int = -1,
        rows: int = 0,
    ) -> None:
        if lane not in LANES:
            raise ValueError(
                f"unknown profiler lane {lane!r} "
                f"(vocabulary: {', '.join(sorted(LANES))})"
            )
        if lane == "loop_other":
            raise ValueError(
                "loop_other is DERIVED (the uncovered gap inside a boxcar "
                "round) — summarize()/chrome_trace() synthesize it; "
                "recording it directly would double-count the tax"
            )
        iv = Interval(0, lane, t0, t1, boxcar, rows)
        with self._lock:
            iv.iid = self._next
            self._next += 1
            self._ring.append(iv)  # maxlen evicts oldest-first
        # Bounded window: the capture self-disarms once the window has
        # elapsed even if no surface ever calls disarm() (a crashed
        # /profilez client must not leave the profiler armed forever).
        if t1 >= self._until:
            disarm()

    # -- reading ---------------------------------------------------------------

    def intervals(self) -> List[Interval]:
        with self._lock:
            return list(self._ring)

    @property
    def seen(self) -> int:
        return self._next

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._next = 0

    # -- reductions ------------------------------------------------------------

    def _rounds(self) -> Dict[int, List[Interval]]:
        """Round-lane intervals grouped by boxcar id."""
        rounds: Dict[int, List[Interval]] = {}
        for iv in self.intervals():
            if iv.boxcar >= 0 and iv.lane in ROUND_LANES:
                rounds.setdefault(iv.boxcar, []).append(iv)
        return rounds

    def summarize(self) -> Dict[str, Any]:
        """Reduce the captured window: per-lane totals, the derived
        ``loop_other`` gap, per-boxcar host-tax percentiles, and the
        timeline-derived device-idle fraction.

        - ``window_s``: first interval start → last interval end.
        - ``lanes_ms``: total recorded wall per lane (sum of durations).
        - ``loop_other_ms``: window wall NOT covered by any recorded
          interval — the global derived gap (named-lane coverage +
          loop_other ≡ the window by construction; the bench asserts
          the split anyway).
        - ``serving_host_tax_ms``: p50/p99 over boxcar rounds of
          per-round ``loop_other + host_stage`` — the per-frame host
          Python between the ticketer and the device dispatch.
        - ``device_idle_frac``: 1 − union(device_step)/window — the
          instrument the bench reconciles against the legacy
          ``serving_pump_device_idle_frac`` (tolerance-asserted:
          two instruments, one truth).
        """
        ivs = self.intervals()
        if not ivs:
            return {
                "window_s": 0.0, "intervals": 0, "boxcars": 0,
                "lanes_ms": {}, "loop_other_ms": 0.0,
                "coverage_frac": 0.0, "serving_host_tax_ms": {},
                "device_idle_frac": None,
            }
        t_lo = min(iv.t0 for iv in ivs)
        t_hi = max(iv.t1 for iv in ivs)
        window = max(t_hi - t_lo, 1e-12)
        lanes_ms: Dict[str, float] = {}
        for iv in ivs:
            lanes_ms[iv.lane] = lanes_ms.get(iv.lane, 0.0) + iv.dur * 1e3
        covered = _union_s(ivs)
        loop_other_ms = max(0.0, (window - covered)) * 1e3
        # Per-boxcar host tax: the round span is its first interval
        # start → last interval end; the round's own uncovered gap plus
        # its host_stage wall is the Python the one-dispatch fusion
        # would delete.
        taxes: List[float] = []
        for _bid, group in sorted(self._rounds().items()):
            span = max(g.t1 for g in group) - min(g.t0 for g in group)
            gap = max(0.0, span - _union_s(group))
            host = sum(g.dur for g in group if g.lane == "host_stage")
            taxes.append((gap + host) * 1e3)
        taxes.sort()

        def _pct(q: float) -> float:
            if not taxes:
                return 0.0
            return taxes[min(len(taxes) - 1, int(q * (len(taxes) - 1)))]

        step_union = _union_s(
            [iv for iv in ivs if iv.lane == "device_step"]
        )
        return {
            "window_s": round(window, 6),
            "intervals": len(ivs),
            "boxcars": len(self._rounds()),
            "lanes_ms": {
                lane: round(ms, 3) for lane, ms in sorted(lanes_ms.items())
            },
            "loop_other_ms": round(loop_other_ms, 3),
            # Named-lane coverage of the window: the union of recorded
            # intervals plus the derived gap — 1.0 by construction, but
            # computed (not assumed) so the bench's ≥0.95 assertion
            # exercises the arithmetic, not a constant.
            "coverage_frac": round(
                (covered + loop_other_ms / 1e3) / window, 4
            ),
            "serving_host_tax_ms": {
                "p50": round(_pct(0.50), 3),
                "p99": round(_pct(0.99), 3),
            },
            "device_idle_frac": round(
                max(0.0, 1.0 - step_union / window), 4
            ),
        }

    def chrome_trace(self) -> Dict[str, Any]:
        """The Perfetto / Chrome trace-event export: one complete-event
        (``ph: "X"``) per interval, pid = the process, one tid per LANE
        (metadata-named), timestamps in wall microseconds on the
        perf_counter clock — the exported FILE carries the timestamps;
        the deterministic test surface (:meth:`render`) does not. Event
        order is the logical record order (replica-deterministic).
        Derived ``loop_other`` gaps are synthesized per boxcar round so
        the timeline visually closes."""
        import os

        pid = os.getpid()
        events: List[dict] = [
            {
                "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "args": {"name": "tpu-fluid serving"},
            }
        ]
        for lane, tid in LANE_TIDS.items():
            events.append({
                "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": lane},
            })
        for iv in self.intervals():
            events.append({
                "name": iv.lane,
                "cat": "serving",
                "ph": "X",
                "pid": pid,
                "tid": LANE_TIDS[iv.lane],
                "ts": round(iv.t0 * 1e6, 3),
                "dur": round(iv.dur * 1e6, 3),
                "args": {"boxcar": iv.boxcar, "rows": iv.rows},
            })
        # Synthesized loop_other: per boxcar round, the uncovered gaps
        # between that round's first and last recorded instants.
        gap_tid = LANE_TIDS["loop_other"]
        for bid, group in sorted(self._rounds().items()):
            edges = sorted((g.t0, g.t1) for g in group)
            edge = edges[0][0]
            for t0, t1 in edges:
                if t0 > edge:
                    events.append({
                        "name": "loop_other",
                        "cat": "serving",
                        "ph": "X",
                        "pid": pid,
                        "tid": gap_tid,
                        "ts": round(edge * 1e6, 3),
                        "dur": round((t0 - edge) * 1e6, 3),
                        "args": {"boxcar": bid, "rows": 0},
                    })
                edge = max(edge, t1)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def render(self) -> str:
        """The deterministic test surface: interval order and logical
        content, NO wall timestamps (the journal /debugz bar — two
        replicas that observed the same logical intervals render
        byte-equal text)."""
        with self._lock:
            ivs = list(self._ring)
            seen = self._next
        lines = [
            "# serving-profiler "
            f"intervals={len(ivs)} seen={seen} capacity={self.capacity}"
        ]
        lines.extend(iv.format() for iv in ivs)
        return "\n".join(lines) + "\n"


# The process-global profiler (the journal.JOURNAL idiom: module state,
# explicit reset for tests).
PROFILER = Profiler()

# Hot-path gate: a plain module global read by every producer site. False
# short-circuits before any timestamp pairing or Interval allocation —
# the counting-shim test pins zero-alloc. Disarmed by default: the
# profiler is an on-demand instrument, not standing instrumentation.
_ON = False


def enabled() -> bool:
    return _ON


@inject_fault("profiler.arm")
def _arm(duration_ms: float, capacity: Optional[int]) -> None:
    """The arming boundary (the ``profiler.arm`` fault site): an armed
    capture allocates (ring growth for the window), so the arm is the
    injectable moment — a failed arm is counted and ABSORBED by
    :func:`arm`; the serving path never sees it."""
    global _ON
    duration_ms = float(duration_ms)
    import math

    if not math.isfinite(duration_ms) or duration_ms <= 0:
        # A NaN/inf window would defeat the self-disarm deadline (NaN
        # compares False against everything) and arm forever.
        raise ValueError(f"non-finite capture window {duration_ms!r}")
    if capacity is not None and int(capacity) != PROFILER.capacity:
        with PROFILER._lock:
            PROFILER.capacity = max(64, int(capacity))
            PROFILER._ring = deque(
                PROFILER._ring, maxlen=PROFILER.capacity
            )
    PROFILER.reset()
    PROFILER._until = time.perf_counter() + duration_ms / 1e3
    _ON = True


def arm(duration_ms: float = 250.0, capacity: Optional[int] = None) -> bool:
    """Arm one bounded capture window (ms; must be finite and positive
    — the deadline is the self-disarm backstop); clears any previous
    capture. In-process callers (benches, tests) may request windows as
    long as their workload needs; the UNTRUSTED /profilez surface
    clamps its requests to :data:`MAX_WINDOW_MS` before calling here.
    Returns False — counted
    ``retry_attempts_total{profiler.arm,fallback}``, never raised —
    when the arm fails (the ``journal.dump`` absorb contract:
    observability must never become the outage)."""
    try:
        _arm(duration_ms, capacity)
    except Exception:
        from fluidframework_tpu_torch.service import retry

        retry.retry_counter().inc(site="profiler.arm", outcome="fallback")
        return False
    return True


def disarm() -> None:
    global _ON
    _ON = False


def record(
    lane: str, t0: float, t1: float, boxcar: int = -1, rows: int = 0,
) -> None:
    """Record one interval on the process profiler (producers gate on
    :data:`_ON` BEFORE taking any extra work; this re-check makes direct
    calls safe too)."""
    if not _ON:
        return
    PROFILER.record(lane, t0, t1, boxcar=boxcar, rows=rows)


def intervals() -> List[Interval]:
    drain_gc_events()  # buffered collector pauses land before the read
    return PROFILER.intervals()


def summarize() -> Dict[str, Any]:
    drain_gc_events()
    return PROFILER.summarize()


def chrome_trace() -> Dict[str, Any]:
    drain_gc_events()
    return PROFILER.chrome_trace()


def render() -> str:
    drain_gc_events()
    return PROFILER.render()


def reset() -> None:
    PROFILER.reset()
    disarm()
    _GC_T0.clear()
    del _GC_PENDING[:]


# ---------------------------------------------------------------------------
# Watchdog metric families — registered in ONE place (the
# ``tree_ingest_counter`` idiom).


def loop_lag_gauge(registry=None):
    """``event_loop_lag_ms``: the socket loop's measured tick overshoot
    (expected-vs-actual sleep delta) — a blocking readback regression on
    the serving loop shows up HERE by name, not as mystery latency."""
    from fluidframework_tpu_torch.telemetry import metrics

    reg = registry or metrics.REGISTRY
    return reg.gauge(
        "event_loop_lag_ms",
        "asyncio serving-loop lag: measured tick delta past the expected "
        "period (the loop-stall watchdog's signal)",
    )


def gc_pause_histogram(registry=None):
    from fluidframework_tpu_torch.telemetry import metrics

    reg = registry or metrics.REGISTRY
    return reg.histogram(
        "gc_pause_ms",
        "stop-the-world garbage-collector pause durations (gc.callbacks)",
    )


def gc_pause_counter(registry=None):
    from fluidframework_tpu_torch.telemetry import metrics

    reg = registry or metrics.REGISTRY
    return reg.counter(
        "gc_pauses_total",
        "garbage-collector pauses observed, by generation",
        labelnames=("gen",),
    )


# ---------------------------------------------------------------------------
# gc.callbacks pause hooks
#
# DEADLOCK RULE: a gc callback runs mid-allocation on WHATEVER thread
# triggered the collection — including a thread currently inside a
# metrics ``samples()``/``observe()`` or the profiler ring's locked
# append (all of which allocate while holding a non-reentrant lock). A
# callback that takes any of those locks can therefore deadlock the
# thread against itself. So the callback below touches NO locks: it
# appends the pause to a plain list (GIL-atomic) and normal code drains
# it (:func:`drain_gc_events` — called by the read surfaces and the
# network server's lag sentinel tick).

_GC_T0: Dict[int, float] = {}  # generation -> pause start (perf_counter)
_GC_PENDING: List[Any] = []  # (t0, t1, gen) tuples awaiting drain
_GC_PENDING_MAX = 1024  # bound: a never-drained process must not grow
_gc_installed = False


def _gc_callback(phase: str, info: dict) -> None:
    # LOCK-FREE by contract (see the deadlock rule above).
    gen = int(info.get("generation", -1))
    if phase == "start":
        _GC_T0[gen] = time.perf_counter()
        return
    t0 = _GC_T0.pop(gen, None)
    if t0 is None:
        return
    _GC_PENDING.append((t0, time.perf_counter(), gen))
    if len(_GC_PENDING) > _GC_PENDING_MAX:
        del _GC_PENDING[: _GC_PENDING_MAX // 2]


def drain_gc_events() -> int:
    """Fold buffered collector pauses into the metric families (and the
    ``gc_pause`` timeline lane while a capture is armed). Runs in
    NORMAL code — a collection triggering mid-drain just appends to the
    pending list again. Returns how many pauses drained."""
    n = 0
    while _GC_PENDING:
        try:
            t0, t1, gen = _GC_PENDING.pop(0)
        except IndexError:  # racing drain on another thread
            break
        gc_pause_histogram().observe((t1 - t0) * 1e3)
        gc_pause_counter().inc(gen=str(gen))
        if _ON:
            PROFILER.record("gc_pause", t0, t1)
        n += 1
    return n


def install_gc_hooks() -> bool:
    """Install the collector pause hooks (idempotent). Pauses buffer
    lock-free in the callback and land on ``gc_pause_ms``/
    ``gc_pauses_total`` (and the ``gc_pause`` timeline lane while
    armed) when :func:`drain_gc_events` runs — the profiler read
    surfaces and the network server's lag sentinel drain every tick."""
    import gc

    global _gc_installed
    if _gc_installed:
        return False
    gc.callbacks.append(_gc_callback)
    _gc_installed = True
    return True


def uninstall_gc_hooks() -> None:
    import gc

    global _gc_installed
    if _gc_installed and _gc_callback in gc.callbacks:
        gc.callbacks.remove(_gc_callback)
    _gc_installed = False
    _GC_T0.clear()
    del _GC_PENDING[:]
