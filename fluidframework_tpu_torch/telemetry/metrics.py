"""Unified metrics registry: counters, gauges, fixed-bucket histograms.

Reference: the server stack wraps every lambda in a ``Lumberjack`` metric
(``server/routerlicious/packages/services-telemetry``) and the deployable
scrapes aggregate health off the process — here that aggregation layer is
explicit: one process-global :class:`MetricsRegistry` that every producer
(Lumber completion, the frame trace spine's span reductions, the device
telemetry lanes, the store node's request counters) feeds, with a
deterministic ``snapshot()`` and Prometheus text-format ``render()``
served as ``GET /metrics`` by ``service/network_server.py`` and
``service/store_server.py``.

Determinism contract (the graftlint determinism pass's bar, applied to
telemetry): two replicas that observed the same values render byte-equal
output — metric families iterate in name order, samples in sorted label
order, and values format through one shared formatter. Registries are
cheap plain-dict machines guarded by one lock; the serving hot path never
allocates here (frame tracing is sampled, Lumber is control-plane only).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from fluidframework_tpu_torch.telemetry.tracing import FRAME_STAGES

# Fixed default buckets in MILLISECONDS — the stage-span scale: sub-ms
# device work up through the ~105ms dispatch-floor tail and beyond.
DEFAULT_BUCKETS_MS: Tuple[float, ...] = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
    500.0, 1000.0, 2500.0,
)

# No serving-path span can legitimately exceed this (10 minutes): trace
# timestamps ride a cooperative wire field, and one absolute-epoch or
# skewed stamp must not put ~1e12 into a histogram sum.
SPAN_SANITY_MS = 600_000.0

# ---------------------------------------------------------------------------
# Family vocabulary: every Prometheus family a production module may
# register, with its kind — the ``faults.SITES`` discipline applied to
# the exposition surface. The graftlint ``vocab-drift`` pass parses this
# dict STATICALLY and cross-checks it against every
# ``reg.counter/gauge/histogram("<family>", ...)`` registration in the
# package: an undeclared family, a kind mismatch, or a declared family
# nothing registers (a dead dashboard row) fails CI. Scrape consumers
# (dashboards, the autoscaler, check_bench_artifact) can therefore trust
# this table as THE exposition contract.

FAMILIES: Dict[str, str] = {
    # -- admission / overload -----------------------------------------
    "admission_denied_total": "counter",
    "admission_tokens": "gauge",
    "overload_shed_total": "counter",
    "serving_overload_tier": "gauge",
    "serving_overload_tier_transitions_total": "counter",
    # -- device backend / read tier -------------------------------
    "device_backend_totals": "gauge",
    "device_shard_telemetry": "gauge",
    "reads_per_device_dispatch": "gauge",
    "read_cache_hits_total": "counter",
    "read_cache_misses_total": "counter",
    # -- chaos / recovery ---------------------------------------------
    "faults_injected_total": "counter",
    "retry_attempts_total": "counter",
    # -- flight recorder / profiler / watchdogs -------------------
    "journal_dumps_total": "counter",
    "event_loop_lag_ms": "gauge",
    "gc_pause_ms": "histogram",
    "gc_pauses_total": "counter",
    # -- trace spine / stage spans -------------------------------------
    "serving_stage_ms": "histogram",
    "trace_frames_dropped_total": "counter",
    "tree_ingest_commits_total": "counter",
    # -- lumber / store node ------------------------------------------------
    "lumber_events_total": "counter",
    "lumber_duration_ms": "histogram",
    "store_requests_total": "counter",
    # -- document residency -------------------------------------------
    "residency_docs": "gauge",
    "residency_wakes_total": "counter",
    "residency_hit_ratio": "gauge",
    "residency_wake_latency_ms": "histogram",
}

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labelnames: Sequence[str], labels: Dict[str, Any]) -> _LabelKey:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"labels {sorted(labels)} != declared {sorted(labelnames)}"
        )
    # Sorted (name, value) pairs: the sample identity AND the render order.
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _fmt(v: float) -> str:
    """One shared value formatter so replicas render byte-equal text."""
    if v == float("inf"):
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _esc(v: str) -> str:
    """Prometheus label-value escaping (backslash, quote, newline) —
    label values can carry request-derived strings, which must not be
    able to break or inject exposition lines."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str]):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        self._values: Dict[_LabelKey, float] = {}

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: Any) -> float:
        return self._values.get(_label_key(self.labelnames, labels), 0.0)

    def samples(self) -> List[Tuple[_LabelKey, str, float]]:
        with self._lock:
            return [(k, "", v) for k, v in sorted(self._values.items())]


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        self._values: Dict[_LabelKey, float] = {}

    def set(self, value: float, **labels: Any) -> None:
        with self._lock:
            self._values[_label_key(self.labelnames, labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: Any) -> float:
        return self._values.get(_label_key(self.labelnames, labels), 0.0)

    def samples(self) -> List[Tuple[_LabelKey, str, float]]:
        with self._lock:
            return [(k, "", v) for k, v in sorted(self._values.items())]


class Histogram(_Metric):
    """Fixed-bucket histogram: per label set, cumulative bucket counts plus
    sum and count (the Prometheus exposition shape). Buckets are fixed at
    construction — scrapes across replicas stay mergeable."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS_MS,
    ):
        super().__init__(name, help, labelnames)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError("histogram needs at least one bucket")
        self.buckets = bs
        # label key -> [per-bucket counts..., +Inf count, sum]
        self._values: Dict[_LabelKey, List[float]] = {}

    def observe(self, value: float, **labels: Any) -> None:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            row = self._values.get(key)
            if row is None:
                row = self._values[key] = [0.0] * (len(self.buckets) + 2)
            for i, b in enumerate(self.buckets):
                if value <= b:
                    row[i] += 1
                    break
            else:
                row[len(self.buckets)] += 1
            row[-1] += float(value)

    def count(self, **labels: Any) -> int:
        row = self._values.get(_label_key(self.labelnames, labels))
        return int(sum(row[:-1])) if row else 0

    def sum(self, **labels: Any) -> float:
        row = self._values.get(_label_key(self.labelnames, labels))
        return row[-1] if row else 0.0

    def samples(self) -> List[Tuple[_LabelKey, str, float]]:
        out: List[Tuple[_LabelKey, str, float]] = []
        with self._lock:
            for key, row in sorted(self._values.items()):
                cum = 0.0
                for i, b in enumerate(self.buckets):
                    cum += row[i]
                    le = key + (("le", _fmt(b)),)
                    out.append((le, "_bucket", cum))
                cum += row[len(self.buckets)]
                out.append((key + (("le", "+Inf"),), "_bucket", cum))
                out.append((key, "_sum", row[-1]))
                out.append((key, "_count", cum))
        return out


class MetricsRegistry:
    """Process-global metric registry. ``counter``/``gauge``/``histogram``
    are get-or-create (idempotent across call sites — the Lumberjack
    pattern); a name re-registered with a different kind or label set is
    a programming error and raises."""

    def __init__(self) -> None:
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name: str, help: str,
                       labelnames: Sequence[str], **kw) -> Any:
        # Lock-free hit path: producers re-resolve their metric on every
        # observation (the Lumberjack-factory idiom survives registry
        # reset), so the common case must be one dict probe, not a lock.
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = self._metrics[name] = cls(
                        name, help, labelnames, **kw
                    )
                    return m
        if not isinstance(m, cls) or m.labelnames != tuple(labelnames):
            raise ValueError(
                f"metric {name!r} already registered as {m.kind} "
                f"with labels {m.labelnames}"
            )
        return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(
        self, name: str, help: str = "", labelnames: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS_MS,
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labelnames, buckets=buckets
        )

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def reset(self) -> None:
        """Drop every metric (test isolation)."""
        with self._lock:
            self._metrics.clear()

    # -- exposition ------------------------------------------------------------

    def snapshot(self) -> Dict[str, dict]:
        """Deterministic plain-dict view: metric name -> {type, help,
        samples: [(labels_dict, suffix, value)]}, names and samples in
        sorted order — the form benches and tests consume."""
        with self._lock:
            metrics = dict(self._metrics)
        out: Dict[str, dict] = {}
        for name in sorted(metrics):
            m = metrics[name]
            out[name] = {
                "type": m.kind,
                "help": m.help,
                "samples": [
                    (dict(key), suffix, value)
                    for key, suffix, value in m.samples()
                ],
            }
        return out

    def render(self) -> str:
        """Prometheus text exposition format 0.0.4; byte-deterministic for
        a given set of observations (sorted families, sorted samples).
        Registration is snapshotted under the lock first: the store node
        serves scrapes from request threads while other threads register
        (dict iteration would race)."""
        with self._lock:
            metrics = dict(self._metrics)
        lines: List[str] = []
        for name in sorted(metrics):
            m = metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            for key, suffix, value in m.samples():
                if key:
                    labels = ",".join(f'{k}="{_esc(v)}"' for k, v in key)
                    lines.append(f"{name}{suffix}{{{labels}}} {_fmt(value)}")
                else:
                    lines.append(f"{name}{suffix} {_fmt(value)}")
        return "\n".join(lines) + "\n"


# The process-global registry every producer feeds (the Lumberjack-factory
# idiom: module state, explicit reset for tests).
REGISTRY = MetricsRegistry()


# -- shared metric feeds ------------------------------------------------------


def observe_stage_spans(
    spans: Dict[str, float], registry: Optional[MetricsRegistry] = None,
) -> None:
    """Fold one completed trace's per-stage durations (``tracing.spans``
    output: ``{stage}_ms`` + ``total_ms``) into the shared stage
    histogram — the single reduction both the per-op path and the frame
    spine feed. Only the known stage vocabulary is observed: trace
    entries ride a protocol wire field, so a client-authored service
    name must not mint a new label set (unbounded registry growth), and
    only sane durations are observed — trace timestamps are cooperative,
    so a negative or wildly out-of-range span (a forged or clock-skewed
    stamp) must not poison the histogram sums."""
    reg = registry or REGISTRY
    hist = reg.histogram(
        "serving_stage_ms",
        "per-stage latency of sampled serving-path messages (ms)",
        labelnames=("stage",),
    )
    for key, value in sorted(spans.items()):
        stage = key[:-3] if key.endswith("_ms") else key
        if (stage == "total" or stage in FRAME_STAGES) and (
            0 <= value <= SPAN_SANITY_MS
        ):
            hist.observe(value, stage=stage)


def tree_ingest_counter(registry: Optional[MetricsRegistry] = None) -> Counter:
    """The SharedTree ingest burn-down counter, registered in ONE place —
    the device and host ingest paths share it, and a labelnames drift
    between two inline registrations would raise at ingest time."""
    reg = registry or REGISTRY
    return reg.counter(
        "tree_ingest_commits_total",
        "SharedTree commits integrated, by path (device/host) and "
        "host-fallback reason",
        labelnames=("path", "reason"),
    )


def _bucket_quantile(
    buckets: Tuple[float, ...], counts: Sequence[float], q: float
) -> float:
    """One quantile estimate from fixed-bucket counts (per-bucket, NOT
    cumulative), the ``histogram_quantile`` interpolation: walk the
    cumulative counts to the target rank, then interpolate linearly
    inside the bucket (lower edge = previous bound, 0 for the first).
    Ranks landing in the +Inf bucket return the highest finite bound —
    the honest answer a fixed-bucket histogram can give."""
    total = sum(counts)
    if total <= 0:
        return 0.0
    target = q * total
    cum = 0.0
    for i, b in enumerate(buckets):
        prev_cum = cum
        cum += counts[i]
        if cum >= target:
            lo = buckets[i - 1] if i else 0.0
            frac = (target - prev_cum) / counts[i] if counts[i] else 0.0
            return lo + (b - lo) * frac
    return buckets[-1]


def stage_span_summary(
    registry: Optional[MetricsRegistry] = None,
    quantiles: Sequence[float] = (),
) -> Dict[str, Any]:
    """Per-stage summary from the shared stage histogram. The default
    (no ``quantiles``) keeps the shape — ``{stage: mean_ms}``, the
    compact ``serving_stage_spans_ms`` form bench.py merges into its
    result file. With ``quantiles`` (e.g. ``(0.5, 0.95, 0.99)``)
    each stage maps to ``{"mean": …, "p50": …, "p95": …, "p99": …}`` —
    estimates interpolated from the SAME fixed buckets (no new state,
    no new histogram type: scrapes across replicas stay mergeable, the
    quantile is a read-side reduction)."""
    reg = registry or REGISTRY
    hist = reg.get("serving_stage_ms")
    if not isinstance(hist, Histogram):
        return {}
    out: Dict[str, Any] = {}
    with hist._lock:  # snapshot: observe() may be inserting a new stage
        rows = [
            (dict(key), list(row[:-1]), row[-1])
            for key, row in sorted(hist._values.items())
        ]
    for labels, counts, total in rows:
        n = sum(counts)
        if not n:
            continue
        stage = labels.get("stage", "")
        if not quantiles:
            out[stage] = round(total / n, 3)
        else:
            row: Dict[str, float] = {"mean": round(total / n, 3)}
            for q in quantiles:
                row[f"p{round(q * 100):g}"] = round(
                    _bucket_quantile(hist.buckets, counts, float(q)), 3
                )
            out[stage] = row
    return out


def trace_dropped_counter(
    registry: Optional[MetricsRegistry] = None,
) -> Counter:
    """``trace_frames_dropped_total{reason}``, registered in ONE place
    (the ``tree_ingest_counter`` idiom): traces evicted incomplete from
    the ``TraceBook`` ledger used to vanish silently into the host-side
    ``dropped`` int — sampled-trace loss is an observability gap the
    registry must count."""
    reg = registry or REGISTRY
    return reg.counter(
        "trace_frames_dropped_total",
        "sampled frame traces dropped before completing, by reason",
        labelnames=("reason",),
    )
