"""The device backend's typed backpressure signal.

Counterpart of ``fluidframework_tpu/service/admission.py``, of which only
:class:`PressureSignal` is ported: it is what
:meth:`DeviceFleetBackend.pressure` returns. The admission controller, the
token buckets and the tiered load-shedding controller that consume it
belong to the pipeline and are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class PressureSignal:
    """The typed backpressure signal the device backend surfaces
    (:meth:`DeviceFleetBackend.pressure`): ring occupancy, queue depth and
    feed latency, pure host state."""

    ring_frac: float = 0.0  # staged ring slots / ring depth
    queue_frac: float = 0.0  # buffered rows / max_batch
    feed_lag_ms: float = 0.0  # age of the oldest buffered row
    scan_inflight: bool = False

    def score(self, lag_ref_ms: float) -> float:
        """Scalar pressure: the max-loaded dimension (a single saturated
        axis is overload even when the others are idle)."""
        lag = self.feed_lag_ms / lag_ref_ms if lag_ref_ms > 0 else 0.0
        return max(self.ring_frac, self.queue_frac, lag)
