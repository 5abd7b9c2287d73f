"""The partitioned stream-lambda plugin surface.

Counterpart of ``fluidframework_tpu/service/lambdas.py``, of which only the
:class:`PartitionLambda` base class is ported (the reference's
``IPartitionLambda``, ``services-core/src/lambdas.ts:72``): the device
stage's ``TpuDeliLambda`` implements it. The runners, deli, scribe,
scriptorium, broadcaster and the partitioned log belong to the pipeline
and are not ported yet.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple


class PartitionLambda:
    """IPartitionLambda: handle one record, emit (topic, key, value) tuples;
    expose/restore durable state for checkpoints.

    ``state()`` MUST return an independent snapshot (no references to
    live mutable structures): the checkpoint store keeps it as-is.
    ``restore`` likewise must not mutate the state object it is given.

    ``wants``: optional frozenset of record types (``value["t"]``) the
    lambda acts on; a runner drops non-matching records before the
    handler call. None = every record."""

    wants: Optional[frozenset] = None

    def handler(self, key: str, value: Any) -> List[Tuple[str, str, Any]]:
        raise NotImplementedError

    def state(self) -> Any:
        return None

    @classmethod
    def restore(cls, state: Any) -> "PartitionLambda":
        raise NotImplementedError
