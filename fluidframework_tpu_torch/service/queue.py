"""Partitioned append-only log — the service's internal op bus.

Reference: ``server/routerlicious/packages/services-core/src/queue.ts``
(``IProducer`` :26 / ``IConsumer`` :84) over Kafka (librdkafka,
``services-ordering-rdkafka``): topics are split into partitions by
document key, each partition is a strictly-ordered append log, consumers
track committed offsets and resume from them after a crash, and producers
boxcar-batch messages per partition (``pendingBoxcar.ts``).

In-proc Python backend here; ``utils.native.NativePartitionLog`` (C++,
``native/partition_log.cpp``) provides the same interface persistently —
both are accepted by the lambda framework.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from fluidframework_tpu_torch.testing.faults import inject_fault

DEFAULT_PARTITIONS = 8  # reference config.json:38


def partition_of(key: str, n_partitions: int) -> int:
    """Stable document-key -> partition routing (Kafka key partitioner)."""
    return zlib.crc32(key.encode()) % n_partitions


@dataclass(slots=True)
class LogRecord:
    offset: int
    key: str
    value: Any


class PartitionedLog:
    """Topics of N ordered partitions with offset-based consumption."""

    def __init__(self, n_partitions: int = DEFAULT_PARTITIONS):
        self.n_partitions = n_partitions
        # (topic, partition) -> list of LogRecord
        self._logs: Dict[Tuple[str, int], List[LogRecord]] = {}
        # (group, topic, partition) -> committed offset (next to consume)
        self._commits: Dict[Tuple[str, str, int], int] = {}
        # key -> partition: crc32 is cheap but the serving path routes the
        # same 10k+ document keys every round — a dict hit is cheaper.
        self._pcache: Dict[str, int] = {}

    # -- producer --------------------------------------------------------------

    def _partition(self, key: str) -> int:
        p = self._pcache.get(key)
        if p is None:
            p = self._pcache[key] = partition_of(key, self.n_partitions)
        return p

    @inject_fault("queue.send")
    def send(self, topic: str, key: str, value: Any) -> Tuple[int, int]:
        """Append one message; returns (partition, offset)."""
        p = self._partition(key)
        log = self._logs.setdefault((topic, p), [])
        rec = LogRecord(offset=len(log), key=key, value=value)
        log.append(rec)
        return p, rec.offset

    @inject_fault("queue.send")
    def send_batch(self, topic: str, entries: List[Tuple[str, Any]]) -> None:
        """Boxcar append (pendingBoxcar.ts batching): one producer call
        for a whole round of records — the bulk front door and the lambda
        runners' per-chunk emissions ride this instead of per-record
        ``send`` (the per-call overhead is real serving-path cost at 10k+
        frames per round)."""
        logs = self._logs
        for key, value in entries:
            p = self._partition(key)
            log = logs.get((topic, p))
            if log is None:
                log = logs.setdefault((topic, p), [])
            log.append(LogRecord(len(log), key, value))

    # -- consumer --------------------------------------------------------------

    def read(
        self, topic: str, partition: int, from_offset: int, limit: Optional[int] = None
    ) -> List[LogRecord]:
        log = self._logs.get((topic, partition), [])
        out = log[from_offset:]
        return out if limit is None else out[:limit]

    def end_offset(self, topic: str, partition: int) -> int:
        return len(self._logs.get((topic, partition), []))

    # -- consumer-group offset commits ----------------------------------------

    def commit(self, group: str, topic: str, partition: int, offset: int) -> None:
        key = (group, topic, partition)
        assert offset >= self._commits.get(key, 0), "commits never rewind"
        self._commits[key] = offset

    def committed(self, group: str, topic: str, partition: int) -> int:
        return self._commits.get((group, topic, partition), 0)
