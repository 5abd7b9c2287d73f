"""Garbage collection — reference-graph reachability + unreferenced-state
tracking.

Reference: ``packages/runtime/garbage-collector`` (``runGarbageCollection``)
and ``packages/runtime/container-runtime/src/gc/garbageCollection.ts:363``
(``collectGarbage`` :1007, unreferenced state machine :223,270-326,
tombstone mode :415, sweep :399-413): at each summary the runtime builds
the handle-reference graph, marks nodes unreachable from the root, and
advances each unreferenced node through
Inactive -> TombstoneReady -> SweepReady on configured timeouts. Tombstoned
nodes error on access; swept nodes are deleted. GC state (unreferenced
timestamps) persists in the summary under the ``gc`` tree.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set


def run_garbage_collection(
    graph: Dict[str, List[str]], roots: List[str]
) -> Set[str]:
    """Reachable node set from ``roots`` over outbound-route edges
    (reference garbage-collector/src/garbageCollector.ts)."""
    seen: Set[str] = set()
    stack = [r for r in roots]
    while stack:
        node = stack.pop()
        if node in seen:
            continue
        seen.add(node)
        for out in graph.get(node, ()):  # missing nodes are leaves
            if out not in seen:
                stack.append(out)
    return seen


class UnreferencedState(enum.Enum):
    """Lifecycle of an unreferenced node (garbageCollection.ts:223)."""

    ACTIVE = "active"  # recently unreferenced, still loadable
    INACTIVE = "inactive"  # past inactiveTimeout: access is telemetry-flagged
    TOMBSTONE_READY = "tombstone"  # load/access errors (tombstone mode)
    SWEEP_READY = "sweep"  # eligible for deletion


@dataclass
class GCOptions:
    """Timeouts in seconds; clock injectable for tests (the reference uses
    wall-clock timestamps persisted across summaries)."""

    inactive_timeout_s: float = 7 * 24 * 3600.0
    tombstone_timeout_s: float = 30 * 24 * 3600.0
    sweep_grace_s: float = 6 * 3600.0  # extra delay after tombstone-ready
    tombstone_mode: bool = True
    sweep_enabled: bool = False
    clock: Callable[[], float] = time.time


@dataclass
class GCResult:
    reachable: Set[str]
    unreferenced: Dict[str, UnreferencedState]
    swept: List[str] = field(default_factory=list)


class GarbageCollector:
    """Mark-phase GC run at summary time (collectGarbage)."""

    def __init__(self, options: Optional[GCOptions] = None):
        self.options = options or GCOptions()
        # route -> timestamp it was first seen unreferenced
        self.unreferenced_since: Dict[str, float] = {}
        # Routes deleted by sweep stay dead forever (the reference records
        # deleted nodes in the GC summary so they can never be revived).
        self.swept_routes: Set[str] = set()

    def state_of(self, route: str) -> UnreferencedState:
        if route in self.swept_routes:
            return UnreferencedState.SWEEP_READY
        since = self.unreferenced_since.get(route)
        if since is None:
            return UnreferencedState.ACTIVE
        age = self.options.clock() - since
        if age >= self.options.tombstone_timeout_s + self.options.sweep_grace_s:
            return UnreferencedState.SWEEP_READY
        if age >= self.options.tombstone_timeout_s:
            return UnreferencedState.TOMBSTONE_READY
        if age >= self.options.inactive_timeout_s:
            return UnreferencedState.INACTIVE
        return UnreferencedState.ACTIVE

    def is_tombstoned(self, route: str) -> bool:
        return self.options.tombstone_mode and self.state_of(route) in (
            UnreferencedState.TOMBSTONE_READY,
            UnreferencedState.SWEEP_READY,
        )

    def collect(self, graph: Dict[str, List[str]], roots: List[str]) -> GCResult:
        """One mark pass: recompute reachability, start/clear unreferenced
        tracking, and report nodes whose state advanced."""
        now = self.options.clock()
        all_nodes = set(graph)
        for outs in graph.values():
            all_nodes.update(outs)
        reachable = run_garbage_collection(graph, roots)
        # Re-referenced nodes rejoin the live set (tracking resets — the
        # reference clears the unreferenced timestamp on revival).
        for route in list(self.unreferenced_since):
            if route in reachable or route not in all_nodes:
                del self.unreferenced_since[route]
        unreferenced: Dict[str, UnreferencedState] = {}
        swept: List[str] = []
        for route in sorted(all_nodes - reachable):
            self.unreferenced_since.setdefault(route, now)
            state = self.state_of(route)
            unreferenced[route] = state
            if state is UnreferencedState.SWEEP_READY and self.options.sweep_enabled:
                swept.append(route)
        for route in swept:
            del self.unreferenced_since[route]
            self.swept_routes.add(route)
        return GCResult(reachable=reachable, unreferenced=unreferenced, swept=swept)

    # -- summary persistence (the ``gc`` tree) --------------------------------

    def summarize(self) -> dict:
        return {
            "unreferenced": dict(self.unreferenced_since),
            "swept": sorted(self.swept_routes),
        }

    def load(self, state: dict) -> None:
        self.unreferenced_since = dict(state.get("unreferenced", {}))
        self.swept_routes = set(state.get("swept", ()))
