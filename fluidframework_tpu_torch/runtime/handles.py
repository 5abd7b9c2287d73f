"""Fluid handles — serializable references between distributed objects.

Reference: ``packages/common/core-interfaces`` ``IFluidHandle`` and the
handle (de)serialization in ``packages/dds/shared-object-base/src/serializer.ts``:
a handle is an absolute route (``/<datastore>/<channel>``) encoded inside
DDS values as ``{"type": "__fluid_handle__", "url": route}``. Handles are
what the garbage collector traces: every handle stored in a reachable
object marks its target route as referenced (garbageCollection.ts,
``getGCData``).
"""

from __future__ import annotations

from typing import Any, Iterator, List

HANDLE_KEY = "__fluid_handle__"


def encode_handle(route: str) -> dict:
    """Serialized form a handle takes inside DDS values."""
    assert route.startswith("/"), f"handle routes are absolute: {route!r}"
    return {"type": HANDLE_KEY, "url": route}


def is_handle(value: Any) -> bool:
    return isinstance(value, dict) and value.get("type") == HANDLE_KEY


def handle_route(value: dict) -> str:
    assert is_handle(value)
    return value["url"]


def collect_handle_routes(value: Any) -> List[str]:
    """All handle routes reachable inside a JSON-ish value (the serializer
    walk the reference does when computing a channel's outbound GC routes)."""
    out: List[str] = []
    _walk(value, out)
    return out


def _walk(value: Any, out: List[str]) -> None:
    if is_handle(value):
        out.append(value["url"])
    elif isinstance(value, dict):
        for v in value.values():
            _walk(v, out)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _walk(v, out)
