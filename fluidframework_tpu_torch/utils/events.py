"""TypedEventEmitter — the event surface every DDS and runtime exposes.

Reference: ``common/lib/common-utils`` ``TypedEventEmitter`` (Node's
EventEmitter with typed listener signatures). Listener errors propagate to
the caller (the reference does not swallow them either — a throwing
listener breaks op processing, which the fuzz suites would catch).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List


class TypedEventEmitter:
    def __init__(self) -> None:
        self._listeners: Dict[str, List[Callable[..., None]]] = {}

    def on(self, event: str, listener: Callable[..., None]) -> Callable[..., None]:
        """Subscribe; returns the listener so callers can keep it for off()."""
        self._listeners.setdefault(event, []).append(listener)
        return listener

    def once(self, event: str, listener: Callable[..., None]) -> None:
        def wrapper(*args: Any, **kw: Any) -> None:
            self.off(event, wrapper)
            listener(*args, **kw)

        self.on(event, wrapper)

    def off(self, event: str, listener: Callable[..., None]) -> None:
        handlers = self._listeners.get(event)
        if handlers and listener in handlers:
            handlers.remove(listener)

    def emit(self, event: str, *args: Any, **kw: Any) -> None:
        for listener in list(self._listeners.get(event, ())):
            listener(*args, **kw)

    def has_listeners(self, event: str) -> bool:
        return bool(self._listeners.get(event))
