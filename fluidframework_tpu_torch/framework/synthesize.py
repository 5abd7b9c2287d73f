"""Dependency synthesizer — typed DI scopes for provider objects.

Reference: ``packages/framework/synthesize`` — ``DependencyContainer``
registers providers by interface key (value, factory, or async factory)
and ``synthesize`` produces an object with required and optional provider
slots; unknown required keys throw, unknown optional keys resolve to None.
Parent containers give layered scopes.

A copy of ``fluidframework_tpu/framework/synthesize.py``
with the port's imports; host-only.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class DependencyContainer:
    def __init__(self, parent: Optional["DependencyContainer"] = None):
        self._providers: Dict[str, Any] = {}
        self._parent = parent

    def register(self, key: str, provider: Any) -> None:
        """Register a value, or a zero-arg factory for lazy instantiation
        (factories run once; their result is cached)."""
        self._providers[key] = provider

    def unregister(self, key: str) -> None:
        self._providers.pop(key, None)

    def has(self, key: str) -> bool:
        return key in self._providers or (
            self._parent is not None and self._parent.has(key)
        )

    def resolve(self, key: str) -> Any:
        if key in self._providers:
            provider = self._providers[key]
            if callable(provider):
                provider = provider()
                self._providers[key] = provider  # cache the instance
            return provider
        if self._parent is not None:
            return self._parent.resolve(key)
        raise KeyError(f"no provider registered for {key!r}")

    def synthesize(
        self,
        required: tuple = (),
        optional: tuple = (),
    ) -> "SynthesizedObject":
        """Build the provider scope object (reference ``synthesize``):
        required keys must resolve, optional keys resolve to None."""
        values: Dict[str, Any] = {}
        for key in required:
            values[key] = self.resolve(key)  # KeyError if missing
        for key in optional:
            values[key] = self.resolve(key) if self.has(key) else None
        return SynthesizedObject(values)


class SynthesizedObject:
    """Attribute access over the synthesized provider slots."""

    def __init__(self, values: Dict[str, Any]):
        self._values = values

    def __getattr__(self, key: str) -> Any:
        try:
            return self._values[key]
        except KeyError:
            raise AttributeError(key) from None

    def __contains__(self, key: str) -> bool:
        return key in self._values
