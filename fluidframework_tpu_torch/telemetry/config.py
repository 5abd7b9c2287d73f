"""Config providers, feature gates, and MonitoringContext.

Reference: ``telemetry-utils`` config system — a host supplies an
``IConfigProviderBase`` (``getRawConfig(name)``), the client wraps it in a
typed cached view (``mc.config.getBoolean("Fluid.ContainerRuntime...")``,
use at ``containerRuntime.ts:1846-1849``), and ``MonitoringContext`` bundles
logger + config so both thread through constructors together.

Server side, the reference layers JSON config via nconf
(``routerlicious/config/config.json``) with typed views in
``services-core/src/configuration.ts``; ``LayeredConfig`` reproduces the
precedence chain (overrides > env-style dict > base file).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from fluidframework_tpu_torch.telemetry.logger import TelemetryLogger


class ConfigProvider:
    """Typed, cached view over a raw config source
    (reference ``ConfigProvider`` wrapping ``IConfigProviderBase``).

    Raw values may be bools, numbers, strings, or JSON strings; each typed
    getter coerces conservatively and returns ``default`` on mismatch —
    feature gates must never throw.
    """

    def __init__(self, raw: Optional[Dict[str, Any]] = None):
        self._raw = dict(raw or {})
        self._cache: Dict[str, Any] = {}

    def _get(self, name: str) -> Any:
        if name not in self._cache:
            self._cache[name] = self._raw.get(name)
        return self._cache[name]

    def get_boolean(self, name: str, default: Optional[bool] = None) -> Optional[bool]:
        v = self._get(name)
        if isinstance(v, bool):
            return v
        if isinstance(v, str) and v.lower() in ("true", "false"):
            return v.lower() == "true"
        return default

    def get_number(self, name: str, default: Optional[float] = None) -> Optional[float]:
        v = self._get(name)
        if isinstance(v, bool):
            return default
        if isinstance(v, (int, float)):
            return v
        if isinstance(v, str):
            try:
                return float(v)
            except ValueError:
                return default
        return default

    def get_string(self, name: str, default: Optional[str] = None) -> Optional[str]:
        v = self._get(name)
        return v if isinstance(v, str) else default

    def set(self, name: str, value: Any) -> None:
        """Dynamic override (tests / control messages)."""
        self._raw[name] = value
        self._cache.pop(name, None)


class MonitoringContext:
    """Logger + config bundle (reference ``MonitoringContext``/``mc``)."""

    def __init__(
        self,
        logger: Optional[TelemetryLogger] = None,
        config: Optional[ConfigProvider] = None,
    ):
        self.logger = logger or TelemetryLogger()
        self.config = config or ConfigProvider()


class LayeredConfig:
    """Layered service config: overrides > upper layers > base
    (reference nconf stack in ``routerlicious/src/...`` + per-deployable
    ``config/config.json``). Keys are ``:``-separated paths, matching
    nconf's ``config.get("deli:checkpointHeuristics")`` style.
    """

    def __init__(self, *layers: Dict[str, Any]):
        # layers[0] has highest precedence.
        self._layers: List[Dict[str, Any]] = [dict(l) for l in layers]

    @staticmethod
    def from_json_file(path: str, *overrides: Dict[str, Any]) -> "LayeredConfig":
        with open(path) as f:
            base = json.load(f)
        return LayeredConfig(*overrides, base)

    def get(self, path: str, default: Any = None) -> Any:
        keys = path.split(":")
        for layer in self._layers:
            node: Any = layer
            found = True
            for k in keys:
                if isinstance(node, dict) and k in node:
                    node = node[k]
                else:
                    found = False
                    break
            if found:
                return node
        return default

    def set(self, path: str, value: Any) -> None:
        """Runtime override onto the top layer (control-message updates,
        reference deli ``ControlMessageType.UpdateDSN`` handling)."""
        if not self._layers:
            self._layers.append({})
        node = self._layers[0]
        keys = path.split(":")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
