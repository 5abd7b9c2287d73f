"""Drivers — client ⇄ service adapters.

Counterpart of ``fluidframework_tpu/drivers/``, of which the local driver
(the in-proc adapter), the network driver (the client of the socket front
door) and the replay driver (stored-op-stream playback) are ported; the
file driver is not. The contract is the surface a client consumes:
``connect() -> connection`` (live stream), ``get_deltas`` (historical
fetch), ``store`` (summary storage).
"""

from fluidframework_tpu_torch.drivers.local_driver import (
    LocalDocumentServiceFactory,
    resolve_url,
)
from fluidframework_tpu_torch.drivers.network_driver import (
    NetworkConnection,
    NetworkDocumentServiceFactory,
    NetworkFluidService,
    RestBlobBackend,
)
from fluidframework_tpu_torch.drivers.replay_driver import (
    ReplayDocumentService,
)

__all__ = [
    "LocalDocumentServiceFactory",
    "NetworkConnection",
    "NetworkDocumentServiceFactory",
    "NetworkFluidService",
    "ReplayDocumentService",
    "RestBlobBackend",
    "resolve_url",
]
