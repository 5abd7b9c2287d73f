"""Drivers — client ⇄ service adapters.

Counterpart of ``fluidframework_tpu/drivers/``, of which the local driver
(the in-proc adapter) and the network driver (the client of the socket
front door) are ported; the file and replay drivers are not. The contract
is the surface a client consumes: ``connect() -> connection`` (live
stream), ``get_deltas`` (historical fetch), ``store`` (summary storage).
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

__all__ = [
    "LocalDocumentServiceFactory",
    "NetworkConnection",
    "NetworkDocumentServiceFactory",
    "NetworkFluidService",
    "RestBlobBackend",
    "resolve_url",
]
