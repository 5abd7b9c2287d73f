"""Drivers — client ⇄ service adapters.

Counterpart of ``fluidframework_tpu/drivers/``, all of it: the local driver
(the in-proc adapter), the network driver (the client of the socket front
door), the replay driver (stored-op-stream playback), the file driver
(snapshots and op logs on disk), the caching and debugger service
wrappers and the binary snapshot codec. The contract is the surface a
client consumes: ``connect() -> connection`` (live stream), ``get_deltas``
(historical fetch), ``store`` (summary storage).
"""

from fluidframework_tpu_torch.drivers.file_driver import (
    FileDocumentService,
    load_document,
    save_document,
)
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
    "FileDocumentService",
    "LocalDocumentServiceFactory",
    "NetworkConnection",
    "NetworkDocumentServiceFactory",
    "NetworkFluidService",
    "ReplayDocumentService",
    "RestBlobBackend",
    "load_document",
    "resolve_url",
    "save_document",
]
