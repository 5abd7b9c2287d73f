"""Service-client facade — the AzureClient/TinyliciousClient analog.

Reference: ``azure/packages/azure-client`` (``AzureClient.createContainer``
AzureClient.ts:51,77, ``getContainer`` :144) and ``tinylicious-client``: a
host hands the client connection config (service endpoint + token provider);
the client mints containers from a ContainerSchema and loads existing ones
by id, returning the app-facing FluidContainer plus service-specific
audience helpers.

Counterpart of ``fluidframework_tpu/framework/client.py``. The client takes
``device=`` (the card by default, raising without one): every container it
creates or loads builds its device-backed channels there. Document ids
from the module's counter are global to the process, as in the reference.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Optional, Tuple

from fluidframework_tpu_torch.drivers.local_driver import (
    URL_SCHEME,
    LocalDocumentServiceFactory,
)
from fluidframework_tpu_torch.framework.fluid_static import (
    ContainerSchema,
    FluidContainer,
    build_root_datastore,
    schema_type_registry,
)
from fluidframework_tpu_torch.runtime.container import ContainerRuntime
from fluidframework_tpu_torch.utils import resolve_device

_doc_counter = itertools.count(1)


@dataclass
class TpuClientProps:
    """Connection configuration (reference AzureClientProps): the document
    service factory stands in for endpoint+token plumbing; swap in the
    network driver factory to hit a real service."""

    factory: Optional[LocalDocumentServiceFactory] = None

    def __post_init__(self):
        if self.factory is None:
            self.factory = LocalDocumentServiceFactory()


class TpuFluidClient:
    """Create/load containers against one Fluid service (AzureClient.ts:51)."""

    def __init__(self, props: Optional[TpuClientProps] = None, device="cuda"):
        self._props = props or TpuClientProps()
        self._device = resolve_device(device)

    @property
    def service(self):
        return self._props.factory.service

    def create_container(
        self, schema: ContainerSchema, doc_id: Optional[str] = None
    ) -> Tuple[FluidContainer, str]:
        """New container from a schema; returns (container, id). The schema's
        initial objects live under the root data object, created before the
        first op so every later loader can rebuild them deterministically."""
        doc_id = doc_id or f"doc-{next(_doc_counter)}"
        assert doc_id not in self.service.docs, f"document {doc_id!r} already exists"
        runtime = self._make_runtime(doc_id, schema)
        return FluidContainer(runtime, schema, device=self._device), doc_id

    def get_container(self, doc_id: str, schema: ContainerSchema) -> FluidContainer:
        """Load an existing container by id (AzureClient.ts:144): connect,
        load latest acked summary if any, replay deltas to head. Unknown ids
        error — silently minting a fresh empty doc would read as data loss."""
        assert doc_id in self.service.docs, f"unknown document {doc_id!r}"
        runtime = self._make_runtime(doc_id, schema)
        return FluidContainer(runtime, schema, device=self._device)

    def _make_runtime(self, doc_id: str, schema: ContainerSchema) -> ContainerRuntime:
        doc_service = self._props.factory.create_document_service(
            f"{URL_SCHEME}localhost/{doc_id}"
        )
        return ContainerRuntime(
            doc_service.service,
            doc_id,
            channels=(build_root_datastore(schema, self._device),),
            channel_types=schema_type_registry(schema, self._device),
        )
