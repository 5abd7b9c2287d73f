"""Local driver — in-proc adapter over LocalFluidService.

Reference: ``packages/drivers/local-driver`` (``localDocumentService.ts``)
+ the ``IUrlResolver`` contract: resolve a ``fluid-test://`` URL to a
document id and hand out a document service bound to the in-proc ordering
service (the test backbone every e2e suite runs on).

Counterpart of ``fluidframework_tpu/drivers/local_driver.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from fluidframework_tpu_torch.service.local_server import LocalFluidService

URL_SCHEME = "fluid-test://"


def resolve_url(url: str) -> str:
    """URL -> document id (the reference's IUrlResolver.resolve)."""
    assert url.startswith(URL_SCHEME), f"unsupported url {url!r}"
    tail = url[len(URL_SCHEME):]
    # fluid-test://host/doc-id[/path...]
    parts = tail.split("/", 2)
    assert len(parts) >= 2 and parts[1], f"no document id in {url!r}"
    return parts[1]


@dataclass
class LocalDocumentService:
    """Bound (service, doc_id) pair exposing the container-facing surface."""

    service: LocalFluidService
    doc_id: str

    def connect(self, mode: str = "write", from_seq: int = 0):
        return self.service.connect(self.doc_id, mode, from_seq)

    def get_deltas(self, from_seq: int = 0, to_seq: Optional[int] = None):
        return self.service.get_deltas(self.doc_id, from_seq, to_seq)

    @property
    def store(self):
        return self.service.store


class LocalDocumentServiceFactory:
    """Creates document services against one in-proc ordering service
    (reference IDocumentServiceFactory.createDocumentService)."""

    def __init__(self, service: Optional[LocalFluidService] = None):
        self.service = service or LocalFluidService()

    def create_document_service(self, url: str) -> LocalDocumentService:
        return LocalDocumentService(self.service, resolve_url(url))
