"""aqueduct — DataObject base classes + container runtime factories.

Reference: ``packages/framework/aqueduct`` (``src/data-objects``,
``src/container-runtime-factories``): ``PureDataObject`` wraps a datastore
runtime with three lifecycle hooks (``initializingFirstTime`` on create,
``initializingFromExisting`` on load, ``hasInitialized`` always);
``DataObject`` adds a root SharedDirectory for the object's state;
``ContainerRuntimeFactoryWithDefaultDataStore`` is the boilerplate that
registers a default data object at a well-known id.

Counterpart of ``fluidframework_tpu/framework/data_object.py``. The
runtime factory takes ``device=`` (the card by default, raising without
one) and builds every data object whose constructor accepts ``device`` on
it (``fluid_static.make_object``), its default object and the ones other
clients attach alike.
"""

from __future__ import annotations

import functools
from typing import Any, Optional, Type

from fluidframework_tpu_torch.models.shared_directory import SharedDirectory
from fluidframework_tpu_torch.runtime.container import ContainerRuntime
from fluidframework_tpu_torch.framework.fluid_static import make_object
from fluidframework_tpu_torch.runtime.datastore import FluidDataStore
from fluidframework_tpu_torch.service.local_server import LocalFluidService
from fluidframework_tpu_torch.utils import resolve_device


class PureDataObject(FluidDataStore):
    """A datastore with app logic and creation/load lifecycle hooks
    (reference PureDataObject). Subclasses add channels in
    ``initializing_first_time`` and re-find them in
    ``initializing_from_existing`` (channel sets must match — loaders
    rebuild the same tree the creator made)."""

    def __init__(self, ds_id: str):
        super().__init__(ds_id)
        self._initialized = False

    # -- lifecycle hooks (override in subclasses) ------------------------------

    def initializing_first_time(self, props: Optional[Any] = None) -> None:
        """Runs exactly once, on the creating client, before any op flows."""

    def initializing_from_existing(self) -> None:
        """Runs on every loading client (summary/op replay restores state)."""

    def has_initialized(self) -> None:
        """Runs after either path — wire event listeners etc. here."""

    # -- initialization driver (reference initializeInternal) ------------------

    def initialize(self, existing: bool, props: Optional[Any] = None) -> None:
        assert not self._initialized, "double initialize"
        if existing:
            self.initializing_from_existing()
        else:
            self.initializing_first_time(props)
        self.has_initialized()
        self._initialized = True


class DataObject(PureDataObject):
    """PureDataObject with a root SharedDirectory (reference DataObject):
    the conventional place for an object's collaborative state."""

    ROOT_ID = "root"

    def __init__(self, ds_id: str):
        super().__init__(ds_id)
        self.create_channel(SharedDirectory(self.ROOT_ID))

    @property
    def root(self) -> SharedDirectory:
        return self.get_channel(self.ROOT_ID)  # type: ignore[return-value]


class DataObjectFactory:
    """Named factory for one data-object type (reference DataObjectFactory):
    the registry entry a container-runtime factory instantiates from."""

    def __init__(self, object_type: str, ctor: Type[PureDataObject]):
        self.object_type = object_type
        self.ctor = ctor

    def create(self, ds_id: str, device) -> PureDataObject:
        """Construct only — ``initialize`` runs after runtime attach, since
        first-time hooks submit ops and op submission needs a live runtime.
        ``device`` reaches a constructor that accepts it."""
        return make_object(self.ctor, ds_id, device)  # type: ignore[return-value]


class ContainerRuntimeFactoryWithDefaultDataStore:
    """Boilerplate runtime factory (reference
    containerRuntimeFactories): instantiates the default data object at a
    well-known id and hands back the connected runtime + object."""

    DEFAULT_ID = "default"

    def __init__(self, default_factory: DataObjectFactory, registry: tuple = (),
                 device="cuda"):
        self.default_factory = default_factory
        self.registry = {f.object_type: f for f in (default_factory,) + tuple(registry)}
        self.device = resolve_device(device)

    def instantiate(
        self, service: LocalFluidService, doc_id: str, existing: bool, props: Any = None
    ):
        """Build the runtime with the default object registered, catch up to
        head (summary + delta replay restore an existing object's state),
        then run the lifecycle hooks and flush any first-time edits."""
        obj = self.default_factory.create(self.DEFAULT_ID, device=self.device)
        runtime = ContainerRuntime(
            service,
            doc_id,
            channels=(obj,),
            channel_types={
                t: functools.partial(f.create, device=self.device)
                for t, f in self.registry.items()
            },
        )
        obj.initialize(existing, props)
        runtime.flush()
        runtime.process_incoming()
        return runtime, obj

    def create_data_object(
        self, runtime: ContainerRuntime, object_type: str, ds_id: str, props: Any = None
    ) -> PureDataObject:
        """Mint a registered data-object type at runtime, replicated via the
        ATTACH op (the registry's purpose in the reference factories)."""
        obj = self.registry[object_type].create(ds_id, device=self.device)
        runtime.attach_channel(obj, object_type)
        obj.initialize(existing=False, props=props)
        runtime.flush()
        return obj

    def get_data_object(self, runtime: ContainerRuntime, ds_id: str) -> PureDataObject:
        """Realize a data object another client attached: lazily runs the
        from-existing lifecycle on first access (reference lazy realization,
        remoteChannelContext.ts)."""
        obj = runtime.get_channel(ds_id)
        assert isinstance(obj, PureDataObject), f"{ds_id} is not a data object"
        if not obj._initialized:
            obj.initialize(existing=True)
        return obj
