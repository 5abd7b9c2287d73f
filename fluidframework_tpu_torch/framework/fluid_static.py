"""fluid-static — declarative containers: ContainerSchema + FluidContainer.

Reference: ``packages/framework/fluid-static`` (``FluidContainer``
fluidContainer.ts:201, ``ContainerSchema`` types.ts:66, ``RootDataObject``
rootDataObject.ts:41,149): a schema names the initial objects a container is
born with plus the dynamic types it may create later; the client facade
turns that into a root data object whose channels are the initial objects,
and ``FluidContainer.create`` makes detached dynamic objects that only
survive while some reachable DDS stores their handle (GC, D.3).

Counterpart of ``fluidframework_tpu/framework/fluid_static.py``. The one
difference is where device state lives: :class:`FluidContainer`,
:func:`build_root_datastore` and :func:`schema_type_registry` take
``device=`` (the card by default; without one they raise, see
``utils.resolve_device``) and hand it to every object type whose
constructor accepts ``device`` (the merge-tree DDSes), and only to those
(:func:`make_object`). A loader's registry builds remotely created
channels on its own device, so every replica of a client holds its
channels on one device.
"""

from __future__ import annotations

import functools
import inspect
from dataclasses import dataclass
from typing import Callable, Dict, Tuple, Type, Union

from fluidframework_tpu_torch.runtime.container import ContainerRuntime
from fluidframework_tpu_torch.runtime.datastore import FluidDataStore
from fluidframework_tpu_torch.runtime.shared_object import SharedObject
from fluidframework_tpu_torch.utils import resolve_device

# A loadable object type: any SharedObject subclass whose constructor takes
# the channel id first (every DDS in models/ does).
LoadableType = Type[SharedObject]

ROOT_DO_ID = "rootDOId"  # reference rootDataObject.ts root datastore alias


def takes_device(object_type) -> bool:
    """Whether ``object_type``'s constructor accepts ``device=``."""
    try:
        return "device" in inspect.signature(object_type).parameters
    except (TypeError, ValueError):
        return False


def make_object(object_type, channel_id: str, device) -> SharedObject:
    """``object_type(channel_id)``, with ``device=device`` where its
    constructor accepts one."""
    if takes_device(object_type):
        return object_type(channel_id, device=device)
    return object_type(channel_id)


@dataclass(frozen=True)
class ContainerSchema:
    """Declarative shape of a container (reference types.ts:66).

    ``initial_objects`` maps app-visible names to DDS types, created exactly
    once at container creation and loadable forever after;
    ``dynamic_object_types`` is the registry of types ``create`` may mint.
    """

    initial_objects: Dict[str, LoadableType]
    dynamic_object_types: Tuple[LoadableType, ...] = ()


class FluidContainer:
    """App-facing container (reference fluidContainer.ts:201): hides the
    runtime/datastore plumbing behind ``initial_objects`` + ``create``."""

    def __init__(self, runtime: ContainerRuntime, schema: ContainerSchema,
                 device="cuda"):
        self._runtime = runtime
        self._schema = schema
        self._device = resolve_device(device)
        self._root: FluidDataStore = runtime.channels[ROOT_DO_ID]  # type: ignore[assignment]
        self._dynamic_seq = 0

    # -- the schema surface ----------------------------------------------------

    @property
    def initial_objects(self) -> Dict[str, SharedObject]:
        return {
            name: self._root.get_channel(name)
            for name in self._schema.initial_objects
        }

    def create(self, object_type: LoadableType) -> SharedObject:
        """Create a dynamic object (fluidContainer.ts ``create``): it is NOT
        rooted — the app must store its handle in a reachable DDS before the
        next summary or GC sweeps it."""
        assert object_type in self._schema.dynamic_object_types, (
            f"{object_type.__name__} not in schema.dynamic_object_types"
        )
        self._dynamic_seq += 1
        cid = f"dyn-{self._runtime.client_id}-{self._dynamic_seq}"
        obj = make_object(object_type, cid, self._device)
        # Replicated via an ATTACH op: every other client constructs it from
        # the schema-derived type registry, so its ops and handles resolve
        # everywhere, not just on the creating client.
        self._runtime.attach_channel(obj, object_type.__name__)
        return obj

    def handle_of(self, obj: SharedObject) -> dict:
        """Encoded handle for a created object (what you store in a DDS)."""
        if obj.id in self._root.channels:
            return self._runtime.handle_for(ROOT_DO_ID, obj.id)
        return self._runtime.handle_for(obj.id)

    def resolve_handle(self, handle: dict) -> SharedObject:
        """Handle -> live object (reference IFluidHandle.get)."""
        route = handle["url"] if isinstance(handle, dict) else handle
        parts = route.lstrip("/").split("/")
        channel = self._runtime.get_channel(parts[0])
        for sub in parts[1:]:
            channel = channel.get_channel(sub)  # type: ignore[attr-defined]
        return channel

    # -- lifecycle / state -----------------------------------------------------

    @property
    def connected(self) -> bool:
        return self._runtime.connected

    @property
    def runtime(self) -> ContainerRuntime:
        return self._runtime

    @property
    def device(self):
        """The device the container's channels hold their state on."""
        return self._device

    @property
    def audience(self) -> Dict[int, dict]:
        """Connected clients (reference IAudience off the quorum)."""
        return dict(self._runtime.quorum_members)

    def disconnect(self) -> None:
        self._runtime.disconnect()

    def connect(self) -> None:
        self._runtime.reconnect()

    def dispose(self) -> None:
        if self._runtime.connected:
            self._runtime.disconnect()


def schema_type_registry(
    schema: ContainerSchema, device="cuda"
) -> Dict[str, Union[LoadableType, Callable[[str], SharedObject]]]:
    """Type-name registry for the runtime's dynamic-channel machinery: the
    type itself, or for a type that takes ``device`` a constructor that
    builds it on ``device``."""
    dev = resolve_device(device)
    return {
        t.__name__: (functools.partial(t, device=dev) if takes_device(t)
                     else t)
        for t in schema.dynamic_object_types
    }


def build_root_datastore(schema: ContainerSchema,
                         device="cuda") -> FluidDataStore:
    """Root data object holding the schema's initial objects (reference
    RootDataObject.initializingFirstTime rootDataObject.ts:149). Channel
    construction is deterministic from the schema, so creating and loading
    clients build identical channel trees before any op/summary applies."""
    dev = resolve_device(device)
    channels = tuple(
        make_object(obj_type, name, dev)
        for name, obj_type in sorted(schema.initial_objects.items())
    )
    return FluidDataStore(ROOT_DO_ID, channels)
