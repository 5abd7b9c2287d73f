"""Datastore layer — second-level op routing between runtime and channels.

Reference: ``packages/runtime/datastore`` ``FluidDataStoreRuntime``
(``process`` dataStoreRuntime.ts:615, ``processChannelOp`` :1070,
``submitChannelOp`` :987): a container routes an op envelope
``{"address": datastore, "contents": {"address": channel, ...}}`` to the
datastore, which routes the inner envelope to one of its channels. A
datastore presents the same runtime interface channels attach to, so any
DDS works flat on the container (the collapsed layout) or nested
inside a datastore unchanged.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from fluidframework_tpu_torch.protocol.types import SequencedDocumentMessage
from fluidframework_tpu_torch.runtime.shared_object import SharedObject


class FluidDataStore(SharedObject):
    """A group of channels with its own route segment (one data store)."""

    def __init__(self, ds_id: str, channels: tuple = ()):
        super().__init__(ds_id)
        self.channels: Dict[str, SharedObject] = {}
        for ch in channels:
            self.create_channel(ch)

    # -- the runtime interface child channels see -----------------------------

    def attach(self, runtime) -> None:
        """Children attach only once this datastore is itself attached —
        DDS attach needs the live client id (kernel state stamps it)."""
        super().attach(runtime)
        for ch in self.channels.values():
            ch.attach(self)

    def create_channel(self, channel: SharedObject) -> SharedObject:
        assert channel.id not in self.channels, f"duplicate channel {channel.id}"
        self.channels[channel.id] = channel
        if self._runtime is not None:
            channel.attach(self)
        return channel

    def get_channel(self, channel_id: str) -> SharedObject:
        return self.channels[channel_id]

    def submit_channel_op(
        self, channel_id: str, contents: Any, local_metadata: Any = None
    ) -> None:
        """Wrap a child op in this datastore's envelope (submitChannelOp)."""
        self.submit_local_message(
            {"address": channel_id, "contents": contents},
            (channel_id, local_metadata),
        )

    def handle_route(self, channel_id: Optional[str] = None) -> str:
        """Absolute route of this datastore or one of its channels."""
        base = f"/{self.id}"
        return base if channel_id is None else f"{base}/{channel_id}"

    # -- SharedObject contract (the container side) ---------------------------

    def process_core(
        self,
        msg: SequencedDocumentMessage,
        local: bool,
        local_metadata: Optional[Tuple[str, Any]],
    ) -> None:
        address = msg.contents["address"]
        inner = msg.contents["contents"]
        child_meta = None
        if local:
            assert local_metadata is not None and local_metadata[0] == address
            child_meta = local_metadata[1]
        self.channels[address].process_core(
            SequencedDocumentMessage(
                **{**msg.__dict__, "contents": inner}
            ),
            local,
            child_meta,
        )

    def summarize_core(self) -> dict:
        return {
            "channels": {cid: ch.summarize_core() for cid, ch in self.channels.items()}
        }

    def load_core(self, summary: dict) -> None:
        for cid, ch_summary in summary["channels"].items():
            if cid in self.channels:
                self.channels[cid].load_core(ch_summary)

    # GC data (reference ``getGCData``) is derived by the container's
    # ``run_gc`` from this datastore's already-computed summary — per-child
    # nodes with child->parent edges — rather than re-summarizing here.

    # -- lifecycle forwarding --------------------------------------------------

    def resubmit_core(self, contents: Any, local_metadata: Any) -> None:
        address = contents["address"]
        child_meta = local_metadata[1] if local_metadata else None
        self.channels[address].resubmit_core(contents["contents"], child_meta)

    def on_client_leave(self, client_id: int) -> None:
        for ch in self.channels.values():
            ch.on_client_leave(client_id)

    def on_reconnect(self, new_client_id: int) -> None:
        for ch in self.channels.values():
            ch.on_reconnect(new_client_id)

    def adopt_stashed_slot(self, old_client_id: int) -> None:
        for ch in self.channels.values():
            ch.adopt_stashed_slot(old_client_id)

    def begin_resubmit(self) -> None:
        for ch in self.channels.values():
            ch.begin_resubmit()

    def end_resubmit(self) -> None:
        for ch in self.channels.values():
            ch.end_resubmit()
