"""SharedObject base — the DDS contract.

Reference: ``packages/dds/shared-object-base/src/sharedObject.ts`` (abstract
hooks ``processCore``/``summarizeCore``/``loadCore``/``reSubmitCore`` at
:308,332,341,534,722). A channel submits local messages through its runtime
and processes the sequenced stream; subclasses implement the merge logic
(for sequence-like DDSes, by lowering ops to kernel rows).
"""

from __future__ import annotations

import abc
from typing import Any, Optional

from fluidframework_tpu_torch.protocol.types import SequencedDocumentMessage
from fluidframework_tpu_torch.utils.events import TypedEventEmitter


class SharedObject(TypedEventEmitter, abc.ABC):
    """Base class for all distributed data structures. Also an event
    emitter (reference SharedObjectCore extends TypedEventEmitter): DDSes
    emit change events for views, undo-redo, and interception layers."""

    def __init__(self, channel_id: str):
        super().__init__()
        self.id = channel_id
        self._runtime = None  # set on attach

    # -- wiring ---------------------------------------------------------------

    def attach(self, runtime) -> None:
        self._runtime = runtime

    @property
    def client_id(self) -> int:
        assert self._runtime is not None, "channel not attached"
        return self._runtime.client_id

    @property
    def conn_no(self) -> int:
        """Never-recycled per-document connection ordinal — the scope for
        content ids (payload origs, tree cell ids). Client slots recycle, so
        slot-scoped ids would collide with a previous holder's live content."""
        assert self._runtime is not None, "channel not attached"
        return self._runtime.conn_no

    def submit_local_message(self, contents: Any, local_metadata: Any = None) -> None:
        """Queue an op for sequencing (recorded in pending state for ack
        matching — reference SharedObjectCore.submitLocalMessage)."""
        assert self._runtime is not None, "channel not attached"
        self._runtime.submit_channel_op(self.id, contents, local_metadata)

    # -- the contract ---------------------------------------------------------

    @abc.abstractmethod
    def process_core(
        self,
        msg: SequencedDocumentMessage,
        local: bool,
        local_metadata: Optional[Any],
    ) -> None:
        """Apply one sequenced channel op. ``local`` means this is the ack of
        our own op; ``local_metadata`` is what we recorded at submit time."""

    @abc.abstractmethod
    def summarize_core(self) -> dict:
        """Produce this channel's summary blob(s)."""

    @abc.abstractmethod
    def load_core(self, summary: dict) -> None:
        """Initialize state from a summary produced by summarize_core."""

    def resubmit_core(self, contents: Any, local_metadata: Any) -> None:
        """Regenerate a pending op after reconnect (reference reSubmitCore).
        Default: resubmit as-is; sequence DDSes override to rebase."""
        self.submit_local_message(contents, local_metadata)

    def on_client_leave(self, client_id: int) -> None:
        """Quorum-departure hook (task reassignment, pact consent, ...)."""

    def on_reconnect(self, new_client_id: int) -> None:
        """Connection-change hook: kernel-backed DDSes update their local
        client slot so new local ops stamp correctly."""

    def adopt_stashed_slot(self, old_client_id: int) -> None:
        """Stashed-state rehydration: pending rows in a loaded snapshot
        carry the CLOSED session's client slot, but load_core stamped the
        state with the new one — record the old slot as current so the
        subsequent on_reconnect restamp moves the right removers bits."""

    def begin_resubmit(self) -> None:
        """Marks the start of a resubmit batch: rebase computations must all
        read the state as of reconnect, not interleaved restamps."""

    def end_resubmit(self) -> None:
        """Marks the end of a resubmit batch."""
