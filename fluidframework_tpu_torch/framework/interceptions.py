"""DDS op interception — wrap a DDS so every outbound op is stamped.

Reference: ``packages/framework/dds-interceptions`` — factory wrappers
(``createSharedMapWithInterception``,
``createSharedStringWithInterception``) that intercept local edits and
stamp extra properties onto the op (the shipped use case is attribution
stamping: each op carries who/when metadata supplied by a callback).

The interception layer rewrites the submitted op contents (adds a
``props`` entry); the DDS merge logic ignores unknown keys, so stamped
props ride the wire for consumers (attribution, audit) without touching
kernel rows.

A copy of ``fluidframework_tpu/framework/interceptions.py``
with the port's imports; host-only.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

from fluidframework_tpu_torch.runtime.shared_object import SharedObject

PropsCallback = Callable[[Dict[str, Any]], Dict[str, Any]]


def intercept_submits(channel: SharedObject, props_callback: PropsCallback) -> SharedObject:
    """Wrap ``channel.submit_local_message`` so every locally-submitted op
    dict gains ``props`` = ``props_callback(contents)``. Returns the same
    channel (the reference returns a wrapping object; rebinding the submit
    path keeps resubmit/rebase flowing through the interception too).

    Re-entrancy guard: if the callback itself triggers a submit on this
    channel, the nested op is NOT re-intercepted (reference guards
    identically in sharedMapWithInterception.ts).
    """
    original = channel.submit_local_message
    state = {"active": False}

    def intercepted(contents: Any, local_metadata: Any = None) -> None:
        if isinstance(contents, dict) and not state["active"]:
            state["active"] = True
            try:
                props = props_callback(contents)
                if props:
                    contents = {**contents, "props": {**contents.get("props", {}), **props}}
            finally:
                state["active"] = False
        original(contents, local_metadata)

    channel.submit_local_message = intercepted  # type: ignore[method-assign]
    return channel


def create_shared_map_with_interception(shared_map, props_callback: PropsCallback):
    """Reference ``createSharedMapWithInterception``."""
    return intercept_submits(shared_map, props_callback)


def create_shared_string_with_interception(shared_string, props_callback: PropsCallback):
    """Reference ``createSharedStringWithInterception`` (attribution
    stamping on insert/annotate ops)."""
    return intercept_submits(shared_string, props_callback)
