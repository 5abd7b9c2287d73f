"""SharedDirectory — hierarchical key/value DDS.

Reference: ``packages/dds/map`` ``SharedDirectory`` (``directory.ts``, 2,108
LoC): a tree of subdirectories, each with its own LWW key store; ops carry
the absolute subdirectory path. Merge semantics per subdirectory mirror
SharedMap (optimistic local-wins per key until ack, mapKernel.ts), with
subdirectory create/delete as structural ops — a delete drops the whole
subtree; keys set concurrently under a deleted subtree are lost (the
reference resolves the same way: the delete is a tombstone for the path).
Host-side state: directory merge is O(1) bookkeeping per op.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

from fluidframework_tpu_torch.protocol.types import SequencedDocumentMessage
from fluidframework_tpu_torch.runtime.shared_object import SharedObject


def _norm(path: str) -> str:
    parts = [p for p in path.split("/") if p]
    return "/" + "/".join(parts)


class SubDirectory:
    """View over one node of the directory tree (IDirectory)."""

    def __init__(self, owner: "SharedDirectory", path: str):
        self._owner = owner
        self.path = _norm(path)

    # -- keys -----------------------------------------------------------------

    def get(self, key: str, default: Any = None) -> Any:
        return self._owner._node(self.path).get("keys", {}).get(key, default)

    def has(self, key: str) -> bool:
        return key in self._owner._node(self.path).get("keys", {})

    def keys(self):
        return self._owner._node(self.path).get("keys", {}).keys()

    def items(self):
        return self._owner._node(self.path).get("keys", {}).items()

    def set(self, key: str, value: Any) -> "SubDirectory":
        self._owner._set(self.path, key, value)
        return self

    def delete(self, key: str) -> None:
        self._owner._delete(self.path, key)

    def clear(self) -> None:
        self._owner._clear(self.path)

    # -- subdirectories -------------------------------------------------------

    def create_subdirectory(self, name: str) -> "SubDirectory":
        return self._owner._create_subdir(self.path, name)

    def get_subdirectory(self, name: str) -> Optional["SubDirectory"]:
        sub = _norm(f"{self.path}/{name}")
        return SubDirectory(self._owner, sub) if self._owner._has_node(sub) else None

    def delete_subdirectory(self, name: str) -> None:
        self._owner._delete_subdir(self.path, name)

    def subdirectories(self) -> Iterator[Tuple[str, "SubDirectory"]]:
        prefix = self.path if self.path != "/" else ""
        for p in sorted(self._owner._nodes):
            parent, _, name = p.rpartition("/")
            if p != "/" and (parent or "/") == (prefix or "/") and p != self.path:
                yield name, SubDirectory(self._owner, p)


class SharedDirectory(SharedObject):
    """The root directory channel."""

    def __init__(self, channel_id: str):
        super().__init__(channel_id)
        # absolute path -> {"keys": {k: v}}; root always exists.
        self._nodes: Dict[str, dict] = {"/": {"keys": {}}}
        # (path, key) -> unacked local op count; (path, None) covers
        # structural ops on the path (create/delete subdir, clear).
        self._pending: Dict[Tuple[str, Optional[str]], int] = {}

    # -- public API (root is itself an IDirectory) ----------------------------

    @property
    def root(self) -> SubDirectory:
        return SubDirectory(self, "/")

    def get(self, key: str, default: Any = None) -> Any:
        return self.root.get(key, default)

    def set(self, key: str, value: Any) -> SubDirectory:
        return self.root.set(key, value)

    def delete(self, key: str) -> None:
        self.root.delete(key)

    def has(self, key: str) -> bool:
        return self.root.has(key)

    def keys(self):
        return self.root.keys()

    def create_subdirectory(self, name: str) -> SubDirectory:
        return self.root.create_subdirectory(name)

    def get_subdirectory(self, name: str) -> Optional[SubDirectory]:
        return self.root.get_subdirectory(name)

    # -- internals ------------------------------------------------------------

    def _node(self, path: str) -> dict:
        return self._nodes.get(path, {})

    def _has_node(self, path: str) -> bool:
        return path in self._nodes

    def _bump(self, path: str, key: Optional[str]) -> None:
        self._pending[(path, key)] = self._pending.get((path, key), 0) + 1

    def _set(self, path: str, key: str, value: Any) -> None:
        assert path in self._nodes, f"no such subdirectory {path}"
        self._nodes[path]["keys"][key] = value
        self._bump(path, key)
        self.submit_local_message({"k": "set", "p": path, "key": key, "val": value})

    def _delete(self, path: str, key: str) -> None:
        self._nodes.get(path, {"keys": {}})["keys"].pop(key, None)
        self._bump(path, key)
        self.submit_local_message({"k": "del", "p": path, "key": key})

    def _clear(self, path: str) -> None:
        self._nodes[path]["keys"].clear()
        self._bump(path, "\0clear")
        self.submit_local_message({"k": "clear", "p": path})

    def _create_subdir(self, path: str, name: str) -> SubDirectory:
        sub = _norm(f"{path}/{name}")
        if sub not in self._nodes:
            self._nodes[sub] = {"keys": {}}
            self._bump(sub, None)
            self.submit_local_message({"k": "mkdir", "p": sub})
        return SubDirectory(self, sub)

    def _delete_subdir(self, path: str, name: str) -> None:
        sub = _norm(f"{path}/{name}")
        self._drop_subtree(sub)
        self._bump(sub, None)
        self.submit_local_message({"k": "rmdir", "p": sub})

    def _drop_subtree(self, sub: str) -> None:
        for p in [p for p in self._nodes if p == sub or p.startswith(sub + "/")]:
            del self._nodes[p]

    # -- sequenced stream -----------------------------------------------------

    def process_core(
        self,
        msg: SequencedDocumentMessage,
        local: bool,
        local_metadata: Optional[Any],
    ) -> None:
        c = msg.contents
        path = c["p"]
        pend_key: Tuple[str, Optional[str]] = (
            path,
            "\0clear" if c["k"] == "clear" else c.get("key"),
        )
        if local:
            left = self._pending.get(pend_key, 0) - 1
            if left <= 0:
                self._pending.pop(pend_key, None)
            else:
                self._pending[pend_key] = left
            return
        kind = c["k"]
        if kind == "mkdir":
            # Concurrent mkdir of the same path merges (idempotent).
            self._nodes.setdefault(path, {"keys": {}})
            return
        if kind == "rmdir":
            # Remote delete wins over everything below it except a pending
            # local re-create of the exact path.
            if self._pending.get((path, None), 0) == 0:
                self._drop_subtree(path)
            return
        if path not in self._nodes:
            return  # op under a concurrently-deleted subtree: dropped
        if kind == "clear":
            keys = self._nodes[path]["keys"]
            self._nodes[path]["keys"] = {
                k: v
                for k, v in keys.items()
                if self._pending.get((path, k), 0) > 0
            }
            return
        key = c["key"]
        if self._pending.get((path, "\0clear"), 0) > 0:
            # A local clear is in flight and sequences after this op: it
            # will wipe the key; applying here would diverge (see
            # SharedMap's pending-clear shadowing).
            return
        if self._pending.get((path, key), 0) > 0:
            return  # optimistic local-wins per (path, key)
        if kind == "set":
            self._nodes[path]["keys"][key] = c["val"]
        elif kind == "del":
            self._nodes[path]["keys"].pop(key, None)

    # -- summary / load -------------------------------------------------------

    def summarize_core(self) -> dict:
        return {
            "nodes": {p: {"keys": dict(n["keys"])} for p, n in self._nodes.items()}
        }

    def load_core(self, summary: dict) -> None:
        self._nodes = {
            p: {"keys": dict(n["keys"])} for p, n in summary["nodes"].items()
        }
