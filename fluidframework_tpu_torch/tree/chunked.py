"""Chunked forest — uniform-chunk compression + device materialization.

Reference: ``packages/dds/tree/src/feature-libraries/chunked-forest``
(``uniformChunk.ts``): runs of same-shaped subtrees compress into one chunk
holding the shape once and the values as flat arrays. That is the
struct-of-arrays layout a device wants: a uniform chunk's value columns
materialize directly as device tensors, so analytical passes over large
regular trees (sum a column over 1M rows, filter by a field) run as single
tensor ops instead of per-node host traversal.

Counterpart of ``fluidframework_tpu/tree/chunked.py``. Chunking stays
numpy, as in the reference; :meth:`UniformChunk.to_device` makes a torch
tensor on ``device=`` (the card by default) with the dtype and bytes of
the reference's ``jnp.asarray`` with 64-bit types off: 64-bit columns
narrow to their 32-bit type (values cast as numpy casts them) and a column
that is not numeric raises ``TypeError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from fluidframework_tpu_torch.tree.hierarchy import Forest
from fluidframework_tpu_torch.utils import resolve_device

# The 64-bit -> 32-bit narrowing of JAX's default (x64 off) dtypes.
_NARROW = {
    np.dtype(np.int64): np.dtype(np.int32),
    np.dtype(np.uint64): np.dtype(np.uint32),
    np.dtype(np.float64): np.dtype(np.float32),
    np.dtype(np.complex128): np.dtype(np.complex64),
}


def device_dtype(dtype) -> np.dtype:
    """The dtype a column of ``dtype`` takes on the device; raises
    ``TypeError`` for a column that is not numeric (strings, objects)."""
    dtype = np.dtype(dtype)
    if dtype.kind not in "biufc":
        raise TypeError(f"Dtype {dtype} is not a valid device column type. "
                        "Only arrays of numeric types are supported.")
    return _NARROW.get(dtype, dtype)


@dataclass(frozen=True)
class TreeShape:
    """The shape of one subtree: its type and, per field, the full tuple of
    child shapes. Two subtrees compare shape-equal iff every field has the
    same child count AND every child's shape matches positionally — the
    invariant that makes column packing alignment-safe."""

    node_type: str
    has_value: bool
    fields: Tuple[Tuple[str, Tuple["TreeShape", ...]], ...]


def shape_of(forest: Forest, node_id: int) -> TreeShape:
    n = forest.node(node_id)
    fields = []
    for fname in sorted(n.fields):
        kids = forest.children(node_id, fname)
        if not kids:
            continue
        fields.append(
            (fname, tuple(shape_of(forest, k) for k in kids))
        )
    return TreeShape(
        node_type=n.type,
        has_value=forest.node(node_id).value is not None,
        fields=tuple(fields),
    )


@dataclass
class UniformChunk:
    """count subtrees of identical shape; values stored column-major as
    flat arrays keyed by value path (e.g. "point/x")."""

    shape: TreeShape
    count: int
    node_ids: List[int]
    columns: Dict[str, np.ndarray]

    def column(self, path: str) -> np.ndarray:
        return self.columns[path]

    def to_device(self, path: str, device="cuda") -> torch.Tensor:
        """Materialize one value column as a tensor on ``device`` (a copy;
        never a view of the host column)."""
        dev = resolve_device(device)
        col = self.columns[path]
        host = np.array(col, dtype=device_dtype(col.dtype), copy=True)
        return torch.from_numpy(host).to(dev)


def _collect_values(forest: Forest, node_id: int, prefix: str,
                    out: Dict[str, list]) -> None:
    n = forest.node(node_id)
    if n.value is not None:
        out.setdefault(prefix or "value", []).append(n.value)
    for fname in sorted(n.fields):
        for i, kid in enumerate(forest.children(node_id, fname)):
            _collect_values(
                forest, kid, f"{prefix}/{fname}[{i}]" if prefix else f"{fname}[{i}]",
                out,
            )


def chunk_field(forest: Forest, parent_id: int, field_name: str,
                min_run: int = 2) -> List[object]:
    """Compress a field's children into uniform chunks where runs of
    identical shape are at least ``min_run`` long; other children pass
    through as raw node ids. Returns a list of UniformChunk | int."""
    kids = forest.children(parent_id, field_name)
    shapes = [shape_of(forest, k) for k in kids]
    out: List[object] = []
    i = 0
    while i < len(kids):
        j = i + 1
        while j < len(kids) and shapes[j] == shapes[i]:
            j += 1
        if j - i >= min_run:
            cols: Dict[str, list] = {}
            for k in kids[i:j]:
                per: Dict[str, list] = {}
                _collect_values(forest, k, "", per)
                for path, vals in per.items():
                    cols.setdefault(path, []).extend(vals)
            out.append(
                UniformChunk(
                    shape=shapes[i],
                    count=j - i,
                    node_ids=list(kids[i:j]),
                    columns={
                        p: np.asarray(v) for p, v in cols.items()
                    },
                )
            )
        else:
            out.extend(kids[i:j])
        i = j
    return out


def field_as_arrays(forest: Forest, parent_id: int,
                    field_name: str) -> Optional[Dict[str, np.ndarray]]:
    """The whole field as struct-of-arrays when fully uniform, else None —
    the fast path for device-side analytics over regular collections."""
    chunks = chunk_field(forest, parent_id, field_name, min_run=1)
    if len(chunks) != 1 or not isinstance(chunks[0], UniformChunk):
        return None
    return chunks[0].columns
