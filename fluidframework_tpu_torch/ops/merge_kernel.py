"""The merge-sequence op application API, on the hand-written kernels.

Counterpart of ``fluidframework_tpu/ops/merge_kernel.py`` (``apply_op``,
``apply_ops``, ``batched_apply_ops``, their jitted forms, ``compact`` and
``batched_compact``). The reference computes them as an XLA ``lax.scan``
of per-op branches and a vmapped zamboni; here every one of them is one
launch of K1 (``ops/apply_kernel.py`` :func:`apply_ops_packed`, the merge
apply, K ops per document in order) or K2 (``ops/compact_kernel.py``
:func:`compact_packed`, the zamboni compaction) on the state's packed
pair. A CUDA state launches the kernel; a CPU state runs its plain
PyTorch version. No path switches from one to the other.

One semantic difference of the two reference kernels is settled here:
XLA ``apply_op`` clips the op type into the known range (type 7 runs as
ACK_ANNOTATE, -1 as NOOP), while K1 changes only the bookkeeping and
ERR_CLIENT for an unknown type. These functions are the XLA functions'
counterparts, so they clip the type column before the launch; K1 keeps
its own semantics for its other callers.

The ``jit_*`` forms and the compactions update a packed state in place
(the reference donates their state argument) and return views of the same
pair; ``apply_ops`` and ``batched_apply_ops`` leave their input as it was.
A state held as separate tensors is packed first (a copy).
"""

from __future__ import annotations

import numpy as np
import torch

from fluidframework_tpu_torch.ops.apply_kernel import apply_ops_packed
from fluidframework_tpu_torch.ops.compact_kernel import compact_packed
from fluidframework_tpu_torch.ops.segment_state import (
    SegmentState,
    packed_of,
    packed_views,
    to_packed,
)
from fluidframework_tpu_torch.protocol.constants import (
    F_TYPE,
    OP_ACK_ANNOTATE,
    OP_NOOP,
)

_I32 = torch.int32


def _ops_on(ops, device, batched: bool) -> torch.Tensor:
    """Op rows as a contiguous int32 [D, K, OP_WIDTH] tensor on ``device``
    with the type column clipped into [OP_NOOP, OP_ACK_ANNOTATE] (always a
    copy). Host rows reach the card through a pinned buffer with an
    asynchronous copy, so an op costs no host-device synchronization."""
    if isinstance(ops, torch.Tensor):
        t = ops.to(device=device, dtype=_I32, copy=True)
        t[..., F_TYPE].clamp_(OP_NOOP, OP_ACK_ANNOTATE)
    else:
        a = np.array(ops, dtype=np.int32)
        a[..., F_TYPE] = np.clip(a[..., F_TYPE], OP_NOOP, OP_ACK_ANNOTATE)
        t = torch.from_numpy(a)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
    if not batched:
        t = t[None]
    return t.contiguous()


def _apply(state: SegmentState, ops, batched: bool,
           in_place: bool) -> SegmentState:
    pair = packed_of(state)
    t, s, single = to_packed(state, pair)
    o = _ops_on(ops, t.device, batched)
    if in_place:
        apply_ops_packed(t, s, o)
        if pair is not None:
            return state  # its views see the update
    else:
        t, s = apply_ops_packed(t, s, o, out=(torch.empty_like(t),
                                              torch.empty_like(s)))
    return packed_views(t, s, single)


def apply_op(state: SegmentState, op) -> SegmentState:
    """Apply one op row (int32[OP_WIDTH]) to one document."""
    return apply_ops(state, op[None])


def apply_ops(state: SegmentState, ops) -> SegmentState:
    """Apply ops[K, OP_WIDTH] in order (the sequenced stream) to one doc;
    the input state is left as it was."""
    return _apply(state, ops, batched=False, in_place=False)


def batched_apply_ops(state: SegmentState, ops) -> SegmentState:
    """Apply ops[D, K, OP_WIDTH] to a [D, ...] state; the input state is
    left as it was."""
    return _apply(state, ops, batched=True, in_place=False)


def jit_apply_ops(state: SegmentState, ops) -> SegmentState:
    """:func:`apply_ops`, updating a packed state in place."""
    return _apply(state, ops, batched=False, in_place=True)


def jit_batched_apply_ops(state: SegmentState, ops) -> SegmentState:
    """:func:`batched_apply_ops`, updating a packed state in place."""
    return _apply(state, ops, batched=True, in_place=True)


def compact(state: SegmentState) -> SegmentState:
    """Reclaim tombstones below the collab window, squeeze out holes, and
    re-merge adjacent split siblings (the zamboni), in place on a packed
    state. Deterministic given the state, so replicas stay convergent."""
    pair = packed_of(state)
    t, s, single = to_packed(state, pair)
    compact_packed(t, s)
    return state if pair is not None else packed_views(t, s, single)


# compact takes a [D, ...] state as it takes one document.
batched_compact = compact
