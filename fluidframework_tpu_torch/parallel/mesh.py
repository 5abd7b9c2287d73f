"""Document sharding across a device mesh.

Counterpart of ``fluidframework_tpu/parallel/mesh.py``. The reference's
mesh is a ``jax.sharding.Mesh`` with a ``docs`` axis, held by one
controller process: the ``[D, ...]`` packed state and the ``[D, K, W]`` op
batches split over it, ``shard_map`` runs the apply kernel on each
device's slice, and only the telemetry reduction crosses shards (psum,
pmax, pmin).

The port keeps that single-controller shape. Its :class:`Mesh` is an
explicit, ordered list of ``torch.device``s with an axis name, held by one
process: a shard's tensors live on its device, each shard's kernel launch
goes out on that device's current stream without a host sync, and the few
cross-shard scalars come together on the first device by stream-ordered
copies. A list may name one device more than once (eight ``cpu`` entries
in the tests, the counterpart of the reference's eight virtual CPU
devices; eight ``cuda:0`` entries run the eight-shard code on one card);
the code is the same whatever device each entry names.

:func:`devices` is the counterpart of ``jax.devices()``: every visible
CUDA device unless :func:`set_devices` named a list; with no card and no
list it raises rather than falling back to the CPU.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fluidframework_tpu_torch.ops import apply_kernel as K1
from fluidframework_tpu_torch.ops import compact_kernel as K2
from fluidframework_tpu_torch.ops.apply_kernel import (
    SC_COUNT,
    SC_CUR_SEQ,
    SC_ERR,
    SC_MIN_SEQ,
    SC_SELF,
    unpack_state,
)
from fluidframework_tpu_torch.ops.merge_kernel import (  # noqa: F401
    batched_apply_ops,
    batched_compact,
)
from fluidframework_tpu_torch.ops.segment_state import (  # noqa: F401
    SEGMENT_LANES,
    SegmentState,
    make_batched_state,
)
from fluidframework_tpu_torch.protocol.constants import NO_CLIENT  # noqa: F401
from fluidframework_tpu_torch.utils import pow2_at_least, resolve_device

_I32 = torch.int32
KERNELS = ("auto", "cuda", "plain")

# -- the device list ------------------------------------------------------------

_DEVICES: Optional[Tuple[torch.device, ...]] = None


def norm_device(device) -> torch.device:
    """A device with its index made explicit (``"cuda"`` -> the current
    card), so equal entries compare equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def set_devices(devs: Optional[Sequence]) -> None:
    """Name the device list :func:`devices` returns (repeats allowed);
    ``None`` restores the default, every visible CUDA device."""
    global _DEVICES
    _DEVICES = None if devs is None else tuple(norm_device(d) for d in devs)
    if _DEVICES is not None and not _DEVICES:
        raise ValueError("the device list must name at least one device")


def devices() -> List[torch.device]:
    """The port's counterpart of ``jax.devices()``: the list named by
    :func:`set_devices`, else every visible CUDA device."""
    if _DEVICES is not None:
        return list(_DEVICES)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "no CUDA device is visible and no device list was set; call "
            "parallel.mesh.set_devices([...]) to run the mesh on the CPU"
        )
    return [torch.device("cuda", i) for i in range(n)]


class Mesh:
    """An ordered list of devices with one axis name (the counterpart of a
    one-axis ``jax.sharding.Mesh``). Shard ``i`` lives on ``devices[i]``;
    the first device gathers the cross-shard scalars."""

    def __init__(self, devs: Sequence, axis: str = "docs"):
        self.devices: Tuple[torch.device, ...] = tuple(norm_device(d) for d in devs)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis = axis

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        return self.devices[0]

    def groups(self) -> List[Tuple[torch.device, List[int]]]:
        """The shards by device, in order of first appearance:
        ``[(device, [shard index, ...]), ...]``."""
        out: Dict[torch.device, List[int]] = {}
        for i, d in enumerate(self.devices):
            out.setdefault(d, []).append(i)
        return list(out.items())

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh) and self.devices == other.devices
                and self.axis == other.axis)

    def __hash__(self) -> int:
        return hash((self.devices, self.axis))

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, axis={self.axis!r})"


def make_mesh(n_devices: Optional[int] = None, axis: str = "docs") -> Mesh:
    devs = devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(devs, axis)


def resolve_kernel(kernel: str, devs) -> str:
    """Check a ``kernel=`` choice against the devices it runs on:
    ``"cuda"`` needs every device to be a card."""
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}; got {kernel!r}")
    if kernel == "cuda" and any(d.type != "cuda" for d in devs):
        raise ValueError("kernel='cuda' needs CUDA devices; use "
                         "kernel='auto' or 'plain' on the CPU")
    return kernel


# -- per-shard packed state -------------------------------------------------------


def shard_state(tables, scalars, mesh: Mesh) -> List[List[torch.Tensor]]:
    """Split a packed ``[N_LANES, D, S]`` / ``[D, N_SCALARS]`` state into
    contiguous per-shard slices, each copied to its shard's device:
    ``[[tables_i, scalars_i], ...]``."""
    n = mesh.size
    d = tables.shape[1]
    if d % n:
        raise ValueError(f"{d} documents do not split evenly over {n} shards")
    per = d // n
    return [
        [tables[:, i * per:(i + 1) * per].to(dev, copy=True).contiguous(),
         scalars[i * per:(i + 1) * per].to(dev, copy=True).contiguous()]
        for i, dev in enumerate(mesh.devices)
    ]


def shard_ops(ops, mesh: Mesh) -> List[torch.Tensor]:
    """Split a ``[D, K, OP_WIDTH]`` op batch (numpy or a tensor) into
    contiguous per-shard slices on the shards' devices (one upload to the
    first device; slices for a shard on that device are views)."""
    if isinstance(ops, np.ndarray):
        ops = torch.from_numpy(np.ascontiguousarray(ops, np.int32))
    ops = ops.to(mesh.first, dtype=_I32)
    n = mesh.size
    if ops.shape[0] % n:
        raise ValueError(f"{ops.shape[0]} documents do not split evenly "
                         f"over {n} shards")
    per = ops.shape[0] // n
    return [ops[i * per:(i + 1) * per].to(dev)
            for i, dev in enumerate(mesh.devices)]


def gather_parts(parts, first: torch.device):
    """One packed pair on ``first`` from per-shard pairs (shard-major):
    the global arrays of the reference's sharded state."""
    return (torch.cat([t.to(first) for t, _ in parts], dim=1),
            torch.cat([s.to(first) for _, s in parts], dim=0))


def gather_slots(parts, slots, first: torch.device):
    """The lanes ``[N_LANES, n, S]`` and scalars ``[n, N_SCALARS]`` of
    global slots ``slots`` (host ints) of per-shard pairs holding equal
    contiguous slot ranges, assembled in ``slots`` order on ``first``: one
    device-side selection per shard that holds any of them."""
    slots = np.asarray(slots, np.int64)
    per = parts[0][1].shape[0]
    if len(parts) == 1:
        t, s = parts[0]
        idx = torch.from_numpy(slots).to(t.device)
        return t.index_select(1, idx).to(first), s.index_select(0, idx).to(first)
    t0, s0 = parts[0]
    lanes = torch.empty((t0.shape[0], len(slots), t0.shape[2]), dtype=_I32,
                        device=first)
    scal = torch.empty((len(slots), s0.shape[1]), dtype=_I32, device=first)
    owner = slots // per
    for i in np.unique(owner):
        t, s = parts[int(i)]
        sel = np.flatnonzero(owner == i)
        local = torch.from_numpy(slots[sel] - int(i) * per).to(t.device)
        at = torch.from_numpy(sel).to(first)
        lanes.index_copy_(1, at, t.index_select(1, local).to(first))
        scal.index_copy_(0, at, s.index_select(0, local).to(first))
    return lanes, scal


def put_slots(parts, slots, lanes, scal) -> None:
    """Write ``lanes [N_LANES, n, S]`` / ``scal [n, N_SCALARS]`` into global
    slots ``slots`` of per-shard pairs (the inverse of
    :func:`gather_slots`)."""
    slots = np.asarray(slots, np.int64)
    per = parts[0][1].shape[0]
    owner = slots // per
    for i in np.unique(owner):
        t, s = parts[int(i)]
        sel = np.flatnonzero(owner == i)
        local = torch.from_numpy(slots[sel] - int(i) * per).to(t.device)
        pick = torch.from_numpy(sel).to(lanes.device)
        t.index_copy_(1, local, lanes.index_select(1, pick).to(t.device))
        s.index_copy_(0, local, scal.index_select(0, pick).to(s.device))


def apply_part(part, ops, kernel: str) -> None:
    """K1 on one shard's packed pair, in place (``"plain"`` runs its plain
    version on any device)."""
    tables, scalars = part
    if kernel == "plain":
        nt, ns = K1.apply_plain(tables, scalars, ops)
        tables.copy_(nt)
        scalars.copy_(ns)
    else:
        K1.apply_ops_packed(tables, scalars, ops)


def compact_part(part, kernel: str) -> None:
    """K2 on one shard's packed pair, in place."""
    tables, scalars = part
    if kernel == "plain":
        nt, ns = K2.compact_plain(tables, scalars)
        tables.copy_(nt)
        scalars.copy_(ns)
    else:
        K2.compact_packed(tables, scalars)


def apply_and_stats(parts, ops_parts, kernel: str = "auto") -> dict:
    """One sharded service step: K1 on each shard's slice with its op
    slice, then the fleet-wide reduction (rows in use, docs with errors,
    max seq, min window) gathered on the first shard's device — the only
    cross-shard communication, as the reference's psum/pmax/pmin. Returns
    0-d int32 tensors; nothing waits on the host."""
    first = parts[0][0].device
    per_shard = []
    for part, ops in zip(parts, ops_parts):
        apply_part(part, ops, kernel)
        sc = part[1]
        per_shard.append(torch.stack([
            sc[:, SC_COUNT].sum().to(_I32),
            (sc[:, SC_ERR] != 0).sum().to(_I32),
            sc[:, SC_CUR_SEQ].amax(),
            sc[:, SC_MIN_SEQ].amin(),
        ]).to(first))
    s = torch.stack(per_shard)
    return {
        "rows_in_use": s[:, 0].sum().to(_I32),
        "docs_with_errors": s[:, 1].sum().to(_I32),
        "max_seq": s[:, 2].amax(),
        "min_window": s[:, 3].amin(),
    }


def unpack_packed_doc_states(
    host: np.ndarray, docs, s: int, pad: int = 0
) -> dict:
    """Split one packed-layout multi-doc readback — ``[L, pad, S]`` lane
    planes followed by ``[pad, N_SCALARS]`` scalar rows, flattened into one
    vector — into per-doc SegmentStates of numpy arrays (``pad`` rows
    beyond ``len(docs)`` are gather padding, discarded). Shared by
    :meth:`DocShard.doc_states` and ``TpuFleetService.doc_states``."""
    pad = pad or len(docs)
    nl = len(SEGMENT_LANES)
    lanes = host[: nl * pad * s].reshape(nl, pad, s)
    scal = host[nl * pad * s:].reshape(pad, -1)
    return {
        d: SegmentState(
            **{k: lanes[i, j] for i, k in enumerate(SEGMENT_LANES)},
            count=scal[j, SC_COUNT],
            min_seq=scal[j, SC_MIN_SEQ],
            cur_seq=scal[j, SC_CUR_SEQ],
            self_client=scal[j, SC_SELF],
            err=scal[j, SC_ERR],
        )
        for j, d in enumerate(docs)
    }


class DocShard:
    """A mesh-resident fleet of documents: ``n_docs`` split into equal
    contiguous slices, one packed pair per shard on its device, K1 and K2
    launched once per shard (the reference's ``shard_map`` of the Pallas
    kernels; its ``backend="xla"`` computes the same states).

    ``kernel``: ``"auto"`` launches the CUDA kernels on a card and runs the
    plain versions on the CPU; ``"cuda"`` insists on the kernels;
    ``"plain"`` runs the plain versions on any device."""

    def __init__(
        self,
        n_docs: int,
        capacity: int,
        mesh: Optional[Mesh] = None,
        axis: str = "docs",
        kernel: str = "auto",
    ):
        from fluidframework_tpu_torch.parallel.fleet import _blank_packed

        self.mesh = mesh or make_mesh(axis=axis)
        self.axis = self.mesh.axis
        self.kernel = resolve_kernel(kernel, self.mesh.devices)
        n_dev = self.mesh.size
        if n_docs % n_dev:
            raise ValueError(
                f"n_docs={n_docs} must divide evenly over {n_dev} devices"
            )
        self.n_docs = n_docs
        self.capacity = capacity
        self._docs_per_dev = n_docs // n_dev
        self.parts = [list(_blank_packed(self._docs_per_dev, capacity, dev))
                      for dev in self.mesh.devices]

    @property
    def packed(self):
        """The whole fleet's packed pair on the first device (a copy)."""
        return gather_parts(self.parts, self.mesh.first)

    def unpacked_state(self) -> SegmentState:
        """The whole fleet as a SegmentState on the first device (a
        copy)."""
        return unpack_state(*self.packed)

    def apply(self, ops) -> dict:
        """ops: ``[D, K, OP_WIDTH]`` int32 sequenced rows (NOOP-padded).
        Returns the step's stats as 0-d tensors on the first device."""
        return apply_and_stats(self.parts, shard_ops(ops, self.mesh),
                               self.kernel)

    def compact(self) -> None:
        for part in self.parts:
            compact_part(part, self.kernel)

    def doc_states(self, docs) -> dict:
        """N documents' full states in one gather on the first device and
        one readback; returns doc id -> :class:`SegmentState` (numpy),
        bit-identical to a per-doc slice. The index pads to a pow2 bucket
        (padding re-gathers doc 0, discarded)."""
        from fluidframework_tpu_torch.parallel.fleet import _host

        docs = [int(d) for d in docs]
        if not docs:
            return {}
        pad = pow2_at_least(len(docs))
        idx = np.zeros(pad, np.int64)
        idx[: len(docs)] = docs
        lanes, scal = gather_slots(self.parts, idx, self.mesh.first)
        host = _host(torch.cat([lanes.reshape(-1), scal.reshape(-1)]))
        return unpack_packed_doc_states(host, docs, self.capacity, pad=pad)

    def telemetry_slice(self) -> np.ndarray:
        """``[n_shards, len(fleet.TELEMETRY_COLS)]`` per-shard health in one
        readback, reduced straight off the packed scalar columns (every
        doc slot is live)."""
        from fluidframework_tpu_torch.parallel.fleet import (
            _host,
            _scalars_telemetry,
        )

        scalars = torch.cat([s.to(self.mesh.first) for _, s in self.parts])
        return _host(_scalars_telemetry(scalars, self.mesh.size))

