"""One document sharded across the device mesh — intra-document scale-out.

Counterpart of ``fluidframework_tpu/parallel/sharded_doc.py``. The segment
table splits into contiguous shards over a mesh (axis ``seg``); each shard
holds a single-document table whose rows are a contiguous run of the
global document. Per sequenced op:

- every shard evaluates the visibility perspective locally (row stamps are
  shard-local state) and reports three numbers: its visible length, whether
  it holds rows, and whether an insert at its own end may land in it (a
  zero-length row there that the insert's tie-break would go before);
- the ``[n_shards, 3]`` reports come together on the mesh's first device,
  which resolves the exclusive offsets, the insert's owner (the first
  shard whose placement predicate fires, else the last shard with rows,
  else shard 0), the global length and the global ERR_RANGE — the
  reference's two scalar ``all_gather``s, here one stream-ordered gather;
- each shard then gets its rewritten copy of the op and K1 applies it
  (``ops/apply_kernel.py``), one launch per op for the shards on one
  device: the owner gets the INSERT at its local, clipped position and
  every other shard the same row as a NOOP (bookkeeping only);
  REMOVE/ANNOTATE reach every shard with the range clamped into its
  coordinates, as a NOOP where that range is empty; ACKs pass unchanged;
  the type is first clipped into [NOOP, ACK_ANNOTATE], as the reference's
  ``lax.switch`` does; the global ERR_RANGE is then ORed into every
  shard's err lane.

Why three numbers suffice for the placement: the reference evaluates
``insert_place_mask`` at the shard-local position ``P = pos1 - offset``,
which needs the offset first (its second gather). Rows of positive visible
length tile ``[0, total)`` exactly, so the mask fires somewhere for every
``0 <= P < total``, never for ``P < 0`` or ``P > total``, and at ``P ==
total`` only on a zero-length row at the shard's end, which is the
mask evaluated at ``total`` — known before any offset.

Nothing in :meth:`ShardedDoc.apply` or :meth:`ShardedDoc.compact` waits on
the host: owner and offsets stay on the device. Compaction is shard-local
(K2 per shard), and :meth:`ShardedDoc.rebalance` is the host-driven
redistribution of live rows into equal contiguous runs. On a card the
kernels take at most 65,536 rows per shard: a larger ``shard_cap`` raises
``ValueError`` at construction (the plain versions on the CPU have no
cap, as the reference has none).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from fluidframework_tpu_torch.ops import _cuda
from fluidframework_tpu_torch.ops.apply_kernel import (
    N_SCALARS,
    SC_COUNT,
    SC_ERR,
    SC_MIN_SEQ,
    SC_SELF,
    _perspective,
    excl_cumsum,
    insert_place_mask,
)
from fluidframework_tpu_torch.ops.merge_kernel import _ops_on
from fluidframework_tpu_torch.ops.segment_state import (
    SCALAR_FIELDS,
    SEGMENT_LANES,
    SegmentState,
    to_host,
)
from fluidframework_tpu_torch.parallel.fleet import _blank_packed, _host
from fluidframework_tpu_torch.parallel.mesh import (
    Mesh,
    apply_part,
    compact_part,
    devices,
    resolve_kernel,
)
from fluidframework_tpu_torch.protocol.constants import (
    ERR_RANGE,
    F_CLIENT,
    F_POS1,
    F_POS2,
    F_REF,
    F_SEQ,
    F_TYPE,
    KIND_FREE,
    NO_CLIENT,
    OP_ANNOTATE,
    OP_INSERT,
    OP_NOOP,
    OP_REMOVE,
    RSEQ_NONE,
)

_I32 = torch.int32


class _Group:
    """The shards of one device: one packed pair ``[N_LANES, n_g, S]`` /
    ``[n_g, N_SCALARS]`` (so K1 and K2 launch once for all of them) and
    their shard indices as an index on the mesh's first device."""

    def __init__(self, device, shards: List[int], tables, scalars, first):
        self.device = device
        self.shards = shards
        self.tables = tables
        self.scalars = scalars
        self.at = torch.tensor(shards, dtype=torch.long, device=first)


def check_shard_cap(shard_cap: int, kernel: str, devs) -> str:
    """Check that shards of ``shard_cap`` rows fit the kernels that would
    run them on ``devs``: on a card, a cap past the kernels' largest tier
    raises ``ValueError`` (the plain versions have no cap). Returns the
    resolved ``kernel``."""
    kernel = resolve_kernel(kernel, devs)
    if kernel != "plain" and any(d.type == "cuda" for d in devs):
        _cuda.tier(shard_cap, "merge_apply")
    return kernel


class ShardedDoc:
    """One document spread over the mesh: capacity = n_shards * shard_cap.
    The host API mirrors a single-document state; positions are global.

    ``mesh`` defaults to every device of :func:`parallel.mesh.devices` on
    axis ``seg``; ``kernel`` is ``"auto"``, ``"cuda"`` or ``"plain"``, as
    for ``DocFleet``."""

    def __init__(self, shard_cap: int, mesh: Optional[Mesh] = None,
                 axis: str = "seg", self_client: int = NO_CLIENT,
                 kernel: str = "auto"):
        if mesh is None:
            mesh = Mesh(devices(), axis)
        self.mesh = mesh
        self.axis = mesh.axis
        self.n_shards = mesh.size
        self.shard_cap = shard_cap
        self.kernel = check_shard_cap(shard_cap, kernel, mesh.devices)
        self._first = mesh.first
        self._groups: List[_Group] = []
        for dev, shards in mesh.groups():
            t, s = _blank_packed(len(shards), shard_cap, dev)
            s[:, SC_SELF] = self_client
            self._groups.append(_Group(dev, shards, t, s, self._first))
        # Row i of a per-group concatenation is shard _order[i].
        self._order = np.concatenate([g.shards for g in self._groups])
        self._in_order = bool((self._order == np.arange(self.n_shards)).all())
        self._ar = torch.arange(self.n_shards, dtype=_I32, device=self._first)

    # -- the per-op exchange ------------------------------------------------

    def _local_stats(self, g: _Group, op) -> torch.Tensor:
        """[n_g, 3] per shard of group ``g``: visible length, holds rows,
        an insert at its end may land in it."""
        L, sc = g.tables, g.scalars

        def f(i):
            return op[i].reshape(1, 1)

        clientn = f(F_CLIENT)
        is_local = clientn == sc[:, SC_SELF:SC_SELF + 1]
        part, vis = _perspective(L, clientn, f(F_REF), is_local,
                                 sc[:, SC_MIN_SEQ:SC_MIN_SEQ + 1])
        total = vis.sum(1, keepdim=True).to(_I32)
        tail = insert_place_mask(L, f(F_SEQ), part, vis,
                                 total - excl_cumsum(vis)).any(1)
        return torch.stack([total[:, 0], (sc[:, SC_COUNT] > 0).to(_I32),
                            tail.to(_I32)], dim=1)

    def _gather(self, per_group: List[torch.Tensor]) -> torch.Tensor:
        """Per-group ``[n_g, ...]`` tensors -> one ``[n_shards, ...]`` on the
        first device, in shard order (stream-ordered copies)."""
        if len(per_group) == 1 and self._in_order:
            return per_group[0].to(self._first)
        out = torch.empty((self.n_shards,) + tuple(per_group[0].shape[1:]),
                          dtype=per_group[0].dtype, device=self._first)
        for g, x in zip(self._groups, per_group):
            out.index_copy_(0, g.at, x.to(self._first))
        return out

    def _apply_one(self, op, op_groups) -> None:
        """One sequenced op (``op`` [OP_WIDTH] on the first device, its
        copy on each group's device in ``op_groups``)."""
        n = self.n_shards
        st = self._gather([self._local_stats(g, o)
                           for g, o in zip(self._groups, op_groups)])
        totals, live, tail = st[:, 0], st[:, 1], st[:, 2] != 0
        offset = excl_cumsum(totals)
        global_total = totals.sum().to(_I32)
        ty, pos1, pos2 = op[F_TYPE], op[F_POS1], op[F_POS2]
        p = pos1 - offset
        has_place = ((p >= 0) & (p < totals)) | ((p == totals) & tail)
        first_place = torch.where(has_place, self._ar, n).amin()
        last_live = torch.where(live != 0, self._ar, 0).amax()
        owner = torch.where(first_place < n, first_place, last_live)
        is_ins = ty == OP_INSERT
        is_rng = (ty == OP_REMOVE) | (ty == OP_ANNOTATE)
        # Out-of-range detection in GLOBAL coordinates: per-shard clamping
        # would legalize streams the single-table kernel flags.
        range_err = torch.where(
            is_ins, (first_place >= n) & (pos1 > global_total),
            is_rng & (pos2 > global_total),
        )
        a = torch.minimum(torch.clamp(p, min=0), totals)
        b = torch.minimum(torch.clamp(pos2 - offset, min=0), totals)
        rows = op.expand(n, op.shape[0]).clone()
        rows[:, F_POS1] = torch.where(is_ins | is_rng, a, pos1)
        rows[:, F_POS2] = torch.where(is_rng, b, pos2)
        rows[:, F_TYPE] = torch.where(
            is_ins, torch.where(self._ar == owner, OP_INSERT, OP_NOOP),
            torch.where(is_rng, torch.where(a < b, ty, OP_NOOP), ty),
        )
        err = torch.where(range_err, ERR_RANGE, 0).to(_I32)
        for g in self._groups:
            r = rows if (len(self._groups) == 1 and self._in_order) \
                else rows.index_select(0, g.at)
            apply_part((g.tables, g.scalars),
                       r.to(g.device)[:, None].contiguous(), self.kernel)
            g.scalars[:, SC_ERR] |= err.to(g.device)

    def apply(self, ops) -> None:
        """ops: ``[K, OP_WIDTH]`` sequenced rows with GLOBAL positions
        (numpy rows go up through a pinned buffer without a host sync)."""
        o = _ops_on(ops, self._first, batched=False)[0]
        per_group = [o.to(g.device) for g in self._groups]
        for k in range(o.shape[0]):
            self._apply_one(o[k], [x[k] for x in per_group])

    def compact(self) -> None:
        """Shard-local zamboni: K2 on every shard (one launch per device).
        Global row order (shard-major) is untouched; no row crosses a
        shard."""
        for g in self._groups:
            compact_part((g.tables, g.scalars), self.kernel)

    # -- host views ------------------------------------------------------------

    def device_scalars(self) -> torch.Tensor:
        """``[n_shards, N_SCALARS]`` on the first device, shard order."""
        return self._gather([g.scalars for g in self._groups])

    def _host_pair(self):
        """Every shard's lanes ``[N_LANES, n_shards, S]`` and scalars
        ``[n_shards, N_SCALARS]`` as host numpy, shard order, one
        readback."""
        t = self._gather([g.tables.transpose(0, 1) for g in self._groups])
        s = self.device_scalars()
        flat = _host(torch.cat([t.reshape(-1), s.reshape(-1)]))
        nt = flat[: t.numel()].reshape(t.shape).transpose(1, 0, 2)
        return nt, flat[t.numel():].reshape(s.shape)

    def _counts(self) -> np.ndarray:
        return _host(self.device_scalars()[:, SC_COUNT])

    @property
    def state(self) -> SegmentState:
        """The shards as one host SegmentState of ``[n_shards, S]`` lanes
        and ``[n_shards]`` scalars (the reference's global arrays)."""
        t, s = self._host_pair()
        return SegmentState(
            *[t[i] for i in range(len(SEGMENT_LANES))],
            *[s[:, j] for j in range(len(SCALAR_FIELDS))],
        )

    def load_state(self, fields) -> None:
        """Replace every shard from the 20 fields of a sharded state as
        host arrays (15 lanes ``[n_shards, S]``, then count, min_seq,
        cur_seq, self_client, err ``[n_shards]``) — the inverse of
        :attr:`state`."""
        arrays = [np.asarray(x, np.int32) for x in fields]
        lanes = np.stack(arrays[: len(SEGMENT_LANES)])
        if lanes.shape[1:] != (self.n_shards, self.shard_cap):
            raise ValueError(f"lanes must be [{self.n_shards}, "
                             f"{self.shard_cap}], got {lanes.shape[1:]}")
        scal = np.zeros((self.n_shards, N_SCALARS), np.int32)
        scal[:, : len(SCALAR_FIELDS)] = np.stack(
            arrays[len(SEGMENT_LANES):], axis=1)
        for g in self._groups:
            g.tables.copy_(torch.from_numpy(
                np.ascontiguousarray(lanes[:, g.shards])))
            g.scalars.copy_(torch.from_numpy(
                np.ascontiguousarray(scal[g.shards])))

    def clone(self, kernel: Optional[str] = None) -> "ShardedDoc":
        """A copy of this document on the same mesh (``kernel`` to run it
        differently, e.g. ``"plain"`` beside the kernels)."""
        out = ShardedDoc.__new__(ShardedDoc)
        out.__dict__.update(self.__dict__)
        out.kernel = resolve_kernel(kernel or self.kernel, self.mesh.devices)
        out._groups = [
            _Group(g.device, g.shards, g.tables.clone(), g.scalars.clone(),
                   self._first)
            for g in self._groups
        ]
        return out

    def rows_in_use(self) -> int:
        """Total live rows across shards (one small readback)."""
        return int(self._counts().sum())

    def rebalance(self, trigger: float = 0.8) -> bool:
        """Host-driven rebalance: when any shard's table passes ``trigger *
        shard_cap`` while the document as a whole still fits, compact and
        redistribute live rows into equal contiguous runs per shard.
        Returns True when a redistribution happened."""
        if int(self._counts().max()) < trigger * self.shard_cap:
            return False
        self.compact()
        single = self.to_single()
        n = int(single.count)
        if -(-max(n, 1) // self.n_shards) > self.shard_cap:
            return False  # genuinely full everywhere: ERR_CAPACITY stands
        self.load_single(single)
        return True

    def load_single(self, single: SegmentState) -> None:
        """Distribute a single-table document over the shards in equal
        contiguous runs of its rows (the summary-load path)."""
        h = to_host(single)
        n = int(h.count)
        per = -(-max(n, 1) // self.n_shards)
        if per > self.shard_cap:
            raise ValueError("document too large for the shard capacity")
        lanes = []
        for lane in SEGMENT_LANES:
            fill = KIND_FREE if lane == "kind" else (
                RSEQ_NONE if lane == "rseq" else 0
            )
            arr = np.full((self.n_shards, self.shard_cap), fill, np.int32)
            src = np.asarray(getattr(h, lane))
            for sh in range(self.n_shards):
                lo, hi = sh * per, min((sh + 1) * per, n)
                if lo < hi:
                    arr[sh, : hi - lo] = src[lo:hi]
            lanes.append(arr)
        counts = np.asarray(
            [max(0, min((sh + 1) * per, n) - sh * per)
             for sh in range(self.n_shards)], np.int32
        )

        def rep(v):
            return np.full(self.n_shards, int(v), np.int32)

        self.load_state(lanes + [counts, rep(h.min_seq), rep(h.cur_seq),
                                 rep(h.self_client), rep(h.err)])

    def to_single(self) -> SegmentState:
        """Concatenate the shards into one host single-document state
        (numpy; rows in global order, each shard's live rows a contiguous
        run, so per-shard free rows drop out)."""
        t, s = self._host_pair()
        counts = [int(c) for c in s[:, SC_COUNT]]
        n = sum(counts)
        lanes = {}
        for i, lane in enumerate(SEGMENT_LANES):
            runs = [t[i, sh, :cnt] for sh, cnt in enumerate(counts) if cnt]
            if runs:
                lanes[lane] = np.concatenate(runs).astype(np.int32)
            else:
                lanes[lane] = np.full(
                    1, KIND_FREE if lane == "kind" else 0, np.int32
                )
        sc = {f: s[:, j] for j, f in enumerate(SCALAR_FIELDS)}
        return SegmentState(
            **lanes,
            count=np.int32(n),
            min_seq=np.int32(sc["min_seq"].max()),
            cur_seq=np.int32(sc["cur_seq"].max()),
            self_client=np.int32(sc["self_client"][0]),
            err=np.int32(np.bitwise_or.reduce(sc["err"])),
        )

    @property
    def err(self) -> int:
        """The shards' sticky err bits ORed (one small readback)."""
        return int(np.bitwise_or.reduce(
            _host(self.device_scalars()[:, SC_ERR])))
