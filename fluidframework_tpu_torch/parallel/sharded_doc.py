"""One document sharded across the device mesh — intra-document scale-out.

Counterpart of ``fluidframework_tpu/parallel/sharded_doc.py``. The segment
table splits into contiguous shards over a mesh (axis ``seg``); each shard
holds a single-document table whose rows are a contiguous run of the
global document. Per sequenced op:

- every shard evaluates the visibility perspective locally (row stamps are
  shard-local state) and reports three numbers: its visible length, whether
  it holds rows, and whether an insert at its own end may land in it (a
  zero-length row there that the insert's tie-break would go before):
  X1 (``ops/shard_exchange_kernel.py``);
- every group's ``[n_g, 3]`` reaches every group's device (the
  reference's two scalar ``all_gather``s), and X2 resolves the exclusive
  offsets, the insert's owner (the first shard whose placement predicate
  fires, else the last shard with rows, else shard 0), the global length
  and the global ERR_RANGE, which it ORs into every shard's err lane, and
  writes each shard's rewritten copy of the op: the owner gets the INSERT
  at its local, clipped position and every other shard the same row as a
  NOOP (bookkeeping only); REMOVE/ANNOTATE reach every shard with the
  range clamped into its coordinates, as a NOOP where that range is
  empty; ACKs pass unchanged; the type is first clipped into [NOOP,
  ACK_ANNOTATE], as the reference's ``lax.switch`` does;
- K1 applies the rows (``ops/apply_kernel.py``), one launch a group.

With one device group (every layout one card runs) nothing moves between
cards, and X1 and X2 are one launch, ``shard_exchange``, whose last CTA
to finish resolves the op from the stats: an op is two launches on one
stream, the exchange and K1. Several groups launch X1 on each, copy the
stats between the cards, then X2 and K1 on each.

Why three numbers suffice for the placement: the reference evaluates
``insert_place_mask`` at the shard-local position ``P = pos1 - offset``,
which needs the offset first (its second gather). Rows of positive visible
length tile ``[0, total)`` exactly, so the mask fires somewhere for every
``0 <= P < total``, never for ``P < 0`` or ``P > total``, and at ``P ==
total`` only on a zero-length row at the shard's end, which is the
mask evaluated at ``total`` — known before any offset.

Nothing in :meth:`ShardedDoc.apply` or :meth:`ShardedDoc.compact` waits on
the host: owner and offsets stay on the device, and the kernels read the
op row in place from the buffer ``apply`` uploads once. Compaction is shard-local
(K2 per shard), and :meth:`ShardedDoc.rebalance` is the host-driven
redistribution of live rows into equal contiguous runs. On a card a
shard past 65,536 rows runs on the kernels' split tier (one thread-block
cluster a shard), so the one-card list's 8 x 65,536 rows a shard runs as
the reference's one-device mesh does; only a ``shard_cap`` past the
kernels' largest tier (2**30 rows) raises ``ValueError`` at construction
(the plain versions on the CPU have no cap, as the reference has none).

:func:`sharded_apply_ops` is the same exchange as a function of a stacked
state, the counterpart of the reference's ``shard_map`` body of that name.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from fluidframework_tpu_torch.ops import _cuda
from fluidframework_tpu_torch.ops import shard_exchange_kernel as SX
from fluidframework_tpu_torch.ops.apply_kernel import (
    N_SCALARS,
    SC_COUNT,
    SC_ERR,
    SC_SELF,
    pack_state,
    unpack_state,
)
from fluidframework_tpu_torch.ops.merge_kernel import (  # noqa: F401
    _ops_on,
    insert_place_mask,
    perspective,
)
from fluidframework_tpu_torch.ops.segment_state import (  # noqa: F401
    SCALAR_FIELDS,
    SEGMENT_LANES,
    SegmentState,
    make_state,
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
from fluidframework_tpu_torch.protocol.constants import (  # noqa: F401
    F_CLIENT,
    F_POS1,
    F_POS2,
    F_REF,
    F_TYPE,
    KIND_FREE,
    NO_CLIENT,
    OP_ANNOTATE,
    OP_INSERT,
    OP_REMOVE,
    OP_WIDTH,
    RSEQ_NONE,
)

_I32 = torch.int32


class _Group:
    """The shards of one device: one packed pair ``[N_LANES, n_g, S]`` /
    ``[n_g, N_SCALARS]`` (so the exchange, K1 and K2 launch once for all
    of them), their shard indices as an index on the mesh's first device
    (``at``, for gathers), and the exchange's buffers on its own device:
    its shard indices (``ids``), the exchange's accumulators, the stats of
    every shard in per-group concatenation order (``stats``: this group's
    at rows ``[lo, lo + n_g)``, its view ``own``; shard ``j`` in row
    ``row_of[j]``) and K1's rewritten op rows."""

    def __init__(self, device, shards: List[int], tables, scalars, first,
                 lo: int, row_of: np.ndarray):
        n_g = len(shards)
        self.device = device
        self.shards = shards
        self.tables = tables
        self.scalars = scalars
        self.at = torch.tensor(shards, dtype=torch.long, device=first)
        self.ids = torch.tensor(shards, dtype=_I32, device=device)
        self.row_of = torch.from_numpy(row_of.astype(np.int32)).to(device)
        self.stats = torch.empty((len(row_of), SX.N_STATS), dtype=_I32,
                                 device=device)
        self.lo = lo
        self.own = self.stats[lo:lo + n_g]
        self.acc = SX.new_accumulators(n_g, device)
        self.rows = torch.empty((n_g, 1, OP_WIDTH), dtype=_I32,
                                device=device)


def check_shard_cap(shard_cap: int, kernel: str, devs) -> str:
    """Check that shards of ``shard_cap`` rows fit the kernels that would
    run them on ``devs``: on a card, a cap past the kernels' largest tier
    (2**30 rows) raises ``ValueError`` (the plain versions have no cap).
    It asks a card nothing but, for a cap of 16,385-65,536 rows, its SM
    count (``_cuda.tier``). Returns the resolved ``kernel``."""
    kernel = resolve_kernel(kernel, devs)
    for dev in set(devs):
        if kernel != "plain" and dev.type == "cuda":
            # A device's shards launch together: one table each.
            _cuda.tier(shard_cap, "merge_apply", list(devs).count(dev))
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
        groups = mesh.groups()
        # Row i of a per-group concatenation is shard _order[i].
        self._order = np.concatenate([shards for _d, shards in groups])
        self._in_order = bool((self._order == np.arange(self.n_shards)).all())
        self._row_of = np.argsort(self._order)
        self._groups: List[_Group] = []
        lo = 0
        for dev, shards in groups:
            t, s = _blank_packed(len(shards), shard_cap, dev)
            s[:, SC_SELF] = self_client
            self._groups.append(_Group(dev, shards, t, s, self._first, lo,
                                       self._row_of))
            lo += len(shards)

    # -- the per-op exchange ------------------------------------------------

    def _stats(self, g: _Group, ops, k: int) -> None:
        """X1 for op ``ops[k]`` on group ``g``, into ``g.own``."""
        if self.kernel == "plain":
            g.own.copy_(SX.shard_stats_plain(g.tables, g.scalars, ops[k]))
        else:
            SX.shard_stats(g.tables, g.scalars, ops, k, out=g.own,
                           acc=g.acc)

    def _share_stats(self) -> None:
        """Every group's stats onto every other group's device
        (stream-ordered copies): the reference's all_gathers."""
        for h in self._groups:
            for g in self._groups:
                if g is not h:
                    h.stats[g.lo:g.lo + len(g.shards)].copy_(g.own)

    def _exchange(self, g: _Group, ops, k: int) -> None:
        """X1 and X2 in one launch for op ``ops[k]`` on the only group:
        its stats into ``g.own``, its rows into ``g.rows``, the global
        ERR_RANGE into its err lanes."""
        if self.kernel == "plain":
            stats, rows, sc = SX.shard_exchange_plain(g.tables, g.scalars,
                                                      ops[k])
            g.own.copy_(stats)
            g.rows.copy_(rows)
            g.scalars.copy_(sc)
        else:
            SX.shard_exchange(g.tables, g.scalars, ops, k, stats=g.own,
                              out=g.rows, acc=g.acc)

    def _resolve(self, g: _Group, ops, k: int) -> None:
        """X2 for op ``ops[k]`` on group ``g``: its rows into ``g.rows``,
        the global ERR_RANGE into its err lanes."""
        if self.kernel == "plain":
            rows, sc = SX.shard_resolve_plain(g.stats, ops[k], g.ids,
                                              g.row_of, g.scalars)
            g.rows.copy_(rows)
            g.scalars.copy_(sc)
        else:
            SX.shard_resolve(g.stats, ops, k, g.ids, g.row_of, g.scalars,
                             out=g.rows)

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

    def apply(self, ops) -> None:
        """ops: ``[K, OP_WIDTH]`` sequenced rows with GLOBAL positions
        (numpy rows go up through a pinned buffer without a host sync).
        Each op on one device group: the exchange, then K1; on several,
        X1 on every group, the stats shared, then X2 and K1 on every
        group."""
        o = _ops_on(ops, self._first, batched=False)[0]
        if len(self._groups) == 1:
            g = self._groups[0]
            for k in range(o.shape[0]):
                self._exchange(g, o, k)
                apply_part((g.tables, g.scalars), g.rows, self.kernel)
            return
        per_group = [o.to(g.device) for g in self._groups]
        for k in range(o.shape[0]):
            for g, og in zip(self._groups, per_group):
                self._stats(g, og, k)
            self._share_stats()
            for g, og in zip(self._groups, per_group):
                self._resolve(g, og, k)
                apply_part((g.tables, g.scalars), g.rows, self.kernel)

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
        # Buffers of its own: a clone shares no exchange state.
        out._groups = [_Group(g.device, g.shards, g.tables.clone(),
                              g.scalars.clone(), self._first, g.lo,
                              self._row_of)
                       for g in self._groups]
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


def sharded_apply_ops(state: SegmentState, ops) -> SegmentState:
    """Apply ops ``[K, OP_WIDTH]`` (GLOBAL positions) in order to one
    document sharded over ``n_shards`` tables; returns the new sharded
    state and leaves ``state`` as it was.

    The signature differs from the reference's ``sharded_apply_ops(state,
    ops, axis, n_shards)``, which is the body of a ``shard_map``: there
    each shard passes its own slice and the exchange runs as collectives
    over ``axis``. Here ``state`` is the whole stack (15 lanes ``[n_shards,
    S]``, scalars ``[n_shards]``) on one device, and the exchange is
    :class:`ShardedDoc`'s over a mesh of ``n_shards`` entries of that
    device; no axis name or shard count is passed."""
    dev = state.kind.device
    n, cap = state.kind.shape
    doc = ShardedDoc(cap, Mesh([dev] * n, "seg"))
    g = doc._groups[0]
    tables, scalars = pack_state(state)
    g.tables.copy_(tables)
    g.scalars.copy_(scalars)
    doc.apply(ops)
    return unpack_state(g.tables, g.scalars)
