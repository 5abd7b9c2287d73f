"""X1 and X2, the sharded document's per-op exchange, as hand-written
Hopper kernels, apart and in one launch.

This module holds the exchange half of the reference's
``fluidframework_tpu/parallel/sharded_doc.py`` ``_shard_apply_one`` (:71),
which the reference runs as the body of a jitted ``shard_map`` (two scalar
``all_gather``s, no ``pl.pallas_call``). Per sequenced op:

- X1 (``shard_stats``) reads a device group's packed pair ``[N_LANES, n_g,
  S]`` / ``[n_g, N_SCALARS]`` and the op row, and writes ``[n_g, 3]``
  int32 per shard: its visible length from the op's perspective, whether
  it holds rows, and whether an insert at its end may land in it (a
  zero-length row there that the insert's tie-break goes before);
- X2 (``shard_resolve``) reads the ``[n, 3]`` of every shard and the op
  row, and writes the group's rewritten op rows ``[n_g, 1, OP_WIDTH]``,
  K1's input: the exclusive offsets, the global length, the insert's
  owner (the first shard whose placement fires, else the last shard with
  rows, else shard 0) at its local, clamped position and a NOOP on every
  other shard; a REMOVE/ANNOTATE clamped into each shard, a NOOP where
  that range is empty; any other type unchanged. The global ERR_RANGE is
  ORed into the group's err lanes (K1 only ORs that lane, so the order
  does not matter).

On one device group (every layout one card runs) the two are one launch,
``shard_exchange``: X1, whose CTA that takes the launch's last ticket
writes the group's stats and runs X2's body on them, with the group's
shards in order (``at`` and ``row_of`` the identity). Several groups keep
X1, the stats copied between the cards, then X2: they need the other
groups' stats.

The kernels are ``shard_stats``, ``shard_resolve`` and ``shard_exchange``
in ``csrc/merge_kernels.cu``; X1 shares K1's perspective and tie-break, so
ownership and the owner's own insert cannot disagree. X1 reads only the
rows below each shard's count (every row at or past it is free); the
plain version walks every row, as the reference does. X1's end-of-shard
test is one pass: a row of positive visible length never fires at ``rem
= total - prefix``, and a zero-length row fires there iff it takes part,
breaks the tie and no row after it has positive visible length; so the
test is "last eligible zero-length row > last positive row". It equals
``insert_place_mask`` at ``total - excl_cumsum(vis)`` while a shard's
visible length stays below 2**32 and no length is negative.

:func:`shard_stats_plain`, :func:`shard_resolve_plain` and
:func:`shard_exchange_plain` (the second applied to the first's output)
are the plain PyTorch versions of the same functions. The wrappers
:func:`shard_stats`, :func:`shard_resolve` and :func:`shard_exchange` run
them for tensors on the CPU and launch the kernels for CUDA tensors (or
raise); they never fall back from one to the other. The op row is read
in place from the uploaded ``[K, OP_WIDTH]`` buffer (``ops[k]``), so a
launch needs no copy and no host synchronisation.
"""

from __future__ import annotations

import torch

from fluidframework_tpu_torch.ops import _cuda
from fluidframework_tpu_torch.ops.apply_kernel import (
    L_SEQ,
    N_SCALARS,
    SC_COUNT,
    SC_ERR,
    SC_MIN_SEQ,
    SC_SELF,
    _perspective,
    excl_cumsum,
    ties_before,
)
from fluidframework_tpu_torch.protocol.constants import (
    ERR_RANGE,
    F_CLIENT,
    F_POS1,
    F_POS2,
    F_REF,
    F_SEQ,
    F_TYPE,
    OP_ANNOTATE,
    OP_INSERT,
    OP_NOOP,
    OP_REMOVE,
    OP_WIDTH,
)

_I32 = torch.int32
# X1's output columns: visible length, holds rows, an insert at the end
# may land in it.
ST_VIS, ST_LIVE, ST_TAIL = range(3)
N_STATS = 3
# X1's accumulators a shard (visible length, last positive row, last
# eligible zero-length row), as each launch leaves them; one more row's
# first column is the launch's ticket (CTAs folded).
ACC_INIT = (0, -1, -1)


def new_accumulators(n_g: int, device) -> torch.Tensor:
    """The ``[n_g + 1, 3]`` accumulators of X1 and ``shard_exchange`` for a
    group of ``n_g`` shards: a row a shard and the ticket's row, each set
    to :data:`ACC_INIT` (each launch leaves them so)."""
    return torch.tensor([ACC_INIT] * (n_g + 1), dtype=_I32, device=device)


def shard_stats_plain(tables, scalars, op) -> torch.Tensor:
    """X1's plain version: ``[n_g, 3]`` int32 for op row ``op``
    ([OP_WIDTH]) on the packed pair ``tables`` ``[N_LANES, n_g, S]`` /
    ``scalars`` ``[n_g, N_SCALARS]``."""
    def f(i):
        return op[i].reshape(1, 1)

    clientn = f(F_CLIENT)
    is_local = clientn == scalars[:, SC_SELF:SC_SELF + 1]
    part, vis = _perspective(tables, clientn, f(F_REF), is_local,
                             scalars[:, SC_MIN_SEQ:SC_MIN_SEQ + 1])
    rows = torch.arange(tables.shape[-1], device=tables.device)
    last_pos = torch.where(vis > 0, rows, -1).amax(1)
    zero = part & (vis == 0) & ties_before(f(F_SEQ), tables[L_SEQ])
    last_zero = torch.where(zero, rows, -1).amax(1)
    return torch.stack([vis.sum(1).to(_I32),
                        (scalars[:, SC_COUNT] > 0).to(_I32),
                        (last_zero > last_pos).to(_I32)], dim=1)


def shard_resolve_plain(stats, op, at, row_of, scalars):
    """X2's plain version: ``(rows [n_g, 1, OP_WIDTH], scalars)`` for op
    row ``op`` ([OP_WIDTH]), given ``stats`` ``[n, 3]`` of every shard
    (shard ``j`` in row ``row_of[j]``), the group's shard indices ``at``
    ``[n_g]`` and its ``scalars`` ``[n_g, N_SCALARS]``; the returned
    scalars carry the global ERR_RANGE in their err lane. Inputs
    untouched."""
    n = stats.shape[0]
    st = stats.index_select(0, row_of.long())
    totals, live, tail = st[:, ST_VIS], st[:, ST_LIVE], st[:, ST_TAIL] != 0
    offset = excl_cumsum(totals)
    total = totals.sum().to(_I32)
    ar = torch.arange(n, dtype=_I32, device=stats.device)
    ty, pos1, pos2 = op[F_TYPE], op[F_POS1], op[F_POS2]
    p = pos1 - offset
    has_place = ((p >= 0) & (p < totals)) | ((p == totals) & tail)
    first_place = torch.where(has_place, ar, n).amin()
    last_live = torch.where(live != 0, ar, 0).amax()
    owner = torch.where(first_place < n, first_place, last_live)
    is_ins = ty == OP_INSERT
    is_rng = (ty == OP_REMOVE) | (ty == OP_ANNOTATE)
    # Out of range in GLOBAL coordinates: per-shard clamping would make
    # streams legal that the single-table kernel flags.
    range_err = torch.where(is_ins, (first_place >= n) & (pos1 > total),
                            is_rng & (pos2 > total))
    a = torch.minimum(torch.clamp(p, min=0), totals)
    b = torch.minimum(torch.clamp(pos2 - offset, min=0), totals)
    rows = op.expand(n, OP_WIDTH).clone()
    rows[:, F_POS1] = torch.where(is_ins | is_rng, a, pos1)
    rows[:, F_POS2] = torch.where(is_rng, b, pos2)
    rows[:, F_TYPE] = torch.where(
        is_ins, torch.where(ar == owner, OP_INSERT, OP_NOOP),
        torch.where(is_rng & (a >= b), OP_NOOP, ty))
    out = scalars.clone()
    out[:, SC_ERR] |= torch.where(range_err, ERR_RANGE, 0).to(_I32)
    return rows.index_select(0, at.long())[:, None], out


def shard_exchange_plain(tables, scalars, op):
    """``shard_exchange``'s plain version on one device group (its shards
    in order): ``(stats [n_g, 3], rows [n_g, 1, OP_WIDTH], scalars)``,
    :func:`shard_resolve_plain` applied to :func:`shard_stats_plain`'s
    output. Inputs untouched."""
    stats = shard_stats_plain(tables, scalars, op)
    ar = torch.arange(stats.shape[0], dtype=_I32, device=stats.device)
    rows, sc = shard_resolve_plain(stats, op, ar, ar, scalars)
    return stats, rows, sc


def _int32_on(dev, what: str, *ts) -> None:
    for t in ts:
        if t.device != dev or t.dtype != _I32 or not t.is_contiguous():
            raise ValueError(f"{what}: every tensor must be a contiguous "
                             f"int32 tensor on {dev}")


def _check_outputs(what: str, n_g: int, stats, acc) -> None:
    if tuple(stats.shape) != (n_g, N_STATS) or \
            tuple(acc.shape) != (n_g + 1, len(ACC_INIT)):
        raise ValueError(f"{what}: stats must be [{n_g}, {N_STATS}] and acc "
                         f"[{n_g + 1}, {len(ACC_INIT)}]")


def _row_ptr(ops, k: int) -> int:
    """The address of row ``k`` of the uploaded op buffer ``[K,
    OP_WIDTH]``."""
    if ops.dim() != 2 or ops.shape[1] != OP_WIDTH:
        raise ValueError(f"ops must be [K, {OP_WIDTH}], got "
                         f"{tuple(ops.shape)}")
    if not 0 <= k < ops.shape[0]:
        raise IndexError(f"op {k} of {ops.shape[0]}")
    return ops.data_ptr() + k * OP_WIDTH * ops.element_size()


def _launch(name: str, dev, *args) -> None:
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(_cuda.lib(), name)(*args, stream)
    if err != 0:
        msg = _cuda.lib().merge_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


def shard_stats(tables, scalars, ops, k: int, *, out=None, acc=None):
    """X1 for op ``ops[k]`` (``ops`` the uploaded ``[K, OP_WIDTH]``
    buffer) on a group's packed pair: writes ``[n_g, 3]`` int32 into
    ``out`` (allocated when None) and returns it. CPU tensors take
    :func:`shard_stats_plain`; CUDA tensors launch ``shard_stats``, which
    folds its CTAs into ``acc`` (:func:`new_accumulators`; fresh ones when
    None) and leaves it reset, or raise."""
    n_g, s = tables.shape[1], tables.shape[2]
    dev = tables.device
    if out is None:
        out = torch.empty((n_g, N_STATS), dtype=_I32, device=dev)
    if dev.type == "cpu":
        out.copy_(shard_stats_plain(tables, scalars, ops[k]))
        return out
    _cuda.check_packed(tables, scalars)
    if acc is None:
        acc = new_accumulators(n_g, dev)
    _int32_on(dev, "shard_stats", ops, out, acc)
    _check_outputs("shard_stats", n_g, out, acc)
    _launch("shard_stats", dev, _row_ptr(ops, k), tables.data_ptr(),
            scalars.data_ptr(), out.data_ptr(), acc.data_ptr(), n_g, s)
    shard_stats.launches += 1
    return out


def shard_resolve(stats, ops, k: int, at, row_of, scalars, *, out=None):
    """X2 for op ``ops[k]``: from ``stats`` ``[n, 3]`` of every shard
    (shard ``j`` in row ``row_of[j]``), writes the rows of the group's
    shards ``at`` (``[n_g]`` shard indices) into ``out`` ``[n_g, 1,
    OP_WIDTH]`` (allocated when None) and ORs the global ERR_RANGE into
    ``scalars[:, SC_ERR]`` in place; returns ``out``. CPU tensors take
    :func:`shard_resolve_plain`; CUDA tensors launch ``shard_resolve`` or
    raise."""
    n, n_g = stats.shape[0], at.shape[0]
    dev = stats.device
    if out is None:
        out = torch.empty((n_g, 1, OP_WIDTH), dtype=_I32, device=dev)
    if dev.type == "cpu":
        rows, sc = shard_resolve_plain(stats, ops[k], at, row_of, scalars)
        out.copy_(rows)
        scalars.copy_(sc)
        return out
    _int32_on(dev, "shard_resolve", stats, ops, at, row_of, scalars, out)
    if (tuple(stats.shape) != (n, N_STATS) or tuple(row_of.shape) != (n,)
            or tuple(scalars.shape) != (n_g, N_SCALARS)
            or tuple(out.shape) != (n_g, 1, OP_WIDTH)):
        raise ValueError(f"shard_resolve: stats must be [n, {N_STATS}], "
                         f"row_of [n], scalars [{n_g}, {N_SCALARS}] and out "
                         f"[{n_g}, 1, {OP_WIDTH}]")
    if n > _cuda.lib().shard_max_shards() or n_g > n:
        raise ValueError(f"shard_resolve: {n_g} of {n} shards")
    _launch("shard_resolve", dev, _row_ptr(ops, k), stats.data_ptr(),
            row_of.data_ptr(), at.data_ptr(), scalars.data_ptr(),
            out.data_ptr(), n, n_g)
    shard_resolve.launches += 1
    return out


def shard_exchange(tables, scalars, ops, k: int, *, stats=None, out=None,
                   acc=None):
    """X1 and X2 in one launch for op ``ops[k]`` on one device group's
    packed pair (its ``n_g`` shards in order): writes X1's ``[n_g, 3]``
    into ``stats`` and the group's rows into ``out`` ``[n_g, 1,
    OP_WIDTH]`` (each allocated when None), ORs the global ERR_RANGE into
    ``scalars[:, SC_ERR]`` in place, and returns ``out``. CPU tensors take
    :func:`shard_exchange_plain`; CUDA tensors launch ``shard_exchange``,
    whose CTAs fold into ``acc`` (:func:`new_accumulators`; fresh ones
    when None) and leave it reset, or raise."""
    n_g, s = tables.shape[1], tables.shape[2]
    dev = tables.device
    if stats is None:
        stats = torch.empty((n_g, N_STATS), dtype=_I32, device=dev)
    if out is None:
        out = torch.empty((n_g, 1, OP_WIDTH), dtype=_I32, device=dev)
    if dev.type == "cpu":
        st, rows, sc = shard_exchange_plain(tables, scalars, ops[k])
        stats.copy_(st)
        out.copy_(rows)
        scalars.copy_(sc)
        return out
    _cuda.check_packed(tables, scalars)
    if acc is None:
        acc = new_accumulators(n_g, dev)
    _int32_on(dev, "shard_exchange", ops, stats, out, acc)
    _check_outputs("shard_exchange", n_g, stats, acc)
    if tuple(out.shape) != (n_g, 1, OP_WIDTH):
        raise ValueError(f"shard_exchange: out must be [{n_g}, 1, "
                         f"{OP_WIDTH}]")
    if n_g > _cuda.lib().shard_exchange_max_shards():
        raise ValueError(f"shard_exchange: {n_g} shards")
    _launch("shard_exchange", dev, _row_ptr(ops, k), tables.data_ptr(),
            scalars.data_ptr(), stats.data_ptr(), acc.data_ptr(),
            out.data_ptr(), n_g, s)
    shard_exchange.launches += 1
    return out


def reset_counts() -> None:
    """Zero the wrappers' CUDA launch counts (the CPU path never
    counts)."""
    shard_stats.launches = 0
    shard_resolve.launches = 0
    shard_exchange.launches = 0


reset_counts()
