"""Device telemetry lanes of a document fleet.

Counterpart of the telemetry part of ``fluidframework_tpu/parallel/fleet.py``
(``TELEMETRY_COLS``, ``_reduce_telemetry``, ``_scalars_telemetry``): one
reduction on the device folds a fleet's packed scalars into per-shard
occupancy, err-bitmask counts by bit and the collab-window watermarks, so a
/metrics scrape reads aggregates in one transfer, never lanes. The rest of
``DocFleet`` (pools, promotion, residency) is not ported yet.
"""

from __future__ import annotations

import torch

from fluidframework_tpu_torch.ops.apply_kernel import (
    SC_COUNT,
    SC_CUR_SEQ,
    SC_ERR,
    SC_MIN_SEQ,
)

TELEMETRY_ERR_BITS = 4  # ERR_CAPACITY / ERR_RANGE / ERR_CLIENT + spare
TELEMETRY_COLS = (
    "live_slots", "rows_in_use", "err_docs",
    "err_bit0", "err_bit1", "err_bit2", "err_bit3",
    "min_seq_floor", "cur_seq_head",
)

_SEQ_SENTINEL = 2**31 - 1  # dead rows must not lower the min_seq floor


def _reduce_telemetry(live, count, err, min_seq, cur_seq, axis: int):
    """The column assembly every telemetry reduction shares, in the order
    of :data:`TELEMETRY_COLS`. Inputs are 2-D blocks whose ``axis`` folds;
    ``live`` is the same-shape bool occupancy mask."""
    zero = torch.zeros_like(count)
    count = torch.where(live, count, zero)
    err = torch.where(live, err, zero)
    min_seq = torch.where(live, min_seq, torch.full_like(min_seq,
                                                         _SEQ_SENTINEL))
    cur_seq = torch.where(live, cur_seq, zero)
    cols = [
        live.to(torch.int32).sum(dim=axis),
        count.sum(dim=axis),
        (err != 0).to(torch.int32).sum(dim=axis),
    ]
    for b in range(TELEMETRY_ERR_BITS):
        cols.append(((err >> b) & 1).sum(dim=axis))
    floor = min_seq.amin(dim=axis)
    cols.append(torch.where(floor == _SEQ_SENTINEL, 0, floor))
    cols.append(cur_seq.amax(dim=axis))
    return torch.stack([c.to(torch.int32) for c in cols], dim=1)


def _scalars_telemetry(scalars, n_shards: int):
    """[n_shards, len(TELEMETRY_COLS)] reduction over packed scalars
    ([D, N_SCALARS], the SC_* columns); every row live."""
    per = scalars.shape[0] // n_shards
    shape = (n_shards, per)
    return _reduce_telemetry(
        torch.ones(shape, dtype=torch.bool, device=scalars.device),
        scalars[:, SC_COUNT].reshape(shape),
        scalars[:, SC_ERR].reshape(shape),
        scalars[:, SC_MIN_SEQ].reshape(shape),
        scalars[:, SC_CUR_SEQ].reshape(shape),
        axis=1,
    )
