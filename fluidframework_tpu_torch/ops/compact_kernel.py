"""K2, the zamboni compact kernel, and K3, apply + compact in one launch.

Replace the Pallas TPU kernels of ``fluidframework_tpu/ops/pallas_compact.py``
(``compact_values`` behind ``compact_packed``; ``_fused_kernel`` behind
``apply_compact_packed``). The CUDA kernels are ``merge_compact`` and
``merge_apply_compact`` in ``csrc/merge_kernels.cu``: one gather per
compaction, computed on the original rows (each kept row's previous kept
row decides whether it heads a merge run; output row h takes the h-th
head, its length a difference of prefix lengths), with K3 running K1's op
loop and K2 back to back so the table never leaves the CTA between them.
They keep the table in one CTA's shared memory up to 2,048 rows, split
across a thread-block cluster's shared memory up to 16,384 and in global
memory above that, up to 65,536 rows (the tiers of K1); so K2 replaces
both the reference's Pallas compact and the XLA compact it falls back to
above 256 rows. Their byte floor is 2 x 15 x S x 4 B x D of table traffic
(plus D x K x 40 B of ops for K3).

:func:`compact_plain` is the plain PyTorch version: reclaim rows that are
removed, acked, at or below min_seq and carry no pending stamp; squeeze the
live rows down as a masked scatter (freed rows take KIND_FREE / RSEQ_NONE /
0); re-merge adjacent splits of one acked, unremoved, identically-annotated
insert, taking merged lengths from prefix-length differences; count =
n_heads. The wrappers update the packed state in place unless ``out`` is
given, take the plain versions for CPU tensors only, and launch the kernel
or raise for CUDA tensors.
"""

from __future__ import annotations

import torch

from fluidframework_tpu_torch.ops import _cuda
from fluidframework_tpu_torch.ops.apply_kernel import (
    L_ALSEQ,
    L_AVAL,
    L_ASEQ,
    L_CLIENT,
    L_KIND,
    L_LEN,
    L_LSEQ,
    L_OFF,
    L_ORIG,
    L_RLSEQ,
    L_RSEQ,
    L_SEQ,
    N_LANES,
    N_SCALARS,
    SC_COUNT,
    SC_MIN_SEQ,
    _apply_values,
    _destination,
    excl_cumsum,
    shift_right1,
)
from fluidframework_tpu_torch.protocol.constants import (
    KIND_FREE,
    KIND_TEXT,
    RSEQ_NONE,
    UNASSIGNED_SEQ,
)

_I32 = torch.int32


def _squeeze(L, mask, dest):
    """out[:, d, dest[d, j]] = L[:, d, j] where mask[d, j]; every other row
    takes its lane's free value."""
    out = torch.zeros_like(L)
    out[L_KIND] = KIND_FREE
    out[L_RSEQ] = RSEQ_NONE
    d_idx, j_idx = mask.nonzero(as_tuple=True)
    out[:, d_idx, dest[d_idx, j_idx].long()] = L[:, d_idx, j_idx]
    return out


def _compact_values(L, min_seq):
    """The compaction on values: (lanes, n_heads [D, 1])."""
    _, d, s = L.shape
    col = torch.arange(s, dtype=_I32, device=L.device).expand(d, s)
    kind, rseq = L[L_KIND], L[L_RSEQ]
    live = kind != KIND_FREE
    pending = (L[L_LSEQ] != 0) | (L[L_RLSEQ] != 0) | (L[L_ALSEQ] != 0)
    reclaim = (
        live & ~pending & (rseq != RSEQ_NONE) & (rseq != UNASSIGNED_SEQ)
        & (rseq <= min_seq)
    )
    keep = live & ~reclaim
    n = keep.sum(1, keepdim=True).to(_I32)
    sq = _squeeze(L, keep, excl_cumsum(keep.to(_I32)))

    # Sibling re-merge (packParent subset).
    valid = col < n
    prev = shift_right1(sq)
    mergeable = (
        valid
        & (col > 0)
        & (sq[L_KIND] == KIND_TEXT)
        & (prev[L_KIND] == KIND_TEXT)
        & (sq[L_ORIG] == prev[L_ORIG])
        & (sq[L_OFF] == prev[L_OFF] + prev[L_LEN])
        & (sq[L_SEQ] == prev[L_SEQ])
        & (sq[L_CLIENT] == prev[L_CLIENT])
        & (sq[L_SEQ] != UNASSIGNED_SEQ)
        & (sq[L_RSEQ] == RSEQ_NONE)
        & (prev[L_RSEQ] == RSEQ_NONE)
        & (sq[L_ASEQ] == prev[L_ASEQ])
        & (sq[L_AVAL] == prev[L_AVAL])
        & (sq[L_ALSEQ] == 0)
        & (prev[L_ALSEQ] == 0)
        & (sq[L_LSEQ] == 0)
        & (prev[L_LSEQ] == 0)
    )
    head = valid & ~mergeable
    n_heads = head.sum(1, keepdim=True).to(_I32)
    dest_h = excl_cumsum(head.to(_I32))
    vlen = torch.where(valid, sq[L_LEN], 0)
    total = vlen.sum(1, keepdim=True).to(_I32)
    plen = excl_cumsum(vlen)

    out = _squeeze(sq, head, dest_h)
    # Prefix length of each head, at its destination row.
    hp = torch.zeros_like(plen)
    d_idx, j_idx = head.nonzero(as_tuple=True)
    hp[d_idx, dest_h[d_idx, j_idx].long()] = plen[d_idx, j_idx]
    # Merged length of head t = (next head's prefix length, or total) - own.
    pl_next = torch.cat([hp[:, 1:], torch.zeros_like(hp[:, :1])], dim=1)
    nxt = torch.where(col + 1 < n_heads, pl_next, total)
    out[L_LEN] = torch.where(col < n_heads, nxt - hp, 0)
    return out, n_heads


def compact_plain(tables, scalars):
    """K2's plain PyTorch version: new (tables, scalars) with count =
    n_heads and every other scalar column kept; inputs untouched."""
    min_seq = scalars[:, SC_MIN_SEQ:SC_MIN_SEQ + 1]
    out, n_heads = _compact_values(tables, min_seq)
    new_scalars = scalars.clone()
    new_scalars[:, SC_COUNT] = n_heads[:, 0]
    return out, new_scalars


def apply_compact_plain(tables, scalars, ops):
    """K3's plain PyTorch version: K1 then K2; the scalar columns past the
    five state scalars are written as 0 (as the fused TPU kernel does)."""
    L, _count, min_seq, cur_seq, self_client, err = _apply_values(
        tables, scalars, ops
    )
    out, n_heads = _compact_values(L, min_seq)
    zpad = torch.zeros((n_heads.shape[0], N_SCALARS - 5), dtype=_I32,
                       device=n_heads.device)
    return out, torch.cat([n_heads, min_seq, cur_seq, self_client, err, zpad],
                          1)


def compact_packed(tables, scalars, *, out=None):
    """Compact a packed state, in place unless ``out`` is given; returns
    the written pair. CPU: :func:`compact_plain`; CUDA: ``merge_compact`` on
    the tier S calls for (every S up to 65,536 rows)."""
    ot, os_ = _destination(tables, scalars, out)
    if tables.device.type == "cpu":
        nt, ns = compact_plain(tables, scalars)
        ot.copy_(nt)
        os_.copy_(ns)
        return ot, os_
    tier = _cuda.launch("merge_compact", tables, scalars, None, (ot, os_))
    _cuda.count_launch(compact_packed, tier)
    return ot, os_


def apply_compact_packed(tables, scalars, ops, *, out=None):
    """Apply ops [D, K, OP_WIDTH] then compact, in one launch on CUDA; in
    place unless ``out`` is given. CPU: :func:`apply_compact_plain`."""
    ot, os_ = _destination(tables, scalars, out)
    if tables.device.type == "cpu":
        nt, ns = apply_compact_plain(tables, scalars, ops)
        ot.copy_(nt)
        os_.copy_(ns)
        return ot, os_
    tier = _cuda.launch("merge_apply_compact", tables, scalars, ops,
                        (ot, os_))
    _cuda.count_launch(apply_compact_packed, tier)
    return ot, os_


# CUDA launches, in all and by tier (the CPU path never counts).
_cuda.reset_counts(compact_packed, apply_compact_packed)
