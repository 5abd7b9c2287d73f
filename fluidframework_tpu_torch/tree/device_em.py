"""Lineage-aware EditManager trunk scan — concurrent commits on the device.

Counterpart of ``fluidframework_tpu/tree/device_em.py``: the EditManager's
own id-anchor algebra (``tree/edit_manager.py`` ``_transport`` +
``apply_ops_to_view``) as dense batched work over N documents.

- The scan carries a ring of the last ``W`` TRUNK ID-STATES keyed by seq,
  so a commit's author view at ``ref`` is one ring select (device-eligible
  commits are authored with no pending chain: their view IS trunk-at-ref).
- The commit's positional marks decode against that view: detached ids
  (deletes and move-outs) become a multihot over the interned id universe
  ``U``, and membership tests are int32 gathers from it.
- Each attach run resolves its anchor as ``_transport`` does — the nearest
  LEFT neighbour in the author's post-edit view that is present in the
  evolving output — with a cumulative max over a membership mask, then
  inserts with the prefix-sum scatter.

Move-bearing commits ride the scan: the encoder lowers ``mout`` slots into
``mov_mask`` (folded into the detach multihot) and ``min`` attaches into
insert runs of the SAME cells. A per-document move watermark (highest seq
of a move-bearing commit) makes a ring miss that crosses a move source
report a distinct bit.

Every document pushes one state per step, so the ring's write slot is the
same for the whole batch and known on the host: the ring is circular
(reads are order-free selects by seq). On the card a scan is one launch of
the hand kernel T2 (``ops/tree_scan_kernel.py``, ``csrc/tree_kernels.cu``):
one warp or one CTA per document (``tree_scan_kernel.tier``), the
multihots as bitsets. The plain version,
:func:`batched_em_trunk_scan_ring_plain`, taken for CPU tensors, runs the
steps and attach runs as Python loops over batched tensors with
``torch.where`` selects; nothing in a step synchronises with the host.

The sticky per-document ``err`` lane is a BITMASK: bit 0 = the ref fell off
the ring, bit 1 = capacity overflow, bit 2 = the ring miss crossed a
move-bearing commit. Any nonzero err means the caller replays that
document's stream on the host path.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from fluidframework_tpu_torch.ops.tree_kernel import (  # noqa: F401
    I32,
    DenseChange,
    _apply,
    apply_change,
    _arange,
    _scatter,
    _take,
    batch_of_one,
    to_device,
)
from fluidframework_tpu_torch.ops.tree_scan_kernel import em_ring_scan_cuda
from fluidframework_tpu_torch.utils import resolve_device

# err bitmask lanes (sticky, per document).
ERR_RING_MISS = 1  # commit ref older than every retained ring state
ERR_CAPACITY = 2  # document outgrew the dense capacity mid-scan
ERR_MOVE_EVICTED = 4  # the ring miss crossed a move-bearing commit


class EmCommitBatch(NamedTuple):
    """C sequenced commits for each of N documents, lowered for the EM
    scan (lanes [N, C, ...]).

    Marks are positional over the AUTHOR VIEW at ``ref``. ``run_*`` describe
    the commit's attach runs (inserts and move-ins) in wire order: start
    position in the POST view, length, offset of the run's first id in the
    ``ins_ids`` pool (-1 start = unused slot). ``mov_mask`` marks move-out
    slots (None = move-free stream; zeros are materialized)."""

    del_mask: torch.Tensor  # [N, C, Lc]
    ins_cnt: torch.Tensor  # [N, C, Lc+1]
    ins_ids: torch.Tensor  # [N, C, Pc] (interned ids, pool order)
    run_start: torch.Tensor  # [N, C, R]
    run_len: torch.Tensor  # [N, C, R]
    run_off: torch.Tensor  # [N, C, R]
    ref: torch.Tensor  # [N, C]
    seq: torch.Tensor  # [N, C]
    mov_mask: Optional[torch.Tensor] = None  # [N, C, Lc]


def em_commits_on(commits: EmCommitBatch, dev) -> EmCommitBatch:
    """The batch as int32 tensors on ``dev``, the move lane materialized."""
    lanes = [to_device(x, dev) for x in commits[:8]]
    mov = (torch.zeros_like(lanes[0]) if commits.mov_mask is None
           else to_device(commits.mov_mask, dev))
    return EmCommitBatch(*lanes, mov)


def _member(ids: torch.Tensor, multihot: torch.Tensor) -> torch.Tensor:
    """membership[n, i] = multihot[n, ids[n, i]]; 0 for ids outside
    [0, U)."""
    return _take(multihot, ids)


def _multihot(ids: torch.Tensor, mask: torch.Tensor, U: int) -> torch.Tensor:
    """multihot[n, u] = 1 iff some masked ids[n, i] == u (id 0 = padding,
    never set; ids outside [0, U) are dropped)."""
    vec = _scatter(torch.where(mask, ids, -1), 1, U)
    vec[:, 0] = 0
    return (vec > 0).to(I32)


def batched_em_trunk_scan(doc_ids, L, base_seq, commits: EmCommitBatch,
                          W: int, U: int, device="cuda"):
    """[N, ...] documents, each with its own commit stream, from a single
    base state (the one-shot catch-up shape). ``base_seq`` [N] is the trunk
    seq of the initial state (commits may ref it). The base state sits at
    the NEWEST slot, so empties (seq -1) evict first."""
    dev = resolve_device(device)
    doc_ids = to_device(doc_ids, dev)
    N, Lc = doc_ids.shape
    ring_ids = torch.zeros((N, W, Lc), dtype=I32, device=dev)
    ring_ids[:, W - 1] = doc_ids
    ring_L = torch.zeros((N, W), dtype=I32, device=dev)
    ring_L[:, W - 1] = to_device(L, dev)
    ring_seq = torch.full((N, W), -1, dtype=I32, device=dev)
    ring_seq[:, W - 1] = to_device(base_seq, dev)
    mov_seq0 = torch.full((N,), -1, dtype=I32, device=dev)
    return batched_em_trunk_scan_ring(ring_ids, ring_L, ring_seq, mov_seq0,
                                      commits, U, device=dev)


def batched_em_trunk_scan_ring(ring_ids, ring_L, ring_seq, mov_seq0,
                               commits: EmCommitBatch, U: int,
                               device="cuda"):
    """[N, W, Lc] PRE-SEEDED state rings, one per document: the newest
    state (the current trunk) at slot W-1, older retained trunk states
    leftward, empties seq -1 — so a commit stream may reference states
    behind the trunk head (the steady-streaming shape). ``mov_seq0`` [N]
    seeds the move watermark (-1 = none retained). Returns ``(doc_ids
    [N, Lc], L [N], err [N])``; the inputs are not modified. On a card it
    is one launch of T2; on the CPU
    :func:`batched_em_trunk_scan_ring_plain`."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return batched_em_trunk_scan_ring_plain(ring_ids, ring_L, ring_seq,
                                                mov_seq0, commits, U, dev)
    rings = [to_device(x, dev).contiguous()
             for x in (ring_ids, ring_L, ring_seq, mov_seq0)]
    cb = EmCommitBatch(*[x.contiguous() for x in em_commits_on(commits,
                                                               dev)])
    return em_ring_scan_cuda(*rings, cb, U)


def batched_em_trunk_scan_ring_plain(ring_ids, ring_L, ring_seq, mov_seq0,
                                     commits: EmCommitBatch, U: int,
                                     device="cuda"):
    """The plain version of :func:`batched_em_trunk_scan_ring` (the same
    function, on any device): Python loops over the commits and attach
    runs over batched tensors."""
    dev = resolve_device(device)
    cb = em_commits_on(commits, dev)
    ring_ids = to_device(ring_ids, dev).clone()
    ring_L = to_device(ring_L, dev).clone()
    ring_seq = to_device(ring_seq, dev).clone()
    mov_seq = to_device(mov_seq0, dev).clone()
    N, W, Lc = ring_ids.shape
    C = cb.ref.shape[1]
    Pc = cb.ins_ids.shape[-1]
    R = cb.run_start.shape[-1]
    ar_lc = _arange(Lc, dev)
    ar_pc = _arange(Pc, dev)
    zl = torch.zeros((N, Lc), dtype=I32, device=dev)
    zb = torch.zeros((N, Lc + 1), dtype=I32, device=dev)
    zp = torch.zeros((N, Pc), dtype=I32, device=dev)
    doc_ids = ring_ids[:, W - 1].clone()
    L = ring_L[:, W - 1].clone()
    err = torch.zeros(N, dtype=I32, device=dev)
    for k in range(C):
        ref = cb.ref[:, k]
        ids_k = cb.ins_ids[:, k]
        mov_k = cb.mov_mask[:, k]
        # The lowered change: move-outs detach exactly like deletes.
        detach = torch.maximum(cb.del_mask[:, k], mov_k)
        c = DenseChange(detach, cb.ins_cnt[:, k], ids_k, zl, zl, zp, zp)
        has_move = mov_k.amax(1) > 0

        # 1. Author view at ref: the LATEST ring state with seq <= ref.
        mask = (ring_seq >= 0) & (ring_seq <= ref[:, None])
        best = torch.where(mask, ring_seq, -1).amax(1)
        miss = (best < 0).to(I32)
        err |= miss * ERR_RING_MISS
        err |= miss * (mov_seq > ref).to(I32) * ERR_MOVE_EVICTED
        hit = (ring_seq == best[:, None]) & mask
        av_ids = torch.where(hit[:, :, None], ring_ids, 0).sum(1, dtype=I32)
        av_L = torch.where(hit, ring_L, 0).sum(1, dtype=I32)

        # 2. Post view: the commit applied to the author view.
        post_ids, _post_L = _apply(av_ids, av_L, c, moves=False)

        # 3. Detached ids -> multihot over U; drop them from the trunk
        #    (idempotent: absent ids match nothing).
        del_vec = _multihot(av_ids, (detach > 0) & (ar_lc < av_L[:, None]),
                            U)
        cur_del = _member(doc_ids, del_vec) * (ar_lc < L[:, None])
        doc2, L2 = _apply(doc_ids, L,
                          DenseChange(cur_del, zb, zp, zl, zl, zp, zp),
                          moves=False)

        # 4. Attach runs in wire order, each anchored after the nearest
        #    left post-view neighbour present in the evolving output.
        for r in range(R):
            start = cb.run_start[:, k, r]
            length = cb.run_len[:, k, r]
            off = cb.run_off[:, k, r]
            present = _multihot(doc2, ar_lc < L2[:, None], U)
            pres = _member(post_ids, present)
            cand = torch.where(pres > 0, ar_lc, -1)
            cmax = torch.cummax(cand, 1).values
            left = torch.gather(cmax, 1,
                                (start - 1).clamp(0, Lc - 1)[:, None].long())
            best = torch.where(start > 0, left[:, 0], -1)
            anchor = torch.gather(post_ids, 1,
                                  best.clamp(0, Lc - 1)[:, None].long())
            match = (doc2 == anchor) & (ar_lc < L2[:, None])
            a_pos = torch.where(match, ar_lc + 1, 0).sum(1, dtype=I32)
            p = torch.where(best >= 0, a_pos, 0)  # insert AFTER the anchor
            # The run's pool slice leads (a per-document rotation by off),
            # masked to its length.
            pool = torch.gather(ids_k, 1, ((ar_pc + off[:, None]) % Pc).long())
            pool = torch.where(ar_pc < length[:, None], pool, 0)
            active = start >= 0
            ins_cnt = _scatter(torch.where(active, p, -1)[:, None],
                               length[:, None], Lc + 1)
            new_doc, new_L = _apply(
                doc2, L2, DenseChange(zl, ins_cnt, pool, zl, zl, zp, zp),
                moves=False)
            keep = active & (length > 0)
            doc2 = torch.where(keep[:, None], new_doc, doc2)
            L2 = torch.where(keep, new_L, L2)

        err |= (L2 > Lc).to(I32) * ERR_CAPACITY
        # 5. Push the new trunk state over the oldest slot; the watermark
        #    remembers the newest move-bearing commit.
        slot = k % W
        ring_ids[:, slot] = doc2
        ring_L[:, slot] = L2
        ring_seq[:, slot] = cb.seq[:, k]
        mov_seq = torch.where(has_move, cb.seq[:, k], mov_seq)
        doc_ids, L = doc2, L2
    return doc_ids, L, err


def em_trunk_scan_one(doc_ids, L, base_seq, commits: EmCommitBatch,
                      W: int, U: int, device="cuda"):
    """One document's EM scan from a single base state: ``doc_ids [Lc]``,
    scalars ``L`` and ``base_seq``, an EmCommitBatch of ``[C, ...]`` lanes.
    Returns ``(doc_ids [Lc], L, err)`` (0-d ``L`` and ``err``):
    :func:`batched_em_trunk_scan` over a batch of one."""
    out = batched_em_trunk_scan(
        batch_of_one(doc_ids), batch_of_one(L), batch_of_one(base_seq),
        EmCommitBatch(*[batch_of_one(x) for x in commits]), W, U,
        device=device,
    )
    return tuple(x[0] for x in out)


def em_trunk_scan_ring_one(ring_ids, ring_L, ring_seq, mov_seq0,
                           commits: EmCommitBatch, U: int, device="cuda"):
    """One document's EM scan over a pre-seeded ring: ``ring_ids [W, Lc]``,
    ``ring_L``/``ring_seq`` ``[W]``, a scalar ``mov_seq0``, an
    EmCommitBatch of ``[C, ...]`` lanes. Returns ``(doc_ids [Lc], L,
    err)``: :func:`batched_em_trunk_scan_ring` over a batch of one."""
    out = batched_em_trunk_scan_ring(
        batch_of_one(ring_ids), batch_of_one(ring_L), batch_of_one(ring_seq),
        batch_of_one(mov_seq0),
        EmCommitBatch(*[batch_of_one(x) for x in commits]), U,
        device=device,
    )
    return tuple(x[0] for x in out)
