"""Device-side EditManager trunk fast path (the positional-rebase scan).

Counterpart of ``fluidframework_tpu/tree/device_trunk.py``. Each sequenced
commit is rebased over the trunk commits concurrent with it (those after
its refSeq), then appended to the trunk (reference
``editManager.ts:142-281``). Here that inner loop runs on the device for a
batch of N documents at once: commits stream through a Python loop over
batched tensors; each step folds the incoming changesets over a ring of the
last ``W`` trunk entries with the dense rebase (``ops/tree_kernel.py``),
applies the result to the trunk documents, and pushes it into the ring.
Inactive ring entries leave the changeset untouched through a branchless
select, so a step makes no host synchronisation.

Every document pushes one entry per step, so the ring's write slot is the
same for the whole batch and known on the host (``step % W``): the ring is
circular, with no per-step copy. Move-bearing commits ride the same scan
(the ring carries the full dense IR, move lanes included).

On the card the whole scan is one launch of the hand kernel T1
(``ops/tree_scan_kernel.py``, ``csrc/tree_kernels.cu``): one warp per
document (one CTA per document past the warp tier's widths).
:func:`batched_trunk_scan_plain` is the
plain PyTorch version of the same function, taken for CPU tensors (and
held against T1 on the card by ``chip_smoke.py``).

Restriction (matches the generated workload): a commit's refSeq covers all
of its author's own earlier commits, so every ring entry newer than the ref
is a concurrent other-session commit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from fluidframework_tpu_torch.ops.tree_kernel import (
    I32,
    DenseChange,
    apply_change,
    batch_of_one,
    rebase_change,
    to_device,
)
from fluidframework_tpu_torch.ops.tree_scan_kernel import trunk_scan_cuda
from fluidframework_tpu_torch.utils import resolve_device


class CommitBatch(NamedTuple):
    """C sequenced commits for each of N documents (lanes [N, C, ...]).

    ``seq``/``ref`` are document sequence numbers; ``seq`` is strictly
    increasing and > 0. The move lanes mirror ``DenseChange`` (None = a
    move-free stream; zeros are materialized)."""

    del_mask: torch.Tensor  # [N, C, Lc]
    ins_cnt: torch.Tensor  # [N, C, Lc+1]
    ins_ids: torch.Tensor  # [N, C, Pc]
    ref: torch.Tensor  # [N, C] refSeq of each commit
    seq: torch.Tensor  # [N, C] sequence number of each commit
    mov_id: Optional[torch.Tensor] = None  # [N, C, Lc]
    mov_off: Optional[torch.Tensor] = None  # [N, C, Lc]
    pool_mid: Optional[torch.Tensor] = None  # [N, C, Pc]
    pool_off: Optional[torch.Tensor] = None  # [N, C, Pc]


def commits_on(commits: CommitBatch, dev: torch.device) -> CommitBatch:
    """The batch as int32 tensors on ``dev``, move lanes materialized."""
    lanes = [to_device(x, dev) for x in commits[:5]]
    if commits.mov_id is None:
        zl = torch.zeros_like(lanes[0])
        zp = torch.zeros_like(lanes[2])
        return CommitBatch(*lanes, zl, zl, zp, zp)
    return CommitBatch(*lanes, *[to_device(x, dev) for x in commits[5:]])


def _select(pred, a: DenseChange, b: DenseChange) -> DenseChange:
    p = pred[:, None]
    return DenseChange(*[torch.where(p, x, y) for x, y in zip(a, b)])


def batched_trunk_scan(doc_ids, L, commits: CommitBatch, W: int,
                       device="cuda"):
    """Integrate each document's C sequenced commits into its trunk;
    returns ``(doc_ids [N, Lc], L [N], err [N])``. ``err`` is sticky and
    set when a commit's ``ref`` reaches behind the W-entry ring (the rebase
    chain would be incomplete): callers fall back to the host path for
    that stream rather than trust the result. On a card it is one launch
    of T1; on the CPU :func:`batched_trunk_scan_plain`."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return batched_trunk_scan_plain(doc_ids, L, commits, W, dev)
    cb = CommitBatch(*[x.contiguous() for x in commits_on(commits, dev)])
    return trunk_scan_cuda(to_device(doc_ids, dev).contiguous(),
                           to_device(L, dev).contiguous(), cb, W)


def batched_trunk_scan_plain(doc_ids, L, commits: CommitBatch, W: int,
                             device="cuda"):
    """The plain version of :func:`batched_trunk_scan` (the same function,
    on any device): a Python loop over the commits, each folded over the
    ring with the batched dense rebase and applied."""
    dev = resolve_device(device)
    cb = commits_on(commits, dev)
    doc_ids = to_device(doc_ids, dev)
    L = to_device(L, dev)
    N, C, Lc = cb.del_mask.shape
    Pc = cb.ins_ids.shape[-1]
    widths = (Lc, Lc + 1, Pc, Lc, Lc, Pc, Pc)
    ring = [torch.zeros((N, W, w), dtype=I32, device=dev) for w in widths]
    ring_L = torch.zeros((N, W), dtype=I32, device=dev)
    ring_seq = torch.zeros((N, W), dtype=I32, device=dev)  # 0 = empty
    max_evicted = torch.zeros(N, dtype=I32, device=dev)
    err = torch.zeros(N, dtype=I32, device=dev)
    lanes = (cb.del_mask, cb.ins_cnt, cb.ins_ids, cb.mov_id, cb.mov_off,
             cb.pool_mid, cb.pool_off)
    for k in range(C):
        c = DenseChange(*[x[:, k] for x in lanes])
        ref = cb.ref[:, k]
        # Ring-window guard: an evicted entry with seq > ref would be
        # silently skipped by the fold below — flag instead.
        err |= ((ref < max_evicted) & (max_evicted > 0)).to(I32)
        # Fold over the ring oldest -> newest (slot k % W is the oldest).
        for j in range(W):
            w = (k + j) % W
            over = DenseChange(*[r[:, w] for r in ring])
            sw = ring_seq[:, w]
            active = (sw > ref) & (sw > 0)
            c = _select(active, rebase_change(c, over, ring_L[:, w]), c)
        new_doc, new_L = apply_change(doc_ids, L, c)
        # Push (c, L, seq) over the oldest slot; record the evicted seq.
        slot = k % W
        max_evicted = torch.maximum(max_evicted, ring_seq[:, slot])
        for r, lane in zip(ring, c):
            r[:, slot] = lane
        ring_L[:, slot] = L
        ring_seq[:, slot] = cb.seq[:, k]
        doc_ids, L = new_doc, new_L
    return doc_ids, L, err


def trunk_scan(doc_ids, L, commits: CommitBatch, W: int, device="cuda"):
    """One document's scan: ``doc_ids [Lc]``, a scalar ``L`` and a
    CommitBatch of ``[C, ...]`` lanes (``ref``/``seq`` ``[C]``). Returns
    ``(doc_ids [Lc], L, err)`` with 0-d ``L`` and ``err``: the reference's
    single-document ``trunk_scan``, here :func:`batched_trunk_scan` over a
    batch of one."""
    out = batched_trunk_scan(
        batch_of_one(doc_ids), batch_of_one(L),
        CommitBatch(*[batch_of_one(x) for x in commits]), W, device=device,
    )
    return tuple(x[0] for x in out)
