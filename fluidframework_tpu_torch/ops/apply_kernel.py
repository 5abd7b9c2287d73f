"""K1, the merge apply kernel: K sequenced ops per document, in order.

Replaces the Pallas TPU kernel ``fluidframework_tpu/ops/pallas_kernel.py``
(``_apply_values``, reached through ``apply_ops_packed``). The CUDA kernel
is ``csrc/merge_kernels.cu`` (``merge_apply``), in three tiers: one CTA per
document with its table resident in shared memory up to 2,048 rows; a
thread-block cluster of 3-16 CTAs per document, the table split across
their shared memory, up to 16,384 rows; and one CTA per document reading
and writing the table in place in global memory up to 65,536 rows. Each
warp walks its own block of rows in 32-row tiles, and each op moves the
rows once. It is latency-bound on the K sequential ops' barriers, not
bandwidth-bound; its byte floor is 2 x 15 x S x 4 B x D of table traffic
plus D x K x 40 B of ops.

:func:`apply_plain` is the plain PyTorch version of the same function: a
batched, branch-free transcription of the reference's unified pipeline —
perspective visibility, an exclusive prefix sum of visible lengths,
boundary splits at pos1/pos2, insert placement with breakTie, shift-by-one
row inserts, remove/annotate/ack marks, the ERR_* bits, and cur_seq /
min_seq bookkeeping. Ops with an unknown type change nothing but that
bookkeeping and ERR_CLIENT, as in the Pallas kernel (the XLA
``merge_kernel.apply_op`` would clip them into a known type instead).

:func:`apply_ops_packed` runs the plain version for tensors on the CPU and
launches the CUDA kernel for CUDA tensors; it never falls back from one to
the other. Like the reference's donated ``input_output_aliases``, it
updates the packed tables and scalars in place unless ``out`` is given.
"""

from __future__ import annotations

import torch

from fluidframework_tpu_torch.ops import _cuda
from fluidframework_tpu_torch.ops.segment_state import (
    N_SCALARS,
    SEGMENT_LANES,
    SegmentState,
    removed_by_slot,
    writer_bits,
)
from fluidframework_tpu_torch.protocol.constants import (
    ERR_CAPACITY,
    ERR_CLIENT,
    ERR_RANGE,
    F_ARG,
    F_CLIENT,
    F_LEN,
    F_LSEQ,
    F_MSN,
    F_POS1,
    F_POS2,
    F_REF,
    F_SEQ,
    F_TYPE,
    KIND_FREE,
    KIND_TEXT,
    MAX_WRITERS,
    NORM_EXISTING_LOCAL,
    NORM_NEW_LOCAL,
    OP_ACK_ANNOTATE,
    OP_ACK_INSERT,
    OP_ACK_REMOVE,
    OP_ANNOTATE,
    OP_INSERT,
    OP_REMOVE,
    RSEQ_NONE,
    UNASSIGNED_SEQ,
)

_I32 = torch.int32
N_LANES = len(SEGMENT_LANES)
# Scalar pack layout (columns of the [D, N_SCALARS] array; the order of
# segment_state.SCALAR_FIELDS).
SC_COUNT, SC_MIN_SEQ, SC_CUR_SEQ, SC_SELF, SC_ERR = range(5)

(L_KIND, L_ORIG, L_OFF, L_LEN, L_SEQ, L_CLIENT, L_LSEQ, L_RSEQ, L_RLSEQ,
 L_RBITS, L_RBITS2, L_RBITS3, L_ASEQ, L_ALSEQ, L_AVAL) = range(N_LANES)


def pack_state(state: SegmentState):
    """SegmentState -> (tables [N_LANES, D, S], scalars [D, N_SCALARS])."""
    tables = torch.stack([getattr(state, k) for k in SEGMENT_LANES]).to(_I32)
    z = torch.zeros_like(state.count)
    scalars = torch.stack(
        [state.count, state.min_seq, state.cur_seq, state.self_client,
         state.err] + [z] * (N_SCALARS - 5),
        dim=-1,
    ).to(_I32)
    return tables.contiguous(), scalars.contiguous()


def unpack_state(tables, scalars) -> SegmentState:
    return SegmentState(
        **{k: tables[i] for i, k in enumerate(SEGMENT_LANES)},
        count=scalars[..., SC_COUNT],
        min_seq=scalars[..., SC_MIN_SEQ],
        cur_seq=scalars[..., SC_CUR_SEQ],
        self_client=scalars[..., SC_SELF],
        err=scalars[..., SC_ERR],
    )


def excl_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum along the last axis, wrapped to int32."""
    return (torch.cumsum(x, dim=-1) - x).to(_I32)


def shift_right1(x: torch.Tensor) -> torch.Tensor:
    """Shift the last axis right by one row, zero-filling row 0."""
    return torch.cat([torch.zeros_like(x[..., :1]), x[..., :-1]], dim=-1)


def _perspective(L, clientn, refn, is_local, min_seq):
    """(part, vis) of every row from the op's perspective (reference
    mergeTree.ts:916-1004)."""
    kind, seq, client = L[L_KIND], L[L_SEQ], L[L_CLIENT]
    length, rseq = L[L_LEN], L[L_RSEQ]
    live = kind != KIND_FREE
    removed = rseq != RSEQ_NONE
    r_acked = removed & (rseq != UNASSIGNED_SEQ)
    skip = r_acked & (rseq <= min_seq)
    rseq_eff = torch.where(rseq == UNASSIGNED_SEQ, RSEQ_NONE, rseq)
    by_client = removed_by_slot(L[L_RBITS], L[L_RBITS2], L[L_RBITS3], clientn)
    hidden = removed & ((rseq_eff <= refn) | by_client)
    seq_eff = torch.where(seq == UNASSIGNED_SEQ, NORM_EXISTING_LOCAL, seq)
    ins_vis = (client == clientn) | (seq_eff <= refn)
    zero = torch.zeros_like(length)
    vis_remote = torch.where(~hidden & ins_vis, length, zero)
    vis_local = torch.where(removed, zero, length)
    vis = torch.where(is_local, vis_local, vis_remote)
    part = live & ~skip
    return part, torch.where(part, vis, zero)


def _apply_values(tables, scalars, ops):
    """The op loop on values: returns (lanes [N_LANES, D, S], count,
    min_seq, cur_seq, self_client, err), the scalars as [D, 1]."""
    _, d, s = tables.shape
    dev = tables.device
    L = tables.clone()
    col = torch.arange(s, dtype=_I32, device=dev).expand(d, s)
    count = scalars[:, SC_COUNT:SC_COUNT + 1].clone()
    min_seq = scalars[:, SC_MIN_SEQ:SC_MIN_SEQ + 1].clone()
    cur_seq = scalars[:, SC_CUR_SEQ:SC_CUR_SEQ + 1].clone()
    self_client = scalars[:, SC_SELF:SC_SELF + 1].clone()
    err = scalars[:, SC_ERR:SC_ERR + 1].clone()
    big = torch.full_like(col, s)

    def first_true(mask):
        idx = torch.where(mask, col, big).amin(dim=1, keepdim=True)
        return idx < s, idx

    def value_at(val, idx):
        return torch.where(col == idx, val, 0).sum(1, keepdim=True).to(_I32)

    def shift1(L, do, q, strict):
        """Rows past q (or from q on when not strict) take their left
        neighbour's lanes — the vectorized B-tree row shift."""
        edge = q if strict else q - 1
        return torch.where((do & (col > edge))[None], shift_right1(L), L)

    def split(L, do, q, length):
        """Boundary split at row q: row q keeps `length`, row q+1 (the
        shifted copy) starts `length` further in."""
        L = shift1(L, do, q, strict=True)
        m_q = do & (col == q)
        m_q1 = do & (col == q + 1)
        L[L_LEN] = torch.where(m_q, length, L[L_LEN])
        L[L_OFF] = torch.where(m_q1, L[L_OFF] + length, L[L_OFF])
        L[L_LEN] = torch.where(m_q1, L[L_LEN] - length, L[L_LEN])
        return L

    for k in range(ops.shape[1]):
        op = ops[:, k, :].to(_I32)

        def f(i):
            return op[:, i:i + 1]

        ty = f(F_TYPE)
        pos1, pos2 = f(F_POS1), f(F_POS2)
        seqn, refn, clientn = f(F_SEQ), f(F_REF), f(F_CLIENT)
        lseqn, arg, ilen, msn = f(F_LSEQ), f(F_ARG), f(F_LEN), f(F_MSN)

        is_ins = ty == OP_INSERT
        is_rem = ty == OP_REMOVE
        is_ann = ty == OP_ANNOTATE
        is_range = is_rem | is_ann
        local_op = seqn == UNASSIGNED_SEQ
        is_local = clientn == self_client

        part, vis = _perspective(L, clientn, refn, is_local, min_seq)
        prefix = excl_cumsum(vis)
        total = vis.sum(1, keepdim=True).to(_I32)
        rem1 = pos1 - prefix
        rem2 = pos2 - prefix

        # Strictly-inside hits = boundary splits needed.
        has1, idx1 = first_true(part & (vis > 0) & (rem1 > 0) & (rem1 < vis))
        has2, idx2 = first_true(part & (vis > 0) & (rem2 > 0) & (rem2 < vis))
        split1 = value_at(rem1, idx1)
        split2 = value_at(rem2, idx2)

        # Insert placement with tie-break (insertingWalk + breakTie).
        op_norm = torch.where(local_op, NORM_NEW_LOCAL, seqn)
        seq = L[L_SEQ]
        seg_norm = torch.where(seq == UNASSIGNED_SEQ, NORM_EXISTING_LOCAL, seq)
        place = part & (
            ((vis > 0) & (rem1 >= 0) & (rem1 < vis))
            | ((vis == 0) & (rem1 == 0) & (op_norm > seg_norm))
        )
        hasp, idxp = first_true(place)
        idxp = torch.where(hasp, idxp, count)

        # Capacity / do flags (sequential checks).
        sh = torch.where(has1, 2, 1).to(_I32)
        cap_err_i = is_ins & (count + sh > s)
        do_ins = is_ins & ~cap_err_i
        do_a_rng = is_range & has1 & (count + 1 <= s)
        cap_a = is_range & has1 & (count + 1 > s)
        count_a = count + do_a_rng.to(_I32)
        do_b_rng = is_range & has2 & (count_a + 1 <= s)
        cap_b = is_range & has2 & (count_a + 1 > s)

        zero = torch.zeros_like(err)
        err = (
            err
            | torch.where(cap_err_i | cap_a | cap_b, ERR_CAPACITY, zero)
            | torch.where(is_ins & ~hasp & (pos1 > total), ERR_RANGE, zero)
            | torch.where(is_range & (pos2 > total), ERR_RANGE, zero)
            | torch.where(clientn >= MAX_WRITERS, ERR_CLIENT, zero)
        )

        # Split A at pos1 (insert mid-segment or range start).
        do_a = do_a_rng | (do_ins & has1)
        L = split(L, do_a, idx1, split1)
        # Split B at pos2 (range ops; index/length in post-A space).
        same_row = do_a_rng & (idx1 == idx2)
        q_b = idx2 + do_a_rng.to(_I32)
        L = split(L, do_b_rng, q_b, torch.where(same_row, split2 - split1,
                                                 split2))
        # Insert the new row (between split halves, or at placement).
        q_i = torch.where(has1, idx1 + 1, idxp)
        L = shift1(L, do_ins, q_i, strict=False)
        m_new = do_ins & (col == q_i)
        new_row = torch.zeros((N_LANES, d, 1), dtype=_I32, device=dev)
        new_row[L_KIND] = KIND_TEXT
        new_row[L_ORIG] = arg
        new_row[L_LEN] = ilen
        new_row[L_SEQ] = seqn
        new_row[L_CLIENT] = clientn
        new_row[L_LSEQ] = torch.where(local_op, lseqn, 0)
        new_row[L_RSEQ] = RSEQ_NONE
        L = torch.where(m_new[None], new_row, L)

        count = torch.where(
            is_range,
            count_a + do_b_rng.to(_I32),
            torch.where(do_ins, count + sh, count),
        )

        # Covered rows (post-split perspective).
        part2, vis2 = _perspective(L, clientn, refn, is_local, min_seq)
        prefix2 = excl_cumsum(vis2)
        cov = part2 & (vis2 > 0) & (prefix2 >= pos1) & (prefix2 + vis2 <= pos2)

        kind, seq, lseq = L[L_KIND], L[L_SEQ], L[L_LSEQ]
        rseq, rlseq = L[L_RSEQ], L[L_RLSEQ]
        aseq, alseq, aval = L[L_ASEQ], L[L_ALSEQ], L[L_AVAL]

        # Remove marks (markRangeRemoved).
        m_rem = cov & is_rem
        not_removed = rseq == RSEQ_NONE
        was_local = rseq == UNASSIGNED_SEQ
        bit_lo, bit_mid, bit_hi = writer_bits(clientn)
        rseq = torch.where(m_rem & (not_removed | was_local), seqn, rseq)
        rlseq = torch.where(m_rem & not_removed & local_op, lseqn, rlseq)
        L[L_RBITS] = torch.where(m_rem, L[L_RBITS] | bit_lo, L[L_RBITS])
        L[L_RBITS2] = torch.where(m_rem, L[L_RBITS2] | bit_mid, L[L_RBITS2])
        L[L_RBITS3] = torch.where(m_rem, L[L_RBITS3] | bit_hi, L[L_RBITS3])

        # Annotate marks (single-lane LWW).
        m_ann = cov & is_ann & (local_op | (alseq == 0))
        aval = torch.where(m_ann, arg, aval)
        aseq = torch.where(m_ann, seqn, aseq)
        alseq = torch.where(m_ann, torch.where(local_op, lseqn, 0), alseq)

        # Acks of own ops (ackPendingSegment).
        live = kind != KIND_FREE
        m_aci = (ty == OP_ACK_INSERT) & live & (seq == UNASSIGNED_SEQ) & (
            lseq == lseqn)
        seq = torch.where(m_aci, seqn, seq)
        lseq = torch.where(m_aci, 0, lseq)
        m_acr = (ty == OP_ACK_REMOVE) & live & (rlseq == lseqn)
        rseq = torch.where(m_acr & (rseq == UNASSIGNED_SEQ), seqn, rseq)
        rlseq = torch.where(m_acr, 0, rlseq)
        m_aca = (ty == OP_ACK_ANNOTATE) & live & (alseq == lseqn)
        aseq = torch.where(m_aca, seqn, aseq)
        alseq = torch.where(m_aca, 0, alseq)

        L[L_SEQ], L[L_LSEQ], L[L_RSEQ], L[L_RLSEQ] = seq, lseq, rseq, rlseq
        L[L_ASEQ], L[L_ALSEQ], L[L_AVAL] = aseq, alseq, aval

        # Bookkeeping (collab window floor / current seq).
        cur_seq = torch.maximum(cur_seq, seqn)
        min_seq = torch.maximum(min_seq, msn)

    return L, count, min_seq, cur_seq, self_client, err


def apply_plain(tables, scalars, ops):
    """K1's plain PyTorch version: new (tables, scalars); inputs untouched."""
    L, count, min_seq, cur_seq, self_client, err = _apply_values(
        tables, scalars, ops
    )
    zpad = torch.zeros((count.shape[0], N_SCALARS - 5), dtype=_I32,
                       device=count.device)
    return L, torch.cat([count, min_seq, cur_seq, self_client, err, zpad], 1)


def _destination(tables, scalars, out):
    if out is None:
        return tables, scalars
    ot, os_ = out
    if ot.shape != tables.shape or os_.shape != scalars.shape:
        raise ValueError("out tensors must match the state's shapes")
    return ot, os_


def apply_ops_packed(tables, scalars, ops, *, out=None):
    """Apply ops [D, K, OP_WIDTH] to a packed state. Writes into ``out``
    (a (tables, scalars) pair) or, by default, into the inputs in place;
    returns the written pair. CPU tensors take :func:`apply_plain`; CUDA
    tensors launch ``merge_apply`` on the tier S calls for (shared memory up
    to 2,048 rows, a cluster up to 16,384, global memory up to 65,536) or
    raise."""
    ot, os_ = _destination(tables, scalars, out)
    if tables.device.type == "cpu":
        nt, ns = apply_plain(tables, scalars, ops)
        ot.copy_(nt)
        os_.copy_(ns)
        return ot, os_
    tier = _cuda.launch("merge_apply", tables, scalars, ops, (ot, os_))
    _cuda.count_launch(apply_ops_packed, tier)
    return ot, os_


# CUDA launches, in all and by tier (the CPU path never counts).
_cuda.reset_counts(apply_ops_packed)
