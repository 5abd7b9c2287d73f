"""Dense SharedTree sequence-field changeset algebra, batched over documents.

Counterpart of ``fluidframework_tpu/ops/tree_kernel.py``. The reference
co-iterates run-length mark lists (``tree/marks.py``); here, as there, the
algebra is lowered to a dense fixed-shape IR where the co-iteration becomes
prefix sums, scatters and comparison-matrix reductions with no
data-dependent control flow and no host synchronisation.

Every tensor carries an explicit leading document axis ``N``; a
``DenseChange`` holds int32 lanes of shape [N, ...]:

- ``del_mask[N, Lc]``  — 1 where input slot i is deleted;
- ``ins_cnt[N, Lc+1]`` — attach atoms (inserts and move-ins) landing at
  boundary b (before input slot b; boundary L = append);
- ``ins_ids[N, Pc]``   — inserted ids for plain-insert atoms (0 for move-in
  atoms), in boundary order;
- ``mov_id[N, Lc]`` / ``mov_off[N, Lc]`` — move tag (id > 0, offset) of a
  moved-out slot (0 = not moved);
- ``pool_mid[N, Pc]`` / ``pool_off[N, Pc]`` — move tag of a move-in atom
  (0 = plain insert atom).

Exactness against the reference (which transports through one-hot fp32
matmuls at HIGHEST precision): every transport here is an int32 scatter-add
or gather, never a float product. A position outside ``[0, size)`` matches
no slot and is dropped; several writers to one slot sum; a gather from an
out-of-range position reads 0. Counts and cumulative sums come back as
int32 (torch widens integer sums to int64).

Tie policy, move capture/splice and the composed-move tags follow the
reference exactly (see its module docstring).
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fluidframework_tpu_torch.utils import resolve_device

I32 = torch.int32


class DenseChange(NamedTuple):
    """A batch of changesets in dense IR (int32 lanes, leading doc axis)."""

    del_mask: torch.Tensor  # [N, Lc]
    ins_cnt: torch.Tensor  # [N, Lc+1]
    ins_ids: torch.Tensor  # [N, Pc]
    mov_id: torch.Tensor  # [N, Lc] move id of a moved-out slot (0 = none)
    mov_off: torch.Tensor  # [N, Lc] offset in the move's unit stream
    pool_mid: torch.Tensor  # [N, Pc] move id of a move-in atom (0 = ins)
    pool_off: torch.Tensor  # [N, Pc] stream offset of the move-in atom


def empty_change(Lc: int, Pc: int, n: int = 1, device="cuda") -> DenseChange:
    """``n`` identity changesets."""
    dev = resolve_device(device)

    def z(w):
        return torch.zeros((n, w), dtype=I32, device=dev)

    return DenseChange(z(Lc), z(Lc + 1), z(Pc), z(Lc), z(Lc), z(Pc), z(Pc))


@lru_cache(maxsize=64)
def _arange(n: int, device: torch.device) -> torch.Tensor:
    """Read-only [1, n] int32 iota, made once per (n, device)."""
    return torch.arange(n, dtype=I32, device=device)[None, :]


def _detach_mask(c: DenseChange) -> torch.Tensor:
    """1 where the slot leaves its position (delete OR move-out)."""
    return torch.maximum(c.del_mask, (c.mov_id > 0).to(I32))


def out_len(c: DenseChange, L: torch.Tensor) -> torch.Tensor:
    """Length [N] of each changeset's output document."""
    Lc = c.del_mask.shape[-1]
    dev = c.del_mask.device
    valid = _arange(Lc, dev) < L[:, None]
    bvalid = _arange(Lc + 1, dev) <= L[:, None]
    return (L - (_detach_mask(c) * valid).sum(1, dtype=I32)
            + (c.ins_cnt * bvalid).sum(1, dtype=I32))


# -- transport primitives -----------------------------------------------------


def _scatter(pos: torch.Tensor, vals, size: int) -> torch.Tensor:
    """out[n, p] = sum of vals[n, i] where pos[n, i] == p; positions outside
    [0, size) are dropped. ``vals`` may be a Python int (every writer adds
    it)."""
    drop = (pos < 0) | (pos >= size)
    idx = torch.where(drop, size, pos).long()
    if not torch.is_tensor(vals):
        vals = torch.full_like(pos, vals)
    out = torch.zeros((pos.shape[0], size + 1), dtype=I32, device=pos.device)
    out.scatter_add_(1, idx, vals.expand_as(pos))
    return out[:, :size]


def _scatter_lanes(pos: torch.Tensor, lanes, size: int):
    """``_scatter`` of several value lanes through the same positions in
    one launch; returns one [N, size] tensor per lane."""
    drop = (pos < 0) | (pos >= size)
    idx = torch.where(drop, size, pos).long()
    vals = torch.stack(lanes, 1)  # [N, K, M]
    out = torch.zeros((pos.shape[0], len(lanes), size + 1), dtype=I32,
                      device=pos.device)
    out.scatter_add_(2, idx[:, None, :].expand_as(vals), vals)
    return out[:, :, :size].unbind(1)


def _take(vals: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """out[n, i] = vals[n, pos[n, i]], 0 where pos is outside [0, size)."""
    size = vals.shape[-1]
    ok = (pos >= 0) & (pos < size)
    got = torch.gather(vals, 1, pos.clamp(0, size - 1).long())
    return torch.where(ok, got, 0)


def _count_leq(sorted_vals: torch.Tensor, queries: torch.Tensor):
    """out[n, q] = #{j : sorted_vals[n, j] <= queries[n, q]} (the
    reference's comparison-matrix searchsorted(side='right'))."""
    return (sorted_vals[:, None, :] <= queries[:, :, None]).sum(-1, dtype=I32)


def _tag_match(mid_a, off_a, mid_b, off_b, mask_b=None) -> torch.Tensor:
    """match[n, i, j] where move tags (mid_a[i], off_a[i]) == (mid_b[j],
    off_b[j]) and the tag is real (mid > 0), restricted to ``mask_b``
    columns — the dense move-effect table."""
    m = ((mid_a[:, :, None] == mid_b[:, None, :])
         & (off_a[:, :, None] == off_b[:, None, :])
         & (mid_a[:, :, None] > 0))
    if mask_b is not None:
        m = m & mask_b[:, None, :]
    return m


def _take_match(match: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """out[n, i] = sum of vals[n, j] over match[n, i, j] (one match per row
    for well-formed changesets; 0 for matchless rows)."""
    return torch.where(match, vals[:, None, :], 0).sum(-1, dtype=I32)


def _prefix(c: DenseChange, L: torch.Tensor):
    """Shared prefix sums. Returns (valid, keep, surv_pos, Dex_b, bcum,
    icnt) where ``surv_pos[i]`` is slot i's position in c's output,
    ``Dex_b[b]`` counts detached slots before boundary b, and ``bcum[b]``
    counts attach atoms at boundaries <= b."""
    Lc = c.del_mask.shape[-1]
    dev = c.del_mask.device
    idx = _arange(Lc, dev)
    valid = idx < L[:, None]
    dmask = _detach_mask(c) * valid
    keep = valid & (dmask == 0)
    Dex_b = F.pad(torch.cumsum(dmask, 1, dtype=I32), (1, 0))  # [N, Lc+1]
    icnt = c.ins_cnt * (_arange(Lc + 1, dev) <= L[:, None])
    bcum = torch.cumsum(icnt, 1, dtype=I32)  # [N, Lc+1]
    surv_pos = idx - Dex_b[:, :Lc] + bcum[:, :Lc]
    return valid, keep, surv_pos, Dex_b, bcum, icnt


def _pool_boundaries(icnt: torch.Tensor, Pc: int):
    """Boundary b(k) of each attach-pool atom k, its validity mask and the
    pool's live atom count."""
    bcum = torch.cumsum(icnt, 1, dtype=I32)
    k = _arange(Pc, icnt.device)
    total = bcum[:, -1]
    kvalid = k < total[:, None]
    b_of_k = _count_leq(bcum, k.expand(icnt.shape[0], Pc))
    return b_of_k, kvalid, total


def _pool_positions(c: DenseChange, Dex_b: torch.Tensor, icnt: torch.Tensor):
    """Output position of every attach-pool atom: survivors before its
    boundary plus every pool atom preceding it. An unused atom's boundary
    can pass the end; its position is clamped and always masked by the
    caller."""
    Pc = c.ins_ids.shape[-1]
    b_of_k, kvalid, total = _pool_boundaries(icnt, Pc)
    dex = torch.gather(Dex_b, 1, b_of_k.clamp(0, Dex_b.shape[-1] - 1).long())
    pos = (b_of_k - dex) + _arange(Pc, icnt.device)
    return b_of_k, kvalid, pos, total


def _apply(doc_ids, L, c: DenseChange, moves: bool = True):
    """``apply_change``; ``moves=False`` when the caller knows every move
    lane is zero (the splice table then contributes nothing)."""
    Lc = doc_ids.shape[-1]
    valid, keep, surv_pos, Dex_b, _bcum, icnt = _prefix(c, L)
    _b_of_k, kvalid, ins_pos, total = _pool_positions(c, Dex_b, icnt)
    vals = c.ins_ids
    if moves:
        # Phase 1 (splice table): each move-in atom pulls the document
        # value its tag detached; plain insert atoms carry their own id.
        src = _tag_match(c.pool_mid, c.pool_off, c.mov_id, c.mov_off, valid)
        vals = torch.where(c.pool_mid > 0, _take_match(src, doc_ids), vals)
    # Phase 2: survivors and attach atoms through one prefix-sum scatter.
    pos = torch.cat([torch.where(keep, surv_pos, -1),
                     torch.where(kvalid, ins_pos, -1)], 1)
    out = _scatter(pos, torch.cat([doc_ids, vals], 1), Lc)
    new_L = (L - Dex_b[:, -1]) + total
    return out, new_L


def apply_change(doc_ids, L, c: DenseChange):
    """Apply changesets; returns (new_ids [N, Lc], new_L [N]). Output slots
    past ``Lc`` are dropped while ``new_L`` still counts them (callers
    detect the overflow from ``new_L``)."""
    return _apply(doc_ids, L, c, True)


def rebase_change(c: DenseChange, over: DenseChange, L,
                  c_after: bool = False) -> DenseChange:
    """Rebase ``c`` over concurrent ``over`` (both read the same input of
    length L); the result reads over's output. Phase 1 resolves where
    every input slot lands in over's output and which of c's move tags die
    (over deleted the unit) or cancel (both moved it and over is later,
    ``c_after=True``); phase 2 scatters the detach lanes to their landing
    positions and maps attach atoms through the monotone boundary map."""
    Lc = c.del_mask.shape[-1]
    Pc = c.ins_ids.shape[-1]
    dev = c.del_mask.device
    ovalid, okeep, of_pos, oDex_b, obcum, oicnt = _prefix(over, L)
    _ob, o_kvalid, o_ins_pos, _ot = _pool_positions(over, oDex_b, oicnt)
    cvalid = _arange(Lc, dev) < L[:, None]
    cicnt = c.ins_cnt * (_arange(Lc + 1, dev) <= L[:, None])

    # Phase 1a: landing position of every input slot in over's output.
    over_del = ovalid & (over.del_mask > 0)
    over_mov = ovalid & (over.mov_id > 0)
    dest = _tag_match(over.mov_id, over.mov_off, over.pool_mid,
                      over.pool_off, o_kvalid)
    o_dest = _take_match(dest, o_ins_pos)
    tpos = torch.where(okeep, of_pos, torch.where(over_mov, o_dest, -1))

    # Phase 1b: fate of c's move tags under over.
    c_mov = cvalid & (c.mov_id > 0)
    tag = _tag_match(c.pool_mid, c.pool_off, c.mov_id, c.mov_off)
    atom_dead = _take_match(tag, (c_mov & over_del).to(I32)) > 0
    live_mov = c_mov & (tpos >= 0)
    atom_live = atom_dead.logical_not()
    if c_after:
        cancel_slot = c_mov & over_mov
        atom_live &= ~(_take_match(tag, cancel_slot.to(I32)) > 0)
        live_mov &= ~cancel_slot

    # Phase 2a: detach lanes follow their content.
    live_del = (c.del_mask * cvalid) * (tpos >= 0)
    del_out = _scatter(torch.where(live_del > 0, tpos, -1), live_del, Lc)
    mov_id_out, mov_off_out = _scatter_lanes(
        torch.where(live_mov, tpos, -1), [c.mov_id, c.mov_off], Lc)

    # Phase 2b: boundaries b -> over-output boundary (c-before-over tie by
    # default excludes over's own attaches at b; c_after includes them).
    b_map = (_arange(Lc + 1, dev) - oDex_b
             + (obcum if c_after else obcum - oicnt))
    cb_of_k, c_kvalid, _ct = _pool_boundaries(cicnt, Pc)
    atom_b = torch.gather(b_map, 1, cb_of_k.clamp(0, Lc).long())
    atom_live &= c_kvalid
    newpos = torch.cumsum(atom_live.to(I32), 1, dtype=I32) - 1
    tgt = torch.where(atom_live, newpos, -1)
    ins_out = _scatter(torch.where(atom_live, atom_b, -1), 1, Lc + 1)
    ids_out, pmid_out, poff_out = _scatter_lanes(
        tgt, [c.ins_ids, c.pool_mid, c.pool_off], Pc)
    return DenseChange(del_out, ins_out, ids_out, mov_id_out, mov_off_out,
                       pmid_out, poff_out)


def invert_change(doc_ids, L, c: DenseChange) -> DenseChange:
    """Inverse changesets over c's output (revive values come from the
    document). Deletes invert to value-carrying re-inserts; moves invert to
    the return move — same tag, detach and attach sides swapped."""
    Lc = doc_ids.shape[-1]
    Pc = c.ins_ids.shape[-1]
    valid, _keep, surv_pos, Dex_b, _bcum, icnt = _prefix(c, L)
    _b_of_k, kvalid, ins_pos, _total = _pool_positions(c, Dex_b, icnt)
    is_min = kvalid & (c.pool_mid > 0)
    is_ins = kvalid & (c.pool_mid == 0)
    inv_del = _scatter(torch.where(is_ins, ins_pos, -1), 1, Lc)
    inv_mov_id, inv_mov_off = _scatter_lanes(
        torch.where(is_min, ins_pos, -1), [c.pool_mid, c.pool_off], Lc)
    detached = valid & (_detach_mask(c) != 0)
    inv_ins = _scatter(torch.where(detached, surv_pos, -1), 1, Lc + 1)
    dpos = torch.cumsum(detached.to(I32), 1, dtype=I32) - 1
    was_del = detached & (c.del_mask != 0)
    was_mov = detached & (c.mov_id > 0)
    inv_ids = _scatter(torch.where(was_del, dpos, -1), doc_ids, Pc)
    inv_pmid, inv_poff = _scatter_lanes(
        torch.where(was_mov, dpos, -1), [c.mov_id, c.mov_off], Pc)
    return DenseChange(inv_del, inv_ins, inv_ids, inv_mov_id, inv_mov_off,
                       inv_pmid, inv_poff)


def _compose_candidates(a: DenseChange, b: DenseChange, L):
    """Phase 1 of :func:`compose_change`: ``(cand_pos, cand_val, cand_unit,
    inplace, q2, del_out)``, the keys, values and units of the Lc + 2 Pc
    attach candidates (live below ``Lc + 2 Pc + 2``), which units stay in
    place, every unit's position in b's output and the composed delete
    lane."""
    Lc = a.del_mask.shape[-1]
    Pc = a.ins_ids.shape[-1]
    N = a.del_mask.shape[0]
    dev = a.del_mask.device
    idx = _arange(Lc, dev)
    avalid, akeep, af_pos, aDex_b, abcum, aicnt = _prefix(a, L)
    La = (L - aDex_b[:, -1]) + abcum[:, -1]
    _ab, a_kvalid, a_pos, _at = _pool_positions(a, aDex_b, aicnt)

    # Phase 1: O1 position of every input unit (a's capture table)...
    a_mov = avalid & (a.mov_id > 0)
    a_dest = _take_match(_tag_match(a.mov_id, a.mov_off, a.pool_mid,
                                    a.pool_off, a_kvalid), a_pos)
    p1 = torch.where(akeep, af_pos, torch.where(a_mov, a_dest, -1))

    # ...then the O2 position of every O1 position (b's capture table).
    bvalid, bkeep, bf_pos, bDex_b, _bbcum, bicnt = _prefix(b, La)
    _bb, b_kvalid, b_pos, _bt = _pool_positions(b, bDex_b, bicnt)
    b_mov_q = bvalid & (b.mov_id > 0)
    b_dest = _take_match(_tag_match(b.mov_id, b.mov_off, b.pool_mid,
                                    b.pool_off, b_kvalid), b_pos)
    o2_of_q = torch.where(bkeep, bf_pos, torch.where(b_mov_q, b_dest, -1))

    # b's verdict at each unit's O1 position (the +2 bias keeps "b deleted
    # it" (-1) apart from an out-of-range read (0)).
    q2 = torch.where(p1 >= 0, _take(o2_of_q + 2, p1) - 2, -1)
    b_skip_at_p1 = _take(bkeep.to(I32), p1) > 0

    alive = avalid & (q2 >= 0)
    inplace = alive & akeep & b_skip_at_p1
    moved = alive & ~inplace
    del_out = (avalid & ~alive).to(I32)

    a_is_ins = a_kvalid & (a.pool_mid == 0)
    a_atom_o2 = torch.where(
        a_is_ins, _take(o2_of_q + 2, torch.where(a_is_ins, a_pos, -1)) - 2,
        -1)
    b_is_ins = b_kvalid & (b.pool_mid == 0)

    BIG = Lc + 2 * Pc + 2
    cand_pos = torch.cat([
        torch.where(moved, q2, BIG),
        torch.where(a_is_ins & (a_atom_o2 >= 0), a_atom_o2, BIG),
        torch.where(b_is_ins, b_pos, BIG),
    ], 1)
    cand_val = torch.cat([torch.zeros((N, Lc), dtype=I32, device=dev),
                          a.ins_ids, b.ins_ids], 1)
    cand_unit = torch.cat([idx.expand(N, Lc),
                           torch.full((N, 2 * Pc), -1, dtype=I32,
                                      device=dev)], 1)
    return cand_pos, cand_val, cand_unit, inplace, q2, del_out


def compose_keys(a: DenseChange, b: DenseChange, L) -> torch.Tensor:
    """The ``[N, Lc + 2 Pc]`` candidate keys :func:`compose_change` sorts
    (live below ``Lc + 2 Pc + 2``): a hold counts its ties from them."""
    return _compose_candidates(a, b, L)[0]


def compose_change(a: DenseChange, b: DenseChange,
                   L) -> Tuple[DenseChange, torch.Tensor]:
    """Changesets equivalent to applying ``a`` then ``b``; returns
    ``(change, overflow)`` with ``overflow[n] = 1`` where the live attach
    pool exceeded ``Pc`` and the result truncated. Every unit's fate is
    resolved through both move-effect tables; units that survive out of
    place become composed moves with fresh singleton tags (pool index + 1);
    one stable sort over output positions builds the attach pool, each
    atom anchored after the last in-place unit preceding it."""
    Lc = a.del_mask.shape[-1]
    Pc = a.ins_ids.shape[-1]
    N = a.del_mask.shape[0]
    dev = a.del_mask.device
    idx = _arange(Lc, dev)
    cand_pos, cand_val, cand_unit, inplace, q2, del_out = \
        _compose_candidates(a, b, L)

    # Phase 2: one stable sort over O2 positions merges the atom sources.
    BIG = Lc + 2 * Pc + 2
    order = torch.argsort(cand_pos, dim=1, stable=True)[:, :Pc]
    pool_pos = torch.gather(cand_pos, 1, order)
    n_live = (cand_pos < BIG).sum(1, dtype=I32)
    overflow = (n_live > Pc).to(I32)
    kpool = _arange(Pc, dev)
    pool_live = kpool < n_live[:, None]
    pool_pos = torch.where(pool_live, pool_pos, BIG)
    pool_unit = torch.where(pool_live, torch.gather(cand_unit, 1, order), -1)
    is_unit_atom = pool_unit >= 0
    pool_mid_out = torch.where(is_unit_atom, kpool + 1, 0)
    pool_ids_out = torch.where(is_unit_atom | ~pool_live, 0,
                               torch.gather(cand_val, 1, order))
    mov_id_out = _scatter(torch.where(is_unit_atom, pool_unit, -1),
                          (kpool + 1).expand(N, Pc), Lc)
    # Anchor rule: the gap after the last in-place unit preceding the atom
    # (a comparison-matrix max: in-place units are monotone).
    bnd = torch.where(
        inplace[:, None, :] & (q2[:, None, :] < pool_pos[:, :, None]),
        (idx + 1)[:, None, :], 0).amax(-1)
    ins_cnt_out = _scatter(torch.where(pool_live, bnd, -1), 1, Lc + 1)
    zl = torch.zeros((N, Lc), dtype=I32, device=dev)
    zp = torch.zeros((N, Pc), dtype=I32, device=dev)
    return (DenseChange(del_out, ins_cnt_out, pool_ids_out, mov_id_out, zl,
                        pool_mid_out, zp), overflow)


# -- host <-> dense conversion (plumbing, not the hot path) ------------------


def from_marks(marks, Lc: int, Pc: int) -> Tuple[DenseChange, int]:
    """Lower a ``tree/marks.py`` changeset (values must be int ids) to one
    unbatched dense change of HOST numpy lanes; returns (change,
    input_len). Callers stack a batch and move it to the device once.
    ``mout``/``min`` lower to the move lanes (host mids are 0-based; dense
    tags are 1-based, 0 = no move)."""
    del_mask = np.zeros(Lc, np.int32)
    ins_cnt = np.zeros(Lc + 1, np.int32)
    ins_ids = np.zeros(Pc, np.int32)
    mov_id = np.zeros(Lc, np.int32)
    mov_off = np.zeros(Lc, np.int32)
    pool_mid = np.zeros(Pc, np.int32)
    pool_off = np.zeros(Pc, np.int32)
    i = 0
    p = 0
    for t, v in marks:
        if t == "skip":
            i += v
        elif t == "del":
            del_mask[i : i + len(v)] = 1
            i += len(v)
        elif t == "ins":
            ins_cnt[i] += len(v)
            ins_ids[p : p + len(v)] = v
            p += len(v)
        elif t == "mout":
            mid, start, vals = v
            mov_id[i : i + len(vals)] = mid + 1
            mov_off[i : i + len(vals)] = np.arange(
                start, start + len(vals), dtype=np.int32
            )
            i += len(vals)
        elif t == "min":
            mid, start, n = v
            ins_cnt[i] += n
            pool_mid[p : p + n] = mid + 1
            pool_off[p : p + n] = np.arange(start, start + n, dtype=np.int32)
            p += n
        else:
            from fluidframework_tpu_torch.tree.marks import _check_kind

            _check_kind(t)  # unknown kinds raise their own error first
            raise AssertionError("unreachable: _check_kind covers the IR")
    return (
        DenseChange(
            del_mask, ins_cnt, ins_ids, mov_id, mov_off, pool_mid, pool_off
        ),
        i,
    )


def doc_to_dense(doc, Lc: int) -> Tuple[np.ndarray, int]:
    """A document's ids padded to ``Lc`` (host numpy) and its length."""
    ids = np.zeros(Lc, np.int32)
    ids[: len(doc)] = doc
    return ids, len(doc)


def dense_to_doc(ids, L) -> list:
    """The first ``L`` ids of a HOST row (numpy or a CPU tensor); read a
    device batch back once and slice it, never per document."""
    return [int(x) for x in np.asarray(ids)[: int(L)]]


# -- batched entry points -----------------------------------------------------


def batch_of_one(x):
    """``x`` with a leading document axis of 1 (None stays None): one
    document's lanes as a batch for the ``batched_*`` scans."""
    return None if x is None else torch.as_tensor(x)[None]


def to_device(x, device) -> torch.Tensor:
    """An int32 tensor on ``device`` (no copy when already there)."""
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           dtype=I32, device=device)


def _change_on(c, dev) -> DenseChange:
    return DenseChange(*[to_device(x, dev) for x in c])


def _kernels():
    """The hand kernels' wrappers (``ops/tree_algebra_kernel.py``, which
    imports this module)."""
    from fluidframework_tpu_torch.ops import tree_algebra_kernel

    return tree_algebra_kernel


def batched_apply(doc_ids, L, c, device="cuda"):
    """[N] documents each through its own changeset; runs on ``device``
    (the card unless asked for the CPU): one launch of A1 on the card, the
    plain :func:`apply_change` on the CPU."""
    dev = resolve_device(device)
    args = (to_device(doc_ids, dev), to_device(L, dev), _change_on(c, dev))
    if dev.type == "cpu":
        return apply_change(*args)
    return _kernels().apply_cuda(*args)


def batched_rebase(c, over, L, c_after: bool = False, device="cuda"):
    """Each changeset of ``c`` rebased over its counterpart in ``over``:
    one launch of A2 on the card, :func:`rebase_change` on the CPU."""
    dev = resolve_device(device)
    args = (_change_on(c, dev), _change_on(over, dev), to_device(L, dev),
            bool(c_after))
    if dev.type == "cpu":
        return rebase_change(*args)
    return _kernels().rebase_cuda(*args)


def batched_invert(doc_ids, L, c, device="cuda"):
    """Each changeset's inverse: one launch of A3 on the card,
    :func:`invert_change` on the CPU."""
    dev = resolve_device(device)
    args = (to_device(doc_ids, dev), to_device(L, dev), _change_on(c, dev))
    if dev.type == "cpu":
        return invert_change(*args)
    return _kernels().invert_cuda(*args)


def batched_compose(a, b, L, device="cuda"):
    """Each pair composed, ``(change, overflow [N])``: one launch of A4 on
    the card, :func:`compose_change` on the CPU."""
    dev = resolve_device(device)
    args = (_change_on(a, dev), _change_on(b, dev), to_device(L, dev))
    if dev.type == "cpu":
        return compose_change(*args)
    return _kernels().compose_cuda(*args)
