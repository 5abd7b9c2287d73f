"""Concurrent tree-commit stream generation + host reference trunk.

Shared by the device-trunk parity tests and the config-3 device bench:
streams of sequenced commits where sessions lag the head by < W commits
(see tree/device_trunk.py), plus the host rebase-based trunk fold they are
checked against (the reference EditManager algorithm)."""

from __future__ import annotations

import numpy as np

from fluidframework_tpu_torch.ops import tree_kernel as TK
from fluidframework_tpu_torch.tree import marks as M
from fluidframework_tpu_torch.tree.device_trunk import CommitBatch


def host_trunk(commits):
    """Fold sequenced commits through the rebase-based trunk: each commit
    rebases over every trunk commit after its ref, then applies."""
    state: list = []
    trunk: list = []  # (seq, trunk_form)
    for k, (ref, c) in enumerate(commits, 1):
        for seq_j, t_j in trunk:
            if seq_j > ref:
                c = M.rebase(c, t_j)
        state = M.apply(state, c)
        trunk.append((k, c))
    return state


def gen_streams(
    rng, n_docs, n_commits, n_sessions, W, Lc, max_ins=16, move_prob=0.0
):
    """Concurrent commit streams: sessions lag behind the head by < W and
    always cover their own previous commit (see device_trunk docstring).
    ``max_ins`` bounds inserted items per commit (dense pool capacity);
    document length is hard-bounded below Lc so every rebased/applied form
    stays inside the fixed-shape IR. ``move_prob`` mixes in first-class
    move commits (mout/min — the dense IR's move lanes)."""
    all_commits = []
    for _d in range(n_docs):
        trunk_states = [[]]  # state after seq k
        last_of = [0] * n_sessions
        commits = []
        commits_trunk = []  # trunk forms, for host-side ref tracking
        next_id = 1
        state = []
        for k in range(1, n_commits + 1):
            s = int(rng.integers(0, n_sessions))
            lag = int(rng.integers(0, W - 1))
            ref = max(k - 1 - lag, last_of[s])
            view = trunk_states[ref]
            if move_prob and len(view) >= 4 and rng.random() < move_prob:
                i0 = int(rng.integers(0, len(view) - 1))
                cnt = int(rng.integers(1, min(3, len(view) - i0) + 1))
                dest = int(rng.integers(0, len(view) - cnt + 1))
                cells = view[i0 : i0 + cnt]
                if dest <= i0:
                    c = [M.skip(dest), M.move_in(0, cnt),
                         M.skip(i0 - dest), M.move_out(0, cells)]
                else:
                    c = [M.skip(i0), M.move_out(0, cells),
                         M.skip(dest - i0), M.move_in(0, cnt)]
                c = M.normalize(c)
                ct = c
                for seq_j in range(ref + 1, k):
                    ct = M.rebase(ct, commits_trunk[seq_j - 1])
                state = M.apply(state, ct)
                trunk_states.append(list(state))
                commits_trunk.append(ct)
                commits.append((ref, c))
                last_of[s] = k
                continue
            c = []
            i = 0
            ins_left = max_ins
            # Bias toward deletes when long so capacity bounds hold; stop
            # inserting once the pool budget or the length bound is near
            # (concurrent sessions can each add ~max_ins before rebasing).
            may_ins = (
                lambda: ins_left >= 2
                and len(view) + (max_ins * n_sessions) < Lc - 4
            )
            while i < len(view):
                r = rng.random()
                run = min(int(rng.integers(1, 3)), len(view) - i)
                if r < (0.55 if len(view) > Lc // 3 else 0.3):
                    c.append(M.delete(view[i : i + run]))
                    i += run
                elif r < 0.75 or not may_ins():
                    c.append(M.skip(run))
                    i += run
                else:
                    n = int(rng.integers(1, 3))
                    c.append(M.insert(list(range(next_id, next_id + n))))
                    next_id += n
                    ins_left -= n
            if (rng.random() < 0.5 or not c) and may_ins():
                n = int(rng.integers(1, 3))
                c.append(M.insert(list(range(next_id, next_id + n))))
                next_id += n
            elif not c:
                c.append(M.skip(0))
            c = M.normalize(c)
            # Sequence it host-side to maintain trunk states for refs.
            ct = c
            for seq_j in range(ref + 1, k):
                ct = M.rebase(ct, commits_trunk[seq_j - 1])
            state = M.apply(state, ct)
            trunk_states.append(list(state))
            commits_trunk.append(ct)
            commits.append((ref, c))
            last_of[s] = k
        all_commits.append(commits)
    return all_commits


def to_device_batch(all_commits, Lc, Pc):
    n_docs = len(all_commits)
    C = len(all_commits[0])
    dm = np.zeros((n_docs, C, Lc), np.int32)
    ic = np.zeros((n_docs, C, Lc + 1), np.int32)
    ii = np.zeros((n_docs, C, Pc), np.int32)
    mid = np.zeros((n_docs, C, Lc), np.int32)
    moff = np.zeros((n_docs, C, Lc), np.int32)
    pmid = np.zeros((n_docs, C, Pc), np.int32)
    poff = np.zeros((n_docs, C, Pc), np.int32)
    refs = np.zeros((n_docs, C), np.int32)
    seqs = np.broadcast_to(
        np.arange(1, C + 1, dtype=np.int32), (n_docs, C)
    ).copy()
    for d, commits in enumerate(all_commits):
        for k, (ref, c) in enumerate(commits):
            dc, _ = TK.from_marks(c, Lc, Pc)
            dm[d, k] = np.asarray(dc.del_mask)
            ic[d, k] = np.asarray(dc.ins_cnt)
            ii[d, k] = np.asarray(dc.ins_ids)
            mid[d, k] = np.asarray(dc.mov_id)
            moff[d, k] = np.asarray(dc.mov_off)
            pmid[d, k] = np.asarray(dc.pool_mid)
            poff[d, k] = np.asarray(dc.pool_off)
            refs[d, k] = ref
    return CommitBatch(dm, ic, ii, refs, seqs, mid, moff, pmid, poff)


