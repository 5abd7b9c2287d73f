"""EditManager — trunk/branch changeset merging for SharedTree.

Counterpart of ``fluidframework_tpu/tree/edit_manager.py``; the host
algebra is the reference's, line for line. The device path dispatches the
port's batched EM scan (``tree/device_em.py``) on the manager's ``device``
(the card unless asked for the CPU), uploads each group once and copies
the whole result batch back to the host once per dispatch.

Reference: ``packages/dds/tree/src/core/edit-manager/editManager.ts``
(SURVEY.md Appendix B.2). State is a *trunk* of sequenced commits, a
per-session *mirror branch* reconstructing that session's authoring view,
and the local display *view* (trunk + our unacked edits).

Where the reference rebases with a sandwich compose over chain inverses —
made sound there by ChangeAtomIds + lineage marks — this design reaches the
same convergence with **cell identity + anchor transport**:

- Every inserted item is a *cell* ``(id, value)`` with a globally-unique id.
- A commit's positional marks are decoded against the author's mirrored
  view (reconstructed purely from the sequenced stream, so identical on
  every replica) into id-operations: delete-by-id (already-deleted targets
  no-op — overlapping removes) and insert runs anchored after the nearest
  left neighbor surviving on the trunk, found by walking leftward through
  the author's post-edit view (the lineage analog).
- Those id-operations apply to *any* superset sequence — the trunk, every
  mirror, and the local view all consume the same decoded ops, so no
  positional rebase (and no inverse composition) exists anywhere on the
  ingest path. Later-sequenced runs land closer to their anchor and pending
  local cells stay left of incoming runs (merge-tree tie ordering).
- The trunk form is the positional diff of the trunk cell list — a pure
  function of agreed data, so every replica derives the identical commit.

Inversion is used only to rewind concrete cell lists to an older trunk seq
(mirror creation), where it is exact.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from fluidframework_tpu_torch.ops import tree_kernel as TK
from fluidframework_tpu_torch.tree import device_em as DE
from fluidframework_tpu_torch.tree import marks as M
from fluidframework_tpu_torch.utils import pow2_at_least as _pow2
from fluidframework_tpu_torch.utils import resolve_device

Cell = Tuple[int, object]  # (cell id, value)
Run = Tuple[Optional[int], List[Cell]]  # (anchor cell id or None=front, cells)


@dataclass
class Commit:
    session: int
    seq: int
    ref: int
    change: M.Changeset  # positional marks over the author's view


@dataclass
class TrunkCommit:
    session: int
    seq: int
    ref: int
    wire: M.Changeset  # authored form (mirror replay)
    trunk_change: M.Changeset  # positional over trunk-before (rewind/apply)
    deleted_ids: Set[int]
    runs: List[Run]
    order_after: List[int]  # trunk cell ids after this commit


@dataclass
class _Branch:
    base: int  # trunk seq this mirror has integrated
    chain: List[M.Changeset] = field(default_factory=list)  # wire forms in flight
    chain_seqs: List[int] = field(default_factory=list)
    state: List[Cell] = field(default_factory=list)  # the session's view


def _attach_counts(change: M.Changeset) -> Tuple[int, int]:
    """(attach-pool cells, attach runs) of a commit: inserts AND move-ins
    — move-in cells re-attach by identity, so they add no NET length, but
    the pool and conservative length sizing must count them. Shared by
    the eligibility gate and the shape pass so the two can never drift
    (a gate admitting what the shapes can't hold would demote the whole
    stream to host replay via the kernel's capacity err)."""
    n_ins = sum(len(v) for t, v in change if t == "ins") + sum(
        v[2] for t, v in change if t == "min"
    )
    n_runs = sum(1 for t, _v in change if t in ("ins", "min"))
    return n_ins, n_runs


def apply_ops_to_view(
    view: List[Cell],
    deleted_ids: Set[int],
    runs: List[Run],
    order_after: List[int],
) -> List[Cell]:
    """Apply a trunk commit's id-operations to a view that may carry extra
    pending cells and miss locally-deleted ones. Pending (non-trunk) cells
    directly after an anchor stay left of the incoming run (they will
    sequence later — merge-tree tie ordering); runs already present (our own
    echo) are skipped; deletes are idempotent."""
    trunk_ids = set(order_after)
    out = [c for c in view if c[0] not in deleted_ids]
    present = {c[0] for c in out}
    for anchor, cells in runs:
        if cells and cells[0][0] in present:
            continue  # own echo: the run is already placed
        pos = 0
        if anchor is not None:
            pos_found = None
            ai = order_after.index(anchor)
            for j in range(ai, -1, -1):
                cid = order_after[j]
                hit = next((k for k, c in enumerate(out) if c[0] == cid), None)
                if hit is not None:
                    pos_found = hit + 1
                    break
            pos = 0 if pos_found is None else pos_found
        while pos < len(out) and out[pos][0] not in trunk_ids:
            pos += 1  # pending local cells keep their left-of-incoming spot
        out[pos:pos] = cells
        present.update(c[0] for c in cells)
    return out


class EditManager:
    # Device fast-path knobs (see add_sequenced_batch): ring depth of the
    # trunk-scan kernel, the largest dense capacity we'll compile for, the
    # smallest batch worth a device dispatch (interning + lowering +
    # kernel launch cost ~ms; tiny interactive drains stay on the host),
    # and the max insert runs per commit the EM kernel unrolls.
    DEVICE_WINDOW = 16
    DEVICE_MAX_LC = 4096
    DEVICE_MIN_BATCH = 4
    DEVICE_MAX_RUNS = 16

    def __init__(self, session: int, device="cuda"):
        self.session = session
        # Where device ingest runs; resolved at dispatch, so a manager that
        # never dispatches needs no card, and a dispatch without one raises.
        self.device = device
        self.trunk: List[TrunkCommit] = []
        self.trunk_state: List[Cell] = []
        self.branches: Dict[int, _Branch] = {}
        self.trunk_seq = 0
        self.view_state: List[Cell] = []
        self.inflight = 0  # our unacked commit count
        # Collab-window floor (advance_min_seq) — refs below it are nacked
        # by the sequencer, so it is the device ring's seeding floor.
        self.min_seq = 0
        # Oldest seq the trunk-inversion rewind reaches exactly: a device
        # batch records no per-commit trunk forms, so _state_at states
        # BELOW this replay forward from a stored anchor instead.
        self._rewind_floor = 0
        # Anchor states (seq -> concrete cell list, ascending) + the
        # device-processed commit log: together they reconstruct the
        # state at ANY admissible ref inside a device-ingested range (a
        # scratch replay — host work proportional to the collab window,
        # paid only when a lagging author actually rebases into it).
        self._anchors: List[Tuple[int, List[Cell]]] = []
        self._replay_log: List[Commit] = []
        # Synthesized id-op forms for device-logged commits (lazy, see
        # _trunk_commits_between); pruned with the log.
        self._tc_cache: Dict[int, TrunkCommit] = {}
        self._ring_seed_cache: Optional[tuple] = None
        # Last sequenced seq per session, ACROSS batches: a commit whose
        # ref precedes its author's own head was authored with a pending
        # chain (view != trunk-at-ref) and must take the host path — the
        # in-batch check alone would miss chains spanning boxcars once
        # the ring seeds states behind the current trunk head.
        self._session_heads: Dict[int, int] = {}
        # Fast-path telemetry: commits integrated by the device kernel vs
        # the host path, with the
        # host tally BROKEN DOWN by fallback cause so the remaining tail
        # is attributable: every host-path commit increments exactly
        # one reason bucket alongside ``host_commits``.
        self.device_commits = 0
        self.device_batches = 0
        self.host_commits = 0
        self.host_fallback_reason: Dict[str, int] = {
            "moves": 0,  # move-specific fallback (evicted move source,
            #              move run past the kernel's capacity)
            "pending_chain": 0,  # author had unacked own commits
            "ring_evicted": 0,  # ref behind the retained state ring
            "other_mark": 0,  # mark kind outside the wire IR
            "own_session": 0,  # own echoes (inflight bookkeeping)
            "capacity": 0,  # dense capacity / run-count limits
            "min_batch": 0,  # below DEVICE_MIN_BATCH (dispatch not worth it)
            "kernel": 0,  # device err lane without a finer cause
        }
        # Cross-batch move-id watermark: highest seq of any ingested
        # move-bearing commit. Seeds the kernel ring's watermark so a
        # ring miss that crosses a move source reports the distinct
        # ERR_MOVE_EVICTED bit (explicit fallback, never silent).
        self._move_head = -1

    # -- authoring / view -----------------------------------------------------

    def add_local(self, change: M.Changeset) -> None:
        """Record a locally-authored change (positional over the view)."""
        self.view_state = M.apply(self.view_state, change)
        self.inflight += 1

    def local_view(self) -> List[Cell]:
        return list(self.view_state)

    def set_session(self, session: int) -> None:
        self.session = session

    def reset_inflight(self, n: int) -> None:
        """Resubmission squashed the pending ops into n wire messages."""
        self.inflight = n

    # -- sequenced ingest -----------------------------------------------------

    def add_sequenced(self, commit: Commit) -> M.Changeset:
        """Ingest one sequenced commit; returns its trunk form."""
        b = self.branches.get(commit.session)
        if b is None:
            b = self.branches[commit.session] = self._make_branch(
                commit.session, commit.ref
            )
        else:
            self._advance_branch(b, commit.ref)

        tc = self._transport(commit, b.state)

        b.chain.append(commit.change)
        b.chain_seqs.append(commit.seq)
        b.state = M.apply(b.state, commit.change)
        self._session_heads[commit.session] = commit.seq
        if M.has_moves(commit.change):
            self._move_head = max(self._move_head, commit.seq)

        self.trunk.append(tc)
        self.trunk_state = M.apply(self.trunk_state, tc.trunk_change)
        self.trunk_seq = commit.seq

        # Local display view: own echoes change nothing (their effect is
        # already in the view — including edits we later undid locally);
        # concurrent commits consume the same id-operations as the trunk.
        if commit.session == self.session:
            self.inflight -= 1
        else:
            self.view_state = apply_ops_to_view(
                self.view_state, tc.deleted_ids, tc.runs, tc.order_after
            )
        if self.inflight == 0:
            self.view_state = list(self.trunk_state)  # exact resync
        return tc.trunk_change

    # -- batched sequenced ingest (the device trunk fast path) ----------------

    def add_sequenced_batch(self, commits: List[Commit], min_seq: int) -> None:
        """Ingest a run of sequenced commits, routing the maximal eligible
        prefix through the LINEAGE-AWARE device scan
        (:func:`~fluidframework_tpu_torch.tree.device_em.batched_em_trunk_scan`
        — this EditManager's own id-anchor algebra as dense kernels, so
        CONCURRENT spans ride the device too) and the remainder through
        the per-commit host path. Semantically identical to
        ``add_sequenced`` per commit + ``advance_min_seq``. (The
        positional-rebase kernel in ``tree/device_trunk.py`` remains the
        marks-algebra engine for config 3b; its tie semantics provably
        diverge from this class on concurrent gap collapses —
        ``test_tree_device_path.py::test_algebra_divergence_documented``
        — which is exactly why THIS path computes the EM algebra
        natively instead.)

        Eligibility (sound, checked host-side; the kernel's err lane
        additionally guards the state ring at runtime with transparent
        fallback):

        - ``inflight == 0`` and no own-session commits — the device scan
          computes trunk state only, which then IS the view;
        - every prefix commit is caught up on ITS OWN session (``ref >=``
          the session's head ACROSS batches — its author view is then
          exactly trunk-at-ref, the kernel's ring entry) and refs a seq
          the W-deep state ring retains (the ring seeds the retained
          doc-commit tail, so steady streaming stays eligible);
        - marks within the FULL wire vocabulary {skip, del, ins, mout,
          min} (move-bearing commits are device-native — the encoder
          lowers ``mout``/``min`` into the kernel's move lane + attach
          runs of the SAME interned cells, the id-anchor transport on
          device), run count within DEVICE_MAX_RUNS, dense capacities
          within DEVICE_MAX_LC.

        An earlier additional B-boundary ("nothing may ever rebase into a
        device range") is GONE: the anchor + replay-log machinery
        reconstructs any admissible state inside device ranges host-side
        (``_state_at`` / ``_scratch_replay``), including pipelined
        authors' mirrors (``_make_branch``), so later commits — host
        remainder or future boxcars — rebase into device ranges exactly.
        """
        if not commits:
            self.advance_min_seq(min_seq)
            return
        prefix, reason = self._device_prefix_ex(commits)
        if prefix:
            ok, err_reason = self._device_ingest(
                commits[:prefix], self._em_lowest_ref(commits)
            )
            if ok:
                commits = commits[prefix:]
            else:
                reason = err_reason
        for c in commits:
            self.add_sequenced(c)
        self._count_host(reason, len(commits))
        self.advance_min_seq(min_seq)

    def _count_host(self, reason: str, n: int = 1) -> None:
        """``n`` host-path commits, attributed to their fallback cause —
        and mirrored into the unified registry (one inc per batch) so the
        ROADMAP's fallback-bucket burn-down is visible on /metrics, not
        only in tests."""
        from fluidframework_tpu_torch.telemetry import metrics

        if not n:
            return
        self.host_commits += n
        key = reason or "kernel"
        self.host_fallback_reason[key] = (
            self.host_fallback_reason.get(key, 0) + n
        )
        metrics.tree_ingest_counter().inc(n, path="host", reason=key)
        from fluidframework_tpu_torch.telemetry import journal

        if journal._ON:
            # Flight recorder: the host_fallback_reason burn-down
            # needs per-event attribution, not just buckets — the
            # journal keeps WHICH ingest fell back and why, interleaved
            # with the op lineage that caused it.
            journal.record("tree.fallback", reason=key, n=n)

    @staticmethod
    def _err_reason(err: int) -> str:
        """Map the kernel's err bitmask to a fallback-reason bucket."""
        if err & DE.ERR_MOVE_EVICTED:
            return "moves"  # ring-evicted move source, reported explicitly
        if err & DE.ERR_RING_MISS:
            return "ring_evicted"
        if err & DE.ERR_CAPACITY:
            return "capacity"
        return "kernel"

    def _device_prefix(self, commits: List[Commit]) -> int:
        """Length of the maximal device-eligible prefix (see
        ``_device_prefix_ex``)."""
        return self._device_prefix_ex(commits)[0]

    def _device_prefix_ex(
        self, commits: List[Commit]
    ) -> Tuple[int, str]:
        """(Length of the maximal device-eligible prefix, fallback reason
        for the remainder — "" when the whole run is eligible). The
        B-boundary fixpoint (nothing may EVER rebase into a device range)
        is gone: the anchor + replay-log machinery reconstructs any
        admissible state inside device ranges host-side, so eligibility
        is purely per-commit — caught-up author (cross-batch session
        heads), ref within the ring's retained window, wire-IR marks
        (mout/min included — the has_moves host gate is retired),
        and capacity."""
        if self.inflight != 0:
            return 0, "pending_chain"
        lr = self._em_lowest_ref(commits)
        total_ins = len(self.trunk_state)
        prefix = 0
        reason = ""
        # Author caught-up checks start from the CROSS-batch session heads
        # (a chain pending since an earlier boxcar is invisible in-batch).
        last_of: Dict[int, int] = dict(self._session_heads)
        # Seqs the kernel's W-deep state ring will retain at each step —
        # seeded with the retained doc-commit tail, so commits authored
        # against the previous boxcar's states stay eligible (steady
        # streaming).
        retained = self._em_ring_seed_seqs(lr)
        for c in commits:
            if c.session == self.session:
                reason = "own_session"
                break
            if c.ref < last_of.get(c.session, 0):
                # Author had a pending chain when authoring: its view is
                # NOT trunk-at-ref; host path reconstructs the mirror.
                reason = "pending_chain"
                break
            if c.ref < retained[0]:
                # Ring would have evicted the ref state. When the evicted
                # span holds a move source the fallback is attributed to
                # moves — the host-side mirror of the kernel's
                # ERR_MOVE_EVICTED watermark bit.
                reason = (
                    "moves" if self._move_head > c.ref else "ring_evicted"
                )
                break
            if any(t not in M.DEVICE_MARK_KINDS for t, _v in c.change):
                # Mark kinds beyond the wire IR are refused loudly — with
                # mout/min device-native this only fires for foreign
                # kinds, which the host algebra rejects too.
                reason = "other_mark"
                break
            has_mv = M.has_moves(c.change)
            n_ins, n_runs = _attach_counts(c.change)
            total_ins += n_ins
            if total_ins + 8 > self.DEVICE_MAX_LC:
                reason = "moves" if has_mv else "capacity"
                break
            if n_runs > self.DEVICE_MAX_RUNS:
                reason = "moves" if has_mv else "capacity"
                break
            last_of[c.session] = c.seq
            retained.append(c.seq)
            if len(retained) > self.DEVICE_WINDOW:
                retained.pop(0)
            prefix += 1
        if prefix >= self.DEVICE_MIN_BATCH:
            return prefix, reason
        return 0, (reason or "min_batch")

    def _em_lowest_ref(self, commits: List[Commit]) -> int:
        """The run's lowest ref, clamped to what is reconstructible —
        shared by the eligibility sim and the encoder so the simulated
        ring and the seeded ring agree exactly."""
        return max(min(c.ref for c in commits), self._recon_floor())

    def _em_ring_seed_seqs(self, lowest_ref: int) -> List[int]:
        """Just the seq labels of `_em_ring_seed` — the eligibility sim
        needs no states (states cost a snapshot replay)."""
        floor = max(self._recon_floor(), min(self.trunk_seq, lowest_ref))
        events = self._doc_commit_seqs(floor)
        events = [s for s in events if s < self.trunk_seq]
        if len(events) > self.DEVICE_WINDOW - 2:
            keep = events[-(self.DEVICE_WINDOW - 2):]
            floor = keep[0]
            events = keep[1:]
        seqs = [floor] + events + [self.trunk_seq]
        if len(seqs) >= 2 and seqs[-2] == seqs[-1]:
            seqs.pop(-2)
        return seqs

    def _recon_floor(self) -> int:
        """Oldest seq _state_at reconstructs exactly: the oldest stored
        anchor when a device log exists, else the pruned collab floor."""
        if self._replay_log and self._anchors:
            return self._anchors[0][0]
        return min(self.min_seq, self.trunk_seq)

    def _doc_commit_seqs(self, above: int) -> List[int]:
        """Seqs of every document commit retained above ``above`` —
        host-path trunk commits AND device-logged commits (states between
        two of these never change, which is what makes a sparse ring
        sound: the newest-at-or-below-ref rule needs NO doc commit hidden
        between adjacent ring entries)."""
        seqs = {c.seq for c in self.trunk if c.seq > above}
        seqs.update(c.seq for c in self._replay_log if c.seq > above)
        return sorted(seqs)

    def _em_ring_seed(
        self, lowest_ref: int
    ) -> Tuple[List[int], List[List[Cell]]]:
        """The states the device ring seeds with, oldest first: the state
        at the batch's lowest admissible ref, then the post-state of each
        doc commit above it (newest W-1; the floor rises if there are
        more), ending at the current trunk. Every adjacent pair has no
        doc commit between, so the kernel's newest-at-or-below-ref hit
        rule is exact for ANY ref >= the floor. States inside device-
        ingested ranges come from one forward snapshot replay."""
        key = (
            lowest_ref, self.trunk_seq, len(self.trunk),
            len(self._replay_log), self.min_seq,
        )
        if self._ring_seed_cache and self._ring_seed_cache[0] == key:
            return self._ring_seed_cache[1]
        seqs = self._em_ring_seed_seqs(lowest_ref)
        if len(seqs) == 1:
            out = (seqs, [list(self.trunk_state)])
        else:
            floor, events = seqs[0], seqs[1:-1]
            snaps = self._states_between([floor] + events)
            out = (
                seqs,
                [snaps[floor]]
                + [snaps[s] for s in events]
                + [list(self.trunk_state)],
            )
        # One sweep calls this from both the shape pass and the encoder —
        # without the memo each device dispatch pays the scratch replay
        # twice per document.
        self._ring_seed_cache = (key, out)
        return out

    def _states_between(
        self, snap_seqs: List[int]
    ) -> Dict[int, List[Cell]]:
        """Exact states at each requested seq (one scratch replay)."""
        wanted = sorted(set(snap_seqs))
        states, _tcs = self._scratch_replay(wanted[-1], want_states=wanted)
        return states

    def _scratch_replay(
        self, hi: int, want_states: List[int] = (), want_tcs: List[int] = ()
    ) -> Tuple[Dict[int, List[Cell]], Dict[int, TrunkCommit]]:
        """ONE forward replay from the reconstruction floor (the only
        start point at or below every retained commit's ref — a scratch
        started mid-range could not serve the refs of the commits it
        replays), producing exact states and/or TrunkCommit forms at
        requested seqs.

        Host trunk commits apply their STORED positional trunk forms
        directly — exact by construction, and crucially mirror-free: a
        host commit may have been authored under a pending chain that
        straddles the replay start, which no suffix replay could
        reconstruct. Only device-logged commits re-derive through
        ``add_sequenced`` — the device eligibility rules guarantee their
        authors were caught up, so trunk-at-ref IS their authoring view."""
        start = self._recon_floor()
        ws = sorted(set(want_states))
        assert not ws or ws[0] >= start, (
            f"state at {ws[0]} below the reconstruction floor {start}"
        )
        events: List[Any] = [
            t for t in self.trunk if start < t.seq <= hi
        ]
        events += [c for c in self._replay_log if start < c.seq <= hi]
        events.sort(key=lambda e: e.seq)
        scratch = EditManager(session=-(1 << 30), device=self.device)
        base = self._state_at(start)
        scratch.trunk_state = list(base)
        scratch.view_state = list(base)
        scratch.trunk_seq = start
        states: Dict[int, List[Cell]] = {}
        tcs: Dict[int, TrunkCommit] = {}
        wt = set(want_tcs)
        wi = 0
        for ev in events:
            while wi < len(ws) and ws[wi] < ev.seq:
                states[ws[wi]] = list(scratch.trunk_state)
                wi += 1
            if isinstance(ev, TrunkCommit):
                scratch.trunk.append(ev)
                scratch.trunk_state = M.apply(
                    scratch.trunk_state, ev.trunk_change
                )
                scratch.trunk_seq = ev.seq
                scratch.view_state = list(scratch.trunk_state)
                scratch._session_heads[ev.session] = ev.seq
                tc = ev
            else:
                scratch.add_sequenced(ev)
                tc = scratch.trunk[-1]
            if ev.seq in wt:
                tcs[ev.seq] = tc
        while wi < len(ws):
            states[ws[wi]] = list(scratch.trunk_state)
            wi += 1
        return states, tcs

    def _em_shape_needs(
        self, commits: List[Commit], lowest_ref: int
    ) -> Tuple[int, int, int, int]:
        """(distinct cells incl. ring seeds, dense length need, max
        inserts per commit, n commits) — the quantities group bucket
        shapes derive from."""
        _seqs, states = self._em_ring_seed(lowest_ref)
        ids = set()
        maxlen = 0
        for st in states:
            ids.update(c[0] for c in st)
            maxlen = max(maxlen, len(st))
        max_ins = 8
        ins_total = 0
        for c in commits:
            n_ins, _n_runs = _attach_counts(c.change)
            max_ins = max(max_ins, n_ins)
            ins_total += n_ins
        return (
            len(ids) + ins_total, maxlen + ins_total, max_ins, len(commits)
        )

    def _encode_em_batch(self, commits: List[Commit], lc: int, pc: int,
                         C: int, lowest_ref: int):
        """Lower one document's commit prefix to the dense EM arrays at
        the CALLER-CHOSEN bucket shapes (a multi-document dispatch needs
        every doc at the group's shapes). Returns (cell_of, ring arrays,
        commit arrays dict)."""
        # Intern cells as dense int32 ids; values stay host-side.
        cell_of: List[Cell] = []
        idx_of: Dict[int, int] = {}

        def intern(cell: Cell) -> int:
            i = idx_of.get(cell[0])
            if i is None:
                i = idx_of[cell[0]] = len(cell_of) + 1
                cell_of.append(cell)
            return i

        W = self.DEVICE_WINDOW
        seed_seqs, seed_states = self._em_ring_seed(lowest_ref)
        ring_ids = np.zeros((W, lc), np.int32)
        ring_L = np.zeros(W, np.int32)
        ring_seq = np.full(W, -1, np.int32)
        k0 = W - len(seed_seqs)
        for j, (sq, st) in enumerate(zip(seed_seqs, seed_states)):
            ids = [intern(c) for c in st]
            ring_ids[k0 + j, : len(ids)] = ids
            ring_L[k0 + j] = len(ids)
            ring_seq[k0 + j] = sq
        R = self.DEVICE_MAX_RUNS
        dm = np.zeros((C, lc), np.int32)
        mv = np.zeros((C, lc), np.int32)
        ic = np.zeros((C, lc + 1), np.int32)
        ii = np.zeros((C, pc), np.int32)
        r_start = np.full((C, R), -1, np.int32)
        r_len = np.zeros((C, R), np.int32)
        r_off = np.zeros((C, R), np.int32)
        refs = np.zeros(C, np.int32)
        seqs = np.zeros(C, np.int32)
        for k, c in enumerate(commits):
            # Move streams are wire-complete per commit: every min's cells
            # come from the commit's own mout marks (which carry values),
            # so the lowering needs one pre-pass, not the author view.
            vals_of: Dict[Tuple[int, int], Cell] = {}
            for t, v in c.change:
                if t == "mout":
                    mid, start, vals = v
                    for j, cell in enumerate(vals):
                        vals_of[(mid, start + j)] = tuple(cell)
            i_in = 0  # position in the author view (input coords)
            i_out = 0  # position in the post view (run starts live here)
            p = 0
            r = 0
            for t, v in c.change:
                if t == "skip":
                    i_in += v
                    i_out += v
                elif t == "del":
                    dm[k, i_in : i_in + len(v)] = 1
                    i_in += len(v)
                elif t == "mout":
                    # Detaches like a delete but rides the dedicated move
                    # lane (feeds the kernel's move-id watermark).
                    mv[k, i_in : i_in + len(v[2])] = 1
                    i_in += len(v[2])
                else:  # ins / min — both are attach runs
                    cells = (
                        v if t == "ins"
                        else [vals_of[(v[0], v[1] + j)] for j in range(v[2])]
                    )
                    ic[k, i_in] += len(cells)
                    r_start[k, r] = i_out
                    r_len[k, r] = len(cells)
                    r_off[k, r] = p
                    r += 1
                    for cell in cells:
                        ii[k, p] = intern(tuple(cell))
                        p += 1
                    i_out += len(cells)
            refs[k] = c.ref
            seqs[k] = c.seq
        # Identity padding: empty commits advancing seq keep shapes pow2
        # (k >= len(commits) >= DEVICE_MIN_BATCH, so seqs[k-1] is set).
        for k in range(len(commits), C):
            refs[k] = seqs[k - 1]
            seqs[k] = seqs[k - 1] + 1
        arrays = {
            "dm": dm, "mv": mv, "ic": ic, "ii": ii, "rs": r_start,
            "rl": r_len, "ro": r_off, "refs": refs, "seqs": seqs,
        }
        return cell_of, (ring_ids, ring_L, ring_seq), arrays

    def _apply_em_result(self, commits: List[Commit], cell_of: List[Cell],
                         out_ids, out_L, err) -> Tuple[bool, str]:
        """Commit one document's scan result. (False, reason) with state
        untouched when the kernel's err lane tripped — the caller replays
        the same commits on the host path, attributed to the err bit's
        fallback bucket. The result rows are host numpy."""
        err = int(err)
        if err:
            # ring miss / capacity / evicted move source: host replays
            return False, self._err_reason(err)
        # Anchor the PRE-batch collab-floor state + log the batch's
        # commits: that is what _state_at replays when a later host-path
        # commit rebases into this (trunk-form-free) range. The anchor
        # sits at the floor — every future ref is at or above it (the
        # sequencer nacks below the collab window, which only advances).
        a_seq = min(self.min_seq, self.trunk_seq)
        if all(s != a_seq for s, _st in self._anchors):
            self._anchors.append((a_seq, self._state_at(a_seq)))
            self._anchors.sort(key=lambda t: t[0])
        self._replay_log.extend(commits)
        final = TK.dense_to_doc(out_ids, out_L)
        self.trunk_state = [cell_of[i - 1] for i in final]
        self.trunk_seq = commits[-1].seq
        self._rewind_floor = self.trunk_seq
        self.view_state = list(self.trunk_state)  # inflight == 0
        for c in commits:
            self._session_heads[c.session] = c.seq
            if M.has_moves(c.change):
                self._move_head = max(self._move_head, c.seq)
        # No per-commit trunk forms were recorded: drop mirrors (they are
        # all behind the prefix boundary and would be pruned by the
        # advance anyway); future commits rebuild from _state_at(ref >= B).
        self.branches.clear()
        self.device_commits += len(commits)
        self.device_batches += 1
        from fluidframework_tpu_torch.telemetry import metrics

        metrics.tree_ingest_counter().inc(
            len(commits), path="device", reason=""
        )
        return True, ""

    def _device_ingest(self, commits: List[Commit], lr: int) -> Tuple[bool, str]:
        """Run the prefix through the lineage-aware EM scan
        (``tree/device_em.py`` — this class's own algebra as dense
        kernels) as a group of one. Returns (False, reason) — with state
        untouched — when the kernel's err lane trips (ring miss /
        capacity / evicted move source), and the caller replays the same
        commits on the host path."""
        total, lc_need, max_ins, n = self._em_shape_needs(commits, lr)
        lc = _pow2(max(lc_need + 8, 32))
        pc = _pow2(max_ins)
        C = _pow2(n)
        cell_of, (ring_ids, ring_L, ring_seq), a = self._encode_em_batch(
            commits, lc, pc, C, lr
        )
        U = _pow2(len(cell_of) + 2)
        out_ids, out_L, err = _em_dispatch(
            (ring_ids[None], ring_L[None], ring_seq[None]),
            np.asarray([self._move_head], np.int32),
            {k: v[None] for k, v in a.items()}, U, self.device,
        )
        return self._apply_em_result(
            commits, cell_of, out_ids[0], out_L[0], err[0]
        )

    def advance_min_seq(self, min_seq: int) -> None:
        """Prune trunk commits at or below the collab-window floor; drop
        mirror branches that are fully integrated behind it. When a
        device replay log exists, pruned trunk commits demote into it
        (their wire forms remain replay events) and the log/anchor pair
        prunes to the newest anchor that can still serve every retained
        ref."""
        self.min_seq = max(self.min_seq, min(min_seq, self.trunk_seq))
        dropped = [c for c in self.trunk if c.seq <= min_seq]
        self.trunk = [c for c in self.trunk if c.seq > min_seq]
        if self._replay_log or self._anchors:
            # Demote pruned trunk commits WITH their exact trunk forms: a
            # pending-chain commit can never be re-derived from a suffix
            # replay, so the scratch must direct-apply the stored form.
            self._replay_log.extend(dropped)
            self._replay_log.sort(key=lambda c: c.seq)
            refs_above = sorted(
                [(c.seq, c.ref) for c in self._replay_log]
                + [(t.seq, t.ref) for t in self.trunk]
            )

            def serves(a: int) -> bool:
                return all(r >= a for s, r in refs_above if s > a)

            for s, _st in reversed(self._anchors):
                if s <= self.min_seq and serves(s):
                    self._anchors = [
                        (a, st) for a, st in self._anchors if a >= s
                    ]
                    self._replay_log = [
                        c for c in self._replay_log if c.seq > s
                    ]
                    self._tc_cache = {
                        q: t for q, t in self._tc_cache.items() if q > s
                    }
                    break
        for session in list(self.branches):
            b = self.branches[session]
            if b.base <= min_seq and all(s <= min_seq for s in b.chain_seqs):
                del self.branches[session]
        # Session-head entries at or below the floor can never decide the
        # `ref < last_of` eligibility check again (the sequencer nacks
        # refs below the collab window) — drop them, or ephemeral-client
        # churn grows this map forever.
        for session, head in list(self._session_heads.items()):
            if head <= min_seq:
                del self._session_heads[session]


    # -- internals ------------------------------------------------------------

    def _state_at(self, seq: int) -> List[Cell]:
        """Concrete trunk cell list at trunk seq. At or above the rewind
        floor: invert retained trunk commits. Below it (inside a
        device-ingested range, which records no trunk forms): one forward
        snapshot replay from the reconstruction floor — exact, host-side,
        and paid only when a lagging author actually rebases into the
        range."""
        for s, st in self._anchors:
            if s == seq:
                return list(st)
        if seq >= self._rewind_floor or not self._replay_log:
            state = list(self.trunk_state)
            for c in reversed(self.trunk):
                if c.seq <= seq:
                    break
                state = M.apply(state, M.invert(c.trunk_change))
            return state
        return self._states_between([seq])[seq]

    def _make_branch(self, session: int, ref: int) -> _Branch:
        """A session's mirror as of a commit reffing ``ref``. Normally
        that is trunk-at-ref — but a PIPELINING author may have own
        sequenced commits it had not yet processed when authoring (a
        pending chain; its mirror may have been dropped by a device
        batch's ``branches.clear()``). Rebuild exactly as the incremental
        path would have: start at the oldest pending own commit's ref,
        then alternate id-op advances with chain appends."""
        own = sorted(
            (
                e for e in list(self.trunk) + list(self._replay_log)
                if e.session == session and e.seq > ref
            ),
            key=lambda e: e.seq,
        )
        if not own:
            return _Branch(base=ref, state=self._state_at(ref))
        b = _Branch(base=own[0].ref, state=self._state_at(own[0].ref))
        for oc in own:
            self._advance_branch(b, oc.ref)
            wire = oc.wire if isinstance(oc, TrunkCommit) else oc.change
            b.chain.append(wire)
            b.chain_seqs.append(oc.seq)
            b.state = M.apply(b.state, wire)
        self._advance_branch(b, ref)
        return b

    def _advance_branch(self, b: _Branch, to: int) -> None:
        """Mirror the session's own processing of trunk commits in
        (base, to]: own acks pop the chain head (view unchanged; exact
        resync when the chain empties); concurrent commits apply their
        id-operations to the mirrored view. The walked stream merges
        host trunk entries with id-op forms synthesized for
        device-logged commits — a mirror advancing across a device-
        ingested range must see those commits too."""
        for t in self._trunk_commits_between(b.base, to):
            if b.chain_seqs and b.chain_seqs[0] == t.seq:
                b.chain.pop(0)
                b.chain_seqs.pop(0)
                if not b.chain:
                    b.state = self._state_at(t.seq)
            else:
                b.state = apply_ops_to_view(
                    b.state, t.deleted_ids, t.runs, t.order_after
                )
        b.base = max(b.base, to)

    def _trunk_commits_between(self, lo: int, hi: int) -> List[TrunkCommit]:
        """TrunkCommit stream in (lo, hi], seq-ascending: retained host
        trunk entries plus forms synthesized — and cached — for
        device-logged commits via one scratch replay (the device path
        records none; a lagging mirror is the one consumer that still
        needs them)."""
        need = sorted(
            c.seq for c in self._replay_log
            if lo < c.seq <= hi and not isinstance(c, TrunkCommit)
            and c.seq not in self._tc_cache
        )
        if need:
            _states, tcs = self._scratch_replay(need[-1], want_tcs=need)
            self._tc_cache.update(tcs)
        out = [t for t in self.trunk if lo < t.seq <= hi]
        out += [
            c if isinstance(c, TrunkCommit) else self._tc_cache[c.seq]
            for c in self._replay_log
            if lo < c.seq <= hi
        ]
        out.sort(key=lambda t: t.seq)
        return out

    def _transport(self, commit: Commit, pre: List[Cell]) -> TrunkCommit:
        """Decode a commit authored on view ``pre`` into id-operations and
        its positional trunk form (the id-anchor transport). Move marks
        lower to detach + re-attach of the SAME cell ids
        (``marks.lower_moves``): the id algebra anchors by cell identity,
        so a moved run re-anchors at its destination exactly like an
        insert of those ids — convergent by the same argument."""
        post = M.apply(pre, commit.change)
        change = M.lower_moves(commit.change)

        deleted_ids: Set[int] = set()
        raw_runs: List[Tuple[int, List[Cell]]] = []  # (start in post, cells)
        i_out = 0
        for t, v in change:
            if t == "skip":
                i_out += v
            elif t == "del":
                deleted_ids.update(cid for cid, _ in v)
            else:
                raw_runs.append((i_out, [tuple(c) for c in v]))
                i_out += len(v)

        trunk_ids = {cid for cid, _ in self.trunk_state}
        out: List[Cell] = [
            c for c in self.trunk_state if c[0] not in deleted_ids
        ]
        placed: Set[int] = set()
        runs: List[Run] = []
        for start, cells in raw_runs:
            anchor = None
            j = start - 1
            while j >= 0:
                cid = post[j][0]
                if (cid in trunk_ids and cid not in deleted_ids) or cid in placed:
                    anchor = cid
                    break
                j -= 1
            runs.append((anchor, cells))
            if anchor is None:
                out[0:0] = cells
            else:
                pos = next(k + 1 for k, c in enumerate(out) if c[0] == anchor)
                out[pos:pos] = cells
            placed.update(cid for cid, _ in cells)

        return TrunkCommit(
            session=commit.session,
            seq=commit.seq,
            ref=commit.ref,
            wire=commit.change,
            trunk_change=_diff_cells(self.trunk_state, out, deleted_ids),
            deleted_ids=deleted_ids,
            runs=runs,
            order_after=[c[0] for c in out],
        )


def _diff_cells(
    old: List[Cell], new: List[Cell], deleted_ids: Set[int]
) -> M.Changeset:
    """Positional changeset old -> new. Cells present in both keep their
    identity: the longest increasing subsequence of shared ids (by old
    position, in new order) stays as skips; every other shared cell —
    REORDERED content, i.e. a move — expresses as delete at its old spot
    + re-insert of the same id at its new spot (the lowered move form the
    id-anchor transport and resubmission squash both consume). Ids only
    in old delete; ids only in new insert."""
    old_pos = {c[0]: k for k, c in enumerate(old)}
    shared = [
        (old_pos[c[0]], c[0]) for c in new
        if c[0] in old_pos and c[0] not in deleted_ids
    ]
    # Patience LIS over old positions (in new order): the maximal set of
    # shared cells whose relative order is unchanged.
    import bisect

    tails: List[int] = []  # tails[k] = smallest ending old-pos of len-k+1
    tail_ids: List[int] = []
    prev: Dict[int, Optional[int]] = {}
    for pos, cid in shared:
        k = bisect.bisect_left(tails, pos)
        prev[cid] = tail_ids[k - 1] if k else None
        if k == len(tails):
            tails.append(pos)
            tail_ids.append(cid)
        else:
            tails[k] = pos
            tail_ids[k] = cid
    kept: Set[int] = set()
    cur: Optional[int] = tail_ids[-1] if tail_ids else None
    while cur is not None:
        kept.add(cur)
        cur = prev[cur]

    change: M.Changeset = []
    oi = 0
    for cell in new:
        if cell[0] in kept:
            while oi < len(old) and old[oi][0] != cell[0]:
                change.append(M.delete([old[oi]]))
                oi += 1
            change.append(M.skip(1))
            oi += 1
        else:
            change.append(M.insert([cell]))
    while oi < len(old):
        change.append(M.delete([old[oi]]))
        oi += 1
    return M.normalize(change)



def batch_ingest(
    items: List[Tuple["EditManager", List[Commit], int]],
) -> Dict[str, int]:
    """Cross-DOCUMENT device ingest: one kernel dispatch for many
    documents' sequenced runs (``batched_em_trunk_scan`` batches a
    document axis that ``add_sequenced_batch`` feeds one doc at a
    time). ``items`` is (manager, commits, min_seq) per document.

    Each manager's device-eligible prefix is computed exactly as the
    single-doc path does (``_device_prefix`` — the soundness contract is
    unchanged), every eligible prefix is lowered at the GROUP's bucket
    shapes, and one batched scan integrates them all; a document whose
    err lane trips replays on its host path, as do remainders and
    ineligible documents. Semantics are identical to calling
    ``add_sequenced_batch(commits, min_seq)`` per manager.

    Returns {"device_docs", "device_commits", "host_commits"} for the
    dispatch-accounting the serving layer reports. The dispatch runs on
    the managers' device (every manager of a dispatch names the same one).
    """
    stats = {"device_docs": 0, "device_commits": 0, "host_commits": 0}
    plans = []  # (em, commits, min_seq, prefix, device_ok, reason)
    for em, commits, min_seq in items:
        prefix, reason = (
            em._device_prefix_ex(commits) if commits else (0, "")
        )
        plans.append([em, commits, min_seq, prefix, False, reason])
    elig = [p for p in plans if p[3]]
    if elig:
        needs = [
            p[0]._em_shape_needs(p[1][: p[3]], p[0]._em_lowest_ref(p[1]))
            for p in elig
        ]
        lc = _pow2(max(max(ln + 8, 32) for _t, ln, _m, _n in needs))
        pc = _pow2(max(m for _t, _ln, m, _n in needs))
        C = _pow2(max(n for _t, _ln, _m, n in needs))
        U = _pow2(max(t for t, _ln, _m, _n in needs) + 2)
        enc = [
            p[0]._encode_em_batch(
                p[1][: p[3]], lc, pc, C, p[0]._em_lowest_ref(p[1])
            )
            for p in elig
        ]
        ring_ids = np.stack([e[1][0] for e in enc])
        ring_L = np.stack([e[1][1] for e in enc])
        ring_seq = np.stack([e[1][2] for e in enc])
        mov_seq0 = np.asarray([p[0]._move_head for p in elig], np.int32)
        stacked = {
            k: np.stack([e[2][k] for e in enc]) for k in enc[0][2]
        }
        devices = {str(p[0].device) for p in elig}
        if len(devices) != 1:
            raise ValueError(f"batch_ingest over managers on several "
                             f"devices: {sorted(devices)}")
        out_ids, out_L, err = _em_dispatch(
            (ring_ids, ring_L, ring_seq), mov_seq0, stacked, U,
            elig[0][0].device,
        )
        for i, p in enumerate(elig):
            ok, err_reason = p[0]._apply_em_result(
                p[1][: p[3]], enc[i][0], out_ids[i], out_L[i], err[i]
            )
            p[4] = ok
            if ok:
                stats["device_docs"] += 1
                stats["device_commits"] += p[3]
            else:
                p[5] = err_reason
    for em, commits, min_seq, prefix, device_ok, reason in plans:
        rest = commits[prefix:] if device_ok else commits
        for c in rest:
            em.add_sequenced(c)
        em._count_host(reason, len(rest))
        stats["host_commits"] += len(rest)
        em.advance_min_seq(min_seq)
    return stats


def _em_dispatch(rings, mov_seq0, arrays, U: int, device):
    """One dispatch of the EM scan for a stacked group: host numpy lanes
    in (uploaded once), host numpy ``(out_ids, out_L, err)`` out, through
    one copy of the whole result batch."""
    dev = resolve_device(device)
    ring_ids, ring_L, ring_seq = rings
    out_ids, out_L, err = DE.batched_em_trunk_scan_ring(
        ring_ids, ring_L, ring_seq, mov_seq0,
        DE.EmCommitBatch(
            arrays["dm"], arrays["ic"], arrays["ii"], arrays["rs"],
            arrays["rl"], arrays["ro"], arrays["refs"], arrays["seqs"],
            arrays["mv"],
        ),
        U, device=dev,
    )
    Lc = out_ids.shape[1]
    host = torch.cat([out_ids, out_L[:, None], err[:, None]], 1).to(
        "cpu", copy=True).numpy()
    return host[:, :Lc], host[:, Lc], host[:, Lc + 1]
