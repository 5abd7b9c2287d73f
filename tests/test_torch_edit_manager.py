"""The port's EditManager against the reference, call for call.

Both packages' managers ingest the same sequenced commits — the
reference's device path as XLA on the CPU, the port's with
``device="cpu"`` — through ``add_sequenced_batch`` (waves, as SharedTree
drains its boxcar) and ``batch_ingest`` (many documents, one dispatch).
After every call the trunk, the view, the sequence state and the
device/host split (``device_commits``, ``device_batches``,
``host_commits``, ``host_fallback_reason``) must be equal.
"""

import copy

import numpy as np
import pytest
import torch

from fluidframework_tpu.tree import edit_manager as REM
from fluidframework_tpu.tree import marks as RM
from fluidframework_tpu_torch.tree import edit_manager as TEM
from fluidframework_tpu_torch.tree import marks as M
from test_tree_device_path import _rand_change, simulate, simulate_bounded

CPU = "cpu"


def port_commits(log):
    return [TEM.Commit(session=c.session, seq=c.seq, ref=c.ref,
                       change=copy.deepcopy(c.change)) for c in log]


def state(em):
    return (em.trunk_state, em.view_state, em.trunk_seq, em.min_seq,
            em.inflight, em._move_head, em.device_commits,
            em.device_batches, em.host_commits,
            dict(em.host_fallback_reason))


class Pair:
    """One reference and one port manager driven in lockstep."""

    def __init__(self, session=1):
        self.ref = REM.EditManager(session=session)
        self.port = TEM.EditManager(session=session, device=CPU)

    def batch(self, log, min_seq):
        self.ref.add_sequenced_batch(list(log), min_seq)
        self.port.add_sequenced_batch(port_commits(log), min_seq)
        assert state(self.port) == state(self.ref)


def ingest_both(pairs, chunks, min_seqs):
    ref = REM.batch_ingest([(p.ref, list(c), m)
                            for p, c, m in zip(pairs, chunks, min_seqs)])
    got = TEM.batch_ingest([(p.port, port_commits(c), m)
                            for p, c, m in zip(pairs, chunks, min_seqs)])
    assert got == ref
    for p in pairs:
        assert state(p.port) == state(p.ref)
    return got


@pytest.mark.parametrize("seed", range(4))
def test_add_sequenced_batch_on_concurrent_streams(seed):
    pair = Pair()
    log = simulate(seed + 10, n_commits=24, max_lag=6)
    pair.batch(log, log[-1].seq)
    assert pair.port.device_commits > 0


@pytest.mark.parametrize("move_prob", [0.05, 0.25])
@pytest.mark.parametrize("seed", range(2))
def test_add_sequenced_batch_in_waves_with_moves(seed, move_prob):
    """The config-3c stream shape in waves of 16 with a trailing collab
    floor: ring seeds from earlier waves, moves on the device."""
    pair = Pair()
    log = simulate_bounded(seed * 7 + 300, n_commits=40, move_prob=move_prob)
    for w0 in range(0, len(log), 16):
        chunk = log[w0:w0 + 16]
        pair.batch(chunk, max(0, chunk[-1].seq - 8))
    assert pair.port.device_commits >= len(log) // 2


@pytest.mark.parametrize("move_prob", [0.0, 0.05])
def test_batch_ingest_groups_documents_like_reference(move_prob):
    """Eligible, concurrent and tiny (below DEVICE_MIN_BATCH) documents in
    one group, then a second wave that seeds each ring from the first."""
    logs = [simulate_bounded(500 + d, 32, move_prob) for d in range(3)]
    logs += [simulate(520 + d, n_commits=32, max_lag=(0 if d else 6),
                      move_prob=move_prob) for d in range(2)]
    pairs = [Pair() for _ in logs]
    first = ingest_both(pairs, [lg[:16] for lg in logs],
                        [max(0, lg[15].seq - 8) for lg in logs])
    assert first["device_docs"] >= 3
    tiny = simulate(530, n_commits=2)
    pairs.append(Pair())
    ingest_both(pairs, [lg[16:] for lg in logs] + [tiny],
                [lg[-1].seq for lg in logs] + [tiny[-1].seq])
    assert pairs[-1].port.host_fallback_reason["min_batch"] == 2


def test_fallback_reasons_match_reference():
    """A pipelined author (pending chain) and a ref behind a pruned
    move source fall back for the same reasons on both sides."""
    base = simulate(41, n_commits=12, max_lag=0)
    head = base[-1].seq
    obs = REM.EditManager(session=1)
    for c in base:
        obs.add_sequenced(c)
    nid = [70_000]
    rng = np.random.default_rng(5)
    c1 = _rand_change(rng, obs.local_view(), 9, nid)
    c2 = _rand_change(rng, RM.apply(obs.local_view(), c1), 9, nid)
    log = base + [REM.Commit(session=900, seq=head + 1, ref=head, change=c1),
                  REM.Commit(session=900, seq=head + 2, ref=head, change=c2)]
    pair = Pair()
    pair.batch(log, 0)
    assert pair.port.host_fallback_reason["pending_chain"] >= 1

    moved = simulate(77, n_commits=30, max_lag=0, move_prob=0.5)
    pair = Pair()
    pair.batch(moved, moved[-1].seq)
    late = [REM.Commit(session=950 + j, seq=moved[-1].seq + j, ref=2,
                       change=RM.normalize([RM.insert([(888800 + j, j)])]))
            for j in range(1, 6)]
    assert pair.port._device_prefix_ex(port_commits(late)) == (0, "moves")
    pair.batch(late, 0)
    assert pair.port.host_fallback_reason["moves"] == 5


def test_dispatch_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    log = port_commits(simulate(90, n_commits=8, max_lag=0))
    em = TEM.EditManager(session=1)
    assert em.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        em.add_sequenced_batch(log, log[-1].seq)
    # A host-only ingest (below DEVICE_MIN_BATCH) never dispatches.
    em = TEM.EditManager(session=1)
    em.add_sequenced_batch(log[:2], 0)
    assert em.host_commits == 2
    with pytest.raises(RuntimeError, match="CUDA"):
        TEM.batch_ingest([(TEM.EditManager(session=1), list(log), 0)])
    mixed = [(TEM.EditManager(session=1, device=d), list(log), 0)
             for d in ("cpu", "meta")]
    with pytest.raises(ValueError, match="several devices"):
        TEM.batch_ingest(mixed)
    assert M.DEVICE_MARK_KINDS == RM.DEVICE_MARK_KINDS
