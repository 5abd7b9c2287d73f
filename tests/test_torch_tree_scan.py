"""The port's device trunk scans against the reference, bit for bit.

``batched_trunk_scan`` (the positional-rebase scan of config 3b) runs on
``gen_streams`` streams, including a scan ring shallower than the streams'
lag so refs fall behind it and set the err lane; ``batched_em_trunk_scan``
and ``batched_em_trunk_scan_ring`` (the EditManager's lineage scan) run on
streams lowered by the reference's own encoder and on raw lanes that reach
all three ``ERR_*`` bits. The reference runs as XLA on the CPU, the port
with ``device="cpu"``; documents, lengths and err lanes must be equal.
"""

import numpy as np
import pytest
import torch

from fluidframework_tpu.testing import tree_streams as RS
from fluidframework_tpu.tree import device_em as RE
from fluidframework_tpu.tree import device_trunk as RT
from fluidframework_tpu.tree.edit_manager import EditManager as RefEM
from fluidframework_tpu.utils import pow2_at_least
from fluidframework_tpu_torch import interop
from fluidframework_tpu_torch.ops import tree_kernel as TK
from fluidframework_tpu_torch.testing import tree_streams as TS
from fluidframework_tpu_torch.tree import device_em as DE
from fluidframework_tpu_torch.tree import device_trunk as DT
from test_tree_device_path import simulate, simulate_bounded

CPU = "cpu"


def same(ref, got, what=""):
    for i, (r, g) in enumerate(zip(ref, got)):
        r = np.asarray(r)
        assert g.dtype == torch.int32 and r.dtype == np.int32, what
        np.testing.assert_array_equal(g.numpy(), r, err_msg=f"{what}[{i}]")


def streams(seed, n_docs, n_commits, W, Lc, move_prob):
    rng = np.random.default_rng(seed)
    return RS.gen_streams(rng, n_docs, n_commits, n_sessions=3, W=W, Lc=Lc,
                          max_ins=8, move_prob=move_prob)


@pytest.mark.parametrize("move_prob", [0.0, 0.2])
@pytest.mark.parametrize("scan_w", [8, 3])
def test_trunk_scan_matches_reference(scan_w, move_prob):
    """Streams generated for W=8; a scan with W=3 evicts entries that
    later refs still need, which the err lane must report alike."""
    Lc, Pc = 32, 16
    ss = streams(3 + scan_w, 6, 24, 8, Lc, move_prob)
    batch = RS.to_device_batch(ss, Lc, Pc)
    ids = np.zeros((6, Lc), np.int32)
    L = np.zeros(6, np.int32)
    ref = RT.batched_trunk_scan(ids, L, batch, scan_w)
    got = DT.batched_trunk_scan(ids, L, DT.CommitBatch(*batch), scan_w,
                                device=CPU)
    same(ref, got, f"trunk scan W={scan_w}")
    err = got[2].numpy()
    if scan_w == 8:
        assert not err.any()
        out = got[0].numpy()
        for d, s in enumerate(ss):
            assert TK.dense_to_doc(out[d], got[1][d]) == RS.host_trunk(s)
    else:
        assert err.any()


def test_port_streams_match_reference_streams():
    """The port's copy of the stream generator, host trunk and batch
    lowering give the reference's streams, trunks and lanes."""
    Lc, Pc = 32, 16
    for move_prob in (0.0, 0.2):
        ref = RS.gen_streams(np.random.default_rng(8), 3, 16, 3, 6, Lc,
                             max_ins=8, move_prob=move_prob)
        got = TS.gen_streams(np.random.default_rng(8), 3, 16, 3, 6, Lc,
                             max_ins=8, move_prob=move_prob)
        assert ref == got
        assert [RS.host_trunk(s) for s in ref] == \
            [TS.host_trunk(s) for s in got]
        for r, g in zip(RS.to_device_batch(ref, Lc, Pc),
                        TS.to_device_batch(got, Lc, Pc)):
            np.testing.assert_array_equal(np.asarray(r), g)
    # A move-free batch without move lanes materializes zeros alike.
    b = TS.to_device_batch(got, Lc, Pc)
    cb = interop.commit_batch_from_numpy(list(b[:5]) + [None] * 4, CPU)
    z = DT.batched_trunk_scan(np.zeros((3, Lc), np.int32),
                              np.zeros(3, np.int32), cb, 6, device=CPU)
    r = RT.batched_trunk_scan(np.zeros((3, Lc), np.int32),
                              np.zeros(3, np.int32),
                              RT.CommitBatch(*b[:5]), 6)
    same(r, z, "move-free lanes")


def encode_group(logs, move_head=-1):
    """What ``batch_ingest`` stacks for a group of fresh managers: each
    log lowered by the reference encoder at the group's bucket shapes."""
    ems = [RefEM(session=1) for _ in logs]
    lrs = [em._em_lowest_ref(log) for em, log in zip(ems, logs)]
    needs = [em._em_shape_needs(log, lr)
             for em, log, lr in zip(ems, logs, lrs)]
    lc = pow2_at_least(max(max(n[1] + 8, 32) for n in needs))
    pc = pow2_at_least(max(n[2] for n in needs))
    C = pow2_at_least(max(n[3] for n in needs))
    U = pow2_at_least(max(n[0] for n in needs) + 2)
    enc = [em._encode_em_batch(log, lc, pc, C, lr)
           for em, log, lr in zip(ems, logs, lrs)]
    rings = [np.stack([e[1][i] for e in enc]) for i in range(3)]
    a = {k: np.stack([e[2][k] for e in enc]) for k in enc[0][2]}
    lanes = (a["dm"], a["ic"], a["ii"], a["rs"], a["rl"], a["ro"],
             a["refs"], a["seqs"], a["mv"])
    mov = np.full(len(logs), move_head, np.int32)
    return rings, mov, lanes, U, enc


@pytest.mark.parametrize("move_prob", [0.0, 0.3])
def test_em_scan_ring_matches_reference_on_encoded_streams(move_prob):
    logs = [simulate_bounded(60 + d, 20, move_prob) if d % 2
            else simulate(60 + d, n_commits=20, max_lag=4,
                          move_prob=move_prob)
            for d in range(4)]
    rings, mov, lanes, U, enc = encode_group(logs)
    ref = RE.batched_em_trunk_scan_ring(*rings, mov,
                                        RE.EmCommitBatch(*lanes), U)
    got = DE.batched_em_trunk_scan_ring(
        *rings, mov, interop.em_commit_batch_from_numpy(lanes, CPU), U,
        device=CPU)
    same(ref, got, "em ring scan")
    assert not got[2].any()
    # The device state is the per-commit host fold's.
    for d, log in enumerate(logs):
        host = RefEM(session=1)
        for c in log:
            host.add_sequenced(c)
        cells = [enc[d][0][i - 1]
                 for i in TK.dense_to_doc(got[0][d], got[1][d])]
        assert cells == host.trunk_state


def raw_em(seed, N=8, C=10, W=4, Lc=32, Pc=16, R=4, U=64):
    """Random EM lanes: ring seqs with empties and gaps, refs that miss
    the ring, watermarks above them, runs with starts and offsets past
    the ends, ids outside [0, U), and documents that overflow Lc."""
    rng = np.random.default_rng(seed)
    ring_ids = rng.integers(0, U + 8, (N, W, Lc)).astype(np.int32)
    ring_L = rng.integers(Lc - 12, Lc + 1, (N, W)).astype(np.int32)
    ring_seq = np.sort(rng.integers(-1, 12, (N, W)), 1).astype(np.int32)
    mov = rng.integers(-1, 20, N).astype(np.int32)
    dm = (rng.random((N, C, Lc)) < 0.1).astype(np.int32)
    mv = (rng.random((N, C, Lc)) < 0.05).astype(np.int32)
    ic = ((rng.random((N, C, Lc + 1)) < 0.05)
          * rng.integers(1, 3, (N, C, Lc + 1))).astype(np.int32)
    ii = rng.integers(0, U + 8, (N, C, Pc)).astype(np.int32)
    rs = np.where(rng.random((N, C, R)) < 0.6,
                  rng.integers(0, Lc + 3, (N, C, R)), -1).astype(np.int32)
    rl = rng.integers(0, 5, (N, C, R)).astype(np.int32)
    ro = rng.integers(-2, Pc + 2, (N, C, R)).astype(np.int32)
    refs = rng.integers(-1, 16, (N, C)).astype(np.int32)
    seqs = (12 + np.cumsum(rng.integers(1, 3, (N, C)), 1)).astype(np.int32)
    return ((ring_ids, ring_L, ring_seq), mov,
            (dm, ic, ii, rs, rl, ro, refs, seqs, mv), U, W)


@pytest.mark.parametrize("seed", range(3))
def test_em_scans_match_reference_on_raw_lanes(seed):
    rings, mov, lanes, U, W = raw_em(seed)
    ref = RE.batched_em_trunk_scan_ring(*rings, mov,
                                        RE.EmCommitBatch(*lanes), U)
    got = DE.batched_em_trunk_scan_ring(*rings, mov, DE.EmCommitBatch(
        *lanes), U, device=CPU)
    same(ref, got, "raw ring scan")
    err = got[2].numpy()
    for bit in (DE.ERR_RING_MISS, DE.ERR_CAPACITY, DE.ERR_MOVE_EVICTED):
        assert (err & bit).any(), bit
    # The single-base form: ring seeded with the newest state only.
    doc, L, base = rings[0][:, -1], rings[1][:, -1], rings[2][:, -1]
    ref1 = RE.batched_em_trunk_scan(doc, L, base, RE.EmCommitBatch(
        *lanes[:8]), W, U)
    got1 = DE.batched_em_trunk_scan(doc, L, base, DE.EmCommitBatch(
        *lanes[:8]), W, U, device=CPU)
    same(ref1, got1, "single-base scan")


def test_scans_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rings, mov, lanes, U, W = raw_em(0, N=2, C=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        DE.batched_em_trunk_scan_ring(*rings, mov, DE.EmCommitBatch(*lanes),
                                      U)
    z = np.zeros((2, 2), np.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        DT.batched_trunk_scan(np.zeros((2, 8), np.int32),
                              np.zeros(2, np.int32),
                              DT.CommitBatch(np.zeros((2, 2, 8), np.int32),
                                             np.zeros((2, 2, 9), np.int32),
                                             np.zeros((2, 2, 4), np.int32),
                                             z, z + 1), 4)
