"""Parity: the port's TpuFleetService (``device="cpu"``, plain PyTorch
kernels) against the JAX reference service (Pallas in interpret mode), fed
the same seeded numpy intents and rows.

After every round both services must agree exactly: packed tables and
scalars, ticket err lanes and stamped rows, wire counters, scribe sweep
results and pack-blob content hashes, latest summaries, doc states, texts
and telemetry.
"""

import numpy as np
import pytest
import torch

from fluidframework_tpu.protocol.constants import F_LSEQ
from fluidframework_tpu.service.fleet_service import (
    TpuFleetService as RefService,
)
from chip_smoke import RoundGen  # config 5's traffic generator
from fluidframework_tpu_torch.interop import service_from_reference_arrays
from fluidframework_tpu_torch.service.fleet_service import TpuFleetService

N_DOCS, CAP, K = 16, 64, 8
PAYLOADS = {i: f"{i:03d}" for i in range(1, 20)}


def _pair(compact_every=1, n_docs=N_DOCS, cap=CAP):
    ref = RefService(n_docs, capacity=cap, block_docs=8, interpret=True,
                     compact_every=compact_every)
    port = TpuFleetService(n_docs, capacity=cap, compact_every=compact_every,
                           device="cpu")
    ref.join_writer(0)
    port.join_writer(0)
    return ref, port


def _assert_state(ref, port):
    np.testing.assert_array_equal(np.asarray(ref.tables), port.tables.numpy())
    np.testing.assert_array_equal(np.asarray(ref.scalars),
                                  port.scalars.numpy())
    np.testing.assert_array_equal(ref.fseq.doc_state, port.fseq.doc_state)
    assert ref.wire16_rounds == port.wire16_rounds
    assert ref.wire32_rounds == port.wire32_rounds
    assert ref.rounds_applied == port.rounds_applied
    np.testing.assert_array_equal(ref.device_errors(), port.device_errors())
    for shards in (1, 4, 3):
        np.testing.assert_array_equal(ref.telemetry_slice(shards),
                                      port.telemetry_slice(shards))
    docs = [0, 3, ref.n_docs - 1]
    want, got = ref.doc_states(docs), port.doc_states(docs)
    for d in docs:
        for a, b in zip(want[d], got[d]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(ref.doc_state(d), port.doc_state(d)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert ref.text(d, PAYLOADS) == port.text(d, PAYLOADS)


def _assert_summaries(ref, port):
    assert ref.summary_writes == port.summary_writes
    assert ref._lane_set == port._lane_set
    for d in range(ref.n_docs):
        a, b = ref._summary_handles.get(d), port._summary_handles.get(d)
        assert (a is None) == (b is None)
        if a is not None:
            assert a[0][0] == b[0][0]  # pack blob content hash
            assert ref.latest_summary(d) == port.latest_summary(d)


def _assert_round_out(a, b):
    err_a, rows_a = a
    err_b, rows_b = b
    np.testing.assert_array_equal(err_a, err_b)
    np.testing.assert_array_equal(rows_a, rows_b)


@pytest.mark.parametrize("compact_every", [1, 2])
def test_config5_rounds_match_reference(compact_every):
    """Config 5's pipelined loop — commit r, begin sweep, stage round r+1,
    stage + finish the sweep — on both services, compared every round.
    With compact_every=2 both K1 and K3 run."""
    ref, port = _pair(compact_every)
    gen = RoundGen(N_DOCS, K, seed=5)
    batch = gen(ref)
    _assert_round_out(ref.submit_round(*batch), port.submit_round(*batch))
    for _ in range(3):
        assert ref.summarize_dirty(1, 4) == port.summarize_dirty(1, 4)
    assert (ref.summarize_dirty(1, N_DOCS // 3)
            == port.summarize_dirty(1, N_DOCS // 3))
    _assert_state(ref, port)
    _assert_summaries(ref, port)

    rounds = 4
    batch = gen(ref)
    tok_r, tok_p = ref.stage_round(*batch), port.stage_round(*batch)
    for r in range(rounds):
        _assert_round_out(ref.commit_round(tok_r), port.commit_round(tok_p))
        pend_r = ref.begin_summarize_dirty(1, N_DOCS // 3)
        pend_p = port.begin_summarize_dirty(1, N_DOCS // 3)
        if r + 1 < rounds:
            batch = gen(ref)
            tok_r, tok_p = ref.stage_round(*batch), port.stage_round(*batch)
        pend_r.stage()
        pend_p.stage()
        assert pend_r.finish() == pend_p.finish()
        _assert_state(ref, port)
        _assert_summaries(ref, port)
    assert not port.device_errors().any()


def test_ticket_error_nack_and_verbatim_wire():
    """A cseq gap refuses one doc (nack, nothing applied), and a row with a
    local seq forces the verbatim int32 wire — identically on both."""
    ref, port = _pair()
    gen = RoundGen(N_DOCS, K, seed=7)
    intents, rows = gen(ref)
    intents = intents.copy()
    intents[3, 0, 1] = 99  # cseq gap on doc 3
    a, b = ref.submit_round(intents, rows), port.submit_round(intents, rows)
    _assert_round_out(a, b)
    assert b[0][3] != 0 and not np.delete(b[0], 3).any()
    _assert_state(ref, port)
    intents, rows = gen(ref)
    intents[3, :, 1] = port.fseq.clients[3, 0, 1] + 1 + np.arange(K)
    rows = rows.copy()
    rows[0, 0, F_LSEQ] = 5
    _assert_round_out(ref.submit_round(intents, rows),
                      port.submit_round(intents, rows))
    assert port.wire32_rounds == 1
    _assert_state(ref, port)


def _int8_overflow_drive(svc):
    """Live rows whose seq span exceeds the int8 window (the reference's
    test_scribe_int8_overflow_regathers_bucket shape)."""
    from fluidframework_tpu.ops import encode as E
    from tests.test_fleet_service import _round

    out = [svc.submit_round(*_round(svc, [[E.insert(0, 1, 1)]] * svc.n_docs))]
    out.append(svc.summarize_dirty(threshold=1))
    for i in range(2, 11):
        out.append(svc.submit_round(
            *_round(svc, [[E.insert(0, i, 1)]] * svc.n_docs)
        ))
        if i >= 8:
            svc.fseq.doc_state[:, 0] += 300  # interleaved traffic elsewhere
    out.append(svc.summarize_dirty(threshold=1))
    return out


def test_int8_overflow_forces_verbatim_regather():
    ref, port = _pair(n_docs=4, cap=64)
    out_r, out_p = _int8_overflow_drive(ref), _int8_overflow_drive(port)
    for a, b in zip(out_r, out_p):
        if isinstance(a, tuple) and isinstance(a[0], np.ndarray):
            _assert_round_out(a, b)
        else:
            assert a == b
    assert port.last_summary_breakdown["regathers"] >= 1
    assert (ref.last_summary_breakdown["regathers"]
            == port.last_summary_breakdown["regathers"])
    _assert_state(ref, port)
    _assert_summaries(ref, port)
    assert max(port.latest_summary(0)["lanes"]["seq"]) > 254


def test_mid_stream_hand_over_through_interop():
    """Two rounds on the reference, then its state crosses to a port
    service as numpy arrays; both continue on identical inputs."""
    ref = RefService(N_DOCS, capacity=CAP, block_docs=8, interpret=True,
                     compact_every=2)
    ref.join_writer(0)
    gen = RoundGen(N_DOCS, K, seed=11)
    for _ in range(3):
        err, _ = ref.submit_round(*gen(ref))
        assert not err.any()
    ref.summarize_dirty(1)
    port = service_from_reference_arrays(
        np.asarray(ref.tables), np.asarray(ref.scalars),
        ref.fseq.doc_state, ref.fseq.clients, ref._summarized_seq,
        device="cpu", compact_every=2, rounds_applied=ref.rounds_applied,
        lane_set=ref._lane_set, lane_idle=ref._lane_idle,
        wire_widths=ref._wire_widths,
    )
    # Counters are the service's own history, not state: carry them so the
    # comparisons below can include them.
    port.wire16_rounds = ref.wire16_rounds
    port.wire32_rounds = ref.wire32_rounds
    port.summary_writes = ref.summary_writes
    for _ in range(3):
        batch = gen(ref)
        _assert_round_out(ref.submit_round(*batch), port.submit_round(*batch))
        assert ref.summarize_dirty(1) == port.summarize_dirty(1)
        _assert_state(ref, port)
        _assert_summaries(ref, port)


def test_commit_between_begin_and_finish_keeps_the_sweep_at_begin():
    """The port's tables update in place; a sweep open across a commit
    must still describe the state at its begin (the commit writes fresh
    buffers instead), exactly as a sweep finished before the commit."""
    a = TpuFleetService(N_DOCS, capacity=CAP, device="cpu")
    b = TpuFleetService(N_DOCS, capacity=CAP, device="cpu")
    for svc in (a, b):
        svc.join_writer(0)
    gen_a, gen_b = RoundGen(N_DOCS, K, seed=3), RoundGen(N_DOCS, K, seed=3)
    for _ in range(2):
        a.submit_round(*gen_a(a))
        b.submit_round(*gen_b(b))
    held = a.tables
    pend = a.begin_summarize_dirty(1)
    a.submit_round(*gen_a(a))  # commit while the sweep is open
    assert a.tables is not held
    pend.stage()
    res_a = pend.finish()
    res_b = b.summarize_dirty(1)
    b.submit_round(*gen_b(b))
    assert res_a == res_b
    assert torch.equal(a.tables, b.tables) and torch.equal(a.scalars,
                                                           b.scalars)
    for d in range(N_DOCS):
        assert a.latest_summary(d) == b.latest_summary(d)
    # With no sweep open, commits update the same buffers in place.
    held = a.tables
    a.submit_round(*gen_a(a))
    assert a.tables is held


def test_standalone_compact_matches_reference_compact():
    """The port's ``compact()`` (K2 outside the cadence) after a K1-only
    round equals the reference's Pallas ``compact_packed`` on the same
    state, and both services continue identically."""
    from fluidframework_tpu.ops.pallas_compact import compact_packed

    ref, port = _pair(compact_every=2)
    gen = RoundGen(N_DOCS, K, seed=13)
    for _ in range(2):
        batch = gen(ref)
        _assert_round_out(ref.submit_round(*batch),
                          port.submit_round(*batch))
        ref.tables, ref.scalars = compact_packed(ref.tables, ref.scalars,
                                                 interpret=True)
        port.compact()
        _assert_state(ref, port)


def test_python_ticket_fallback_matches_native():
    """The port keeps the reference's pure-Python ticket loop for hosts
    without a C++ compiler; it must ticket exactly like the native loop,
    gaps, duplicates, stale refs and unknown writers included."""
    from fluidframework_tpu_torch.service.fleet_sequencer import (
        FleetSequencer,
    )

    rng = np.random.default_rng(17)
    native, python = FleetSequencer(32), FleetSequencer(32)
    assert native.native_available
    python._native._lib = None
    assert not python.native_available
    for fs in (native, python):
        fs.join_all(0)
        fs.join_all(3)
    for _ in range(4):
        ops = np.zeros((32, 6, 3), np.int32)
        ops[:, :, 0] = rng.choice([0, 3, 3, 0, 7], size=(32, 6))
        ops[:, :, 1] = (native.clients[:, 0, 1].max() + 1
                        + rng.integers(-1, 3, (32, 6)))
        ops[:, :, 2] = native.doc_state[:, 0:1] + rng.integers(-2, 2, (32, 6))
        a, b = native.ticket_batch(ops), python.ticket_batch(ops)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(native.doc_state, python.doc_state)
        np.testing.assert_array_equal(native.clients, python.clients)
