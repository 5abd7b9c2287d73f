"""Parity of the host tier the port's serving stage carries as its own
copy: the frame wire (``protocol/opframe.py``), the wire lowering
(``models/shared_string.row_from_wire``) and inbound unpacking
(``runtime/op_lifecycle.RemoteMessageProcessor``), the telemetry
vocabularies and renderings (journal, metrics, profiler, tracing), the
fault-site table, and the residency state machine — each against the
reference package on the same seeded inputs, exactly.
"""

import numpy as np
import pytest

from fluidframework_tpu.models import shared_string as ref_ss
from fluidframework_tpu.protocol import opframe as ref_opframe
from fluidframework_tpu.protocol import types as ref_types
from fluidframework_tpu.runtime import op_lifecycle as ref_lifecycle
from fluidframework_tpu.service import residency as ref_residency
from fluidframework_tpu.service import retry as ref_retry
from fluidframework_tpu.service.admission import (
    PressureSignal as RefPressure,
)
from fluidframework_tpu.telemetry import journal as ref_journal
from fluidframework_tpu.telemetry import metrics as ref_metrics
from fluidframework_tpu.telemetry import profiler as ref_profiler
from fluidframework_tpu.telemetry import tracing as ref_tracing
from fluidframework_tpu.testing import faults as ref_faults
from fluidframework_tpu_torch.models import shared_string as port_ss
from fluidframework_tpu_torch.protocol import opframe as port_opframe
from fluidframework_tpu_torch.protocol import types as port_types
from fluidframework_tpu_torch.protocol.constants import F_CLIENT, F_MSN, F_SEQ
from fluidframework_tpu_torch.runtime import op_lifecycle as port_lifecycle
from fluidframework_tpu_torch.service import residency as port_residency
from fluidframework_tpu_torch.service import retry as port_retry
from fluidframework_tpu_torch.service.admission import (
    PressureSignal as PortPressure,
)
from fluidframework_tpu_torch.telemetry import journal as port_journal
from fluidframework_tpu_torch.telemetry import metrics as port_metrics
from fluidframework_tpu_torch.telemetry import profiler as port_profiler
from fluidframework_tpu_torch.telemetry import tracing as port_tracing
from fluidframework_tpu_torch.testing import faults as port_faults


def _kinds(rng, n):
    return [("ins", "rem", "ann")[int(k)] for k in
            rng.choice(3, size=n, p=[0.6, 0.25, 0.15])]


def _opframe_args(rng, n):
    kinds = _kinds(rng, n)
    a = rng.integers(0, 50, n).tolist()
    b = (np.asarray(a) + rng.integers(1, 9, n)).tolist()
    tv = [
        "".join(chr(0x61 + int(c)) for c in rng.integers(0, 26, 1 + i % 4))
        + ("é" if i % 5 == 0 else "")
        if k == "ins" else (int(rng.integers(1, 9)) if k == "ann" else None)
        for i, k in enumerate(kinds)
    ]
    return kinds, a, b, tv


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frames_encode_byte_identical_and_round_trip(seed):
    rng = np.random.default_rng(seed)
    n = 1 + seed * 7
    kinds, a, b, tv = _opframe_args(rng, n)
    frames = {}
    for name, mod in (("ref", ref_opframe), ("port", port_opframe)):
        raw = mod.OpFrame.build("s", kinds, a, b, tv, csn0=5 + seed,
                                ref=40 + seed)
        rows = raw.rows.copy()
        rows[:, F_SEQ] = 100 + np.arange(n)  # deli's stamps
        rows[:, F_MSN] = 90
        rows[:, F_CLIENT] = 3
        seq = mod.SeqFrame("chan", 3, 5 + seed, rows, raw.texts, 12.5)
        frames[name] = (raw, seq)
    (rraw, rseq), (praw, pseq) = frames["ref"], frames["port"]
    assert praw.encode() == rraw.encode()
    assert pseq.encode() == rseq.encode()
    back = port_opframe.OpFrame.decode(praw.encode())
    np.testing.assert_array_equal(back.rows, praw.rows)
    assert (back.address, back.texts) == (praw.address, praw.texts)
    back = port_opframe.SeqFrame.decode(pseq.encode())
    np.testing.assert_array_equal(back.rows, pseq.rows)
    assert (back.address, back.client_id, back.csn0, back.texts,
            back.timestamp) == (pseq.address, pseq.client_id, pseq.csn0,
                                pseq.texts, pseq.timestamp)
    for want, got in zip(rseq.messages(1), pseq.messages(1)):
        assert vars(want) == vars(got)
    origs_r, texts_r = rseq.insert_payloads()
    origs_p, texts_p = pseq.insert_payloads()
    np.testing.assert_array_equal(origs_r, origs_p)
    assert texts_r == texts_p


def test_opframe_from_messages_matches():
    rng = np.random.default_rng(3)
    kinds, a, b, tv = _opframe_args(rng, 9)
    out = []
    for mod, types in ((ref_opframe, ref_types), (port_opframe, port_types)):
        msgs = []
        for i, (k, x, y, v) in enumerate(zip(kinds, a, b, tv)):
            c = ({"k": "ins", "pos": x, "orig": y, "text": v} if k == "ins"
                 else {"k": k, "start": x, "end": y} if k == "rem"
                 else {"k": "ann", "start": x, "end": y, "val": v})
            msgs.append(types.DocumentMessage(
                client_sequence_number=7 + i, reference_sequence_number=20 + i,
                type=types.MessageType.OPERATION,
                contents={"address": "s", "contents": c}))
        out.append(mod.OpFrame.from_messages(msgs).encode())
    assert out[0] == out[1]


def test_vocabularies_equal_the_reference():
    assert port_journal.EVENTS == ref_journal.EVENTS
    assert port_faults.SITES == ref_faults.SITES
    assert port_faults.RECOVERY_KINDS == ref_faults.RECOVERY_KINDS
    assert port_tracing.FRAME_STAGES == ref_tracing.FRAME_STAGES
    assert port_profiler.LANES == ref_profiler.LANES
    assert port_profiler.ROUND_LANES == ref_profiler.ROUND_LANES
    assert port_metrics.FAMILIES == ref_metrics.FAMILIES
    assert port_residency.STATES == ref_residency.STATES
    assert port_residency.WAKE_OUTCOMES == ref_residency.WAKE_OUTCOMES
    from fluidframework_tpu.service import lambdas as ref_lambdas
    from fluidframework_tpu.service import summary_store as ref_store
    from fluidframework_tpu_torch.service import lambdas as port_lambdas
    from fluidframework_tpu_torch.service import summary_store as port_store

    for name in ("RAW_TOPIC", "DELTAS_TOPIC", "SIGNALS_TOPIC"):
        assert getattr(port_lambdas, name) == getattr(ref_lambdas, name)
    assert port_store.SUMMARY_HANDLE_KEY == ref_store.SUMMARY_HANDLE_KEY
    assert port_store.summary_handle("h") == ref_store.summary_handle("h")
    assert list(vars(PortPressure())) == list(vars(RefPressure()))
    sig = dict(ring_frac=0.5, queue_frac=0.25, feed_lag_ms=9.0)
    assert PortPressure(**sig).score(3.0) == RefPressure(**sig).score(3.0)


def _journal_events(j):
    j.record("frame.submit", doc="d1", csn=3, csn_hi=5, client=2)
    j.record("device.stage", spans=(("d1", 4, 9), ("d2", 1, 1)), rows=7)
    j.record("device.err", doc="d2", addr="s")
    j.record("retry.outcome", site="pump.dispatch", outcome="fallback")
    j.record("doc.wake", doc="d1", seq=9, latency_ms=1.25)


def test_same_events_render_same_journal_and_metrics():
    jr, jp = ref_journal.Journal(64), port_journal.Journal(64)
    _journal_events(jr)
    _journal_events(jp)
    assert jp.render() == jr.render()
    assert [e.to_dict()["kind"] for e in jp.lineage("d1", 5)] == \
        [e.to_dict()["kind"] for e in jr.lineage("d1", 5)]
    with pytest.raises(ValueError, match="unknown journal event"):
        jp.record("no.such.event")

    texts = []
    for metrics, retry, tracing in (
        (ref_metrics, ref_retry, ref_tracing),
        (port_metrics, port_retry, port_tracing),
    ):
        reg = metrics.MetricsRegistry()
        retry.retry_counter(reg).inc(site="pump.stage", outcome="requeue")
        retry.retry_counter(reg).inc(2, site="read.gather",
                                     outcome="fallback")
        reg.gauge("reads_per_device_dispatch", "reads per gather").set(4096)
        h = reg.histogram("stage_span_ms", "stage spans",
                          labelnames=("stage",))
        for v in (0.4, 3.0, 17.0, 250.0):
            h.observe(v, stage="device")
        traces = []
        tracing.stamp(traces, tracing.STAGE_DEVICE, "start", 1.0)
        tracing.stamp(traces, tracing.STAGE_DEVICE, "end", 1.004)
        metrics.observe_stage_spans(tracing.spans(traces), reg)
        texts.append((reg.render(), reg.snapshot()))
    assert texts[0] == texts[1]


def test_same_intervals_summarize_alike():
    out = []
    for prof in (ref_profiler, port_profiler):
        p = prof.Profiler(256)
        for bid in range(3):
            t = 10.0 + bid
            p.record("feed_wait", t, t + 0.001, boxcar=bid, rows=8)
            p.record("host_stage", t + 0.001, t + 0.003, boxcar=bid, rows=8)
            p.record("ring_put", t + 0.003, t + 0.0031, boxcar=bid, rows=8)
            p.record("dispatch", t + 0.004, t + 0.006, boxcar=bid, rows=8)
            p.record("device_step", t + 0.006, t + 0.02, boxcar=bid)
            p.record("scan_consume", t + 0.019, t + 0.02, boxcar=bid)
        out.append((p.summarize(), p.render(), p.chrome_trace()))
    assert out[0] == out[1]


def _wire_contents(rng, n):
    out = []
    for i in range(n):
        k = ("ins", "rem", "ann", "interval")[int(rng.integers(4))]
        if k == "ins":
            out.append({"k": "ins", "pos": int(rng.integers(30)),
                        "orig": 1000 + i,
                        "text": "xyz"[: 1 + i % 3] * (1 + i % 7)})
        elif k == "interval":
            out.append({"k": "interval", "op": "add"})
        else:
            s = int(rng.integers(20))
            c = {"k": k, "start": s, "end": s + 1 + int(rng.integers(5))}
            if k == "ann":
                c["val"] = int(rng.integers(1, 9))
            out.append(c)
    return out


def test_row_from_wire_matches():
    rng = np.random.default_rng(4)
    for i, c in enumerate(_wire_contents(rng, 40)):
        kw = dict(seq=50 + i, ref=49 + i, client=i % 5, msn=i // 2)
        pr, pp = {}, {}
        want = ref_ss.row_from_wire(c, payloads=pr, **kw)
        got = port_ss.row_from_wire(c, payloads=pp, **kw)
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(want, got)
            assert want.dtype == got.dtype
        assert pr == pp


@pytest.mark.parametrize("threshold,chunk", [(None, None), (64, None),
                                             (None, 80), (32, 40)])
def test_remote_message_processor_matches(threshold, chunk):
    """Batches packed with compression and/or chunking unpack to the same
    logical messages, in order, with the same swallowed chunks."""
    rng = np.random.default_rng(5)
    envs = [{"address": "s", "contents": c}
            for c in _wire_contents(rng, 12)]
    out = []
    for lifecycle, types in ((ref_lifecycle, ref_types),
                             (port_lifecycle, port_types)):
        wire = lifecycle.pack_batch(envs, compression_threshold=threshold,
                                    chunk_size=chunk)
        rmp = lifecycle.RemoteMessageProcessor()
        got = []
        for i, w in enumerate(wire):
            msg = types.SequencedDocumentMessage(
                client_id=4, sequence_number=10 + i,
                client_sequence_number=i + 1, reference_sequence_number=9,
                minimum_sequence_number=1, type=types.MessageType.OPERATION,
                contents=w.contents, metadata=w.metadata)
            m = rmp.process(msg)
            got.append(None if m is None else (
                m.sequence_number, m.contents, m.metadata, w.logical_index))
        rmp.forget_client(4)
        out.append(got)
    assert out[0] == out[1]
    assert sum(x is not None for x in out[1]) == len(envs)


def test_residency_state_machine_matches():
    """The same op / idle / hibernate / wake sequence drives both
    managers (and their heat trackers) through the same states and
    counters."""
    out = []
    for mod in (ref_residency, port_residency):
        m = mod.ResidencyManager(max_resident=2, heat=mod.HeatTracker())
        trail = []
        for d in ("a", "b", "c"):
            m.note_admit(d)
            trail.append(m.note_op(d, 3.0))
        m.heat.observe_window()
        for d in ("a", "c"):
            trail.append(m.mark_idle(d))
        trail.append(tuple(m.hibernation_candidates()))
        trail.append(m.begin_hibernate("c"))
        m.finish_hibernate("c", ok=True, head=7)
        trail.append(m.note_op("c"))
        m.begin_wake("c")
        m.finish_wake("c", "retry")
        m.finish_wake("c", "ok", head=7)
        trail.append((m.state("c"), m.hit_ratio(), m.heat.rate("a")))
        st = m.stats()
        st.pop("wake_p99_ms")  # a wall-clock latency
        out.append((trail, st, m.counts()))
    assert out[0] == out[1]
