"""Parity of the host modules the port's pipeline carries as its own copy:
the partitioned log (``service/queue.py``), the deli sequencer
(``service/sequencer.py``), the admission envelope
(``service/admission.py``), the LRU cache, the wire codec, the historian
read tier and its store-node socket client, and the telemetry logger,
config gates and Lumberjack — each against the reference package on the
same seeded inputs. The tolerance is exact equality throughout; the only
fields left out are wall-clock readings (``timestamp``,
``durationInMs``, ``duration``) the modules take themselves.
"""

import dataclasses
import enum
import json
import types as pytypes
import zlib

import numpy as np
import pytest

from fluidframework_tpu.protocol import types as ref_types
from fluidframework_tpu.service import admission as ref_admission
from fluidframework_tpu.service import codec as ref_codec
from fluidframework_tpu.service import historian as ref_historian
from fluidframework_tpu.service import pipeline as ref_pipeline
from fluidframework_tpu.service import queue as ref_queue
from fluidframework_tpu.service import sequencer as ref_sequencer
from fluidframework_tpu.service import summary_store as ref_summary_store
from fluidframework_tpu.service.store_server import StoreServer
from fluidframework_tpu.telemetry import config as ref_config
from fluidframework_tpu.telemetry import logger as ref_logger
from fluidframework_tpu.telemetry import lumberjack as ref_lumberjack
from fluidframework_tpu.telemetry import metrics as ref_metrics
from fluidframework_tpu.utils import lru as ref_lru
from fluidframework_tpu_torch.protocol import types as port_types
from fluidframework_tpu_torch.service import admission as port_admission
from fluidframework_tpu_torch.service import codec as port_codec
from fluidframework_tpu_torch.service import historian as port_historian
from fluidframework_tpu_torch.service import pipeline as port_pipeline
from fluidframework_tpu_torch.service import queue as port_queue
from fluidframework_tpu_torch.service import sequencer as port_sequencer
from fluidframework_tpu_torch.service import (
    summary_store as port_summary_store,
)
from fluidframework_tpu_torch.telemetry import config as port_config
from fluidframework_tpu_torch.telemetry import logger as port_logger
from fluidframework_tpu_torch.telemetry import lumberjack as port_lumberjack
from fluidframework_tpu_torch.telemetry import metrics as port_metrics
from fluidframework_tpu_torch.utils import lru as port_lru

WALL = ("timestamp", "durationInMs", "duration")


def _norm(x):
    """A package-free form of a value (classes by name, enums by name and
    value, arrays by dtype and contents), wall-clock keys dropped."""
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name, x.value)
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.tolist())
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, [(f.name, _norm(getattr(x, f.name)))
                                   for f in dataclasses.fields(x)])
    if isinstance(x, dict):
        return ("dict", [(_norm(k), _norm(v)) for k, v in x.items()
                         if k not in WALL])
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, [_norm(v) for v in x])
    return x


# -- the partitioned log ------------------------------------------------------


def _keys(n=10_000, seed=0):
    rng = np.random.default_rng(seed)
    keys = [f"doc-{i}" for i in range(n // 2)]
    keys += [f"d{i}" for i in range(n // 4)]
    alphabet = "abcxyzé日本-_/#0123456789"
    while len(keys) < n:
        k = int(rng.integers(0, 24))
        keys.append("".join(alphabet[int(c)] for c in
                            rng.integers(0, len(alphabet), k)))
    return keys


@pytest.mark.parametrize("n_partitions", [1, 4, 8, 13])
def test_partition_of_matches_for_10000_keys(n_partitions):
    keys = _keys()
    got = [port_queue.partition_of(k, n_partitions) for k in keys]
    assert got == [ref_queue.partition_of(k, n_partitions) for k in keys]
    assert got == [zlib.crc32(k.encode()) % n_partitions for k in keys]


def _log_script(mod):
    log = mod.PartitionedLog(4)
    out = [log.send("t", f"d{i % 5}", {"i": i}) for i in range(9)]
    log.send_batch("t", [(f"d{i % 3}", {"b": i}) for i in range(7)])
    log.send_batch("u", [("x", 1), ("y", 2)])
    for p in range(4):
        out.append([(r.offset, r.key, r.value) for r in log.read("t", p, 0)])
        out.append([(r.offset, r.key) for r in log.read("t", p, 1, limit=2)])
        out.append(log.end_offset("t", p))
        log.commit("g", "t", p, log.end_offset("t", p) // 2)
    log.commit("g", "t", 0, log.end_offset("t", 0))
    out.append([log.committed("g", "t", p) for p in range(4)])
    out.append(log.committed("h", "u", 1))
    with pytest.raises(AssertionError, match="never rewind"):
        log.commit("g", "t", 0, 0)
    out.append(sorted(log._logs))
    return out


def test_partitioned_log_offsets_and_commits():
    assert _log_script(ref_queue) == _log_script(port_queue)
    assert port_queue.DEFAULT_PARTITIONS == ref_queue.DEFAULT_PARTITIONS


# -- the deli sequencer -------------------------------------------------------


def _sequencer_script(mod, types, seed):
    """A seeded client stream through one ``DocumentSequencer``: joins
    (read and write), per-op tickets and frame tickets with duplicates,
    overlaps, gaps and stale refs, leaves, control messages, a
    checkpoint-restore in the middle; every return value recorded."""
    rng = np.random.default_rng(seed)
    seq = mod.DocumentSequencer("doc")
    out = []
    csn = {}  # client -> last csn the script sent
    seen = {}  # client -> head the client has seen
    for step in range(160):
        live = sorted(seq.clients)
        r = rng.random()
        if r < 0.08 or not live:
            res = seq.join("read" if rng.random() < 0.1 else "write")
            if hasattr(res, "contents"):
                cid = res.contents["clientId"]
                csn[cid] = 0
                seen[cid] = res.sequence_number
            out.append(("join", res))
        elif r < 0.13:
            cid = int(rng.choice(live))
            out.append(("leave", seq.leave(cid), seq.maybe_no_client()))
        elif r < 0.16:
            ctl = ({"type": "updateDSN", "dsn": int(seq.seq // 2)}
                   if rng.random() < 0.5 else
                   {"type": "nackMessages", "enable": rng.random() < 0.3})
            out.append(("control", seq.control(ctl)))
        elif r < 0.19:
            ck = seq.checkpoint()
            seq = mod.DocumentSequencer(
                "doc", mod.SequencerCheckpoint(**seq.checkpoint_dict()))
            out.append(("restore", ck))
        else:
            cid = int(rng.choice(live)) if rng.random() < 0.93 else 99
            # (99: an unknown client)
            last = csn.get(cid, 0)
            shift = int(rng.choice([0, 0, 0, 0, -2, -1, 1, 2]))
            c0 = max(1, last + 1 + shift)
            ref = seen.get(cid, 0)
            if rng.random() < 0.1:
                ref = max(0, seq.min_seq - 1)  # stale
            if rng.random() < 0.5:
                n = int(rng.integers(1, 6))
                refs = np.full(n, ref, np.int32)
                if rng.random() < 0.4:  # mixed refs, some below the msn
                    refs = rng.integers(max(0, ref - 3), ref + 1, n
                                        ).astype(np.int32)
                res = seq.ticket_frame(cid, c0, n, refs)
                if res is not None and hasattr(res, "m"):
                    csn[cid] = c0 + res.drop + res.m - 1
                out.append(("frame", cid, c0, n, res))
            else:
                ty = (types.MessageType.SUMMARIZE if rng.random() < 0.05
                      else types.MessageType.OPERATION)
                msg = types.DocumentMessage(
                    client_sequence_number=c0, reference_sequence_number=ref,
                    type=ty, contents={"step": step})
                res = seq.ticket(cid, msg)
                if res is not None and hasattr(res, "sequence_number") \
                        and not hasattr(res, "error_type"):
                    csn[cid] = c0
                out.append(("op", cid, c0, res))
            if cid in seen:
                seen[cid] = seq.seq
        out.append(("state", seq.checkpoint_dict(), seq.seq, seq.min_seq,
                    seq.durable_seq, seq._nack_all))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sequencer_ticket_streams_match(monkeypatch, seed):
    clock = pytypes.SimpleNamespace(time=lambda: 1234.5)
    for mod in (ref_sequencer, port_sequencer):
        monkeypatch.setattr(mod, "time", clock)
    want = _sequencer_script(ref_sequencer, ref_types, seed)
    got = _sequencer_script(port_sequencer, port_types, seed)
    assert len(got) == len(want)
    kinds = {k[0] for k in got}
    assert {"join", "leave", "frame", "op", "restore"} <= kinds
    for i, (a, b) in enumerate(zip(want, got)):
        assert _norm(a) == _norm(b), (i, a, b)
    assert port_sequencer.FULL_SCOPES == ref_sequencer.FULL_SCOPES


# -- the admission envelope ---------------------------------------------------


class Clock:
    def __init__(self):
        self.t = 50.0

    def __call__(self):
        return self.t


def _admission_script(mod):
    clock = Clock()
    out = []
    tb = mod.TokenBucket(10.0, 5.0, clock=clock)
    for step, n in enumerate([1, 3, 2, 8, 1, 4, 6, 1]):
        out.append((tb.take(n), tb.tokens, tb.retry_after_ms(n)))
        clock.t += 0.15 * (step % 3)
        if step == 3:
            tb.give_back(2)
    adm = mod.AdmissionController(tenant_rate=20.0, doc_rate=6.0,
                                  clock=clock, autotune_headroom=2.0,
                                  autotune_min_interval_s=0.5)
    adm.set_tenant_rate("vip", 100.0, 50.0)
    adm.set_doc_rate("hot", 2.0, 2.0)
    tiers = [mod.Tier.NORMAL] * 6 + [mod.Tier.THROTTLE_WRITES] * 3 + \
        [mod.Tier.REFUSE_CONNECTIONS]
    for step in range(40):
        tenant = ("local", "vip", "other")[step % 3]
        doc = ("a", "b", "hot", "c")[step % 4]
        d = adm.decide(tenant, doc, 1 + step % 4, tier=tiers[step % 10])
        out.append((d, adm.tenant_tokens(tenant), adm.permissive()))
        clock.t += 0.05
        if step % 9 == 0:
            out.append(adm.autotune(applied_total=100.0 * step))
    out.append((adm.denied, adm.doc_rate, adm.tenant_rate,
                sorted(adm._tenants), sorted(adm._docs)))
    ov = mod.OverloadController(lag_ref_ms=10.0)
    P = mod.PressureSignal
    for sig in [P(0.1, 0.1, 1.0), P(0.7, 0.0, 0.0), P(0.0, 0.95, 2.0),
                P(0.0, 0.0, 13.0), P(0.6, 0.1, 0.0), P(0.4, 0.0, 0.0),
                P(0.0, 0.0, 0.0), P(1.0, 1.0, 50.0), P(0.0, 0.0, 0.0)]:
        out.append((ov.observe(sig), ov.last_score, ov.shed_reads(),
                    ov.refuse_connections(), ov.retry_after_ms()))
    ov.force(mod.Tier.THROTTLE_WRITES)
    out.append(ov.observe(P(0.0, 0.0, 0.0)))
    ov.force(None)
    out.append((ov.observe(P(0.0, 0.0, 0.0)), list(ov.transitions)))
    return out


def test_token_buckets_admission_and_overload_on_one_clock():
    counters = {}
    for name, mod, reg in (("ref", ref_admission, ref_metrics.REGISTRY),
                           ("port", port_admission, port_metrics.REGISTRY)):
        denied0 = {r: mod.admission_denied_counter(reg).value(reason=r)
                   for r in ("tenant_budget", "doc_budget", "tier_refuse")}
        out = _admission_script(mod)
        denied = {r: mod.admission_denied_counter(reg).value(reason=r)
                  - denied0[r] for r in denied0}
        counters[name] = (out, denied)
    assert _norm(counters["ref"]) == _norm(counters["port"])
    assert [t.name for t in port_admission.Tier] == \
        [t.name for t in ref_admission.Tier]
    assert {k.name: v for k, v in port_admission.TIER_WRITE_COST.items()} == \
        {k.name: v for k, v in ref_admission.TIER_WRITE_COST.items()}


# -- LRU and codec ------------------------------------------------------------


def _lru_script(mod):
    c = mod.LruCache(capacity_bytes=40)
    out = []
    for i in range(12):
        c.set(f"k{i % 7}", bytes(3 + i % 5) * (1 + i % 3))
        if i % 4 == 0:
            out.append(c.get(f"k{(i + 3) % 7}"))
        if i == 8:
            c.delete("k2")
        out.append((list(c._d), c._bytes))
    c.set("huge", b"x" * 41)  # larger than the budget: skipped
    out.append((list(c._d), c._bytes, c.get("huge")))
    return out


def test_lru_eviction_order():
    assert _lru_script(ref_lru) == _lru_script(port_lru)


def _codec_values(types):
    return [
        types.DocumentMessage(
            client_sequence_number=3, reference_sequence_number=1,
            type=types.MessageType.OPERATION,
            contents={"address": "s", "contents": {"k": "ins", "pos": 0}},
            metadata={"batch": True}),
        types.SequencedDocumentMessage(
            client_id=2, sequence_number=9, client_sequence_number=3,
            reference_sequence_number=7, minimum_sequence_number=5,
            type=types.MessageType.SUMMARY_ACK,
            contents={"handle": "h", "nested": [1, {"a": None}]},
            timestamp=12.5),
        types.NackMessage(
            sequence_number=4, content_code=429,
            error_type=types.NackErrorType.THROTTLING, message="slow",
            retry_after_s=0.25, client_sequence_number=11),
        {"t": "op", "client": 1, "msgs": [1, "two", (3, 4)]},
        [None, 1.5, "x"],
    ]


def test_codec_round_trips():
    for rv, pv in zip(_codec_values(ref_types), _codec_values(port_types)):
        enc = port_codec.encode_value(pv)
        assert enc == ref_codec.encode_value(rv)
        assert _norm(port_codec.decode_value(enc)) == \
            _norm(ref_codec.decode_value(enc))
        assert json.dumps(port_codec.to_jsonable(pv), sort_keys=True) == \
            json.dumps(ref_codec.to_jsonable(rv), sort_keys=True)
        assert _norm(port_codec.from_jsonable(port_codec.to_jsonable(pv))) \
            == _norm(ref_codec.from_jsonable(ref_codec.to_jsonable(rv)))


# -- the historian read tier --------------------------------------------------


class _Exploding:
    def get(self, key):
        raise RuntimeError("cache down")

    def set(self, key, value):
        raise RuntimeError("cache down")

    def delete(self, key):
        raise RuntimeError("cache down")


def _historian_script(pipeline, historian, summary_store, types, reg,
                      remote):
    hits, misses = historian.read_cache_counter(reg), \
        historian.read_cache_miss_counter(reg)
    tiers = ("deltas", "summary", "blob")
    h0 = [hits.value(tier=t) for t in tiers]
    m0 = [misses.value(tier=t) for t in tiers]
    svc = pipeline.PipelineFluidService(n_partitions=2, device_backend=False)
    svc.read_tier = historian.HistorianReadTier(svc, chunk=4)
    conn = svc.connect("doc")
    for i in range(1, 12):
        conn.submit(types.DocumentMessage(
            client_sequence_number=i, reference_sequence_number=conn.join_seq,
            type=types.MessageType.OPERATION, contents={"n": i}))
    rt = svc.read_tier
    out = [rt.deltas_payload("doc", f, t)
           for f, t in [(0, None), (0, 8), (2, 11), (0, None), (4, 4),
                        (9, 3)]]
    handle = svc.store.put_summary({"channels": {"a": {"v": 1}},
                                    "doc_id": "doc"})
    head = svc.doc_head("doc")
    conn.submit(types.DocumentMessage(
        client_sequence_number=12, reference_sequence_number=head,
        type=types.MessageType.SUMMARIZE,
        contents={"handle": handle, "head": head}))
    out += [rt.latest_summary("doc"), rt.latest_summary("doc"),
            rt.latest_summary("nobody")]
    b = rt.put_blob(b"blob one")
    out += [rt.get_blob(b), rt.get_blob(b), rt.has(b), rt.has("0" * 64),
            rt.hit_ratio(), rt.hits, rt.misses, rt.blobs.hits,
            rt.blobs.misses]
    store = historian.historian(summary_store.SummaryStore(),
                                cache=_Exploding())
    h = store.put_blob(b"direct")
    out += [store.get_blob(h), store._backend.cache_errors]
    rc = historian.RemoteCache(*remote)
    rc.set("k", b"over the node")
    out += [rc.get("k"), rc.get("missing")]
    rc.delete("k")
    out.append(rc.get("k"))
    via = summary_store.SummaryStore(
        backend=historian.CachingBlobBackend(summary_store.SummaryStore(),
                                             rc))
    hb = via.put_blob(b"cached remotely")
    out += [via.get_blob(hb), via._backend.hits, via._backend.misses]
    out.append([hits.value(tier=t) - x for t, x in zip(tiers, h0)])
    out.append([misses.value(tier=t) - x for t, x in zip(tiers, m0)])
    return out


def test_historian_caches_and_the_store_node_client(monkeypatch):
    """The read tier's delta chunks, summary pointer and blob cache, the
    ``historian()`` store over a failing cache, and ``RemoteCache`` over
    the reference's store node on localhost (the port's ``_Conn``
    framing against the reference server): same bytes, same hit and
    miss counts, same counter increments."""
    clock = pytypes.SimpleNamespace(time=lambda: 77.0)
    for mod in (ref_sequencer, port_sequencer):
        monkeypatch.setattr(mod, "time", clock)
    node = StoreServer(port=0).serve_background()
    try:
        outs = {}
        for name, pipe, hist, ss, types, reg in (
            ("ref", ref_pipeline, ref_historian, ref_summary_store,
             ref_types, ref_metrics.REGISTRY),
            ("port", port_pipeline, port_historian, port_summary_store,
             port_types, port_metrics.REGISTRY),
        ):
            token = pytypes.SimpleNamespace(hex="0123456789abcdef")
            monkeypatch.setattr(pipe, "uuid", pytypes.SimpleNamespace(
                uuid4=lambda: token))
            outs[name] = _historian_script(pipe, hist, ss, types, reg,
                                           (node.host, node.port))
    finally:
        node.close()
    assert _norm(outs["ref"]) == _norm(outs["port"])
    assert outs["port"][0].startswith(b"[") and outs["port"][-2] != [0, 0, 0]


# -- telemetry: Lumberjack, logger, config ------------------------------------


def _telemetry_script(lj, logger, config, tmp_path):
    eng = lj.CollectingEngine()
    lj.Lumberjack.setup([eng])
    try:
        m = lj.Lumberjack.new_metric(lj.LumberEventName.DeliHandler,
                                     {"tenantId": "t", "documentId": "d"})
        m.set_property("k", 1).set_properties({"j": 2})
        m.success("ok")
        with pytest.raises(RuntimeError, match="already completed"):
            m.error("twice")
        m2 = lj.Lumberjack.new_metric(lj.LumberEventName.SummaryWrite)
        m2.error("bad", ValueError("x"))
        lj.Lumberjack.new_metric("Custom", {"a": 1}).success()
        lj.Lumberjack.log("hello", level="warn", properties={"p": 3})
        records = [dict(r) for r in eng.records]
        out = [records, len(eng.matches("DeliHandler"))]
    finally:
        lj.Lumberjack.reset()
    sink = logger.CollectingLogger({"common": True})
    child = logger.ChildLogger.create(sink, "fluid:telemetry",
                                      {"childProp": 1})
    grand = logger.ChildLogger.create(child, "DeltaManager")
    grand.send({"eventName": "Connect", "x": 1})
    child.send_error("Boom", ValueError("bad"), extra=2)
    sink.send_performance("Perf", 12.0, p=1)
    with logger.PerformanceEvent(grand, "Load", emit_start=True, a=1) as ev:
        ev.end(b=2)
    with pytest.raises(KeyError):
        with logger.PerformanceEvent(child, "Fail"):
            raise KeyError("k")
    logger.TelemetryLogger().send({"eventName": "nowhere"})
    out += [sink.events, [e["eventName"] for e in sink.matches("Load_end")]]
    cp = config.ConfigProvider({"b": "TRUE", "n": "2.5", "s": "x", "bad": [],
                                "t": True, "i": 3})
    out += [cp.get_boolean("b"), cp.get_boolean("s", False),
            cp.get_boolean("t"), cp.get_number("n"), cp.get_number("t", -1),
            cp.get_number("i"), cp.get_number("s", 7), cp.get_string("s"),
            cp.get_string("i", "d"), cp.get_boolean("missing")]
    cp.set("b", "false")
    out.append(cp.get_boolean("b"))
    mc = config.MonitoringContext()
    out.append((type(mc.logger).__name__, type(mc.config).__name__))
    path = tmp_path / "config.json"
    path.write_text(json.dumps({"deli": {"checkpointHeuristics": {
        "maxMessages": 500}, "enable": True}, "top": 1}))
    lc = config.LayeredConfig.from_json_file(str(path), {"top": 2})
    out += [lc.get("deli:checkpointHeuristics:maxMessages"), lc.get("top"),
            lc.get("deli:missing", "dflt"), lc.get("deli:enable")]
    lc.set("deli:checkpointHeuristics:maxMessages", 10)
    lc.set("new:path", [1])
    out += [lc.get("deli:checkpointHeuristics:maxMessages"),
            lc.get("new:path"), config.LayeredConfig().get("x", 0)]
    return out


def test_lumberjack_logger_and_config_output(tmp_path):
    want = _telemetry_script(ref_lumberjack, ref_logger, ref_config,
                             tmp_path)
    got = _telemetry_script(port_lumberjack, port_logger, port_config,
                            tmp_path)
    assert _norm(want) == _norm(got)
    assert vars(port_lumberjack.LumberEventName).keys() == \
        vars(ref_lumberjack.LumberEventName).keys()
    assert (port_logger.GENERIC, port_logger.ERROR, port_logger.PERFORMANCE) \
        == (ref_logger.GENERIC, ref_logger.ERROR, ref_logger.PERFORMANCE)
