"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where no CUDA device is present (decided
inside the test). On a machine with a card, run this file alone and
without the suite's conftest, which imports jax:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from chip_smoke import (
    KERNELS,
    Config6Gen,
    _on_loop,
    _same_states,
    _lanes_equal,
    _snapshot,
    Recorded,
    ServingRun,
    ServingTraffic,
    compact_edge_case,
    edge_case,
    bulk_connect,
    client_family,
    config1_author,
    hold_kernel,
    pipeline_frames,
    pipeline_round,
    pipeline_stages,
    random_case,
    replay_and_compare,
    replay_pipeline,
    replay_serving,
    tree_3b,
    tree_3c,
)
from fluidframework_tpu_torch.ops import _cuda
from fluidframework_tpu_torch.ops import apply_kernel as K1
from fluidframework_tpu_torch.parallel.fleet import DocFleet
from fluidframework_tpu_torch.service.device_backend import (
    DeviceFleetBackend,
)
from fluidframework_tpu_torch.service.pipeline import PipelineFluidService
from fluidframework_tpu_torch.ops import tree_kernel as TK


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [8, 64, 128, 512, 2048])
def test_kernels_match_plain_on_the_card(cap):
    _need_card()
    dev = torch.device("cuda", 0)
    t0, s0, ops = random_case(np.random.default_rng(cap), 257, cap, 16, dev)
    for name, spec in KERNELS.items():
        before = spec["wrapper"].launches
        err, _ms, _plain_ms = hold_kernel(name, t0, s0, ops, 1, 1)
        assert err == 0
        assert spec["wrapper"].launches == before + 2  # check + one timing


def _tier_counts(w):
    return {t: getattr(w, f"launches_{t}") for t in _cuda.TIER_CODES}


@pytest.mark.cuda
@pytest.mark.parametrize("cap,n_docs", [(2050, 33), (4096, 16), (8192, 8),
                                        (12000, 5), (16384, 4), (16385, 3),
                                        (65536, 3)])
def test_global_tier_matches_plain_on_the_card(cap, n_docs):
    """Tables wider than one CTA's shared memory run, bit for bit with the
    plain versions, on the cluster tier up to 16,384 rows (ragged slices
    at 2,050 and 12,000) and on the global-memory tier above it, for K1, K2
    and K3; each launch counts on its tier. Random states, moves that land
    on the 32-row tile and the cluster slice edges, and compactions that
    meet them (K2 and K3)."""
    _need_card()
    dev = torch.device("cuda", 0)
    cases = [random_case(np.random.default_rng(cap), n_docs, cap, 16, dev),
             edge_case(cap, dev), compact_edge_case(cap, dev)]
    for i, (t0, s0, ops) in enumerate(cases):
        for name, spec in KERNELS.items():
            if i == 2 and name == "K1_merge_apply":
                continue
            w = spec["wrapper"]
            tier = _cuda.tier(cap, spec["entry"])
            assert tier == ("cluster" if cap <= 16384 else "global")
            before = _tier_counts(w)
            err, _ms, _plain_ms = hold_kernel(name, t0, s0, ops, 1, 1)
            assert err == 0
            want = dict(before)
            want[tier] += 2  # check + one timing
            assert _tier_counts(w) == want


@pytest.mark.cuda
def test_capacity_past_the_largest_tier_raises():
    _need_card()
    t = torch.zeros((15, 2, _cuda.MAX_CAPACITY * 2), dtype=torch.int32,
                    device="cuda")
    s = torch.zeros((2, 8), dtype=torch.int32, device="cuda")
    ops = torch.zeros((2, 1, 10), dtype=torch.int32, device="cuda")
    before = K1.apply_ops_packed.launches
    with pytest.raises(ValueError, match="65536"):
        K1.apply_ops_packed(t, s, ops)
    assert K1.apply_ops_packed.launches == before


@pytest.mark.cuda
def test_docfleet_lifecycle_crosses_into_the_global_tier():
    """Four docs grow from the 1,024-row tier through 2,048 into 4,096 on
    the kernels; a kernel="plain" replay on the card matches bit for
    bit. K1 and K2 ran on the shared and cluster tiers."""
    _need_card()
    kw = dict(n_docs=4, capacity=1024, high_water=0.7, device="cuda")
    gen = Config6Gen(4)
    rec = Recorded(DocFleet(**kw))
    up = {K1.apply_ops_packed: "cluster",
          KERNELS["K2_zamboni_compact"]["wrapper"]: "cluster"}
    before = {w: _tier_counts(w) for w in up}
    extra = 3
    while extra:
        rec("apply", gen.round(grow=True))
        rec("compact")
        rec("check_and_migrate")
        if 4096 in rec.fleet.pools:
            extra -= 1
    assert rec("stats")["docs_with_errors"] == 0
    for w, tier in up.items():
        now = _tier_counts(w)
        assert now["smem"] > before[w]["smem"]
        assert now[tier] > before[w][tier]
    replay_and_compare(rec, lambda: DocFleet(kernel="plain", **kw),
                       [0, 1, 2, 3])


def _feed(run, traffic):
    for doc, frame in traffic.frames():
        run.handle(doc, {"t": "seqframe", "frame": frame})


@pytest.mark.cuda
def test_serving_upload_is_pinned_and_async():
    """A staged boxcar owns a pinned host buffer (its rows are a numpy
    view of it) and its device rows come from a non-blocking copy; the run
    (growth from 64 through 128 rows, compactions) matches a
    kernel="plain" replay on the card bit for bit."""
    _need_card()
    kw = dict(capacity=64, max_batch=4096, compact_every=2, device="cuda")
    traffic = ServingTraffic(24, k=8, remove_from=4, prefix="p")
    run = ServingRun(DeviceFleetBackend(**kw))
    before = K1.apply_ops_packed.launches
    for _ in range(9):
        _feed(run, traffic)
        assert run("pump_stage")
        slot = run.be._ring.staged[-1]
        assert slot.host_rows.base.is_pinned()
        assert slot.dev_rows.is_cuda
        run("pump_dispatch")
        run("flush")
    run("pump_drain")
    assert K1.apply_ops_packed.launches > before
    assert 128 in run.be.fleet.pools
    for i in range(0, 24, 5):
        assert run("text", traffic.docs[i], "s") == traffic.expected(i)
    replay_serving(run, lambda: DeviceFleetBackend(kernel="plain", **kw),
                   [(d, "s") for d in traffic.docs[::5]])


@pytest.mark.cuda
def test_serving_scan_token_prefetch():
    """The scan token holds a pinned buffer and a CUDA event per pool;
    prefetch_scan / scan_transfer / scan_prefetched move the one-boxcar-
    stale readback off the dispatch, and the next dispatch consumes the
    prefetched copy. Matches a kernel="plain" replay."""
    _need_card()
    kw = dict(capacity=64, max_batch=4096, device="cuda")
    traffic = ServingTraffic(16, k=8, prefix="s")
    run = ServingRun(DeviceFleetBackend(**kw))
    be = run.be
    for _ in range(8):
        _feed(run, traffic)
        run("flush")
        # The prefetch only moves the transfer; it is not replayed.
        token = be.prefetch_scan()
        assert token is not None
        for buf, event, _gen in token.values():
            assert buf.is_pinned() and isinstance(event, torch.cuda.Event)
        host = DeviceFleetBackend.scan_transfer(token)
        be.scan_prefetched(token, host)
        assert be.prefetch_scan() is None
        assert be._scan_prefetch is not None
    _feed(run, traffic)
    run("flush")
    assert be._scan_prefetch is None
    run("collect_now")
    assert be.fleet.migrations == 16
    replay_serving(run, lambda: DeviceFleetBackend(kernel="plain", **kw),
                   [(d, "s") for d in traffic.docs[::3]])


@pytest.mark.cuda
def test_serving_launch_error_is_not_swallowed():
    """A table past the largest kernel tier makes K1's wrapper raise at
    the first dispatch: flush re-raises it (no fallback, no requeue), and
    no kernel launched; the plain version of the same backend applies the
    rows."""
    _need_card()
    cap = _cuda.MAX_CAPACITY * 2
    traffic = ServingTraffic(2, k=8, prefix="e")
    be = DeviceFleetBackend(capacity=cap, max_capacity=cap, device="cuda")
    run = ServingRun(be)
    frames = traffic.frames()
    for doc, frame in frames:
        run.handle(doc, {"t": "seqframe", "frame": frame})
    before = K1.apply_ops_packed.launches
    with pytest.raises(ValueError, match="largest kernel tier"):
        be.flush()
    assert K1.apply_ops_packed.launches == before
    assert len(be._ring) == 0 and be.pump_dispatches == 0
    plain = ServingRun(DeviceFleetBackend(capacity=cap, max_capacity=cap,
                                          kernel="plain", device="cuda"))
    for doc, frame in frames:
        plain.handle(doc, {"t": "seqframe", "frame": frame})
    plain("flush")
    assert plain("text", "e0", "s") == traffic.expected(0)


def _pipeline_states(kernel, n_docs=256, rounds=9, k=8):
    """Config 7's rounds through ``PipelineFluidService`` on the card at
    ``n_docs`` documents; every channel's state by key, and the stats."""
    svc = PipelineFluidService(n_partitions=8, device_max_batch=4096,
                               checkpoint_every=500, device_kernel=kernel,
                               device_torch=torch.device("cuda", 0))
    docs = [f"d{i}" for i in range(n_docs)]
    conns = bulk_connect(svc, docs)
    stage_s = {name: 0.0 for name, _r in pipeline_stages(svc)}
    for items in pipeline_frames(docs, conns, k, rounds):
        pipeline_round(svc, conns,
                       lambda: svc.submit_frames_bulk(items, pump=False),
                       stage_s)
    keys = svc.device.channels()
    return svc.device.doc_states(keys), svc.device.stats()


@pytest.mark.cuda
def test_pipeline_on_the_card_matches_the_plain_versions():
    """256 documents through the ordering pipeline with the kernels, and
    again with ``device_kernel="plain"``: every channel's lanes and
    scalars match by key, K1 and K2 launched, and no document errs."""
    _need_card()
    _cuda.reset_counts(*(spec["wrapper"] for spec in KERNELS.values()))
    got, stats = _pipeline_states("cuda")
    assert KERNELS["K1_merge_apply"]["wrapper"].launches > 0
    assert KERNELS["K2_zamboni_compact"]["wrapper"].launches > 0
    want, plain_stats = _pipeline_states("plain")
    assert stats["docs_with_errors"] == plain_stats["docs_with_errors"] == 0
    assert stats["ops_applied"] == plain_stats["ops_applied"] == 256 * 8 * 9
    assert list(got) == list(want)
    for key in got:
        for f, x, y in zip(got[key]._fields, got[key], want[key]):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=f"{key} {f}")


@pytest.mark.cuda
def test_server_on_the_card_matches_the_plain_replay():
    """The socket front door on the card: 16 writers over websockets
    (the port's network driver, push sockets on), three 8-op frames
    each; K1 launched on the server path, no document errs, and every
    channel's state equals its deltas log replayed through a
    ``kernel="plain"`` backend, by key."""
    _need_card()
    from fluidframework_tpu_torch.drivers.network_driver import (
        NetworkFluidService,
    )
    from fluidframework_tpu_torch.protocol.opframe import OpFrame
    from fluidframework_tpu_torch.service.network_server import (
        FluidNetworkServer,
    )

    dev = torch.device("cuda", 0)
    svc = PipelineFluidService(device_torch=dev, device_flush_min_rows=64)
    srv = FluidNetworkServer(svc)
    _cuda.reset_counts(*(spec["wrapper"] for spec in KERNELS.values()))
    srv.start()
    try:
        cli = NetworkFluidService("127.0.0.1", srv.port, push=True)
        conns = [cli.connect(f"w{i}") for i in range(16)]
        for r in range(3):
            for c in conns:
                csn0 = r * 8 + 1
                c.submit_frame(OpFrame.build(
                    "s", ["ins"] * 8, [0] * 8,
                    [c.conn_no * (1 << 14) + csn0 + j for j in range(8)],
                    list("abcdefgh"), csn0=csn0, ref=c._seq_watermark))
            for c in conns:
                assert c.wait_for(lambda cc, last=r * 8 + 8: any(
                    m.client_id == cc.client_id
                    and m.client_sequence_number == last
                    for m in cc.inbox), 60)
        texts = {f"w{i}": cli.get_channel_text(f"w{i}", "s")
                 for i in range(16)}
        for c in conns:
            c.disconnect()
        served = _on_loop(srv, lambda: _snapshot(svc))
    finally:
        srv.stop()
    assert KERNELS["K1_merge_apply"]["wrapper"].launches > 0
    assert svc.device.stats()["docs_with_errors"] == 0
    assert all(len(t) == 24 for t in texts.values())
    be = svc.device
    offsets = [{p: 0 for p in range(svc.log.n_partitions)},
               dict(svc._device_runner._offsets)]
    plain_texts = replay_pipeline(svc, lambda: DeviceFleetBackend(
        device=dev, kernel="plain", capacity=128, max_batch=be.max_batch,
        compact_every=be.compact_every, pump_mode=be.pump_mode,
        ring_depth=2), offsets, text_keys=[(d, "s") for d in texts])
    assert {d: plain_texts[(d, "s")] for d in texts} == texts
    _same_states(served, _snapshot(svc), "served state after stop")


@pytest.mark.cuda
def test_tree_3b_scan_on_the_card_equals_the_cpu():
    """A small 7a: the positional trunk scan under sync-debug "error",
    every distinct script equal to the host trunk, the card equal to the
    CPU bit for bit, the dense algebra's entry points timed."""
    _need_card()
    res = tree_3b(torch.device("cuda", 0), n_docs=16, n_commits=24,
                  scripts=4, cpu_docs=8, cpu_commits=24)
    assert res["step"]["launches"] > 0
    assert {f["name"] for f in res["functions"]} == {
        "batched_apply", "batched_rebase", "batched_invert",
        "batched_compose"}


@pytest.mark.cuda
@pytest.mark.parametrize("move_prob", [0.0, 0.05])
def test_tree_3c_ingest_on_the_card_equals_the_cpu(move_prob):
    """A small 7b: ``batch_ingest`` over ``EditManager(device=cuda)``s,
    parity with the host EditManager, the recorded dispatch's scan under
    sync-debug "error" and equal to the CPU bit for bit."""
    _need_card()
    res = tree_3c(torch.device("cuda", 0), n_docs=16, n_commits=48,
                  scripts=4, wave=16, move_prob=move_prob, cpu_docs=8)
    assert res["device_commits"] > 0


@pytest.mark.cuda
def test_tree_algebra_on_the_card_equals_the_cpu():
    """Raw random lanes (several writers to a slot, duplicate tags,
    overflowing pools) through apply / rebase (both ties) / invert /
    compose: the card equals the CPU on every lane."""
    _need_card()
    rng = np.random.default_rng(5)
    n, lc, pc = 64, 128, 32

    def lanes():
        def sparse(shape, hi):
            return (rng.integers(0, hi, shape)
                    * (rng.random(shape) < 0.3)).astype(np.int32)
        return TK.DenseChange(
            sparse((n, lc), 2), sparse((n, lc + 1), 3),
            rng.integers(1, 1 << 20, (n, pc)).astype(np.int32),
            sparse((n, lc), 4), sparse((n, lc), 4), sparse((n, pc), 4),
            sparse((n, pc), 4))

    ids = rng.integers(1, 1 << 20, (n, lc)).astype(np.int32)
    L = rng.integers(0, lc + 1, n).astype(np.int32)
    a, b = lanes(), lanes()
    for fn, args in ((TK.batched_apply, (ids, L, a)),
                     (TK.batched_rebase, (a, b, L, False)),
                     (TK.batched_rebase, (a, b, L, True)),
                     (TK.batched_invert, (ids, L, a)),
                     (TK.batched_compose, (a, b, L))):
        got = fn(*args, device="cuda")
        want = fn(*args, device="cpu")
        flat = (lambda r: list(r[0]) + [r[1]] if fn is TK.batched_compose
                else list(r))
        for x, y in zip(flat(got), flat(want)):
            assert torch.equal(x.cpu(), y), fn.__name__


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [256, 2048, 4096, 16384, 65536])
def test_kernels_at_one_document_match_plain(cap):
    """K1 (one op a launch) and K2 at one document on every tier: random
    states, then each edge move and each edge compaction as a document of
    its own (a cluster or a split tier of one document)."""
    _need_card()
    dev = torch.device("cuda", 0)
    for seed in range(3):
        t, s, ops = random_case(np.random.default_rng(cap + seed), 1, cap, 1,
                                dev)
        hold_kernel("K1_merge_apply", t, s, ops, 0, 0)
        hold_kernel("K2_zamboni_compact", t, s, None, 0, 0)
    t, s, ops = edge_case(cap, dev, k=2)
    for i in range(t.shape[1]):
        hold_kernel("K1_merge_apply", t[:, i:i + 1].contiguous(),
                    s[i:i + 1].contiguous(), ops[i:i + 1].contiguous(), 0, 0)
    t, s, _ = compact_edge_case(cap, dev)
    for i in range(t.shape[1]):
        hold_kernel("K2_zamboni_compact", t[:, i:i + 1].contiguous(),
                    s[i:i + 1].contiguous(), None, 0, 0)


@pytest.mark.cuda
def test_shared_string_on_the_card_matches_its_cpu_twin():
    """Config 1's author (1,000 ops) with ``SharedString(device="cuda")``
    against the same on the CPU: the text and every lane equal, and the
    card's K1/K2 launched (the client path, one op a launch)."""
    _need_card()
    dev = torch.device("cuda", 0)
    K1.apply_ops_packed.launches = 0
    _svc, card, _s, _n = config1_author(dev, 1000)
    assert K1.apply_ops_packed.launches >= 1000
    _svc, cpu, _s, _n = config1_author(torch.device("cpu"), 1000)
    a, b = card.get_channel("text"), cpu.get_channel("text")
    assert a.get_text() == b.get_text()
    _lanes_equal(a._state, b._state, "card vs CPU")
    assert a._state.kind.device.type == "cuda"


@pytest.mark.cuda
def test_dds_family_on_the_card_matches_the_cpu():
    """Phase 8d's script (SharedString with intervals, SharedMatrix,
    SparseMatrix, SharedMap, undo-redo, a reconnect) at 120 steps."""
    _need_card()
    card = client_family(torch.device("cuda", 0), steps=120, offline=(40, 60))
    cpu = client_family(torch.device("cpu"), steps=120, offline=(40, 60))
    for a, b in zip(card, cpu):
        for key in a:
            if key == "lanes":
                for la, lb in zip(a[key], b[key]):
                    assert all(np.array_equal(x, y) for x, y in zip(la, lb))
            else:
                assert a[key] == b[key], key


@pytest.mark.cuda
def test_grow_past_the_largest_tier_raises_on_the_card():
    """``grow`` beyond 65,536 rows raises on the card (no kernel tier takes
    the table) instead of moving the state to the CPU."""
    _need_card()
    from fluidframework_tpu_torch.ops.segment_state import (
        grow,
        make_interactive_state,
    )

    st = make_interactive_state(65536, 0, device="cuda")
    with pytest.raises(ValueError, match="65536"):
        grow(st, 131072)
    assert grow(make_interactive_state(32768, 0, device="cuda"),
                65536).kind.device.type == "cuda"
