"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where no CUDA device is present (decided
inside the test). On a machine with a card, run this file alone and
without the suite's conftest, which imports jax:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from chip_smoke import (
    ALGEBRA_HOLDS,
    ALGEBRA_KERNELS,
    KERNELS,
    T1_HOLDS,
    T2_HOLD_COMMITS,
    T2_HOLD_DOCS,
    T2_HOLD_LCS,
    Config6Gen,
    _on_loop,
    _same_states,
    _lanes_equal,
    _snapshot,
    Recorded,
    ServingRun,
    ServingTraffic,
    compact_edge_case,
    edge_batches,
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
    algebra_args,
    algebra_case,
    em_case,
    hold_algebra,
    hold_tree,
    tree_3b,
    trunk_case,
)
from fluidframework_tpu_torch.ops import _cuda
from tools import kernel_sanitize as KS
from fluidframework_tpu_torch.ops import apply_kernel as K1
from fluidframework_tpu_torch.parallel.fleet import DocFleet
from fluidframework_tpu_torch.service.device_backend import (
    DeviceFleetBackend,
)
from fluidframework_tpu_torch.service.pipeline import PipelineFluidService
from fluidframework_tpu_torch.ops import tree_algebra_kernel as TAK
from fluidframework_tpu_torch.ops import tree_kernel as TK
from fluidframework_tpu_torch.ops import tree_scan_kernel as TSK
from fluidframework_tpu_torch.tree import device_em as DEM
from fluidframework_tpu_torch.tree import device_trunk as DT


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
    at 2,050 and 12,000) and on the global-memory tier above it, for K1,
    K2 and K3; each launch counts on its tier. K1 and K3 route to the
    split tier in launches of fewer documents than the card has SMs, so
    above 16,384 rows they are held on the global tier forced as well.
    Random states, moves that land on the 32-row tile and the cluster
    slice edges, and compactions that meet them (K2 and K3)."""
    _need_card()
    dev = torch.device("cuda", 0)
    cases = [random_case(np.random.default_rng(cap), n_docs, cap, 16, dev),
             edge_case(cap, dev), compact_edge_case(cap, dev)]
    for i, (t0, s0, ops) in enumerate(cases):
        for name, spec in KERNELS.items():
            if i == 2 and name == "K1_merge_apply":
                continue
            w = spec["wrapper"]
            n = t0.shape[1]
            tier = _cuda.tier(cap, spec["entry"], n)
            assert tier == ("cluster" if cap <= 16384 else "global"
                            if n >= _cuda.sm_count(dev)
                            or name == "K2_zamboni_compact" else "split")
            for t in (None, "global") if tier == "split" else (None,):
                before = _tier_counts(w)
                err, _ms, _plain_ms = hold_kernel(name, t0, s0, ops, 1, 1,
                                                  t=t)
                assert err == 0
                want = dict(before)
                want[t or tier] += 2  # check + one timing
                assert _tier_counts(w) == want


@pytest.mark.cuda
@pytest.mark.parametrize("tier,cap", [("smem", 256), ("smem", 1024),
                                      ("smem", 2048), ("cluster", 4096),
                                      ("cluster", 12000)])
def test_shared_and_cluster_tiers_walk_the_rows_below_count(tier, cap):
    """K1, K2 and K3 on the shared and cluster tiers (forced) where the
    rows below count (+ 2K) meet their seams: count 0 (every warp and CTA
    without rows), 1, 31, 33 and S, count + 2K past S, live ranges that
    end on the last warp's or slice's edge (half the table: 8 warps of
    cap / 16 rows, or C slices of 512), one live op beside NOOPs, and
    the edge moves and compactions. Each held bit for bit against the
    plain versions in place (each launch counts on its tier) and out of
    place into sentinel outputs (the rows past the larger count must be
    written as fills)."""
    _need_card()
    dev = torch.device("cuda", 0)
    k, half = 4, cap // 2
    cases = [("apply", KS.live_inputs(dev, cap, [0, 1, 31, 33, cap, cap - 3,
                                                 half - 2 * k, half], k)),
             ("apply", KS.live_inputs(dev, cap, [cap // 8] * 8, 1,
                                      live_doc=3)),
             ("apply", edge_case(cap, dev, k)),
             ("compact", compact_edge_case(cap, dev))]
    for kind, (t0, s0, ops) in cases:
        for name, spec in KERNELS.items():
            if kind == "compact" and name == "K1_merge_apply":
                continue
            w = spec["wrapper"]
            before = _tier_counts(w)
            err, _ms, _plain_ms = hold_kernel(name, t0, s0, ops, 1, 1,
                                              t=tier)
            assert err == 0
            want = dict(before)
            want[tier] += 2  # check + one timing
            assert _tier_counts(w) == want
            run = KS.merge_run(spec["entry"], t0, s0, ops, tier)
            assert KS.first_difference(run.kernel(), run.plain()) is None, (
                name, kind)


@pytest.mark.cuda
def test_split_tier_matches_plain_on_the_card():
    """Tables past 65,536 rows (2 x 131,072, and the edge cases in
    launches of up to 8) run on the split tier, bit for bit with the plain
    versions, for K1, K2 and K3: random states, moves on the tile and
    slice edges, compactions that meet them; each launch counts on the
    split tier. A tier the library refuses for the size
    raises and counts nothing: no fallback."""
    _need_card()
    dev = torch.device("cuda", 0)
    cap = 131072
    cases = [("apply", random_case(np.random.default_rng(cap), 2, cap, 16,
                                   dev))] + list(edge_batches(cap, dev))
    for kind, (t0, s0, ops) in cases:
        for name, spec in KERNELS.items():
            if kind == "compact" and name == "K1_merge_apply":
                continue
            w = spec["wrapper"]
            assert _cuda.tier(cap, spec["entry"], t0.shape[1]) == "split"
            before = _tier_counts(w)
            err, _ms, _plain_ms = hold_kernel(name, t0, s0, ops, 1, 1)
            assert err == 0
            want = dict(before)
            want["split"] += 2  # check + one timing
            assert _tier_counts(w) == want
    t0, s0, ops = cases[0][1]
    before = K1.apply_ops_packed.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        _cuda.launch("merge_apply", t0, s0, ops, (t0.clone(), s0.clone()),
                     t="global")
    assert K1.apply_ops_packed.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [8, 64, 128, 256, 512])
def test_warp_tier_matches_plain_on_the_card(cap):
    """K1 and K3 on the warp tier (one warp a document, forced), bit for
    bit with the plain versions: random states at 301 documents, moves on
    the 32-row tile edges (``edge_case``) and compactions that meet them
    (``compact_edge_case``); each launch counts on the warp tier. K2
    refuses the warp tier, and so does K1 past its widest table: each
    raises and counts nothing (no fallback)."""
    _need_card()
    dev = torch.device("cuda", 0)
    cases = [("apply", random_case(np.random.default_rng(cap), 301, cap, 16,
                                   dev)),
             ("apply", edge_case(cap, dev)),
             ("compact", compact_edge_case(cap, dev))]
    for kind, (t0, s0, ops) in cases:
        if t0.shape[1] == 0:
            continue
        for name in ("K1_merge_apply", "K3_fused_apply_compact"):
            if kind == "compact" and name == "K1_merge_apply":
                continue
            w = KERNELS[name]["wrapper"]
            before = _tier_counts(w)
            err, _ms, _plain_ms = hold_kernel(name, t0, s0, ops, 1, 1,
                                              t="warp")
            assert err == 0
            want = dict(before)
            want["warp"] += 2  # check + one timing
            assert _tier_counts(w) == want
    t0, s0, ops = cases[0][1]
    for entry, args, w in (
            ("merge_compact", None, KERNELS["K2_zamboni_compact"]["wrapper"]),
            ("merge_apply", ops, K1.apply_ops_packed)):
        if entry == "merge_apply":  # past the warp tier's widest table
            t0, s0, args = random_case(np.random.default_rng(1), 3,
                                       _cuda.WARP_MAX_CAPACITY + 1, 2, dev)
        before = _tier_counts(w)
        with pytest.raises(RuntimeError, match="CUDA error"):
            _cuda.launch(entry, t0, s0, args, (t0.clone(), s0.clone()),
                         t="warp")
        assert _tier_counts(w) == before


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
def test_serving_launch_error_is_not_swallowed(monkeypatch):
    """A launch the kernel library refuses (the tier choice forced to the
    one-CTA global tier for a 131,072-row table, which the library does
    not take) makes K1's wrapper raise at the first dispatch: flush
    re-raises it (no fallback, no requeue), and no kernel launched; the
    same backend with the tier chosen as usual applies the rows, as does
    the plain version."""
    _need_card()
    cap = 131072
    traffic = ServingTraffic(2, k=8, prefix="e")
    be = DeviceFleetBackend(capacity=cap, max_capacity=cap, device="cuda")
    run = ServingRun(be)
    frames = traffic.frames()
    for doc, frame in frames:
        run.handle(doc, {"t": "seqframe", "frame": frame})
    before = K1.apply_ops_packed.launches
    with monkeypatch.context() as m:
        m.setattr(_cuda, "tier", lambda s, entry, n_docs, sms=None:
                  "global")
        with pytest.raises(RuntimeError, match="CUDA error"):
            be.flush()
    assert K1.apply_ops_packed.launches == before
    assert len(be._ring) == 0 and be.pump_dispatches == 0
    for make in (lambda: DeviceFleetBackend(capacity=cap, max_capacity=cap,
                                            device="cuda"),
                 lambda: DeviceFleetBackend(capacity=cap, max_capacity=cap,
                                            kernel="plain", device="cuda")):
        ok = ServingRun(make())
        for doc, frame in frames:
            ok.handle(doc, {"t": "seqframe", "frame": frame})
        ok("flush")
        assert ok("text", "e0", "s") == traffic.expected(0)
    assert K1.apply_ops_packed.launches > before


@pytest.mark.cuda
def test_serving_warp_launch_error_is_not_swallowed(monkeypatch):
    """The tier choice forced to the warp tier for a 1,024-row pool, wider
    than the warp tier takes: K1's wrapper raises at the first dispatch,
    flush re-raises it and no kernel launched (no fallback to the shared
    tier); the same backend with the tier chosen as usual applies the
    rows."""
    _need_card()
    cap = 1024
    traffic = ServingTraffic(2, k=8, prefix="w")
    be = DeviceFleetBackend(capacity=cap, max_capacity=cap, device="cuda")
    run = ServingRun(be)
    frames = traffic.frames()
    for doc, frame in frames:
        run.handle(doc, {"t": "seqframe", "frame": frame})
    before = _tier_counts(K1.apply_ops_packed)
    with monkeypatch.context() as m:
        m.setattr(_cuda, "tier", lambda s, entry, n_docs, sms=None: "warp")
        with pytest.raises(RuntimeError, match="CUDA error"):
            be.flush()
    assert _tier_counts(K1.apply_ops_packed) == before
    assert len(be._ring) == 0 and be.pump_dispatches == 0
    ok = ServingRun(DeviceFleetBackend(capacity=cap, max_capacity=cap,
                                       device="cuda"))
    for doc, frame in frames:
        ok.handle(doc, {"t": "seqframe", "frame": frame})
    ok("flush")
    assert ok("text", "w0", "s") == traffic.expected(0)


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
    CPU bit for bit, the dense algebra's entry points one launch of A1-A4
    each, held and timed. A scan is one
    launch of T1 and nothing else on the card (the profiler's device
    activities of one scan)."""
    _need_card()
    TSK.reset_counts()
    res = tree_3b(torch.device("cuda", 0), n_docs=16, n_commits=24,
                  scripts=4, cpu_docs=8)
    assert res["scan"]["kernel_launches"] == 1
    assert res["scan"]["launches"] == 1
    assert TSK.trunk_scan_cuda.launches > 0
    assert TSK.em_ring_scan_cuda.launches == 0
    assert {f["name"] for f in res["functions"]} == {
        "batched_apply", "batched_rebase", "batched_invert",
        "batched_compose"}
    # One launch of A1-A4 a call (the kernels' own counters), each held
    # against its plain version.
    assert [f["kernel"] for f in res["functions"]] == [
        "A1_tree_apply", "A2_tree_rebase", "A2_tree_rebase",
        "A3_tree_invert", "A4_tree_compose"]
    assert all(f["launches"] == 1 for f in res["functions"])
    assert all(f["hold"]["max_abs_err"] == 0 for f in res["functions"])


@pytest.mark.cuda
@pytest.mark.parametrize("move_prob", [0.0, 0.05])
def test_tree_3c_ingest_on_the_card_equals_the_cpu(move_prob):
    """A small 7b: ``batch_ingest`` over ``EditManager(device=cuda)``s,
    parity with the host EditManager, the recorded dispatch's scan under
    sync-debug "error", equal to T2 into sentinel-filled outputs, to the
    plain version on the card and to the CPU bit for bit. A scan is one
    launch of T2 and one device activity on the profiler. It runs in a
    process of its own: after other card work in one process,
    ``torch.profiler`` records no device activity for T2 (PERF.md §7)."""
    _need_card()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import json, torch\n"
        "import chip_smoke as c\n"
        "from fluidframework_tpu_torch.ops import tree_scan_kernel as TSK\n"
        "TSK.reset_counts()\n"
        "r = c.tree_3c(torch.device('cuda', 0), n_docs=16, n_commits=48, "
        f"scripts=4, wave=16, move_prob={move_prob!r}, cpu_docs=8)\n"
        "print('TREE_3C ' + json.dumps(dict(r, t1=TSK.trunk_scan_cuda."
        "launches, t2=TSK.em_ring_scan_cuda.launches)))\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=root,
                         env=dict(os.environ, PYTHONPATH=root),
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    res = json.loads(next(x for x in run.stdout.splitlines()
                          if x.startswith("TREE_3C "))[len("TREE_3C "):])
    assert res["device_commits"] > 0
    assert res["scan"]["kernel_launches"] == 1
    assert res["scan"]["launches"] == 1
    assert res["t2"] >= res["dispatches"] > 0
    assert res["t1"] == 0


def _scan_once(fn, *args, **kw):
    """``fn`` under sync-debug "error" with the tree counts zeroed first."""
    TSK.reset_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.cuda
@pytest.mark.parametrize("hold", T1_HOLDS)
def test_trunk_scan_kernel_matches_plain_on_the_card(hold):
    """T1 at each hold shape of the smoke (W 3/8/16, Lc 32-1,024, Pc
    8/32, moves or none, the ring-window err, N 1/7/1,024), on every tier
    that takes the shape (the warp tier with its ring in the slice and in
    the workspace, the shared and global tiers): the kernel, writing into
    sentinel-filled outputs, equals its plain version on the card in every
    lane, and ``batched_trunk_scan`` is one launch on the tier ``tier()``
    names without a host sync."""
    _need_card()
    dev = torch.device("cuda", 0)
    n, c, w, lc, pc, mp, lag_w = hold
    docs, L0, cb = trunk_case(dev, n, c, lag_w, lc, pc, mp)
    row = hold_tree(dev, "T1_trunk_scan", (docs, L0, cb, w))
    assert row["max_abs_err"] == 0
    assert all(r["max_abs_err"] == 0 for r in row["tiers"].values())
    got = _scan_once(DT.batched_trunk_scan, docs, L0, cb, w, device=dev)
    tier = TSK.tier("tree_trunk_scan", lc, pc, w, n=n)
    assert TSK.trunk_scan_cuda.launches == 1
    assert getattr(TSK.trunk_scan_cuda, f"launches_{tier}") == 1
    want = DT.batched_trunk_scan_plain(docs, L0, cb, w, device=dev)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert bool(want[2].any()) == (w < lag_w)


@pytest.mark.cuda
@pytest.mark.parametrize("lc", T2_HOLD_LCS)
def test_em_ring_scan_kernel_matches_plain_on_the_card(lc):
    """T2 at every Lc bucket of ``batch_ingest`` (every tier that takes
    it; W 16, R 16, all 16 runs on one commit, ring misses with and
    without a move watermark, an ``ERR_CAPACITY`` overflow): the kernel,
    writing into sentinel-filled outputs, equals its plain version on the
    card in every lane, and ``batched_em_trunk_scan_ring`` is one launch
    on the tier ``tier()`` names without a host sync."""
    _need_card()
    dev = torch.device("cuda", 0)
    rings, cb, U = em_case(dev, T2_HOLD_DOCS, T2_HOLD_COMMITS, lc)
    row = hold_tree(dev, "T2_em_ring_scan", (*rings, cb, U))
    assert row["max_abs_err"] == 0
    assert all(r["max_abs_err"] == 0 for r in row["tiers"].values())
    got = _scan_once(DEM.batched_em_trunk_scan_ring, *rings, cb, U,
                     device=dev)
    assert TSK.em_ring_scan_cuda.launches == 1
    tier = TSK.tier("tree_em_ring_scan", lc, cb.ins_ids.shape[2], 16,
                    cb.run_start.shape[2], U, n=T2_HOLD_DOCS)
    assert getattr(TSK.em_ring_scan_cuda, f"launches_{tier}") == 1
    want = DEM.batched_em_trunk_scan_ring_plain(*rings, cb, U, device=dev)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    err = want[2].tolist()
    assert err[1] & DEM.ERR_MOVE_EVICTED and err[-1] & DEM.ERR_CAPACITY
    assert err[4] & DEM.ERR_RING_MISS and not err[4] & DEM.ERR_MOVE_EVICTED


@pytest.mark.cuda
@pytest.mark.parametrize("lc", T2_HOLD_LCS)
def test_em_ring_scan_one_document_matches_plain_on_the_card(lc):
    """T2 at one document a launch (the EditManager's own dispatch) at
    every bucket, on every tier that takes it, equal to its plain version
    in every lane into sentinel-filled outputs; one launch on the tier
    ``tier()`` names for one document, without a host sync."""
    _need_card()
    dev = torch.device("cuda", 0)
    rings, cb, U = em_case(dev, 1, T2_HOLD_COMMITS, lc)
    row = hold_tree(dev, "T2_em_ring_scan", (*rings, cb, U))
    assert all(r["max_abs_err"] == 0 for r in row["tiers"].values())
    got = _scan_once(DEM.batched_em_trunk_scan_ring, *rings, cb, U,
                     device=dev)
    tier = TSK.tier("tree_em_ring_scan", lc, cb.ins_ids.shape[2], 16,
                    cb.run_start.shape[2], U, n=1)
    assert TSK.em_ring_scan_cuda.launches == 1
    assert getattr(TSK.em_ring_scan_cuda, f"launches_{tier}") == 1
    want = DEM.batched_em_trunk_scan_ring_plain(*rings, cb, U, device=dev)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert want[2][0] & DEM.ERR_CAPACITY


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["T1", "T2"])
def test_tree_scans_take_the_warp_tier_at_the_main_shapes(name):
    """At 3b's and 7b's widths and 1,024 documents each scan is one launch
    of the warp tier with its ring in the workspace, without a host sync,
    equal to its plain version in every lane."""
    _need_card()
    dev = torch.device("cuda", 0)
    if name == "T1":
        docs, L0, cb = trunk_case(dev, 1024, 24, 16, 128, 32, 0.0)
        args, scan = (docs, L0, cb, 16), DT.batched_trunk_scan
        plain, wrapper = DT.batched_trunk_scan_plain, TSK.trunk_scan_cuda
        shape = ("tree_trunk_scan", 128, 32, 16, 0, 1)
    else:
        rings, cb, U = em_case(dev, 1024, 16, 512, U=2048)
        args, scan = (*rings, cb, U), DEM.batched_em_trunk_scan_ring
        plain = DEM.batched_em_trunk_scan_ring_plain
        wrapper = TSK.em_ring_scan_cuda
        shape = ("tree_em_ring_scan", 512, cb.ins_ids.shape[2], 16, 16, U)
    assert TSK.tier(*shape, n=1024) == "warp"
    assert TSK.warp_ring(*shape, n=1024) == "global"
    got = _scan_once(scan, *args, device=dev)
    assert wrapper.launches == 1 and wrapper.launches_warp == 1
    want = plain(*args, device=dev)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.cuda
def test_tree_algebra_on_the_card_equals_the_cpu():
    """Raw random lanes (several writers to a slot, duplicate tags,
    overflowing pools) through apply / rebase (both ties) / invert /
    compose: one launch on the tier ``tier()`` names, and the card equals
    the CPU on every lane."""
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
    for fn, args, w in ((TK.batched_apply, (ids, L, a), TAK.apply_cuda),
                        (TK.batched_rebase, (a, b, L, False),
                         TAK.rebase_cuda),
                        (TK.batched_rebase, (a, b, L, True),
                         TAK.rebase_cuda),
                        (TK.batched_invert, (ids, L, a), TAK.invert_cuda),
                        (TK.batched_compose, (a, b, L), TAK.compose_cuda)):
        TAK.reset_counts()
        got = fn(*args, device="cuda")
        t = TAK.tier(TAK.ENTRIES[TAK.WRAPPERS.index(w)], lc, pc, n)
        assert w.launches == getattr(w, f"launches_{t}") == 1
        assert sum(x.launches for x in TAK.WRAPPERS) == 1
        want = fn(*args, device="cpu")
        flat = (lambda r: list(r[0]) + [r[1]] if fn is TK.batched_compose
                else list(r))
        for x, y in zip(flat(got), flat(want)):
            assert torch.equal(x.cpu(), y), fn.__name__


@pytest.mark.cuda
@pytest.mark.parametrize("hold", ALGEBRA_HOLDS, ids=lambda h: h[0])
def test_tree_algebra_kernels_match_plain_on_the_card(hold):
    """A1-A4 at the smoke's algebra holds (3b's and 3c's widths on
    gen_streams commits and on raw lanes, a width past every shared tier):
    each kernel, rebase in both tie forms, on every tier that takes the
    shape, writing into sentinel-filled outputs, equals its plain version
    on the card in every lane; each batched entry point is one launch of
    its kernel on the tier ``tier()`` names, without a host sync, equal to
    the plain version."""
    _need_card()
    dev = torch.device("cuda", 0)
    label, n, lc, pc, lanes = hold
    docs, L, a, b = algebra_case(dev, n, lc, pc, lanes)
    for name, spec in ALGEBRA_KERNELS.items():
        for c_after in ((False, True) if name == "A2_tree_rebase"
                        else (False,)):
            args = algebra_args(name, docs, L, a, b, c_after)
            row = hold_algebra(dev, name, args, reps=1)
            assert row["max_abs_err"] == 0
            assert set(row["tiers"]) == {
                t for t in TAK.TIER_CODES
                if TAK.placement(spec["entry"], lc, pc, t) is not None}
            TAK.reset_counts()
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = spec["fn"](*args, device=dev)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            t = TAK.tier(spec["entry"], lc, pc, n)
            w = spec["wrapper"]
            assert w.launches == getattr(w, f"launches_{t}") == 1
            assert sum(x.launches for x in TAK.WRAPPERS) == 1
            want = spec["plain"](*args)
            flat = (lambda r: [*r[0], r[1]] if name == "A4_tree_compose"
                    else list(r))
            assert all(torch.equal(x, y)
                       for x, y in zip(flat(got), flat(want))), name


# Every kernel entry by the smoke's name, for the repeated-launch holds.
REPEATED = {**{n: s["entry"] for n, s in {**KERNELS, **ALGEBRA_KERNELS}
               .items()},
            "T1_trunk_scan": "tree_trunk_scan",
            "T2_em_ring_scan": "tree_em_ring_scan",
            "X1_shard_stats": "shard_stats",
            "X2_shard_resolve": "shard_resolve",
            "X12_shard_exchange": "shard_exchange"}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["A1_tree_apply", "A3_tree_invert"] + sorted(
    set(REPEATED) - {"A1_tree_apply", "A3_tree_invert"}))
def test_apply_and_invert_stay_exact_over_repeated_launches(name):
    """Every kernel entry, 100 launches on every tier it has, each into
    fresh sentinel outputs (the allocator's free blocks poisoned before
    each) and equal to the plain version in every lane: an
    ordering fault in shared memory shows only over repeated launches (a
    design that appended A1's move-in atoms through a shared-memory counter
    held once and failed over repeated calls). Each entry runs
    ``tools.kernel_sanitize``'s cases of it, round robin; A1 and A3 also on
    raw lanes at 3b's widths (duplicate move tags in most documents)."""
    _need_card()
    dev = torch.device("cuda", 0)
    cases = [c for c in KS.cases() if c.entry == REPEATED[name]]
    assert {c.tier for c in cases} == set(KS.entry_tiers(REPEATED[name]))
    for c, r in zip(cases, KS.hold_all([c.make(dev) for c in cases], 100,
                                       poison_dev=dev)):
        assert r["mismatches"] == 0, KS.report_line(c, r)
    if name not in ("A1_tree_apply", "A3_tree_invert"):
        return
    docs, L, a, _b = algebra_case(dev, 1024, 128, 32, "raw")
    spec = ALGEBRA_KERNELS[name]
    args = algebra_args(name, docs, L, a, a)
    want = spec["plain"](*args)
    for t in TAK.TIER_CODES:
        for _ in range(100):
            got = spec["wrapper"](*args, t=t)
            assert all(torch.equal(x, y) for x, y in zip(got, want)), t


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [256, 2048, 4096, 16384, 65536, 131072])
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
    for kind, (t, s, ops) in edge_batches(cap, dev, k=2, launch_docs=1):
        for i in range(t.shape[1]):
            one = (t[:, i:i + 1].contiguous(), s[i:i + 1].contiguous())
            if kind == "apply":
                hold_kernel("K1_merge_apply", *one,
                            ops[i:i + 1].contiguous(), 0, 0)
            else:
                hold_kernel("K2_zamboni_compact", *one, None, 0, 0)


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
def test_grow_past_65536_rows_on_the_card():
    """``grow`` from 65,536 to 131,072 rows stays on the card and the next
    ops run on the split tier, equal to the same run on the CPU (phase
    8f at 64 ops); past the kernels' largest tier ``grow`` raises before
    it allocates, and never moves the state to the CPU."""
    _need_card()
    from chip_smoke import client_8f
    from fluidframework_tpu_torch.ops.segment_state import (
        grow,
        make_interactive_state,
    )

    before = K1.apply_ops_packed.launches_split
    client_8f(torch.device("cuda", 0), {}, n_ops=64)
    assert K1.apply_ops_packed.launches_split == before + 2
    st = make_interactive_state(65536, 0, device="cuda")
    assert grow(st, 131072).kind.device.type == "cuda"
    with pytest.raises(ValueError, match="1073741824"):
        grow(st, _cuda.MAX_CAPACITY + 1)


# -- the mesh and the sharded document (tolerance 0, int32) -------------------


def _mesh_ops(n_docs, k, seed):
    from chip_smoke import mesh_op_stream

    return mesh_op_stream(n_docs, k, np.random.default_rng(seed))


def _mesh_fleet_run(devs, ops, rounds=3):
    from fluidframework_tpu_torch.parallel.mesh import Mesh

    fleet = DocFleet(ops.shape[0], 16, mesh=Mesh(devs))
    for r in range(rounds):
        fleet.apply_sparse(np.arange(ops.shape[0]), ops)
        fleet.compact()
        fleet.check_and_migrate()
    return fleet


def _sharded_stream(rng, n, seq0, length):
    """Inserts, removes and annotates at random global positions (some
    past the end), unknown types and wide writers among them."""
    from fluidframework_tpu_torch.ops import encode as E
    from fluidframework_tpu_torch.protocol.constants import F_TYPE

    rows = []
    for i in range(n):
        s = seq0 + i
        pos = int(rng.integers(0, length + 3))
        client = int(rng.integers(0, 4)) if rng.random() < 0.9 else 120
        r = rng.random()
        if r < 0.6:
            rows.append(E.insert(pos, 1 + i % 7, 3, seq=s, ref=s - 1,
                                 client=client, msn=max(0, s - 8)))
            length += 3
        elif r < 0.8:
            rows.append(E.remove(pos, pos + 4, seq=s, ref=s - 1,
                                 client=client, msn=max(0, s - 8)))
        elif r < 0.9:
            rows.append(E.annotate(pos, pos + 5, 3, seq=s, ref=s - 1,
                                   client=client))
        else:
            row = E.insert(pos, 2, 1, seq=s, ref=s - 1, client=client)
            row[F_TYPE] = int(rng.choice([-1, 7, 100]))
            rows.append(row)
    return np.stack(rows).astype(np.int32)


def _sharded_run(devs, rows, kernel="auto"):
    from fluidframework_tpu_torch.parallel.mesh import Mesh
    from fluidframework_tpu_torch.parallel.sharded_doc import ShardedDoc

    doc = ShardedDoc(64, mesh=Mesh(devs, "seg"), kernel=kernel)
    for i in range(0, len(rows), 16):
        doc.apply(rows[i:i + 16])
        doc.compact()
        doc.rebalance(0.5)
    return doc


@pytest.mark.cuda
def test_mesh_fleet_on_eight_card_entries_equals_the_cpu():
    """DocFleet(mesh=8 x cuda:0): every pool equal to the same run over
    eight CPU entries, through promotions."""
    _need_card()
    ops = _mesh_ops(48, 8, 1)
    card = _mesh_fleet_run([torch.device("cuda", 0)] * 8, ops)
    cpu = _mesh_fleet_run(["cpu"] * 8, ops)
    assert sorted(card.pools) == sorted(cpu.pools)
    for cap, pool in card.pools.items():
        assert len(pool.parts) == 8
        assert torch.equal(pool.tables.cpu(), cpu.pools[cap].tables)
        assert torch.equal(pool.scalars.cpu(), cpu.pools[cap].scalars)


@pytest.mark.cuda
def test_sharded_doc_on_the_card_equals_the_cpu_without_a_sync():
    """ShardedDoc over 8 x cuda:0 equals its run over eight CPU entries
    shard for shard; apply and compact make no host sync."""
    _need_card()
    from fluidframework_tpu_torch.interop import mesh_state_to_numpy

    rows = _sharded_stream(np.random.default_rng(4), 96, 1, 0)
    card = _sharded_run([torch.device("cuda", 0)] * 8, rows)
    cpu = _sharded_run(["cpu"] * 8, rows)
    for a, b in zip(mesh_state_to_numpy(card), mesh_state_to_numpy(cpu)):
        np.testing.assert_array_equal(a, b)
    more = _sharded_stream(np.random.default_rng(5), 16, 97, 40)
    torch.cuda.set_sync_debug_mode("error")
    try:
        card.apply(more)
        card.compact()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    cpu.apply(more)
    cpu.compact()
    for a, b in zip(mesh_state_to_numpy(card), mesh_state_to_numpy(cpu)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_one_card_sharded_doc_equals_plain_on_the_card():
    """The one-card list's ShardedDoc of 8 x 65,536 rows in one shard (the
    reference's one-device size) takes a document of 70,000 distinct rows
    and a mixed stream with compactions on the split tier, bit for bit
    with ``kernel="plain"`` on the card; only a shard cap past the
    kernels' largest tier raises ValueError."""
    _need_card()
    from chip_smoke import _overflow_state
    from fluidframework_tpu_torch.interop import mesh_state_to_numpy
    from fluidframework_tpu_torch.parallel.mesh import Mesh
    from fluidframework_tpu_torch.parallel.sharded_doc import ShardedDoc

    one = Mesh([torch.device("cuda", 0)], "seg")
    n = 70000
    rows = _sharded_stream(np.random.default_rng(7), 96, n + 1, n)
    docs = {}
    before = _tier_counts(K1.apply_ops_packed)
    for kernel in ("auto", "plain"):
        doc = ShardedDoc(8 * 65536, mesh=one, kernel=kernel)
        doc.load_single(_overflow_state(n, 8 * 65536))
        for i in range(0, len(rows), 32):
            doc.apply(rows[i:i + 32])
            doc.compact()
        docs[kernel] = doc
    got = _tier_counts(K1.apply_ops_packed)
    assert got["split"] - before["split"] == len(rows)
    for a, b in zip(mesh_state_to_numpy(docs["auto"]),
                    mesh_state_to_numpy(docs["plain"])):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="largest kernel tier"):
        ShardedDoc(_cuda.MAX_CAPACITY + 1, mesh=one)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [50, 64, 2048, 65536, 524288])
@pytest.mark.parametrize("n", [1, 3, 8, 17])
def test_exchange_kernels_match_plain_on_the_card(n, s):
    """X1, X2 and ``shard_exchange`` (the sharded document's exchange)
    against their plain versions on the card into outputs filled with a
    sentinel (``chip_smoke.hold_exchange``): 8 ops a case (inserts,
    removes, annotates, unsequenced, on the shards' ends and past the
    document's end) on ``exchange_case`` states of ``n`` shards of ``s``
    rows (50: X1 reads a row at a time, the lanes not 16-byte aligned at
    every 4th row), X2 also as a strided group with permuted stats rows;
    the accumulators come back reset."""
    _need_card()
    from chip_smoke import exchange_case, hold_exchange

    dev = torch.device("cuda", 0)
    rows = hold_exchange(dev, *exchange_case(dev, n, s, seed=n + s),
                         f"{n} x {s}", reps=0)
    assert [r["max_abs_err"] for r in rows] == [0, 0, 0]


@pytest.mark.cuda
def test_sharded_doc_exchange_kernels_equal_the_plain_clone():
    """``ShardedDoc(kernel="cuda")`` over 8 x cuda:0 (one device group)
    against its ``clone(kernel="plain")`` over a fuzz stream with
    compactions, every shard equal after every chunk; each op launches
    ``shard_exchange`` and K1 once, X1 and X2 never; one more op under
    sync-debug "error"."""
    _need_card()
    from fluidframework_tpu_torch.interop import mesh_state_to_numpy
    from fluidframework_tpu_torch.ops import shard_exchange_kernel as SX
    from fluidframework_tpu_torch.parallel.mesh import Mesh
    from fluidframework_tpu_torch.parallel.sharded_doc import ShardedDoc

    dev = torch.device("cuda", 0)
    doc = ShardedDoc(64, mesh=Mesh([dev] * 8, "seg"), kernel="cuda")
    twin = doc.clone(kernel="plain")

    def same():
        for a, b in zip(mesh_state_to_numpy(doc), mesh_state_to_numpy(twin)):
            np.testing.assert_array_equal(a, b)

    rows = _sharded_stream(np.random.default_rng(12), 128, 1, 0)
    SX.reset_counts()
    k1 = K1.apply_ops_packed.launches
    for i in range(0, len(rows), 16):
        for d in (doc, twin):
            d.apply(rows[i:i + 16])
            d.compact()
        same()
    assert SX.shard_exchange.launches == len(rows)
    assert SX.shard_stats.launches == SX.shard_resolve.launches == 0
    assert K1.apply_ops_packed.launches - k1 == len(rows)
    one = _sharded_stream(np.random.default_rng(13), 1, len(rows) + 1, 200)
    torch.cuda.set_sync_debug_mode("error")
    try:
        doc.apply(one)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    twin.apply(one)
    same()


@pytest.mark.cuda
def test_mesh_over_two_cards_equals_the_cpu():
    """Shards alternating over two cards: the mesh fleet and the sharded
    document equal their CPU runs (stream-ordered cross-card gathers)."""
    _need_card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from fluidframework_tpu_torch.interop import mesh_state_to_numpy

    devs = [torch.device("cuda", i % 2) for i in range(8)]
    ops = _mesh_ops(48, 8, 2)
    card, cpu = _mesh_fleet_run(devs, ops), _mesh_fleet_run(["cpu"] * 8, ops)
    for cap, pool in card.pools.items():
        assert torch.equal(pool.tables.cpu(), cpu.pools[cap].tables)
    rows = _sharded_stream(np.random.default_rng(6), 64, 1, 0)
    a, b = _sharded_run(devs, rows), _sharded_run(["cpu"] * 8, rows)
    for x, y in zip(mesh_state_to_numpy(a), mesh_state_to_numpy(b)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.cuda
def test_fluid_container_on_the_card_equals_the_cpu():
    """Phase 11's script at a small depth: three clients of a
    ``FluidContainer`` on the card (string, map, both hierarchy trees,
    scheduler, a data object, a dynamic string) and the drivers over the
    document equal the same script on the CPU: texts, lanes, summaries,
    saved files, snapshot bytes, attributor and scheduler."""
    _need_card()
    from chip_smoke import _same_obs, framework_script

    card = framework_script(torch.device("cuda", 0), n_ops=600, tail=120)
    cpu = framework_script(torch.device("cpu"), n_ops=600, tail=120)
    _same_obs(card, cpu, "framework")


@pytest.mark.cuda
def test_chunk_columns_to_device_on_the_card():
    """``UniformChunk.to_device`` on the card: 64-bit columns narrow to
    their 32-bit type with the CPU's bytes, and a column's sum there
    equals numpy's."""
    _need_card()
    from chip_smoke import framework_11b
    from fluidframework_tpu_torch.tree.chunked import UniformChunk

    framework_11b(torch.device("cuda", 0), 2048)
    cols = {"i": np.arange(-5, 4000, 3), "f": np.linspace(0, 1, 999),
            "b": np.arange(7) % 2 == 0, "h": np.arange(9, dtype=np.int16)}
    chunk = UniformChunk(shape=None, count=0, node_ids=[], columns=cols)
    for path, col in cols.items():
        card = chunk.to_device(path, device="cuda")
        cpu = chunk.to_device(path, device="cpu")
        assert card.device.type == "cuda" and card.dtype == cpu.dtype
        assert card.cpu().numpy().tobytes() == cpu.numpy().tobytes()
    assert int(chunk.to_device("i", device="cuda").sum()) == \
        int(cols["i"].sum())
