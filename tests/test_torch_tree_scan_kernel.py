"""T1/T2 (``ops/tree_scan_kernel.py``) on the CPU: dispatch, tiers, the
plain ring scan at the largest bucket, and the per-source kernel builds.

The kernels themselves run only on a card (``tests/test_torch_cuda.py``,
``chip_smoke.py``). Here: the scans take their plain versions for CPU
tensors and never reach a kernel entry (patched to fail); ``tier()``
takes every bucket ``EditManager.batch_ingest`` can make and raises past
the kernels' limits; the plain EditManager ring scan equals the
reference's at Lc 4,096 with R 16 on a commit that uses all 16 runs; and
``_cuda`` builds one library per source, named by its own content hash,
without ``nvcc`` (a stub compiler stands in).
"""

import hashlib
import os
import subprocess

import numpy as np
import pytest
import torch

from chip_smoke import em_case, trunk_case
from fluidframework_tpu.tree import device_em as RE
from fluidframework_tpu_torch.ops import _cuda
from fluidframework_tpu_torch.ops import tree_scan_kernel as TSK
from fluidframework_tpu_torch.tree import device_em as DE
from fluidframework_tpu_torch.tree import device_trunk as DT
from fluidframework_tpu_torch.tree import edit_manager as TEM
from fluidframework_tpu_torch.tree.edit_manager import EditManager

CPU = torch.device("cpu")
T1, T2 = "tree_trunk_scan", "tree_em_ring_scan"


def _same(a, b):
    for x, y in zip(a, b):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))


@pytest.fixture
def no_kernels(monkeypatch):
    """Make reaching either kernel entry from the scans an error."""
    def fail(*a, **k):
        raise AssertionError("a CPU tensor reached a CUDA kernel wrapper")

    monkeypatch.setattr(DT, "trunk_scan_cuda", fail)
    monkeypatch.setattr(DE, "em_ring_scan_cuda", fail)


def test_trunk_scans_take_the_plain_version_on_the_cpu(no_kernels):
    docs, L0, cb = trunk_case(CPU, 5, 24, 8, 32, 8, 0.2)
    want = DT.batched_trunk_scan_plain(docs, L0, cb, 8, device=CPU)
    _same(DT.batched_trunk_scan(docs, L0, cb, 8, device=CPU), want)
    one = DT.CommitBatch(*[x[2] for x in cb])
    _same(DT.trunk_scan(docs[2], L0[2], one, 8, device=CPU),
          [x[2] for x in want])


def test_em_scans_take_the_plain_version_on_the_cpu(no_kernels):
    (ring_ids, ring_L, ring_seq, mov), cb, U = em_case(CPU, 5, 6, 32)
    want = DE.batched_em_trunk_scan_ring_plain(ring_ids, ring_L, ring_seq,
                                               mov, cb, U, device=CPU)
    _same(DE.batched_em_trunk_scan_ring(ring_ids, ring_L, ring_seq, mov, cb,
                                        U, device=CPU), want)
    _same(DE.em_trunk_scan_ring_one(
        ring_ids[3], ring_L[3], ring_seq[3], mov[3],
        DE.EmCommitBatch(*[x[3] for x in cb]), U, device=CPU),
        [x[3] for x in want])
    base = DE.batched_em_trunk_scan(ring_ids[:, -1], ring_L[:, -1],
                                    ring_seq[:, -1], DE.EmCommitBatch(
                                        *cb[:8]), 16, U, device=CPU)
    _same(DE.em_trunk_scan_one(ring_ids[0, -1], ring_L[0, -1],
                               ring_seq[0, -1], DE.EmCommitBatch(
                                   *[x[0] for x in cb[:8]]), 16, U,
                               device=CPU), [x[0] for x in base])


def test_batch_ingest_on_cpu_managers_never_reaches_a_kernel(no_kernels):
    """The EditManager's device ingest (``_em_dispatch``) on CPU managers
    runs the plain ring scan: the kernel entries, patched to fail, are
    never reached and commits still ride the dense path."""
    from chip_smoke import em_stream

    logs = [em_stream(1000 + i, 24) for i in range(3)]
    ems = [EditManager(session=1, device="cpu") for _ in logs]
    stats = TEM.batch_ingest([(em, log, max(0, log[-1].seq - 8))
                              for em, log in zip(ems, logs)])
    assert stats["device_commits"] > 0
    for em, log in zip(ems, logs):
        host = EditManager(session=1, device="cpu")
        for c in log:
            host.add_sequenced(c)
        assert em.trunk_state == host.trunk_state


def test_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises: it has no plain path."""
    docs, L0, cb = trunk_case(CPU, 2, 4, 8, 32, 8, 0.0)
    with pytest.raises(ValueError, match="CUDA"):
        TSK.trunk_scan_cuda(docs, L0, cb, 8)
    (ring_ids, ring_L, ring_seq, mov), ecb, U = em_case(CPU, 2, 2, 32)
    with pytest.raises(ValueError, match="CUDA"):
        TSK.em_ring_scan_cuda(ring_ids, ring_L, ring_seq, mov, ecb, U)
    assert TSK.trunk_scan_cuda.launches == 0
    assert TSK.em_ring_scan_cuda.launches == 0


def test_a_hold_fails_on_a_lane_the_kernel_leaves_unwritten():
    """The smoke's holds launch a kernel into outputs filled with
    ``TREE_SENTINEL``: an unwritten lane (here: every lane) cannot equal
    the plain version, and plain lanes that hold the sentinel refuse the
    hold."""
    from chip_smoke import TREE_SENTINEL, _held, _sentinel_out

    docs, L0, cb = trunk_case(CPU, 3, 8, 8, 32, 8, 0.0)
    want = DT.batched_trunk_scan_plain(docs, L0, cb, 8, device=CPU)
    assert _held(want, want, "T1") == 0
    blank = _sentinel_out(docs, CPU)
    assert [tuple(x.shape) for x in blank] == [(3, 32), (3,), (3,)]
    with pytest.raises(AssertionError, match="kernel != plain"):
        _held(blank, want, "T1")
    part = [x.clone() for x in want]
    part[0][:, -1] = TREE_SENTINEL
    with pytest.raises(AssertionError, match="kernel != plain"):
        _held(part, want, "T1")
    with pytest.raises(AssertionError, match="sentinel"):
        _held(part, part, "T1")
    (ring_ids, *_), _cb, _U = em_case(CPU, 2, 2, 64)
    assert tuple(_sentinel_out(ring_ids, CPU)[0].shape) == (2, 64)


# The C entries' tier codes: (tier, the warp tier's ring).
_CODES = {0: ("shared", None), 1: ("global", None), 2: ("warp", "shared"),
          3: ("warp", "global")}


class _FakeTreeLib:
    """Stands in for the built tree library: its entries answer from
    ``tree_scan_kernel.placement`` and ``docs_per_cta``, the workspace
    shifted by ``skew`` ints."""

    def __init__(self, skew=0):
        def entry(kernel, what):
            def f(*args):
                t, ring = _CODES[args[-1]]
                if kernel == T1:
                    (lc, pc, W), R, U = args[:3], 0, 1
                else:
                    lc, pc, W, R, U = args[:5]
                pl = TSK.placement(kernel, lc, pc, W, U, t, R, ring)
                if pl is None:
                    return -1
                if what == 2:
                    return TSK.docs_per_cta(kernel, lc, pc, W, U, t, R, ring)
                return pl[what] + skew * what
            return f

        self.tree_smem_budget = lambda: TSK.SMEM_BYTES
        self.tree_trunk_smem_bytes = entry(T1, 0)
        self.tree_trunk_work_ints = entry(T1, 1)
        self.tree_trunk_docs = entry(T1, 2)
        self.tree_em_smem_bytes = entry(T2, 0)
        self.tree_em_work_ints = entry(T2, 1)
        self.tree_em_docs = entry(T2, 2)
        for name in ("tree_trunk_scan", "tree_em_ring_scan",
                     "tree_error_string"):
            setattr(self, name, lambda *a: 0)


def test_tree_library_is_bound_and_checked_by_its_wrapper(monkeypatch):
    """``_cuda.lib("tree")`` only loads the library; ``tree_scan_kernel.lib``
    binds its entries and checks its layout once, and refuses a library
    whose workspace layout differs from ``placement``."""
    monkeypatch.setattr(TSK, "_lib", None)
    fake = _FakeTreeLib()
    monkeypatch.setattr(_cuda, "lib", lambda name: fake)
    assert TSK.lib() is fake
    assert fake.tree_trunk_scan.restype is not None
    assert len(fake.tree_em_ring_scan.argtypes) == 26
    assert TSK.lib() is fake
    monkeypatch.setattr(TSK, "_lib", None)
    monkeypatch.setattr(_cuda, "lib", lambda name: _FakeTreeLib(skew=1))
    with pytest.raises(RuntimeError, match="layout"):
        TSK.lib()
    assert TSK._lib is None


# Every bucket batch_ingest makes: lc a power of two from 32 to
# DEVICE_MAX_LC (and one past it: ring seed states may be longer than the
# trunk), pc a power of two from 8 to lc, W = DEVICE_WINDOW, R =
# DEVICE_MAX_RUNS, U a power of two over the interned ids (up to the W
# ring states' and the inserts' distinct ids).
_LCS = [32 << i for i in range(9)]


@pytest.mark.parametrize("lc", _LCS)
def test_tier_takes_every_batch_ingest_bucket(lc):
    """Every bucket takes a tier at every document count a dispatch has
    (one document through a large batch): the warp tier where
    ``WARP_MIN_DOCS`` lets it, the shared tier where the whole state fits
    one CTA, the global tier above."""
    W, R = EditManager.DEVICE_WINDOW, EditManager.DEVICE_MAX_RUNS
    pcs = [8 << i for i in range(lc.bit_length()) if 8 << i <= lc]
    us = [1 << i for i in range(5, (2 * W * lc).bit_length() + 1)]
    for pc in pcs:
        for U in us:
            for n in (1, 7, 512, 1024, None):
                t = TSK.tier(T2, lc, pc, W, R, U, n)
                smem, work = TSK.placement(T2, lc, pc, W, U, t, R,
                                           TSK.warp_ring(T2, lc, pc, W, R, U,
                                                         n))
                assert smem <= TSK.SMEM_BYTES
                fewest = TSK.warp_min_docs(T2, lc)
                if t == "warp":
                    assert lc <= 512 and (n or 1 << 30) >= fewest
                elif t == "shared":
                    assert work == 0
                    assert lc <= 2048
                else:
                    assert TSK.placement(T2, lc, pc, W, U, "shared") is None
                    assert work >= W * lc
    want = ("warp" if lc <= 512 and lc != 128 else "shared" if lc <= 2048
            else "global")
    assert TSK.tier(T2, lc, 8, W, R, 1 << 10) == want


@pytest.mark.parametrize("W", [3, 8, 16])
@pytest.mark.parametrize("lc,pc", [(32, 8), (32, 16), (128, 32), (512, 8),
                                   (512, 32), (1024, 32), (4096, 64)])
def test_trunk_tier_takes_its_callers_shapes(lc, pc, W):
    """Every T1 caller shape takes a tier, for one document and for a
    large batch: the warp tier up to Lc 512 (past Lc 128 only with 256
    documents or more), the shared tier where the CTA's state fits, the
    global tier above."""
    e = 4 * lc + 1 + 3 * pc
    fits = 4 * (W * e + 2 * W + 2 * e + 6 * lc + 3 + 4 * pc) <= TSK.SMEM_BYTES
    for n in (1, 255, 256, None):
        t = TSK.tier(T1, lc, pc, W, n=n)
        smem, work = TSK.placement(T1, lc, pc, W, 1, t, 0,
                                   TSK.warp_ring(T1, lc, pc, W, n=n))
        assert smem <= TSK.SMEM_BYTES
        if lc <= 128 or (lc <= 512 and (n is None or n >= 256)):
            assert t == "warp"
        else:
            assert (t == "shared") == fits
        if t == "global":
            assert work >= W * e


@pytest.mark.parametrize("entry,shape,n,slice_bytes,work", [
    # 3b (7a): 1,024 documents, Lc 128, Pc 32, W 16; the workspace ring of
    # 16 changesets of 609 ints, 5 of them cached in the slice.
    (T1, (128, 32, 16, 0, 1), 1024, 27_596, 9744),
    # 7b: 1,024 documents (3c-moves 512), Lc 512, Pc 8, W 16, R 16, U 512.
    (T2, (512, 8, 16, 16, 512), 1024, 25_248, 8192),
    (T2, (512, 8, 16, 16, 512), 512, 25_248, 8192),
])
def test_config_3b_and_7b_run_on_the_shared_tier(entry, shape, n,
                                                 slice_bytes, work):
    """3b's and 7b's scans run on the warp tier with the ring in the
    workspace, 8 documents a CTA, one wave on an H100; the shared tier
    they ran on before (the CTA tier the holds time beside it) keeps its
    bytes."""
    lc, pc, W, R, U = shape
    assert TSK.tier(entry, lc, pc, W, R, U, n) == "warp"
    assert TSK.warp_ring(entry, lc, pc, W, R, U, n) == "global"
    assert TSK.placement(entry, lc, pc, W, U, "warp", R, "global") == (
        8 * slice_bytes, work)
    assert TSK.docs_per_cta(entry, lc, pc, W, U, "warp", R, "global") == 8
    assert TSK.placement(entry, lc, pc, W, U, "shared") == (
        (47_572, 0) if entry == T1 else (47_304, 0))
    assert TSK.wave_docs(8 * slice_bytes, 8) >= 1024


@pytest.mark.parametrize("entry", [T1, T2])
@pytest.mark.parametrize("ring", TSK.RINGS)
@pytest.mark.parametrize("lc", [32, 100, 128, 512, 1024, 4096])
def test_warp_placement_bytes(entry, ring, lc):
    """The warp tier's bytes for each ring placement: D documents a CTA
    (1 to WARP_MAX_D) of one slice each within SMEM_BYTES, a slice of the
    kernels' layout; the workspace holds the ring only when it lies
    there."""
    pc, W, R = max(8, lc // 8), 16, 16
    U = 4 * lc
    pl = TSK.placement(entry, lc, pc, W, U, "warp", R, ring)
    d = TSK.docs_per_cta(entry, lc, pc, W, U, "warp", R, ring)
    e = 4 * lc + 1 + 3 * pc
    if entry == T1:
        m = TSK.trunk_cache(lc, pc, W) if ring == "global" else 0
        slice_ = (((2 + m) * e if ring == "global" else W * e) + 2 * W
                  + 3 * (e + 2) + 5 * lc + 3 + 4 * pc)
        ring_ints = W * e
    else:
        s_ = 3 * lc + 1 + pc + 3 * R + 2
        slice_ = ((0 if ring == "global" else W * lc) + 2 * W + (U + 31) // 32
                  + 6 * lc + 2 + 2 * s_)
        ring_ints = W * lc
    if 4 * slice_ > TSK.SMEM_BYTES:
        assert pl is None and d is None
        return
    assert d == min(TSK.WARP_MAX_D, TSK.SMEM_BYTES // (4 * slice_))
    assert pl == (4 * slice_ * d, ring_ints if ring == "global" else 0)
    assert pl[0] <= TSK.SMEM_BYTES


def test_trunk_cache_keeps_the_documents_a_cta():
    """T1's cache of the newest ring entries is as large as leaves the
    warp tier's documents a CTA as they are without it: 5 at config 3b,
    never more than W."""
    assert TSK.trunk_cache(128, 32, 16) == 5
    assert TSK.trunk_cache(32, 8, 3) == 3
    for lc, pc, W in ((128, 32, 16), (512, 32, 16), (32, 8, 8), (64, 8, 16)):
        m = TSK.trunk_cache(lc, pc, W)
        assert 0 <= m <= min(W, TSK.WARP_CACHE_MAX)
        e = 4 * lc + 1 + 3 * pc
        base = TSK._warp_slice(T1, lc, pc, W, 0, 1, "global", cache=0)[0]
        assert TSK._warp_docs(base + m * e) == TSK._warp_docs(base)
        if m < min(W, TSK.WARP_CACHE_MAX):
            assert TSK._warp_docs(base + (m + 1) * e) < TSK._warp_docs(base)


@pytest.mark.parametrize("entry,lc,pc,R,U", [(T1, 128, 32, 0, 1),
                                             (T2, 512, 8, 16, 512),
                                             (T2, 32, 8, 16, 256)])
def test_warp_ring_follows_one_wave(entry, lc, pc, R, U):
    """The warp tier keeps the ring in the slice while the launch's
    documents all fit the card at once that way, and in the workspace past
    that; with no count, in the slice only where it costs no documents a
    CTA."""
    W = 16
    full = TSK._warp(entry, lc, pc, W, U, R, "shared")
    wave = TSK.wave_docs(full[0], full[2])
    assert TSK.warp_ring(entry, lc, pc, W, R, U, wave) == "shared"
    assert TSK.warp_ring(entry, lc, pc, W, R, U, wave + 1) == "global"
    assert TSK.warp_ring(entry, lc, pc, W, R, U) == (
        "shared" if full[2] == TSK.WARP_MAX_D else "global")


def test_warp_min_docs_by_width():
    """Which launches the warp tier takes: T1 at Lc 128 from one document,
    at Lc 512 from 256; T2 at Lc 64 from one, never at Lc 128, at Lc 256
    from 1,024 and at Lc 512 from 512; neither past Lc 512."""
    want = {T1: {32: 1, 128: 1, 256: 256, 512: 256, 1024: None},
            T2: {32: 1, 64: 1, 128: None, 256: 1024, 512: 512,
                 1024: None}}
    for entry, by_lc in want.items():
        for lc, fewest in by_lc.items():
            assert TSK.warp_min_docs(entry, lc) == fewest
            pc = 32 if entry == T1 else 8
            args = (lc, pc, 16, 16 if entry == T2 else 0, 4 * lc)
            if fewest is None:
                assert TSK.tier(entry, *args, n=1 << 20) != "warp"
            else:
                assert TSK.tier(entry, *args, n=fewest) == "warp"
                if fewest > 1:
                    assert TSK.tier(entry, *args, n=fewest - 1) != "warp"


def test_tier_codes_name_every_placement():
    """The C entries' tier codes: 0 shared, 1 global, 2 and 3 the warp
    tier with its ring in the slice or the workspace; an unknown ring or
    tier raises."""
    assert [TSK.code(*_CODES[c]) for c in range(4)] == [0, 1, 2, 3]
    assert set(TSK.TIER_CODES) == {"shared", "global", "warp"}
    with pytest.raises(ValueError):
        TSK.code("warp", "l2")
    with pytest.raises(ValueError):
        TSK.placement(T1, 128, 32, 16, 1, "warp", 0, "l2")


@pytest.mark.parametrize("entry,args", [
    (T1, (TSK.MAX_LC + 1, 32, 16)), (T1, (128, TSK.MAX_PC + 1, 16)),
    (T1, (128, 32, TSK.MAX_W + 1)), (T1, (0, 32, 16)), (T1, (128, 32, 0)),
    (T2, (4096, 8, 16, TSK.MAX_R + 1, 1024)),
    (T2, (4096, 8, 16, 16, TSK.MAX_U + 1)),
    (T2, (TSK.MAX_LC + 1, 8, 16, 16, 1024)),
    (T2, (4096, 8, TSK.MAX_W + 1, 16, 1024)), (T2, (4096, 8, 16, 16, 0)),
    ("tree_compose", (128, 32, 16)),
])
def test_tier_raises_past_the_kernels_limits(entry, args):
    with pytest.raises(ValueError):
        TSK.tier(entry, *args)


def test_merge_tier_refuses_tree_entries():
    assert set(TSK.ENTRIES) <= set(_cuda.ENTRIES)
    for entry in TSK.ENTRIES:
        assert _cuda.ENTRIES[entry] == "tree"
        with pytest.raises(ValueError, match="tree_scan_kernel.tier"):
            _cuda.tier(128, entry, 1)


def test_plain_ring_scan_equals_the_reference_at_the_largest_bucket():
    """Lc 4,096 (the global tier's bucket), R 16, 2 documents x 2
    commits; commit 1 of each uses all 16 attach runs, and the second
    document overflows Lc. Ids stay below U (9,216) so the reference's
    one-hot membership stays small."""
    lc, U = 4096, 2 * 4096 + 1024
    (ring_ids, ring_L, ring_seq, mov), cb, _U = em_case(CPU, 2, 2, lc, U=U)
    assert (cb.run_start[:, 1] >= 0).all() and cb.run_start.shape[2] == 16
    assert TSK.tier(T2, lc, cb.ins_ids.shape[2], 16, 16, U) == "global"
    got = DE.batched_em_trunk_scan_ring(ring_ids, ring_L, ring_seq, mov, cb,
                                        U, device=CPU)
    lanes = [x.numpy() for x in cb]
    want = RE.batched_em_trunk_scan_ring(
        ring_ids.numpy(), ring_L.numpy(), ring_seq.numpy(), mov.numpy(),
        RE.EmCommitBatch(*lanes), U)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert got[2][1] & DE.ERR_CAPACITY


# -- _cuda: one library per source ------------------------------------------


def test_each_source_builds_its_own_library(monkeypatch, tmp_path):
    """Without nvcc: a stub compiler writes the output file and a ptxas
    report naming its source. Each library is ``lib<stem>-<sha256[:16]>``
    of its own source; ``build_log`` holds both reports (merge first); a
    second build reuses both; an edited source gets a new name."""
    calls = []

    def fake_run(cmd, capture_output, text, timeout):
        src, out = cmd[-1], cmd[cmd.index("-o") + 1]
        assert "arch=compute_90a,code=sm_90a" in cmd
        calls.append(os.path.basename(src))
        with open(out, "w") as f:
            f.write("not a library")
        return subprocess.CompletedProcess(
            cmd, 0, "", f"ptxas info: report of {os.path.basename(src)}\n")

    monkeypatch.setattr(_cuda, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_cuda, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_cuda.subprocess, "run", fake_run)
    monkeypatch.setattr(_cuda, "_logs", {})
    monkeypatch.setattr(_cuda, "build_log", "")
    paths = {}
    for name in ("tree", "merge"):
        paths[name] = _cuda.build(name)
        src = _cuda.source(name)
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        stem = os.path.splitext(os.path.basename(src))[0]
        assert os.path.basename(paths[name]) == f"lib{stem}-{digest}.so"
        assert os.path.dirname(paths[name]) == _cuda.BUILD_DIR
    assert calls == ["tree_kernels.cu", "merge_kernels.cu"]
    assert _cuda.build_log == ("ptxas info: report of merge_kernels.cu\n"
                               "ptxas info: report of tree_kernels.cu\n")
    monkeypatch.setattr(_cuda, "_logs", {})
    assert _cuda.build("merge") == paths["merge"]
    assert _cuda.build("tree") == paths["tree"]
    assert len(calls) == 2  # reused, reports read back from disk
    assert "tree_kernels.cu" in _cuda.build_log
    edited = tmp_path / "tree_kernels.cu"
    edited.write_bytes(open(_cuda.TREE_SOURCE, "rb").read() + b"\n")
    monkeypatch.setattr(_cuda, "TREE_SOURCE", str(edited))
    assert _cuda.build("tree") != paths["tree"]
    assert len(calls) == 3
    with pytest.raises(ValueError, match="unknown kernel library"):
        _cuda.build("compose")


def test_importing_the_port_builds_nothing():
    """The libraries are built at first use, never at import."""
    import fluidframework_tpu_torch.tree.device_trunk  # noqa: F401
    import fluidframework_tpu_torch.tree.edit_manager  # noqa: F401

    assert "tree" not in _cuda._libs


def test_profile_stamps_land_in_the_kernel_source():
    """``tools/tree_scan_profile.py`` stamps ``csrc/tree_kernels.cu`` by
    text anchors (a stale one raises only when the tool runs on a card):
    both instrumented sources build their text here, every stamp lands
    once per anchor, and the CTA kernels' barriers are all stamped; the
    algebra's stamps land through the source's markers, for A1-A4."""
    from tools import tree_scan_profile as P

    def cta_part(src):
        return src[src.index("__device__ unsigned block_scan"):
                   src.index("// -- the warp tier")]

    with open(_cuda.TREE_SOURCE) as f:
        barriers = cta_part(f.read()).count("__syncthreads();")
    cta = P.instrumented_source()
    assert cta_part(cta).count("PSYNC();") == barriers > 20
    for stamp, n in (("MV_BEGIN\n", 3), ("MV_END\n", 3), ("p_load +=", 2),
                     ("p_mid +=", 2), ("p_tail +=", 2), ("++p_n;", 2),
                     ("tree_prof[(size_t)blockIdx.x", 2),
                     ("if (smem > 0) {", 1), ("tree_prof_set", 1)):
        assert cta.count(stamp) == n, stamp
    warp = P.instrumented_warp_source()
    for _anchor, j in P._WARP_STAMPS:
        assert f"WSTAMP({j});" in warp
    assert warp.count("  WSTAMP(") == len(P._WARP_STAMPS)
    assert warp.count("wlast[wid] = clock64();") == 2
    assert warp.count("tree_prof[(size_t)n * 16 + q]") == 2
    # The algebra stamps (--algebra): the source's ALG_PHASE markers,
    # empty in a normal build, defined as stamps; each kernel of A2 and A4
    # opens and closes its record, and each phase index of a kernel's
    # device function is stamped once, as P.ALG_PHASES names them.
    with open(_cuda.TREE_SOURCE) as f:
        src = f.read()
    assert "#ifndef ALG_PHASE\n#define ALG_PHASE(j)\n" in src
    alg = P.instrumented_algebra_source()
    assert (alg.index("#define ALG_PHASE(j) do")
            < alg.index("#ifndef ALG_PHASE"))
    assert alg.count("if (smem > 0) {") == 1 and "tree_prof_set" in alg

    def body(head):
        i = src.index(head)
        return src[i:src.index("\n}\n", i)]

    for entry, kernels, fn, last in (
            (P.TAK.A2, ("alg_rebase_kernel(", "alg_rebase_warp_kernel("),
             ("__device__ void rebase(", "__device__ void rebase_w("), 8),
            (P.TAK.A4, ("alg_compose_kernel(", "alg_compose_warp_kernel("),
             ("__device__ int compose(",), 13)):
        assert len(P.ALG_PHASES[entry]) == last + 1
        for k in kernels:
            b = body(k)
            for mark in ("ALG_PROF_BEGIN;", "ALG_PHASE(0);",
                         f"ALG_PHASE({last});", "ALG_PROF_END(n, "):
                assert b.count(mark) == 1, (k, mark)
        for f in fn:
            b = body(f)
            assert [b.count(f"ALG_PHASE({j});")
                    for j in range(1, last)] == [1] * (last - 1), f
    # A1 and A3: each kernel opens and closes its record, and the group's
    # device function, which every tier runs, stamps each phase once.
    for entry, kernels, fn in (
            (P.TAK.A1, ("alg_apply_kernel(", "alg_apply_warp_kernel("),
             "__device__ void apply_alg("),
            (P.TAK.A3, ("alg_invert_kernel(", "alg_invert_warp_kernel("),
             "__device__ void invert_alg(")):
        n = len(P.ALG_PHASES[entry])
        for k in kernels:
            b = body(k)
            assert b.count("ALG_PROF_BEGIN;") == 1, k
            assert b.count("ALG_PROF_END(n, ") == 1, k
            assert "ALG_PHASE(" not in b, k
        b = body(fn)
        assert [b.count(f"ALG_PHASE({j});") for j in range(n + 1)] == (
            [1] * n + [0]), fn
