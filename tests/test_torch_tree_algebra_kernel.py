"""A1-A4 (``ops/tree_algebra_kernel.py``) on the CPU: dispatch, tiers, the
wrappers' launch arguments, and the algebra against the reference.

The kernels run only on a card (``tests/test_torch_cuda.py``,
``chip_smoke.py``). Here: ``batched_*`` take the plain versions for CPU
tensors and build nothing; on a CUDA route without the library each raises
instead of falling back; ``tier()`` picks by widths and raises past the
kernels' limits, and the wrappers refuse lanes of mismatched widths. A
stand-in library rebuilds every input lane from the pointers and row
strides a wrapper passes and writes the plain version's result through the
output pointers: it holds the wrappers' marshalling (lane slices of a
commit batch, whose rows are strided, against contiguous lanes; both tiers'
workspaces; ``out=``). The four entry points, both tie forms, equal the
reference's (``fluidframework_tpu/ops/tree_kernel.py``) on well-formed,
move-bearing and raw lanes, and on compose's ties and overflowing pools, at
4-16 documents and Lc 16-64, through the plain route and through the
wrappers over the stand-in.
"""

import ctypes

import numpy as np
import pytest
import torch

from fluidframework_tpu.ops import tree_kernel as RK
from fluidframework_tpu.tree import marks as RM
from fluidframework_tpu_torch.ops import _cuda
from fluidframework_tpu_torch.ops import tree_algebra_kernel as TAK
from fluidframework_tpu_torch.ops import tree_kernel as TK
from fluidframework_tpu_torch.ops.tree_scan_kernel import MAX_LC, MAX_PC
from test_torch_tree_kernel import docs_batch, raw_lanes, same, stack
from test_tree_marks import random_change, random_change_with_moves
from test_tree_marks import random_state

PLAIN = {TAK.A1: TK.apply_change, TAK.A2: TK.rebase_change,
         TAK.A3: TK.invert_change, TAK.A4: TK.compose_change}
WRAPPERS = dict(zip(TAK.ENTRIES, TAK.WRAPPERS))


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.int32)


def _change(lanes):
    return TK.DenseChange(*[_t(x) for x in lanes])


def algebra_case(seed, kind, n, lc, pc):
    """``(ids, L, a, b over a's input, b2 over a's output)`` as numpy
    lanes. ``"ties"`` is raw lanes dense enough that compose's candidate
    keys tie and its live pools overflow ``Pc``."""
    rng = np.random.default_rng(seed)
    if kind in ("raw", "ties"):
        dense = 0.8 if kind == "ties" else 0.3
        ids = rng.integers(1, 1 << 20, (n, lc)).astype(np.int32)
        L = rng.integers(0, lc + 1, n).astype(np.int32)
        return (ids, L, *(raw_lanes(rng, n, lc, pc, dense) for _ in range(3)))
    gen = random_change_with_moves if kind == "moves" else random_change

    def attached(c):
        return sum(len(v) if t == "ins" else v[2] for t, v in c
                   if t in ("ins", "min"))

    states, a, b, b2 = [], [], [], []
    while len(states) < n:  # documents whose changes fit Lc and Pc
        s = random_state(rng, int(rng.integers(0, lc // 2 + 1)))
        ca, cb = gen(rng, s), gen(rng, s)
        mid = RM.apply(s, ca)
        cb2 = gen(rng, mid)
        if len(mid) <= lc and max(map(attached, (ca, cb, cb2))) <= pc:
            states.append(s)
            a.append(ca)
            b.append(cb)
            b2.append(cb2)
    ids, L = docs_batch(states, lc)
    return ids, L, stack(a, lc, pc), stack(b, lc, pc), stack(b2, lc, pc)


def calls(ids, L, a, b, b2):
    """``(entry, args)`` of every kernel call of the case: apply, rebase of
    b over a in both tie forms, invert, compose of a then b2."""
    return [(TAK.A1, (ids, L, a)), (TAK.A2, (b, a, L, False)),
            (TAK.A2, (b, a, L, True)), (TAK.A3, (ids, L, a)),
            (TAK.A4, (a, b2, L))]


def _flat(r):
    if isinstance(r, tuple) and isinstance(r[0], TK.DenseChange):
        return [*r[0], r[1]]
    return list(r)


# -- dispatch ------------------------------------------------------------------


def test_batched_entry_points_take_the_plain_version_on_the_cpu(
        monkeypatch):
    """CPU tensors run the plain functions: no build, no library and no
    kernel wrapper is reached, and no launch counts."""
    def fail(*a, **k):
        raise AssertionError("the CPU route reached a kernel")

    monkeypatch.setattr(_cuda, "build", fail)
    monkeypatch.setattr(_cuda, "lib", fail)
    for name in ("apply_cuda", "rebase_cuda", "invert_cuda", "compose_cuda"):
        monkeypatch.setattr(TAK, name, fail)
    TAK.reset_counts()
    ids, L, a, b, b2 = algebra_case(3, "moves", 6, 32, 16)
    A, B, B2 = _change(a), _change(b), _change(b2)
    same_t = lambda x, y: all(torch.equal(p, q)
                              for p, q in zip(_flat(x), _flat(y)))
    assert same_t(TK.batched_apply(ids, L, a, device="cpu"),
                  TK.apply_change(_t(ids), _t(L), A))
    for c_after in (False, True):
        assert same_t(TK.batched_rebase(b, a, L, c_after, device="cpu"),
                      TK.rebase_change(B, A, _t(L), c_after))
    assert same_t(TK.batched_invert(ids, L, a, device="cpu"),
                  TK.invert_change(_t(ids), _t(L), A))
    assert same_t(TK.batched_compose(a, b2, L, device="cpu"),
                  TK.compose_change(A, B2, _t(L)))
    assert all(w.launches == 0 for w in TAK.WRAPPERS)


def test_cuda_route_without_the_library_raises(monkeypatch):
    """On the CUDA route each entry point goes to its kernel's wrapper, and
    where the library cannot be built it raises: the plain functions
    (patched to fail) are never reached and nothing counts a launch."""
    def fail(*a, **k):
        raise AssertionError("the CUDA route fell back to the plain version")

    def no_nvcc(name="merge"):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(TK, "resolve_device", lambda d: torch.device("cuda"))
    monkeypatch.setattr(TK, "to_device", lambda x, dev: _t(x))
    monkeypatch.setattr(TAK, "_check", lambda ts, what: None)
    monkeypatch.setattr(TAK, "_lib", None)
    monkeypatch.setattr(_cuda, "lib", no_nvcc)
    for name in ("apply_change", "rebase_change", "invert_change",
                 "compose_change"):
        monkeypatch.setattr(TK, name, fail)
    TAK.reset_counts()
    ids, L, a, b, _b2 = algebra_case(1, "plain", 4, 16, 8)
    for call in (lambda: TK.batched_apply(ids, L, a),
                 lambda: TK.batched_rebase(b, a, L),
                 lambda: TK.batched_rebase(b, a, L, True),
                 lambda: TK.batched_invert(ids, L, a),
                 lambda: TK.batched_compose(a, b, L)):
        with pytest.raises(RuntimeError, match="nvcc"):
            call()
    assert all(w.launches == 0 for w in TAK.WRAPPERS)


# -- tiers and shapes ----------------------------------------------------------


@pytest.mark.parametrize("lc,pc,want", [
    # 3b's and 3c's widths: every entry's region fits one CTA.
    (128, 32, "shared"), (512, 8, "shared"), (2048, 8, "shared"),
    # Rebase and compose carry three changes: past shared memory at 4,096.
    (4096, 32, {TAK.A1: "shared", TAK.A2: "global", TAK.A3: "shared",
                TAK.A4: "global"}),
    # Apply and invert stage no change: their scratch fits one CTA to Lc
    # 28,000 and more.
    pytest.param(8192, 32, {TAK.A1: "shared", TAK.A2: "global",
                            TAK.A3: "shared", TAK.A4: "global"},
                 id="8192-32-global"),
    (MAX_LC, MAX_PC, "global"),
])
def test_tier_picks_shared_or_global_by_widths(monkeypatch, lc, pc, want):
    """Where the warp tier does not run (no threshold table), the region's
    size picks the CTA tier."""
    monkeypatch.setattr(TAK, "WARP_MIN_DOCS", {})
    for entry in TAK.ENTRIES:
        t = TAK.tier(entry, lc, pc)
        assert t == (want[entry] if isinstance(want, dict) else want)
        smem, work = TAK.placement(entry, lc, pc, t)
        assert smem <= TAK.SMEM_BYTES
        assert (work > 0) == (t == "global")
        assert work == 0 or work == TAK.region_ints(entry, lc, pc, "global")
    assert TAK.placement(TAK.A4, 128, 32, "shared") == (13_364, 0)


def test_tier_takes_the_warp_tier_by_document_count(monkeypatch):
    """``tier()`` gives an entry the warp tier from the fewest documents
    :data:`WARP_MIN_DOCS` names for the widths, one document below it the
    CTA tier; at widths the table does not name (the sweep's neighbours
    included), where a slice does not fit, and for an entry it does not
    name, never. The table itself, on both sides of each of its thresholds,
    and a stand-in table for rebase and compose."""
    for entry in TAK.ENTRIES:
        table = TAK.WARP_MIN_DOCS.get(entry, {})
        for (lc, pc), fewest in table.items():
            assert TAK.tier(entry, lc, pc, fewest) == "warp"
            assert TAK.tier(entry, lc, pc, 10 ** 6) == "warp"
            assert TAK.tier(entry, lc, pc) == "warp"
            if fewest > 1:
                assert TAK.tier(entry, lc, pc, fewest - 1) == "shared"
            for other in ((lc - 1, pc), (lc + 1, pc), (lc, pc - 1),
                          (lc, pc + 1)):
                if other not in table:
                    assert TAK.tier(entry, *other, 10 ** 6) != "warp"
    table = {(64, 8): 1, (512, 8): 300}
    monkeypatch.setattr(TAK, "WARP_MIN_DOCS", {TAK.A2: table, TAK.A4: table})
    for entry in TAK.ENTRIES:
        has = entry in (TAK.A2, TAK.A4)
        for lc, pc, n, warp in ((64, 8, 1, True), (63, 8, 1024, False),
                                (64, 16, 10 ** 6, False),
                                (128, 8, 10 ** 6, False),
                                (512, 8, 299, False), (512, 8, 300, True),
                                (512, 8, None, True),
                                (513, 8, 10 ** 6, False)):
            got = TAK.tier(entry, lc, pc, n)
            assert got == ("warp" if warp and has else "shared"), (entry,
                                                                   lc, n)
    # Past the slice's limit the warp tier cannot take the width at all.
    table = {(8192, 32): 1, (2048, 8): 1, (4096, 8): 1}
    monkeypatch.setattr(TAK, "WARP_MIN_DOCS", {TAK.A2: table, TAK.A4: table})
    assert TAK.tier(TAK.A4, 8192, 32, 1024) == "global"
    assert TAK.tier(TAK.A2, 2048, 8, 1024) == "warp"
    assert TAK.tier(TAK.A4, 4096, 8, 1024) == "global"
    assert TAK.tier(TAK.A1, 2048, 8, 1024) == "shared"


def test_warp_tier_placement():
    """A warp-tier CTA holds as many documents' slices as fit
    :data:`SMEM_BYTES`, at most :data:`WARP_MAX_D`, no workspace; a
    slice is rebase's region without its landing positions, and compose's,
    apply's and invert's whole region (apply's and invert's stage no
    change, so their regions are the same on every tier)."""
    for lc, pc, docs in ((128, 32, {TAK.A1: 8, TAK.A2: 8, TAK.A3: 8,
                                    TAK.A4: 8}),
                         (512, 8, {TAK.A1: 8, TAK.A2: 7, TAK.A3: 8,
                                   TAK.A4: 5}),
                         (2048, 8, {TAK.A1: 8, TAK.A2: 1, TAK.A3: 8,
                                    TAK.A4: 1}),
                         (4096, 8, {TAK.A1: 7, TAK.A2: None, TAK.A3: 7,
                                    TAK.A4: None})):
        for entry in TAK.ENTRIES:
            pl = TAK.placement(entry, lc, pc, "warp")
            if docs[entry] is None:
                assert pl is None
                continue
            ints = TAK.region_ints(entry, lc, pc, "warp")
            assert pl == (4 * ints * docs[entry], 0)
            assert min(TAK.WARP_MAX_D, TAK.SMEM_BYTES // (4 * ints)) == (
                docs[entry])
    e = 4 * 128 + 1 + 3 * 32
    assert TAK.region_ints(TAK.A2, 128, 32, "warp") == (
        TAK.region_ints(TAK.A2, 128, 32, "shared") - 128) == (
        3 * e + 3 * 129 + 128)
    assert TAK.region_ints(TAK.A4, 128, 32, "warp") == (
        TAK.region_ints(TAK.A4, 128, 32, "shared")) == 3341
    # The global tier reads its inputs where they lie: no staged changes.
    # Apply and invert read theirs in place on every tier: bcum and dex,
    # the staged pool lanes and apply's move-in positions and sums.
    assert TAK.region_ints(TAK.A4, 128, 32, "global") == 3341 - 2 * e
    for t in TAK.TIER_CODES:
        assert TAK.region_ints(TAK.A1, 128, 32, t) == 2 * 129 + 5 * 32
        assert TAK.region_ints(TAK.A3, 128, 32, t) == 2 * 129 + 2 * 32
    assert TAK.placement(TAK.A4, 128, 32, "warp") == (8 * 13_364, 0)
    assert TAK.placement(TAK.A4, 512, 8, "warp") == (5 * 45_620, 0)


@pytest.mark.parametrize("entry,lc,pc", [
    (TAK.A1, 0, 8), (TAK.A2, MAX_LC + 1, 8), (TAK.A3, 128, 0),
    (TAK.A4, 128, MAX_PC + 1), ("tree_trunk_scan", 128, 32),
])
def test_tier_raises_past_the_kernels_limits(entry, lc, pc):
    with pytest.raises(ValueError):
        TAK.tier(entry, lc, pc)


def test_wrappers_refuse_mismatched_widths_and_cpu_tensors():
    """A lane of the wrong width, a second change of another Pc, documents
    or L of another shape raise ``ValueError``; so do CPU tensors of the
    right shapes (a wrapper launches its kernel or raises)."""
    ids, L, a, b, _b2 = (_t(x) if not isinstance(x, tuple) else _change(x)
                         for x in algebra_case(2, "raw", 4, 16, 8))
    short = a._replace(ins_cnt=a.ins_cnt[:, :16])
    other = TK.DenseChange(*_change(raw_lanes(np.random.default_rng(0), 4,
                                              16, 4)))
    for call in (lambda: TAK.apply_cuda(ids, L, short),
                 lambda: TAK.apply_cuda(ids[:, :8], L, a),
                 lambda: TAK.invert_cuda(ids, L[:3], a),
                 lambda: TAK.rebase_cuda(a, other, L),
                 lambda: TAK.compose_cuda(short, b, L)):
        with pytest.raises(ValueError, match="must be"):
            call()
    TAK.reset_counts()
    for call in (lambda: TAK.apply_cuda(ids, L, a),
                 lambda: TAK.rebase_cuda(b, a, L, True),
                 lambda: TAK.invert_cuda(ids, L, a),
                 lambda: TAK.compose_cuda(a, b, L)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert all(w.launches == 0 for w in TAK.WRAPPERS)


# -- the wrappers' launch arguments, through a stand-in library ---------------


def _view(ptr, stride, n, w=None):
    """The host int32 lane at ``ptr``: ``[n, w]`` rows ``stride`` ints
    apart, or ``[n]`` elements ``stride`` apart where ``w`` is None."""
    count = (n - 1) * stride + (w or 1)
    base = np.ctypeslib.as_array((ctypes.c_int32 * count).from_address(ptr))
    if w is None:
        return torch.from_numpy(np.lib.stride_tricks.as_strided(
            base, (n,), (4 * stride,)))
    return torch.from_numpy(np.lib.stride_tricks.as_strided(
        base, (n, w), (4 * stride, 4)))


class _FakeAlgebraLib:
    """Stands in for the built tree library: each entry rebuilds its input
    lanes from the pointers and row strides it is given, runs the plain
    version on them and writes every output lane through the output
    pointers; the layout entries answer from ``placement`` (the workspace
    shifted by ``skew`` ints). ``calls`` records (entry, N, Lc, Pc, the
    extra ints, tier code, a workspace given, the strides)."""

    def __init__(self, skew=0, warp_skew=0):
        self.calls = []
        self.tree_smem_budget = lambda: TAK.SMEM_BYTES
        self.tree_error_string = lambda e: b"error"

        def layout(what):
            def f(op, lc, pc, code):
                t = next(k for k, v in TAK.TIER_CODES.items() if v == code)
                pl = TAK.placement(TAK.ENTRIES[op], lc, pc, t)
                if pl is None:
                    return -1
                return (pl[what] + skew * what
                        + warp_skew * (t == "warp" and what == 0))
            return f

        self.tree_algebra_smem_bytes = layout(0)
        self.tree_algebra_work_ints = layout(1)
        for entry in TAK.ENTRIES:
            setattr(self, entry, self._entry(entry))

    def _entry(self, entry):
        def run(in_p, in_s, out_p, work, N, Lc, Pc, *rest):
            extra, code = rest[:-2], rest[-2]
            n_in = 9 if entry in (TAK.A1, TAK.A3) else 15
            widths = [Lc, Lc + 1, Pc, Lc, Lc, Pc, Pc]
            if entry in (TAK.A1, TAK.A3):
                lanes = ([_view(in_p[0], in_s[0], N, Lc),
                          _view(in_p[1], in_s[1], N)]
                         + [_view(in_p[2 + q], in_s[2 + q], N, w)
                            for q, w in enumerate(widths)])
                args = (lanes[0], lanes[1], TK.DenseChange(*lanes[2:]))
            else:
                ch = [TK.DenseChange(*[
                    _view(in_p[7 * c + q], in_s[7 * c + q], N, w)
                    for q, w in enumerate(widths)]) for c in (0, 1)]
                args = (*ch, _view(in_p[14], in_s[14], N))
            if entry == TAK.A2:
                args += (bool(extra[0]),)
            got = _flat(PLAIN[entry](*args))
            for q, x in enumerate(got):
                _view(out_p[q], x.shape[1] if x.dim() == 2 else 1, N,
                      x.shape[1] if x.dim() == 2 else None).copy_(x)
            self.calls.append((entry, N, Lc, Pc, tuple(extra), code,
                               work is not None,
                               [in_s[q] for q in range(n_in)]))
            return 0
        return run


@pytest.fixture
def fake_lib(monkeypatch):
    """The wrappers over :class:`_FakeAlgebraLib` on CPU tensors."""
    fake = _FakeAlgebraLib()
    monkeypatch.setattr(TAK, "_lib", None)
    monkeypatch.setattr(_cuda, "lib", lambda name: fake)
    monkeypatch.setattr(TAK, "_check", lambda ts, what: None)
    monkeypatch.setattr(TAK, "_stream", lambda dev: None)
    TAK.reset_counts()
    yield fake
    TAK.reset_counts()


def test_library_is_bound_and_checked_by_its_wrapper(monkeypatch):
    """``tree_algebra_kernel.lib`` binds A1-A4 and checks the library's
    layout once, and refuses a library whose workspace or warp slice
    differs from ``placement``."""
    monkeypatch.setattr(TAK, "_lib", None)
    fake = _FakeAlgebraLib()
    monkeypatch.setattr(_cuda, "lib", lambda name: fake)
    assert TAK.lib() is fake and TAK.lib() is fake
    assert len(fake.tree_rebase.argtypes) == 10
    assert len(fake.tree_compose.argtypes) == 9
    for bad in (_FakeAlgebraLib(skew=1), _FakeAlgebraLib(warp_skew=4)):
        monkeypatch.setattr(TAK, "_lib", None)
        monkeypatch.setattr(_cuda, "lib", lambda name, bad=bad: bad)
        with pytest.raises(RuntimeError, match="layout"):
            TAK.lib()
        assert TAK._lib is None


@pytest.mark.parametrize("t", ["shared", "global", "warp"])
def test_strided_lane_slices_equal_contiguous_lanes(fake_lib, t):
    """Lane slices ``x[:, k]`` of a ``[N, C, w]`` commit batch (and an L
    slice) reach the library as row strides, with no copy, and give the
    plain version's result on contiguous lanes, into sentinel-filled
    ``out`` lanes too; each call is one launch on the tier asked for, the
    global tier with a workspace."""
    n, C, lc, pc = 5, 3, 24, 8
    rng = np.random.default_rng(11)
    commits = [raw_lanes(rng, n, lc, pc) for _ in range(C)]
    batch = [_t(np.stack([c[q] for c in commits], 1)) for q in range(7)]
    a = TK.DenseChange(*[x[:, 1] for x in batch])
    b = TK.DenseChange(*[x[:, 2] for x in batch])
    ids = _t(rng.integers(1, 1 << 20, (n, lc)))
    Lb = _t(rng.integers(0, lc + 1, (n, 2)))
    L = Lb[:, 1]
    ac, bc = (TK.DenseChange(*[x.contiguous() for x in c]) for c in (a, b))
    for entry, args in calls(ids, L, a, b, b):
        if TAK.placement(entry, lc, pc, t) is None:
            with pytest.raises(ValueError, match="cannot take"):
                WRAPPERS[entry](*args, t=t)
            continue
        cont = tuple(ac if x is a else bc if x is b else
                     x.contiguous() if torch.is_tensor(x) else x
                     for x in args)
        want = _flat(PLAIN[entry](*cont))
        w = WRAPPERS[entry]
        before = (w.launches, getattr(w, f"launches_{t}"))
        got = _flat(w(*args, t=t))
        assert all(torch.equal(x, y) for x, y in zip(got, want)), entry
        sent = [torch.full_like(x, -0x5EED) for x in want]
        out = (tuple(sent) if entry == TAK.A1 else
               (TK.DenseChange(*sent[:7]), sent[7]) if entry == TAK.A4
               else TK.DenseChange(*sent))
        got = _flat(w(*args, out=out, t=t))
        assert all(x is y for x, y in zip(got, sent))
        assert all(torch.equal(x, y) for x, y in zip(sent, want)), entry
        assert (w.launches, getattr(w, f"launches_{t}")) == (
            before[0] + 2, before[1] + 2)
    strides = {e: s for e, _N, _lc, _pc, _x, _c, _w, s in fake_lib.calls}
    assert strides[TAK.A1] == [lc, 2] + [C * w for w in
                                         (lc, lc + 1, pc, lc, lc, pc, pc)]
    assert strides[TAK.A4][14] == 2
    assert {(c[5], c[6]) for c in fake_lib.calls} == {
        (TAK.TIER_CODES[t], t == "global")}
    assert {c[4] for c in fake_lib.calls if c[0] == TAK.A2} == {(0,), (1,)}


def test_empty_batches_launch_nothing(fake_lib):
    ids, L, a, b, b2 = (_t(x) if not isinstance(x, tuple) else _change(x)
                        for x in algebra_case(0, "raw", 0, 16, 8))
    for entry, args in calls(ids, L, a, b, b2):
        got = _flat(WRAPPERS[entry](*args))
        assert all(x.shape[0] == 0 for x in got)
    assert fake_lib.calls == [] and all(w.launches == 0
                                        for w in TAK.WRAPPERS)


# -- against the reference -----------------------------------------------------


def _reference(entry, ids, L, a, b, b2, c_after):
    ra, rb, rb2 = (RK.DenseChange(*x) for x in (a, b, b2))
    if entry == TAK.A1:
        return RK.batched_apply(ids, L, ra)
    if entry == TAK.A2:
        return RK.batched_rebase(rb, ra, L, c_after)
    if entry == TAK.A3:
        return RK.batched_invert(ids, L, ra)
    return RK.batched_compose(ra, rb2, L)


def _port(entry, ids, L, a, b, b2, c_after):
    if entry == TAK.A1:
        return TK.batched_apply(ids, L, a, device="cpu")
    if entry == TAK.A2:
        return TK.batched_rebase(b, a, L, c_after, device="cpu")
    if entry == TAK.A3:
        return TK.batched_invert(ids, L, a, device="cpu")
    return TK.batched_compose(a, b2, L, device="cpu")


SHAPES = [(4, 16, 8), (12, 48, 16), (16, 64, 32)]


@pytest.mark.parametrize("kind", ["plain", "moves", "raw", "ties"])
@pytest.mark.parametrize("n,lc,pc", SHAPES)
def test_algebra_equals_the_reference(fake_lib, kind, n, lc, pc):
    """Every entry point and tie form equals the reference in every lane,
    through the plain route and through the wrappers over the stand-in
    library on every tier of the entry; the ``ties`` lanes hold tied
    candidate keys and overflowing pools in compose."""
    ids, L, a, b, b2 = algebra_case(n * 7 + lc, kind, n, lc, pc)
    if kind == "ties":
        keys = TK.compose_keys(_change(a), _change(b2), _t(L))
        srt = torch.sort(keys, 1).values
        live = srt < keys.shape[1] + 2
        assert ((srt[:, 1:] == srt[:, :-1]) & live[:, 1:]).any()
        assert (live.sum(1) > pc).any()
    T = tuple(_t(x) if not isinstance(x, tuple) else _change(x)
              for x in (ids, L, a, b, b2))
    for entry, args in calls(*T):
        c_after = entry == TAK.A2 and args[3]
        want = _reference(entry, ids, L, a, b, b2, c_after)
        what = f"{entry} c_after={c_after}"
        same(want, _port(entry, ids, L, a, b, b2, c_after), what)
        for t in TAK.TIER_CODES:
            if TAK.placement(entry, lc, pc, t) is not None:
                same(want, WRAPPERS[entry](*args, t=t), f"{what} on {t}")


# -- compose's rank and the two copies of the rebase device code ------------


def chunked_counting_rank(keys, pc):
    """A numpy model of compose's rank on the warp and shared tiers
    (``csrc/tree_kernels.cu``, ``compose``): ``slot [Pc]``, the candidate
    index of each rank below ``pc``, for one document's candidate keys
    (live below ``len(keys) + 2``). Negative keys take the comparison
    count; the others a histogram's exclusive scan and one warp's walk in
    index order, 32 candidates a step: equal keys of a step (the
    ``__match_any_sync`` peers) rank by lane after the cursor of their key,
    which the group's lowest lane then advances by the group's size."""
    keys = np.asarray(keys, np.int64)
    nc = len(keys)
    big = nc + 2
    slot = np.full(pc, -1, np.int64)
    live = keys < big
    neg = live & (keys < 0)
    n_neg = int(neg.sum())
    for j in np.flatnonzero(neg):
        r = int((keys < keys[j]).sum() + (keys[:j] == keys[j]).sum())
        if r < pc:
            slot[r] = j
    pos = np.zeros(big + 1, np.int64)
    np.add.at(pos, keys[live & ~neg] + 1, 1)
    pos = np.cumsum(pos)  # pos[v]: the live keys in [0, v)
    for j0 in range(0, nc, 32):
        chunk = keys[j0:j0 + 32]
        ranked = (chunk >= 0) & (chunk < big)
        for lane in np.flatnonzero(ranked):
            peers = np.flatnonzero(ranked & (chunk == chunk[lane]))
            r = n_neg + pos[chunk[lane]] + int((peers < lane).sum())
            if r < pc:
                slot[r] = j0 + lane
        for v in np.unique(chunk[ranked]):
            pos[v] += int((chunk[ranked] == v).sum())
    return slot


@pytest.mark.parametrize("seed", range(6))
def test_chunked_counting_rank_is_the_stable_argsort(seed):
    """The chunked stable counting rank equals ``torch.argsort(stable=
    True)`` kept to Pc: on keys with many ties across and inside 32-wide
    steps, negative keys, dead keys (at and past BIG) and more live keys
    than Pc, and on compose's own candidate keys of raw lanes."""
    rng = np.random.default_rng(seed)
    nc = int(rng.integers(40, 300))
    big = nc + 2
    keys = rng.integers(0, max(2, nc // 8), nc)
    keys[rng.random(nc) < 0.3] = big + rng.integers(0, 3)
    if seed % 2:
        keys[rng.random(nc) < 0.1] = -rng.integers(1, 4)
    for pc in (1, 7, nc // 3, nc):
        order = torch.argsort(torch.as_tensor(keys), stable=True)[:pc]
        n_live = int((keys < big).sum())
        want = np.where(np.arange(pc) < n_live, order.numpy(), -1)
        assert (chunked_counting_rank(keys, pc) == want).all()
        assert n_live > pc or pc == nc
    ids, L, a, b, b2 = algebra_case(seed, "ties", 4, 48, 16)
    ck = TK.compose_keys(_change(a), _change(b2), _t(L)).numpy()
    for row in ck:
        order = torch.argsort(torch.as_tensor(row), stable=True)[:16]
        live = int((row < len(row) + 2).sum())
        want = np.where(np.arange(16) < live, order.numpy(), -1)
        assert (chunked_counting_rank(row, 16) == want).all()


# -- A1's and A3's chunked passes and A1's move-in resolution -------------


def _w32(x) -> int:
    """``x`` wrapped to int32, as the kernels' int arithmetic wraps."""
    return (int(x) + (1 << 31)) % (1 << 32) - (1 << 31)


def _icnt_fast() -> int:
    with open(_cuda.TREE_SOURCE) as f:
        src = f.read()
    i = src.index("constexpr int ICNT_FAST = ")
    return int(src[i:src.index(";", i)].split("=")[1])


def chunked_apply_invert(doc, L, c, T):
    """A numpy model of A1 and A3 (``apply_alg`` and ``invert_alg`` in
    ``csrc/tree_kernels.cu``) for one document on a group of ``T``
    threads: ``(new_ids, new_L, inverse lanes, slow)``. Each thread takes
    a chunk of the slots and boundaries (the thread with the last slots
    also boundary Lc). Pass 1 sums its detach counts, attach counts and
    detached slots; the chunks' exclusive offsets follow in thread order.
    Pass 2 walks each chunk again: survivors scatter (apply), detached
    slots take their attach and pool entry (invert), and where every
    attach count past the first boundary lies in [0, ICNT_FAST] (so the
    prefix sum cannot fall) each boundary b takes the atoms with bcum[b -
    1] <= k < bcum[b]; otherwise every atom searches the whole prefix sum
    (``slow``). Apply's live move-in atoms record their positions; then
    every slot below L with a move tag adds its value at each recorded
    atom with that tag."""
    del_, ins, ids, mid, moff, pmid, poff = (np.asarray(x, np.int64)
                                             for x in c)
    doc = np.asarray(doc, np.int64)
    L = int(L)
    lc, pc = len(del_), len(ids)
    fast_max = _icnt_fast()
    per = -(-lc // T)
    chunks = []
    for t in range(T):
        lo = min(lc, t * per)
        hi = min(lc, lo + per)
        chunks.append((lo, hi, hi + int(hi == lc and lo < hi)))

    def d_at(j):
        return max(int(del_[j]), int(mid[j] > 0)) * int(j < L)

    def ic_at(b):
        return int(ins[b]) * int(b <= L)

    sums, risky = [], False
    for lo, hi, hib in chunks:
        s = [0, 0, 0]
        for j in range(lo, hib):
            if j < lc:
                s[0] += d_at(j)
                s[2] += d_at(j) != 0
            ic = ic_at(j)
            s[1] += ic
            risky |= ic > fast_max or (j > 0 and ic < 0)
        sums.append(s)
    offs = np.cumsum([[0, 0, 0]] + sums[:-1], 0)
    tot = [_w32(x) for x in np.sum(sums, 0)]
    n_atoms = min(pc, tot[1])
    out = np.zeros(lc, np.int64)
    inv = [np.zeros(n, np.int64) for n in (lc, lc + 1, pc, lc, lc, pc, pc)]
    listed = []  # apply's recorded move-in atoms: (pmid, poff, ip)
    bcum = np.zeros(lc + 1, np.int64)
    dex = np.zeros(lc + 1, np.int64)
    bad = False

    def atom(k, ip):
        if not 0 <= ip < lc:
            return
        if pmid[k] > 0:
            listed.append((pmid[k], poff[k], ip))
            inv[3][ip] += pmid[k]
            inv[4][ip] += poff[k]
        else:
            out[ip] += ids[k]
            inv[0][ip] += pmid[k] == 0

    for (lo, hi, hib), off in zip(chunks, offs):
        dx, bc, dc = (_w32(x) for x in off)
        for j in range(lo, hib):
            bprev, bc = bc, _w32(bc + ic_at(j))
            if not risky:
                for k in range(max(0, bprev), min(bc, n_atoms)):
                    atom(k, _w32(j - dx + k))
            else:
                bcum[j], dex[j] = bc, dx
                bad |= j > 0 and bc < bprev
            if j < lc:
                d = d_at(j)
                if j < L and d == 0:
                    sp = _w32(j - dx + bc)
                    if 0 <= sp < lc:
                        out[sp] += doc[j]
                if d != 0:
                    sp = _w32(j - dx + bc)
                    if 0 <= sp <= lc:
                        inv[1][sp] += 1
                    if dc < pc:
                        inv[2][dc] = doc[j] if del_[j] != 0 else 0
                        inv[5][dc] = mid[j] if mid[j] > 0 else 0
                        inv[6][dc] = moff[j] if mid[j] > 0 else 0
                    dc += 1
                dx = _w32(dx + d)
    if risky:
        for k in range(max(0, n_atoms)):
            b = (int(np.searchsorted(bcum, k, "right")) if not bad
                 else int((bcum <= k).sum()))
            atom(k, _w32(b - dex[min(max(b, 0), lc)] + k))
    for lo, hi, _hib in chunks:
        for j in range(lo, hi):
            if j < L and mid[j] > 0:
                for pm, po, ip in listed:
                    if (pm, po) == (mid[j], moff[j]):
                        out[ip] += doc[j]
    new_L = _w32(L - tot[0] + tot[1])
    w = np.vectorize(_w32)
    return w(out), new_L, [w(x) for x in inv], risky


@pytest.mark.parametrize("T", [32, 128])
@pytest.mark.parametrize("kind", ["moves", "raw", "ties", "wrap"])
def test_chunked_apply_and_invert_are_the_plain_versions(kind, T):
    """The numpy model of A1's and A3's kernels equals ``apply_change`` and
    ``invert_change`` on well-formed changes with moves and on raw lanes:
    duplicate move tags, tags no slot holds and slots no atom takes, pools
    past the live count, several writers to a position, and (``wrap``)
    attach counts that are negative or wrap the prefix sum past 2^31,
    which take the searching path; chunks of one and of several slots a
    thread (a warp, a CTA)."""
    seen = set()
    for n, lc, pc in ((8, 48, 16), (3, 200, 9)):
        rng = np.random.default_rng(lc + T)
        if kind == "wrap":
            ids = rng.integers(1, 1 << 20, (n, lc)).astype(np.int32)
            L = rng.integers(lc // 2, lc + 1, n).astype(np.int32)
            a = list(raw_lanes(rng, n, lc, pc))
            a[1] = a[1].copy()
            a[1][1::4, 1::7] = -1
            a[1][2::4, rng.integers(1, lc, 3)] = 1 << 30
        else:
            ids, L, a, _b, _b2 = algebra_case(lc * 3 + T, kind, n, lc, pc)
        ca = _change(a)
        want_ids, want_L = TK.apply_change(_t(ids), _t(L), ca)
        want_inv = TK.invert_change(_t(ids), _t(L), ca)
        for r in range(n):
            got_ids, got_L, inv, slow = chunked_apply_invert(
                ids[r], L[r], [x[r] for x in a], T)
            seen.add(slow)
            assert (got_ids == want_ids[r].numpy()).all(), (kind, r)
            assert got_L == int(want_L[r])
            for x, y in zip(inv, want_inv):
                assert (x == y[r].numpy()).all(), (kind, r)
    assert seen == ({True, False} if kind == "wrap" else {False})


def test_apply_resolves_move_ins_from_the_slots():
    """A1's and A3's bodies walk only each thread's own chunk (``each_elem``)
    and never the whole slot range from a fixed start; A1's move-in atoms
    are resolved from the slots: each live move-in atom records its
    position, and every warp sums its slots' values with each recorded
    atom's tag, a batch of a thread's slots at a time, one add a warp."""
    with open(_cuda.TREE_SOURCE) as f:
        src = f.read()
    for head in ("template <class G>\n__device__ void apply_alg(",
                 "template <class G>\n__device__ void invert_alg("):
        body = _device_fn(src, head)
        assert "j < L && j < Lc" not in body and "for (int j = 0;" not in body
        assert "each_elem(r, held, [&](int j, const Elem &e) {" in body
    body = _device_fn(src, "template <class G>\n__device__ void apply_alg(")
    assert "for (int b = 0; b * BATCH < per; ++b) {" in body
    assert "for (int k = 0; k < n_atoms; ++k) {" in body
    assert "e[q].mid == pm && e[q].moff == po" in body
    assert "v = __reduce_add_sync(FULL, v);" in body
    walk = _device_fn(src, "template <class F>\n"
                      "__device__ __forceinline__ void each_elem(")
    assert "for (int j0 = r.lo + BATCH; j0 < r.hib; j0 += BATCH)" in walk


def _device_fn(src, head):
    """The body of device function ``head`` (its signature's opening) in
    the kernel source."""
    i = src.index(head)
    j = src.index("\n}\n", i)
    return src[i:j]


def test_rebase_w_serves_both_tie_forms_in_rebase_words():
    """``csrc/tree_kernels.cu`` holds two copies of the rebase device code,
    ``rebase`` (CTA tiers) and ``rebase_w`` (warp tiers), both templates on
    ``C_AFTER``; each C_AFTER branch is described in both in the same words
    and is the same test: the atom's boundary without o's attaches, a
    move-in atom also dead where o moved its source, c's move-out dropped
    where o moved the unit."""
    with open(_cuda.TREE_SOURCE) as f:
        src = f.read()
    assert src.count("__device__ void rebase") == 2
    cta = _device_fn(src, "template <bool C_AFTER>\n__device__ void rebase(")
    warp = _device_fn(src,
                      "template <bool C_AFTER>\n__device__ void rebase_w(")
    for words in ("// b_map at the atom's boundary: b - Dex_b + (bcum - icnt)"
                  " of o\n    // (C_AFTER: + bcum).",
                  "A move-in atom of c dies when o deleted its source slot "
                  "(C_AFTER:",
                  "// C_AFTER: o's move wins, c's move-out of the unit is "
                  "dropped.",
                  "const int oicnt = C_AFTER ? 0 : o.ins[cb] * (int)(cb <= "
                  "L);",
                  "((C_AFTER && o.mid[i] > 0) || o.del[i] > 0);",
                  "if (c.mid[i] > 0 && !(C_AFTER && o.mid[i] > 0)) {"):
        assert words in cta and words in warp, words
    # T1's warp kernel keeps the false instance; A2's warp kernel takes both.
    assert src.count("rebase_w<false>(") == 2
    assert "rebase_w<C_AFTER>(" in src
    assert "alg_rebase_warp_kernel<true>" in src
