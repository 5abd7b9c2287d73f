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
    (8192, 32, "global"), (MAX_LC, MAX_PC, "global"),
])
def test_tier_picks_shared_or_global_by_widths(lc, pc, want):
    for entry in TAK.ENTRIES:
        t = TAK.tier(entry, lc, pc)
        assert t == (want[entry] if isinstance(want, dict) else want)
        smem, work = TAK.placement(entry, lc, pc, t)
        assert smem <= TAK.SMEM_BYTES
        assert (work > 0) == (t == "global")
        assert work == 0 or work == TAK.region_ints(entry, lc, pc, "global")
    assert TAK.placement(TAK.A4, 128, 32, "shared") == (14_624, 0)


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

    def __init__(self, skew=0):
        self.calls = []
        self.tree_smem_budget = lambda: TAK.SMEM_BYTES
        self.tree_error_string = lambda e: b"error"

        def layout(what):
            def f(op, lc, pc, code):
                t = next(k for k, v in TAK.TIER_CODES.items() if v == code)
                pl = TAK.placement(TAK.ENTRIES[op], lc, pc, t)
                return -1 if pl is None else pl[what] + skew * what
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
    layout once, and refuses a library whose workspace differs from
    ``placement``."""
    monkeypatch.setattr(TAK, "_lib", None)
    fake = _FakeAlgebraLib()
    monkeypatch.setattr(_cuda, "lib", lambda name: fake)
    assert TAK.lib() is fake and TAK.lib() is fake
    assert len(fake.tree_rebase.argtypes) == 10
    assert len(fake.tree_compose.argtypes) == 9
    monkeypatch.setattr(TAK, "_lib", None)
    monkeypatch.setattr(_cuda, "lib", lambda name: _FakeAlgebraLib(skew=1))
    with pytest.raises(RuntimeError, match="layout"):
        TAK.lib()
    assert TAK._lib is None


@pytest.mark.parametrize("t", ["shared", "global"])
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
    library on both tiers; the ``ties`` lanes hold tied candidate keys
    and overflowing pools in compose."""
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
            same(want, WRAPPERS[entry](*args, t=t), f"{what} on {t}")
