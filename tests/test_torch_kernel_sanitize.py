"""``tools/kernel_sanitize.py``'s case table, on the CPU.

The table must hold every C entry of ``csrc/merge_kernels.cu`` and
``csrc/tree_kernels.cu`` that launches a kernel (every function of their
``extern "C"`` blocks that takes a stream; the capacity and size queries
take none) on every tier the entry has, and every case must build on the
CPU and run through the plain versions (the merge and exchange wrappers'
own CPU path too). The kernels themselves run only on a card: ``python3
-m tools.kernel_sanitize``, alone or under compute-sanitizer.
"""

import ast
import os
import re

import pytest
import torch

from fluidframework_tpu_torch.ops import _cuda
from fluidframework_tpu_torch.ops import shard_exchange_kernel as SX
from fluidframework_tpu_torch.ops.apply_kernel import SC_ERR
from fluidframework_tpu_torch.ops import tree_algebra_kernel as TAK
from fluidframework_tpu_torch.ops import tree_scan_kernel as TSK
from fluidframework_tpu_torch.protocol.constants import (
    ERR_RANGE,
    F_TYPE,
    OP_ANNOTATE,
    OP_INSERT,
    OP_REMOVE,
)
from tools import kernel_sanitize as KS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "kernel_sanitize.py")
CPU = torch.device("cpu")
CASES = KS.cases()


def _launching_entries(path: str) -> set:
    """The functions defined after the first ``extern "C" {`` of ``path``
    (its C interface runs to the end of the file) whose parameters name a
    stream."""
    src = open(path).read()
    tail = src[src.index('extern "C" {'):]
    return {m.group(1) for m in re.finditer(
        r"^\w[\w\s\*]*?\b(\w+)\(([^)]*)\)\s*\{", tail, re.M)
        if "stream" in m.group(2)}


def test_the_table_names_every_launching_entry():
    entries = set()
    for lib in _cuda.LIBRARIES:
        entries |= _launching_entries(_cuda.source(lib))
    assert entries == set(_cuda.ENTRIES) == set(KS.LABELS)
    assert {c.entry for c in CASES} == entries


@pytest.mark.parametrize("entry", sorted(KS.LABELS))
def test_every_tier_of_an_entry_has_a_case(entry):
    want = (_cuda.entry_tiers(entry) if _cuda.ENTRIES[entry] == "merge"
            else None)
    if entry in _cuda.UNTIERED:
        want = ("-",)
    elif entry in TSK.ENTRIES:
        want = tuple(f"warp/{r}" for r in TSK.RINGS) + tuple(
            t for t in TSK.TIER_CODES if t != "warp")
    elif entry in TAK.ENTRIES:
        want = tuple(TAK.TIER_CODES)
    assert set(KS.entry_tiers(entry)) == set(want)
    assert {c.tier for c in CASES if c.entry == entry} == set(want)


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"{c.label}-{c.tier}-{i}"
                              for i, c in enumerate(CASES)])
def test_a_case_builds_and_runs_plain_on_the_cpu(i):
    case = CASES[i]
    run = case.make(CPU)
    want = run.plain()
    assert want and all(torch.is_tensor(x) for x in want)
    assert not any(bool((x == KS.SENTINEL).any()) for x in want)
    assert run.launches >= 1
    if case.entry in KS.MERGE or case.entry in KS.EXCHANGE:
        # The wrappers' CPU path (the plain versions) into the sentinel
        # outputs writes every lane.
        assert KS.first_difference(run.kernel(), want) is None


@pytest.mark.parametrize("tier,cap", [(t, cap) for t, cap, _n, _k
                                      in KS.MERGE_SHAPES])
def test_merge_shapes_sit_at_their_tiers_lower_edge(tier, cap):
    """Each merge case's width is the tier's own (``_cuda.tier`` for a
    launch of as many documents as an H100 has SMs, which takes the
    global tier where the document count decides), the smallest power of
    two past the tier below; the split tier's documents get at least 2
    CTAs each; every document's first ops are an insert, a remove and an
    annotate."""
    assert _cuda.tier(cap, "merge_apply", 132, 132) == tier
    below = {"cluster": _cuda.SMEM_MAX_CAPACITY,
             "global": _cuda.CLUSTER_MAX_CAPACITY,
             "split": _cuda.GLOBAL_MAX_CAPACITY}
    if tier in below:
        assert cap == 2 * below[tier]
    n = next(n for t, c, n, _k in KS.MERGE_SHAPES if (t, c) == (tier, cap))
    assert n >= 2 and min(16, -(-132 // n)) >= 2
    _t, _s, ops = KS.merge_inputs(CPU, 8, n, 4)
    assert ops.shape[1] >= 4
    assert (ops[:, :3, F_TYPE] == torch.tensor(
        [OP_INSERT, OP_REMOVE, OP_ANNOTATE], dtype=torch.int32)).all()


def test_the_tree_cases_take_their_tiers():
    """Every tree case's tier takes its shape; the warp tier's scans and
    algebra hold a full CTA of 8 documents and a partial one; compose's
    raw lanes hold tied keys and overflowing pools; T2 runs at 1 and 9
    documents."""
    t1 = KS.trunk_args(CPU, *KS.T1_SHAPE)
    assert t1[0].shape[0] == 9 and TSK.WARP_MAX_D == 8
    assert bool((t1[2].mov_id != 0).any())
    for tier in KS.SCAN_TIERS:
        assert KS.scan_placement(TSK.T1, tier, t1) is not None, tier
        for shape in KS.T2_SHAPES:
            args = KS.em_args(CPU, *shape)
            assert KS.scan_placement(TSK.T2, tier, args) is not None
            assert int((args[4].run_start >= 0).sum()) > 0
    assert sorted(s[0] for s in KS.T2_SHAPES) == [1, 9]
    n, lc, pc = KS.ALGEBRA_SHAPE
    assert n == 9
    for entry in TAK.ENTRIES:
        for t in TAK.TIER_CODES:
            assert TAK.placement(entry, lc, pc, t) is not None
    docs, L, a, b = KS.algebra_inputs(CPU)
    ties, over = KS.compose_ties(a, b, L)
    assert ties > 0 and over > 0
    tags = a.mov_id[a.mov_id > 0]
    assert tags.numel() > torch.unique(tags).numel()  # duplicate tags


def test_exchange_cases_run_the_ticket_and_err_range():
    """X1 runs over two device groups of more than one CTA a shard and
    counts past one CTA's share; X2's and shard_exchange's ops include
    one past the document's end, whose rows come back with ERR_RANGE."""
    assert len(KS.X1_GROUPS) >= 2
    sms = 132
    for g in KS.X1_GROUPS:
        fill = -(-2 * sms // len(g))
        assert min(fill, -(-KS.X1_ROWS[0] // 4096)) > 1
    assert min(KS.X1_ROWS) > KS.X1_ROWS[0] // 2
    t, s, ops = KS.exchange_case(CPU, 4, 64, k=4)
    ops = KS.with_past_op(ops)
    _st, _rows, sc = SX.shard_exchange_plain(t, s, ops[-1])
    assert bool((sc[:, SC_ERR] & ERR_RANGE).all())


def test_hold_counts_every_mismatching_launch():
    want = [torch.arange(6, dtype=torch.int32).reshape(2, 3)]
    calls = []

    def kernel():
        calls.append(1)
        got = want[0].clone()
        if len(calls) % 3 == 0:
            got[1, 2] = 99
        return [got]

    once = KS.Run(lambda: want, lambda: want)
    r, r1 = KS.hold_all([KS.Run(kernel, lambda: want, launches=2), once],
                        launches=13)
    assert r == dict(launches=14, mismatches=2, first=(0, (1, 2), 5, 99))
    assert r1 == dict(launches=13, mismatches=0, first=None)
    assert KS.first_difference([want[0]], want) is None
    assert KS.first_difference([want[0][:1]], want)[1] == "shape"


def test_main_lists_the_table_and_refuses_without_a_card(monkeypatch,
                                                        capsys):
    assert KS.main(["--list"]) == 0
    assert len(capsys.readouterr().out.splitlines()) == len(CASES)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert KS.main(["--only", "K1"]) == 2


def test_the_tool_imports_only_torch_numpy_the_stdlib_and_the_port():
    tree = ast.parse(open(TOOL).read(), filename=TOOL)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            root = n.split(".")[0]
            assert root in ("torch", "numpy", "fluidframework_tpu_torch",
                            "__future__", "argparse", "dataclasses", "os",
                            "re", "subprocess", "sys", "tempfile",
                            "typing"), f"{TOOL}:{node.lineno} imports {n}"


def test_ptxas_reports_compare_by_kernel_without_the_path_hash():
    """Two builds of one source from two paths name each kernel with
    another anonymous-namespace hash; the comparison keys on the rest."""
    def report(h, regs):
        return (f"ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__"
                f"{h}_15_tree_kernels_cu_3bd03dbb18alg_compose_kernelILb0EEEv"
                "NS_7AlgArgsE' for 'sm_90a'\n"
                "ptxas info    : Function properties for x\n"
                "    0 bytes stack frame, 0 bytes spill stores, 0 bytes "
                "spill loads\n"
                f"ptxas info    : Used {regs} registers, used 1 barriers, "
                "400 bytes smem\n")
    a = KS.ptxas_kernels(report("7983e0ba", 56))
    assert a == KS.ptxas_kernels(report("625c19cf", 56))
    assert a != KS.ptxas_kernels(report("625c19cf", 64))
    (name,) = a
    assert "alg_compose_kernel" in name and "56 registers" in a[name]
