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
    Recorded,
    compact_edge_case,
    edge_case,
    hold_kernel,
    random_case,
    replay_and_compare,
)
from fluidframework_tpu_torch.ops import _cuda
from fluidframework_tpu_torch.ops import apply_kernel as K1
from fluidframework_tpu_torch.parallel.fleet import DocFleet


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
