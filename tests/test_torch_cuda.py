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


@pytest.mark.cuda
@pytest.mark.parametrize("cap,n_docs", [(2050, 33), (4096, 16), (65536, 3)])
def test_global_tier_matches_plain_on_the_card(cap, n_docs):
    """Tables wider than one CTA's shared memory run on the global-memory
    tier, bit for bit with the plain versions; each launch counts there."""
    _need_card()
    dev = torch.device("cuda", 0)
    t0, s0, ops = random_case(np.random.default_rng(cap), n_docs, cap, 16,
                              dev)
    for name, spec in KERNELS.items():
        w = spec["wrapper"]
        before = (w.launches, w.launches_smem, w.launches_global)
        err, _ms, _plain_ms = hold_kernel(name, t0, s0, ops, 1, 1)
        assert err == 0
        assert (w.launches, w.launches_smem, w.launches_global) == (
            before[0] + 2, before[1], before[2] + 2)


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
    bit, and K1 and K2 ran on both tiers."""
    _need_card()
    kw = dict(n_docs=4, capacity=1024, high_water=0.7, device="cuda")
    gen = Config6Gen(4)
    rec = Recorded(DocFleet(**kw))
    before = {w: (w.launches_smem, w.launches_global)
              for w in (K1.apply_ops_packed, KERNELS["K2_zamboni_compact"][
                  "wrapper"])}
    extra = 3
    while extra:
        rec("apply", gen.round(grow=True))
        rec("compact")
        rec("check_and_migrate")
        if 4096 in rec.fleet.pools:
            extra -= 1
    assert rec("stats")["docs_with_errors"] == 0
    for w, (smem, glob) in before.items():
        assert w.launches_smem > smem and w.launches_global > glob
    replay_and_compare(rec, lambda: DocFleet(kernel="plain", **kw),
                       [0, 1, 2, 3])
