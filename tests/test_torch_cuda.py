"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where no CUDA device is present (decided
inside the test). On a machine with a card, run this file alone and
without the suite's conftest, which imports jax:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from chip_smoke import KERNELS, hold_kernel, random_case
from fluidframework_tpu_torch.ops import _cuda
from fluidframework_tpu_torch.ops import apply_kernel as K1


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
def test_capacity_past_shared_memory_tier_raises():
    _need_card()
    t = torch.zeros((15, 2, _cuda.MAX_CAPACITY * 2), dtype=torch.int32,
                    device="cuda")
    s = torch.zeros((2, 8), dtype=torch.int32, device="cuda")
    ops = torch.zeros((2, 1, 10), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="tier"):
        K1.apply_ops_packed(t, s, ops)
