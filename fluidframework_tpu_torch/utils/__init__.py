"""Shared small utilities."""

import torch


def pow2_at_least(n: int) -> int:
    """Smallest power of two >= n (gather index buckets stay in a small
    closed set of shapes)."""
    p = 1
    while p < n:
        p *= 2
    return p


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. ``"cuda"`` is the default for
    every entry point; without a card it raises rather than falling back
    to the CPU — the CPU path is only taken when asked for by name."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fluidframework_tpu_torch runs on a CUDA device and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev
