"""Where the port's entry points run: the CUDA device unless the caller
asks for another."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``None`` -> the CUDA device; raises if CUDA is asked for and absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; the port runs on the GPU (pass "
            "device='cpu' to run the kernels' plain torch versions)"
        )
    return device


def describe(device) -> str:
    """One line saying where a run's kernels run: the hand-written CUDA
    kernels on the card, or their plain torch versions on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return f"[device] {device}: the routing kernels run on the card"
    return f"[device] {device}: the kernels' plain torch versions (no CUDA kernel runs)"
