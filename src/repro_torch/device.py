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
