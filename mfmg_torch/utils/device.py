"""The card as the default device of the port's entry points."""

from __future__ import annotations

import torch


def checked_device(device) -> torch.device:
    """torch.device(device); "cuda" needs a CUDA device and never falls back
    to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} needs a CUDA device and "
                           f"torch.cuda.is_available() is False; pass "
                           f"device='cpu' to run on the CPU")
    return device
