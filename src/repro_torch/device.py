"""Device resolution for the port's entry points.

Entry points default to the card and never fall back to the CPU: a run
that asked for CUDA on a machine without it raises, so no CPU timing can
pass for a device measurement. Tests ask for the CPU explicitly.
"""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """`device` as a torch.device; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but torch sees no CUDA "
            "device; pass device='cpu' to run the plain PyTorch path")
    return dev


def kernel_capable(dev: torch.device) -> bool:
    """True when `dev` is a CUDA card of compute capability >= 9.0 (the
    Hopper kernels are built for sm_90a)."""
    return (dev.type == "cuda"
            and torch.cuda.get_device_capability(dev) >= (9, 0))
