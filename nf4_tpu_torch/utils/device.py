"""Device resolution for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU.  They never
continue quietly on the CPU when no card is present: the CPU runs only the
plain PyTorch versions of the kernels, which is what tests want and what a
server or benchmark must not do by accident.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev
