"""MQRLD on PyTorch and CUDA: the port of ``repro`` to one NVIDIA H100.

The package mirrors the JAX reference's module layout (``core/`` for the
platform, ``kernels/`` for the hand-written Hopper kernels and their
plain PyTorch versions, ``csrc/`` for the CUDA sources). It imports
``torch``, numpy and the standard library only.

Device rule: every entry point takes an explicit ``device``; ``None``
means the CUDA card and raises when there is none. A tensor on the CPU
takes a kernel's plain version, a CUDA tensor takes the kernel.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA card (raises without one); anything else is
    taken as given, so tests pass ``device="cpu"`` explicitly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain versions")
        return torch.device("cuda")
    return torch.device(device)
