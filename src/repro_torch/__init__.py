"""PyTorch/CUDA port of the DASH package (``repro``) for one NVIDIA H100.

The layout mirrors ``repro``: each module sits at the same path as its JAX
counterpart. Plain tensor code is PyTorch; every kernel that ``repro`` writes
in Pallas for the TPU is a CUDA C++ kernel here, under ``kernels/csrc/``,
built with ``nvcc`` at first use.

Entry points run on the card unless the caller passes ``device="cpu"``
(:func:`resolve_device`); nothing falls back to the CPU quietly.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: raise when CUDA is missing rather than run on
    the CPU. An explicit ``"cpu"`` (as the tests pass) is honoured."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch path")
        return torch.device("cuda")
    return torch.device(device)
