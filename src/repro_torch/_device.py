"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: raise when there is none, never fall back.

    The CPU runs only when the caller names it (``device="cpu"``); there
    the kernel wrappers use their plain PyTorch versions.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA unless asked otherwise, and no CUDA "
                "device is available; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)
