"""Entry point of K7: the counterpart of ``repro.kernels.cin.ops.cin_layer_kernel``.

``cin_layer_kernel(xk, x0, w)`` takes arrays or tensors, puts them on
``device`` (default ``cuda``; tensors already on a device stay there)
as contiguous tensors and runs :func:`.kernel.cin_layer`: K7 on the card,
the plain version on the CPU.  The reference's ``batch_block`` and
``interpret`` have no counterpart: K7 masks a ragged batch itself, and a
CUDA kernel has no interpret mode.
"""

from __future__ import annotations

import torch

from ..._device import resolve_device
from .kernel import cin_layer

__all__ = ["cin_layer_kernel"]


def cin_layer_kernel(xk, x0, w, *, device=None) -> torch.Tensor:
    """(B, Hk, D) ``xk``, (B, m, D) ``x0``, (Hk·m, H') ``w`` → (B, H', D) of
    ``xk``'s type."""
    if isinstance(xk, torch.Tensor) and device is None:
        dev = xk.device
    else:
        dev = resolve_device(device)
    xk, x0, w = (torch.as_tensor(t).to(dev).contiguous() for t in (xk, x0, w))
    return cin_layer(xk, x0, w)
