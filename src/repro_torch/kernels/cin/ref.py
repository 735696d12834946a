"""Plain PyTorch version of K7, the xDeepFM CIN layer.

``out[b, n, d] = Σ_{h<Hk, j<m} w[h·m + j, n] · xk[b, h, d] · x0[b, j, d]``:
the outer product ``z = xk[:, :, None, :] · x0[:, None, :, :]`` along the
fields, flattened to ``(B, Hk·m, D)`` and contracted with ``w`` (a 1×1
convolution).  It works in float32 whatever the input type, as the Pallas
kernel ``repro.kernels.cin.kernel._cin_kernel`` casts (``kernel.py:25-32``):
``z`` is the float32 product, the sums are float32, and the result is
rounded once to ``xk``'s type.  ``z`` is formed ``chunk`` samples at a time,
so the plain version's memory stays bounded at any batch.
"""

from __future__ import annotations

import torch

__all__ = ["cin_layer_ref"]

_Z_ELEMS = 1 << 26  # float32 elements of z alive at once


def cin_layer_ref(xk: torch.Tensor, x0: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, Hk, D) ``xk``, (B, m, D) ``x0``, (Hk·m, H') ``w`` → (B, H', D)
    of ``xk.dtype``."""
    B, Hk, D = xk.shape
    m = x0.shape[1]
    wf = w.float()
    out = torch.empty((B, w.shape[1], D), dtype=xk.dtype, device=xk.device)
    chunk = max(1, _Z_ELEMS // max(1, Hk * m * D))
    for b0 in range(0, B, chunk):
        b1 = min(B, b0 + chunk)
        z = xk[b0:b1, :, None, :].float() * x0[b0:b1, None, :, :].float()
        z = z.reshape(b1 - b0, Hk * m, D)
        out[b0:b1] = torch.einsum("bzd,zn->bnd", z, wf).to(xk.dtype)
    return out
