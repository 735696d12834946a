"""Shared layer primitives of the models (port of ``repro.models.common``).

Plain functions on tensors; parameters are plain dictionaries of tensors.
``dense_init`` draws from :func:`repro_torch.random.truncated_normal`, the
port of ``jax.random.truncated_normal`` (within a few ulp of JAX's draw).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import random as jrandom
from .._device import resolve_device

__all__ = ["dense_init", "rms_norm", "layer_norm", "swish", "gelu", "softmax_xent"]


def dense_init(key, shape, scale: float | None = None, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """Truncated-normal fan-in init on [−2, 2], times ``1/√fan_in`` unless
    ``scale`` is given; on ``device`` (default ``cuda``).

    ``fan_in`` is ``shape[0]``, as in the reference: for the LM's stacked
    (L, D, F) weights that is the layer count L, not D.  The draw is made
    slice by slice straight into ``dtype`` on the device
    (``truncated_normal(out=...)``), bitwise the whole draw's cast.  On the
    ``meta`` device it draws nothing: the shape alone, as ``jax.eval_shape``
    traces it."""
    dev = resolve_device(device)
    if dev.type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device=dev)
    fan_in = shape[0] if len(shape) >= 2 else 1
    if scale is None:
        scale = 1.0 / (fan_in ** 0.5)
    out = torch.empty(tuple(shape), dtype=dtype, device=dev)
    return jrandom.truncated_normal(key, -2.0, 2.0, tuple(shape), dev, out=out, scale=scale)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight).to(dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * weight + bias).to(dtype)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean cross-entropy over valid positions, reduced in float32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        mask = mask.to(nll.dtype)
        nll = nll * mask
        return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
