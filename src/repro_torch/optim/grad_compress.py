"""Gradient compression for bandwidth-bound data parallelism (port of
``repro.optim.grad_compress``).

- :func:`topk_compress_update`: top-k sparsification with error feedback
  (the dropped coordinates carry into the next step); the values sent are
  ``k/n`` of the dense gradient, with their indices.
- :func:`int8_compress`: stochastic-rounding int8 with a per-tensor scale,
  unbiased; the uniforms are ``repro_torch.random.uniform`` of the
  caller's key, so ``q`` is the reference's bit for bit.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .. import random as jrandom
from ..streaming.carry import tree_flatten, tree_unflatten

__all__ = ["topk_compress_update", "int8_compress", "int8_decompress", "CompressState",
           "init_compress_state"]


class CompressState(NamedTuple):
    residual: Any  # error-feedback memory, float32, the tree of the grads


def init_compress_state(params) -> CompressState:
    leaves, spec = tree_flatten(params)
    return CompressState(residual=tree_unflatten(spec, [
        torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]))


def _topk_mask(x: torch.Tensor, frac: float) -> torch.Tensor:
    flat = torch.abs(x.reshape(-1))
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.topk(flat, k).values[-1]
    return (torch.abs(x) >= thresh).to(x.dtype)


def topk_compress_update(grads, state: CompressState, frac: float = 0.01):
    """Returns ``(compressed_grads, new_state, wire_bytes_fraction)``:
    compressed = top-k(grad + residual); residual' = input − compressed."""
    g_leaves, spec = tree_flatten(grads)
    r_leaves = tree_flatten(state.residual)[0]
    sent, resid = [], []
    for g, r in zip(g_leaves, r_leaves):
        g = g.float() + r
        s = g * _topk_mask(g, frac)
        sent.append(s)
        resid.append(g - s)
    wire_frac = frac * (4 + 4) / 4  # k values + k indices against n values
    return (tree_unflatten(spec, sent), CompressState(residual=tree_unflatten(spec, resid)),
            wire_frac)


def int8_compress(g: torch.Tensor, key) -> tuple[torch.Tensor, torch.Tensor]:
    """Stochastic-rounding int8 of ``g`` with a ``repro_torch.random`` key:
    ``(q (int8), scale)``, unbiased."""
    g32 = g.float()
    scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-12) / 127.0
    scaled = g32 / scale
    low = torch.floor(scaled)
    p_up = scaled - low
    up = jrandom.uniform(key, tuple(g.shape), g.device) < p_up
    q = (low + up.float()).to(torch.int8)
    return q, scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale
