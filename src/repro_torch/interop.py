"""Carry state across from the JAX package as numpy arrays.

The port's "weights" are the states the reference computes: an Alg. 1
``ClusterState``, a ``CMSketch``, the game's ``GameInputs`` plus a start
assignment, the ``c2p`` table with a load vector, and the scoring
baselines' carries (Greedy, HDRF, grid).  Each function
takes the reference structure (or anything with the same fields, as
numpy-convertible arrays) and returns the port's structure on ``device``,
as fresh copies, so both sides can compute from one state.  Nothing here
imports the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .core.clustering import ClusterState
from .core.cms import CMSketch
from .core.game import GameInputs

__all__ = ["cluster_state", "sketch", "game_inputs", "placement",
           "greedy_carry", "hdrf_carry", "grid_carry"]


def _tensor(x, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def cluster_state(state, device=None) -> ClusterState:
    """The reference's 10-leaf ``ClusterState`` (int32 leaves)."""
    dev = resolve_device(device)
    return ClusterState(*(_tensor(leaf, torch.int32, dev) for leaf in state))


def sketch(sk, device=None) -> CMSketch:
    """The reference's ``CMSketch``: uint32 ``table`` and ``seeds``."""
    dev = resolve_device(device)
    table = np.asarray(sk.table).astype(np.uint32).view(np.int32)
    return CMSketch(table=_tensor(table, torch.int32, dev),
                    seeds=_tensor(np.asarray(sk.seeds).astype(np.int64), torch.int64, dev))


def game_inputs(inputs, device=None, assign0=None):
    """The reference's ``GameInputs`` (and an optional start assignment).
    Returns ``GameInputs``, or ``(GameInputs, assign0)`` when given one."""
    dev = resolve_device(device)
    out = GameInputs(
        sizes=_tensor(inputs.sizes, torch.float32, dev),
        pair_a=_tensor(inputs.pair_a, torch.int32, dev),
        pair_b=_tensor(inputs.pair_b, torch.int32, dev),
        pair_w=_tensor(inputs.pair_w, torch.float32, dev),
        n_head=int(inputs.n_head), k=int(inputs.k))
    if assign0 is None:
        return out
    return out, _tensor(assign0, torch.int32, dev)


def placement(c2p, load, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """A cluster→partition table and a ``(k,)`` load vector (int32)."""
    dev = resolve_device(device)
    return _tensor(c2p, torch.int32, dev), _tensor(load, torch.int32, dev)


def greedy_carry(carry, device=None):
    """The reference's Greedy carry ``(load, rep)`` (int32)."""
    dev = resolve_device(device)
    load, rep = carry
    return _tensor(load, torch.int32, dev), _tensor(rep, torch.int32, dev)


def hdrf_carry(carry, device=None):
    """The reference's HDRF carry ``(load, rep, pd, λ, kmask)``."""
    dev = resolve_device(device)
    load, rep, pd, lam, kmask = carry
    return (_tensor(load, torch.int32, dev), _tensor(rep, torch.int32, dev),
            _tensor(pd, torch.int32, dev), _tensor(lam, torch.float32, dev),
            _tensor(kmask, torch.bool, dev))


def grid_carry(carry, device=None):
    """The reference's grid carry ``(load, row, col, n_cols)``."""
    dev = resolve_device(device)
    load, row, col, n_cols = carry
    return (_tensor(load, torch.int32, dev), _tensor(row, torch.int32, dev),
            _tensor(col, torch.int32, dev), int(n_cols))
