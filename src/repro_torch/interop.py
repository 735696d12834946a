"""Carry state across from the JAX package as numpy arrays.

The port's "weights" are the states the reference computes: an Alg. 1
``ClusterState``, a ``CMSketch``, the game's ``GameInputs`` plus a start
assignment, the ``c2p`` table with a load vector, and the scoring
baselines' carries (Greedy, HDRF, grid), and model weights (the GCN's,
SchNet's, EGNN's, DimeNet's, the LM's and xDeepFM's parameter trees).  Each function
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
           "greedy_carry", "hdrf_carry", "grid_carry", "gcn_params", "gnn3d_params",
           "lm_params", "xdeepfm_params"]


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


def _leaf(w, dev) -> torch.Tensor:
    """A reference float array as a float32 or bfloat16 tensor on ``dev``."""
    w = np.asarray(w)
    if w.dtype.name == "bfloat16":  # NumPy has no bfloat16: go through its bits
        return torch.from_numpy(w.view(np.uint16).astype(np.int16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(w, np.float32)).to(dev)


def gcn_params(params, device=None) -> dict:
    """The reference's GCN parameters ``{"layers": [{"w": (d_in, d_out)}]}``
    (arrays in the reference's float type, float32 or bfloat16)."""
    dev = resolve_device(device)
    return {"layers": [{"w": _leaf(layer["w"], dev)} for layer in params["layers"]]}


def _tree(tree, dev):
    """Nested dicts and lists of reference arrays as the same nesting of
    tensors on ``dev``."""
    if isinstance(tree, dict):
        return {k: _tree(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree(v, dev) for v in tree]
    return _leaf(tree, dev)


def gnn3d_params(params, device=None) -> dict:
    """The reference's SchNet, EGNN or DimeNet tree (dicts and lists of
    ``{"w", "b"}`` layers, arrays in float32) as the port's on ``device``,
    leaf for leaf."""
    return _tree(params, resolve_device(device))


def lm_params(params, device=None) -> dict:
    """The reference's LM parameter tree (nested dicts of arrays, stacked
    (L, …) layer leaves, float32 or bfloat16) as the port's dict on
    ``device``, key for key."""
    return _tree(params, resolve_device(device))


def xdeepfm_params(params, device=None) -> dict:
    """The reference's xDeepFM tree (``tables``, ``lin_tables``, ``cin``:
    lists of arrays; ``mlp``: a list of ``{"w", "b"}``; ``cin_out``,
    ``mlp_out``, ``bias``) as the port's on ``device``, leaf for leaf."""
    dev = resolve_device(device)
    return {
        "tables": [_leaf(t, dev) for t in params["tables"]],
        "lin_tables": [_leaf(t, dev) for t in params["lin_tables"]],
        "cin": [_leaf(w, dev) for w in params["cin"]],
        "cin_out": _leaf(params["cin_out"], dev),
        "mlp": [{"w": _leaf(layer["w"], dev), "b": _leaf(layer["b"], dev)}
                for layer in params["mlp"]],
        "mlp_out": _leaf(params["mlp_out"], dev),
        "bias": _leaf(params["bias"], dev),
    }
