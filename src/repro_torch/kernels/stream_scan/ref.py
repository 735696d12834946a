"""Plain PyTorch versions of K1 and K2, with the whole kernel contract.

The per-edge transitions themselves live in ``core.clustering`` and
``core.postprocess`` (as in ``repro``); these oracles take and return the
same leaf tuples and arguments as the wrappers in :mod:`.kernel`, so the
CPU tests and the on-card comparison hold like against like.  ``core`` is
imported lazily: ``core`` imports the kernels package at module level.
"""

from __future__ import annotations

import torch

__all__ = ["cluster_chunk_oracle", "assign_chunk_oracle"]


def cluster_chunk_oracle(state, src, dst, degrees, *, xi, kappa,
                         global_tail=False):
    """``core.clustering.cluster_chunk`` on a 10-leaf state tuple (in place)."""
    from ...core.clustering import ClusterState, cluster_chunk

    out = cluster_chunk(ClusterState(*state), src, dst, degrees, xi=xi,
                        kappa=kappa, global_tail=global_tail)
    return tuple(out)


def assign_chunk_oracle(load, src, dst, is_head_edge, pcu, pcv, *, max_load,
                        sign=1, parts=None, n_valid=None):
    """Alg. 3 over one chunk, insert or retract; returns ``(parts, load)``.

    Insert: ``core.postprocess._assign_steps`` over every entry (``limit``
    is the chunk length; padding drops out as a self-loop).  Retract: the
    recorded ``parts`` of the first ``n_valid`` entries each give back one
    unit, and come back unchanged as the chunk's parts.
    """
    from ...core.postprocess import _assign_steps

    if sign > 0:
        return _assign_steps(load, src, dst, is_head_edge, pcu, pcv,
                             max_load=int(max_load))
    real = torch.arange(src.shape[0], device=src.device) < int(n_valid)
    placed = real & (src != dst) & (parts >= 0)
    load = load - torch.zeros_like(load).index_add_(
        0, parts.clamp(min=0).long(), placed.to(load.dtype))
    return parts.clone(), load
