"""Partitioning-quality metrics: replication factor and balance.

``RF = Σ_v |P(v)| / |V|`` (paper Eq. 1), with ``P(v)`` the partitions
holding an edge incident to v, from a (V, k) replica bitmap.  The ratios
are computed in float32, as the reference's int32 true division is.
"""

from __future__ import annotations

import torch

__all__ = ["replica_matrix", "replication_factor", "load_balance",
           "partition_loads"]


def replica_matrix(src, dst, parts, *, n_vertices: int, k: int) -> torch.Tensor:
    """(V, k) bool: vertex v has a replica in partition p."""
    mat = torch.zeros((n_vertices, k), dtype=torch.bool, device=parts.device)
    valid = parts >= 0
    p = parts[valid].long()
    mat[src[valid].long(), p] = True
    mat[dst[valid].long(), p] = True
    return mat


def replication_factor(src, dst, parts, *, n_vertices: int, k: int) -> float:
    """Vertices with no assigned edge don't count toward |V|."""
    replicas = replica_matrix(src, dst, parts, n_vertices=n_vertices, k=k).sum(dim=1)
    denom = torch.clamp((replicas > 0).sum(), min=1)
    return float(replicas.sum().to(torch.float32) / denom.to(torch.float32))


def partition_loads(parts, *, k: int) -> torch.Tensor:
    valid = (parts >= 0).to(torch.int32)
    return torch.zeros(k, dtype=torch.int32, device=parts.device).index_add_(
        0, parts.clamp(min=0).long(), valid)


def load_balance(parts, *, k: int) -> float:
    """Relative imbalance: k·max_i |p_i| / |E| (paper Eq. 2 LHS)."""
    loads = partition_loads(parts, k=k)
    n = int(loads.sum())
    return float((k * loads.max()).to(torch.float32) / max(n, 1))
