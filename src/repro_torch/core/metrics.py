"""Partitioning-quality metrics: replication factor, balance, comm volume.

``RF = Σ_v |P(v)| / |V|`` (paper Eq. 1), with ``P(v)`` the partitions
holding an edge incident to v, from a (V, k) replica bitmap.  The ratios
are computed in float32, as the reference's int32 true division is.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["replica_matrix", "replication_factor", "load_balance",
           "partition_loads", "rf_by_degree", "gas_comm_bytes"]


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


def rf_by_degree(src, dst, parts, *, n_vertices: int, k: int):
    """Average replication per degree value — the degree-distribution form
    of Eq. (1), for the paper's Fig. 8-style skew analysis.  Returns
    ``{degree: (mean replicas, vertices)}`` over vertices of degree > 0."""
    replicas = replica_matrix(src, dst, parts, n_vertices=n_vertices,
                              k=k).sum(dim=1).cpu().numpy()
    deg = np.bincount(src.cpu().numpy(), minlength=n_vertices)
    deg = deg + np.bincount(dst.cpu().numpy(), minlength=n_vertices)
    out: dict[int, tuple[float, int]] = {}
    for d in np.unique(deg[deg > 0]):
        sel = deg == d
        out[int(d)] = (float(replicas[sel].mean()), int(sel.sum()))
    return out


def gas_comm_bytes(src, dst, parts, *, n_vertices: int, k: int,
                   bytes_per_value: int = 8, iterations: int = 1) -> int:
    """Per-iteration GAS sync volume implied by a vertex-cut partitioning:
    each replica of v sends its partial gather to the master and receives
    the applied value back, 2·(|P(v)|−1) messages of one value (the
    PowerGraph cost model behind the paper's Fig. 11)."""
    replicas = replica_matrix(src, dst, parts, n_vertices=n_vertices,
                              k=k).sum(dim=1)
    msgs = int((replicas - 1).clamp(min=0).sum())
    return msgs * 2 * bytes_per_value * iterations
