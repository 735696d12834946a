"""Synthetic datasets shaped like the assigned GNN benchmark graphs (port of
``repro.graphs.datasets``; NumPy on both sides, so the outputs are bitwise
the reference's).

- ``cora_like``           — 2,708 nodes / 5,278 undirected edges / 1,433 features
- ``ogbn_products_like``  — 2,449,029 nodes / up to 30,929,570 undirected edges
                            (Chung–Lu, after dedup) / 100 features made per
                            node by ``products_features``

``molecule_batch`` waits for the SchNet/EGNN/DimeNet slice.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .generators import powerlaw_graph

__all__ = ["GraphData", "cora_like", "ogbn_products_like", "products_features"]


class GraphData(NamedTuple):
    src: np.ndarray
    dst: np.ndarray
    n_vertices: int
    features: np.ndarray | None  # (V, F) or None for lazy
    labels: np.ndarray | None
    n_classes: int


def cora_like(seed: int = 0) -> GraphData:
    n, m, f, c = 2708, 10556 // 2, 1433, 7  # 10,556 directed = 5,278 undirected
    src, dst, _ = powerlaw_graph(n, avg_degree=2 * m / n, rho=2.5, seed=seed)
    src, dst = src[:m], dst[:m]
    rng = np.random.default_rng(seed + 1)
    feats = (rng.random((n, f)) < 0.012).astype(np.float32)  # sparse bag-of-words
    # labels derive from features (+ noise) so held-out accuracy is learnable
    w = rng.standard_normal((f, c))
    labels = (feats @ w + 0.5 * rng.standard_normal((n, c))).argmax(1).astype(np.int32)
    return GraphData(src, dst, n, feats, labels, c)


def ogbn_products_like(seed: int = 0, scale: float = 1.0) -> GraphData:
    """Product co-purchase-shaped graph.  ``scale`` < 1 shrinks for tests."""
    n = int(2_449_029 * scale)
    m = int(61_859_140 // 2 * scale)
    src, dst, _ = powerlaw_graph(n, avg_degree=2 * m / n, rho=2.3, seed=seed)
    src, dst = src[:m], dst[:m]
    rng = np.random.default_rng(seed + 1)
    labels = rng.integers(0, 47, n).astype(np.int32)
    return GraphData(src, dst, n, None, labels, 47)  # features generated lazily


def products_features(nodes: np.ndarray, d_feat: int = 100, seed: int = 0) -> np.ndarray:
    """Deterministic per-node features (hash-seeded) — lazy materialization.

    One NumPy generator per node, seeded by its id, in a Python loop: the
    reference's values exactly, so it is not vectorised."""
    out = np.empty((nodes.size, d_feat), np.float32)
    for i, v in enumerate(np.asarray(nodes, np.int64)):
        r = np.random.default_rng(seed * 1_000_003 + int(v))
        out[i] = r.standard_normal(d_feat).astype(np.float32)
    return out
