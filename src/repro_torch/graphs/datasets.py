"""Synthetic datasets shaped like the assigned GNN benchmark graphs (port of
``repro.graphs.datasets``; NumPy on both sides, so the outputs are bitwise
the reference's).

- ``cora_like``           — 2,708 nodes / 5,278 undirected edges / 1,433 features
- ``ogbn_products_like``  — 2,449,029 nodes / up to 30,929,570 undirected edges
                            (Chung–Lu, after dedup) / 100 features made per
                            node by ``products_features``
- ``molecule_batch``      — batched small molecular graphs (30 nodes / 64
                            edges each) with 3-D coordinates for
                            SchNet/EGNN/DimeNet
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .generators import powerlaw_graph

__all__ = ["GraphData", "cora_like", "ogbn_products_like", "products_features",
           "MoleculeBatch", "molecule_batch"]


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


class MoleculeBatch(NamedTuple):
    positions: np.ndarray  # (B, N, 3)
    species: np.ndarray  # (B, N) int32 atomic numbers
    edge_src: np.ndarray  # (B, E) intra-molecule edges
    edge_dst: np.ndarray  # (B, E)
    energies: np.ndarray  # (B,) regression target


def molecule_batch(batch: int = 128, n_atoms: int = 30, n_edges: int = 64,
                   seed: int = 0) -> MoleculeBatch:
    """``batch`` molecules of ``n_atoms`` Gaussian atoms, each joined by its
    ``n_edges`` shortest directed pairs; the target is Σ exp(−d) over them."""
    rng = np.random.default_rng(seed)
    pos = rng.standard_normal((batch, n_atoms, 3)).astype(np.float32) * 2.0
    species = rng.integers(1, 10, (batch, n_atoms)).astype(np.int32)
    # connect nearest neighbors until n_edges per molecule
    es = np.zeros((batch, n_edges), np.int32)
    ed = np.zeros((batch, n_edges), np.int32)
    for b in range(batch):
        d = np.linalg.norm(pos[b][:, None] - pos[b][None, :], axis=-1)
        np.fill_diagonal(d, np.inf)
        flat = np.argsort(d, axis=None)[: n_edges]
        es[b] = (flat // n_atoms).astype(np.int32)
        ed[b] = (flat % n_atoms).astype(np.int32)
    # synthetic smooth target: sum of pairwise Gaussians (learnable)
    en = np.zeros(batch, np.float32)
    for b in range(batch):
        d = np.linalg.norm(pos[b][es[b]] - pos[b][ed[b]], axis=-1)
        en[b] = np.exp(-d).sum()
    return MoleculeBatch(pos, species, es, ed, en)
