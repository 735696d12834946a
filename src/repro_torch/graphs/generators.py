"""Synthetic graph generators for the paper's evaluation suite.

- :func:`rmat_graph` — R-MAT (Chakrabarti 2004) recursive generator, the
  TrillionG-style sampler the paper uses for its G₁…G₆ skewness sweep.
  Implemented vectorized: every edge draws its quadrant bits for all
  ``log2(V)`` levels at once.
- :func:`powerlaw_graph` — Chung-Lu style power-law degree sequence.
- :func:`erdos_renyi_graph` — non-skewed control.
- :func:`toy_graph_fig3` — the 12-vertex/14-edge worked example of paper
  Figure 3 (used by the unit tests to pin Algorithm-1 behaviour).
- :func:`community_graph` — degree-corrected SBM (power-law degrees plus
  planted communities).
- :func:`block_rmat_graph` — hub-heavy R-MAT blocks with planted
  communities, hidden by a relabelling (the parallel-ingest gate's graph).
- :func:`graph_skewness` — the paper's §2.3 skewness statistics.

NumPy only: the same seeds give the same arrays as ``repro.graphs``.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "rmat_graph",
    "powerlaw_graph",
    "community_graph",
    "erdos_renyi_graph",
    "toy_graph_fig3",
    "block_rmat_graph",
    "graph_skewness",
]


def rmat_graph(
    scale: int,
    edge_factor: int = 16,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
    dedup: bool = True,
):
    """R-MAT: V = 2**scale vertices, E ≈ edge_factor·V edges.

    Larger (a − d) skews the degree distribution harder; the paper's
    G₁…G₃/G₄…G₆ groups vary edge_factor at fixed V to increase skew.
    Returns (src, dst, n_vertices) as int32 numpy arrays.
    """
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = edge_factor * n
    d = 1.0 - a - b - c
    if d < 0:
        raise ValueError("a + b + c must be <= 1")
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    # vectorized recursive quadrant descent
    for _ in range(scale):
        r = rng.random(m)
        # quadrant probabilities: [a | b; c | d] over (src_bit, dst_bit)
        sbit = (r >= a + b).astype(np.int64)  # bottom half ⇒ src bit 1
        r2 = rng.random(m)
        p_right = np.where(sbit == 0, b / max(a + b, 1e-12), d / max(c + d, 1e-12))
        dbit = (r2 < p_right).astype(np.int64)
        src = (src << 1) | sbit
        dst = (dst << 1) | dbit
    keep = src != dst
    src, dst = src[keep], dst[keep]
    if dedup:
        key = np.minimum(src, dst) * n + np.maximum(src, dst)
        _, idx = np.unique(key, return_index=True)
        idx.sort()  # preserve stream order of first occurrence
        src, dst = src[idx], dst[idx]
    return src.astype(np.int32), dst.astype(np.int32), n


def powerlaw_graph(n_vertices: int, avg_degree: float = 8.0, rho: float = 2.2,
                   seed: int = 0, dedup: bool = True):
    """Chung-Lu expected-degree power-law graph: f(d) ∝ d^(−ρ)."""
    rng = np.random.default_rng(seed)
    # sample degree weights from a Pareto-ish tail
    w = (rng.pareto(rho - 1.0, n_vertices) + 1.0)
    w *= avg_degree / w.mean()
    m = int(n_vertices * avg_degree / 2)
    p = w / w.sum()
    src = rng.choice(n_vertices, size=m, p=p).astype(np.int64)
    dst = rng.choice(n_vertices, size=m, p=p).astype(np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    if dedup:
        key = np.minimum(src, dst) * np.int64(n_vertices) + np.maximum(src, dst)
        _, idx = np.unique(key, return_index=True)
        idx.sort()
        src, dst = src[idx], dst[idx]
    return src.astype(np.int32), dst.astype(np.int32), n_vertices


def community_graph(
    n_vertices: int,
    n_communities: int = 32,
    avg_degree: float = 8.0,
    rho: float = 2.2,
    p_intra: float = 0.9,
    seed: int = 0,
    dedup: bool = True,
):
    """Degree-corrected SBM: power-law degrees + planted communities.

    This is the structure of the paper's web/social graphs (strong locality
    + heavy skew) — the regime where clustering-refinement partitioners
    (2PS-L / CLUGP / S5P) beat score-based ones (HDRF).  A pure Chung-Lu
    graph has *no* communities and is the adversarial case for clustering.
    """
    rng = np.random.default_rng(seed)
    w = rng.pareto(rho - 1.0, n_vertices) + 1.0
    w *= avg_degree / w.mean()
    comm = rng.integers(0, n_communities, n_vertices)
    # bucket vertices by community for intra-draws
    order = np.argsort(comm, kind="stable")
    comm_sorted = comm[order]
    starts = np.searchsorted(comm_sorted, np.arange(n_communities))
    stops = np.searchsorted(comm_sorted, np.arange(n_communities), side="right")
    m = int(n_vertices * avg_degree / 2)
    p_global = w / w.sum()
    src = np.empty(m, np.int64)
    dst = np.empty(m, np.int64)
    intra = rng.random(m) < p_intra
    # endpoint 1 ~ degree-weighted global draw
    src[:] = rng.choice(n_vertices, size=m, p=p_global)
    # endpoint 2: same community (degree-weighted within) or global
    dst_global = rng.choice(n_vertices, size=m, p=p_global)
    dst[:] = dst_global
    for c in range(n_communities):
        members = order[starts[c]:stops[c]]
        if members.size < 2:
            continue
        sel = intra & (comm[src] == c)
        cnt = int(sel.sum())
        if cnt == 0:
            continue
        pw = w[members] / w[members].sum()
        dst[sel] = rng.choice(members, size=cnt, p=pw)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    if dedup:
        key = np.minimum(src, dst) * np.int64(n_vertices) + np.maximum(src, dst)
        _, idx = np.unique(key, return_index=True)
        idx.sort()
        src, dst = src[idx], dst[idx]
    return src.astype(np.int32), dst.astype(np.int32), n_vertices


def erdos_renyi_graph(n_vertices: int, avg_degree: float = 8.0, seed: int = 0):
    rng = np.random.default_rng(seed)
    m = int(n_vertices * avg_degree / 2)
    src = rng.integers(0, n_vertices, m)
    dst = rng.integers(0, n_vertices, m)
    keep = src != dst
    return src[keep].astype(np.int32), dst[keep].astype(np.int32), n_vertices


def toy_graph_fig3():
    """Paper Figure 3: 12 vertices, 14 edges; index = stream arrival order.

    Edge numbers in the figure give the arrival sequence (e1 … e14).  The
    figure names a few explicitly (e4(v2,v7), e5(v1,v2), e6(v0,v1),
    e14(v3,v6)); the remaining edges complete a consistent head/tail split
    with head vertices {v0, v1, v2, v3} for ξ = ⌊2·14/12⌋ = 2.
    """
    edges = [
        (0, 4),   # e1  tail (gives v0 head degree, per the e6 narrative)
        (5, 6),   # e2  tail
        (6, 7),   # e3  tail
        (2, 7),   # e4  (paper)
        (1, 2),   # e5  head (paper: d(v1)=5, d(v2)=6 context)
        (0, 1),   # e6  head (paper)
        (1, 3),   # e7
        (2, 3),   # e8
        (0, 2),   # e9
        (1, 8),   # e10
        (2, 9),   # e11
        (1, 10),  # e12
        (2, 11),  # e13
        (3, 6),   # e14 (paper)
    ]
    src = np.array([e[0] for e in edges], np.int32)
    dst = np.array([e[1] for e in edges], np.int32)
    return src, dst, 12


def block_rmat_graph(
    block_scale: int = 7,
    n_blocks: int = 32,
    edge_factor: int = 8,
    a: float = 0.65,
    b: float = 0.12,
    c: float = 0.12,
    inter_frac: float = 0.08,
    seed: int = 0,
):
    """Hub-heavy R-MAT with planted blocks: ``n_blocks`` independent R-MATs
    of ``2**block_scale`` vertices, ``inter_frac``·E uniform inter-block
    edges, vertex ids and arrival order permuted so the blocks are
    invisible to a streaming partitioner.  Returns (src, dst, n_vertices)."""
    rng = np.random.default_rng(seed)
    bs = 1 << block_scale
    n = bs * n_blocks
    srcs, dsts = [], []
    for blk in range(n_blocks):
        s, d, _ = rmat_graph(block_scale, edge_factor, a=a, b=b, c=c,
                             seed=seed * 7919 + blk)
        srcs.append(s.astype(np.int64) + blk * bs)
        dsts.append(d.astype(np.int64) + blk * bs)
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    m_inter = int(inter_frac * src.size)
    isrc = rng.integers(0, n, m_inter)
    idst = rng.integers(0, n, m_inter)
    keep = isrc != idst
    src = np.concatenate([src, isrc[keep]])
    dst = np.concatenate([dst, idst[keep]])
    perm = rng.permutation(n)
    src, dst = perm[src], perm[dst]
    order = rng.permutation(src.size)
    return src[order].astype(np.int32), dst[order].astype(np.int32), n


def graph_skewness(src, dst, n_vertices: int):
    """(ρ, ρ₁, ρ₂, ρ₃) per paper §2.3: the power-law exponent fitted on the
    degree histogram, Pearson's two skewness coefficients, and |E| − (3|V| − 6)."""
    deg = np.bincount(src, minlength=n_vertices) + np.bincount(dst, minlength=n_vertices)
    deg = deg[deg > 0].astype(np.float64)
    vals, counts = np.unique(deg, return_counts=True)
    mask = (vals > 0) & (counts > 0)
    x = np.log(vals[mask])
    y = np.log(counts[mask])
    rho = float(-np.polyfit(x, y, 1)[0]) if x.size >= 2 else float("nan")
    sigma = deg.std()
    mean = deg.mean()
    mode = float(vals.astype(np.int64)[np.argmax(counts)])
    median = float(np.median(deg))
    rho1 = float((mean - mode) / sigma) if sigma > 0 else 0.0
    rho2 = float(3 * (mean - median) / sigma) if sigma > 0 else 0.0
    rho3 = int(src.shape[0] - (3 * n_vertices - 6))
    return rho, rho1, rho2, rho3
