"""Neighbor sampling for large-graph minibatch GNN training (port of
``repro.graphs.sampler``).

A uniform fanout sampler (GraphSAGE-style, e.g. 15-10): seed nodes →
up to ``fanout[h]`` neighbors per hop from a CSR adjacency, emitted as a
padded subgraph of fixed shapes.  The sampler is host NumPy with the
reference's ``default_rng`` draws in the reference's order, so a seed gives
the reference's subgraph bit for bit.  :func:`build_csr` sorts on a device
(default ``cuda``; a stable sort and a ``bincount``) and returns the
reference's NumPy arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device

__all__ = ["CSRGraph", "build_csr", "SampledSubgraph", "NeighborSampler"]


class CSRGraph(NamedTuple):
    indptr: np.ndarray  # (V+1,) int64
    indices: np.ndarray  # (E,) int32
    n_vertices: int


def _ids(x, dev) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return torch.as_tensor(x).to(dev)


def build_csr(src, dst, n_vertices: int, symmetrize: bool = True, *,
              device=None) -> CSRGraph:
    """The CSR of ``src → dst`` (and ``dst → src`` when ``symmetrize``), rows
    by source in the edge list's order: the stable sort of the reference's
    ``np.argsort(kind="stable")``, run on ``device`` (default ``cuda``).
    ``src`` and ``dst`` are NumPy arrays or tensors on any device."""
    dev = resolve_device(device)
    src, dst = _ids(src, dev), _ids(dst, dev)
    if symmetrize:
        s, d = torch.cat([src, dst]), torch.cat([dst, src])
    else:
        s, d = src, dst
    del src, dst
    order = torch.sort(s, stable=True).indices
    indices = d[order].to(torch.int32)
    del d, order
    counts = torch.bincount(s.long(), minlength=n_vertices)
    if counts.numel() > n_vertices:
        raise IndexError(f"a vertex id is >= n_vertices = {n_vertices}")
    indptr = torch.zeros(n_vertices + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=indptr[1:])
    return CSRGraph(indptr=indptr.cpu().numpy(), indices=indices.cpu().numpy(),
                    n_vertices=n_vertices)


class SampledSubgraph(NamedTuple):
    """Fixed-shape padded subgraph for one minibatch."""

    nodes: np.ndarray  # (max_nodes,) global node ids (padded with 0)
    node_mask: np.ndarray  # (max_nodes,) bool
    edge_src: np.ndarray  # (max_edges,) local indices into `nodes`
    edge_dst: np.ndarray  # (max_edges,)
    edge_mask: np.ndarray  # (max_edges,) bool
    seed_count: int  # seeds occupy nodes[:seed_count]


class NeighborSampler:
    """Uniform fanout sampler with fixed padded output shapes."""

    def __init__(self, graph: CSRGraph, fanouts: tuple[int, ...], batch_nodes: int,
                 seed: int = 0):
        self.graph = graph
        self.fanouts = tuple(fanouts)
        self.batch_nodes = batch_nodes
        self.rng = np.random.default_rng(seed)
        # fixed budget: seeds + seeds*f1 + seeds*f1*f2 + ...
        n = batch_nodes
        self.max_nodes = batch_nodes
        self.max_edges = 0
        for f in self.fanouts:
            e = n * f
            self.max_edges += e
            n = e
            self.max_nodes += e

    def sample(self, seeds: np.ndarray | None = None) -> SampledSubgraph:
        """One minibatch: ``seeds`` (default: ``batch_nodes`` distinct
        vertices drawn from the sampler's generator), then each hop's
        picks, with the draws in the reference's order."""
        g = self.graph
        if seeds is None:
            seeds = self.rng.choice(g.n_vertices, size=self.batch_nodes, replace=False)
        seeds = np.asarray(seeds, np.int64)

        nodes: list[np.ndarray] = [seeds]
        local_of: dict[int, int] = {int(v): i for i, v in enumerate(seeds)}
        e_src: list[int] = []
        e_dst: list[int] = []
        frontier = seeds
        for f in self.fanouts:
            deg = g.indptr[frontier + 1] - g.indptr[frontier]
            next_frontier = []
            for v, dv in zip(frontier, deg):
                if dv == 0:
                    continue
                start = g.indptr[v]
                take = min(f, int(dv))
                picks = self.rng.choice(int(dv), size=take, replace=False)
                nbrs = g.indices[start + picks]
                lv = local_of[int(v)]
                for nb in nbrs:
                    nbi = int(nb)
                    li = local_of.get(nbi)
                    if li is None:
                        li = len(local_of)
                        local_of[nbi] = li
                        next_frontier.append(nbi)
                    # message flows neighbor → center
                    e_src.append(li)
                    e_dst.append(lv)
            frontier = np.asarray(next_frontier, np.int64)
            if frontier.size:
                nodes.append(frontier)
            if frontier.size == 0:
                break

        all_nodes = np.concatenate(nodes) if len(nodes) > 1 else nodes[0]
        n_real = all_nodes.size
        n_edges = len(e_src)
        out_nodes = np.zeros(self.max_nodes, np.int32)
        out_nodes[:n_real] = all_nodes[: self.max_nodes]
        node_mask = np.zeros(self.max_nodes, bool)
        node_mask[: min(n_real, self.max_nodes)] = True
        es = np.zeros(self.max_edges, np.int32)
        ed = np.zeros(self.max_edges, np.int32)
        emask = np.zeros(self.max_edges, bool)
        ne = min(n_edges, self.max_edges)
        es[:ne] = np.asarray(e_src[:ne], np.int32)
        ed[:ne] = np.asarray(e_dst[:ne], np.int32)
        emask[:ne] = True
        return SampledSubgraph(
            nodes=out_nodes, node_mask=node_mask, edge_src=es, edge_dst=ed,
            edge_mask=emask, seed_count=self.batch_nodes,
        )
