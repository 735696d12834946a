"""PowerGraph-style GAS (Gather-Apply-Scatter) engine over a vertex cut.

The downstream consumer the paper deploys S5P into (§6.6): each partition
holds an edge set and *replicas* of every incident vertex.  Per super-step:

  1. local gather:   per-partition sum of edge messages into the local
                     replicas;
  2. replica→master: every mirror sends its partial accumulator to the
                     master copy (**network**, counted);
  3. apply:          the master applies the vertex program;
  4. master→mirror:  new vertex values go back to the mirrors
                     (**network**, counted).

The replication factor is therefore the driver of communication: the
byte counts (:func:`comm_stats`) are exact, not simulated.  This is the
reference's single-host mode (``repro.gas.engine``): partitions are
segments of one device array, and the per-partition gather is one
``index_add_`` into a ``(V·k,)`` accumulator.  On the card float32
atomics add in an order that changes from run to run, so PageRank values
agree with the reference within a tolerance (the tests state it); the
mirror counts and label propagation (integer minima) are exact.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device

__all__ = ["GASGraph", "CommStats", "build_gas_graph", "pagerank",
           "pagerank_step", "out_degree_inv", "carry_values",
           "label_propagation", "comm_stats"]


class GASGraph(NamedTuple):
    """Vertex-cut layout: edges grouped by partition + replica tables."""

    src: torch.Tensor  # (E,) int32, grouped by partition
    dst: torch.Tensor  # (E,)
    edge_part: torch.Tensor  # (E,) int32
    part_offsets: np.ndarray  # (k+1,) edge ranges per partition
    replica_mask: torch.Tensor  # (V, k) bool — v has a replica in p
    masters: torch.Tensor  # (V,) int32 — master partition per vertex
    n_vertices: int
    k: int


class CommStats(NamedTuple):
    mirror_to_master_msgs: int
    master_to_mirror_msgs: int

    def total_bytes(self, bytes_per_value: int = 8) -> int:
        return (self.mirror_to_master_msgs + self.master_to_mirror_msgs) * bytes_per_value


def build_gas_graph(src, dst, parts, n_vertices: int, k: int, *,
                    device=None) -> GASGraph:
    """Group the placed edges by partition (a stable sort, as in the
    reference) and build the replica table, all on ``device`` (default
    ``cuda``)."""
    dev = resolve_device(device)
    src, dst, parts = (torch.as_tensor(x).to(dev, torch.int32)
                       for x in (src, dst, parts))
    valid = parts >= 0
    src, dst, parts = src[valid], dst[valid], parts[valid]
    parts, order = torch.sort(parts, stable=True)
    src, dst = src[order], dst[order]
    offsets = np.zeros(k + 1, np.int64)
    offsets[1:] = torch.bincount(parts, minlength=k).cumsum(0).cpu().numpy()
    p = parts.long()
    mask = torch.zeros(n_vertices * k, dtype=torch.bool, device=dev)
    mask[src.long() * k + p] = True
    mask[dst.long() * k + p] = True
    mask = mask.view(n_vertices, k)
    # master = lowest-id partition holding the vertex (comm counts do not
    # depend on the choice); argmax returns the first maximum
    masters = torch.where(mask.any(dim=1), mask.to(torch.uint8).argmax(dim=1), 0)
    return GASGraph(src=src, dst=dst, edge_part=parts, part_offsets=offsets,
                    replica_mask=mask, masters=masters.to(torch.int32),
                    n_vertices=n_vertices, k=k)


def comm_stats(g: GASGraph) -> CommStats:
    """Per-superstep replica sync volume (each mirror ⇄ master once)."""
    replicas = g.replica_mask.sum(dim=1)
    mirrors = int((replicas - 1).clamp(min=0).sum())
    return CommStats(mirror_to_master_msgs=mirrors, master_to_mirror_msgs=mirrors)


def _gas_superstep(g: GASGraph, values: torch.Tensor,
                   out_deg_inv: torch.Tensor) -> torch.Tensor:
    """One gather-apply-scatter round of PageRank, replica-exact: the
    partition-local accumulators (vertex × partition) are summed by the
    mirror→master reduction, as the distributed run would."""
    s = g.src.long()
    contrib = values[s] * out_deg_inv[s]
    flat = g.dst.long() * g.k + g.edge_part.long()
    local = torch.zeros(g.n_vertices * g.k, dtype=torch.float32,
                        device=values.device)
    local.index_add_(0, flat, contrib)
    local = local.view(g.n_vertices, g.k)
    total = torch.where(g.replica_mask, local, 0.0).sum(dim=1)
    return 0.15 + 0.85 * total


def label_propagation(g: GASGraph, iterations: int = 5):
    """Connected components via min-label propagation on the vertex cut:
    the same replica-sync structure as PageRank, gather = min."""
    dev = g.src.device
    n, k = g.n_vertices, g.k
    labels = torch.arange(n, dtype=torch.int32, device=dev)
    big = 2**30
    s, d, p = g.src.long(), g.dst.long(), g.edge_part.long()

    def seg_min(vals, idx):
        out = torch.full((n * k,), big, dtype=torch.int32, device=dev)
        return out.scatter_reduce_(0, idx, vals, reduce="amin").view(n, k)

    for _ in range(iterations):
        lmin = seg_min(labels[s], d * k + p)
        rmin = seg_min(labels[d], s * k + p)
        local = torch.minimum(torch.where(g.replica_mask, lmin, big),
                              torch.where(g.replica_mask, rmin, big))
        labels = torch.minimum(labels, local.amin(dim=1))
    per = comm_stats(g)
    return labels, CommStats(per.mirror_to_master_msgs * iterations,
                             per.master_to_mirror_msgs * iterations)


def out_degree_inv(g: GASGraph) -> torch.Tensor:
    """``1/outdeg`` per vertex (0 for sinks), the PageRank edge weight."""
    out_deg = torch.bincount(g.src.long(), minlength=g.n_vertices).to(torch.float32)
    return torch.where(out_deg > 0, 1.0 / out_deg.clamp(min=1.0), 0.0)


def pagerank_step(g: GASGraph, values: torch.Tensor,
                  out_deg_inv: torch.Tensor | None = None) -> torch.Tensor:
    """One PageRank super-step from ``values``, the serving-loop unit; its
    comm is :func:`comm_stats` of the graph it ran on."""
    if out_deg_inv is None:
        out_deg_inv = out_degree_inv(g)
    return _gas_superstep(g, values, out_deg_inv)


def carry_values(values, n_vertices: int, fill: float = 1.0) -> torch.Tensor:
    """Carry a vertex-state vector across a layout swap: shared vertices
    keep their state, new ones start at ``fill``, a shrunken table is
    truncated."""
    values = torch.as_tensor(values, dtype=torch.float32)
    n_old = values.shape[0]
    if n_vertices <= n_old:
        return values[:n_vertices]
    pad = torch.full((n_vertices - n_old,), fill, dtype=torch.float32,
                     device=values.device)
    return torch.cat([values, pad])


def pagerank(g: GASGraph, iterations: int = 10):
    """PageRank on the vertex-cut layout + exact per-superstep comm stats."""
    inv = out_degree_inv(g)
    values = torch.ones(g.n_vertices, dtype=torch.float32, device=g.src.device)
    for _ in range(iterations):
        values = pagerank_step(g, values, inv)
    per = comm_stats(g)
    return values, CommStats(per.mirror_to_master_msgs * iterations,
                             per.master_to_mirror_msgs * iterations)
