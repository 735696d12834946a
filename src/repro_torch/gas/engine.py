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
segments of one device array.  PageRank's per-partition gather is one K5
launch (``kernels/segment_agg``) over the replica rows, laid out once by
:func:`build_gas_graph`: each edge is keyed to the compacted row of its
``(dst, part)`` replica, and K5 sums each row in edge order, as
``jax.ops.segment_sum`` does.  The mirror→master sum runs in the order of
XLA's CPU reduce and the apply as the fused multiply-add XLA emits, so a
superstep gives the reference's bits on the CPU and the same bits on the
card, run after run.  The mirror counts and label propagation (integer
minima) are exact.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from .._fp32 import fma_f32, xla_sum_f32_columns
from ..kernels.segment_agg.kernel import segment_agg
from ..kernels.segment_agg.ops import SegmentLayout, segment_layout

__all__ = ["GASGraph", "CommStats", "build_gas_graph", "pagerank",
           "pagerank_step", "out_degree_inv", "carry_values",
           "label_propagation", "label_propagation_step", "comm_stats"]


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
    replica_slots: torch.Tensor  # (R,) int64: p·V + v of each replica, in (v, p) order
    gather: SegmentLayout  # K5 layout: edge → its (dst, part) replica row


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
    # PageRank's gather layout: replica rows compacted in (v, p) order, so
    # K5 runs over R ≈ RF·V rows instead of V·k; each row's sum lands in
    # a (k, V) accumulator, whose k rows the mirror→master sum reads whole
    flat = torch.nonzero(mask.view(-1))[:, 0]
    row_of = torch.full((n_vertices * k,), -1, dtype=torch.int64, device=dev)
    row_of[flat] = torch.arange(flat.numel(), device=dev)
    gather = segment_layout(src, row_of[dst.long() * k + p], int(flat.numel()), device=dev)
    return GASGraph(src=src, dst=dst, edge_part=parts, part_offsets=offsets,
                    replica_mask=mask, masters=masters.to(torch.int32),
                    n_vertices=n_vertices, k=k,
                    replica_slots=(flat % k) * n_vertices + flat // k, gather=gather)


def comm_stats(g: GASGraph) -> CommStats:
    """Per-superstep replica sync volume (each mirror ⇄ master once)."""
    replicas = g.replica_mask.sum(dim=1)
    mirrors = int((replicas - 1).clamp(min=0).sum())
    return CommStats(mirror_to_master_msgs=mirrors, master_to_mirror_msgs=mirrors)


def _gas_superstep(g: GASGraph, values: torch.Tensor,
                   out_deg_inv: torch.Tensor) -> torch.Tensor:
    """One gather-apply-scatter round of PageRank, replica-exact: the
    partition-local accumulators (vertex × partition) are summed by the
    mirror→master reduction, as the distributed run would.  The gather is
    one K5 launch on the card (the plain version on the CPU): each
    replica row sums ``values[src]·out_deg_inv[src]`` over its edges in
    edge order."""
    contrib = (values * out_deg_inv)[:, None]
    local = torch.zeros(g.k * g.n_vertices, dtype=torch.float32, device=values.device)
    local[g.replica_slots] = segment_agg(contrib, g.gather)[:, 0]
    # the mirror→master sum: XLA's CPU reduce over each vertex's k replicas
    total = xla_sum_f32_columns(local.view(g.k, g.n_vertices))
    return fma_f32(torch.full_like(total, 0.85), total, torch.full_like(total, 0.15))


def label_propagation_step(g: GASGraph, labels: torch.Tensor) -> torch.Tensor:
    """One min-label superstep from ``labels`` (int32, (V,)): each vertex
    takes the least label among itself and its neighbours, gathered per
    replica.  Integer minima: the same bits in any order, on any device."""
    dev = g.src.device
    n, k = g.n_vertices, g.k
    big = 2**30
    s, d, p = g.src.long(), g.dst.long(), g.edge_part.long()

    def seg_min(vals, idx):
        out = torch.full((n * k,), big, dtype=torch.int32, device=dev)
        return out.scatter_reduce_(0, idx, vals, reduce="amin").view(n, k)

    lmin = seg_min(labels[s], d * k + p)
    rmin = seg_min(labels[d], s * k + p)
    local = torch.minimum(torch.where(g.replica_mask, lmin, big),
                          torch.where(g.replica_mask, rmin, big))
    return torch.minimum(labels, local.amin(dim=1))


def label_propagation(g: GASGraph, iterations: int = 5):
    """Connected components via min-label propagation on the vertex cut:
    the same replica-sync structure as PageRank, gather = min."""
    labels = torch.arange(g.n_vertices, dtype=torch.int32, device=g.src.device)
    for _ in range(iterations):
        labels = label_propagation_step(g, labels)
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
