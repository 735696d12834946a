"""Segment aggregation over an edge list: the layout and the entry point.

``segment_aggregate(x, src, dst, w, n_rows)`` has the signature of
``repro.kernels.segment_agg.segment_aggregate``.  The TPU version buckets
edges into padded destination-row tiles and, above 8,192 nodes, falls
back to ``jax.ops.segment_sum``; the port has no such fallback: the card
runs K5 at any size, or raises.  The edges are laid out once
(:func:`segment_layout`: stable sort by destination, ``row_ptr``) and the
layout can be reused for every aggregation over the same edges, with new
weights through :meth:`SegmentLayout.with_weights`.  The layout also lists
the rows of more than :data:`LONG_ROW_EDGES` edges, to which K5 gives a
block each.  :meth:`SegmentLayout.transposed` is the layout of the
gradient: the same edges reversed, built once per layout and kept.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..._device import resolve_device
from .kernel import segment_agg

__all__ = ["LONG_ROW_EDGES", "SegmentLayout", "segment_layout", "segment_aggregate"]

# T: a row of more than T edges is long, and K5 gives it a block for each
# 32-byte slice of its columns (a tree or a chain); shorter rows go to a
# group of threads or a warp.  Chosen from a sweep on the card (PERF.md, K5).
LONG_ROW_EDGES = 4096


class SegmentLayout(NamedTuple):
    """The edges with ``dst >= 0``, in stable destination order."""

    src: torch.Tensor  # (E',) int32
    dst: torch.Tensor  # (E',) int32, non-decreasing
    w: torch.Tensor  # (E',) float32
    row_ptr: torch.Tensor  # (n_rows + 1,) int64: row r owns [row_ptr[r], row_ptr[r+1])
    order: torch.Tensor  # (E',) int64: position of each edge in the caller's list
    n_rows: int
    n_src: int  # 1 + the largest src id (0 without edges)
    n_edges: int  # length of the caller's edge list, padding included
    long_rows: torch.Tensor  # (n_long,) int32: rows of more than T edges, longest first
    long_row_edges: int  # T
    cache: dict | None = None  # transposed layouts, keyed by the leaves they were built from

    def with_weights(self, w) -> "SegmentLayout":
        """The same edges under new per-edge weights, given in the caller's
        edge order (a gather, no sort)."""
        _constant(w)
        w = torch.as_tensor(w).to(self.w.device, torch.float32)
        if tuple(w.shape) != (self.n_edges,):
            raise ValueError(f"w must be an ({self.n_edges},) vector over the layout's edges")
        return self._replace(w=w[self.order].contiguous(), cache={})

    def transposed(self, n_rows: int) -> "SegmentLayout":
        """The layout of the gradient of a sum over this one: every edge
        ``src → dst`` as ``dst → src`` with its weight, into ``n_rows`` rows
        (the rows of the summed ``x``), each row's edges in the caller's
        edge order.  Built at the first call and kept with the layout."""
        key = (int(n_rows), id(self.src), id(self.dst), id(self.w))
        if self.cache is not None and key in self.cache:
            return self.cache[key]
        caller = torch.argsort(self.order)  # the kept edges back in the caller's order
        lay = segment_layout(self.dst[caller], self.src[caller], n_rows, self.w[caller],
                             device=self.w.device)
        if self.cache is not None:
            self.cache[key] = lay
        return lay


def _constant(w) -> None:
    if isinstance(w, torch.Tensor) and w.requires_grad:
        raise ValueError("a layout's weights are constants: K5 has no gradient for them, "
                         "so w must not require one (detach it)")


def segment_layout(src, dst, n_rows: int, w=None, *, device=None) -> SegmentLayout:
    """Lay out an edge list for :func:`segment_agg` on ``device`` (default
    ``cuda``).  ``dst < 0`` marks padding, which is dropped; a dst id
    ``>= n_rows`` or a negative src id raises."""
    dev = resolve_device(device)
    src = torch.as_tensor(src).to(dev, torch.int32)
    dst = torch.as_tensor(dst).to(dev, torch.int32)
    if src.dim() != 1 or src.shape != dst.shape:
        raise ValueError("src and dst must be (E,) vectors of one length")
    if w is None:
        w = torch.ones(src.shape, dtype=torch.float32, device=dev)
    _constant(w)
    w = torch.as_tensor(w).to(dev, torch.float32)
    if w.shape != src.shape:
        raise ValueError("w must have the shape of src")
    dst_sorted, order = torch.sort(dst, stable=True)
    n_pad = int((dst < 0).sum())
    dst_sorted, order = dst_sorted[n_pad:], order[n_pad:]
    src_sorted = src[order]
    counts = torch.bincount(dst_sorted, minlength=n_rows)
    if counts.numel() > n_rows:
        raise ValueError(f"a dst id is >= n_rows = {n_rows}")
    row_ptr = torch.zeros(n_rows + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=row_ptr[1:])
    long_rows = torch.nonzero(counts > LONG_ROW_EDGES)[:, 0]
    by_length = torch.sort(counts[long_rows], descending=True, stable=True).indices
    long_rows = long_rows[by_length].to(torch.int32)
    n_src = 0
    if src_sorted.numel():
        lo, hi = torch.aminmax(src_sorted)
        if int(lo) < 0:
            raise ValueError("a src id is negative")
        n_src = int(hi) + 1
    return SegmentLayout(src=src_sorted.contiguous(), dst=dst_sorted.contiguous(),
                         w=w[order].contiguous(), row_ptr=row_ptr, order=order,
                         n_rows=int(n_rows), n_src=n_src, n_edges=int(src.numel()),
                         long_rows=long_rows.contiguous(), long_row_edges=LONG_ROW_EDGES,
                         cache={})


def segment_aggregate(x, src, dst, w=None, n_rows=None, *, device=None) -> torch.Tensor:
    """``out[dst] += w·x[src]`` (float32 sums, result in ``x.dtype``) on
    ``device`` (default ``cuda``): K5 on the card, the plain version on
    the CPU."""
    dev = resolve_device(device)
    x = torch.as_tensor(x).to(dev)
    n_rows = int(x.shape[0]) if n_rows is None else int(n_rows)
    return segment_agg(x, segment_layout(src, dst, n_rows, w, device=dev))
