"""Sliding-window streams: the last W edges of a churning graph.

The port of ``repro.streaming.window``.  :class:`SlidingWindowStream`
turns an arrival-ordered :class:`~repro_torch.streaming.EdgeStream` (in
memory or the out-of-core ``ShardedEdgeStream``) into paired insert /
expire events: each step admits the next ``step_edges`` arrivals and
expires every edge that has left the trailing ``window_edges``.  A
decremental partitioner folds the inserts and retracts the expired edges,
so it keeps a partition of exactly the live window (its consumers come
with dynamic partitioning, ``incremental/``).

Events carry the expired edges' arrival indices, by which per-edge records
(parts, cluster tags) are kept, and the edges themselves, so a retraction
needs no random access into the stream.  One step's batches are host
arrays at a time, O(step + expired); out-of-core streams page both ranges
from their shards through ``_edges_at``.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple

import numpy as np

__all__ = ["SlidingWindowStream", "WindowEvent"]


class WindowEvent(NamedTuple):
    """One churn step: admit ``[start, start + len(src))``, expire the rest."""

    src: np.ndarray  # (B,) int32 inserted edges, arrival order
    dst: np.ndarray  # (B,) int32
    start: int  # arrival index of the first inserted edge
    expire_src: np.ndarray  # (D,) int32 edges leaving the window
    expire_dst: np.ndarray  # (D,) int32
    expire_idx: np.ndarray  # (D,) int64 their arrival indices
    lo: int  # the live window after this step is [lo, hi)
    hi: int

    @property
    def window_edges(self) -> int:
        return self.hi - self.lo


class SlidingWindowStream:
    """Insert/expire batches over a trailing window of ``window_edges``.

    ``step_edges`` (default: the stream's chunk size, at most the window)
    is how many arrivals each event admits.  Expiry is FIFO: an event's
    ``expire_idx`` is the arrival range ``[old_lo, new_lo)``, so after
    every event the live set is the last ``window_edges`` arrivals (fewer
    while the window fills).
    """

    def __init__(self, stream, window_edges: int, *,
                 step_edges: int | None = None):
        if getattr(stream, "ordering", "natural") != "natural":
            raise ValueError(
                "sliding windows are defined over arrival order; got a "
                f"{stream.ordering!r}-ordered stream (window membership "
                "under a global reordering has no stable FIFO expiry)")
        if window_edges < 1:
            raise ValueError("window_edges must be >= 1")
        if step_edges is None:
            step_edges = min(int(stream.chunk_size), int(window_edges))
        if step_edges < 1:
            raise ValueError("step_edges must be >= 1")
        self.stream = stream
        self.window_edges = int(window_edges)
        self.step_edges = int(step_edges)

    @property
    def n_edges(self) -> int:
        return self.stream.n_edges

    @property
    def n_steps(self) -> int:
        return -(-self.n_edges // self.step_edges)

    def _range(self, a: int, b: int) -> tuple[np.ndarray, np.ndarray]:
        """Edges at arrival positions [a, b), paged from disk out of core."""
        if a >= b:
            z = np.zeros(0, np.int32)
            return z, z
        s, d = self.stream._edges_at(slice(a, b), a, b)
        # copies: an out-of-core stream recycles its staging per read
        return np.array(s, np.int32), np.array(d, np.int32)

    def events(self) -> Iterator[WindowEvent]:
        """A fresh replay of the whole churn schedule."""
        E, W, B = self.n_edges, self.window_edges, self.step_edges
        lo = hi = 0
        while hi < E:
            new_hi = min(hi + B, E)
            new_lo = max(new_hi - W, 0)
            ins_s, ins_d = self._range(hi, new_hi)
            exp_s, exp_d = self._range(lo, new_lo)
            yield WindowEvent(
                src=ins_s, dst=ins_d, start=hi,
                expire_src=exp_s, expire_dst=exp_d,
                expire_idx=np.arange(lo, new_lo, dtype=np.int64),
                lo=new_lo, hi=new_hi,
            )
            lo, hi = new_lo, new_hi
