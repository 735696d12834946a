"""EdgeStream — chunked, replayable edge streams with pluggable orderings.

The stream owns host-resident numpy edge arrays; the device only ever
sees one fixed-size chunk (padded with ``(0, 0)`` self-loops, which every
consumer masks as no-ops).  ``chunks()`` replays the same deterministic
order every time it is called, so the clustering pass, the Θ pass and the
placement pass are three replays of one stream object.

Orderings (``ordering=``): ``"natural"`` (arrival order), ``"shuffled"``
(a seeded global permutation), ``"dst-sorted"`` (stable sort by
destination) and ``"windowed"`` (a sliding buffer of ``window`` edges
that emits the lowest destination first).  Chunks are bit-identical to
``repro.streaming.EdgeStream``'s for the same arguments.
"""

from __future__ import annotations

import heapq
from typing import Iterator, NamedTuple

import numpy as np
import torch

from .._device import resolve_device

__all__ = ["Chunk", "EdgeStream", "ORDERINGS"]

ORDERINGS = ("natural", "shuffled", "dst-sorted", "windowed")

DEFAULT_CHUNK = 1 << 16


class Chunk(NamedTuple):
    """One device-resident slice of the stream.

    Padding entries (tail chunk of a multi-chunk stream only) are (0, 0)
    self-loops with zeroed extras.
    """

    src: torch.Tensor  # (B,) int32
    dst: torch.Tensor  # (B,) int32
    extras: tuple  # per-edge tensors sliced in the same order
    start: int  # offset of this chunk in stream order
    n_valid: int  # true (unpadded) edge count, <= B


def _windowed_emit(dst_iter, window: int) -> Iterator[int]:
    """Sliding-buffer reorder: emit the buffered edge with the smallest
    destination first (ties by arrival); the buffer holds <= ``window``."""
    heap: list[tuple[int, int]] = []
    for i, d in enumerate(dst_iter):
        heapq.heappush(heap, (int(d), i))
        if len(heap) > window:
            yield heapq.heappop(heap)[1]
    while heap:
        yield heapq.heappop(heap)[1]


def _windowed_order(dst: np.ndarray, window: int) -> np.ndarray:
    return np.fromiter(_windowed_emit(dst, window), np.int64,
                       count=dst.shape[0])


class EdgeStream:
    """Chunked multi-pass view over an edge list; chunks land on ``device``."""

    def __init__(self, src, dst, n_vertices: int | None = None, *,
                 chunk_size: int = DEFAULT_CHUNK, ordering: str = "natural",
                 seed: int = 0, window: int = 4096, device=None):
        if ordering not in ORDERINGS:
            raise ValueError(f"unknown ordering {ordering!r}; one of {ORDERINGS}")
        if chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        if window < 1:
            raise ValueError("window must be >= 1")
        self.device = resolve_device(device)
        self.src = _host_int32(src)
        self.dst = _host_int32(dst)
        if self.src.shape != self.dst.shape:
            raise ValueError("src/dst shape mismatch")
        if n_vertices is None:
            n_vertices = (int(max(self.src.max(), self.dst.max())) + 1
                          if self.src.size else 0)
        self.n_vertices = int(n_vertices)
        self.chunk_size = int(chunk_size)
        self.ordering = ordering
        self.seed = int(seed)
        self.window = int(window)
        self._order = self._make_order()
        #: parallel-ingest plans built over this stream, a pure function of
        #: its edges, kept for the passes that replay it (``parallel.py``)
        self.plans: dict = {}

    def _make_order(self) -> np.ndarray | None:
        if self.ordering == "natural":
            return None
        if self.ordering == "shuffled":
            return np.random.default_rng(self.seed).permutation(self.n_edges)
        if self.ordering == "dst-sorted":
            return np.argsort(self.dst, kind="stable")
        return _windowed_order(self.dst, self.window)

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])

    def __len__(self) -> int:
        return self.n_edges

    @property
    def n_chunks(self) -> int:
        return max(-(-self.n_edges // self.chunk_size), 1)

    @property
    def order(self) -> np.ndarray | None:
        """Stream order as a permutation of arrival indices (None = identity)."""
        return self._order

    def _edges_at(self, sl, start: int, stop: int):
        """The data-access hook: host int32 ``(src, dst)`` of stream
        positions [start, stop).  ``sl`` is a ``slice`` of arrival positions
        (natural order) or an int array of arrival indices (the others);
        the out-of-core stream pages them from disk instead.  Everything
        else in :meth:`chunk_at` is shared, so the engines agree bit for
        bit."""
        return self.src[sl], self.dst[sl]

    def chunk_at(self, i: int, *extras, pad: bool = True) -> Chunk:
        """Build chunk ``i``.  ``extras`` are per-edge tensors or array-likes
        (numpy arrays, memmaps, a sharded stream's field views: anything
        with ``.shape`` and ``__getitem__`` passes through unread), sliced
        in stream order alongside src/dst and padded with zeros.  With
        ``pad=True`` every chunk of a multi-chunk stream has exactly
        ``chunk_size`` entries; a single-chunk stream comes back
        unpadded."""
        if not 0 <= i < self.n_chunks:
            raise IndexError(f"chunk {i} out of range [0, {self.n_chunks})")
        ex = [e if hasattr(e, "shape") else np.asarray(e) for e in extras]
        for e in ex:
            if e.shape[0] != self.n_edges:
                raise ValueError("extra array length != n_edges")
        n, cs = self.n_edges, self.chunk_size
        start = i * cs
        stop = min(start + cs, n)
        sl = (slice(start, stop) if self._order is None
              else np.array(self._order[start:stop]))  # writable, if mmap-backed
        s, d = self._edges_at(sl, start, stop)
        exc = [_take(e, sl, self.device) for e in ex]
        padn = cs - s.shape[0] if pad and start > 0 else 0
        if padn > 0:
            s = np.concatenate([s, np.zeros(padn, np.int32)])
            d = np.concatenate([d, np.zeros(padn, np.int32)])
            exc = [torch.cat([e, e.new_zeros((padn,) + tuple(e.shape[1:]))])
                   for e in exc]
        return Chunk(
            src=torch.from_numpy(s).to(self.device),
            dst=torch.from_numpy(d).to(self.device),
            extras=tuple(exc),
            start=start,
            n_valid=stop - start,
        )

    def chunks(self, *extras, pad: bool = True) -> Iterator[Chunk]:
        """Yield the stream as fixed-size chunks (a fresh replay per call)."""
        for i in range(self.n_chunks):
            yield self.chunk_at(i, *extras, pad=pad)

    def scatter_back(self, values: torch.Tensor) -> torch.Tensor:
        """Map per-edge results (last axis) from stream to arrival order."""
        if self._order is None:
            return values
        order = np.asarray(self._order)  # an mmap-backed order reads in place
        inv = np.empty(order.size, np.int64)
        inv[order] = np.arange(order.size)
        return values.index_select(-1, torch.from_numpy(inv).to(values.device))


def _host_int32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, np.int32)


def _take(e, sl, device) -> torch.Tensor:
    """Slice one per-edge extra in stream order, as a tensor on ``device``."""
    if isinstance(e, torch.Tensor):
        if isinstance(sl, slice):
            return e[sl].to(device)
        return e.index_select(0, torch.from_numpy(sl).to(e.device)).to(device)
    rows = np.ascontiguousarray(e[sl])
    if not rows.flags.writeable:  # a read-only memmap's rows
        rows = rows.copy()
    return torch.from_numpy(rows).to(device)
