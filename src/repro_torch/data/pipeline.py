"""Step-addressable synthetic data pipelines and a host prefetcher.

The port of ``repro.data.pipeline``.  Every pipeline is a pure function of
(seed, step): replaying step s after a restart gives the same batch, the
property a resumed loop relies on.  The numpy draws are the reference's,
so the batches are its values, as tensors on the pipeline's ``device``
(default ``cuda``).

:class:`Prefetcher` builds the next batches on a host thread while the
caller computes (double buffering).
"""

from __future__ import annotations

import queue
import threading
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from .._device import resolve_device

__all__ = ["TokenPipeline", "RecsysPipeline", "EdgeChunkPipeline", "Prefetcher"]


class TokenPipeline:
    """Zipf-distributed token batches (LM pretraining stand-in)."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0,
                 zipf_a: float = 1.2, *, device=None):
        self.vocab, self.batch, self.seq, self.seed = vocab, batch, seq, seed
        self.zipf_a = zipf_a
        self.device = resolve_device(device)

    def __call__(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        toks = rng.zipf(self.zipf_a, (self.batch, self.seq + 1)) % self.vocab
        toks = torch.from_numpy(toks.astype(np.int32)).to(self.device)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


class RecsysPipeline:
    """Click-log batches: power-law feature ids and logistic labels."""

    def __init__(self, vocabs: tuple[int, ...], batch: int, seed: int = 0, *,
                 device=None):
        self.vocabs, self.batch, self.seed = vocabs, batch, seed
        self.device = resolve_device(device)

    def __call__(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        cols = [(rng.zipf(1.3, self.batch) % v).astype(np.int32) for v in self.vocabs]
        ids = np.stack(cols, axis=1)
        # labels follow a fixed hash of field 0 (learnable), in int64: the
        # reference's int32 product promotes so under numpy 1 and raises
        # OverflowError under numpy 2 (ROADMAP Queue 3 k)
        h = (ids[:, 0].astype(np.int64) * 2654435761 % 97) / 97.0
        labels = (rng.random(self.batch) < 0.15 + 0.5 * h).astype(np.float32)
        return {"field_ids": torch.from_numpy(ids).to(self.device),
                "labels": torch.from_numpy(labels).to(self.device)}


class EdgeChunkPipeline:
    """Step-addressable edge chunks of an :class:`~repro_torch.streaming.EdgeStream`.

    ``step`` indexes chunks modulo the stream (one replay an epoch), so
    replaying step s gives the same chunk.  With :class:`Prefetcher` the
    host's chunking, or an out-of-core stream's disk paging, overlaps the
    device's scans.  The first argument is a ``src`` array (``dst`` and
    ``n_vertices`` follow), a built stream (any ``EdgeStream``, on its own
    device), or a shard manifest path or ``file:<path>`` spec, which opens
    a :class:`~repro_torch.streaming.ShardedEdgeStream` on ``device``.
    """

    def __init__(self, src, dst=None, n_vertices: int | None = None, *,
                 chunk_size: int = 1 << 16, ordering: str = "natural",
                 seed: int = 0, window: int = 4096, device=None):
        from ..streaming import EdgeStream, ShardedEdgeStream

        if isinstance(src, EdgeStream):
            if dst is not None or n_vertices is not None:
                raise ValueError("pass either a stream or (src, dst, n_vertices)")
            self.stream = src
        elif isinstance(src, (str, Path)):
            manifest = str(src)
            manifest = manifest[5:] if manifest.startswith("file:") else manifest
            if dst is not None or n_vertices is not None:
                raise ValueError("pass either a manifest path or (src, dst, n_vertices)")
            self.stream = ShardedEdgeStream(manifest, chunk_size=chunk_size,
                                            ordering=ordering, seed=seed,
                                            window=window, device=device)
        else:
            self.stream = EdgeStream(src, dst, n_vertices, chunk_size=chunk_size,
                                     ordering=ordering, seed=seed, window=window,
                                     device=device)

    def __call__(self, step: int) -> dict:
        # only the requested chunk is built
        nc = self.stream.n_chunks
        ch = self.stream.chunk_at(step % nc)
        return {"src": ch.src, "dst": ch.dst, "start": ch.start,
                "n_valid": ch.n_valid, "epoch": step // nc}


class Prefetcher:
    """Double-buffered prefetch around any step-addressable ``fn``.

    ``stop()`` ends the worker: the producer blocks only in a ``put`` with
    a timeout (re-checking the stop flag), and ``stop`` drains the queue
    until the thread exits, so ``start``/``stop``/``start`` cycles are safe
    (each ``start`` gets a fresh queue).  A worker that dies in ``fn``
    raises in the consumer instead of leaving it waiting on an empty
    queue.  A step other than the next queued one is built directly.
    """

    _FAILED = object()  # queue sentinel: the worker died in fn

    def __init__(self, fn: Callable[[int], dict], depth: int = 2):
        self.fn = fn
        self.depth = depth
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = True
        self._error: BaseException | None = None
        self._thread: threading.Thread | None = None

    def start(self, start_step: int = 0) -> None:
        self.stop()  # end any previous worker first
        self._stop = False
        self._error = None
        q = self._q = queue.Queue(maxsize=self.depth)

        def put_until_stopped(item) -> bool:
            while not self._stop:
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def work():
            s = start_step
            try:
                while not self._stop:
                    if put_until_stopped((s, self.fn(s))):
                        s += 1
            except BaseException as e:  # noqa: BLE001 — raised in the consumer
                self._error = e
                put_until_stopped((s, self._FAILED))

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def __call__(self, step: int) -> dict:
        if self._thread is None:
            return self.fn(step)
        while True:
            try:
                s, batch = self._q.get(timeout=0.1)
            except queue.Empty:
                if self._error is not None:
                    raise RuntimeError("prefetch worker died") from self._error
                if not self._thread.is_alive():
                    return self.fn(step)  # worker gone without an error
                continue
            if batch is self._FAILED:
                raise RuntimeError(
                    f"prefetch worker died at step {s}") from self._error
            if s == step:
                return batch
            if s > step:  # a seek backwards: build it directly
                return self.fn(step)

    def stop(self) -> None:
        self._stop = True
        t = self._thread
        if t is None:
            return
        while t.is_alive():
            try:  # unblock a producer waiting on a full queue
                self._q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=0.05)
        self._thread = None
