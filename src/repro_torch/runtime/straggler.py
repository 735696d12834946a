"""Straggler detection and mitigation (the port of
``repro.runtime.straggler``).

Per-shard step-time EMAs; a shard whose EMA exceeds ``threshold ×`` the
fleet median is flagged.  :meth:`StragglerMonitor.rebalance_plan` hands a
tail fraction of each straggler's range to the fastest shard;
:func:`repro_torch.streaming.run_parallel` drives it live at each merge
boundary (``straggler=``), hub-granular under hub sharding.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

__all__ = ["StragglerMonitor"]


class StragglerMonitor:
    def __init__(self, n_shards: int = 1, ema: float = 0.9,
                 threshold: float = 1.5):
        self.n_shards = n_shards
        self.ema = ema
        self.threshold = threshold
        self.times: dict[int, float] = defaultdict(float)
        self.history: list[tuple[int, int, float]] = []  # (step, shard, dt)

    def record(self, step: int, dt: float, shard: int = 0) -> None:
        shard = int(shard)
        # auto-grow: callers that discover lanes as they go (parallel
        # ingest) need not size the fleet up front
        self.n_shards = max(self.n_shards, shard + 1)
        prev = self.times[shard]
        self.times[shard] = dt if prev == 0 else self.ema * prev + (1 - self.ema) * dt
        self.history.append((step, shard, dt))

    def stragglers(self) -> list[int]:
        if not self.times:
            return []
        vals = np.array([self.times[s] for s in range(self.n_shards)])
        med = np.median(vals[vals > 0]) if (vals > 0).any() else 0.0
        if med == 0:
            return []
        return [s for s in range(self.n_shards) if self.times[s] > self.threshold * med]

    def rebalance_plan(self, shard_ranges: list[tuple[int, int]],
                       give_frac: float = 0.25):
        """Move ``give_frac`` of each straggler's range to the fastest
        shard.  Returns the new ranges (stream offsets: a metadata move)."""
        slow = set(self.stragglers())
        if not slow or not self.times:
            return shard_ranges
        fastest = min(range(self.n_shards), key=lambda s: self.times[s] or 1e9)
        out = list(shard_ranges)
        for s in slow:
            if s == fastest or s >= len(out):
                continue
            lo, hi = out[s]
            cut = int((hi - lo) * give_frac)
            out[s] = (lo, hi - cut)
            flo, fhi = out[fastest]
            # the fastest absorbs the tail (contiguity not required)
            out[fastest] = (flo, fhi + cut)
        return out
