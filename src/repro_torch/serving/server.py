"""The read side: GAS super-steps and queries over pinned bundle versions
(port of ``repro.serving.server``).

:class:`GASServer` runs vertex programs over whatever version the
:class:`~repro_torch.serving.bundle.BundleRegistry` publishes.  Every
super-step pins one version for its whole duration, so a concurrent swap
takes effect at the next step boundary.  The PageRank value vector stays
on the bundle's device and is carried across swaps
(:func:`~repro_torch.gas.carry_values`).  Each super-step records the
pinned version's RF and mirror-sync bytes; each query records its latency:
host time around work that ends in a copy to the host, so the device has
finished it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from ..gas import carry_values, comm_stats, label_propagation, pagerank_step
from .bundle import BundleRegistry, PartitionBundle

__all__ = ["GASServer", "ServingMetrics", "SuperstepRecord"]


class SuperstepRecord(NamedTuple):
    """One GAS super-step as observed by the server."""

    step: int
    version: int  # bundle version the step was pinned to
    swapped: bool  # first step on a new version
    sync_bytes: int  # mirror⇄master volume of this step
    rf: float
    n_edges: int


@dataclass
class ServingMetrics:
    """Accumulated serving telemetry (the RF → bytes → latency pipe)."""

    supersteps: list[SuperstepRecord] = field(default_factory=list)
    query_latency_us: list[float] = field(default_factory=list)
    swaps_observed: int = 0

    @property
    def total_sync_bytes(self) -> int:
        return sum(r.sync_bytes for r in self.supersteps)

    @property
    def n_supersteps(self) -> int:
        return len(self.supersteps)

    def bytes_per_superstep(self) -> float:
        return self.total_sync_bytes / max(self.n_supersteps, 1)

    def mean_query_latency_us(self) -> float:
        return float(np.mean(self.query_latency_us)) if self.query_latency_us else 0.0

    def summary(self) -> dict:
        rfs = [r.rf for r in self.supersteps]
        return {
            "supersteps": self.n_supersteps,
            "swaps_observed": self.swaps_observed,
            "sync_bytes_total": self.total_sync_bytes,
            "sync_bytes_per_superstep": self.bytes_per_superstep(),
            "rf_final": rfs[-1] if rfs else 0.0,
            "queries": len(self.query_latency_us),
            "query_latency_us_mean": self.mean_query_latency_us(),
        }


class GASServer:
    """Continuous GAS execution over the registry's live versions."""

    def __init__(self, registry: BundleRegistry):
        self.registry = registry
        self.values: torch.Tensor | None = None  # carried vertex state
        self.metrics = ServingMetrics()
        self._step = 0
        self._last_version = -1

    # ----------------------------------------------------------- compute
    def superstep(self) -> SuperstepRecord | None:
        """One pinned PageRank super-step; ``None`` before first publish."""
        with self.registry.pin() as bundle:
            if bundle is None:
                return None
            swapped = bundle.version != self._last_version
            if swapped and self._last_version >= 0:
                self.metrics.swaps_observed += 1
            self._last_version = bundle.version
            if self.values is None:
                self.values = torch.ones(bundle.n_vertices, dtype=torch.float32,
                                         device=bundle.device)
            else:
                self.values = carry_values(self.values, bundle.n_vertices)
            self.values = pagerank_step(bundle.gas, self.values, bundle.out_deg_inv)
            rec = SuperstepRecord(
                step=self._step, version=bundle.version, swapped=swapped,
                sync_bytes=bundle.bytes_per_superstep(),
                rf=bundle.rf, n_edges=bundle.n_edges)
        self._step += 1
        self.metrics.supersteps.append(rec)
        return rec

    def run(self, n_supersteps: int) -> list[SuperstepRecord]:
        """Run ``n`` super-steps (skipping while nothing is published)."""
        out = []
        for _ in range(n_supersteps):
            rec = self.superstep()
            if rec is not None:
                out.append(rec)
        return out

    # ----------------------------------------------------------- queries
    def _record(self, t0: float) -> None:
        self.metrics.query_latency_us.append((time.perf_counter() - t0) * 1e6)

    def query_pagerank(self, vertices) -> np.ndarray:
        """Read the carried PageRank values for ``vertices`` (timed)."""
        t0 = time.perf_counter()
        with self.registry.pin() as bundle:
            if bundle is None or self.values is None:
                out = np.zeros(len(vertices), np.float32)
            else:
                idx = torch.as_tensor(np.asarray(vertices, np.int64), device=self.values.device)
                out = self.values[idx].cpu().numpy()
        self._record(t0)
        return out

    def query_components(self, iterations: int = 5) -> np.ndarray | None:
        """Label-propagation components on the pinned version (timed)."""
        t0 = time.perf_counter()
        with self.registry.pin() as bundle:
            if bundle is None:
                return None
            labels, _ = label_propagation(bundle.gas, iterations)
            out = labels.cpu().numpy()
        self._record(t0)
        return out

    def query_gnn(self, params, feats, cfg, vertices=None) -> np.ndarray | None:
        """GCN inference over the pinned version's live edges (timed).

        Runs :func:`repro_torch.models.gnn.gcn_forward` on the bundle's edge
        list, on the bundle's device — the same live window the GAS programs
        execute over — and returns logits for ``vertices`` (all by default).
        """
        from ..models.gnn import gcn_forward

        t0 = time.perf_counter()
        with self.registry.pin() as bundle:
            if bundle is None:
                return None
            logits = gcn_forward(params, feats, bundle.edge_src, bundle.edge_dst,
                                 bundle.n_vertices, cfg, device=bundle.device)
            if vertices is not None:
                logits = logits[torch.as_tensor(np.asarray(vertices, np.int64),
                                                device=logits.device)]
            out = logits.cpu().numpy()
        self._record(t0)
        return out

    # ------------------------------------------------------- convergence
    def run_to_convergence(self, tol: float = 1e-6, max_steps: int = 200) -> int:
        """Super-step until the value vector moves < ``tol`` (∞-norm);
        returns the steps taken."""
        for i in range(max_steps):
            prev = self.values
            self.superstep()
            if prev is not None and self.values is not None \
                    and prev.shape == self.values.shape:
                delta = float(torch.max(torch.abs(self.values - prev)))
                if delta < tol:
                    return i + 1
        return max_steps

    @staticmethod
    def comm_of(bundle: PartitionBundle):
        return comm_stats(bundle.gas)
