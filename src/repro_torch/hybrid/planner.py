"""Budget planner: size the resident skew core from a CMS degree sketch
(the port of ``repro.hybrid.planner``).

The hybrid regime needs one number before any edge is retained: the core
degree threshold ξ* such that the resident core (spilled core edge
records, the tables they drag along, the refinement's state) fits a
caller-supplied byte budget.  The planner sizes the core online from a
count-min sketch of vertex degrees (one streamed pass, K4a twice a chunk
on the card) and a deterministic stride sample of edges (two K4b point
queries), then picks ξ* from the sample's min-degree quantiles on the
host, in numpy, as the reference does.

Two properties the driver leans on, both the reference's:

- **one-sided safety**: CMS point queries over-estimate degrees, so the
  predicted core size at any threshold over-estimates too; the driver's
  hard-capped :class:`~repro_torch.streaming.HostBudget` catches the
  residual sampling error by moving ξ* one ladder level up;
- **budget-independent ladder**: the candidate thresholds are quantiles
  at fixed core fractions, so a larger budget's ladder extends a smaller
  one's, which makes the quality/memory frontier monotone.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from ..core.cms import (CMSketch, cms_query, cms_retract, cms_update, make_sketch,
                        suggest_params, vertex_key)
from ..streaming import REPLICATED, SUM, PartitionerCarry, as_stream, run_parallel

__all__ = [
    "BudgetPlan",
    "CORE_EDGE_BYTES",
    "CORE_FRACTIONS",
    "DegreeSketchCarry",
    "build_degree_sketch",
    "plan_budget",
]

_INT32_MAX = 2**31 - 1

# One resident core-edge record: src(4) + dst(4) + arrival index(8) +
# cluster tags cu/cv(4+4) + min endpoint degree(4) + head flag(1).
CORE_EDGE_BYTES = 29

# Fixed per-plan overhead charged against the budget besides edge records:
# the k-vector core load, the per-cluster move masks, numpy object slack.
PLAN_FIXED_BYTES = 4096

# Candidate core fractions, smallest first.  The threshold ladder is these
# fractions' min-degree quantiles; a budget admits a prefix-closed set.
CORE_FRACTIONS = (1 / 64, 1 / 32, 1 / 16, 1 / 8, 1 / 4, 1 / 2, 1.0)


class BudgetPlan(NamedTuple):
    """Resident-core sizing decision for one hybrid run."""

    budget_bytes: int        # requested host budget (0 ⇒ pure streaming)
    mode: str                # "streaming" | "hybrid" | "in_memory"
    xi_star: int             # core threshold: resident iff min end-degree > ξ*
    ladder: tuple[int, ...]  # descending refine thresholds, last == ξ*
    est_core_edges: int      # sketch-estimated resident edge count at ξ*
    est_core_bytes: int      # … and its byte cost (records + fixed overhead)
    total_edges: int
    sample_edges: int        # stride-sample size the quantiles came from
    sketch_bytes: int        # planner's own CMS footprint (not budgeted)

    @property
    def resident(self) -> bool:
        return self.mode != "streaming"


class DegreeSketchCarry(PartitionerCarry):
    """Vertex-degree pass as a carry: a CMS over per-vertex keys.

    Each valid non-self-loop edge adds one at both endpoints' keys (K4a
    twice a chunk on the card), so a point query over-estimates deg(v)
    one-sidedly.  The table SUMs in ℤ/2³² and the seeds are REPLICATED,
    so lanes merge exactly, as the Θ pass's
    :class:`~repro_torch.core.cms.SketchCarry` does.
    """

    emits_parts = False
    supports_retract = True
    retract_exact = True
    merge_ops = (SUM, REPLICATED)

    def __init__(self, width: int, depth: int, seed: int = 0, device=None):
        self.width = int(width)
        self.depth = int(depth)
        self.seed = int(seed)
        self.device = resolve_device(device)

    def init(self) -> CMSketch:
        return make_sketch(self.width, self.depth, seed=self.seed,
                           device=self.device)

    @staticmethod
    def _counts(src, dst, n_valid):
        real = torch.arange(src.shape[0], device=src.device) < n_valid
        return (real & (src != dst)).to(torch.int64)

    def step_chunk(self, carry, src, dst, n_valid, *extras):
        counts = self._counts(src, dst, n_valid)
        carry = cms_update(carry, vertex_key(src), counts)
        carry = cms_update(carry, vertex_key(dst), counts)
        return carry, None

    def retract_chunk(self, carry, src, dst, n_valid, parts, *extras):
        counts = self._counts(src, dst, n_valid)
        carry = cms_retract(carry, vertex_key(src), counts)
        carry = cms_retract(carry, vertex_key(dst), counts)
        return carry


def build_degree_sketch(
    src,
    dst,
    n_vertices: int,
    *,
    epsilon: float = 0.1,
    nu: float = 0.01,
    seed: int = 0,
    stream=None,
    chunk_size: int = 1 << 16,
    num_streams: int = 1,
    super_chunk: int | str = 8,
    device=None,
) -> CMSketch:
    """One streamed pass building the planner's degree sketch, on
    ``device`` (default the card) or the stream's.

    Width scales with √|V| on top of the paper's w = ⌈e/ε⌉, so collision
    error stays sub-linear in the vertex count.
    """
    dev = stream.device if stream is not None else resolve_device(device)
    w, d = suggest_params(epsilon, nu)
    width = w * max(1, int(math.sqrt(max(int(n_vertices), 1))))
    stream = as_stream(src, dst, stream=stream, chunk_size=chunk_size, device=dev)
    carry = DegreeSketchCarry(width, d, seed=seed, device=dev)
    _, sketch = run_parallel(
        stream, carry, num_streams=num_streams, super_chunk=super_chunk)
    return sketch


def plan_budget(
    src,
    dst,
    n_vertices: int,
    budget_bytes: int | None,
    *,
    stream=None,
    epsilon: float = 0.1,
    nu: float = 0.01,
    seed: int = 0,
    chunk_size: int = 1 << 16,
    num_streams: int = 1,
    super_chunk: int | str = 8,
    max_sample: int = 1 << 16,
    safety: float = 0.9,
    device=None,
) -> BudgetPlan:
    """Choose ξ* (and the refinement ladder) for a byte budget.

    ``budget_bytes`` of ``None`` or ≤ 0 gives the pure-streaming plan (no
    resident core, empty ladder, no sketch built); a budget covering the
    whole edge list gives the fully in-memory plan (ξ* = 0).  In between,
    ξ* is the smallest candidate threshold whose sketch-estimated core
    fits ``budget_bytes × safety``.  ``src``/``dst`` are arrays or
    tensors (the sample is drawn on the host); the sketch runs on
    ``device`` (default the card) or the stream's.
    """
    src, dst = (np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x, np.int32)
                for x in (src, dst))
    E = int(src.shape[0])
    budget = 0 if budget_bytes is None else max(int(budget_bytes), 0)

    def _plan(mode, xi_star, ladder, est_edges, sample_m, sketch_mem):
        return BudgetPlan(
            budget_bytes=budget, mode=mode, xi_star=int(xi_star),
            ladder=tuple(int(t) for t in ladder),
            est_core_edges=int(est_edges),
            est_core_bytes=int(est_edges) * CORE_EDGE_BYTES + PLAN_FIXED_BYTES,
            total_edges=E, sample_edges=int(sample_m),
            sketch_bytes=int(sketch_mem),
        )

    if budget <= 0 or E == 0:
        return _plan("streaming", _INT32_MAX, (), 0, 0, 0)

    dev = stream.device if stream is not None else resolve_device(device)
    sketch = build_degree_sketch(
        src, dst, n_vertices,
        epsilon=epsilon, nu=nu, seed=seed, stream=stream,
        chunk_size=chunk_size, num_streams=num_streams,
        super_chunk=super_chunk, device=dev)

    # deterministic stride sample of the edge list (arrival order)
    stride = max(1, E // max(1, int(max_sample)))
    idx = np.arange(0, E, stride, dtype=np.int64)
    s_src = src[idx]
    s_dst = dst[idx]
    deg_u = cms_query(sketch, vertex_key(torch.from_numpy(s_src).to(dev))).cpu().numpy()
    deg_v = cms_query(sketch, vertex_key(torch.from_numpy(s_dst).to(dev))).cpu().numpy()
    emin = np.minimum(deg_u, deg_v).astype(np.int64)
    emin[s_src == s_dst] = 0  # self-loops never join the core
    m = int(emin.size)

    # budget-independent candidate thresholds: min-degree quantiles at the
    # fixed core fractions (descending thresholds as fractions grow)
    emin_desc = np.sort(emin)[::-1]
    thresholds = []
    for f in CORE_FRACTIONS:
        if f >= 1.0:
            thresholds.append(0)  # whole graph: every valid edge is core
            continue
        pos = max(int(math.ceil(f * m)) - 1, 0)
        thresholds.append(int(emin_desc[pos]))

    # estimated resident cost at each threshold (one-sided over-estimate)
    affordable = budget * float(safety)
    chosen = -1
    est_at = []
    for t in thresholds:
        frac = float(np.mean(emin > t)) if t > 0 else 1.0
        est_edges = int(math.ceil(frac * E))
        est_at.append(est_edges)
        if est_edges * CORE_EDGE_BYTES + PLAN_FIXED_BYTES <= affordable:
            chosen = len(est_at) - 1

    # a budget that covers the whole edge list is in-memory outright
    if budget >= E * CORE_EDGE_BYTES + PLAN_FIXED_BYTES:
        chosen = len(thresholds) - 1

    if chosen < 0:
        return _plan("streaming", _INT32_MAX, (), 0, m, sketch.memory_bytes())

    # ladder: thresholds for every admitted fraction, deduped in order, a
    # prefix of any larger budget's ladder by construction
    ladder: list[int] = []
    for t in thresholds[: chosen + 1]:
        if not ladder or t < ladder[-1]:
            ladder.append(t)
    xi_star = ladder[-1]
    mode = "in_memory" if xi_star == 0 else "hybrid"
    return _plan(mode, xi_star, ladder, est_at[chosen], m, sketch.memory_bytes())
