"""``run_hybrid``: one budget-bounded pass, resident core + streamed tail
(the port of ``repro.hybrid.driver``).

Control flow (every pass replays the same EdgeStream):

1. **baseline**: the pure-streaming S5P pipeline runs first (K1, K2,
   K4a/K4b and the game's K5 on the card); its parts, c2p and load are
   the incumbent.  A zero budget returns exactly this, bit for bit
   :func:`~repro_torch.core.s5p.s5p_partition`.
2. **plan**: :func:`~repro_torch.hybrid.planner.plan_budget` picks ξ* and
   the refinement ladder from a CMS degree sketch.
3. **spill**: core edges (min endpoint degree > ξ*) spill to a resident
   host :class:`~repro_torch.hybrid.refiner.CoreBuffer`, every chunk's
   records charged against a hard-capped
   :class:`~repro_torch.streaming.HostBudget`; a
   :class:`~repro_torch.streaming.BudgetExceededError` retreats ξ* one
   ladder level up and spills again.
4. **refine**: for each ladder level ℓ (descending) the masked game frees
   the clusters level-ℓ core edges touch; the candidate is scored by
   composing the placement (core records placed first, then the tail
   streamed through :class:`~repro_torch.hybrid.refiner.TailAssignCarry`
   seeded with the core's load) and kept iff its RF strictly improves.
5. **bundle**: the winner packs into a standard warm bundle
   (:func:`~repro_torch.incremental.pack_warm_bundle`), so deltas,
   deletions, resharding and serving consume it like a cold run's.

Host numpy where the reference holds numpy (the records, the ladder, the
bundle, the spill's bookkeeping); tensors on the run's device where it
holds JAX arrays.  Loads that seed or keep a placement are never aliased:
a rejected level cannot write the incumbent's load.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from ..core import game as _game
from ..core.metrics import load_balance, replication_factor
from ..core.s5p import S5PConfig, s5p_partition
from ..incremental.pipeline import IncrementalResult, pack_warm_bundle, s5p_apply_delta
from ..streaming import BudgetExceededError, HostBudget, as_stream, run_parallel
from .planner import PLAN_FIXED_BYTES, BudgetPlan, plan_budget
from .refiner import CoreBuffer, TailAssignCarry, core_move_mask, place_core, refine_core_game

__all__ = ["HybridResult", "HybridServingChain", "run_hybrid"]


class HybridResult(NamedTuple):
    """What one hybrid run produced (and what pure streaming would have)."""

    parts: np.ndarray          # (E,) int32, arrival order
    k: int
    mode: str                  # plan mode after spill retries
    plan: BudgetPlan
    xi_star: int               # effective core threshold after retries
    rf: float
    balance: float
    rf_streaming: float        # the pure-streaming incumbent's quality
    balance_streaming: float
    accepted_levels: tuple[int, ...]  # ladder levels that improved RF
    game_rounds: int           # masked-game rounds spent refining
    core_edges: int            # resident records actually spilled
    peak_budget_bytes: int     # HostBudget high-water mark (≤ budget)
    budget_bytes: int          # the requested cap
    bundle: dict               # standard warm bundle (pack_warm_bundle)
    timings: dict[str, float]  # seconds: streaming (pass 0), plan, spill, refine


def _materialize(stream_or_edges):
    """(src, dst, n, stream) from an EdgeStream, a sharded stream or a
    ``(src, dst, n)`` triple; src/dst as host int32."""
    s = stream_or_edges
    if isinstance(s, tuple):
        src, dst, n = s
        return _host(src), _host(dst), int(n), None
    if hasattr(s, "arrival_arrays"):  # ShardedEdgeStream pages from disk
        src, dst = s.arrival_arrays()
    else:
        src, dst = s.src, s.dst
    return _host(src), _host(dst), int(s.n_vertices), s


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, np.int32)


def _spill_core(src, dst, degrees, v2c_h, v2c_t, xi: int, threshold: int,
                budget: HostBudget, chunk_size: int) -> tuple[CoreBuffer, int]:
    """One bounded pass collecting core records, charging as it goes.

    Returns ``(core, charged_bytes)``; on :class:`BudgetExceededError`
    everything charged so far is released before re-raising, so the
    caller can retreat to a stricter threshold with clean accounting.
    """
    E = int(src.shape[0])
    cols: list[CoreBuffer] = []
    charged = 0
    try:
        for start in range(0, E, max(int(chunk_size), 1)):
            sl = slice(start, start + chunk_size)
            s, d = src[sl], dst[sl]
            du, dv = degrees[s], degrees[d]
            dmin = np.minimum(du, dv).astype(np.int32)
            m = (dmin > threshold) & (s != d)
            if not m.any():
                continue
            is_head = (du > xi) & (dv > xi)
            cu = np.where(is_head, v2c_h[s], v2c_t[s]).astype(np.int32)
            cv = np.where(is_head, v2c_h[d], v2c_t[d]).astype(np.int32)
            rec = CoreBuffer(
                src=s[m], dst=d[m],
                arrival=(start + np.nonzero(m)[0]).astype(np.int64),
                cu=cu[m], cv=cv[m], deg_min=dmin[m], head=is_head[m])
            budget.charge(rec.nbytes())
            charged += rec.nbytes()
            cols.append(rec)
    except BudgetExceededError:
        budget.release(charged)
        raise
    if not cols:
        empty = CoreBuffer(*(np.zeros(0, dt) for dt in
                             (np.int32, np.int32, np.int64, np.int32,
                              np.int32, np.int32, bool)))
        return empty, charged
    return CoreBuffer(*(np.concatenate(f) for f in zip(*cols))), charged


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_hybrid(stream, config: S5PConfig, *, host_budget: int | None = None,
               device=None) -> HybridResult:
    """Partition under a host-memory budget: resident skew core + tail.

    ``stream`` is an :class:`~repro_torch.streaming.EdgeStream` (the
    out-of-core :class:`~repro_torch.streaming.ShardedEdgeStream`
    included), whose device the run takes, or an ``(src, dst,
    n_vertices)`` triple, run on ``device`` (default the card).
    ``host_budget`` (bytes) overrides ``config.host_budget``; 0/None is
    pure streaming, a budget covering the whole edge list fully
    in-memory.
    """
    src, dst, n_vertices, es = _materialize(stream)
    dev = es.device if es is not None else resolve_device(device)
    budget = host_budget if host_budget is not None else config.host_budget
    budget = 0 if budget is None else max(int(budget), 0)
    k = config.k
    timings: dict[str, float] = {}
    src_t = torch.from_numpy(src).to(dev)
    dst_t = torch.from_numpy(dst).to(dev)

    def _rf_bal(parts: np.ndarray) -> tuple[float, float]:
        p = torch.from_numpy(parts).to(dev)
        return (replication_factor(src_t, dst_t, p, n_vertices=n_vertices, k=k),
                load_balance(p, k=k))

    # ---- pass 0: the pure-streaming incumbent (bit-identical to s5p) ----
    t0 = time.perf_counter()
    base = s5p_partition(src, dst, n_vertices, config, stream=es, device=dev)
    internals = base.aux.get("incremental")
    if internals is None:
        raise ValueError("hybrid run produced no pipeline state "
                         "(no valid edges)")
    res = internals["compact"]
    degrees_np = internals["degrees"].cpu().numpy().astype(np.int32)
    v2c_h = res.v2c_h.cpu().numpy().astype(np.int32)
    v2c_t = res.v2c_t.cpu().numpy().astype(np.int32)
    C = int(res.n_clusters)

    parts_best = base.parts.cpu().numpy().astype(np.int32)
    c2p_best = np.asarray(base.cluster_assignment, np.int32)
    load_best = internals["load"]
    rf_streaming, bal_streaming = _rf_bal(parts_best)
    rf_best, bal_best = rf_streaming, bal_streaming
    timings["streaming"] = time.perf_counter() - t0

    # ---- plan: size the resident core for the budget ----
    t0 = time.perf_counter()
    plan = plan_budget(
        src, dst, n_vertices, budget, stream=es,
        epsilon=config.cms_epsilon, nu=config.cms_nu, seed=config.seed,
        chunk_size=config.chunk_size, num_streams=config.num_streams,
        super_chunk=config.super_chunk, device=dev)
    timings["plan"] = time.perf_counter() - t0

    acct = HostBudget(limit_bytes=budget if budget > 0 else None)

    def _result(mode, xi_star, accepted, rounds, core_edges, charged):
        bundle = pack_warm_bundle(
            src, dst, n_vertices, config,
            state=internals["cluster_state"], res=res,
            degrees=internals["degrees"], sizes=internals["sizes"],
            pair_a=internals["pair_a"], pair_b=internals["pair_b"],
            pair_w=internals["pair_w"], c2p=c2p_best,
            parts=torch.from_numpy(parts_best).to(dev),
            load=load_best, xi=base.xi, kappa=base.kappa,
            sketch=base.aux.get("sketch"))
        acct.release(charged)  # resident records die with this frame
        return HybridResult(
            parts=parts_best, k=k, mode=mode, plan=plan,
            xi_star=int(xi_star), rf=float(rf_best), balance=float(bal_best),
            rf_streaming=float(rf_streaming),
            balance_streaming=float(bal_streaming),
            accepted_levels=tuple(accepted), game_rounds=int(rounds),
            core_edges=int(core_edges),
            peak_budget_bytes=int(acct.peak_bytes), budget_bytes=budget,
            bundle=bundle, timings=timings)

    if not plan.resident or C == 0:
        return _result("streaming", plan.xi_star, (), 0, 0, 0)

    # ---- spill the core, retreating up the ladder on a hard-cap hit ----
    t0 = time.perf_counter()
    ladder = list(plan.ladder)
    core = None
    charged = 0
    acct.charge(PLAN_FIXED_BYTES)
    charged += PLAN_FIXED_BYTES
    while ladder:
        try:
            core, spilled = _spill_core(
                src, dst, degrees_np, v2c_h, v2c_t, base.xi, ladder[-1],
                acct, config.chunk_size)
            charged += spilled
            break
        except BudgetExceededError:
            ladder.pop()  # strictly fewer resident edges next try
            core = None
    timings["spill"] = time.perf_counter() - t0
    if core is None or core.n_edges == 0:
        return _result("streaming", plan.xi_star, (), 0, 0, charged)
    xi_star = ladder[-1]
    mode = "in_memory" if xi_star == 0 else "hybrid"

    # ---- refinement ladder: masked game + composed re-scoring ----
    t0 = time.perf_counter()
    comb_is_head = (np.ones(C, bool) if config.one_stage
                    else np.arange(C) < res.n_head)
    inputs = _game.GameInputs(
        sizes=internals["sizes"].to(torch.float32),
        pair_a=internals["pair_a"], pair_b=internals["pair_b"],
        pair_w=internals["pair_w"].to(torch.float32),
        n_head=res.n_head, k=k)
    accepted: list[int] = []
    rounds = 0
    for i, level in enumerate(ladder):
        sub = core.select(np.asarray(core.deg_min) > level)
        if sub.n_edges == 0:
            continue
        move_mask = core_move_mask(sub, C)
        if not move_mask.any():
            continue
        game = refine_core_game(
            inputs, C, c2p_best,
            leader_mask=comb_is_head, move_mask=move_mask,
            rounds=config.refine_rounds or config.game_max_rounds,
            accept_prob=config.game_accept_prob,
            seed=config.seed + 101 + i,
            batch_size=config.game_batch_size)
        rounds += int(game.rounds)
        c2p_cand = game.assignment.cpu().numpy().astype(np.int32)
        # composed placement: core resident first, tail streamed after,
        # both against one shared capacity L.  core_load is this level's
        # own tensor: the tail may fold into it in place (S = 1).
        core_parts, core_load = place_core(
            sub, c2p_cand, k, base.max_load, n_vertices,
            chunk_size=config.chunk_size, device=dev)
        tail = TailAssignCarry(
            k, base.max_load, torch.from_numpy(c2p_cand).to(dev),
            degrees=internals["degrees"], v2c_h=res.v2c_h, v2c_t=res.v2c_t,
            xi=base.xi, core_threshold=level)
        tail_stream = as_stream(src, dst, stream=es,
                                chunk_size=config.chunk_size, device=dev)
        tail_parts, tail_load = run_parallel(
            tail_stream, tail, num_streams=config.num_streams,
            super_chunk=config.super_chunk, carry=core_load)
        parts_cand = tail_parts.cpu().numpy().astype(np.int32)
        parts_cand[sub.arrival] = core_parts
        rf_cand, bal_cand = _rf_bal(parts_cand)
        if rf_cand < rf_best - 1e-12:
            rf_best, bal_best = rf_cand, bal_cand
            parts_best, c2p_best, load_best = parts_cand, c2p_cand, tail_load
            accepted.append(int(level))
    _sync(dev)
    timings["refine"] = time.perf_counter() - t0

    return _result(mode, xi_star, accepted, rounds, core.n_edges, charged)


class _HybridStep(NamedTuple):
    """The first serving step of a hybrid chain (duck-typed record)."""

    rf: float
    balance: float
    refined: bool = False
    filling: bool = False


class HybridServingChain:
    """Serve a hybrid bundle through the standard ServingController.

    Duck-typed like :class:`~repro_torch.incremental.S5PWindowChain`: the
    first ``step()`` publishes the hybrid partition itself (origin
    ``"cold"``); each later step absorbs one queued insertion batch
    through :func:`~repro_torch.incremental.s5p_apply_delta` on
    ``device`` (default the card), which the published bundles follow.
    """

    def __init__(self, result: HybridResult, config: S5PConfig, src, dst,
                 n_vertices: int, deltas=(), *, device=None):
        self.device = resolve_device(device)
        self.bundle: dict | None = dict(result.bundle)
        self.config = config
        self.n_vertices = int(n_vertices)
        self._full_src = _host(src)
        self._full_dst = _host(dst)
        self._first = _HybridStep(rf=result.rf, balance=result.balance)
        self._emitted = False
        self._deltas = list(deltas)

    @property
    def lo(self) -> int:
        return 0

    @property
    def hi(self) -> int:
        return int(self.bundle["stream_pos"])

    def live_partition(self):
        b = self.bundle
        arrival = np.asarray(b["arrival"], np.int64)
        alive = np.asarray(b["alive"], bool)
        return (self._full_src[arrival[alive]],
                self._full_dst[arrival[alive]],
                np.asarray(b["parts"], np.int32)[alive])

    def step(self) -> "_HybridStep | IncrementalResult | None":
        if not self._emitted:
            self._emitted = True
            return self._first
        if not self._deltas:
            return None
        dsrc, ddst = self._deltas.pop(0)
        pos = int(self.bundle["stream_pos"])
        self._full_src = np.concatenate([self._full_src, _host(dsrc)])
        self._full_dst = np.concatenate([self._full_dst, _host(ddst)])
        self.n_vertices = max(
            self.n_vertices,
            int(max(self._full_src.max(), self._full_dst.max())) + 1)
        self.bundle, rec = s5p_apply_delta(
            self.bundle, self.config, self._full_src, self._full_dst, pos,
            device=self.device)
        return rec
