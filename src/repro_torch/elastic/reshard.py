"""Bounded-migration k→k′ resharding of S5P bundles and scan carries.

The port of ``repro.elastic.reshard``.  :func:`reshard_bundle` re-settles
only the cluster→partition game under a migration-cost payoff (no stream
replay), then re-places only the edges whose placement died:

- **grow** (k′ > k): every placement survives; the game decides which
  clusters are worth relocating onto the new empty partitions, each
  paying ``move_cost ∝ |c_i|`` to leave home;
- **shrink** (k′ < k): edges on partitions ≥ k′ are displaced and must
  move (their clusters re-home with no penalty: ``home = -1``); surviving
  clusters relocate only where the gain at k′ beats their migration cost.

Everything k-independent (Alg. 1 state, degrees, Θ, the CMS, the per-edge
tags, the slot/arrival coordinates) carries over untouched.

The bookkeeping is the reference's host numpy, statement for statement;
the game runs on the device (``core.game.run_game``, its sums on K5) and
the affected edges are placed again through
:class:`~repro_torch.core.postprocess.AssignCarry` (K2), from the kept
edges' loads.  :func:`reshard_scan_carry` retracts a Greedy/HDRF carry's
displaced edges on K3 (``sign = -1``) while it still has k columns,
slices or pads the columns and scans the displaced edges again at k′ (K3).
:func:`~repro_torch.incremental.pipeline.last_games` reports a bundle
reshard's game and its seconds.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from ..core import game as _game
from ..core.postprocess import AssignCarry
from ..core.s5p import S5PConfig
from ..incremental import pipeline as _pipe
from ..incremental.pipeline import (
    _INT32_MAX,
    _dev,
    _game_inputs,
    _invalidate_journal,
    _least_loaded_fill,
    _metrics,
    _np,
    ensure_slot_index,
)
from ..streaming import EdgeStream, run_carry, run_retract

__all__ = ["ReshardResult", "reshard_bundle", "reshard_scan_carry",
           "reshard_carry"]


class ReshardResult(NamedTuple):
    """What a resize cost and what it bought."""

    k_old: int
    k_new: int
    rf: float  # replication factor at k_new
    balance: float  # load balance at k_new
    n_live: int  # live placed edges at reshard time
    migrated_edges: int  # live edges whose partition changed
    n_displaced: int  # live edges whose old partition no longer exists
    moved_clusters: int  # clusters the game relocated
    game_rounds: int

    @property
    def migrated_fraction(self) -> float:
        return self.migrated_edges / max(self.n_live, 1)


def _noop_result(k: int, rf: float, bal: float, n_live: int) -> ReshardResult:
    return ReshardResult(k_old=k, k_new=k, rf=rf, balance=bal,
                         n_live=n_live, migrated_edges=0, n_displaced=0,
                         moved_clusters=0, game_rounds=0)


def reshard_bundle(bundle: dict, config: S5PConfig, k_new: int,
                   full_src, full_dst, *, move_cost_scale: float = 1.0,
                   device=None) -> tuple[dict, S5PConfig, ReshardResult]:
    """Map an S5P warm bundle onto ``k_new`` partitions, migrating as few
    edges as the balance constraint allows (on ``device``, default the card).

    ``full_src``/``full_dst`` are the arrival-indexed stream prefix the
    bundle is keyed on; only its slots are gathered.  ``move_cost_scale``
    scales the per-cluster penalty ``|c_i| / k′``: 0 re-settles freely,
    large values freeze every survivor.  Returns ``(bundle,
    config_at_k_new, result)``; the input bundle is not modified.
    """
    dev = resolve_device(device)
    _pipe._new_game_log()
    k_old = int(config.k)
    if k_new < 1:
        raise ValueError(f"k_new must be >= 1, got {k_new}")
    b = ensure_slot_index(dict(bundle))
    new_config = dataclasses.replace(config, k=int(k_new))

    arrival = np.asarray(b["arrival"], np.int64)
    full_src = _np(full_src, np.int32)
    full_dst = _np(full_dst, np.int32)
    slot_src = full_src[arrival]
    slot_dst = full_dst[arrival]
    old_parts = np.asarray(b["parts"], np.int32)
    alive = np.asarray(b["alive"], bool)
    placed = alive & (old_parts >= 0)
    n_live = int(np.count_nonzero(placed))

    if k_new == k_old:
        return b, new_config, _noop_result(
            k_old, float(b["rf_baseline"]), float(b["balance_baseline"]),
            n_live)

    sizes = np.asarray(b["sizes"], np.float32)
    comb_is_head = np.asarray(b["comb_is_head"], bool)
    C = int(sizes.shape[0])
    old_c2p = np.asarray(b["c2p"], np.int32)

    # ---- seat the displaced clusters, keep everyone else home --------
    displaced_c = old_c2p >= k_new  # never true on grow
    c2p0 = old_c2p.copy()
    c2p0[displaced_c] = -1
    disp_ids = np.nonzero(displaced_c)[0]
    # big clusters first: successive least-loaded seating packs better
    disp_ids = disp_ids[np.argsort(-sizes[disp_ids], kind="stable")]
    c2p0 = _least_loaded_fill(sizes, c2p0, disp_ids, int(k_new))

    # ---- the migration-cost Stackelberg game (float32, as NEP 50 does) --
    home = np.where(displaced_c, -1, old_c2p).astype(np.int32)
    move_cost = np.where(
        displaced_c, 0.0,
        float(move_cost_scale) * sizes / float(k_new)).astype(np.float32)
    move_mask = sizes > 0
    game_rounds = 0
    if np.any(move_mask):
        inputs = _game_inputs(sizes, np.asarray(b["pair_a"], np.int32),
                              np.asarray(b["pair_b"], np.int32),
                              np.asarray(b["pair_w"], np.float32), int(k_new), dev)
        bs = _game.default_batch_size(config.game_batch_size, C)
        res = _pipe._play(
            "reshard", inputs, C, batch_size=bs, max_rounds=config.game_max_rounds,
            accept_prob=config.game_accept_prob, assign0=c2p0,
            seed=config.seed + 2, leader_mask=comb_is_head,
            move_mask=move_mask, move_cost=move_cost, home=home)
        c2p_new = _np(res.assignment, np.int32)
        game_rounds = int(res.rounds)
    else:
        c2p_new = c2p0
    moved_c = c2p_new != old_c2p
    # empty clusters ride along as metadata; seat them in range so later
    # deltas that revive them place against a valid map
    oob = c2p_new >= k_new
    if np.any(oob):
        c2p_new = np.where(oob, c2p_new % k_new, c2p_new).astype(np.int32)

    # ---- bounded migration: keep survivors, re-place the rest (K2) ----
    edge_cu = np.asarray(b["edge_cu"], np.int32)
    edge_cv = np.asarray(b["edge_cv"], np.int32)
    edge_head = np.asarray(b["edge_head"], bool)
    affected = placed & (
        (old_parts >= k_new)
        | ((edge_cu >= 0) & moved_c[np.maximum(edge_cu, 0)])
        | ((edge_cv >= 0) & moved_c[np.maximum(edge_cv, 0)]))
    kept = placed & ~affected
    load64 = np.zeros(int(k_new), np.int64)
    np.add.at(load64, old_parts[kept], 1)
    max_load = (_INT32_MAX if config.bounded
                else int(math.ceil(config.tau * max(n_live, 1) / k_new)))
    parts = old_parts.copy()
    aidx = np.nonzero(affected)[0]
    n_vertices = int(np.asarray(b["degrees"]).shape[0])
    if aidx.size:
        re_stream = EdgeStream(slot_src[aidx], slot_dst[aidx], n_vertices,
                               chunk_size=config.chunk_size, device=dev)
        ac = AssignCarry(int(k_new), max_load, _dev(c2p_new, dev))
        re_parts, load = run_carry(
            re_stream, ac, edge_head[aidx], np.maximum(edge_cu[aidx], 0),
            np.maximum(edge_cv[aidx], 0),
            carry=_dev(load64.astype(np.int32), dev))
        parts[aidx] = _np(re_parts, np.int32)
        load = _np(load, np.int32)
    else:
        load = load64.astype(np.int32)

    rf, bal = _metrics(slot_src, slot_dst, parts, n_vertices, int(k_new), dev)
    migrated = int(np.count_nonzero(placed & (parts != old_parts)))
    n_displaced = int(np.count_nonzero(placed & (old_parts >= k_new)))

    b["c2p"] = c2p_new
    b["load"] = load
    b["parts"] = parts
    b["touched"] = np.zeros(C, bool)
    b["rf_baseline"] = np.float64(rf)
    b["balance_baseline"] = np.float64(bal)
    # κ is k-dependent (≈ 2E/k′ unbounded): the k-era value would trip
    # needs_cold_restart on the very next delta
    if not config.bounded:
        b["kappa"] = np.int32(
            min(max(int(math.ceil(2.0 * n_live / k_new)), 2), _INT32_MAX))
    # the journal snapshots k-era c2p/load: a rollback across a resize
    # would resurrect out-of-range partitions
    _invalidate_journal(b)

    result = ReshardResult(
        k_old=k_old, k_new=int(k_new), rf=rf, balance=bal, n_live=n_live,
        migrated_edges=migrated, n_displaced=n_displaced,
        moved_clusters=int(np.count_nonzero(moved_c & (sizes > 0))),
        game_rounds=game_rounds)
    return b, new_config, result


# ---------------------------------------------------------------------------
# scan carries (greedy / HDRF)
# ---------------------------------------------------------------------------


def _resize_cols(x: torch.Tensor, k_new: int) -> torch.Tensor:
    """Pad (grow) or slice (shrink) the trailing k axis with zeros."""
    k_old = x.shape[-1]
    if k_new <= k_old:
        return x[..., :k_new].contiguous()
    pad = x.new_zeros(tuple(x.shape[:-1]) + (k_new - k_old,))
    return torch.cat([x, pad], dim=-1)


def reshard_scan_carry(pc, carry, k_new: int, src, dst, parts, *,
                       chunk_size: int = 1 << 16,
                       ) -> tuple[object, np.ndarray, ReshardResult]:
    """Reshard a Greedy/HDRF carry (and its recorded parts) onto k′.

    ``pc`` is the **k′-dimensioned** consumer (``GreedyCarry(V, k′)`` /
    ``HdrfCarry(V, k′)``), on the carry's device; ``carry`` its k-era state
    (not modified); ``src``/``dst``/``parts`` the edges it accounts for.
    Grow pads the k columns with zeros (no placement changes); shrink
    retracts the displaced edges (K3, ``sign = -1``) while the carry still
    has k columns, slices the columns and scans only the displaced edges
    at k′ (K3).  Grid carries hash into a fixed k grid and raise.
    """
    from ..kernels.stream_scan import ops as _ops
    from ..kernels.stream_scan import ref as _ref

    if isinstance(pc, _ops.GridCarry):
        raise ValueError(
            "grid carries hash vertices into a fixed k grid; a resize "
            "re-hashes every edge — use a cold re-partition")
    if not isinstance(pc, (_ops.GreedyCarry, _ops.HdrfCarry)):
        raise ValueError(f"cannot reshard carry for {type(pc).__name__}")

    src = _np(src, np.int32)
    dst = _np(dst, np.int32)
    parts = _np(parts, np.int32)
    dev = carry[0].device
    k_old = int(carry[0].shape[0])
    k_new = int(k_new)
    n_live = int(np.count_nonzero(parts >= 0))
    n_vertices = pc.n_vertices

    if k_new == k_old:
        rf, bal = _metrics(src, dst, parts, n_vertices, k_old, dev)
        return carry, parts, _noop_result(k_old, rf, bal, n_live)

    displaced = parts >= k_new  # empty on grow
    didx = np.nonzero(displaced)[0]
    # the kernels update in place: work on a copy, as the reference's
    # carries are values
    work = tuple(x.clone() for x in carry)
    if didx.size:
        # subtract the dead partitions' accounting while the carry is
        # still k-dimensioned: COUNTED/SUM fields retract exactly
        del_stream = EdgeStream(src[didx], dst[didx], n_vertices,
                                chunk_size=chunk_size, device=dev)
        work = run_retract(del_stream, pc, parts[didx], carry=work)

    load = _resize_cols(work[0], k_new)
    rep = _resize_cols(work[1], k_new)
    if isinstance(pc, _ops.HdrfCarry):
        fresh = _ref.hdrf_init(n_vertices, k_new, float(work[3]), device=dev)
        work = (load, rep, work[2], work[3], fresh[4])
    else:
        work = (load, rep)

    new_parts = parts.copy()
    if didx.size:
        re_stream = EdgeStream(src[didx], dst[didx], n_vertices,
                               chunk_size=chunk_size, device=dev)
        re_parts, work = run_carry(re_stream, pc, carry=work)
        new_parts[didx] = _np(re_parts, np.int32)

    rf, bal = _metrics(src, dst, new_parts, n_vertices, k_new, dev)
    migrated = int(np.count_nonzero((parts >= 0) & (new_parts != parts)))
    return work, new_parts, ReshardResult(
        k_old=k_old, k_new=k_new, rf=rf, balance=bal, n_live=n_live,
        migrated_edges=migrated, n_displaced=int(didx.size),
        moved_clusters=0, game_rounds=0)


def reshard_carry(state, k_new: int, *args, **kwargs):
    """Dispatch: an S5P bundle dict → :func:`reshard_bundle` (pass
    ``config, full_src, full_dst``); a scan consumer →
    :func:`reshard_scan_carry` (pass ``src, dst, parts`` and ``carry=``)."""
    if isinstance(state, dict) and "c2p" in state:
        config = args[0] if args else kwargs.pop("config")
        rest = args[1:] if args else ()
        return reshard_bundle(state, config, k_new, *rest, **kwargs)
    return reshard_scan_carry(state, kwargs.pop("carry"), k_new,
                              *args, **kwargs)
