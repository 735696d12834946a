"""Warm-start S5P: the whole pipeline as an incrementally maintained bundle.

The port of ``repro.incremental.pipeline``.  A cold run's internals
(``S5POutput.aux["incremental"]``) are packed into a flat **carry bundle**,
a dict of host numpy arrays with the reference's keys and dtypes (the form
a :class:`~repro_torch.incremental.store.CarryStore` checkpoints, so the
two packages read each other's bundles):

======================  =====================================================
``degrees``             global degree table (SUM: exactly incremental)
``v2c_h/v2c_t/...``     the raw Algorithm-1 :class:`ClusterState`
``raw2comb_h/_t``       raw → stable combined cluster ids (new clusters
                        append, so pair list, c2p and edge tags stay valid)
``comb_is_head``        leader set per combined id (the masked game's
                        ``leader_mask``)
``sizes/pair_*``        cluster sizes + Θ adjacency in combined ids
``theta_table/seeds``   the CMS, ``uint32`` as the reference writes it
``c2p/load/parts``      game assignment, Alg.-3 load vector, per-edge parts
``edge_cu/cv/alt/head`` per-edge cluster tags: what lets refinement and
                        deletion address an edge without a stream replay
``touched``             clusters touched since the last refinement
``arrival/stream_pos``  slot → global arrival index; edges ingested
``prev__*``             the journal a last-batch deletion rolls back to
======================  =====================================================

Each pass moves what it needs to the device and runs there: the Alg.-1
replay of a delta through :class:`~repro_torch.core.clustering.ClusterCarry`
(K1 on the card), Θ updates and retractions through ``cms_update`` /
``cms_retract`` (K4a, negative counts for a retraction) and ``cms_query``
(K4b), the settle and refine games through ``run_game`` (its sums on K5),
and Alg.-3 placement through :class:`~repro_torch.core.postprocess.
AssignCarry` (K2).  RF and balance run on the device too.  The rest is
the reference's host numpy, statement for statement: the id bookkeeping,
the per-edge tags, the journal, and the cluster sizes, summed in float64
and cast to float32 as the reference does.

Exact vs approximate, rollback and compaction are the reference's: see
``repro.incremental.pipeline`` (and :mod:`repro_torch.incremental`).
"""

from __future__ import annotations

import math
import time
from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from ..core import clustering as _cl
from ..core import game as _game
from ..core.cms import CMSketch, cms_query, cms_retract, cms_update, pair_key, suggest_params
from ..core.metrics import load_balance, replication_factor
from ..core.postprocess import AssignCarry
from ..core.s5p import S5PConfig, S5POutput, s5p_partition
from ..streaming import EdgeStream, run_carry
from .delta import DeltaStream, grow_carry, run_incremental_carry
from .drift import DriftMonitor

__all__ = ["IncrementalResult", "s5p_identity_config", "s5p_cold_bundle",
           "pack_warm_bundle",
           "s5p_apply_delta", "s5p_apply_deletion", "compact_bundle",
           "compact_edge_slots", "ensure_slot_index", "s5p_cold_restart",
           "theta_delta_pairs", "last_games", "JOURNAL_PREFIX"]

_INT32_MAX = 2**31 - 1
_LAST_GAMES: list[dict] = []


def last_games() -> list[dict]:
    """The games the last delta, deletion or reshard played, in order: each
    one's kind (``settle``, ``refine`` or ``reshard``), batch size, leader
    and move masks, seconds (``run_game`` alone: every round ends in a host
    read), and its ``GameResult`` report (rounds, hub batches, ordered
    sums, size guard)."""
    return list(_LAST_GAMES)


def _new_game_log() -> None:
    """Start :func:`last_games`'s list for a new delta, deletion or reshard."""
    _LAST_GAMES.clear()


def _play(kind: str, inputs, C: int, **kw):
    """``run_game`` on the bundle's cluster graph, its report and seconds
    kept for :func:`last_games`."""
    t0 = time.perf_counter()
    res = _game.run_game(inputs, C, **kw)
    seconds = time.perf_counter() - t0
    _LAST_GAMES.append({"game": kind, "n_clusters": int(C), "batch_size": kw["batch_size"],
                        "leader_mask": kw["leader_mask"], "move_mask": kw["move_mask"],
                        "seconds": seconds,
                        **{f: getattr(res, f) for f in res._fields if f != "assignment"}})
    return res


class IncrementalResult(NamedTuple):
    """What one delta application did (and what it would have cost cold)."""

    # (stream_pos,) int32, arrival-indexed — full assignment after the
    # delta; deleted edges (tombstoned or slot-compacted away) are −1
    parts: np.ndarray
    rf: float
    balance: float
    refined: bool
    rf_drift: float
    balance_drift: float
    edges_replayed: int  # consumer-fold records processed by the warm path
    full_replay_cost: int  # the cold re-run's fold count (4 passes × E)
    game_rounds: int  # settlement + refinement rounds spent
    n_new_clusters: int
    n_delta_edges: int
    n_retracted: int = 0  # edges deleted/expired by this application
    churn: float = 0.0  # cumulative retraction fraction at the drift check
    needs_cold_restart: bool = False  # ξ/κ refresh policy (advisory)
    xi_drift: float = 0.0  # relative drift of the frozen ξ from live value
    kappa_drift: float = 0.0
    rolled_back: bool = False  # deletion was served by a version rollback

    @property
    def replay_fraction(self) -> float:
        return self.edges_replayed / max(self.full_replay_cost, 1)


def s5p_identity_config(config: S5PConfig) -> dict:
    """The config fields a carry must agree on to seed a warm start
    (execution knobs — chunking, lanes, game batching, drift thresholds —
    change how a replay runs, not what the state means)."""
    return {
        "k": config.k, "tau": config.tau, "beta": config.beta,
        "use_cms": config.use_cms, "cms_epsilon": config.cms_epsilon,
        "cms_nu": config.cms_nu, "bounded": config.bounded,
        "one_stage": config.one_stage, "seed": config.seed,
        "ordering": config.ordering,
    }


# ---------------------------------------------------------------------------
# host/device helpers
# ---------------------------------------------------------------------------


def _np(x, dtype=None) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x) if dtype is None else np.asarray(x, dtype)


def _dev(x: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, order="C")).to(dev)


def _metrics(src, dst, parts, n_vertices: int, k: int, dev) -> tuple[float, float]:
    """RF and balance on the device (the reference's float32 ratios)."""
    p = _dev(np.asarray(parts, np.int32), dev)
    rf = replication_factor(_dev(np.asarray(src, np.int32), dev),
                            _dev(np.asarray(dst, np.int32), dev), p,
                            n_vertices=n_vertices, k=k)
    return float(rf), float(load_balance(p, k=k))


def _sketch_to_dev(b: dict, dev) -> CMSketch:
    """The bundle's uint32 sketch as the port's (int32 bits, int64 seeds)."""
    return CMSketch(table=_dev(np.asarray(b["theta_table"], np.uint32).view(np.int32), dev),
                    seeds=_dev(np.asarray(b["theta_seeds"], np.uint32).astype(np.int64), dev))


def _sketch_to_host(b: dict, sketch: CMSketch) -> None:
    b["theta_table"] = _np(sketch.table).view(np.uint32)
    b["theta_seeds"] = _np(sketch.seeds).astype(np.uint32)


def _pair_keys(a: np.ndarray, b: np.ndarray, dev) -> torch.Tensor:
    return pair_key(_dev(a, dev), _dev(b, dev))


def _query(sketch: CMSketch, pa: np.ndarray, pb: np.ndarray) -> np.ndarray:
    dev = sketch.table.device
    return _np(cms_query(sketch, _pair_keys(pa, pb, dev))).astype(np.float32)


def _sum_at(n: int, idx: np.ndarray, w: float) -> np.ndarray:
    """``np.add.at(zeros(n), idx, w)`` in float64: every term a multiple of
    ½ far below 2^52, so the sum is exact in any order."""
    return np.bincount(idx, minlength=n).astype(np.float64)[:n] * w


# ---------------------------------------------------------------------------
# cold start → bundle
# ---------------------------------------------------------------------------


def _raw_to_comb(raw_table: np.ndarray, comb_table: np.ndarray,
                 n_raw: int) -> np.ndarray:
    """The raw→combined id map from the two per-vertex tables
    (``compact_clusters`` applies it consistently, so a scatter recovers it)."""
    out = np.full(max(n_raw, 1), -1, np.int32)
    mask = raw_table >= 0
    out[raw_table[mask]] = comb_table[mask]
    return out


def s5p_cold_bundle(src, dst, n_vertices: int, config: S5PConfig, *,
                    stream=None, device=None) -> tuple[S5POutput, dict]:
    """Run S5P cold (on ``device``, default the card) and pack the
    warm-start bundle from its internals."""
    out = s5p_partition(src, dst, n_vertices, config, stream=stream, device=device)
    internals = out.aux.get("incremental")
    if internals is None:  # degenerate no-valid-edge graphs skip the passes
        raise ValueError("cold run produced no pipeline state to carry "
                         "(no valid edges)")
    bundle = pack_warm_bundle(
        src, dst, n_vertices, config,
        state=internals["cluster_state"], res=internals["compact"],
        degrees=internals["degrees"], sizes=internals["sizes"],
        pair_a=internals["pair_a"], pair_b=internals["pair_b"],
        pair_w=internals["pair_w"], c2p=out.cluster_assignment,
        parts=out.parts, load=internals["load"], xi=out.xi,
        kappa=out.kappa, sketch=out.aux.get("sketch"))
    return out, bundle


def pack_warm_bundle(src, dst, n_vertices: int, config: S5PConfig, *,
                     state: _cl.ClusterState, res: _cl.ClusterResult,
                     degrees, sizes, pair_a, pair_b, pair_w, c2p, parts,
                     load, xi: int, kappa: int, sketch=None) -> dict:
    """Pack pipeline internals and a final (c2p, parts, load) into the flat
    warm-start bundle (host numpy).  RF and balance are computed on the
    device ``parts`` lies on."""
    dev = parts.device if isinstance(parts, torch.Tensor) else torch.device("cpu")
    src = _np(src, np.int32)
    dst = _np(dst, np.int32)
    degrees = _np(degrees, np.int32)

    v2c_h = _np(state.v2c_h)
    v2c_t = _np(state.v2c_t)
    raw2comb_h = _raw_to_comb(v2c_h, _np(res.v2c_h), int(state.next_h))
    raw2comb_t = _raw_to_comb(v2c_t, _np(res.v2c_t), int(state.next_t))
    C = res.n_clusters
    # one_stage makes every cluster a leader in the cold game; the warm
    # settle/refine games keep that semantics
    comb_is_head = (np.ones(C, bool) if config.one_stage
                    else np.arange(C) < res.n_head)

    parts = _np(parts, np.int32)
    is_head_e = (degrees[src] > xi) & (degrees[dst] > xi)
    comb_h = _np(res.v2c_h)
    comb_t = _np(res.v2c_t)
    e_cu = np.where(is_head_e, comb_h[src], comb_t[src]).astype(np.int32)
    e_cv = np.where(is_head_e, comb_h[dst], comb_t[dst]).astype(np.int32)
    # the other-table memberships of each endpoint (the cross-type Θ
    # channels), kept so a deletion retracts exactly the keys it added
    e_alt_u = np.where(is_head_e, comb_t[src], comb_h[src]).astype(np.int32)
    e_alt_v = np.where(is_head_e, comb_t[dst], comb_h[dst]).astype(np.int32)
    invalid = src == dst
    for arr in (e_cu, e_cv, e_alt_u, e_alt_v):
        arr[invalid] = -1

    rf, bal = _metrics(src, dst, parts, n_vertices, config.k, dev)

    bundle = {
        "degrees": degrees,
        "v2c_h": v2c_h.astype(np.int32),
        "v2c_t": v2c_t.astype(np.int32),
        "vol_h": _np(state.vol_h, np.int32),
        "vol_t": _np(state.vol_t, np.int32),
        "ld": _np(state.ld, np.int32),
        "next_h": np.int32(int(state.next_h)),
        "next_t": np.int32(int(state.next_t)),
        "cnt_h": _np(state.cnt_h, np.int32),
        "cnt_t": _np(state.cnt_t, np.int32),
        "alloc_h": _np(state.alloc_h, np.int32),
        "raw2comb_h": raw2comb_h,
        "raw2comb_t": raw2comb_t,
        "comb_is_head": comb_is_head,
        "sizes": _np(sizes, np.float32),
        "pair_a": _np(pair_a, np.int32),
        "pair_b": _np(pair_b, np.int32),
        "pair_w": _np(pair_w, np.float32),
        "c2p": _np(c2p, np.int32),
        "load": _np(load, np.int32),
        "parts": parts,
        "edge_cu": e_cu,
        "edge_cv": e_cv,
        "edge_alt_u": e_alt_u,
        "edge_alt_v": e_alt_v,
        "edge_head": np.asarray(is_head_e, bool),
        "alive": np.ones(parts.shape[0], bool),
        # per-edge arrays are indexed by slot; arrival[slot] is the global
        # arrival index it holds (the identity until slot compaction)
        "arrival": np.arange(parts.shape[0], dtype=np.int64),
        "stream_pos": np.int64(parts.shape[0]),
        "touched": np.zeros(C, bool),
        "retracted": np.int64(0),
        "journal_valid": np.bool_(False),
        "journal_pos": np.int64(-1),
        "journal_slots": np.int64(-1),
        "xi": np.int32(xi),
        "kappa": np.int32(kappa),
        "rf_baseline": np.float64(rf),
        "balance_baseline": np.float64(bal),
    }
    if sketch is not None:
        _sketch_to_host(bundle, sketch)
    return bundle


# ---------------------------------------------------------------------------
# delta application
# ---------------------------------------------------------------------------


def _comb_of(raw: np.ndarray, remap: np.ndarray) -> np.ndarray:
    return np.where(raw >= 0, remap[np.maximum(raw, 0)], -1).astype(np.int32)


def _scatter_parts(parts: np.ndarray, arrival: np.ndarray,
                   stream_pos: int) -> np.ndarray:
    """Slot-indexed parts → arrival-indexed (compacted arrivals are −1)."""
    full = np.full(int(stream_pos), -1, np.int32)
    full[arrival] = parts
    return full


_STATE_KEYS = ("v2c_h", "v2c_t", "vol_h", "vol_t", "ld", "next_h", "next_t",
               "cnt_h", "cnt_t", "alloc_h")


def _unpack_cluster_state(b: dict, dev) -> _cl.ClusterState:
    """The bundle's raw Algorithm-1 fields as a live ClusterState (fresh
    int32 tensors on ``dev``: K1 folds into them in place)."""
    return _cl.ClusterState(*[_dev(np.array(b[key], np.int32), dev)
                              for key in _STATE_KEYS])


def _pack_cluster_state(b: dict, state: _cl.ClusterState,
                        next_h: int, next_t: int) -> None:
    b.update({key: _np(getattr(state, key), np.int32) for key in _STATE_KEYS})
    b.update(next_h=np.int32(next_h), next_t=np.int32(next_t))


# ---------------------------------------------------------------------------
# bundle versioning (the journal a last-batch deletion rolls back to)
# ---------------------------------------------------------------------------

JOURNAL_PREFIX = "prev__"

#: the O(|V| + C + P + k) fields an insertion may mutate in place; the
#: per-edge arrays only ever append during an insertion, so the rollback
#: restores them by truncation
_JOURNALED = (
    "degrees", "v2c_h", "v2c_t", "vol_h", "vol_t", "ld", "next_h", "next_t",
    "cnt_h", "cnt_t", "alloc_h", "raw2comb_h", "raw2comb_t", "comb_is_head",
    "sizes", "pair_a", "pair_b", "pair_w", "c2p", "load", "touched",
    "theta_table", "theta_seeds", "rf_baseline", "balance_baseline",
    "retracted", "stream_pos",
)

_PER_EDGE = ("parts", "edge_cu", "edge_cv", "edge_alt_u", "edge_alt_v",
             "edge_head", "alive", "arrival")


def ensure_slot_index(b: dict) -> dict:
    """Synthesize the slot→arrival index for pre-compaction bundles (the
    identity; the stream position is the slot count).  Mutates and returns
    ``b``."""
    if "arrival" not in b:
        n_slots = int(np.asarray(b["parts"]).shape[0])
        b["arrival"] = np.arange(n_slots, dtype=np.int64)
        b["stream_pos"] = np.int64(n_slots)
        b["journal_slots"] = np.int64(b.get("journal_pos", -1))
    return b


def _write_journal(b: dict, stream_pos: int) -> None:
    """Snapshot the mutable small fields: the bundle's previous version."""
    for key in _JOURNALED:
        if key in b:
            b[JOURNAL_PREFIX + key] = np.copy(b[key])
    b["journal_pos"] = np.int64(stream_pos)
    b["journal_slots"] = np.int64(np.asarray(b["parts"]).shape[0])
    b["journal_valid"] = np.bool_(True)


def _invalidate_journal(b: dict) -> None:
    b["journal_valid"] = np.bool_(False)
    b["journal_slots"] = np.int64(-1)
    for key in _JOURNALED:
        b.pop(JOURNAL_PREFIX + key, None)


def _rollback(b: dict) -> None:
    """Restore the journaled version: small fields from their snapshots,
    per-edge arrays by truncation to the journaled slot count."""
    pos = int(b.get("journal_slots", b["journal_pos"]))
    for key in _JOURNALED:
        jkey = JOURNAL_PREFIX + key
        if jkey in b:
            b[key] = b.pop(jkey)
    for key in _PER_EDGE:
        b[key] = np.asarray(b[key])[:pos]
    b["journal_valid"] = np.bool_(False)
    b["journal_pos"] = np.int64(-1)
    b["journal_slots"] = np.int64(-1)


def _refresh_decision(b: dict, config: S5PConfig, degrees: np.ndarray,
                      e_live: int):
    """ξ/κ full-refresh policy: the frozen thresholds against what a cold
    run over the live graph would choose today (the cold run's
    denominators, isolated vertices included)."""
    n = int(degrees.shape[0])
    avg_deg = 2.0 * e_live / max(n, 1)
    xi_now = min(int(config.beta * avg_deg), _INT32_MAX - 1)
    kappa_now = (_INT32_MAX if config.bounded
                 else max(int(math.ceil(2.0 * e_live / config.k)), 2))
    return DriftMonitor.refresh_check(
        float(b["xi"]), float(b["kappa"]), float(xi_now), float(kappa_now),
        xi_refresh_threshold=config.xi_refresh_threshold)


def _least_loaded_fill(sizes, c2p, new_ids, k):
    """Initial partition of newly allocated clusters: successively the
    least loaded by size-weighted partition loads."""
    loads = np.zeros(k, np.float64)
    placed = c2p >= 0
    np.add.at(loads, c2p[placed], sizes[placed])
    for cid in new_ids:
        p = int(np.argmin(loads))
        c2p[cid] = p
        loads[p] += sizes[cid]
    return c2p


def _pair_union(pa, pb, da, db, n_comb):
    """Union of the stored structural pair list with the delta's pairs."""
    key_old = pa.astype(np.int64) * (n_comb + 1) + pb
    key_new = da.astype(np.int64) * (n_comb + 1) + db
    keys = np.unique(np.concatenate([key_old, key_new]))
    return ((keys // (n_comb + 1)).astype(np.int32),
            (keys % (n_comb + 1)).astype(np.int32))


def _merge_exact_counts(pa, pb, pw, da, db, dcount, n_comb):
    """Exact-Θ merge: old per-pair counts + the delta's occurrences."""
    key_old = pa.astype(np.int64) * (n_comb + 1) + pb
    key_new = da.astype(np.int64) * (n_comb + 1) + db
    keys, inv = np.unique(np.concatenate([key_old, key_new]),
                          return_inverse=True)
    w = np.zeros(keys.size, np.float64)
    np.add.at(w, inv, np.concatenate([pw.astype(np.float64), dcount]))
    return ((keys // (n_comb + 1)).astype(np.int32),
            (keys % (n_comb + 1)).astype(np.int32),
            w.astype(np.float32))


def _exact_delta_counts(da, db, n_comb):
    duniq, dcount = np.empty(0, np.int64), np.empty(0, np.float64)
    if da.size:
        key = da.astype(np.int64) * (n_comb + 1) + db
        duniq, dcount = np.unique(key, return_counts=True)
        dcount = dcount.astype(np.float64)
    return ((duniq // (n_comb + 1)).astype(np.int32),
            (duniq % (n_comb + 1)).astype(np.int32), dcount)


def theta_delta_pairs(cu, cv, alt_u, alt_v, valid=None):
    """The Θ pairs a batch of edges adds (or, deleted, retracts): the three
    membership pair sets (primary × primary and each cross-type channel),
    each pair as ``(min, max)``, non-pairs dropped.  ``valid`` masks
    self-loops (a deletion's tags already hold −1 there)."""
    if valid is None:
        valid = np.ones(cu.shape, bool)
    a_parts, b_parts = [], []
    for a, bb, ok in ((cu, cv, valid), (alt_u, cv, valid & (alt_u >= 0)),
                      (cu, alt_v, valid & (alt_v >= 0))):
        ok = ok & (a != bb) & (a >= 0) & (bb >= 0)
        a_parts.append(np.minimum(a, bb)[ok])
        b_parts.append(np.maximum(a, bb)[ok])
    return (np.concatenate(a_parts).astype(np.int32),
            np.concatenate(b_parts).astype(np.int32))


def _empty_result(parts, arrival, stream_pos, rf, bal, full_cost) -> IncrementalResult:
    return IncrementalResult(
        parts=_scatter_parts(parts, arrival, stream_pos), rf=float(rf),
        balance=float(bal), refined=False, rf_drift=0.0, balance_drift=0.0,
        edges_replayed=0, full_replay_cost=full_cost, game_rounds=0,
        n_new_clusters=0, n_delta_edges=0)


def _game_inputs(sizes, pa, pb, pw, k, dev) -> _game.GameInputs:
    return _game.GameInputs(sizes=_dev(sizes, dev), pair_a=_dev(pa, dev),
                            pair_b=_dev(pb, dev), pair_w=_dev(pw, dev),
                            n_head=0, k=k)


def s5p_apply_delta(bundle: dict, config: S5PConfig, full_src, full_dst,
                    stream_pos: int, *, device=None) -> tuple[dict, IncrementalResult]:
    """Absorb ``full[stream_pos:]`` into the bundle; maybe refine.

    ``full_src``/``full_dst`` are the whole stream in arrival order (the
    bundle's prefix + the insertion batch).  Runs on ``device`` (default
    the card).  Returns the updated bundle (a copy: the input dict is not
    modified) and an :class:`IncrementalResult`.
    """
    dev = resolve_device(device)
    _new_game_log()
    b = ensure_slot_index(dict(bundle))
    full_src = _np(full_src, np.int32)
    full_dst = _np(full_dst, np.int32)
    E_total = int(full_src.shape[0])
    E0 = int(stream_pos)
    if E0 > E_total:
        raise ValueError(f"carry stream position {E0} is past the stream "
                         f"({E_total} edges)")
    if E0 != int(b["stream_pos"]):
        raise ValueError(
            f"bundle was built at stream position {int(b['stream_pos'])} "
            f"but the delta claims position {E0}")
    dsrc = full_src[E0:]
    ddst = full_dst[E0:]
    E_delta = E_total - E0
    k = config.k
    xi = int(b["xi"])
    kappa = int(b["kappa"])
    full_cost = 4 * E_total  # degree + Alg.1 + Θ + Alg.3 folds of a cold run

    # per-edge arrays are slot-indexed: gather the slots' edges once
    arrival0 = np.asarray(b["arrival"], np.int64)
    slot_src = full_src[arrival0]
    slot_dst = full_dst[arrival0]

    n_old = int(b["degrees"].shape[0])
    if E_delta == 0:
        parts = np.asarray(b["parts"], np.int32)
        rf, bal = _metrics(slot_src, slot_dst, parts, n_old, k, dev)
        return b, _empty_result(parts, arrival0, E0, rf, bal, full_cost)

    # version the bundle before the first mutation: deleting exactly this
    # batch later rolls straight back to the snapshot (bitwise)
    _write_journal(b, E0)

    # ---- vertex-set growth -------------------------------------------
    n_new = max(n_old, int(max(dsrc.max(), ddst.max())) + 1)
    degrees = np.zeros(n_new, np.int32)
    degrees[:n_old] = b["degrees"]
    # exact SUM update (self-loops count, as compute_degrees does)
    degrees += (np.bincount(dsrc, minlength=n_new)
                + np.bincount(ddst, minlength=n_new)).astype(np.int32)

    state = grow_carry("cluster", _unpack_cluster_state(b, dev), n_old, n_new)

    # ---- Alg. 1 replay over the delta (frozen ξ/κ, fresh degrees): K1 --
    delta_stream = DeltaStream(dsrc, ddst, n_new, base_offset=E0,
                               chunk_size=config.chunk_size, device=dev)
    pc = _cl.ClusterCarry(_dev(degrees, dev), n_new, xi=xi, kappa=kappa,
                          global_tail=config.bounded)
    _, state = run_incremental_carry(
        delta_stream, pc, carry=state, num_streams=config.num_streams,
        super_chunk=config.super_chunk)

    # ---- stable combined ids for any newly allocated clusters --------
    v2c_h = _np(state.v2c_h)
    v2c_t = _np(state.v2c_t)
    next_h = int(state.next_h)
    next_t = int(state.next_t)
    r2c_h = np.full(max(next_h, 1), -1, np.int32)
    r2c_h[:b["raw2comb_h"].shape[0]] = b["raw2comb_h"]
    r2c_t = np.full(max(next_t, 1), -1, np.int32)
    r2c_t[:b["raw2comb_t"].shape[0]] = b["raw2comb_t"]
    C0 = int(b["comb_is_head"].shape[0])
    used_h = np.unique(v2c_h[v2c_h >= 0])
    used_t = np.unique(v2c_t[v2c_t >= 0])
    new_h = used_h[r2c_h[used_h] < 0]
    new_t = used_t[r2c_t[used_t] < 0]
    r2c_h[new_h] = C0 + np.arange(new_h.size, dtype=np.int32)
    r2c_t[new_t] = C0 + new_h.size + np.arange(new_t.size, dtype=np.int32)
    C1 = C0 + new_h.size + new_t.size
    comb_is_head = np.concatenate([
        b["comb_is_head"], np.ones(new_h.size, bool),
        np.ones(new_t.size, bool) if config.one_stage
        else np.zeros(new_t.size, bool)])
    sizes = np.concatenate([b["sizes"],
                            np.zeros(C1 - C0, np.float32)]).astype(np.float32)
    c2p = np.concatenate([b["c2p"], np.full(C1 - C0, -1, np.int32)])
    touched = np.concatenate([b["touched"], np.ones(C1 - C0, bool)])

    # ---- per-edge cluster tags for the delta (combined ids) ----------
    u64 = dsrc.astype(np.int64)
    v64 = ddst.astype(np.int64)
    valid = dsrc != ddst
    head_e = (degrees[u64] > xi) & (degrees[v64] > xi)
    ch_u = _comb_of(v2c_h[u64], r2c_h)
    ct_u = _comb_of(v2c_t[u64], r2c_t)
    ch_v = _comb_of(v2c_h[v64], r2c_h)
    ct_v = _comb_of(v2c_t[v64], r2c_t)
    cu = np.where(head_e, ch_u, ct_u).astype(np.int32)
    cv = np.where(head_e, ch_v, ct_v).astype(np.int32)
    cu[~valid] = -1
    cv[~valid] = -1
    alt_u = np.where(head_e, ct_u, ch_u).astype(np.int32)
    alt_v = np.where(head_e, ct_v, ch_v).astype(np.int32)
    alt_u[~valid] = -1
    alt_v[~valid] = -1
    for arr in (cu, cv):
        t = arr[arr >= 0]
        if t.size:
            touched[t] = True

    # ---- cluster sizes (the ½/1 attribution of cluster_statistics), in
    # float64 on the host and cast to float32, as the reference does ----
    internal = (cu == cv) & valid & (cu >= 0)
    boundary = (cu != cv) & valid & (cu >= 0) & (cv >= 0)
    sizes64 = sizes.astype(np.float64)
    sizes64 += _sum_at(C1, cu[internal], 1.0)
    sizes64 += _sum_at(C1, cu[boundary], 0.5)
    sizes64 += _sum_at(C1, cv[boundary], 0.5)
    sizes = sizes64.astype(np.float32)

    # ---- Θ update: the three membership pair sets of the delta (K4a) --
    da, db = theta_delta_pairs(cu, cv, alt_u, alt_v, valid)
    if config.use_cms and "theta_table" in b:
        sketch = _sketch_to_dev(b, dev)
        if da.size:
            sketch = cms_update(sketch, _pair_keys(da, db, dev))
        pa, pb = _pair_union(b["pair_a"], b["pair_b"], da, db, C1)
        pw = _query(sketch, pa, pb)
        _sketch_to_host(b, sketch)
    else:
        pa, pb, pw = _merge_exact_counts(
            b["pair_a"], b["pair_b"], b["pair_w"], *_exact_delta_counts(da, db, C1), C1)

    # ---- settle new clusters (a masked game over just them) ----------
    game_rounds = 0
    n_new_clusters = C1 - C0
    # the settle and refine games share inputs: the cluster graph after
    # this delta (only c2p moves between the two)
    inputs = _game_inputs(sizes, pa, pb, pw, k, dev)
    bs = _game.default_batch_size(config.game_batch_size, C1)
    if n_new_clusters:
        c2p = _least_loaded_fill(sizes, c2p, range(C0, C1), k)
        # refine_rounds == 0 is pure replay: new clusters keep the fill
        if config.refine_rounds > 0:
            new_mask = np.zeros(C1, bool)
            new_mask[C0:] = True
            settle = _play(
                "settle", inputs, C1, batch_size=bs,
                max_rounds=min(4, config.refine_rounds),
                accept_prob=config.game_accept_prob, assign0=c2p,
                seed=config.seed, leader_mask=comb_is_head,
                move_mask=new_mask & (sizes > 0))
            c2p = _np(settle.assignment, np.int32)
            game_rounds += int(settle.rounds)

    # ---- Alg. 3: place only the delta edges (warm load vector): K2 ---
    # capacity follows the live edge count (tombstoned edges hold no load)
    e_live_in = int(np.count_nonzero(b["alive"])) + E_delta
    max_load = (_INT32_MAX if config.bounded
                else int(math.ceil(config.tau * e_live_in / k)))
    ac = AssignCarry(k, max_load, _dev(c2p, dev))
    delta_parts, load = run_carry(
        delta_stream, ac, head_e, np.maximum(cu, 0), np.maximum(cv, 0),
        carry=_dev(np.array(b["load"], np.int32), dev))
    parts = np.concatenate([b["parts"], _np(delta_parts, np.int32)])
    edge_cu = np.concatenate([b["edge_cu"], cu])
    edge_cv = np.concatenate([b["edge_cv"], cv])
    edge_alt_u = np.concatenate([b["edge_alt_u"], alt_u])
    edge_alt_v = np.concatenate([b["edge_alt_v"], alt_v])
    edge_head = np.concatenate([b["edge_head"], head_e])
    alive = np.concatenate([b["alive"], np.ones(E_delta, bool)])
    arrival = np.concatenate([arrival0,
                              np.arange(E0, E_total, dtype=np.int64)])
    slot_src = np.concatenate([slot_src, dsrc])
    slot_dst = np.concatenate([slot_dst, ddst])
    load = _np(load, np.int32)
    edges_replayed = 4 * E_delta

    # ---- drift check → bounded refinement ----------------------------
    e_live = int(np.count_nonzero(alive))
    rf, bal = _metrics(slot_src, slot_dst, parts, n_new, k, dev)
    monitor = DriftMonitor(
        float(b["rf_baseline"]), float(b["balance_baseline"]),
        rf_threshold=config.drift_rf_threshold,
        balance_threshold=config.drift_balance_threshold,
        churn_threshold=config.drift_churn_threshold,
        retracted=int(b.get("retracted", 0)))
    decision = monitor.check(rf, bal, live_edges=e_live)
    refined = False
    if decision.refine and config.refine_rounds > 0 and C1 > 0:
        c2p, parts, load, rounds, replayed, rf, bal = _refine_pass(
            config, inputs, C1, bs, c2p, comb_is_head, touched, sizes,
            parts, load, edge_cu, edge_cv, edge_head,
            slot_src, slot_dst, n_new, max_load, rf, bal, dev)
        game_rounds += rounds
        edges_replayed += replayed
        refined = True
        touched = np.zeros(C1, bool)
        monitor.rebase(rf, bal)

    # ---- pack the grown bundle ---------------------------------------
    _pack_cluster_state(b, state, next_h, next_t)
    b.update(
        degrees=degrees,
        raw2comb_h=r2c_h, raw2comb_t=r2c_t,
        comb_is_head=comb_is_head, sizes=sizes,
        pair_a=pa, pair_b=pb, pair_w=pw,
        c2p=c2p.astype(np.int32), load=load, parts=parts,
        edge_cu=edge_cu, edge_cv=edge_cv,
        edge_alt_u=edge_alt_u, edge_alt_v=edge_alt_v,
        edge_head=edge_head, alive=alive, arrival=arrival,
        stream_pos=np.int64(E_total),
        touched=touched,
        retracted=np.int64(monitor.retracted),
        rf_baseline=np.float64(monitor.baseline_rf),
        balance_baseline=np.float64(monitor.baseline_balance),
    )
    if refined:
        # refinement re-placed old edges: truncation can no longer
        # restore the previous version
        _invalidate_journal(b)
    refresh = _refresh_decision(b, config, degrees, e_live)
    result = IncrementalResult(
        parts=_scatter_parts(parts, arrival, E_total), rf=rf, balance=bal,
        refined=refined,
        rf_drift=decision.rf_drift, balance_drift=decision.balance_drift,
        edges_replayed=edges_replayed, full_replay_cost=full_cost,
        game_rounds=game_rounds, n_new_clusters=int(n_new_clusters),
        n_delta_edges=E_delta, churn=decision.churn,
        needs_cold_restart=refresh.needs_cold_restart,
        xi_drift=refresh.xi_drift, kappa_drift=refresh.kappa_drift)
    return b, result


def _refine_pass(config, inputs, C1, bs, c2p, comb_is_head, touched, sizes,
                 parts, load, edge_cu, edge_cv, edge_head,
                 full_src, full_dst, n_vertices, max_load, rf, bal, dev,
                 move_mask=None):
    """The drift-triggered masked Stackelberg refinement of the insertion
    and deletion paths: re-settle the touched clusters (or the caller's
    ``move_mask``), then lift and re-place (K2) only the moved clusters'
    live edges.  Returns ``(c2p, parts, load, rounds, n_replayed, rf, bal)``."""
    k = config.k
    if move_mask is None:
        move_mask = touched & (sizes > 0)
    refine = _play(
        "refine", inputs, C1, batch_size=bs, max_rounds=config.refine_rounds,
        accept_prob=config.game_accept_prob, assign0=c2p,
        seed=config.seed + 1, leader_mask=comb_is_head,
        move_mask=move_mask)
    c2p_new = _np(refine.assignment, np.int32)
    rounds = int(refine.rounds)
    replayed = 0
    moved = np.nonzero(c2p_new != c2p)[0]
    if moved.size:
        moved_mask = np.zeros(C1, bool)
        moved_mask[moved] = True
        ok = parts >= 0
        aff = ok & (moved_mask[np.maximum(edge_cu, 0)]
                    | moved_mask[np.maximum(edge_cv, 0)])
        # lift the affected edges' load, then re-place just them in
        # arrival order against the new cluster→partition map
        load64 = load.astype(np.int64)
        load64 -= np.bincount(parts[aff], minlength=k)[:k]
        aidx = np.nonzero(aff)[0]
        re_stream = EdgeStream(full_src[aidx], full_dst[aidx], n_vertices,
                               chunk_size=config.chunk_size, device=dev)
        ac = AssignCarry(k, max_load, _dev(c2p_new, dev))
        re_parts, load = run_carry(
            re_stream, ac, edge_head[aidx], np.maximum(edge_cu[aidx], 0),
            np.maximum(edge_cv[aidx], 0),
            carry=_dev(load64.astype(np.int32), dev))
        parts = parts.copy()
        parts[aidx] = _np(re_parts, np.int32)
        load = _np(load, np.int32)
        replayed = int(aidx.size)
        rf, bal = _metrics(full_src, full_dst, parts, n_vertices, k, dev)
    return c2p_new, parts, load, rounds, replayed, rf, bal


# ---------------------------------------------------------------------------
# deletion application
# ---------------------------------------------------------------------------


def s5p_apply_deletion(bundle: dict, config: S5PConfig, full_src, full_dst,
                       delete_idx, *, device=None) -> tuple[dict, IncrementalResult]:
    """Delete the edges at arrival indices ``delete_idx`` from the bundle.

    - **version rollback**: the deleted set is exactly the last inserted
      batch and the journal is intact: restore the snapshot, bitwise the
      pre-insertion bundle (``rolled_back=True``);
    - **decremental retraction**: tombstone the edges (``alive`` false,
      ``parts`` −1), subtract their degree / size / Θ (K4a, negative
      counts) / load accounting exactly from the stored per-edge tags,
      retract the Alg.-1 fold approximately
      (:func:`~repro_torch.core.clustering.cluster_retract_chunk` with the
      stored head flags), count the retractions toward drift, and run the
      masked refinement game when a drift channel trips.

    Runs on ``device`` (default the card).  Returns ``(bundle, result)``;
    the input bundle is not modified.
    """
    dev = resolve_device(device)
    _new_game_log()
    b = ensure_slot_index(dict(bundle))
    full_src = _np(full_src, np.int32)
    full_dst = _np(full_dst, np.int32)
    E_total = int(b["stream_pos"])
    if int(full_src.shape[0]) < E_total:
        raise ValueError(
            f"bundle covers {E_total} edges but the stream holds only "
            f"{full_src.shape[0]}")
    k = config.k
    full_cost = 4 * E_total
    idx = np.unique(np.asarray(delete_idx, np.int64))
    n_vertices = int(np.asarray(b["degrees"]).shape[0])
    arrival = np.asarray(b["arrival"], np.int64)
    slot_src = full_src[arrival]
    slot_dst = full_dst[arrival]
    if idx.size == 0:
        parts = np.asarray(b["parts"], np.int32)
        rf, bal = _metrics(slot_src, slot_dst, parts, n_vertices, k, dev)
        return b, _empty_result(parts, arrival, E_total, rf, bal, full_cost)
    if idx[0] < 0 or idx[-1] >= E_total:
        raise ValueError(
            f"deletion indices must lie in [0, {E_total}); got "
            f"[{idx[0]}, {idx[-1]}]")
    # global arrival indices → live slots (deleting a compacted slot's
    # arrival is a double delete)
    slot_idx = np.searchsorted(arrival, idx)
    hit = np.zeros(idx.size, bool)
    if arrival.size:
        inb = slot_idx < arrival.size
        hit[inb] = arrival[slot_idx[inb]] == idx[inb]
    alive = np.asarray(b["alive"], bool)
    if not hit.all() or not alive[slot_idx[hit]].all():
        raise ValueError("deletion names edges that are already deleted")
    D = int(idx.size)

    # ---- version rollback: exactly the last inserted batch -----------
    jpos = int(b.get("journal_pos", -1))
    if (bool(b.get("journal_valid", False)) and jpos >= 0
            and D == E_total - jpos
            and int(idx[0]) == jpos and int(idx[-1]) == E_total - 1):
        _rollback(b)
        parts = np.asarray(b["parts"], np.int32)
        arrival_rb = np.asarray(b["arrival"], np.int64)
        n_rb = int(np.asarray(b["degrees"]).shape[0])
        rf, bal = _metrics(full_src[arrival_rb], full_dst[arrival_rb], parts,
                           n_rb, k, dev)
        return b, _empty_result(parts, arrival_rb, jpos, rf, bal, full_cost)._replace(
            n_retracted=D, rolled_back=True)

    # ---- decremental retraction --------------------------------------
    dsrc = full_src[idx]
    ddst = full_dst[idx]
    degrees = np.asarray(b["degrees"], np.int32).copy()
    # exact inverse of the insertion's unconditional degree counting
    degrees -= (np.bincount(dsrc, minlength=n_vertices)
                + np.bincount(ddst, minlength=n_vertices)).astype(np.int32)

    state = _cl.cluster_retract_chunk(
        _unpack_cluster_state(b, dev), _dev(dsrc, dev), _dev(ddst, dev), D,
        is_head=_dev(np.asarray(b["edge_head"], bool)[slot_idx], dev))

    cu = np.asarray(b["edge_cu"])[slot_idx]
    cv = np.asarray(b["edge_cv"])[slot_idx]
    au = np.asarray(b["edge_alt_u"])[slot_idx]
    av = np.asarray(b["edge_alt_v"])[slot_idx]
    C1 = int(np.asarray(b["comb_is_head"]).shape[0])

    # sizes: subtract the same ½/1 attribution the insertion added
    sizes64 = np.asarray(b["sizes"], np.float64).copy()
    ok = (cu >= 0) & (cv >= 0)
    internal = ok & (cu == cv)
    boundary = ok & (cu != cv)
    sizes64 -= _sum_at(C1, cu[internal], 1.0)
    sizes64 -= _sum_at(C1, cu[boundary], 0.5)
    sizes64 -= _sum_at(C1, cv[boundary], 0.5)
    sizes = sizes64.astype(np.float32)

    # Θ retraction: the same three membership pair sets (K4a, count −1)
    da, db = theta_delta_pairs(cu, cv, au, av)
    pa = np.asarray(b["pair_a"], np.int32)
    pb = np.asarray(b["pair_b"], np.int32)
    if config.use_cms and "theta_table" in b:
        sketch = _sketch_to_dev(b, dev)
        if da.size:
            sketch = cms_retract(sketch, _pair_keys(da, db, dev))
        pw = _query(sketch, pa, pb)
        _sketch_to_host(b, sketch)
    else:
        ua, ub, dcount = _exact_delta_counts(da, db, C1)
        pa, pb, pw = _merge_exact_counts(
            pa, pb, np.asarray(b["pair_w"], np.float32), ua, ub, -dcount, C1)

    # load / parts / alive tombstones — exact
    parts = np.asarray(b["parts"], np.int32).copy()
    placed = parts[slot_idx] >= 0
    load64 = np.asarray(b["load"], np.int64).copy()
    load64 -= np.bincount(parts[slot_idx][placed], minlength=k)[:k]
    load = load64.astype(np.int32)
    parts[slot_idx] = -1
    alive = alive.copy()
    alive[slot_idx] = False
    touched = np.asarray(b["touched"], bool).copy()
    for arr in (cu, cv):
        t = arr[arr >= 0]
        if t.size:
            touched[t] = True

    edge_cu = np.asarray(b["edge_cu"])
    edge_cv = np.asarray(b["edge_cv"])
    edge_head = np.asarray(b["edge_head"], bool)
    c2p = np.asarray(b["c2p"], np.int32)
    comb_is_head = np.asarray(b["comb_is_head"], bool)
    edges_replayed = D  # one retraction fold per deleted edge

    # ---- drift check (retractions count) → bounded refinement --------
    e_live = int(np.count_nonzero(alive))
    rf, bal = _metrics(slot_src, slot_dst, parts, n_vertices, k, dev)
    monitor = DriftMonitor(
        float(b["rf_baseline"]), float(b["balance_baseline"]),
        rf_threshold=config.drift_rf_threshold,
        balance_threshold=config.drift_balance_threshold,
        churn_threshold=config.drift_churn_threshold,
        retracted=int(b.get("retracted", 0)))
    monitor.note_retractions(D)
    decision = monitor.check(rf, bal, live_edges=e_live)
    refined = False
    game_rounds = 0
    max_load = (_INT32_MAX if config.bounded
                else int(math.ceil(config.tau * max(e_live, 1) / k)))
    if decision.refine and config.refine_rounds > 0 and C1 > 0:
        inputs = _game_inputs(sizes, pa, pb, pw, k, dev)
        bs = _game.default_batch_size(config.game_batch_size, C1)
        # a churn-tripped refinement re-settles every live cluster
        move_mask = (sizes > 0) if decision.churn >= monitor.churn_threshold \
            else touched & (sizes > 0)
        c2p, parts, load, rounds, replayed, rf, bal = _refine_pass(
            config, inputs, C1, bs, c2p, comb_is_head, touched, sizes,
            parts, load, edge_cu, edge_cv, edge_head,
            slot_src, slot_dst, n_vertices, max_load,
            rf, bal, dev, move_mask=move_mask)
        game_rounds += rounds
        edges_replayed += replayed
        refined = True
        touched = np.zeros(C1, bool)
        monitor.rebase(rf, bal)

    # ---- pack ---------------------------------------------------------
    _pack_cluster_state(b, state, int(b["next_h"]), int(b["next_t"]))
    b.update(
        degrees=degrees, sizes=sizes, pair_a=pa, pair_b=pb, pair_w=pw,
        c2p=c2p.astype(np.int32), load=load, parts=parts, alive=alive,
        touched=touched, retracted=np.int64(monitor.retracted),
        rf_baseline=np.float64(monitor.baseline_rf),
        balance_baseline=np.float64(monitor.baseline_balance),
    )
    # any decremental deletion desynchronizes the journal snapshot
    _invalidate_journal(b)
    refresh = _refresh_decision(b, config, degrees, e_live)
    result = IncrementalResult(
        parts=_scatter_parts(parts, arrival, E_total), rf=rf, balance=bal,
        refined=refined,
        rf_drift=decision.rf_drift, balance_drift=decision.balance_drift,
        edges_replayed=edges_replayed, full_replay_cost=full_cost,
        game_rounds=game_rounds, n_new_clusters=0, n_delta_edges=0,
        n_retracted=D, churn=decision.churn,
        needs_cold_restart=refresh.needs_cold_restart,
        xi_drift=refresh.xi_drift, kappa_drift=refresh.kappa_drift)
    return b, result


# ---------------------------------------------------------------------------
# carry compaction (the append-only combined id space, renumbered)
# ---------------------------------------------------------------------------


def compact_bundle(bundle: dict, config: S5PConfig, *, device=None) -> tuple[dict, int]:
    """Renumber the combined cluster id space, dropping dead ids.

    The live ids are those a live edge tags or a vertex's counted
    membership still maps to; they are renumbered densely in order, and
    every id-indexed structure is rewritten (remaps, sizes, c2p, touched,
    leader mask, Θ pairs, per-edge tags).  The CMS is rebuilt over the
    renumbered pairs at their estimated weights (K4a, then K4b), sized for
    the live cluster count.  Returns ``(bundle, n_dropped)``; invalidates
    the rollback journal.
    """
    dev = resolve_device(device)
    b = dict(bundle)
    C1 = int(np.asarray(b["comb_is_head"]).shape[0])
    alive = np.asarray(b["alive"], bool)
    eff_h, eff_t = (_np(x) for x in _unpack_cluster_state(b, "cpu").effective())
    r2c_h = np.asarray(b["raw2comb_h"], np.int32)
    r2c_t = np.asarray(b["raw2comb_t"], np.int32)

    live = np.zeros(C1, bool)
    for tags in (np.asarray(b["edge_cu"])[alive],
                 np.asarray(b["edge_cv"])[alive],
                 np.asarray(b["edge_alt_u"])[alive],
                 np.asarray(b["edge_alt_v"])[alive]):
        t = tags[tags >= 0]
        if t.size:
            live[t] = True
    for raw, remap in ((eff_h, r2c_h), (eff_t, r2c_t)):
        r = raw[raw >= 0]
        if r.size:
            comb = remap[r]
            comb = comb[comb >= 0]
            live[comb] = True

    n_live = int(np.count_nonzero(live))
    n_dropped = C1 - n_live
    if n_dropped == 0:
        return b, 0
    remap = np.full(C1 + 1, -1, np.int32)  # trailing slot: -1 passthrough
    remap[:C1][live] = np.arange(n_live, dtype=np.int32)

    def _retag(arr):
        arr = np.asarray(arr, np.int32)
        return np.where(arr >= 0, remap[np.maximum(arr, 0)], -1).astype(np.int32)

    b["raw2comb_h"] = _retag(r2c_h)
    b["raw2comb_t"] = _retag(r2c_t)
    b["comb_is_head"] = np.asarray(b["comb_is_head"], bool)[live]
    b["sizes"] = np.asarray(b["sizes"], np.float32)[live]
    b["c2p"] = np.asarray(b["c2p"], np.int32)[live]
    b["touched"] = np.asarray(b["touched"], bool)[live]
    for key in ("edge_cu", "edge_cv", "edge_alt_u", "edge_alt_v"):
        b[key] = _retag(b[key])

    # pair list: drop pairs with a dead endpoint, renumber the rest
    pa = _retag(b["pair_a"])
    pb = _retag(b["pair_b"])
    pw = np.asarray(b["pair_w"], np.float32)
    keep = (pa >= 0) & (pb >= 0)
    pa, pb, pw = pa[keep], pb[keep], pw[keep]
    lo = np.minimum(pa, pb)
    hi = np.maximum(pa, pb)
    order = np.argsort(lo.astype(np.int64) * (n_live + 1) + hi, kind="stable")
    b["pair_a"], b["pair_b"], b["pair_w"] = lo[order], hi[order], pw[order]

    if config.use_cms and "theta_table" in b:
        # the sketch hashes ids: rebuild it over the renumbered pairs at
        # their estimated weights, resized for the live cluster count
        old = np.asarray(b["theta_table"], np.uint32)
        w, _d = suggest_params(config.cms_epsilon, config.cms_nu)
        width = w * max(1, int(math.isqrt(max(n_live, 1))))
        fresh = CMSketch(
            table=torch.zeros((old.shape[0], width), dtype=torch.int32, device=dev),
            seeds=_dev(np.asarray(b["theta_seeds"], np.uint32).astype(np.int64), dev))
        if b["pair_a"].size:
            counts = b["pair_w"].astype(np.uint32).astype(np.int64)
            fresh = cms_update(fresh, _pair_keys(b["pair_a"], b["pair_b"], dev),
                               _dev(counts, dev))
        _sketch_to_host(b, fresh)
        b["pair_w"] = _query(fresh, b["pair_a"], b["pair_b"])

    _invalidate_journal(b)
    return b, n_dropped


# ---------------------------------------------------------------------------
# edge-slot compaction (free the tombstoned per-edge records)
# ---------------------------------------------------------------------------


def compact_edge_slots(bundle: dict) -> tuple[dict, int]:
    """Drop dead per-edge slots, freeing the tombstones for real.

    Every per-edge array is gathered down to the live slots; the surviving
    ``arrival`` array is the stable old→new index map, and ``stream_pos``
    (with the CarryStore's prefix CRC) is untouched.  Host numpy only.
    Returns ``(bundle, n_freed)``; the input is not modified; the rollback
    journal is invalidated.
    """
    b = ensure_slot_index(dict(bundle))
    alive = np.asarray(b["alive"], bool)
    n_freed = int(alive.size - np.count_nonzero(alive))
    if n_freed == 0:
        return b, 0
    for key in _PER_EDGE:
        b[key] = np.asarray(b[key])[alive]
    _invalidate_journal(b)
    return b, n_freed


# ---------------------------------------------------------------------------
# cold restart (the ξ/κ refresh the drift monitor asks for)
# ---------------------------------------------------------------------------


def s5p_cold_restart(bundle: dict, config: S5PConfig, full_src,
                     full_dst, *, device=None) -> tuple[dict, IncrementalResult]:
    """Re-partition the bundle's live edge set from scratch (on ``device``),
    re-deriving thresholds, sketch, clusters and placements, and keep the
    stream coordinates (``arrival``, ``stream_pos``).  ``result.
    edges_replayed`` is the full cold cost.  Raises ``ValueError`` if the
    live set holds no valid edge."""
    b = ensure_slot_index(dict(bundle))
    full_src = _np(full_src, np.int32)
    full_dst = _np(full_dst, np.int32)
    alive = np.asarray(b["alive"], bool)
    arrival = np.asarray(b["arrival"], np.int64)[alive]
    stream_pos = int(b["stream_pos"])
    lsrc = full_src[arrival]
    ldst = full_dst[arrival]
    # keep the vertex table: values/carries sized to it stay aligned
    n_vertices = int(np.asarray(b["degrees"]).shape[0])
    _, nb = s5p_cold_bundle(lsrc, ldst, n_vertices, config, device=device)
    nb["arrival"] = arrival
    nb["stream_pos"] = np.int64(stream_pos)
    parts = np.asarray(nb["parts"], np.int32)
    cost = 4 * int(arrival.size)
    result = IncrementalResult(
        parts=_scatter_parts(parts, arrival, stream_pos),
        rf=float(nb["rf_baseline"]), balance=float(nb["balance_baseline"]),
        refined=False, rf_drift=0.0, balance_drift=0.0,
        edges_replayed=cost, full_replay_cost=max(cost, 1),
        game_rounds=0, n_new_clusters=int(nb["comb_is_head"].shape[0]),
        n_delta_edges=0)
    return nb, result
