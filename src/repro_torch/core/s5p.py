"""S5P — Skewness-aware Streaming Vertex-cut Partitioner (the paper's system).

Pipeline (paper Fig. 2), on one :class:`~repro_torch.streaming.EdgeStream`
replayed by every pass:

  degrees ──Alg.1──▶ head/tail clusters ──compaction, Θ──▶ Alg.2 game
          ──Alg.3──▶ edge→partition (+ RF / balance)

Variants: CMS-backed Θ (default) or exact Θ (``use_cms=False``), S5P-B
(``bounded=True``: global degrees everywhere, no κ cap, no maxLoad) and
the one-stage game (``one_stage=True``).  Runs on ``device`` (default
``cuda``): there Alg. 1, Alg. 3 and the CMS go through the K1, K2 and
K4a/K4b kernels.

Parallel ingest (``num_streams > 1``): the clustering and placement
passes run S lanes (``shard``: range, round-robin or hub) merged every
``super_chunk`` chunks (or ``"auto"``), the Θ pair stream S range lanes
(its sketch is linear, so its table equals the sequential one).  Then the
touch-up (``touch_up``, :func:`_touch_up`) plays a masked game of at most
``refine_rounds`` rounds over the clusters that two or more lanes wrote
and re-places the edges of the clusters that moved.  The stream may be
an out-of-core ``ShardedEdgeStream`` (edge shards paged from disk).  The
drift knobs serve the warm-start bundle of :mod:`repro_torch.incremental`,
which packs ``aux["incremental"]``.  ``host_budget`` is the memory-budget
hybrid's knob: :func:`s5p_partition` ignores it, only
:func:`repro_torch.hybrid.run_hybrid` reads it.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any

import numpy as np
import torch

from .._device import resolve_device
from ..streaming import EdgeStream, ParallelEdgeStream, last_ingest_stats, run_carry, run_parallel
from . import clustering as _cl
from . import game as _game
from . import postprocess as _post
from .cms import SketchCarry, cms_query, pair_key, suggest_params

__all__ = ["S5PConfig", "S5POutput", "s5p_partition", "cluster_statistics", "theta_pairs"]

_INT32_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class S5PConfig:
    k: int
    tau: float = 1.0  # balance threshold (paper uses 1.0)
    beta: float = 1.0  # ξ = β · avg_degree
    use_cms: bool = True
    cms_epsilon: float = 0.1
    cms_nu: float = 0.01
    game_batch_size: int = 256
    game_max_rounds: int = 96
    game_accept_prob: float = 0.9
    chunk_size: int = 1 << 16
    ordering: str = "natural"
    bounded: bool = False  # S5P-B (§5.3)
    one_stage: bool = False  # Fig. 7d ablation
    seed: int = 0
    # parallel ingest: S lanes a pass, merged every super_chunk chunks
    # (or "auto"); shard is range | round-robin (rr) | hub
    num_streams: int = 1
    super_chunk: int | str = 8
    shard: str = "range"
    # after a parallel run: a masked game of at most refine_rounds rounds
    # over the clusters two or more lanes wrote, then their edges re-placed
    touch_up: bool = True
    # incremental re-partitioning (repro_torch.incremental): the drift
    # monitor's thresholds, the refinement game's round budget (also the
    # touch-up's) and the ξ/κ refresh signal's threshold
    drift_rf_threshold: float = 0.05
    drift_balance_threshold: float = 0.10
    refine_rounds: int = 16
    drift_churn_threshold: float = 0.25
    xi_refresh_threshold: float = 0.5
    # memory-budget hybrid (repro_torch.hybrid): host bytes for a resident
    # high-degree core; None = the pure-streaming pipeline.  s5p_partition
    # ignores it; run_hybrid's host_budget= overrides.
    host_budget: int | None = None


@dataclasses.dataclass
class S5POutput:
    parts: torch.Tensor  # (E,) int32 edge → partition
    k: int
    n_clusters: int
    n_head_clusters: int
    game_rounds: int
    game_converged: bool
    xi: int
    kappa: int
    max_load: int
    cluster_assignment: np.ndarray  # (C,) cluster → partition
    timings: dict[str, float]
    aux: dict[str, Any]


def _edge_clusters(src, dst, res: _cl.ClusterResult, degrees, xi):
    """Per-edge (cu, cv, is_head_edge) from the compacted tables."""
    s, d = src.long(), dst.long()
    is_head = (degrees[s] > xi) & (degrees[d] > xi)
    cu = torch.where(is_head, res.v2c_h[s], res.v2c_t[s])
    cv = torch.where(is_head, res.v2c_h[d], res.v2c_t[d])
    return cu, cv, is_head


def theta_pairs(src, dst, res: _cl.ClusterResult, degrees, xi: int, *,
                edge_clusters=None) -> tuple[np.ndarray, np.ndarray]:
    """The Θ pass's pair stream on the host, as the statistics pass streams
    it: for every edge its three pair sets (primary and other-type
    memberships of each endpoint), each pair as ``(min, max)`` cluster
    ids, the pairs that are no pair (a self pair, a missing membership, a
    self-loop edge) dropped.  ``edge_clusters`` is ``_edge_clusters``'s
    result when the caller has it."""
    dev = src.device
    C = res.n_clusters
    cu, cv, is_head = (edge_clusters if edge_clusters is not None
                       else _edge_clusters(src, dst, res, degrees, xi))
    valid = src != dst
    s, d = src.long(), dst.long()
    hu, hv = res.v2c_h[s], res.v2c_h[d]
    tu, tv = res.v2c_t[s], res.v2c_t[d]
    alt_u = torch.where(is_head, tu, hu)  # u's membership in the other table
    alt_v = torch.where(is_head, tv, hv)
    pair_sets = [
        (cu, cv, valid),
        (alt_u, cv, valid & (alt_u >= 0)),
        (cu, alt_v, valid & (alt_v >= 0)),
    ]
    sentinel = torch.full((), C, dtype=torch.int32, device=dev)
    a_parts, b_parts = [], []
    for a, b, ok in pair_sets:
        ok = ok & (a != b) & (a >= 0) & (b >= 0)
        a_parts.append(torch.where(ok, torch.minimum(a, b), sentinel).cpu().numpy())
        b_parts.append(torch.where(ok, torch.maximum(a, b), sentinel).cpu().numpy())
    a_np = np.concatenate(a_parts)
    b_np = np.concatenate(b_parts)
    keep = a_np < C
    return a_np[keep], b_np[keep]


def cluster_statistics(src, dst, res: _cl.ClusterResult, degrees, xi: int, *,
                       use_cms: bool, cms_epsilon: float, cms_nu: float,
                       seed: int, chunk_size: int = 1 << 18,
                       num_streams: int = 1, super_chunk: int | str = 8):
    """Stream pass 2: cluster sizes and inter-cluster adjacency Θ.

    An internal edge adds 1 to its cluster's size, a boundary edge ½ to
    each side.  Θ pairs span every pair of endpoint memberships (primary
    and other-type, :func:`theta_pairs`); the pair list is deduped on the
    host (numpy), and the counts come from a CMS streamed over the pairs
    (K4a, queried by K4b) or from the exact dedup counts.  The pair stream
    shards by range over ``num_streams`` lanes: the sketch is linear, so
    the merged table is the sequential one bit for bit.
    """
    dev = src.device
    C = res.n_clusters
    cu, cv, is_head = _edge_clusters(src, dst, res, degrees, xi)
    valid = src != dst
    internal = (cu == cv) & valid
    boundary = (cu != cv) & valid

    def seg(w, idx):
        z = torch.zeros(C, dtype=torch.float32, device=dev)
        return z.index_add(0, idx.clamp(min=0).long(), w)

    one = torch.ones((), dtype=torch.float32, device=dev)
    half = torch.full((), 0.5, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    sizes = seg(torch.where(internal, one, zero), cu)
    sizes = sizes + seg(torch.where(boundary, half, zero), cu)
    sizes = sizes + seg(torch.where(boundary, half, zero), cv)

    a_np, b_np = theta_pairs(src, dst, res, degrees, xi, edge_clusters=(cu, cv, is_head))
    keys = a_np.astype(np.int64) * (C + 1) + b_np
    uniq, counts = np.unique(keys, return_counts=True)
    pa = torch.from_numpy((uniq // (C + 1)).astype(np.int32)).to(dev)
    pb = torch.from_numpy((uniq % (C + 1)).astype(np.int32)).to(dev)

    sketch_mem = 0
    if use_cms:
        w, depth = suggest_params(cms_epsilon, cms_nu)
        pair_stream = EdgeStream(a_np, b_np, C + 1, chunk_size=chunk_size, device=dev)
        theta = SketchCarry(w * max(1, int(math.sqrt(C))), depth, seed=seed,
                            device=dev)
        _, sketch = run_parallel(pair_stream, theta, num_streams=num_streams,
                                 super_chunk=super_chunk)
        pw = cms_query(sketch, pair_key(pa, pb)).to(torch.float32)
        sketch_mem = sketch.memory_bytes()
    else:
        sketch = None
        pw = torch.from_numpy(counts.astype(np.float32)).to(dev)

    return sizes, pa, pb, pw, {
        "n_pairs": int(uniq.size),
        "sketch_bytes": sketch_mem,
        "exact_count_bytes": int(uniq.size) * (8 + 4),
        "counts_exact": counts,
        "sketch": sketch,
    }


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _as_int32(x, dev) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x, np.int32))
    return x.to(dev, torch.int32)


def s5p_partition(src, dst, n_vertices: int, config: S5PConfig,
                  stream: EdgeStream | None = None, *, device=None) -> S5POutput:
    """Partition an edge list with S5P.  ``src``/``dst`` are int arrays or
    tensors in arrival order; the run happens on ``device`` (default
    ``cuda``), or on the device of ``stream`` when one is passed.  Every
    pass over the edges replays ``stream``, which may page them from disk
    (``ShardedEdgeStream``); the degrees, the statistics and the
    placement's cluster ids read the arrival arrays, as in the reference."""
    dev = stream.device if stream is not None else resolve_device(device)
    src = _as_int32(src, dev)
    dst = _as_int32(dst, dev)
    E = int(src.shape[0])
    k = config.k
    timings: dict[str, float] = {}
    if stream is None:
        stream = EdgeStream(src.cpu().numpy(), dst.cpu().numpy(), n_vertices,
                            chunk_size=config.chunk_size,
                            ordering=config.ordering, seed=config.seed,
                            device=dev)

    t0 = time.perf_counter()
    degrees = _cl.compute_degrees(src, dst, n_vertices)
    avg_deg = 2.0 * E / max(n_vertices, 1)
    xi = min(int(config.beta * avg_deg), _INT32_MAX - 1)
    kappa = _INT32_MAX if config.bounded else max(int(math.ceil(2.0 * E / k)), 2)

    # ---- Phase 1: skewness-aware streaming clustering (Alg. 1) ----
    state = _cl.cluster_stream(src, dst, n_vertices, xi=xi, kappa=kappa,
                               global_tail=config.bounded, stream=stream,
                               num_streams=config.num_streams,
                               super_chunk=config.super_chunk, shard=config.shard)
    res = _cl.compact_clusters(state, degrees, xi)
    _sync(dev)
    timings["clustering"] = time.perf_counter() - t0

    if res.n_clusters == 0:  # degenerate: no valid edges
        return S5POutput(
            parts=torch.full((E,), -1, dtype=torch.int32, device=dev), k=k,
            n_clusters=0, n_head_clusters=0, game_rounds=0,
            game_converged=True, xi=xi, kappa=kappa, max_load=0,
            cluster_assignment=np.zeros(0, np.int32), timings=timings, aux={})

    # ---- Θ statistics pass ----
    t0 = time.perf_counter()
    sizes, pa, pb, pw, stats = cluster_statistics(
        src, dst, res, degrees, xi, use_cms=config.use_cms,
        cms_epsilon=config.cms_epsilon, cms_nu=config.cms_nu, seed=config.seed,
        num_streams=config.num_streams, super_chunk=config.super_chunk)
    _sync(dev)
    timings["statistics"] = time.perf_counter() - t0

    # ---- Phase 2: Stackelberg game (Alg. 2) ----
    t0 = time.perf_counter()
    n_head = res.n_clusters if config.one_stage else res.n_head
    inputs = _game.GameInputs(sizes=sizes, pair_a=pa, pair_b=pb, pair_w=pw,
                              n_head=n_head, k=k)
    bs = _game.default_batch_size(config.game_batch_size, res.n_clusters)
    game = _game.run_game(inputs, res.n_clusters, batch_size=bs,
                          max_rounds=config.game_max_rounds,
                          accept_prob=config.game_accept_prob, seed=config.seed)
    _sync(dev)
    timings["game"] = time.perf_counter() - t0

    # ---- Phase 3: postprocess (Alg. 3) ----
    t0 = time.perf_counter()
    max_load = _INT32_MAX if config.bounded else int(math.ceil(config.tau * E / k))
    cu, cv, is_head = _edge_clusters(src, dst, res, degrees, xi)
    parts, load = _post.assign_edges_stream(
        src, dst, is_head, cu.clamp(min=0), cv.clamp(min=0), game.assignment,
        k, max_load, stream=stream, num_streams=config.num_streams,
        super_chunk=config.super_chunk, shard=config.shard)
    _sync(dev)
    timings["postprocess"] = time.perf_counter() - t0
    stats["parallel_ingest"] = last_ingest_stats().as_dict()  # the placement pass

    stats["game"] = _game_report(game)
    stats["game"].update(batch_size=bs, n_head=n_head)
    c2p = game.assignment
    if (config.num_streams > 1 and config.touch_up
            and config.refine_rounds > 0 and res.n_clusters > 1):
        t0 = time.perf_counter()
        parts, load, c2p, stats["touch_up"] = _touch_up(
            src, dst, n_vertices, config, stream, res, inputs, bs, cu, cv,
            is_head, sizes, parts, load, c2p, k, max_load)
        _sync(dev)
        timings["touch_up"] = time.perf_counter() - t0
    stats["incremental"] = {
        "cluster_state": state, "degrees": degrees, "compact": res,
        "sizes": sizes, "pair_a": pa, "pair_b": pb, "pair_w": pw, "load": load,
    }
    return S5POutput(
        parts=parts, k=k, n_clusters=res.n_clusters,
        n_head_clusters=res.n_head, game_rounds=game.rounds,
        game_converged=game.converged, xi=xi, kappa=kappa, max_load=max_load,
        cluster_assignment=c2p.cpu().numpy(), timings=timings, aux=stats)


def _game_report(game: _game.GameResult) -> dict:
    return {f: getattr(game, f) for f in game._fields if f != "assignment"}


def _touch_up(src, dst, n_vertices, config, stream, res, inputs, bs, cu, cv,
              is_head, sizes, parts, load, c2p, k, max_load):
    """The reference's post-ingest touch-up: a masked game of at most
    ``refine_rounds`` rounds over the clusters whose edges two or more
    lanes folded (the only ones whose state could differ across lanes),
    then the edges of the clusters that moved are lifted out of the load
    vector and placed again, in arrival order, against the new table.
    The plan is deterministic, so rebuilding it gives the ingest's lanes.
    Returns ``(parts, load, c2p, stats)``."""
    dev = parts.device
    C = res.n_clusters
    lanes = ParallelEdgeStream(stream, config.num_streams,
                               shard=config.shard).edge_lanes()
    cu_np = cu.cpu().numpy()
    cv_np = cv.cpu().numpy()
    valid = (src != dst).cpu().numpy()
    c_all = np.concatenate([cu_np[valid], cv_np[valid]])
    l_all = np.concatenate([lanes[valid], lanes[valid]])
    ok = c_all >= 0
    mn = np.full(C, np.iinfo(np.int32).max, np.int64)
    mx = np.full(C, -1, np.int64)
    np.minimum.at(mn, c_all[ok], l_all[ok])
    np.maximum.at(mx, c_all[ok], l_all[ok])
    contested = mx > mn  # folded by two or more lanes
    move_mask = contested & (sizes.cpu().numpy() > 0)
    stats = {"contested_clusters": int(contested.sum()), "moved_clusters": 0,
             "replayed_edges": 0, "rounds": 0}
    if not move_mask.any():
        return parts, load, c2p, stats
    c2p_np = c2p.cpu().numpy()
    refined = _game.run_game(
        inputs, C, batch_size=bs, max_rounds=config.refine_rounds,
        accept_prob=config.game_accept_prob, assign0=c2p_np,
        seed=config.seed + 1, leader_mask=np.arange(C) < inputs.n_head,
        move_mask=move_mask)
    stats["rounds"] = int(refined.rounds)
    stats["game"] = _game_report(refined)
    stats["game"].update(batch_size=bs, move_mask=move_mask)
    c2p_new = refined.assignment
    moved = np.flatnonzero(c2p_new.cpu().numpy() != c2p_np)
    stats["moved_clusters"] = int(moved.size)
    if not moved.size:
        return parts, load, c2p, stats
    moved_mask = np.zeros(C, bool)
    moved_mask[moved] = True
    aff = valid & (moved_mask[np.maximum(cu_np, 0)] | moved_mask[np.maximum(cv_np, 0)])
    aidx = np.flatnonzero(aff)
    stats["replayed_edges"] = int(aidx.size)
    idx = torch.from_numpy(aidx).to(dev)
    old_parts = parts[idx]
    load = load - torch.bincount(old_parts.long(), minlength=k).to(load.dtype)
    re_stream = EdgeStream(src[idx].cpu().numpy(), dst[idx].cpu().numpy(), n_vertices,
                           chunk_size=config.chunk_size, device=dev)
    ac = _post.AssignCarry(k, max_load, c2p_new)
    re_parts, load = run_carry(re_stream, ac, is_head[idx], cu[idx].clamp(min=0),
                               cv[idx].clamp(min=0), carry=load)
    parts = parts.clone()
    parts[idx] = re_parts
    return parts, load, c2p_new, stats
