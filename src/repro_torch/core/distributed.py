"""Distributed S5P: the partitioner itself over the ranks of a mesh axis.

The port of ``repro.core.distributed``.  SPMD: one process a rank, every
rank calls :func:`distributed_partition` with the whole edge list (the
reference's contract) and uploads only its own range of it to its device.
The edges are padded with ``(0, 0)`` pairs to a multiple of S (they fall
in the last range and count in vertex 0's degree), and rank s owns range
s.  Every rank returns the same result, bit for bit the reference's:

- **Phase 1** — the rank's degree counts, summed over the axis; then
  Alg. 1 over its range from an empty state, in the main path's chunks
  (K1 once a chunk: a serial fold in chunks is the reference's one scan).
- **Global ids** — the ranks' ``next_h``/``next_t`` and vertex → cluster
  tables all-gathered, heads first, then tails, rank-major inside each.
- **Phase 2** — cluster sizes as float64 partial sums (multiples of ½: any
  order is exact), summed over the axis; the rank's pairs (boundary and
  cross-type within its range, and the cross-range pairs of ranks
  ``(rank, s2 > rank)``) reduced to unique keys with counts before they
  cross, then merged by key; Θ is each rank's CMS of its own pair stream
  (K4a), the tables summed (a linear sketch, ℤ/2³²), queried over the
  merged pairs (K4b), or the exact merged counts.
- **Phase 3** — the game on every rank (its inputs are identical, so is its
  output: a hash of the assignment is checked across ranks).
- **Phase 4** — Alg. 3 round by round over chunks of ``max(chunk_size //
  S, 1024)`` edges: within a round the ranks place in turn (K2, one launch
  a chunk), each against the load vector the rank before it left (a send
  to rank s + 1, and from S − 1 back to 0 for the next round).  Serial, as
  the reference is.  The parts are all-gathered at the end.

:func:`last_partition_stats` returns this rank's seconds and collective
bytes by phase of the last call.
"""

from __future__ import annotations

import hashlib
import math
import time

import numpy as np
import torch

from .. import _dist
from ..streaming import EdgeStream, run_carry
from . import clustering as _cl
from . import game as _game
from . import postprocess as _post
from .cms import CMSketch, SketchCarry, cms_query, pair_key, suggest_params
from .s5p import S5PConfig, _game_report, _sync

__all__ = ["distributed_partition", "last_partition_stats"]

_INT32_MAX = 2**31 - 1
_last_stats: dict | None = None


def last_partition_stats() -> dict | None:
    """This rank's report of the last :func:`distributed_partition`: seconds
    and collective bytes by phase, the parts' hash, the cap and the game's
    report."""
    return _last_stats


def _host_int32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, np.int32)


def _hash(a: np.ndarray) -> int:
    """The first 8 bytes of the array's SHA-256, as a signed int64."""
    return int(np.frombuffer(hashlib.sha256(np.ascontiguousarray(a).tobytes()).digest()[:8],
                             np.int64)[0])


def _pairs(x: torch.Tensor, y: torch.Tensor, ok: torch.Tensor):
    return torch.minimum(x, y)[ok], torch.maximum(x, y)[ok]


def distributed_partition(src, dst, n_vertices: int, config: S5PConfig, mesh,
                          axis: str = "data", *, device=None):
    """Run S5P over the ranks of ``mesh[axis]`` (a ``DeviceMesh`` and one of
    its dim names; ``mesh=None`` is the default group).  Every rank of the
    axis calls it with the same arguments.  Returns ``(parts (E,) int32 on
    the rank's device, info)``, ``info`` with the reference's keys.  Runs
    on the rank's card unless ``device`` names another."""
    global _last_stats
    dev = _dist.rank_device(device)
    group = (mesh, axis) if mesh is not None else None
    S, me = _dist.world_size(group), _dist.rank(group)
    src, dst = _host_int32(src), _host_int32(dst)
    E = int(src.shape[0])
    pad = (-E) % S
    if pad:
        src = np.concatenate([src, np.zeros(pad, np.int32)])
        dst = np.concatenate([dst, np.zeros(pad, np.int32)])
    V, k = int(n_vertices), config.k
    avg_deg = 2.0 * E / max(V, 1)
    xi = min(int(config.beta * avg_deg), _INT32_MAX - 1)
    kappa = max(int(math.ceil(2.0 * E / k)), 2)
    L = (E + pad) // S
    lo = me * L
    seconds, moved = {}, {}
    t0 = time.perf_counter()
    b0 = sum(_dist.collective_bytes().values())

    def done(phase):
        nonlocal t0, b0
        _sync(dev)
        now, b = time.perf_counter(), sum(_dist.collective_bytes().values())
        seconds[phase], moved[phase] = now - t0, b - b0
        t0, b0 = now, b

    # ---- Phase 1: global degrees, then Alg. 1 over the rank's range ----
    s_host, d_host = src[lo:lo + L], dst[lo:lo + L]
    s_loc = torch.from_numpy(np.array(s_host)).to(dev)  # a copy: the input may be read-only
    d_loc = torch.from_numpy(np.array(d_host)).to(dev)
    deg = _dist.all_reduce(_cl.compute_degrees(s_loc, d_loc, V), _dist.SUM, group)
    stream = EdgeStream(s_host, d_host, V, chunk_size=config.chunk_size, device=dev)
    _, state = run_carry(stream, _cl.ClusterCarry(deg, V, xi=xi, kappa=kappa))
    done("clustering")

    # ---- global cluster ids: heads first, then tails, rank-major ----
    mine = torch.cat([torch.stack([state.next_h, state.next_t]).reshape(2),
                      state.v2c_h, state.v2c_t]).cpu().numpy()
    every = np.concatenate(_dist.all_gather_arrays(mine[None], group))  # (S, 2 + 2V)
    nh, nt = every[:, 0].astype(np.int64), every[:, 1].astype(np.int64)
    h_off = np.concatenate([[0], np.cumsum(nh)])[:-1]
    n_head = int(nh.sum())
    t_off = n_head + np.concatenate([[0], np.cumsum(nt)])[:-1]
    C = int(n_head + nt.sum())
    v2c_h, v2c_t = every[:, 2:2 + V], every[:, 2 + V:]
    gh = np.where(v2c_h >= 0, v2c_h + h_off[:, None], -1).astype(np.int32)  # (S, V)
    gt = np.where(v2c_t >= 0, v2c_t + t_off[:, None], -1).astype(np.int32)
    done("global_ids")

    # ---- Phase 2: sizes, the rank's pairs, the merged keys and Θ ----
    gh_me = torch.from_numpy(gh[me]).to(dev)
    gt_me = torch.from_numpy(gt[me]).to(dev)
    u, v = s_loc.long(), d_loc.long()
    valid = s_loc != d_loc
    is_head = (deg[u] > xi) & (deg[v] > xi)
    cu = torch.where(is_head, gh_me[u], gt_me[u])
    cv = torch.where(is_head, gh_me[v], gt_me[v])
    internal = (cu == cv) & valid & (cu >= 0)
    boundary = (cu != cv) & valid & (cu >= 0) & (cv >= 0)
    halves = (torch.bincount(cu[boundary].long(), minlength=C)
              + torch.bincount(cv[boundary].long(), minlength=C))
    sizes = torch.bincount(cu[internal].long(), minlength=C).double() + 0.5 * halves.double()
    sizes = _dist.all_reduce(sizes, _dist.SUM, group)
    alt_u = torch.where(is_head, gt_me[u], gh_me[u])
    alt_v = torch.where(is_head, gt_me[v], gh_me[v])
    pieces = [_pairs(cu, cv, boundary),
              _pairs(alt_u, cv, valid & (alt_u >= 0) & (alt_u != cv) & (cv >= 0)),
              _pairs(cu, alt_v, valid & (alt_v >= 0) & (alt_v != cu) & (cu >= 0))]
    a_np = np.concatenate([p[0].cpu().numpy() for p in pieces])
    b_np = np.concatenate([p[1].cpu().numpy() for p in pieces])
    cross = [(np.minimum(t[me], t[s2]), np.maximum(t[me], t[s2]), (t[me] >= 0) & (t[s2] >= 0))
             for t in (gh, gt) for s2 in range(me + 1, S)]
    a_np = np.concatenate([a_np] + [x[ok] for x, _, ok in cross]).astype(np.int32)
    b_np = np.concatenate([b_np] + [y[ok] for _, y, ok in cross]).astype(np.int32)
    keys, counts = np.unique(a_np.astype(np.int64) * (C + 1) + b_np, return_counts=True)
    merged = np.concatenate(_dist.all_gather_arrays(
        np.stack([keys, counts.astype(np.int64)], axis=1), group))
    uniq, inv = np.unique(merged[:, 0], return_inverse=True)
    counts = np.bincount(inv.reshape(-1), weights=merged[:, 1], minlength=uniq.size)
    pa = torch.from_numpy((uniq // (C + 1)).astype(np.int32)).to(dev)
    pb = torch.from_numpy((uniq % (C + 1)).astype(np.int32)).to(dev)
    if config.use_cms:
        w, depth = suggest_params(config.cms_epsilon, config.cms_nu)
        width = w * max(1, int(math.sqrt(max(C, 1))))
        pairs = EdgeStream(a_np, b_np, C + 1, chunk_size=1 << 18, device=dev)
        _, sketch = run_carry(pairs, SketchCarry(width, depth, seed=config.seed, device=dev))
        sketch = CMSketch(table=_dist.all_reduce(sketch.table, _dist.SUM, group),
                          seeds=sketch.seeds)
        pw = cms_query(sketch, pair_key(pa, pb)).to(torch.float32)
    else:
        pw = torch.from_numpy(counts.astype(np.float32)).to(dev)
    done("statistics")

    # ---- Phase 3: the replicated game ----
    inputs = _game.GameInputs(sizes=sizes.to(torch.float32), pair_a=pa, pair_b=pb,
                              pair_w=pw, n_head=C if config.one_stage else n_head, k=k)
    bs = _game.default_batch_size(config.game_batch_size, C)
    game = _game.run_game(inputs, C, batch_size=bs, max_rounds=config.game_max_rounds,
                          accept_prob=config.game_accept_prob, seed=config.seed)
    c2p = game.assignment
    h = torch.tensor([_hash(c2p.cpu().numpy())], dtype=torch.int64)
    if not torch.equal(_dist.all_reduce(h, _dist.MIN, group),
                       _dist.all_reduce(h, _dist.MAX, group)):
        raise RuntimeError("the replicated game gave different assignments on the ranks")
    done("game")

    # ---- Phase 4: Alg. 3, the ranks in turn within each round ----
    max_load = int(math.ceil(config.tau * (E + pad) / k))
    chunk = max(config.chunk_size // S, 1024)
    place = _post.AssignCarry(k, max_load, c2p)
    cu, cv = cu.clamp(min=0), cv.clamp(min=0)
    load = place.init()
    parts_loc = torch.empty(L, dtype=torch.int32, device=dev)
    starts = range(0, L, chunk)
    for r, start in enumerate(starts):
        stop = min(start + chunk, L)
        if S > 1 and (r > 0 or me > 0):
            load = _dist.recv(load, (me - 1) % S, group)
        load, p = place.step_chunk(load, s_loc[start:stop], d_loc[start:stop], stop - start,
                                   is_head[start:stop], cu[start:stop], cv[start:stop])
        parts_loc[start:stop] = p
        if S > 1 and (r < len(starts) - 1 or me < S - 1):
            _dist.send(load, (me + 1) % S, group)
    parts = np.concatenate(_dist.all_gather_arrays(parts_loc.cpu().numpy(), group))[:E]
    done("postprocess")

    _last_stats = {"seconds": seconds, "collective_bytes": moved, "max_load": max_load,
                   "parts_hash": _hash(parts), "shard_edges": L, "place_chunk": chunk,
                   "pairs": int(a_np.size),
                   "game": {**_game_report(game), "batch_size": bs}}
    info = {"n_clusters": C, "n_head": n_head, "game_rounds": int(game.rounds),
            "converged": bool(game.converged), "n_shards": S}
    return torch.from_numpy(parts).to(dev), info
