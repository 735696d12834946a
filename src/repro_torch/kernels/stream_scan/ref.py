"""Plain PyTorch versions of K1, K2, K3 and G1, with the whole kernel contract,
and the scoring oracles of the Greedy, HDRF and grid baselines.

K1/K2: the per-edge transitions live in ``core.clustering`` and
``core.postprocess`` (as in ``repro``); their oracles take and return the
same leaf tuples and arguments as the wrappers in :mod:`.kernel`.  ``core``
is imported lazily: ``core`` imports the kernels package at module level.

K3/G1 and the scoring oracles (``repro.kernels.stream_scan.ref``): the
carries are the reference's tuples — Greedy ``(load, rep)``, HDRF ``(load,
rep, pd, λ, kmask)``, grid ``(load, row, col, n_cols)`` — with ``rep`` the
**counted** ``(V, k)`` replica table that OR-projects (``> 0``) for
scoring.  Inserts are sequential scans, edge by edge; retracts are
vectorised exact inverses (integer scatter-subtracts commute).  Unlike the
reference's pure functions these update the carry's tensors in place and
return them, as the kernels do.

HDRF rounds as the reference's compiled scan (XLA 0.9, CPU) rounds it:
``g = 2 − θ`` (XLA folds ``1 + (1 − θ)``), ``θ`` and ``bal`` as IEEE
divisions, and the score as one fused multiply-add ``fma(λ, bal, g_u +
g_v)`` (:func:`repro_torch._fp32.fma_f32`).  Ties go to the lowest index:
argmax of the HDRF score (inactive partitions score −inf), argmin of the
Greedy ``where(mask, load, 2**30)``.

``cluster_chunk_staged`` and ``scoring_chunk_staged`` are the kernels'
tile plans (:mod:`.plan`) in plain torch: each tile's endpoints get vertex
slots, their state is gathered, the fold runs on slots, and the tile is
written back.  They give the oracles' bits for any tile and any slot
numbering (``slot_seed`` shuffles it, as the kernels' atomics do).
"""

from __future__ import annotations

import numpy as np
import torch

from ..._fp32 import fma_f32
from .plan import K1_TILE, scoring_plan

__all__ = [
    "cluster_chunk_oracle",
    "cluster_chunk_staged",
    "scoring_chunk_staged",
    "assign_chunk_oracle",
    "scoring_chunk_oracle",
    "grid_chunk_oracle",
    "greedy_init",
    "greedy_chunk",
    "greedy_retract_chunk",
    "hdrf_init",
    "hdrf_chunk",
    "hdrf_retract_chunk",
    "grid_init",
    "grid_chunk",
    "grid_retract_chunk",
]

_INF_I32 = 2**30
_HDRF_EPS = 1e-3


def cluster_chunk_oracle(state, src, dst, degrees, *, xi, kappa,
                         global_tail=False):
    """``core.clustering.cluster_chunk`` on a 10-leaf state tuple (in place)."""
    from ...core.clustering import ClusterState, cluster_chunk

    out = cluster_chunk(ClusterState(*state), src, dst, degrees, xi=xi,
                        kappa=kappa, global_tail=global_tail)
    return tuple(out)


def _tile_slots(us, vs, rng):
    """The tile's distinct endpoints (its vertex slots, each vertex once)
    in first-appearance order, or shuffled by ``rng``; and the slot map."""
    vid = list(dict.fromkeys(x for pair in zip(us, vs) for x in pair))
    if rng is not None:
        rng.shuffle(vid)
    return vid, {x: i for i, x in enumerate(vid)}


def _cluster_slots(ids, next_id, rng):
    """Cluster slots of one kind (head or tail) for a tile whose vertices
    hold cluster ``ids`` (``-1``: none).  Slots ``0 … n_new - 1`` are the ids
    the tile may hand out, ``next_id + j`` (``n_new`` = vertices without a
    cluster: each gets at most one); the vertices' other ids follow.
    Returns (slot → id, the vertices' ids as slots, n_new)."""
    from ...core.clustering import _w32

    n_new = sum(c < 0 for c in ids)
    sid = [_w32(next_id + j) for j in range(n_new)]
    slot = {c: j for j, c in enumerate(sid)}
    rest = [c for c in dict.fromkeys(ids) if c >= 0 and c not in slot]
    if rng is not None:
        rng.shuffle(rest)
    for c in rest:
        slot[c] = len(sid)
        sid.append(c)
    return sid, [slot[c] if c >= 0 else -1 for c in ids], n_new


def cluster_chunk_staged(state, src, dst, degrees, *, xi, kappa,
                         global_tail=False, tile: int = K1_TILE,
                         slot_seed: int | None = None):
    """K1's tile plan in plain torch, in place on the 10-leaf state.

    Per tile of ``tile`` edges: stage (vertex slots; each slot's degree,
    head and tail cluster, local degree, counts and allocation; the cluster
    slots of :func:`_cluster_slots` with their volumes, read even for the
    ids to be handed out; each valid edge's bump of its endpoints' head or
    tail count), fold the tile on slots in the oracle's statement order
    (``core.clustering._edge_step``, its id counters counting new slots
    from 0, its counts and allocations into scratch: they never feed its
    decisions), then write every staged leaf back with slots turned into
    ids, the allocation of each vertex that started without a head cluster
    and ends with one, and the id counters.  Volumes at ids outside
    ``[0, V]`` are neither read nor written, as in the kernel.
    """
    from types import SimpleNamespace

    from ...core.clustering import _edge_step, _w32

    (v2ch, v2ct, volh, volt, ld, nexth, nextt, cnth, cntt, alloch) = state
    V = int(degrees.shape[0])
    rng = None if slot_seed is None else np.random.default_rng(slot_seed)
    us_all, vs_all = src.tolist(), dst.tolist()
    kw = dict(xi=int(xi), kappa=int(kappa), global_tail=bool(global_tail))
    for base in range(0, len(us_all), tile):
        us, vs = us_all[base:base + tile], vs_all[base:base + tile]
        vid, vslot = _tile_slots(us, vs, rng)
        idx = torch.tensor(vid, dtype=torch.long)
        h0 = v2ch[idx].tolist()
        hid, hs, new_h = _cluster_slots(h0, int(nexth), rng)
        tid, ts, new_t = _cluster_slots(v2ct[idx].tolist(), int(nextt), rng)
        deg = degrees[idx].tolist()
        counts = {"h": cnth[idx].tolist(), "t": cntt[idx].tolist()}
        for u, v in zip(us, vs):
            su, sv = vslot[u], vslot[v]
            if su != sv:
                c = counts["h" if deg[su] > xi and deg[sv] > xi else "t"]
                c[su] = _w32(c[su] + 1)
                c[sv] = _w32(c[sv] + 1)

        def vols(table, ids):
            return [int(table[c]) if 0 <= c <= V else 0 for c in ids]

        scratch = [0] * len(vid)
        s = SimpleNamespace(
            v2c_h=hs, v2c_t=ts, vol_h=vols(volh, hid), vol_t=vols(volt, tid),
            ld=ld[idx].tolist(), next_h=0, next_t=0, cnt_h=list(scratch),
            cnt_t=list(scratch), alloc_h=list(scratch))
        for u, v in zip(us, vs):
            _edge_step(s, vslot[u], vslot[v], True, deg=deg, **kw)
        # the tile's clusters are closed: it handed out only reserved slots
        assert s.next_h <= new_h and s.next_t <= new_t
        alloc = [_w32(a + d) if c0 < 0 and c >= 0 else a for a, d, c0, c
                 in zip(alloch[idx].tolist(), deg, h0, s.v2c_h)]
        for table, ids, sl in ((v2ch, hid, s.v2c_h), (v2ct, tid, s.v2c_t)):
            table[idx] = torch.tensor([ids[c] if c >= 0 else -1 for c in sl],
                                      dtype=torch.int32)
        for table, ids, vol in ((volh, hid, s.vol_h), (volt, tid, s.vol_t)):
            keep = [j for j, c in enumerate(ids) if 0 <= c <= V]
            table[torch.tensor([ids[j] for j in keep], dtype=torch.long)] = \
                torch.tensor([vol[j] for j in keep], dtype=torch.int32)
        for table, vals in ((ld, s.ld), (cnth, counts["h"]), (cntt, counts["t"]),
                            (alloch, alloc)):
            table[idx] = torch.tensor(vals, dtype=torch.int32)
        nexth.fill_(_w32(int(nexth) + s.next_h))
        nextt.fill_(_w32(int(nextt) + s.next_t))
    return tuple(state)


def assign_chunk_oracle(load, src, dst, is_head_edge, pcu, pcv, *, max_load,
                        sign=1, parts=None, n_valid=None):
    """Alg. 3 over one chunk, insert or retract; returns ``(parts, load)``.

    Insert: ``core.postprocess._assign_steps`` over every entry (``limit``
    is the chunk length; padding drops out as a self-loop).  Retract: the
    recorded ``parts`` of the first ``n_valid`` entries each give back one
    unit, and come back unchanged as the chunk's parts.
    """
    from ...core.postprocess import _assign_steps

    if sign > 0:
        return _assign_steps(load, src, dst, is_head_edge, pcu, pcv,
                             max_load=int(max_load))
    real = torch.arange(src.shape[0], device=src.device) < int(n_valid)
    placed = real & (src != dst) & (parts >= 0)
    load = load - torch.zeros_like(load).index_add_(
        0, parts.clamp(min=0).long(), placed.to(load.dtype))
    return parts.clone(), load


# ------------------------------------------------------------- K3 (plain)


def _greedy_pick(load, ru, rv) -> int:
    """PowerGraph's four cases: both endpoints' partitions, else either's,
    else all; the least-loaded of the candidates (lowest index on ties)."""
    both = ru & rv
    if bool(both.any()):
        mask = both
    else:
        mask = ru | rv  # cases 2 and 3 take the same mask
        if not bool(mask.any()):
            return int(torch.argmin(load))
    return int(torch.argmin(torch.where(mask, load, _INF_I32)))


def _hdrf_pick(load, ru, rv, du: int, dv: int, lam, kmask, eps) -> int:
    """argmax over active partitions of ``g_u + g_v + λ·bal``, rounded as
    the reference's compiled scan rounds it (module docstring)."""
    du_f = torch.tensor(du, dtype=torch.float32)
    dv_f = torch.tensor(dv, dtype=torch.float32)
    theta_u = du_f / (du_f + dv_f)
    theta_v = 1.0 - theta_u
    zero = torch.zeros((), dtype=torch.float32)
    g = torch.where(ru, 2.0 - theta_u, zero) + torch.where(rv, 2.0 - theta_v, zero)
    loadf = load.to(torch.float32)
    active = loadf[kmask]
    maxl = active.max()
    minl = active.min()
    bal = (maxl - loadf) / ((eps + maxl) - minl)
    score = fma_f32(lam.expand_as(bal), bal, g)
    score = torch.where(kmask, score, float("-inf"))
    return int(torch.argmax(score))


def _insert_steps(load, rep, pd, lam, kmask, src, dst, *, mode, eps):
    """Sequential insert scan over every entry of the chunk, in place on
    ``load``/``rep``/``pd``; returns the parts (``-1`` for self-loops)."""
    eps = torch.tensor(eps, dtype=torch.float32)
    parts = []
    for u, v in zip(src.tolist(), dst.tolist()):
        if mode == "hdrf":
            pd[u] += 1  # every entry, self-loops and padding included
            pd[v] += 1
            pick = _hdrf_pick(load, rep[u] > 0, rep[v] > 0, int(pd[u]),
                              int(pd[v]), lam, kmask, eps)
        else:
            pick = _greedy_pick(load, rep[u] > 0, rep[v] > 0)
        if u != v:
            load[pick] += 1
            rep[u, pick] += 1
            rep[v, pick] += 1
            parts.append(pick)
        else:
            parts.append(-1)
    return torch.tensor(parts, dtype=torch.int32, device=src.device)


def _retract(load, rep, pd, src, dst, n_valid, parts):
    """Exact inverse of the insert scan's accounting for the first
    ``n_valid`` entries, given their recorded ``parts`` (in place).

    Partial degrees give back every real entry, self-loops included, as the
    insert bumped them; the padding's bumps are a chunk-seam approximation
    of the reference that no retract undoes.  Load and replica counts give
    back only placed edges (``u != v``, ``parts >= 0``).
    """
    real = torch.arange(src.shape[0], device=src.device) < int(n_valid)
    s, d = src.long(), dst.long()
    if pd is not None:
        r = real.to(pd.dtype)
        pd.index_add_(0, s, -r)
        pd.index_add_(0, d, -r)
    w = (real & (src != dst) & (parts >= 0)).to(torch.int32)
    p = parts.clamp(min=0).long()
    load.index_add_(0, p, -w)
    k = rep.shape[1]
    flat = rep.view(-1)
    flat.index_add_(0, s * k + p, -w)
    flat.index_add_(0, d * k + p, -w)


def scoring_chunk_oracle(src, dst, load, rep, pd=None, lam=None, *, mode: str,
                         sign: int = 1, parts=None, n_valid=None,
                         eps: float = _HDRF_EPS, k_active: int | None = None):
    """K3's contract on CPU tensors: one Greedy/HDRF chunk, insert
    (``sign=+1``: every entry, as the reference's ``limit`` is the chunk
    length) or retract (``sign=-1``: the first ``n_valid`` entries with
    their recorded ``parts``).  Updates ``load``/``rep``/``pd`` in place
    and returns ``(parts, load, rep, pd)``; retract echoes ``parts``.
    HDRF scores only the first ``k_active`` partitions (default all).
    """
    k = int(load.shape[0])
    if sign < 0:
        _retract(load, rep, pd if mode == "hdrf" else None, src, dst,
                 n_valid, parts)
        return parts.clone(), load, rep, pd
    kmask = torch.arange(k) < (k if k_active is None else int(k_active))
    lam_t = torch.tensor(0.0 if lam is None else float(lam), dtype=torch.float32)
    out = _insert_steps(load, rep, pd, lam_t, kmask, src, dst, mode=mode,
                        eps=eps)
    return out, load, rep, pd


def scoring_chunk_staged(src, dst, load, rep, pd=None, lam=None, *,
                         mode: str, sign: int = 1, parts=None, n_valid=None,
                         eps: float = _HDRF_EPS, k_active: int | None = None,
                         tile: int | None = None,
                         slot_seed: int | None = None):
    """K3's shared rung in plain torch: :func:`scoring_chunk_oracle`'s
    contract, folded tile by tile (``tile`` edges, :func:`.plan.
    scoring_plan`'s by default).  Per tile: vertex slots, each slot's replica
    row and (HDRF) partial degree gathered; the insert's picks, or the
    retract's recorded parts, applied edge by edge to the staged rows, the
    load vector and the staged degrees; the rows and degrees written back
    whole.  The retract runs the same serial loop, not the oracle's
    vectorised inverse."""
    hdrf = mode == "hdrf"
    k = int(load.shape[0])
    E = int(src.shape[0])
    tile = scoring_plan(k).tile if tile is None else int(tile)
    rng = None if slot_seed is None else np.random.default_rng(slot_seed)
    kmask = torch.arange(k) < (k if k_active is None else int(k_active))
    lam_t = torch.tensor(0.0 if lam is None else float(lam), dtype=torch.float32)
    eps_t = torch.tensor(eps, dtype=torch.float32)
    limit = E if sign > 0 else int(n_valid)
    rec = [] if parts is None else parts.tolist()
    out = []
    us_all, vs_all = src.tolist(), dst.tolist()
    for base in range(0, E, tile):
        us, vs = us_all[base:base + tile], vs_all[base:base + tile]
        vid, slot = _tile_slots(us, vs, rng)
        idx = torch.tensor(vid, dtype=torch.long)
        rows = rep[idx]
        spd = pd[idx] if hdrf else None
        for e, (u, v) in enumerate(zip(us, vs)):
            g = base + e
            su, sv = slot[u], slot[v]
            real = g < limit
            if sign > 0:
                if hdrf:
                    spd[su] += 1  # every entry below limit, before scoring
                    spd[sv] += 1
                    pick = _hdrf_pick(load, rows[su] > 0, rows[sv] > 0,
                                      int(spd[su]), int(spd[sv]), lam_t, kmask,
                                      eps_t)
                else:
                    pick = _greedy_pick(load, rows[su] > 0, rows[sv] > 0)
                placed = u != v
                out.append(pick if placed else -1)
            else:
                pick = max(rec[g], 0)
                if hdrf and real:
                    spd[su] -= 1
                    spd[sv] -= 1
                placed = real and u != v and rec[g] >= 0
            if placed:
                load[pick] += sign
                rows[su, pick] += sign
                rows[sv, pick] += sign
        rep[idx] = rows
        if hdrf:
            pd[idx] = spd
    parts_out = (parts.clone() if sign < 0 else
                 torch.tensor(out, dtype=torch.int32, device=src.device))
    return parts_out, load, rep, pd


def grid_chunk_oracle(load, row, col, n_cols: int, src, dst):
    """G1's contract on CPU tensors: the grid scan over one chunk (insert
    only), in place on ``load``; returns ``(parts, load)``.

    Candidates ``row[u]·c + col[v]`` and ``row[v]·c + col[u]`` do not depend
    on the state, so they are gathered for the whole chunk at once; the
    less-loaded candidate (``cand1`` on ties) takes the edge.
    """
    s, d = src.long(), dst.long()
    cand1 = (row[s] * n_cols + col[d]).tolist()
    cand2 = (row[d] * n_cols + col[s]).tolist()
    ld = load.tolist()
    parts = []
    for u, v, a, b in zip(src.tolist(), dst.tolist(), cand1, cand2):
        pick = a if ld[a] <= ld[b] else b
        if u != v:
            ld[pick] += 1
            parts.append(pick)
        else:
            parts.append(-1)
    load.copy_(torch.tensor(ld, dtype=load.dtype))
    return torch.tensor(parts, dtype=torch.int32, device=src.device), load


# -------------------------------------------------------- scoring oracles


def greedy_init(n_vertices: int, k: int, device="cpu"):
    """(load (k,), rep (V, k) counted replica table)."""
    return (torch.zeros((k,), dtype=torch.int32, device=device),
            torch.zeros((n_vertices, k), dtype=torch.int32, device=device))


def greedy_chunk(carry, src, dst):
    """PowerGraph Greedy over one chunk: ``(carry, parts)``."""
    load, rep = carry
    parts, *_ = scoring_chunk_oracle(src, dst, load, rep, mode="greedy")
    return (load, rep), parts


def greedy_retract_chunk(carry, src, dst, n_valid, parts):
    """Exact inverse of :func:`greedy_chunk`'s accounting for these edges."""
    load, rep = carry
    _retract(load, rep, None, src, dst, n_valid, parts)
    return (load, rep)


def hdrf_init(n_vertices: int, k: int, lam: float = 1.1,
              k_active: int | None = None, device="cpu"):
    """(load, rep counted replica table, pd partial degrees, λ (float32
    scalar), active-partition mask ``arange(k) < k_active``)."""
    if k_active is None:
        k_active = k
    return (torch.zeros((k,), dtype=torch.int32, device=device),
            torch.zeros((n_vertices, k), dtype=torch.int32, device=device),
            torch.zeros((n_vertices,), dtype=torch.int32, device=device),
            torch.tensor(lam, dtype=torch.float32, device=device),
            torch.arange(k, device=device) < k_active)


def hdrf_chunk(carry, src, dst):
    """HDRF (partial-degree variant, as published) over one chunk."""
    load, rep, pd, lam, kmask = carry
    out = _insert_steps(load, rep, pd, lam, kmask, src, dst,
                        mode="hdrf", eps=_HDRF_EPS)
    return carry, out


def hdrf_retract_chunk(carry, src, dst, n_valid, parts):
    """Exact inverse of :func:`hdrf_chunk`'s accounting for these edges."""
    load, rep, pd, _, _ = carry
    _retract(load, rep, pd, src, dst, n_valid, parts)
    return carry


def grid_init(load_k: int, row, col, n_cols: int, device="cpu"):
    """(load, per-vertex hashed row/col, #grid-columns)."""
    def table(x):
        if isinstance(x, torch.Tensor):
            return x.to(device, torch.int32)
        return torch.tensor(np.asarray(x), dtype=torch.int32, device=device)

    return (torch.zeros((load_k,), dtype=torch.int32, device=device),
            table(row), table(col), int(n_cols))


def grid_chunk(carry, src, dst):
    """Grid candidate partitioning, least-loaded pick, over one chunk."""
    load, row, col, c = carry
    parts, _ = grid_chunk_oracle(load, row, col, c, src, dst)
    return carry, parts


def grid_retract_chunk(carry, src, dst, n_valid, parts):
    """Exact inverse of :func:`grid_chunk`'s accounting for these edges."""
    load = carry[0]
    real = torch.arange(src.shape[0], device=src.device) < int(n_valid)
    w = (real & (src != dst) & (parts >= 0)).to(torch.int32)
    load.index_add_(0, parts.clamp(min=0).long(), -w)
    return carry
