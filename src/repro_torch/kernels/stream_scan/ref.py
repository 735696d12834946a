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
"""

from __future__ import annotations

import numpy as np
import torch

from ..._fp32 import fma_f32

__all__ = [
    "cluster_chunk_oracle",
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
