"""Streaming vertex-cut baselines the paper compares against (§6.2).

All are single-pass streaming partitioners over the same edge-stream
contract as S5P; each returns ``(E,)`` int32 parts on its device (default
``cuda``; ``device="cpu"`` runs the plain versions).

- Hash:   p = h(eid) mod k                                    [random]
- DBH:    hash the lower-(global-)degree endpoint             [Xie et al. 2014]
- Grid:   candidate cells = row∪col of each endpoint's hashed
          cell; pick the least-loaded intersection cell       [GraphBuilder 2013]
          — the G1 kernel on the card
- Greedy: PowerGraph's 4-case replica-aware heuristic         [Gonzalez 2012]
- HDRF:   degree-weighted replica score + balance term        [Petroni 2015]
          — both the K3 kernel on the card
- 2PS-L-style: global-degree clustering (K1) + linear cluster
          placement + streaming second pass (K2)              [Mayer 2022]
- CLUGP-style: local-degree clustering + ONE-stage
          simultaneous cluster game + postprocess             [Kong 2022]

Bit for bit the reference's ``repro.core.baselines``.  The uint32 hashing
is done as ``core/cms.py`` does it: uint32 values in int64 masked to 32
bits, products by :func:`repro_torch.random.mul32`.  Parallel ingest
(``num_streams > 1``), the vmapped batched engines
(``hdrf_partition_batched``, ``grid_partition_multi_seed``) and file
streams wait for slice 4 of the port.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._device import resolve_device
from ..kernels import stream_scan as _scan
from ..random import M32, mul32
from ..streaming import as_stream, run_carry
from . import clustering as _cl
from . import postprocess as _post
from .s5p import S5PConfig, _as_int32, s5p_partition

__all__ = [
    "hash_partition",
    "dbh_partition",
    "grid_partition",
    "greedy_partition",
    "hdrf_partition",
    "two_ps_partition",
    "clugp_partition",
    "PARTITIONERS",
    "S5P_BASED",
]

_GOLD = 0x9E3779B1


def _hash32(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """The reference's 32-bit mix of int32 ids (uint32 values in int64)."""
    h = mul32(x.to(torch.int64) & M32, _GOLD) ^ ((seed * 0x85EBCA6B + 1) % 2**32)
    h = h ^ (h >> 15)
    h = mul32(h, 0x2C1B3C6D)
    return h ^ (h >> 12)


def _edges(src, dst, device):
    dev = resolve_device(device)
    return _as_int32(src, dev), _as_int32(dst, dev)


def hash_partition(src, dst, n_vertices, k, seed=0, *, device=None):
    src, _ = _edges(src, dst, device)
    eid = torch.arange(src.shape[0], dtype=torch.int64, device=src.device)
    return (_hash32(eid, seed) % k).to(torch.int32)


def dbh_partition(src, dst, n_vertices, k, seed=0, *, device=None):
    """Degree-Based Hashing: cut the lower-degree endpoint."""
    src, dst = _edges(src, dst, device)
    deg = _cl.compute_degrees(src, dst, n_vertices)
    s, d = src.long(), dst.long()
    v = torch.where(deg[s] <= deg[d], src, dst)
    return (_hash32(v, seed) % k).to(torch.int32)


def _grid_dims(k: int) -> tuple[int, int]:
    r = int(math.isqrt(k))
    while k % r:
        r -= 1
    return r, k // r


def _grid_rowcol(n_vertices, k, c, seed, device):
    ids = torch.arange(n_vertices, dtype=torch.int64, device=device)
    cell = (_hash32(ids, seed) % k).to(torch.int32)
    return cell // c, cell % c


def _stream(src, dst, n_vertices, stream, chunk_size, num_streams,
            super_chunk, shard, device):
    _cl._check_sequential(num_streams, super_chunk, shard)
    return as_stream(src, dst, n_vertices, stream=stream,
                     chunk_size=chunk_size, device=device)


def grid_partition(src, dst, n_vertices, k, seed=0, *, stream=None,
                   chunk_size=None, num_streams=1, super_chunk=8,
                   shard="range", device=None):
    """Grid/constrained candidate partitioning, sequential least-loaded pick.

    Candidate set: grid intersection of u's row/col with v's — cells
    (row_u, col_v) and (row_v, col_u); degenerate → own cell.
    """
    st = _stream(src, dst, n_vertices, stream, chunk_size, num_streams,
                 super_chunk, shard, device)
    _, c = _grid_dims(k)
    row, col = _grid_rowcol(n_vertices, k, c, seed, st.device)
    parts, _ = run_carry(st, _scan.GridCarry(k, row, col, c, device=st.device))
    return parts


def greedy_partition(src, dst, n_vertices, k, seed=0, *, stream=None,
                     chunk_size=None, num_streams=1, super_chunk=8,
                     shard="range", device=None):
    """PowerGraph Greedy: 4-case replica-aware assignment."""
    st = _stream(src, dst, n_vertices, stream, chunk_size, num_streams,
                 super_chunk, shard, device)
    parts, _ = run_carry(st, _scan.GreedyCarry(n_vertices, k, device=st.device))
    return parts


def hdrf_partition(src, dst, n_vertices, k, seed=0, lam: float = 1.1, *,
                   stream=None, chunk_size=None, num_streams=1,
                   super_chunk=8, shard="range", device=None):
    """High-Degree Replicated First (partial-degree variant, as published)."""
    st = _stream(src, dst, n_vertices, stream, chunk_size, num_streams,
                 super_chunk, shard, device)
    pc = _scan.HdrfCarry(n_vertices, k, lam, device=st.device)
    parts, _ = run_carry(st, pc)
    return parts


def two_ps_partition(src, dst, n_vertices, k, seed=0, *, device=None):
    """2PS-L-style: global-degree streaming clustering, then linear
    cluster placement (first-fit decreasing) + streaming second pass."""
    src, dst = _edges(src, dst, device)
    E = int(src.shape[0])
    deg = _cl.compute_degrees(src, dst, n_vertices)
    kappa = max(int(math.ceil(2.0 * E / k)), 2)
    # xi = -1 ⇒ every edge is a 'head' edge ⇒ single global-degree table
    state = _cl.cluster_stream(src, dst, n_vertices, xi=-1, kappa=kappa,
                               device=src.device)
    res = _cl.compact_clusters(state, deg, -1)
    cu = res.v2c[src.long()].clamp(min=0)  # every vertex has a head cluster
    cv = res.v2c[dst.long()].clamp(min=0)
    # cluster sizes in edges (by source attribution): float32 in the
    # reference (a segment sum of ones), integers below 2**24 either way
    n_c = max(res.n_clusters, 1)
    csize = torch.bincount(cu.long(), minlength=n_c).cpu().numpy()
    # first-fit decreasing placement under capacity τ|E|/k, on the host
    # as in the reference
    cap = math.ceil(1.05 * E / k)
    order = np.argsort(-csize, kind="stable")
    c2p = np.zeros(n_c, np.int32)
    loads = [0] * k
    sizes = csize.tolist()
    for c in order.tolist():
        cs = sizes[c]
        p = next((j for j in range(k) if loads[j] + cs <= cap), None)
        if p is None:
            p = loads.index(min(loads))  # least loaded, lowest id on ties
        c2p[c] = p
        loads[p] += cs
    # streaming second pass: the less-loaded endpoint partition under the
    # hard cap (the Alg. 3 scan)
    max_load = int(math.ceil(1.0 * E / k))
    parts, _ = _post.assign_edges_stream(
        src, dst, torch.zeros(E, dtype=torch.bool, device=src.device), cu, cv,
        torch.from_numpy(c2p).to(src.device), k, max_load, device=src.device)
    return parts


def clugp_partition(src, dst, n_vertices, k, seed=0, *, device=None,
                    full_output=False):
    """CLUGP-style: local-degree clustering + one-stage simultaneous game,
    realised as S5P with ``one_stage=True`` and ξ = ∞ (every edge takes
    the local-degree tail path)."""
    cfg = S5PConfig(k=k, beta=float(2**30), one_stage=True, use_cms=False,
                    seed=seed)
    out = s5p_partition(src, dst, n_vertices, cfg, device=device)
    return out if full_output else out.parts


def _s5p(src, dst, n_vertices, k, seed=0, *, stream=None, chunk_size=None,
         num_streams=1, super_chunk=8, shard="range", device=None,
         full_output=False):
    cfg = S5PConfig(k=k, seed=seed, chunk_size=chunk_size or 1 << 16,
                    num_streams=num_streams, super_chunk=super_chunk,
                    shard=shard)
    out = s5p_partition(src, dst, n_vertices, cfg, stream=stream, device=device)
    return out if full_output else out.parts


def _s5p_exact(src, dst, n_vertices, k, seed=0, *, stream=None,
               chunk_size=None, num_streams=1, super_chunk=8, shard="range",
               device=None, full_output=False):
    cfg = S5PConfig(k=k, use_cms=False, seed=seed,
                    chunk_size=chunk_size or 1 << 16,
                    num_streams=num_streams, super_chunk=super_chunk,
                    shard=shard)
    out = s5p_partition(src, dst, n_vertices, cfg, stream=stream, device=device)
    return out if full_output else out.parts


# the rows that run S5P's pipeline: ``full_output=True`` returns its
# ``S5POutput`` (clusters, game rounds, per-phase seconds) for them
S5P_BASED = ("clugp", "s5p", "s5p-exact")

PARTITIONERS = {
    "hash": hash_partition,
    "dbh": dbh_partition,
    "grid": grid_partition,
    "greedy": greedy_partition,
    "hdrf": hdrf_partition,
    "2ps-l": two_ps_partition,
    "clugp": clugp_partition,
    "s5p": _s5p,
    "s5p-exact": _s5p_exact,
}
