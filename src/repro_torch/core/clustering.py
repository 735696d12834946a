"""Skewness-aware streaming graph clustering (paper Algorithm 1).

Each edge is classified *head* (both endpoints have global degree > ξ) or
*tail* and drives an allocate/migrate update on one of two vertex→cluster
tables: ``v2c_h`` with volumes in global-degree units, ``v2c_t`` with
volumes in local-degree units (global degrees under S5P-B's
``global_tail``).  Migration moves the lighter endpoint into the other
cluster when both stay under the volume cap κ.

The state is the 10-leaf :class:`ClusterState` of ``repro.core.clustering``
(int32 tensors; the volume arrays have a trailing sink slot).  On CUDA the
fold runs in the K1 kernel (``kernels/stream_scan``); on the CPU in
:func:`cluster_chunk`, a sequential transcription of the kernel's
statement order.  Both update the state in place.  Deleted edges retract
through :func:`cluster_retract_chunk`, order-independent integer sums in
plain torch (as the reference computes them outside any Pallas kernel).
``cluster_stream`` ingests S lanes at once through
``run_parallel`` (``num_streams > 1``), merging the lanes' states by
:attr:`ClusterCarry.merge_ops`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from ..kernels.stream_scan import kernel as _scan
from ..streaming import COUNTED, SUM, PartitionerCarry, as_stream, run_parallel

__all__ = [
    "ClusterState",
    "ClusterResult",
    "ClusterCarry",
    "DegreeCarry",
    "init_state",
    "cluster_chunk",
    "cluster_retract_chunk",
    "cluster_stream",
    "compute_degrees",
    "compute_degrees_stream",
    "compact_clusters",
]


class ClusterState(NamedTuple):
    """Carry of the clustering fold.  All tensors int32, O(|V|)."""

    v2c_h: torch.Tensor  # (V,) -1 = unassigned
    v2c_t: torch.Tensor  # (V,) -1 = unassigned
    vol_h: torch.Tensor  # (V + 1,) head-cluster volumes; slot V is a sink
    vol_t: torch.Tensor  # (V + 1,) tail-cluster volumes; slot V is a sink
    ld: torch.Tensor  # (V,) streaming local degree
    next_h: torch.Tensor  # () next head cluster id
    next_t: torch.Tensor  # () next tail cluster id
    cnt_h: torch.Tensor  # (V,) counted head-edge incidences
    cnt_t: torch.Tensor  # (V,) counted tail-edge incidences
    alloc_h: torch.Tensor  # (V,) vol_h contribution added at allocation

    def effective(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(v2c_h, v2c_t) with dead entries (counter <= 0 or id out of
        range) projected to -1."""
        ok_h = (self.cnt_h > 0) & (self.v2c_h >= 0) & (self.v2c_h < self.next_h)
        ok_t = (self.cnt_t > 0) & (self.v2c_t >= 0) & (self.v2c_t < self.next_t)
        neg = torch.full_like(self.v2c_h, -1)
        return torch.where(ok_h, self.v2c_h, neg), torch.where(ok_t, self.v2c_t, neg)


class ClusterResult(NamedTuple):
    """Compacted output of clustering (input to the Stackelberg game)."""

    v2c: torch.Tensor  # (V,) combined id of each vertex's primary cluster
    v2c_h: torch.Tensor  # (V,) head cluster id, combined space (-1 if none)
    v2c_t: torch.Tensor  # (V,) tail cluster id, combined space (-1 if none)
    n_head: int  # head clusters are ids [0, n_head)
    n_clusters: int  # tail clusters are ids [n_head, n_clusters)
    is_head_vertex: torch.Tensor  # (V,) bool


def init_state(n_vertices: int, device=None) -> ClusterState:
    dev = resolve_device(device)
    v = int(n_vertices)

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.int32, device=dev)

    return ClusterState(
        v2c_h=full((v,), -1), v2c_t=full((v,), -1),
        vol_h=full((v + 1,), 0), vol_t=full((v + 1,), 0), ld=full((v,), 0),
        next_h=full((), 0), next_t=full((), 0),
        cnt_h=full((v,), 0), cnt_t=full((v,), 0), alloc_h=full((v,), 0),
    )


def _w32(x: int) -> int:
    """Wrap a Python int to int32, as the reference's int32 adds do."""
    return ((x + 2**31) & 0xFFFFFFFF) - 2**31


class _Lists:
    """The state as Python lists, for the sequential plain version."""

    def __init__(self, state: ClusterState):
        (self.v2c_h, self.v2c_t, self.vol_h, self.vol_t, self.ld,
         _, _, self.cnt_h, self.cnt_t, self.alloc_h) = (
            t.tolist() if t.dim() else None for t in state)
        self.next_h = int(state.next_h)
        self.next_t = int(state.next_t)

    def write_back(self, state: ClusterState) -> None:
        for name, t in zip(ClusterState._fields, state):
            t.copy_(torch.tensor(getattr(self, name), dtype=torch.int32))


def _rd(vol: list, c: int) -> int:
    """``vol[c]`` as the reference's gather reads it: clamped to the last
    slot (only merged lanes hand out ids past ``V``)."""
    return vol[min(c, len(vol) - 1)]


def _add(vol: list, c: int, x: int) -> None:
    """``vol.at[c].add(x)``: an id past the last slot is dropped."""
    if c < len(vol):
        vol[c] = _w32(vol[c] + x)


def _edge_step(s: _Lists, u: int, v: int, real: bool, *, deg, xi: int,
               kappa: int, global_tail: bool) -> None:
    """One Algorithm-1 step, in the reference kernel's statement order.

    Masked writes of the reference add zero to the sink slot and are
    skipped here, which leaves every slot bit-identical.  Cluster ids past
    the volume arrays (parallel lanes whose merged id counters passed
    ``V``) read the last slot and drop their writes, as XLA's gathers and
    scatters do.
    """
    du = deg[u]
    dv = deg[v]
    is_head = du > xi and dv > xi
    valid = real and u != v

    # ---------------- head branch (global-degree volumes) ----------------
    if is_head and valid:
        cu, cv = s.v2c_h[u], s.v2c_h[v]
        new_u, new_v = cu < 0, cv < 0
        cu2 = s.next_h if new_u else cu
        s.next_h = _w32(s.next_h + int(new_u))
        cv2 = s.next_h if new_v else cv
        s.next_h = _w32(s.next_h + int(new_v))
        vol = s.vol_h
        if new_u:
            _add(vol, cu2, du)
        if new_v:
            _add(vol, cv2, dv)
        s.cnt_h[u] = _w32(s.cnt_h[u] + 1)
        s.cnt_h[v] = _w32(s.cnt_h[v] + 1)
        if new_u:
            s.alloc_h[u] = _w32(s.alloc_h[u] + du)
        if new_v:
            s.alloc_h[v] = _w32(s.alloc_h[v] + dv)
        s.v2c_h[u] = cu2
        s.v2c_h[v] = cv2
        vu, vv = _rd(vol, cu2), _rd(vol, cv2)
        both_small = vu < kappa and vv < kappa and cu2 != cv2
        u_is_i = _w32(vu - du) <= _w32(vv - dv)  # tie -> u
        ci, cj = (cu2, cv2) if u_is_i else (cv2, cu2)
        i_vtx, di = (u, du) if u_is_i else (v, dv)
        if both_small and _w32(_rd(vol, cj) + di) < kappa:
            _add(vol, cj, di)
            _add(vol, ci, -di)
            s.v2c_h[i_vtx] = cj

    # ---------------- tail branch (local-degree volumes) -----------------
    if not is_head and valid:
        tu, tv = s.v2c_t[u], s.v2c_t[v]
        tnew_u, tnew_v = tu < 0, tv < 0
        tu2 = s.next_t if tnew_u else tu
        s.next_t = _w32(s.next_t + int(tnew_u))
        tv2 = s.next_t if tnew_v else tv
        s.next_t = _w32(s.next_t + int(tnew_v))
        vol = s.vol_t
        if global_tail:
            if tnew_u:
                _add(vol, tu2, du)
            if tnew_v:
                _add(vol, tv2, dv)
        else:  # lines 14-15: vol(·) and ld(·) += 1 for both endpoints
            _add(vol, tu2, 1)
            _add(vol, tv2, 1)
            s.ld[u] = _w32(s.ld[u] + 1)
            s.ld[v] = _w32(s.ld[v] + 1)
        s.v2c_t[u] = tu2
        s.v2c_t[v] = tv2
        s.cnt_t[u] = _w32(s.cnt_t[u] + 1)
        s.cnt_t[v] = _w32(s.cnt_t[v] + 1)
        tvu, tvv = _rd(vol, tu2), _rd(vol, tv2)
        t_small = tvu < kappa and tvv < kappa and tu2 != tv2
        tu_is_i = tvu <= tvv  # tie -> u
        tci, tcj = (tu2, tv2) if tu_is_i else (tv2, tu2)
        ti = u if tu_is_i else v
        ldi = deg[ti] if global_tail else s.ld[ti]
        t_mig = t_small
        if global_tail:
            t_mig = t_mig and _w32(_rd(vol, tcj) + ldi) < kappa
        if t_mig:
            _add(vol, tcj, ldi)
            _add(vol, tci, -ldi)
            s.v2c_t[ti] = tcj


def cluster_chunk(state: ClusterState, src, dst, degrees, *, xi: int,
                  kappa: int, global_tail: bool = False) -> ClusterState:
    """Process one chunk through Algorithm 1, sequentially (plain version).

    Updates ``state``'s tensors in place and returns it.  ``limit`` is the
    chunk's full length, as in the kernel.
    """
    s = _Lists(state)
    deg = degrees.tolist()
    for u, v in zip(src.tolist(), dst.tolist()):
        _edge_step(s, u, v, True, deg=deg, xi=int(xi), kappa=int(kappa),
                   global_tail=bool(global_tail))
    s.write_back(state)
    return state


def cluster_retract_chunk(state: ClusterState, src, dst, n_valid, degrees=None, *,
                          xi: int | None = None, is_head=None) -> ClusterState:
    """Retract one chunk of deleted edges from the clustering state (the
    reference's ``cluster_retract_chunk``): a new state, the input's
    tensors untouched.

    Membership counters and local degrees subtract exactly; a tail edge
    takes one unit of volume per endpoint from the vertex's *current* tail
    cluster; a head vertex whose counter reaches 0 hands its allocation
    contribution back to its head cluster and becomes unassigned, a tail
    vertex likewise (its volume already went per incidence).  ``is_head``
    is the per-edge head flag recorded at insertion, else the frozen-ξ
    classification against ``degrees``.  Every sum is an int32
    ``index_add_``, exact in any order; an update whose cluster id lies
    past the volume arrays is dropped, as the reference's scatters drop it.
    """
    if is_head is None:
        if degrees is None or xi is None:
            raise ValueError("need either is_head flags or (degrees, xi)")
        is_head = (degrees[src.long()] > xi) & (degrees[dst.long()] > xi)
    dev = state.ld.device
    V = state.ld.shape[0]
    n_vol = state.vol_h.shape[0]
    sink = n_vol - 1
    src = src.to(dev)
    dst = dst.to(dev)
    s, d = src.long(), dst.long()
    real = torch.arange(src.shape[0], device=dev) < int(n_valid)
    valid = real & (src != dst)
    is_head = is_head.to(dev, torch.bool)
    h = (valid & is_head).to(torch.int32)
    t = (valid & ~is_head).to(torch.int32)

    def seg(w, idx):
        return torch.zeros(V, dtype=torch.int32, device=dev).index_add_(0, idx, w)

    cnt_h = state.cnt_h - seg(h, s) - seg(h, d)
    cnt_t = state.cnt_t - seg(t, s) - seg(t, d)
    ld = state.ld - seg(t, s) - seg(t, d)

    def scatter_add(vol, idx, on, w):
        """``vol.at[where(on, idx, sink)].add(where(on, w, 0))``, dropping
        ids past the array."""
        on = on & (idx < n_vol)
        at = torch.where(on, idx, torch.full_like(idx, sink)).long()
        return vol.index_add(0, at, torch.where(on, w, torch.zeros_like(w)))

    vol_t = state.vol_t
    for vtx in (s, d):
        c = state.v2c_t[vtx]
        vol_t = scatter_add(vol_t, c, (t > 0) & (c >= 0), torch.full_like(c, -1))
    orphan = (cnt_h <= 0) & (state.cnt_h > 0) & (state.v2c_h >= 0)
    vol_h = scatter_add(state.vol_h, state.v2c_h, orphan, -state.alloc_h)
    zero = torch.zeros_like(state.alloc_h)
    alloc_h = torch.where(orphan, zero, state.alloc_h)
    v2c_h = torch.where(orphan, zero - 1, state.v2c_h)
    orphan_t = (cnt_t <= 0) & (state.cnt_t > 0) & (state.v2c_t >= 0)
    v2c_t = torch.where(orphan_t, zero - 1, state.v2c_t)
    return ClusterState(
        v2c_h=v2c_h, v2c_t=v2c_t, vol_h=vol_h, vol_t=vol_t, ld=ld,
        next_h=state.next_h.clone(), next_t=state.next_t.clone(),
        cnt_h=cnt_h, cnt_t=cnt_t, alloc_h=alloc_h)


class ClusterCarry(PartitionerCarry):
    """Algorithm 1 as a carry (state-only).  Each chunk goes through
    ``cluster_scan``: K1 on CUDA, the plain fold on the CPU; a retraction
    through :func:`cluster_retract_chunk` (approximate: see there).

    Merge ops as the reference declares them: volumes, local degrees and
    id counters SUM their lanes' deltas; the membership counters are
    COUNTED; the two vertex → cluster tables SUM too but are
    ``pick_first``, so a vertex two lanes reassigned in one super-chunk
    keeps the lowest lane's (real) id instead of a telescoped sum."""

    emits_parts = False
    supports_retract = True
    retract_exact = False  # migrations are history-dependent
    # v2c_h, v2c_t, vol_h, vol_t, ld, next_h, next_t, cnt_h, cnt_t, alloc_h
    merge_ops = (SUM, SUM, SUM, SUM, SUM, SUM, SUM, COUNTED, COUNTED, SUM)
    pick_first = (0, 1)

    def __init__(self, degrees: torch.Tensor, n_vertices: int, *, xi: int,
                 kappa: int, global_tail: bool = False):
        self.degrees = degrees
        self.n_vertices = int(n_vertices)
        self.xi = int(xi)
        self.kappa = int(kappa)
        self.global_tail = bool(global_tail)

    def init(self) -> ClusterState:
        return init_state(self.n_vertices, self.degrees.device)

    def step_chunk(self, carry, src, dst, n_valid, *extras):
        leaves = _scan.cluster_scan(tuple(carry), src, dst, self.degrees,
                                    xi=self.xi, kappa=self.kappa,
                                    global_tail=self.global_tail)
        return ClusterState(*leaves), None

    def retract_chunk(self, carry, src, dst, n_valid, parts, *extras):
        return cluster_retract_chunk(carry, src, dst, n_valid, self.degrees,
                                     xi=self.xi)

    def occupancy_contest(self, before, after) -> float:
        """Reassignment churn between merge bases: the fraction of assigned
        vertices whose cluster id moved (assigned → another id) over both
        tables; fresh assignments are growth, not contention."""
        changed = active = 0
        for b, a in ((before.v2c_h, after.v2c_h), (before.v2c_t, after.v2c_t)):
            changed = changed + ((b >= 0) & (a >= 0) & (a != b)).sum()
            active = active + (a >= 0).sum()
        got = torch.stack([changed, active]).tolist()
        return got[0] / max(got[1], 1)


class DegreeCarry(PartitionerCarry):
    """One-pass global degree count as a carry (state-only).  Padding is
    masked by ``n_valid``; real (0, 0) self-loops count twice for vertex 0,
    as in :func:`compute_degrees`."""

    emits_parts = False
    supports_retract = True
    retract_exact = True
    merge_ops = (SUM,)

    def __init__(self, n_vertices: int, device=None):
        self.n_vertices = int(n_vertices)
        self.device = resolve_device(device)

    def init(self) -> torch.Tensor:
        return torch.zeros((self.n_vertices,), dtype=torch.int32,
                           device=self.device)

    def step_chunk(self, carry, src, dst, n_valid, *extras):
        return _degree_chunk(carry, src, dst, n_valid, 1), None

    def retract_chunk(self, carry, src, dst, n_valid, parts, *extras):
        return _degree_chunk(carry, src, dst, n_valid, -1)


def _degree_chunk(deg, src, dst, n_valid, sign):
    w = (torch.arange(src.shape[0], device=src.device) < n_valid).to(torch.int32) * sign
    deg = deg.index_add(0, src.long(), w)
    return deg.index_add(0, dst.long(), w)


def compute_degrees(src: torch.Tensor, dst: torch.Tensor, n_vertices: int) -> torch.Tensor:
    ones = torch.ones_like(src, dtype=torch.int32)
    deg = torch.zeros((int(n_vertices),), dtype=torch.int32, device=src.device)
    deg = deg.index_add(0, src.long(), ones)
    return deg.index_add(0, dst.long(), ones)


def compute_degrees_stream(stream, num_streams: int = 1,
                           super_chunk: int | str = 8, shard: str = "range") -> torch.Tensor:
    """The one-pass degree count, chunk by chunk: bit-identical to
    :func:`compute_degrees` for any ``num_streams``, ``super_chunk`` and
    ``shard`` (integer sums commute)."""
    _, deg = run_parallel(stream, DegreeCarry(stream.n_vertices, stream.device),
                          num_streams=num_streams, super_chunk=super_chunk,
                          shard=shard)
    return deg


def cluster_stream(src, dst, n_vertices: int, *, xi: int, kappa: int,
                   chunk_size: int = 1 << 16, global_tail: bool = False,
                   stream=None, num_streams: int = 1, super_chunk=8,
                   shard: str = "range", device=None) -> ClusterState:
    """Run Algorithm 1 over the whole stream in fixed-size chunks.

    Degrees are the one-pass global precompute (a chunked pass over an
    out-of-core stream).  Runs on ``stream.device``
    when a stream is given, else on ``device`` (default ``cuda``).
    ``num_streams > 1`` ingests S lanes (``shard``) merged every
    ``super_chunk`` chunks (``run_parallel``); 1 is the sequential fold.
    """
    stream = as_stream(src, dst, n_vertices, stream=stream,
                       chunk_size=chunk_size, device=device)
    dev = stream.device
    # a stream without host arrays (out of core) counts degrees chunk by
    # chunk: integer sums, so the same bits
    src_full = getattr(stream, "src", None)
    if src_full is not None:
        degrees = compute_degrees(torch.from_numpy(src_full).to(dev),
                                  torch.from_numpy(stream.dst).to(dev),
                                  stream.n_vertices)
    else:
        degrees = compute_degrees_stream(stream)
    pc = ClusterCarry(degrees, stream.n_vertices, xi=xi, kappa=kappa,
                      global_tail=global_tail)
    _, state = run_parallel(stream, pc, num_streams=num_streams,
                            super_chunk=super_chunk, shard=shard)
    return state


def compact_clusters(state: ClusterState, degrees: torch.Tensor, xi: int) -> ClusterResult:
    """Renumber head/tail clusters into one dense combined id space (host
    numpy, as in the reference): head ids [0, n_head), tail ids after."""
    dev = degrees.device
    eff_h, eff_t = state.effective()
    v2c_h = eff_h.cpu().numpy()
    v2c_t = eff_t.cpu().numpy()
    deg = degrees.cpu().numpy()

    used_h = np.unique(v2c_h[v2c_h >= 0])
    used_t = np.unique(v2c_t[v2c_t >= 0])
    remap_h = np.full(int(state.next_h) + 1, -1, np.int32)
    remap_h[used_h] = np.arange(used_h.size, dtype=np.int32)
    remap_t = np.full(int(state.next_t) + 1, -1, np.int32)
    remap_t[used_t] = np.arange(used_t.size, dtype=np.int32) + used_h.size

    out_h = np.where(v2c_h >= 0, remap_h[np.maximum(v2c_h, 0)], -1).astype(np.int32)
    out_t = np.where(v2c_t >= 0, remap_t[np.maximum(v2c_t, 0)], -1).astype(np.int32)
    primary = np.where(out_h >= 0, out_h, out_t).astype(np.int32)

    return ClusterResult(
        v2c=torch.from_numpy(primary).to(dev),
        v2c_h=torch.from_numpy(out_h).to(dev),
        v2c_t=torch.from_numpy(out_t).to(dev),
        n_head=int(used_h.size),
        n_clusters=int(used_h.size + used_t.size),
        is_head_vertex=torch.from_numpy(deg > xi).to(dev),
    )
