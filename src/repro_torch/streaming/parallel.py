"""Parallel ingest: one logical EdgeStream sharded into S lanes.

The port of ``repro.streaming.parallel``.  S lanes each fold a disjoint
share of the stream into their own copy of a
:class:`~repro_torch.streaming.carry.PartitionerCarry`, and the copies are
merged by the carry's declared merge ops once per *super-chunk*.

:class:`ParallelEdgeStream` is the plan, bit for bit the reference's:

- ``"range"``       — lane s scans chunks ``[s·⌈C/S⌉, (s+1)·⌈C/S⌉)``;
- ``"round-robin"`` — chunk i goes to lane ``i mod S`` (alias ``"rr"``);
- ``"hub"``         — edge-granular: an online CMS degree sketch (K4a/K4b
  on the card, two launches of each a stream chunk) classifies each
  edge's higher-degree endpoint as hub or tail; a hub's edges all go to
  its rendezvous-hashed lane, tail vertices are dealt round-robin, and
  each lane's edges (in stream order) are packed into fixed-size chunks.
  A hub plan is a pure function of the stream, so it is built once per
  (S, threshold) and kept in the stream's ``plans``.

``super_chunk`` is a chunk count or ``"auto"`` (:class:`_CadenceController`:
parts-emitting carries merge every chunk while the replica tables are
contested and back off geometrically; state-only carries fold in
isolation and merge once).  :func:`last_ingest_stats` returns what the
last drive did (schedule, per-lane chunks, edges and seconds).

:func:`run_parallel` has three backends, equal bit for bit on one plan:

- ``"threads"`` (default) — one host thread a lane.  On the card each lane
  issues on its own ``torch.cuda.Stream``, so the lanes' one-block serial
  scans (K1–K3, G1) run side by side; the kernels are bound through
  ``ctypes``, which releases the GIL while a launch is issued.  On the CPU
  the lanes fold one after another in the caller's thread (the plain
  versions hold the GIL; the merges are the same).  Each lane
  starts a super-chunk from its own clone of the merge base (the carries
  update in place), and the merge waits for every lane's stream.
- ``"vmap"`` — the reference's batched lanes: the carry stacked ``(S, …)``,
  each active lane stepped on its row, then one ``merge_stacked``.
- ``"shard_map"`` (the reference's name) — one lane a rank of a
  ``torch.distributed`` world (SPMD: every rank calls ``run_parallel`` with
  the same arguments): a rank stages and folds only its lane's chunks, the
  lanes merge through ``merge_collective`` at every super-chunk, and the
  parts are all-gathered, so every rank returns the same parts and carry.
  ``mesh`` is a one-dimensional ``DeviceMesh`` S ranks wide; without one,
  the default group must be S ranks wide.  It is the default when a
  process group is up and S ranks wide (the reference's rule, ranks for
  devices), ``threads`` otherwise.

``num_streams=1`` (or a one-chunk stream) runs the sequential driver and
is bit-identical to it in every shard mode.
``on_lane_failure="replay"`` re-folds a failed lane's super-chunk from the
merge base: the in-memory one, or with a ``carry_store``
(:class:`~repro_torch.incremental.CarryStore`) the one checkpointed at
every merge, restored from disk.  A ``straggler`` monitor
(:class:`~repro_torch.runtime.StragglerMonitor`) gets each lane's time per
chunk at every merge, and its ``rebalance_plan`` moves a tail cut of each
straggler lane's remaining chunks to the fastest lane (hub mode: at a
whole-hub boundary, the moved hubs' ``pin_map`` entries with them).  The
lanes share one card, so a lane's time includes the others' contention.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from .carry import (GROUP_OPS, MAX, OR, REPLICATED, PartitionerCarry, _check_ops,
                    tree_flatten, tree_unflatten)
from .engine import rows_of, run_carry, write_row
from .stream import Chunk, EdgeStream

__all__ = ["ParallelEdgeStream", "run_parallel", "IngestStats", "LaneStats",
           "last_ingest_stats", "reset_cadence_log"]

log = logging.getLogger(__name__)

SHARD_MODES = ("range", "round-robin", "hub")
_SHARD_ALIASES = {"rr": "round-robin"}
LANE_FAILURE_MODES = ("raise", "replay")
BACKENDS = ("threads", "vmap", "shard_map")

#: adaptive cadence: merge every chunk while the per-merge occupancy delta
#: exceeds WARM, then back off 1 → 2 → 4 → … up to CAP chunks
AUTO_CADENCE_WARM = 0.05
AUTO_CADENCE_CAP = 32

#: "merge once at the end" (every backend clamps to the rounds left)
ISOLATE_CADENCE = 1 << 30


# ---------------------------------------------------------------------------
# observability
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LaneStats:
    """One lane's share of a ``run_parallel`` drive."""

    chunks: int
    edges: int
    merge_count: int
    wall_s: float


@dataclasses.dataclass(frozen=True)
class IngestStats:
    """What one ``run_parallel`` drive did.  ``schedule`` is the realized
    cadence (chunks a lane between merges); ``wall_s`` is each lane's fold
    time on the threads backend (its stream synchronised), the shared
    loop time on ``vmap``."""

    num_streams: int
    shard: str
    backend: str
    super_chunk: int | str
    schedule: tuple[int, ...]
    lanes: tuple[LaneStats, ...]

    def as_dict(self) -> dict:
        return {
            "num_streams": self.num_streams,
            "shard": self.shard,
            "backend": self.backend,
            "super_chunk": self.super_chunk,
            "schedule": list(self.schedule),
            "lanes": [dataclasses.asdict(lane) for lane in self.lanes],
        }


_last_stats: IngestStats | None = None
_logged_schedules: set[tuple] = set()


def last_ingest_stats() -> IngestStats | None:
    """Stats of the most recent :func:`run_parallel` drive (the sequential
    ``num_streams=1`` delegation included)."""
    return _last_stats


def reset_cadence_log() -> None:
    """Re-arm the once-per-run cadence-schedule logging."""
    _logged_schedules.clear()


def _compress_schedule(schedule) -> str:
    """``[1,1,1,2,4,8,8]`` → ``"1×3,2,4,8×2"`` (:data:`ISOLATE_CADENCE`
    renders as ``"all"``)."""
    out, i = [], 0
    schedule = ["all" if c == ISOLATE_CADENCE else c for c in schedule]
    while i < len(schedule):
        j = i
        while j < len(schedule) and schedule[j] == schedule[i]:
            j += 1
        out.append(str(schedule[i]) if j - i == 1 else f"{schedule[i]}×{j - i}")
        i = j
    return ",".join(out)


def _log_schedule(consumer: str, stats: IngestStats) -> None:
    key = (consumer, stats.shard, stats.super_chunk, stats.schedule)
    if key in _logged_schedules:
        return
    _logged_schedules.add(key)
    log.info("ingest %s: S=%d shard=%s super_chunk=%s → cadence [%s] "
             "(%d merges)", consumer, stats.num_streams, stats.shard,
             stats.super_chunk, _compress_schedule(stats.schedule),
             len(stats.schedule))


class _CadenceController:
    """The merge cadence.  A fixed ``super_chunk`` repeats; ``"auto"``
    starts at 1 for parts-emitting carries, doubles while a merge's
    occupancy contest stays under :data:`AUTO_CADENCE_WARM` and re-arms to
    1 above it; state-only carries isolate (one merge at the end)."""

    def __init__(self, pc: PartitionerCarry, super_chunk: int | str):
        self.pc = pc
        self.auto = super_chunk == "auto"
        self.isolate = self.auto and not pc.emits_parts
        if self.isolate:
            self.cadence = ISOLATE_CADENCE
        else:
            self.cadence = 1 if self.auto else int(super_chunk)
        self.schedule: list[int] = []

    def next(self) -> int:
        self.schedule.append(self.cadence)
        return self.cadence

    def observe(self, prev_base, new_base) -> None:
        if not self.auto or self.isolate:
            return
        contest = self.pc.occupancy_contest(prev_base, new_base)
        if contest > AUTO_CADENCE_WARM:
            self.cadence = 1
        else:
            self.cadence = min(self.cadence * 2, AUTO_CADENCE_CAP)


# ---------------------------------------------------------------------------
# sharding plan
# ---------------------------------------------------------------------------


def _rendezvous_lanes(v: np.ndarray, S: int) -> np.ndarray:
    """Highest-random-weight lane per vertex id: ``argmax_s h(v, s)`` over
    an avalanche mix, a pure function of the vertex id."""
    with np.errstate(over="ignore"):
        h = (v.astype(np.uint32)[:, None] * np.uint32(0x9E3779B1)) ^ (
            np.arange(S, dtype=np.uint32)[None, :] * np.uint32(0x85EBCA6B))
        h ^= h >> np.uint32(16)
        h *= np.uint32(0x85EBCA6B)
        h ^= h >> np.uint32(13)
        h *= np.uint32(0xC2B2AE35)
        h ^= h >> np.uint32(16)
    return np.argmax(h, axis=1).astype(np.int32)


def _to_device(a: np.ndarray, dev: torch.device, *, pinned: bool = False) -> torch.Tensor:
    """A host array on ``dev``.  ``pinned``: to the card through page-locked
    memory without blocking, so a lane queues its next chunk while its scan
    runs (8 range lanes of Greedy at scale 20 on an H100: 0.68–0.73 s
    against 1.27–1.39 by blocking copies, PERF.md §6); pinning costs more
    than it saves where the host waits for the card anyway (the hub plan)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if pinned and dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def _hub_plan(st: EdgeStream, S: int, threshold: int):
    """The reference's hub plan (``_build_hub_plan``) over ``st``: per stream
    chunk, query the online degree sketch for both endpoints (K4b), route,
    then add the chunk's non-loop endpoints (K4a)."""
    from ..core.cms import cms_query, cms_update, make_sketch, suggest_params, vertex_key

    dev = st.device
    E, V, B = st.n_edges, st.n_vertices, st.chunk_size
    w, d = suggest_params()
    width = w * max(1, int(math.sqrt(max(V, 1))))
    sketch = make_sketch(width, d, seed=st.seed, device=dev)
    lane_of_pos = np.empty(E, np.int32)
    pin_vertex = np.full(E, -1, np.int32)
    tail_lane = np.full(V, -1, np.int32)  # tail vertex → dealt lane
    hub_lane = np.full(V, -1, np.int32)  # rendezvous lane, once a vertex
    pinned = np.zeros(V, bool)  # vertices some edge was pinned by
    rr = 0  # round-robin cursor for newly seen tail vertices
    order = st.order
    for i in range(st.n_chunks):
        lo, hi = i * B, min((i + 1) * B, E)
        sl = slice(lo, hi) if order is None else order[lo:hi]
        s, t = st._edges_at(sl, lo, hi)
        s_dev, t_dev = _to_device(s, dev), _to_device(t, dev)
        key_s, key_t = vertex_key(s_dev), vertex_key(t_dev)
        # query before update: the estimate covers earlier chunks only
        est = torch.stack([cms_query(sketch, key_s), cms_query(sketch, key_t)]).cpu().numpy()
        est_s, est_t = est[0], est[1]
        # the hub endpoint is the higher-degree one (ties to the smaller id)
        s_wins = (est_s > est_t) | ((est_s == est_t) & (s <= t))
        hub_v = np.where(s_wins, s, t)
        is_hub = (np.maximum(est_s, est_t) > threshold) & (s != t)
        lanes_c = np.empty(hi - lo, np.int32)
        hub_idx = np.flatnonzero(is_hub)
        if hub_idx.size:
            hv = hub_v[hub_idx]
            new_hubs = np.unique(hv[hub_lane[hv] < 0])
            hub_lane[new_hubs] = _rendezvous_lanes(new_hubs, S)
            lanes_c[hub_idx] = hub_lane[hv]
            pinned[hv] = True
        # tail edges route by the lower-degree endpoint, each newly seen
        # tail vertex dealt the next lane in first-appearance order
        tail_idx = np.flatnonzero(~is_hub)
        if tail_idx.size:
            tv = np.where(s_wins, t, s)[tail_idx]
            newv = tv[tail_lane[tv] < 0]
            if newv.size:
                _, first = np.unique(newv, return_index=True)
                order_v = newv[np.sort(first)]
                tail_lane[order_v] = (rr + np.arange(order_v.size)) % S
                rr = (rr + order_v.size) % S
            lanes_c[tail_idx] = tail_lane[tv]
        lane_of_pos[lo:hi] = lanes_c
        pin_vertex[lo + hub_idx] = hub_v[hub_idx]
        counts = (s_dev != t_dev).to(torch.int64)
        sketch = cms_update(sketch, key_s, counts)
        sketch = cms_update(sketch, key_t, counts)
    # a hub's lane is a function of its id: every pinned edge of v is on hub_lane[v]
    hubs = np.flatnonzero(pinned)
    pin_map = dict(zip(hubs.tolist(), hub_lane[hubs].tolist()))
    # each lane's positions (stream order) packed into fixed-size chunks
    chunk_pos, lanes = [], []
    for s_ in range(S):
        positions = np.flatnonzero(lane_of_pos == s_)
        lanes.append(list(range(len(chunk_pos), len(chunk_pos) + -(-positions.size // B))))
        chunk_pos += [positions[i:i + B] for i in range(0, positions.size, B)]
    return {"lane_of_pos": lane_of_pos, "pin_vertex": pin_vertex, "pin_map": pin_map,
            "chunk_pos": chunk_pos, "lanes": lanes}


class ParallelEdgeStream:
    """Shard a stream into S lanes (see the module docstring).  Every edge
    belongs to exactly one lane, and a lane's order is stream order."""

    def __init__(self, stream: EdgeStream, num_streams: int, *,
                 shard: str = "range", hub_threshold: int | None = None):
        shard = _SHARD_ALIASES.get(shard, shard)
        if num_streams < 1:
            raise ValueError("num_streams must be >= 1")
        if shard not in SHARD_MODES:
            raise ValueError(f"unknown shard mode {shard!r}; one of {SHARD_MODES}")
        self.stream = stream
        self.shard = shard
        # more lanes than chunks would only add all-padding lanes
        self.num_streams = max(1, min(int(num_streams), stream.n_chunks))
        C, S = stream.n_chunks, self.num_streams
        self._chunk_pos: list[np.ndarray] | None = None  # hub: chunk → positions
        self._lane_of_pos: np.ndarray | None = None
        self._pin_vertex: np.ndarray | None = None
        self.pin_map: dict[int, int] = {}
        self.hub_threshold: int | None = None
        if shard == "range":
            q = -(-C // S)
            self.lanes = [list(range(s * q, min((s + 1) * q, C))) for s in range(S)]
        elif shard == "round-robin":
            self.lanes = [list(range(s, C, S)) for s in range(S)]
        else:
            self._build_hub_plan(hub_threshold)

    # ---------------------------------------------------------- hub plan
    def _build_hub_plan(self, hub_threshold: int | None) -> None:
        st, S = self.stream, self.num_streams
        if type(st)._edges_at is not EdgeStream._edges_at and st.order is not None:
            raise ValueError(
                "shard='hub' needs per-edge gathers; reordered out-of-core "
                "streams serve edges by stream-order ranges only — use "
                "ordering='natural' or an in-memory stream")
        if hub_threshold is None:  # a hub past the average degree
            hub_threshold = max(2, int(2.0 * st.n_edges / max(st.n_vertices, 1)))
        self.hub_threshold = int(hub_threshold)
        key = ("hub", S, self.hub_threshold)
        plan = st.plans.get(key)
        if plan is None:  # never written after: each instance copies its lists
            plan = st.plans[key] = _hub_plan(st, S, self.hub_threshold)
        self._lane_of_pos, self._pin_vertex = plan["lane_of_pos"], plan["pin_vertex"]
        self.pin_map = dict(plan["pin_map"])
        self._chunk_pos = list(plan["chunk_pos"])
        self.lanes = [list(lane) for lane in plan["lanes"]]

    def _register_chunks(self, positions: np.ndarray) -> list[int]:
        """Pack stream positions (ascending: stream order) into new
        fixed-size plan chunks; returns their ids."""
        B = self.stream.chunk_size
        cids = []
        for i in range(0, len(positions), B):
            cids.append(len(self._chunk_pos))
            self._chunk_pos.append(positions[i:i + B])
        return cids

    @property
    def n_hubs(self) -> int:
        return len(self.pin_map)

    def edge_lanes(self) -> np.ndarray:
        """Per-edge lane id in arrival order (the touch-up's provenance)."""
        st = self.stream
        if self.shard == "hub":
            by_pos = self._lane_of_pos
        else:
            B = st.chunk_size
            lane_of_chunk = np.empty(st.n_chunks, np.int32)
            for s, lane in enumerate(self.lanes):
                lane_of_chunk[np.asarray(lane, np.int64)] = s
            by_pos = lane_of_chunk[
                np.minimum(np.arange(st.n_edges) // B, st.n_chunks - 1)]
        if st.order is None:
            return by_pos.astype(np.int32)
        out = np.empty(st.n_edges, np.int32)
        out[np.asarray(st.order)] = by_pos
        return out

    # ------------------------------------------------------------ serving
    @property
    def n_rounds(self) -> int:
        """Lockstep rounds = chunks of the longest lane."""
        return max(len(lane) for lane in self.lanes)

    def chunk_n_valid(self, chunk_id: int) -> int:
        if self._chunk_pos is not None:
            return len(self._chunk_pos[chunk_id])
        cs, E = self.stream.chunk_size, self.stream.n_edges
        return min((chunk_id + 1) * cs, E) - chunk_id * cs

    def chunk_positions(self, chunk_id: int) -> np.ndarray:
        """Stream positions of a plan chunk."""
        if self._chunk_pos is not None:
            return self._chunk_pos[chunk_id]
        B = self.stream.chunk_size
        return np.arange(chunk_id * B, chunk_id * B + self.chunk_n_valid(chunk_id))

    def chunk_for(self, chunk_id: int, *extras) -> Chunk:
        """The plan chunk ``chunk_id``, padded to the stream's chunk size
        with (0, 0) self-loops and zero extras; the stream's own chunk in
        the chunk-granular modes, a gathered one in hub mode."""
        return self.upload(self.stage(chunk_id, *extras))

    def stage(self, chunk_id: int, *extras) -> tuple:
        """The host half of :meth:`chunk_for`: the chunk's edges and host
        extras gathered in numpy (device extras keep their positions)."""
        st = self.stream
        nv = self.chunk_n_valid(chunk_id)
        if self._chunk_pos is None and st.order is None:
            start = chunk_id * st.chunk_size
            arr = slice(start, start + nv)
        else:
            pos = self.chunk_positions(chunk_id)
            start = int(pos[0]) if nv else 0
            arr = pos if st.order is None else np.asarray(st.order)[pos]
        exs = [(e, arr) if isinstance(e, torch.Tensor) else np.asarray(e)[arr]
               for e in extras]
        # a hub chunk's positions are not a range: the hook gathers them
        # (hub plans are refused over reordered out-of-core streams)
        s, d = st._edges_at(arr, start, start + nv)
        return s, d, exs, start, nv

    def upload(self, staged: tuple) -> Chunk:
        """The device half of :meth:`chunk_for`: pad and copy to the
        stream's device, gather device extras there."""
        s, d, exs, start, nv = staged
        st = self.stream
        dev, B = st.device, st.chunk_size
        idx = None
        exc = []
        for e in exs:
            if isinstance(e, tuple):
                e, arr = e
                if isinstance(arr, slice):
                    x = e[arr]
                else:
                    if idx is None:
                        idx = _to_device(np.asarray(arr, np.int64), e.device, pinned=True)
                    x = e.index_select(0, idx)
                exc.append(x.to(dev))
            else:
                exc.append(_to_device(e, dev, pinned=True))
        padn = B - nv
        if padn > 0:
            s = np.concatenate([s, np.zeros(padn, np.int32)])
            d = np.concatenate([d, np.zeros(padn, np.int32)])
            exc = [torch.cat([e, e.new_zeros((padn,) + tuple(e.shape[1:]))])
                   for e in exc]
        return Chunk(src=_to_device(s, dev, pinned=True), dst=_to_device(d, dev, pinned=True),
                     extras=tuple(exc), start=start, n_valid=nv)

    def round_at(self, r: int, *extras):
        """Round r as stacked (S, B) tensors: ``(src, dst, n_valid (S,),
        extras, chunk_ids)``; exhausted lanes get all-padding chunks and a
        ``None`` chunk id."""
        B = self.stream.chunk_size
        dev = self.stream.device
        srcs, dsts, nvs, ids = [], [], [], []
        exs: list[list] = [[] for _ in extras]
        zero = None
        for lane in self.lanes:
            if r < len(lane):
                cid = lane[r]
                ch = self.chunk_for(cid, *extras)
                srcs.append(ch.src)
                dsts.append(ch.dst)
                nvs.append(ch.n_valid)
                for j, e in enumerate(ch.extras):
                    exs[j].append(e)
                ids.append(cid)
            else:
                if zero is None:
                    zero = torch.zeros((B,), dtype=torch.int32, device=dev)
                srcs.append(zero)
                dsts.append(zero)
                nvs.append(0)
                for e in exs:
                    if not e:
                        raise AssertionError("padding lane before any real lane")
                    e.append(torch.zeros_like(e[0]))
                ids.append(None)
        return (torch.stack(srcs), torch.stack(dsts),
                torch.tensor(nvs, dtype=torch.int32, device=dev),
                tuple(torch.stack(e) for e in exs), ids)


# ---------------------------------------------------------------------------
# lanes
# ---------------------------------------------------------------------------


def _carry_device(tree) -> torch.device | None:
    for leaf in tree_flatten(tree)[0]:
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return None


def _lane_copy(pc: PartitionerCarry, base):
    """A lane's private start: the base's group (and monotone) tensor
    leaves cloned, since the carries update in place; REPLICATED leaves
    are read only and shared."""
    flat, spec = tree_flatten(base)
    _check_ops(pc.merge_ops, len(flat))
    return tree_unflatten(spec, [
        x.clone() if isinstance(x, torch.Tensor) and op in GROUP_OPS + (OR, MAX)
        else x for op, x in zip(pc.merge_ops, flat)])


def _stack_lanes(pc: PartitionerCarry, base, S: int):
    """The batched backend's carry: group leaves repeated to (S, …) (rows
    are contiguous), REPLICATED tensors broadcast as views."""
    flat, spec = tree_flatten(base)
    _check_ops(pc.merge_ops, len(flat))
    out = []
    for op, x in zip(pc.merge_ops, flat):
        if not isinstance(x, torch.Tensor):
            out.append(x)
        elif op == REPLICATED:
            out.append(x.unsqueeze(0).expand((S,) + tuple(x.shape)))
        else:
            out.append(x.unsqueeze(0).repeat((S,) + (1,) * x.dim()))
    return tree_unflatten(spec, out)


class _InlineExecutor(contextlib.AbstractContextManager):
    """Runs each submitted lane at once, in the caller's thread: on the CPU
    the plain versions hold the GIL, so lane threads would only contend."""

    def submit(self, fn, *args) -> Future:
        fut: Future = Future()
        try:
            fut.set_result(fn(*args))
        except Exception as e:  # noqa: BLE001 — delivered through the future
            fut.set_exception(e)
        return fut

    def __exit__(self, *exc):
        return None


def _publish_stats(pc, stats: IngestStats) -> IngestStats:
    global _last_stats
    _last_stats = stats
    _log_schedule(type(pc).__name__, stats)
    return stats


def run_parallel(
    stream: EdgeStream,
    pc: PartitionerCarry,
    *extras,
    num_streams: int = 1,
    super_chunk: int | str = 8,
    shard: str = "range",
    hub_threshold: int | None = None,
    backend: str | None = None,
    mesh=None,
    carry=None,
    on_lane_failure: str = "raise",
    lane_injector=None,
    straggler=None,
    carry_store=None,
    carry_consumer: str | None = None,
    carry_config=None,
):
    """Drive ``pc`` over ``stream`` with S-way parallel ingest.

    Returns ``(parts in arrival order | None, pc.finalize(final carry))``,
    as :func:`~repro_torch.streaming.engine.run_carry`.  ``super_chunk``
    is the rounds between merges or ``"auto"``; ``shard`` the plan;
    ``hub_threshold`` the hub mode's degree cut; ``carry`` a start carry
    (with S > 1 the first merge base, never written; the sequential drive
    of S = 1 may update it in place, as ``run_carry`` does).
    ``on_lane_failure="replay"``
    re-folds a lane whose super-chunk raised, from the merge base, which
    is bit-identical to the drive without the failure; ``lane_injector``
    is a duck-typed ``check(lane, chunk_id)`` called before each chunk
    (threads backend).  ``straggler`` (threads backend) records each lane's
    time a chunk at every merge and hands a tail cut of each straggler's
    remaining chunks to the fastest lane (:func:`_handoff_lanes`).  With a
    ``carry_store`` (threads backend) every
    merge base, the start carry included, is checkpointed under
    ``carry_consumer`` (default ``parallel:<carry class>``) and
    ``carry_config`` (plus the cadence and the shard mode), keyed by the
    edges merged so far, and a replay restores its base from disk.
    """
    if num_streams < 1:
        raise ValueError("num_streams must be >= 1")
    if isinstance(super_chunk, str):
        if super_chunk != "auto":
            raise ValueError(
                f"super_chunk must be >= 1 or 'auto', got {super_chunk!r}")
    elif super_chunk < 1:
        raise ValueError("super_chunk must be >= 1")
    shard = _SHARD_ALIASES.get(shard, shard)
    if shard not in SHARD_MODES:
        raise ValueError(f"unknown shard mode {shard!r}; one of {SHARD_MODES}")
    if on_lane_failure not in LANE_FAILURE_MODES:
        raise ValueError(f"unknown on_lane_failure {on_lane_failure!r}; "
                         f"one of {LANE_FAILURE_MODES}")
    if mesh is not None and backend not in (None, "shard_map"):
        raise ValueError(f"a mesh runs the shard_map backend, not {backend!r}")
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if num_streams == 1 or stream.n_chunks <= 1:
        t0 = time.perf_counter()
        out = run_carry(stream, pc, *extras, carry=carry)
        _publish_stats(pc, IngestStats(
            num_streams=1, shard=shard, backend="sequential",
            super_chunk=super_chunk, schedule=(),
            lanes=(LaneStats(chunks=stream.n_chunks, edges=stream.n_edges,
                             merge_count=0,
                             wall_s=time.perf_counter() - t0),)))
        return out

    ps = ParallelEdgeStream(stream, num_streams, shard=shard,
                            hub_threshold=hub_threshold)
    S = ps.num_streams
    backend = _resolve_backend("shard_map" if mesh is not None else backend, S)
    if (lane_injector is not None or straggler is not None or carry_store is not None
            or on_lane_failure != "raise") and backend != "threads":
        raise ValueError("lane fault handling, straggler handoff and carry "
                         "checkpoints run on the threads backend; got "
                         f"backend={backend!r}")
    base = pc.init() if carry is None else carry
    parts_by_chunk: dict[int, torch.Tensor] = {}
    ctl = _CadenceController(pc, super_chunk)
    t_run = time.perf_counter()
    lane_chunks = [0] * S
    lane_edges = [0] * S
    lane_wall = [0.0] * S

    if backend == "vmap":
        r0 = 0
        while r0 < ps.n_rounds:
            sc = ctl.next()
            local = _stack_lanes(pc, base, S)
            rows = rows_of(local)
            for r in range(r0, min(r0 + sc, ps.n_rounds)):
                for s, lane in enumerate(ps.lanes):
                    if r >= len(lane):  # exhausted: no step, a zero delta
                        continue
                    cid = lane[r]
                    ch = ps.chunk_for(cid, *extras)
                    new, parts = pc.step_chunk(rows[s], ch.src, ch.dst, ch.n_valid,
                                               *ch.extras)
                    write_row(rows[s], new)
                    if parts is not None:
                        parts_by_chunk[cid] = parts[: ch.n_valid]
            prev = base
            base = pc.merge_stacked(local, prev)
            ctl.observe(prev, base)
            r0 += sc
        wall = time.perf_counter() - t_run
        for s in range(S):
            lane_chunks[s] = len(ps.lanes[s])
            lane_edges[s] = sum(ps.chunk_n_valid(c) for c in ps.lanes[s])
            lane_wall[s] = wall
    elif backend == "shard_map":
        base = _shard_map_drive(ps, pc, extras, mesh, base, ctl, parts_by_chunk)
        wall = time.perf_counter() - t_run
        for s in range(S):
            lane_chunks[s] = len(ps.lanes[s])
            lane_edges[s] = sum(ps.chunk_n_valid(c) for c in ps.lanes[s])
            lane_wall[s] = wall
    else:
        dev = _carry_device(base)
        cuda = dev is not None and dev.type == "cuda"
        main = torch.cuda.current_stream(dev) if cuda else None
        lane_streams = [torch.cuda.Stream(dev) if cuda else None for _ in range(S)]
        # the host gathers of chunk staging are serialised, as in the
        # reference; each lane queues its chunk's copy outside the lock
        stage_lock = threading.Lock()

        def lane_fold(s, chunks, start, inject):
            local = start
            t0 = time.perf_counter()
            ctx = torch.cuda.stream(lane_streams[s]) if cuda else contextlib.nullcontext()
            with ctx:
                for cid in chunks:
                    if inject is not None:
                        inject.check(s, cid)
                    with stage_lock:
                        staged = ps.stage(cid, *extras)
                    ch = ps.upload(staged)
                    local, parts = pc.step_chunk(local, ch.src, ch.dst,
                                                 ch.n_valid, *ch.extras)
                    if parts is not None:
                        parts_by_chunk[cid] = parts[: ch.n_valid]
            if cuda:
                lane_streams[s].synchronize()
            return local, time.perf_counter() - t0

        def start_of(s, batch):
            if not batch:  # an exhausted lane folds nothing: the base itself
                return base
            c = _lane_copy(pc, base)
            if cuda:
                lane_streams[s].wait_stream(main)
            return c

        edges_done = 0  # edges committed through merges (the checkpoint key)
        consumer = (carry_consumer if carry_consumer is not None
                    else f"parallel:{type(pc).__name__}")
        store_cfg = dict(carry_config or {})
        store_cfg.setdefault("super_chunk", str(super_chunk))
        store_cfg.setdefault("shard", shard)

        def save_base():
            if carry_store is not None:
                carry_store.save(base, consumer=consumer, config=store_cfg,
                                 stream_pos=edges_done)

        def replay_start(s, batch):
            """The failed lane's start: the last commit point, from disk
            when checkpointed (fresh tensors: no copy needed)."""
            if carry_store is None or not batch:
                return start_of(s, batch)
            restored, _ = carry_store.load(like=base, consumer=consumer,
                                           config=store_cfg,
                                           max_stream_pos=edges_done)
            if cuda:
                lane_streams[s].wait_stream(main)
            return restored

        save_base()  # a lane can die before the first merge commits
        # a straggler handoff re-deals the remaining chunks between merges:
        # the plan's own lists stay as they are
        lanes = [list(lane) for lane in ps.lanes]
        pos = [0] * S
        sc_index = 0
        with (ThreadPoolExecutor(max_workers=S) if cuda else _InlineExecutor()) as ex:
            while any(pos[s] < len(lanes[s]) for s in range(S)):
                sc = ctl.next()
                batches = [lanes[s][pos[s]:pos[s] + sc] for s in range(S)]
                futs = [ex.submit(lane_fold, s, batches[s], start_of(s, batches[s]),
                                  lane_injector) for s in range(S)]
                locals_: list = [None] * S
                times = [0.0] * S
                failed: list[int] = []
                for s, f in enumerate(futs):
                    try:
                        locals_[s], times[s] = f.result()
                    except Exception as e:  # noqa: BLE001 — a lane died
                        if on_lane_failure != "replay":
                            raise
                        log.warning("ingest lane %d died mid-super-chunk (%s); "
                                    "replaying its range", s, e)
                        failed.append(s)
                for s in failed:
                    # the merge base is the last commit point: re-fold the
                    # lane's chunks from it, bit-identical to no failure
                    locals_[s], times[s] = ex.submit(
                        lane_fold, s, batches[s], replay_start(s, batches[s]),
                        None).result()
                if cuda:
                    for ls in lane_streams:
                        main.wait_stream(ls)
                prev = base
                base = pc.merge(locals_, base=prev)
                locals_ = futs = None  # the lanes' copies go before the next ones
                ctl.observe(prev, base)
                edges_done += sum(ps.chunk_n_valid(cid) for b in batches for cid in b)
                for s in range(S):
                    pos[s] += len(batches[s])
                    lane_chunks[s] += len(batches[s])
                    lane_edges[s] += sum(ps.chunk_n_valid(c) for c in batches[s])
                    lane_wall[s] += times[s]
                save_base()
                if straggler is not None:
                    for s in range(S):
                        if batches[s]:
                            # a lane's time a chunk: its speed, not its load
                            straggler.record(sc_index, times[s] / len(batches[s]),
                                             shard=s)
                    _handoff_lanes(ps, lanes, pos, straggler)
                sc_index += 1
        if cuda:
            for p in parts_by_chunk.values():
                p.record_stream(main)

    merges = len(ctl.schedule)
    _publish_stats(pc, IngestStats(
        num_streams=S, shard=shard, backend=backend, super_chunk=super_chunk,
        schedule=tuple(ctl.schedule),
        lanes=tuple(LaneStats(chunks=lane_chunks[s], edges=lane_edges[s],
                              merge_count=merges, wall_s=lane_wall[s])
                    for s in range(S))))

    result = pc.finalize(base)
    if not parts_by_chunk:
        return None, result
    if ps.shard == "hub":
        # plan chunks carry their stream positions: scatter to stream order
        cids = list(parts_by_chunk)
        posns = np.concatenate([ps.chunk_positions(c) for c in cids])
        vals = torch.cat([parts_by_chunk[c][: ps.chunk_n_valid(c)] for c in cids])
        out = torch.empty((stream.n_edges,), dtype=vals.dtype, device=vals.device)
        out[_to_device(posns.astype(np.int64), vals.device)] = vals
        return stream.scatter_back(out), result
    outs = [parts_by_chunk[cid][: ps.chunk_n_valid(cid)]
            for cid in range(stream.n_chunks)]
    parts = outs[0] if len(outs) == 1 else torch.cat(outs)
    return stream.scatter_back(parts), result


def _resolve_backend(backend, S: int) -> str:
    """The reference's rule with ranks for devices: ``shard_map`` when a
    process group is up and S ranks wide, else ``threads``."""
    if backend is not None:
        return backend
    from .. import _dist

    return "shard_map" if _dist.is_up() and _dist.world_size() == S else "threads"


def _shard_map_drive(ps, pc, extras, mesh, base, ctl, parts_by_chunk):
    """One lane a rank of a one-dimensional mesh (default: over the default
    group): each rank stages and folds only its lane's chunks, from its own
    copy of the merge base, and the lanes merge through
    :meth:`~repro_torch.streaming.carry.PartitionerCarry.merge_collective`
    at every super-chunk.  The lanes' parts are all-gathered at the end, so
    every rank fills ``parts_by_chunk`` with every chunk.  Returns the last
    merge base, the same on every rank."""
    from .. import _dist

    S = ps.num_streams
    if mesh is None:
        if not _dist.is_up() or _dist.world_size() != S:
            raise ValueError(
                f"the shard_map backend runs one lane a rank: it needs a process group "
                f"of {S} ranks, got world size "
                f"{_dist.world_size() if _dist.is_up() else 1} (use backend='threads' "
                f"or 'vmap', or start {S} ranks)")
        dev = _carry_device(base) or ps.stream.device
        mesh = _dist.world_mesh(dev.type, "streams")
    if mesh.ndim != 1 or mesh.size() != S:
        raise ValueError(f"shard_map backend needs a {S}-wide mesh axis, got "
                         f"{tuple(mesh.shape)} (use backend='threads' or 'vmap')")
    me = mesh.get_local_rank()
    lane = ps.lanes[me]
    mine: dict[int, torch.Tensor] = {}
    r0 = 0
    while r0 < ps.n_rounds:
        sc = ctl.next()
        local = _lane_copy(pc, base)
        for cid in lane[r0:r0 + sc]:
            ch = ps.chunk_for(cid, *extras)
            local, parts = pc.step_chunk(local, ch.src, ch.dst, ch.n_valid, *ch.extras)
            if parts is not None:
                mine[cid] = parts[: ch.n_valid]
        prev = base
        base = pc.merge_collective(local, prev, mesh)
        local = None
        ctl.observe(prev, base)
        r0 += sc
    if not pc.emits_parts:
        return base
    flat = (torch.cat([mine[c] for c in lane]) if lane else torch.zeros(0, dtype=torch.int32))
    got = _dist.all_gather_arrays(flat.cpu().numpy(), mesh)
    dev = ps.stream.device
    for s, arr in enumerate(got):
        at = 0
        for cid in ps.lanes[s]:
            nv = ps.chunk_n_valid(cid)
            parts_by_chunk[cid] = torch.from_numpy(arr[at:at + nv].copy()).to(dev)
            at += nv
    return base


def _handoff_lanes(ps, lanes, pos, straggler):
    """Live lane handoff at a merge boundary: the monitor's
    ``rebalance_plan`` over each lane's remaining chunk range says what
    tail cut each straggler gives up, and those chunk ids move to the
    receiving lane's queue.  Chunks already folded (before ``pos``) never
    move.  In hub mode the cut is re-sliced at a whole-hub boundary
    (:func:`_handoff_lanes_hub`)."""
    ranges = [(pos[s], len(lanes[s])) for s in range(len(lanes))]
    plan = straggler.rebalance_plan(ranges)
    if plan == ranges:
        return
    if ps.shard == "hub":
        _handoff_lanes_hub(ps, lanes, pos, ranges, plan)
        return
    moved: list[int] = []
    receiver = None
    for s, ((_, hi_old), (_, hi_new)) in enumerate(zip(ranges, plan)):
        if hi_new < hi_old:
            cut = hi_old - hi_new
            moved.extend(lanes[s][len(lanes[s]) - cut:])
            del lanes[s][len(lanes[s]) - cut:]
        elif hi_new > hi_old:
            receiver = s
    if receiver is not None and moved:
        # keep stream order within the receiving lane's tail
        lanes[receiver].extend(sorted(moved))
        log.info("straggler handoff: %d chunk(s) moved to lane %d",
                 len(moved), receiver)


def _handoff_lanes_hub(ps, lanes, pos, ranges, plan):
    """Hub-granular handoff: each straggler's remaining edges are cut at a
    whole-hub boundary (a hub edge moves iff its hub's first remaining
    occurrence is past the boundary, so a hub's remaining edges all stay or
    all move, in stream order either way), both sides are registered as new
    plan chunks, and the moved hubs' ``pin_map`` entries go to the
    receiver."""
    B = ps.stream.chunk_size
    receiver = None
    for s, ((_, hi_old), (_, hi_new)) in enumerate(zip(ranges, plan)):
        if hi_new > hi_old:
            receiver = s
    if receiver is None:
        return
    for s, ((_, hi_old), (_, hi_new)) in enumerate(zip(ranges, plan)):
        cut = hi_old - hi_new
        if cut <= 0 or s == receiver:
            continue
        rest = lanes[s][pos[s]:]
        if not rest:
            continue
        positions = np.concatenate([ps._chunk_pos[c] for c in rest])
        boundary = max(len(positions) - cut * B, 0)
        pv = ps._pin_vertex[positions]
        idx = np.arange(len(positions))
        move = (pv < 0) & (idx >= boundary)
        # a hub edge moves with its hub's first remaining occurrence
        hub = pv >= 0
        if hub.any():
            hubs, first = np.unique(pv[hub], return_index=True)
            first_of = np.flatnonzero(hub)[first]  # positions ascend
            move[hub] = first_of[np.searchsorted(hubs, pv[hub])] >= boundary
        keep_pos = positions[~move]
        move_pos = positions[move]
        if not move_pos.size:
            continue
        lanes[s] = lanes[s][:pos[s]] + ps._register_chunks(keep_pos)
        lanes[receiver].extend(ps._register_chunks(move_pos))
        moved_hubs = np.unique(pv[move & hub])
        for h in moved_hubs:
            ps.pin_map[int(h)] = receiver
        lane_of_pos = ps._lane_of_pos.copy()  # the cached plan's array stays as built
        lane_of_pos[move_pos] = receiver
        ps._lane_of_pos = lane_of_pos
        log.info("straggler handoff (hub): %d edge(s), %d hub pin(s) "
                 "moved lane %d → %d", len(move_pos), len(moved_hubs), s,
                 receiver)
