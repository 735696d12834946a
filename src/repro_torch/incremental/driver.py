"""Top-level incremental driver: cold start → CarryStore → warm replays.

The port of ``repro.incremental.driver``.  Two bundle flavors behind one
``save``/``resume`` surface:

- **scan partitioners** (greedy / hdrf / grid): the bundle is the scoring
  carry plus the per-edge parts and alive mask; a delta replay is one
  :func:`~repro_torch.incremental.delta.run_incremental_carry` fold (K3
  for greedy and HDRF, G1 for grid), a **deletion** one
  :func:`~repro_torch.streaming.run_retract` drive (K3 with ``sign = -1``
  for greedy and HDRF);
- **s5p**: the pipeline bundle of :mod:`~repro_torch.incremental.pipeline`,
  with drift-triggered refinement, version-rollback deletions and the ξ/κ
  refresh signal.

``cold_start`` runs the partitioner from scratch and persists the bundle;
``run_incremental`` restores the latest one (validated by consumer, config
fingerprint, stream position, carry representation and the prefix CRC),
replays only the suffix the store has not seen, applies any deletions and
saves the grown bundle.  :class:`S5PWindowChain` (and
:func:`s5p_sliding_window`, which drains it) track the last W edges of a
stream; ``S5PWindowChain.resize`` reshards its bundle onto k′.  The
stores are the reference's format: a store written by either package
resumes in the other.  Entry points run on ``device`` (default the card).
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, NamedTuple

import numpy as np

from .._device import resolve_device
from ..checkpoint.manager import as_like
from ..core.s5p import S5PConfig
from ..kernels import stream_scan as _scan
from ..streaming.carry import tree_flatten, tree_flatten_with_paths, tree_unflatten
from .delta import DeltaStream, grow_carry, run_incremental_carry
from .pipeline import (
    IncrementalResult,
    _metrics,
    _np,
    compact_bundle,
    compact_edge_slots,
    s5p_apply_delta,
    s5p_apply_deletion,
    s5p_cold_bundle,
    s5p_cold_restart,
    s5p_identity_config,
)
from .store import CarryMismatchError, CarryStore

__all__ = ["SCAN_PARTITIONERS", "INCREMENTAL_PARTITIONERS", "cold_start",
           "run_incremental", "s5p_sliding_window", "S5PWindowChain", "WindowStep"]

SCAN_PARTITIONERS = ("greedy", "hdrf", "grid")
INCREMENTAL_PARTITIONERS = SCAN_PARTITIONERS + ("s5p",)


def _scan_carry(name: str, n_vertices: int, k: int, seed: int, dev,
                lam: float = 1.1):
    if name == "greedy":
        return _scan.GreedyCarry(n_vertices, k, device=dev)
    if name == "hdrf":
        return _scan.HdrfCarry(n_vertices, k, lam, device=dev)
    if name == "grid":
        from ..core.baselines import _grid_dims, _grid_rowcol

        _, c = _grid_dims(k)
        row, col = _grid_rowcol(n_vertices, k, c, seed, dev)
        return _scan.GridCarry(k, row, col, c, device=dev)
    raise ValueError(f"{name!r} is not a scan partitioner")


def _scan_identity_config(name: str, k: int, seed: int,
                          lam: float = 1.1) -> dict:
    cfg: dict[str, Any] = {"partitioner": name, "k": k, "seed": seed}
    if name == "hdrf":
        cfg["lam"] = lam
    return cfg


def _prefix_crc(src, dst, n_edges: int) -> int:
    """CRC32 of the first ``n_edges`` edges: the stream-identity check that
    catches a longer foreign stream (config + position alone would replay
    an unrelated graph's suffix against the carry)."""
    crc = zlib.crc32(np.ascontiguousarray(src[:n_edges], np.int32).tobytes())
    return zlib.crc32(
        np.ascontiguousarray(dst[:n_edges], np.int32).tobytes(), crc)


def _check_prefix(meta, full_src, full_dst):
    want = meta.get("prefix_crc")
    if want is None:
        return
    got = _prefix_crc(full_src, full_dst, int(meta["stream_pos"]))
    if got != want:
        raise CarryMismatchError(
            f"the current stream's first {meta['stream_pos']} edges do not "
            "match the edges this carry was built on (foreign stream)")


def _check_partitioner(partitioner: str) -> None:
    if partitioner not in INCREMENTAL_PARTITIONERS:
        raise ValueError(
            f"partitioner {partitioner!r} has no incremental bundle; one of "
            f"{INCREMENTAL_PARTITIONERS}")


def cold_start(store_dir, partitioner: str, src, dst, n_vertices: int,
               k: int, *, seed: int = 0, chunk_size: int = 1 << 16,
               s5p_config: S5PConfig | None = None, stream=None,
               num_streams: int = 1, super_chunk: int | str = 8,
               keep: int = 3, device=None):
    """Run ``partitioner`` from scratch and persist its warm-start bundle.
    Returns ``(parts, store_path)`` (parts a host int32 array)."""
    _check_partitioner(partitioner)
    dev = stream.device if stream is not None else resolve_device(device)
    store = CarryStore(store_dir, keep=keep)
    src = _np(src, np.int32)
    dst = _np(dst, np.int32)
    E = int(src.shape[0])
    if partitioner == "s5p":
        config = s5p_config if s5p_config is not None else S5PConfig(
            k=k, seed=seed, chunk_size=chunk_size)
        out, bundle = s5p_cold_bundle(src, dst, n_vertices, config,
                                      stream=stream, device=dev)
        store.save(bundle, consumer="s5p", config=s5p_identity_config(config),
                   stream_pos=E,
                   extra_meta={"n_vertices": int(n_vertices),
                               "prefix_crc": _prefix_crc(src, dst, E)})
        return _np(out.parts, np.int32), store.directory
    pc = _scan_carry(partitioner, n_vertices, k, seed, dev)
    from ..streaming import as_stream, run_parallel

    st = as_stream(src, dst, n_vertices, stream=stream,
                   chunk_size=chunk_size, device=dev)
    parts, carry = run_parallel(st, pc, num_streams=num_streams,
                                super_chunk=super_chunk)
    parts = _np(parts, np.int32)
    store.save({"scan": carry, "parts": parts,
                "alive": np.ones(E, bool)}, consumer=partitioner,
               config=_scan_identity_config(partitioner, k, seed),
               stream_pos=E,
               extra_meta={"n_vertices": int(n_vertices),
                           "prefix_crc": _prefix_crc(src, dst, E)})
    return parts, store.directory


def _merge_deletion(result: IncrementalResult, dres: IncrementalResult):
    return dres._replace(
        edges_replayed=result.edges_replayed + dres.edges_replayed,
        game_rounds=result.game_rounds + dres.game_rounds,
        refined=result.refined or dres.refined,
        n_new_clusters=result.n_new_clusters,
        n_delta_edges=result.n_delta_edges)


def run_incremental(store_dir, partitioner: str, full_src, full_dst,
                    n_vertices: int, k: int, *, seed: int = 0,
                    chunk_size: int = 1 << 16,
                    s5p_config: S5PConfig | None = None,
                    num_streams: int = 1, super_chunk: int | str = 8,
                    delete=None, save: bool = True, save_dir=None,
                    keep: int = 3, device=None) -> IncrementalResult:
    """Warm-start ``partitioner`` on the suffix the store has not seen.

    ``full_src``/``full_dst`` are the whole stream in arrival order; the
    delta is everything past the persisted bundle's stream position, and
    ``delete`` (optional) names arrival indices to retract after the
    insertion replay.  A mismatched bundle raises
    :class:`~repro_torch.incremental.store.CarryMismatchError`.  The grown
    bundle is saved back to ``save_dir`` (default: the same store) unless
    ``save=False``.
    """
    _check_partitioner(partitioner)
    dev = resolve_device(device)
    load_store = CarryStore(store_dir, keep=keep)
    store = (load_store if save_dir is None
             else CarryStore(save_dir, keep=keep))
    full_src = _np(full_src, np.int32)
    full_dst = _np(full_dst, np.int32)
    E_total = int(full_src.shape[0])
    if partitioner == "s5p":
        config = s5p_config if s5p_config is not None else S5PConfig(
            k=k, seed=seed, chunk_size=chunk_size)
        bundle, meta = load_store.load(consumer="s5p",
                                       config=s5p_identity_config(config),
                                       max_stream_pos=E_total)
        _check_prefix(meta, full_src, full_dst)
        bundle, result = s5p_apply_delta(bundle, config, full_src, full_dst,
                                         meta["stream_pos"], device=dev)
        if delete is not None and len(delete):
            bundle, dres = s5p_apply_deletion(bundle, config, full_src,
                                              full_dst, delete, device=dev)
            result = _merge_deletion(result, dres)
        if save:
            # keyed on the stream position, not the slot count: slot
            # compaction shrinks the slots without moving the stream
            pos = int(bundle["stream_pos"])
            store.save(bundle, consumer="s5p",
                       config=s5p_identity_config(config), stream_pos=pos,
                       extra_meta={"n_vertices": int(bundle["degrees"].shape[0]),
                                   "prefix_crc": _prefix_crc(full_src, full_dst, pos)})
        return result

    config = _scan_identity_config(partitioner, k, seed)
    flat, meta = load_store.load(consumer=partitioner, config=config,
                                 max_stream_pos=E_total)
    _check_prefix(meta, full_src, full_dst)
    E0 = int(meta["stream_pos"])
    n_old = int(meta.get("n_vertices", n_vertices))
    prefix_parts = np.asarray(flat.pop("parts"), np.int32)
    alive = np.asarray(flat.pop("alive"), bool)
    # reassemble the scoring carry from its path-keyed leaves
    proto = _scan_carry(partitioner, n_old, k, seed, dev).init()
    paths = tree_flatten_with_paths({"scan": proto})
    _, spec = tree_flatten(proto)
    carry = tree_unflatten(spec, [as_like(flat[key], x) for key, x in paths])
    dsrc = full_src[E0:]
    ddst = full_dst[E0:]
    E_delta = E_total - E0
    n_new = n_vertices
    if E_delta:
        n_new = max(n_old, int(max(dsrc.max(), ddst.max())) + 1, n_vertices)
    carry = grow_carry(partitioner, carry, n_old, n_new, k=k, seed=seed)
    pc = _scan_carry(partitioner, n_new, k, seed, dev)
    parts = prefix_parts
    if E_delta:
        stream = DeltaStream(dsrc, ddst, n_new, base_offset=E0,
                             chunk_size=chunk_size, device=dev)
        delta_parts, carry = run_incremental_carry(
            stream, pc, carry=carry, num_streams=num_streams,
            super_chunk=super_chunk)
        parts = np.concatenate([prefix_parts, _np(delta_parts, np.int32)])
        alive = np.concatenate([alive, np.ones(E_delta, bool)])
    n_retracted = 0
    if delete is not None and len(delete):
        idx = np.unique(np.asarray(delete, np.int64))
        if idx[0] < 0 or idx[-1] >= E_total:
            raise ValueError(
                f"deletion indices must lie in [0, {E_total})")
        if not alive[idx].all():
            raise ValueError("deletion names edges that are already deleted")
        from ..streaming import run_retract

        back = DeltaStream(full_src[idx], full_dst[idx], n_new, sign=-1,
                           chunk_size=chunk_size, device=dev)
        carry = run_retract(back, pc, parts[idx], carry=carry,
                            num_streams=num_streams, super_chunk=super_chunk)
        parts = parts.copy()
        parts[idx] = -1
        alive = alive.copy()
        alive[idx] = False
        n_retracted = int(idx.size)
    rf, bal = _metrics(full_src, full_dst, parts, n_new, k, dev)
    if save:
        store.save({"scan": carry, "parts": parts, "alive": alive},
                   consumer=partitioner, config=config, stream_pos=E_total,
                   extra_meta={"n_vertices": int(n_new),
                               "prefix_crc": _prefix_crc(full_src, full_dst, E_total)})
    return IncrementalResult(
        parts=parts, rf=rf, balance=bal, refined=False, rf_drift=0.0,
        balance_drift=0.0, edges_replayed=E_delta + n_retracted,
        full_replay_cost=E_total, game_rounds=0, n_new_clusters=0,
        n_delta_edges=E_delta, n_retracted=n_retracted)


# ---------------------------------------------------------------------------
# sliding-window S5P: track the last W edges continuously
# ---------------------------------------------------------------------------


class WindowStep(NamedTuple):
    """Per-step record of a sliding-window run."""

    step: int
    lo: int  # live window after the step: arrival indices [lo, hi)
    hi: int
    rf: float
    balance: float
    refined: bool
    rolled_back: bool
    n_inserted: int
    n_retracted: int
    churn: float
    needs_cold_restart: bool
    xi_drift: float
    n_compacted: int  # combined ids dropped by compaction this step
    filling: bool = False  # window not yet full — no partition maintained
    cold_restarted: bool = False  # acted on needs_cold_restart this step
    n_slots_freed: int = 0  # dead per-edge slots dropped this step


class S5PWindowChain:
    """Stepwise sliding-window S5P: one churn event per :meth:`step`.

    Each step admits the next ``step_edges`` arrivals
    (:func:`~repro_torch.incremental.pipeline.s5p_apply_delta`), retracts
    the expired batch (:func:`~repro_torch.incremental.pipeline.
    s5p_apply_deletion`), then maintains the bundle: a cold restart on the
    refresh signal (``auto_cold_restart``), cluster-id compaction past
    ``compact_factor ×`` the last known live id count, slot compaction
    past ``slot_compact_factor ×`` the live edges (``<= 0`` disables
    either).  The chain cold-starts when the window first fills (fill
    events are ``filling`` steps without a partition).  Runs on
    ``device`` (default the card), or the stream's.
    """

    def __init__(self, src, dst, n_vertices: int, config: S5PConfig,
                 window_edges: int, *, step_edges: int | None = None,
                 stream=None, compact_factor: float = 2.0,
                 slot_compact_factor: float = 4.0,
                 auto_cold_restart: bool = False, device=None):
        from ..streaming import SlidingWindowStream, as_stream

        dev = stream.device if stream is not None else resolve_device(device)
        st = as_stream(src, dst, n_vertices, stream=stream,
                       chunk_size=config.chunk_size, device=dev)
        self.device = dev
        self.config = config
        self.window_edges = int(window_edges)
        self.compact_factor = float(compact_factor)
        self.slot_compact_factor = float(slot_compact_factor)
        self.auto_cold_restart = bool(auto_cold_restart)
        self._sw = SlidingWindowStream(st, window_edges,
                                       step_edges=step_edges)
        self.n_vertices = int(st.n_vertices)
        self.n_steps = self._sw.n_steps
        # arrival prefix [0, hi), filled in place per event: one O(E)
        # buffer for the whole run
        self._buf_src = np.empty(st.n_edges, np.int32)
        self._buf_dst = np.empty(st.n_edges, np.int32)
        self.bundle: dict | None = None
        self._c_live_known = 1
        self._events = self._sw.events()
        self._i = 0
        self.lo = 0
        self.hi = 0

    @property
    def seen_src(self) -> np.ndarray:
        """Arrivals [0, hi) — the stream prefix the bundle is keyed on."""
        return self._buf_src[:self.hi]

    @property
    def seen_dst(self) -> np.ndarray:
        return self._buf_dst[:self.hi]

    def live_edges(self) -> tuple[np.ndarray, np.ndarray]:
        """The live window's edges, in slot order (empty while filling)."""
        if self.bundle is None:
            z = np.zeros(0, np.int32)
            return z, z
        alive = np.asarray(self.bundle["alive"], bool)
        arr = np.asarray(self.bundle["arrival"], np.int64)[alive]
        return self._buf_src[arr], self._buf_dst[arr]

    def live_partition(self):
        """``(src, dst, parts)`` of the live window in slot order (fresh
        arrays each call), or ``None`` while the window is filling."""
        if self.bundle is None:
            return None
        alive = np.asarray(self.bundle["alive"], bool)
        arr = np.asarray(self.bundle["arrival"], np.int64)[alive]
        parts = np.asarray(self.bundle["parts"], np.int32)[alive]
        return self._buf_src[arr], self._buf_dst[arr], parts

    def step(self) -> WindowStep | None:
        """Apply the next churn event; ``None`` when the stream is done."""
        ev = next(self._events, None)
        if ev is None:
            return None
        i = self._i
        self._i += 1
        dev = self.device
        self._buf_src[ev.start:ev.hi] = ev.src
        self._buf_dst[ev.start:ev.hi] = ev.dst
        self.lo, self.hi = ev.lo, ev.hi
        seen_src = self._buf_src[:ev.hi]
        seen_dst = self._buf_dst[:ev.hi]
        config = self.config
        if (self.bundle is None and ev.hi < self.window_edges
                and i < self.n_steps - 1):
            # window still filling: no partition yet, just accumulate
            return WindowStep(
                step=i, lo=ev.lo, hi=ev.hi, rf=0.0, balance=0.0,
                refined=False, rolled_back=False,
                n_inserted=int(ev.src.shape[0]), n_retracted=0,
                churn=0.0, needs_cold_restart=False, xi_drift=0.0,
                n_compacted=0, filling=True)
        rolled_back = False
        if self.bundle is None:
            # first full window (or the stream ended short of one): cold
            # start on everything seen, then retract any expired prefix
            _, bundle = s5p_cold_bundle(seen_src, seen_dst, self.n_vertices,
                                        config, device=dev)
            rf = float(bundle["rf_baseline"])
            bal = float(bundle["balance_baseline"])
            refined = needs_cold = False
            churn = xi_drift = 0.0
            n_ret = 0
            if ev.expire_idx.size:
                bundle, res = s5p_apply_deletion(bundle, config, seen_src,
                                                 seen_dst, ev.expire_idx,
                                                 device=dev)
                rf, bal = res.rf, res.balance
                refined, churn = res.refined, res.churn
                xi_drift = res.xi_drift
                needs_cold = res.needs_cold_restart
                n_ret = int(ev.expire_idx.size)
            self._c_live_known = max(int(bundle["comb_is_head"].shape[0]), 1)
        else:
            bundle, res = s5p_apply_delta(self.bundle, config, seen_src,
                                          seen_dst, ev.start, device=dev)
            n_ret = 0
            refined = res.refined
            if ev.expire_idx.size:
                bundle, dres = s5p_apply_deletion(bundle, config, seen_src,
                                                  seen_dst, ev.expire_idx,
                                                  device=dev)
                # the step refined if either phase did
                refined = refined or dres.refined
                res = dres
                n_ret = int(ev.expire_idx.size)
            rf, bal = res.rf, res.balance
            rolled_back = res.rolled_back
            churn, xi_drift = res.churn, res.xi_drift
            needs_cold = res.needs_cold_restart

        cold_restarted = False
        if needs_cold and self.auto_cold_restart:
            try:
                bundle, cres = s5p_cold_restart(bundle, config, seen_src,
                                                seen_dst, device=dev)
            except ValueError:
                pass  # live set degenerate (no valid edge): keep serving
            else:
                rf, bal = cres.rf, cres.balance
                cold_restarted = True
                self._c_live_known = max(
                    int(bundle["comb_is_head"].shape[0]), 1)
        n_comp = 0
        if self.compact_factor > 0 and not cold_restarted:
            C1 = int(np.asarray(bundle["comb_is_head"]).shape[0])
            if C1 > self.compact_factor * self._c_live_known:
                bundle, n_comp = compact_bundle(bundle, config, device=dev)
                self._c_live_known = max(
                    int(np.asarray(bundle["comb_is_head"]).shape[0]), 1)
        n_freed = 0
        if self.slot_compact_factor > 0:
            n_slots = int(np.asarray(bundle["parts"]).shape[0])
            n_live = int(np.count_nonzero(np.asarray(bundle["alive"])))
            if n_slots > self.slot_compact_factor * max(n_live, 1):
                bundle, n_freed = compact_edge_slots(bundle)
        self.bundle = bundle
        return WindowStep(
            step=i, lo=ev.lo, hi=ev.hi, rf=float(rf), balance=float(bal),
            refined=bool(refined), rolled_back=bool(rolled_back),
            n_inserted=int(ev.src.shape[0]), n_retracted=n_ret,
            churn=float(churn), needs_cold_restart=bool(needs_cold),
            xi_drift=float(xi_drift), n_compacted=int(n_comp),
            cold_restarted=cold_restarted, n_slots_freed=int(n_freed))

    def resize(self, k_new: int):
        """Elastic k → k′: reshard the live bundle onto ``k_new`` partitions
        with bounded migration (:func:`repro_torch.elastic.reshard_bundle`);
        the chain's config follows, so later steps ingest at k′.  Returns
        the ``ReshardResult``, or ``None`` while the window is filling (only
        ``config.k`` changes: the cold start runs at k′)."""
        from ..elastic import reshard_bundle

        if self.bundle is None:
            self.config = dataclasses.replace(self.config, k=int(k_new))
            return None
        bundle, config, res = reshard_bundle(
            self.bundle, self.config, k_new, self.seen_src, self.seen_dst,
            device=self.device)
        self.bundle = bundle
        self.config = config
        return res

    def steps(self):
        """Iterate the remaining churn schedule."""
        while True:
            rec = self.step()
            if rec is None:
                return
            yield rec


def s5p_sliding_window(src, dst, n_vertices: int, config: S5PConfig,
                       window_edges: int, *, step_edges: int | None = None,
                       stream=None, compact_factor: float = 2.0,
                       slot_compact_factor: float = 4.0,
                       auto_cold_restart: bool = False, device=None):
    """Maintain an S5P partition of the last ``window_edges`` edges: drain
    an :class:`S5PWindowChain`.  Returns ``(history, bundle)``, one
    :class:`WindowStep` per event and the final (slot-indexed) bundle."""
    chain = S5PWindowChain(
        src, dst, n_vertices, config, window_edges, step_edges=step_edges,
        stream=stream, compact_factor=compact_factor,
        slot_compact_factor=slot_compact_factor,
        auto_cold_restart=auto_cold_restart, device=device)
    history = list(chain.steps())
    return history, chain.bundle
