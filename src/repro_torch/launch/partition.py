"""Partitioning driver of the port: S5P and the paper's baselines on one graph.

  python -m repro_torch.launch.partition --graph rmat:16 --k 32
  python -m repro_torch.launch.partition --graph community:2000 --k 8 --compare --device cpu
  python -m repro_torch.launch.partition --graph community:2000 --k 8 --device cpu \
      --num-streams 4 --shard-mode hub --super-chunk auto

Out of core (edge shards paged from disk, ``repro_torch.streaming.oocstream``;
the reference's shard format, so either package reads the other's):

  python -m repro_torch.launch.partition --graph rmat:18 --write-shards /data/g18 \
      --shard-edges 1048576
  python -m repro_torch.launch.partition --graph rmat:10 --write-shards /data/g18 --append
  python -m repro_torch.launch.partition --graph file:/data/g18/manifest.json \
      --k 32 --partitioner hdrf --ordering windowed --window 4096

``--partitioner NAME`` runs one entry of ``PARTITIONERS`` (default
``s5p``), ``--compare`` runs all of them.  Each prints the reference's row
(``repro.launch.partition``): name, RF, balance, GAS sync MB per
iteration and seconds (host clock around work that ends in
``torch.cuda.synchronize()`` on cuda); a row that runs S5P's pipeline
(``S5P_BASED``) adds an indented line with its clusters, game rounds and
per-phase seconds.  ``--num-streams S`` ingests S lanes in the rows
that take them (grid, greedy, hdrf, s5p, s5p-exact), dealt by
``--shard-mode`` and merged every ``--super-chunk`` chunks (or ``auto``).
A ``file:`` graph pages every row that takes a stream from its shards
(the others run on its arrival arrays, marked ``[in-memory, natural]``;
the metrics read those arrays too).  Runs on ``cuda`` unless ``--device``
names another device.

Incremental re-partitioning (``repro_torch.incremental``; the carry
stores are the reference's format, so either CLI resumes the other's):

  python -m repro_torch.launch.partition --graph rmat:14 --k 32 --partitioner s5p \
      --save-carry /data/carry
  python -m repro_torch.launch.partition --graph rmat:14 --k 32 --partitioner s5p \
      --resume-carry /data/carry --delta rmat:10 --delete frac:0.05
  python -m repro_torch.launch.partition --graph rmat:14 --k 32 --window-edges 65536 \
      --window-step 16384
  python -m repro_torch.launch.partition --graph rmat:14 --k 8 --resize-k 12

``--save-carry DIR`` persists a cold run's warm-start bundle (greedy, hdrf,
grid, s5p); ``--resume-carry DIR`` replays everything past the bundle's
stream position (a ``file:`` graph grown by ``--write-shards --append``,
plus any ``--delta`` batch) and applies ``--delete`` (``first:X | last:X
| frac:F``); ``--window-edges`` partitions the last W edges step by step
(s5p); ``--resize-k K2`` partitions cold at ``--k`` and reshards the s5p
bundle to K2 with bounded migration.

Memory-budget hybrid (``repro_torch.hybrid``): a resident high-degree core
refined in memory, the rest streamed (s5p only):

  python -m repro_torch.launch.partition --graph rmat:14 --k 32 --host-budget 2M
  python -m repro_torch.launch.partition --graph rmat:14 --k 32 --hybrid --budget-fraction 0.25

``--host-budget BYTES`` (``512M`` / ``2G`` suffixes; 0 = pure streaming)
caps the resident core; ``--hybrid`` sizes the budget as
``--budget-fraction`` of the host's available memory (``/proc/meminfo``
MemAvailable, else ``os.sysconf``).  ``--save-carry DIR`` persists the
hybrid run's warm bundle like a cold run's.

Several ranks (``torchrun``; ``WORLD_SIZE > 1`` brings the process group
up: NCCL when each rank has a card of its own, gloo when ranks share one):

  torchrun --nproc-per-node 4 -m repro_torch.launch.partition --graph rmat:14 --k 8 \
      --num-streams 4

``--num-streams`` equal to the world size runs one lane a rank
(``run_parallel``'s ``shard_map`` backend); rank 0 alone prints and writes.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import inspect
import os
import time

import numpy as np
import torch

from .. import _dist
from .._device import resolve_device
from ..core.baselines import PARTITIONERS, S5P_BASED
from ..core.metrics import gas_comm_bytes, load_balance, replication_factor
from ..graphs import community_graph, powerlaw_graph, rmat_graph, toy_graph_fig3
from ..streaming import ORDERINGS, EdgeStream, ShardedEdgeStream, append_shards, write_shards


def load_graph(spec: str, seed: int = 0):
    """``rmat:S | community:N | powerlaw:N | toy`` → (src, dst, n); a
    ``file:`` spec opens as a stream (:func:`open_sharded_stream`)."""
    kind, _, arg = spec.partition(":")
    if kind == "rmat":
        return rmat_graph(int(arg or 14), edge_factor=8, seed=seed)
    if kind == "powerlaw":
        return powerlaw_graph(int(arg or 10000), seed=seed)
    if kind == "community":
        return community_graph(int(arg or 4000), seed=seed)
    if kind == "toy":
        return toy_graph_fig3()
    if kind == "file":
        raise ValueError("file: specs are opened by run(); use the CLI or "
                         "open_sharded_stream() directly")
    raise ValueError(f"unknown graph spec {spec!r}")


def open_sharded_stream(manifest: str, *, chunk_size: int = 1 << 16,
                        ordering: str = "natural", seed: int = 0,
                        window: int = 4096, device=None) -> ShardedEdgeStream:
    """Open a ``file:<manifest>`` spec as a paged ``ShardedEdgeStream``."""
    return ShardedEdgeStream(manifest, chunk_size=chunk_size, ordering=ordering,
                             seed=seed, window=window, device=device)


def write_shards_cli(graph: str, out_dir: str, shard_edges: int, seed: int = 0,
                     append: bool = False) -> str:
    """``--write-shards``: a synthetic spec's edges as a shard directory, or
    with ``append`` grown onto an existing one (the layout of one write of
    the concatenation; the manifest keeps its own shard size)."""
    src, dst, n = load_graph(graph, seed)
    t0 = time.perf_counter()
    if append:
        mpath = append_shards(out_dir, src, dst)
        print(f"appended {len(src)} edges ({n} vertices) to {mpath}  "
              f"[{time.perf_counter() - t0:.1f}s]")
    else:
        mpath = write_shards(out_dir, src, dst, shard_edges=shard_edges, n_vertices=n)
        print(f"wrote {len(src)} edges ({n} vertices) as shards of "
              f"{shard_edges} to {mpath}  [{time.perf_counter() - t0:.1f}s]")
    return str(mpath)


SHARD_MODES = ("range", "rr", "round-robin", "hub")

_BYTE_SUFFIXES = {"K": 1 << 10, "M": 1 << 20, "G": 1 << 30, "T": 1 << 40}


def parse_bytes(spec: str) -> int:
    """``--host-budget`` spec → bytes: plain int, or ``512M`` / ``2G`` /
    ``64KB`` (binary suffixes, case-insensitive, optional trailing B)."""
    s = str(spec).strip().upper()
    if s.endswith("B") and len(s) > 1 and not s[:-1].isdigit():
        s = s[:-1]
    mult = 1
    if s and s[-1] in _BYTE_SUFFIXES:
        mult = _BYTE_SUFFIXES[s[-1]]
        s = s[:-1]
    try:
        value = int(s)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected bytes like 1048576, 512M or 2G, got {spec!r}")
    if value < 0:
        raise argparse.ArgumentTypeError(f"byte budget must be >= 0, got {spec!r}")
    return value * mult


def _parse_meminfo_available(text: str) -> int | None:
    """``/proc/meminfo`` text → available bytes (``MemAvailable`` line,
    falling back to ``MemFree``), or None when neither parses."""
    free = None
    for line in text.splitlines():
        key, _, rest = line.partition(":")
        key = key.strip()
        if key not in ("MemAvailable", "MemFree"):
            continue
        fields = rest.split()
        if not fields or not fields[0].isdigit():
            continue
        value = int(fields[0])
        unit = fields[1].upper() if len(fields) > 1 else "KB"
        mult = {"B": 1, "KB": 1 << 10, "MB": 1 << 20, "GB": 1 << 30}.get(unit)
        if mult is None:
            continue
        if key == "MemAvailable":
            return value * mult
        free = value * mult
    return free


def detect_available_memory() -> int | None:
    """Available host memory in bytes, or None when undetectable:
    ``/proc/meminfo``'s MemAvailable first, then
    ``os.sysconf(SC_AVPHYS_PAGES) * SC_PAGE_SIZE``."""
    import os

    try:
        with open("/proc/meminfo") as fh:
            avail = _parse_meminfo_available(fh.read())
        if avail is not None:
            return avail
    except OSError:
        pass
    try:
        pages = os.sysconf("SC_AVPHYS_PAGES")
        page_size = os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError, AttributeError):
        return None
    if pages <= 0 or page_size <= 0:
        return None
    return int(pages) * int(page_size)


def auto_host_budget(fraction: float = 0.5) -> int:
    """Size ``--host-budget`` from available memory (``--hybrid`` with no
    explicit budget): ``fraction`` of what the host reports as available."""
    if not 0 < fraction <= 1:
        raise ValueError(
            f"budget_fraction must be in (0, 1], got {fraction}")
    avail = detect_available_memory()
    if avail is None:
        raise RuntimeError(
            "could not detect available host memory (/proc/meminfo and "
            "os.sysconf both unavailable); pass --host-budget explicitly")
    return int(avail * fraction)


def _parse_delete(spec: str, n_edges: int, seed: int) -> np.ndarray:
    """``--delete`` spec → arrival indices (the reference's parser).

    ``first:X`` / ``last:X``: the oldest / most recent X edges (a count,
    or a fraction when X < 1); ``frac:F``: a seeded random fraction.
    """
    kind, _, arg = spec.partition(":")
    try:
        x = float(arg)
    except ValueError:
        raise ValueError(f"--delete {spec!r}: expected a number after ':'")
    if kind in ("first", "last"):
        count = int(round(x * n_edges)) if 0 < x < 1 else int(x)
        count = max(0, min(count, n_edges))
        return (np.arange(count, dtype=np.int64) if kind == "first"
                else np.arange(n_edges - count, n_edges, dtype=np.int64))
    if kind == "frac":
        if not 0 <= x <= 1:
            raise ValueError("--delete frac: needs a fraction in [0, 1]")
        rng = np.random.default_rng(seed + 0x5EED)
        count = int(round(x * n_edges))
        return np.sort(rng.choice(n_edges, size=count, replace=False)
                       ).astype(np.int64)
    raise ValueError(
        f"unknown --delete spec {spec!r}; one of first:X | last:X | frac:F")


def _s5p_cfg(k, seed, chunk_size, ordering, num_streams, super_chunk,
             drift_threshold, refine_rounds, xi_refresh_threshold,
             shard="range"):
    from ..core import S5PConfig

    cfg = S5PConfig(k=k, seed=seed, chunk_size=chunk_size, ordering=ordering,
                    num_streams=num_streams, super_chunk=super_chunk,
                    shard=shard)
    overrides = {}
    if drift_threshold is not None:
        overrides["drift_rf_threshold"] = drift_threshold
    if refine_rounds is not None:
        overrides["refine_rounds"] = refine_rounds
    if xi_refresh_threshold is not None:
        overrides["xi_refresh_threshold"] = xi_refresh_threshold
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def _run_window_cli(src, dst, n, k, partitioner, seed, window_edges,
                    window_step, *, stream, chunk_size, ordering,
                    drift_threshold, refine_rounds, xi_refresh_threshold, dev):
    """``--window-edges``: continuous sliding-window partitioning."""
    from ..incremental import s5p_sliding_window

    if partitioner != "s5p":
        raise ValueError("--window-edges drives the s5p pipeline; use "
                         "--partitioner s5p (scan partitioners delete via "
                         "--resume-carry --delete)")
    if ordering != "natural":
        raise ValueError("sliding windows are defined over arrival order; "
                         "drop --ordering")
    cfg = _s5p_cfg(k, seed, chunk_size, ordering, 1, 8, drift_threshold,
                   refine_rounds, xi_refresh_threshold)
    t0 = time.perf_counter()
    history, _ = s5p_sliding_window(src, dst, n, cfg, window_edges,
                                    step_edges=window_step, stream=stream,
                                    device=dev)
    dt = time.perf_counter() - t0
    for st_ in history:
        flags = "".join((
            "F" if st_.filling else "-",
            "R" if st_.refined else "-",
            "B" if st_.rolled_back else "-",
            "C" if st_.n_compacted else "-",
            "X" if st_.needs_cold_restart else "-",
        ))
        print(f"step {st_.step:4d} window=[{st_.lo},{st_.hi}) "
              f"RF={st_.rf:7.3f} balance={st_.balance:5.2f} "
              f"+{st_.n_inserted}/-{st_.n_retracted} churn={st_.churn:.2f} "
              f"xi_drift={st_.xi_drift:.2f} [{flags}]")
    print(f"[window] {len(history)} steps, {dt:.1f}s total "
          f"({dt / max(len(history), 1):.2f}s/step)")
    return history


def _run_hybrid_cli(src, dst, n, k, seed, host_budget, *, stream,
                    chunk_size, ordering, num_streams, super_chunk,
                    shard, refine_rounds, save_carry, dev):
    """``--host-budget``: one memory-budget hybrid partition (s5p), the
    reference's row.  ``--save-carry`` persists the hybrid warm bundle
    like a cold run's.  Returns the ``HybridResult``."""
    from ..hybrid import run_hybrid

    cfg = _s5p_cfg(k, seed, chunk_size, ordering, num_streams, super_chunk,
                   None, refine_rounds, None, shard)
    cfg = dataclasses.replace(cfg, host_budget=int(host_budget))
    t0 = time.perf_counter()
    res = run_hybrid(stream if stream is not None else (src, dst, n), cfg,
                     device=dev)
    dt = time.perf_counter() - t0
    pct = res.peak_budget_bytes / max(host_budget, 1)
    print(f"{'hybrid':10s} RF={res.rf:7.3f} balance={res.balance:5.2f} "
          f"mode={res.mode} core={res.core_edges} "
          f"streamRF={res.rf_streaming:7.3f} "
          f"peak={res.peak_budget_bytes}B ({pct:.0%} of budget) "
          f"rounds={res.game_rounds}  {dt:6.1f}s")
    if save_carry:
        from ..incremental import CarryStore, s5p_identity_config
        from ..incremental.driver import _prefix_crc

        E = int(np.asarray(src).shape[0])
        path = CarryStore(save_carry).save(
            res.bundle, consumer="s5p", config=s5p_identity_config(cfg),
            stream_pos=E,
            extra_meta={"n_vertices": int(n),
                        "prefix_crc": _prefix_crc(src, dst, E)})
        print(f"[hybrid] carry→{path}")
    return res


def _run_resize_cli(src, dst, n, k, k_new, partitioner, seed, *,
                    chunk_size, drift_threshold, refine_rounds,
                    xi_refresh_threshold, dev):
    """``--resize-k``: a cold partition at k, then an elastic reshard to k′
    (bounded migration, :mod:`repro_torch.elastic`).  Prints RF before and
    after and the migrated fraction; returns the ``ReshardResult``."""
    from ..elastic import reshard_bundle
    from ..incremental.pipeline import s5p_cold_bundle

    if partitioner != "s5p":
        raise ValueError("--resize-k reshards the s5p warm bundle; use "
                         "--partitioner s5p (scan carries reshard via "
                         "repro_torch.elastic.reshard_scan_carry)")
    cfg = _s5p_cfg(k, seed, chunk_size, "natural", 1, 8, drift_threshold,
                   refine_rounds, xi_refresh_threshold)
    t0 = time.perf_counter()
    _, bundle = s5p_cold_bundle(src, dst, n, cfg, device=dev)
    t_cold = time.perf_counter() - t0
    rf0 = float(bundle["rf_baseline"])
    t0 = time.perf_counter()
    _, _, res = reshard_bundle(bundle, cfg, k_new, src, dst, device=dev)
    t_resize = time.perf_counter() - t0
    print(f"{partitioner:10s} k={k} RF={rf0:7.3f}  [{t_cold:.1f}s cold]")
    print(f"resize →k={k_new} RF={res.rf:7.3f} balance={res.balance:5.2f} "
          f"migrated={res.migrated_fraction:.1%} "
          f"({res.migrated_edges}/{res.n_live} edges, "
          f"{res.n_displaced} displaced, {res.moved_clusters} clusters "
          f"moved, {res.game_rounds} rounds)  [{t_resize:.1f}s]")
    return res


def _run_incremental_cli(src, dst, n, k, partitioner, seed, compare, *,
                         stream, chunk_size, ordering, num_streams,
                         super_chunk, shard, save_carry, resume_carry, delta,
                         delete, drift_threshold, refine_rounds,
                         xi_refresh_threshold, dev):
    """``--save-carry`` / ``--resume-carry`` / ``--delta`` / ``--delete``."""
    from ..incremental import cold_start, run_incremental

    if compare:
        raise ValueError("carry flows need a single --partitioner, "
                         "not --compare")
    if delta and not resume_carry:
        raise ValueError("--delta needs --resume-carry (an insertion batch "
                         "is replayed against a saved carry)")
    if delete and not resume_carry:
        raise ValueError("--delete needs --resume-carry (deletions retract "
                         "against a saved carry)")
    if ordering != "natural":
        raise ValueError(
            "incremental carries assume natural (insertion-order) streams; "
            f"a {ordering!r} reordering permutes the whole grown stream and "
            "has no stable prefix to resume from")
    if delta:
        dsrc, ddst, dn = load_graph(delta, seed + 1)
        src = np.concatenate([np.asarray(src, np.int32),
                              np.asarray(dsrc, np.int32)])
        dst = np.concatenate([np.asarray(dst, np.int32),
                              np.asarray(ddst, np.int32)])
        n = max(n, dn)
    cfg = _s5p_cfg(k, seed, chunk_size, ordering, num_streams, super_chunk,
                   drift_threshold, refine_rounds, xi_refresh_threshold,
                   shard)
    if resume_carry:
        delete_idx = _parse_delete(delete, len(src), seed) if delete else None
        t0 = time.perf_counter()
        res = run_incremental(
            resume_carry, partitioner, src, dst, n, k, seed=seed,
            chunk_size=chunk_size, s5p_config=cfg, delete=delete_idx,
            num_streams=num_streams, super_chunk=super_chunk, save=True,
            save_dir=save_carry, device=dev)
        dt = time.perf_counter() - t0
        cold_note = " NEEDS-COLD-RESTART" if res.needs_cold_restart else ""
        print(f"{partitioner:10s} RF={res.rf:7.3f} balance={res.balance:5.2f} "
              f"delta={res.n_delta_edges} deleted={res.n_retracted} "
              f"replay={res.replay_fraction:.1%} "
              f"drift={res.rf_drift:+.3f} churn={res.churn:.2f} "
              f"refined={res.refined} rolled_back={res.rolled_back} "
              f"rounds={res.game_rounds}  {dt:6.1f}s{cold_note}")
        return res
    t0 = time.perf_counter()
    parts, path = cold_start(save_carry, partitioner, src, dst, n, k,
                             seed=seed, chunk_size=chunk_size,
                             s5p_config=cfg, stream=stream,
                             num_streams=num_streams,
                             super_chunk=super_chunk, device=dev)
    dt = time.perf_counter() - t0
    s = torch.from_numpy(np.asarray(src, np.int32)).to(dev)
    d = torch.from_numpy(np.asarray(dst, np.int32)).to(dev)
    p = torch.from_numpy(parts).to(dev)
    rf = replication_factor(s, d, p, n_vertices=n, k=k)
    bal = load_balance(p, k=k)
    print(f"{partitioner:10s} RF={rf:7.3f} balance={bal:5.2f} "
          f"carry→{path}  {dt:6.1f}s")
    return [(partitioner, rf, bal, None, dt)]


def run(graph: str, k: int, partitioner: str = "s5p", *, seed: int = 0,
        compare: bool = False, chunk_size: int = 1 << 16,
        ordering: str = "natural", window: int = 4096, num_streams: int = 1,
        super_chunk: int | str = 8, shard: str = "range",
        save_carry: str | None = None, resume_carry: str | None = None,
        delta: str | None = None, delete: str | None = None,
        drift_threshold: float | None = None,
        refine_rounds: int | None = None,
        xi_refresh_threshold: float | None = None,
        window_edges: int | None = None, window_step: int | None = None,
        resize_k: int | None = None, host_budget: int | None = None,
        hybrid: bool = False, budget_fraction: float = 0.5, device=None):
    """Partition ``graph`` with one partitioner (or all, ``compare``) and
    print one row each.  Returns ``[(name, rf, balance, gas_comm_bytes,
    seconds), ...]``, the reference's rows; the carry flows return the
    reference's results instead (a cold start's row, an
    ``IncrementalResult``, or the window's ``WindowStep`` history), and
    ``host_budget`` / ``hybrid`` the ``HybridResult``."""
    for pname, v in (("k", k), ("chunk_size", chunk_size), ("window", window),
                     ("num_streams", num_streams)):
        if v < 1:
            raise ValueError(f"{pname} must be >= 1, got {v}")
    if isinstance(super_chunk, str):
        if super_chunk != "auto":
            raise ValueError(
                f"super_chunk must be >= 1 or 'auto', got {super_chunk!r}")
    elif super_chunk < 1:
        raise ValueError(f"super_chunk must be >= 1, got {super_chunk}")
    if shard not in SHARD_MODES:
        raise ValueError(f"shard must be one of range | rr | round-robin | "
                         f"hub, got {shard!r}")
    if hybrid and host_budget is None:
        host_budget = auto_host_budget(budget_fraction)
        print(f"[hybrid] auto-sized --host-budget: {host_budget} bytes "
              f"({budget_fraction:.0%} of available host memory)")
    if host_budget is not None:
        if partitioner != "s5p":
            raise ValueError("--host-budget drives the s5p hybrid pipeline; "
                             "use --partitioner s5p")
        if (compare or window_edges is not None or resize_k is not None
                or resume_carry or delta or delete):
            raise ValueError("--host-budget runs a single hybrid partition; "
                             "drop --compare/--window-edges/--resize-k/"
                             "carry-resume flags (--save-carry combines)")
    if resize_k is not None:
        if compare or window_edges is not None or resume_carry or delta or delete:
            raise ValueError("--resize-k runs a single cold partition "
                             "followed by an elastic reshard; drop "
                             "--compare/--window-edges/carry flags")
    dev = resolve_device(device)
    on_disk = graph.startswith("file:")
    if on_disk:
        stream = open_sharded_stream(graph[5:], chunk_size=chunk_size,
                                     ordering=ordering, seed=seed,
                                     window=window, device=dev)
        n = stream.n_vertices
        # the metrics (and the rows that take no stream) read the arrival
        # arrays: the one O(E) read of the shards; every scan pages
        src, dst = stream.arrival_arrays()
    else:
        src, dst, n = load_graph(graph, seed)
    if num_streams > 1:
        # more lanes than chunks, or a super-chunk longer than a lane,
        # would degenerate silently: refuse them as the reference does
        n_chunks = max(-(-len(src) // chunk_size), 1)
        if num_streams > n_chunks:
            raise ValueError(
                f"num_streams must be <= the stream's chunk count "
                f"({n_chunks} chunks of {chunk_size}), got {num_streams}")
        rounds = -(-n_chunks // num_streams)
        if not isinstance(super_chunk, str) and super_chunk > rounds:
            raise ValueError(
                f"super_chunk must be <= the {rounds} chunks each of the "
                f"{num_streams} sub-streams ingests (else it degenerates "
                f"to a single merge), got {super_chunk}")
    if host_budget is not None:
        try:
            return _run_hybrid_cli(
                src, dst, n, k, seed, host_budget,
                stream=stream if on_disk else None, chunk_size=chunk_size,
                ordering=ordering, num_streams=num_streams,
                super_chunk=super_chunk, shard=shard,
                refine_rounds=refine_rounds, save_carry=save_carry, dev=dev)
        finally:
            if on_disk:
                stream.close()
    if resize_k is not None:
        try:
            return _run_resize_cli(
                src, dst, n, k, resize_k, partitioner, seed,
                chunk_size=chunk_size, drift_threshold=drift_threshold,
                refine_rounds=refine_rounds,
                xi_refresh_threshold=xi_refresh_threshold, dev=dev)
        finally:
            if on_disk:
                stream.close()
    carry_flow = save_carry or resume_carry or delta or delete
    if window_edges is not None:
        if compare:
            raise ValueError("--window-edges runs a single partitioner, "
                             "not --compare")
        if num_streams > 1:
            raise ValueError("--window-edges is sequential (the per-step "
                             "delta/retract batches are not sharded); drop "
                             "--num-streams")
        for flag, val in (("--save-carry", save_carry),
                          ("--resume-carry", resume_carry),
                          ("--delta", delta), ("--delete", delete)):
            if val:
                raise ValueError(
                    f"{flag} does not combine with --window-edges (the "
                    "window loop manages its own bundle in memory)")
    if window_edges is not None or carry_flow:
        kw = dict(chunk_size=chunk_size, ordering=ordering,
                  drift_threshold=drift_threshold, refine_rounds=refine_rounds,
                  xi_refresh_threshold=xi_refresh_threshold, dev=dev,
                  stream=stream if on_disk else None)
        try:
            if window_edges is not None:
                return _run_window_cli(src, dst, n, k, partitioner, seed,
                                       window_edges, window_step, **kw)
            return _run_incremental_cli(
                src, dst, n, k, partitioner, seed, compare,
                num_streams=num_streams, super_chunk=super_chunk, shard=shard,
                save_carry=save_carry, resume_carry=resume_carry,
                delta=delta, delete=delete, **kw)
        finally:
            if on_disk:
                stream.close()
    s = torch.from_numpy(src).to(dev)
    d = torch.from_numpy(dst).to(dev)
    # one replayable stream, in the requested order, for every row that
    # takes one; the others run on the arrays in arrival order
    if not on_disk:
        stream = EdgeStream(src, dst, n, chunk_size=chunk_size, ordering=ordering,
                            seed=seed, window=window, device=dev)
    print(f"graph={graph} device={dev} |V|={n} |E|={src.size} k={k}")
    rows = []
    for name in (list(PARTITIONERS) if compare else [partitioner]):
        fn = PARTITIONERS[name]
        params = inspect.signature(fn).parameters
        takes_stream = "stream" in params
        kw = {"stream": stream} if takes_stream else {"device": dev}
        if num_streams > 1 and "num_streams" in params:
            kw.update(num_streams=num_streams, super_chunk=super_chunk,
                      shard=shard)
        if name in S5P_BASED:
            kw["full_output"] = True
        t0 = time.perf_counter()
        out = fn(src, dst, n, k, seed, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        parts = out.parts if name in S5P_BASED else out
        rf = replication_factor(s, d, parts, n_vertices=n, k=k)
        bal = load_balance(parts, k=k)
        comm = gas_comm_bytes(s, d, parts, n_vertices=n, k=k)
        rows.append((name, rf, bal, comm, dt))
        note = ("" if takes_stream else "  [in-memory, natural]" if on_disk
                else "" if ordering == "natural" else "  [natural]")
        print(f"{name:10s} RF={rf:7.3f} balance={bal:5.2f} "
              f"gas_comm={comm/1e6:8.2f} MB/iter  {dt:6.1f}s{note}")
        if name in S5P_BASED:
            print(f"{'':10s} clusters={out.n_clusters} (head {out.n_head_clusters}) "
                  f"game_rounds={out.game_rounds} converged={out.game_converged} "
                  "seconds: " + " ".join(f"{p}={v:.3f}" for p, v in out.timings.items()))
    if on_disk:
        peak = stream.budget.peak_bytes
        print(f"[oocstream] peak stream-host bytes (stream-backed rows): "
              f"{peak} ({peak / max(8 * len(src), 1):.1%} of the edge list)")
        stream.close()
    return rows


def _positive_int(value: str) -> int:
    v = int(value)
    if v < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {v}")
    return v


def _super_chunk_arg(value: str):
    """argparse type of ``--super-chunk``: a chunk count >= 1 or ``auto``."""
    if value.strip().lower() == "auto":
        return "auto"
    try:
        return _positive_int(value)
    except (ValueError, argparse.ArgumentTypeError):
        raise argparse.ArgumentTypeError(
            f"expected a chunk count >= 1 or 'auto', got {value!r}")


def _fraction_arg(value: str) -> float:
    """argparse type of ``--budget-fraction``: a float in (0, 1]."""
    try:
        fv = float(value)
    except ValueError:
        raise argparse.ArgumentTypeError(f"expected a fraction, got {value!r}")
    if not 0 < fv <= 1:
        raise argparse.ArgumentTypeError(
            f"must be a fraction in (0, 1], got {value!r}")
    return fv


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--graph", default="community:4000",
                    help="rmat:S | powerlaw:N | community:N | toy | "
                         "file:<shard manifest.json>")
    ap.add_argument("--k", type=_positive_int, default=8)
    ap.add_argument("--partitioner", default="s5p", choices=list(PARTITIONERS))
    ap.add_argument("--compare", action="store_true",
                    help="run every partitioner, one row each")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk-size", type=_positive_int, default=1 << 16)
    ap.add_argument("--ordering", choices=ORDERINGS, default="natural",
                    help="stream order of the partitioners that take a stream")
    ap.add_argument("--window", type=_positive_int, default=4096,
                    help="the windowed ordering's buffer of edges")
    ap.add_argument("--num-streams", type=_positive_int, default=1,
                    help="parallel-ingest lanes a pass (1 = sequential)")
    ap.add_argument("--super-chunk", type=_super_chunk_arg, default=8,
                    help="chunks a lane folds between merges, or 'auto'")
    ap.add_argument("--shard-mode", default="range", choices=SHARD_MODES,
                    help="how edges are dealt onto the lanes: chunk ranges, "
                         "interleaved chunks (rr) or hub-pinned edges")
    ap.add_argument("--write-shards", default=None, metavar="DIR",
                    help="write --graph as edge shards in DIR and exit")
    ap.add_argument("--shard-edges", type=_positive_int, default=1 << 20,
                    help="edges a shard, for --write-shards")
    ap.add_argument("--append", action="store_true",
                    help="with --write-shards: grow the shard directory in place")
    ap.add_argument("--save-carry", default=None, metavar="DIR",
                    help="persist the partitioner's warm-start carry bundle "
                         "to DIR (greedy/hdrf/grid/s5p)")
    ap.add_argument("--resume-carry", default=None, metavar="DIR",
                    help="warm-start from the carry in DIR; the delta is "
                         "everything past its recorded stream position "
                         "(grow file: graphs via --write-shards --append) "
                         "plus any --delta batch")
    ap.add_argument("--delta", default=None, metavar="SPEC",
                    help="insertion batch (same specs as --graph) appended "
                         "to the stream before resuming")
    ap.add_argument("--delete", default=None, metavar="SPEC",
                    help="deletion batch against a resumed carry: first:X | "
                         "last:X (count, or fraction when X < 1) | frac:F "
                         "(seeded random fraction)")
    ap.add_argument("--window-edges", type=_positive_int, default=None,
                    help="sliding-window mode: continuously partition the "
                         "last W edges of the stream (s5p)")
    ap.add_argument("--window-step", type=_positive_int, default=None,
                    help="edges admitted per sliding-window step "
                         "(default: min(chunk-size, window-edges))")
    ap.add_argument("--drift-threshold", type=float, default=None,
                    help="relative RF drift that triggers game refinement "
                         "on resume (s5p; default from S5PConfig)")
    ap.add_argument("--refine-rounds", type=int, default=None,
                    help="refinement budget in Stackelberg rounds "
                         "(s5p; 0 disables)")
    ap.add_argument("--xi-refresh-threshold", type=float, default=None,
                    help="relative ξ/κ drift past which a warm chain "
                         "reports needs_cold_restart (s5p; default from "
                         "S5PConfig)")
    ap.add_argument("--resize-k", type=_positive_int, default=None,
                    help="elastic resize: cold-partition at --k, then "
                         "reshard the s5p bundle to this k with bounded "
                         "migration (prints RF before/after + the migrated "
                         "fraction)")
    ap.add_argument("--host-budget", type=parse_bytes, default=None,
                    metavar="BYTES",
                    help="memory-budget hybrid mode: host bytes spendable "
                         "on a resident high-degree core (accepts 512M / "
                         "2G suffixes; 0 = pure streaming; s5p only)")
    ap.add_argument("--hybrid", action="store_true",
                    help="memory-budget hybrid mode with the budget "
                         "auto-sized from available host memory "
                         "(--budget-fraction of /proc/meminfo "
                         "MemAvailable, falling back to os.sysconf); "
                         "--host-budget overrides")
    ap.add_argument("--budget-fraction", type=_fraction_arg, default=0.5,
                    help="fraction of detected available memory --hybrid "
                         "spends on the resident core (default 0.5)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain versions)")
    a = ap.parse_args(argv)
    if a.append and not a.write_shards:
        ap.error("--append only makes sense with --write-shards DIR")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return _main(a, a.device)
    # under torchrun: every rank runs the same rows (--num-streams equal to
    # the world size resolves run_parallel to one lane a rank); rank 0
    # alone prints and writes
    rank = int(os.environ["RANK"])
    dev = _dist.init_world(rank, world, "env://", a.device)
    try:
        if rank == 0:
            return _main(a, dev)
        with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
            return _main(a, dev, writes=False)
    finally:
        _dist.shutdown()


def _main(a, device, writes: bool = True):
    if a.write_shards:
        if writes:
            write_shards_cli(a.graph, a.write_shards, a.shard_edges, a.seed,
                             append=a.append)
        return None
    return run(a.graph, a.k, a.partitioner, seed=a.seed, compare=a.compare,
        chunk_size=a.chunk_size, ordering=a.ordering, window=a.window,
        num_streams=a.num_streams, super_chunk=a.super_chunk,
        shard=a.shard_mode, save_carry=a.save_carry if writes else None,
        resume_carry=a.resume_carry, delta=a.delta, delete=a.delete,
        drift_threshold=a.drift_threshold, refine_rounds=a.refine_rounds,
        xi_refresh_threshold=a.xi_refresh_threshold,
        window_edges=a.window_edges, window_step=a.window_step,
        resize_k=a.resize_k, host_budget=a.host_budget, hybrid=a.hybrid,
        budget_fraction=a.budget_fraction, device=device)


if __name__ == "__main__":
    main()
