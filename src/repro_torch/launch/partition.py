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
names another device.  The incremental, hybrid (``--host-budget``) and
elastic flags wait for later slices.
"""

from __future__ import annotations

import argparse
import inspect
import time

import torch

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


def run(graph: str, k: int, partitioner: str = "s5p", *, seed: int = 0,
        compare: bool = False, chunk_size: int = 1 << 16,
        ordering: str = "natural", window: int = 4096, num_streams: int = 1,
        super_chunk: int | str = 8, shard: str = "range",
        device=None) -> list[tuple]:
    """Partition ``graph`` with one partitioner (or all, ``compare``) and
    print one row each.  Returns ``[(name, rf, balance, gas_comm_bytes,
    seconds), ...]``, the reference's rows."""
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
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain versions)")
    a = ap.parse_args(argv)
    if a.append and not a.write_shards:
        ap.error("--append only makes sense with --write-shards DIR")
    if a.write_shards:
        write_shards_cli(a.graph, a.write_shards, a.shard_edges, a.seed,
                         append=a.append)
        return
    run(a.graph, a.k, a.partitioner, seed=a.seed, compare=a.compare,
        chunk_size=a.chunk_size, ordering=a.ordering, window=a.window,
        num_streams=a.num_streams, super_chunk=a.super_chunk,
        shard=a.shard_mode, device=a.device)


if __name__ == "__main__":
    main()
