"""Partitioning driver of the port: S5P and the paper's baselines on one graph.

  python -m repro_torch.launch.partition --graph rmat:16 --k 32
  python -m repro_torch.launch.partition --graph community:2000 --k 8 --compare --device cpu

``--partitioner NAME`` runs one entry of ``PARTITIONERS`` (default
``s5p``), ``--compare`` runs all of them.  Each prints the reference's row
(``repro.launch.partition``): name, RF, balance, GAS sync MB per
iteration and seconds (host clock around work that ends in
``torch.cuda.synchronize()`` on cuda); a row that runs S5P's pipeline
(``S5P_BASED``) adds an indented line with its clusters, game rounds and
per-phase seconds.  Runs on ``cuda`` unless
``--device`` names another device.  ``file:`` graphs, ``--write-shards``
and the incremental, hybrid and elastic flags wait for later slices.
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
from ..streaming import ORDERINGS, EdgeStream


def load_graph(spec: str, seed: int = 0):
    """``rmat:S | community:N | powerlaw:N | toy`` → (src, dst, n)."""
    kind, _, arg = spec.partition(":")
    if kind == "rmat":
        return rmat_graph(int(arg or 14), edge_factor=8, seed=seed)
    if kind == "powerlaw":
        return powerlaw_graph(int(arg or 10000), seed=seed)
    if kind == "community":
        return community_graph(int(arg or 4000), seed=seed)
    if kind == "toy":
        return toy_graph_fig3()
    raise ValueError(f"unknown graph spec {spec!r}")


def run(graph: str, k: int, partitioner: str = "s5p", *, seed: int = 0,
        compare: bool = False, chunk_size: int = 1 << 16,
        ordering: str = "natural", device=None) -> list[tuple]:
    """Partition ``graph`` with one partitioner (or all, ``compare``) and
    print one row each.  Returns ``[(name, rf, balance, gas_comm_bytes,
    seconds), ...]``, the reference's rows."""
    dev = resolve_device(device)
    src, dst, n = load_graph(graph, seed)
    s = torch.from_numpy(src).to(dev)
    d = torch.from_numpy(dst).to(dev)
    # one replayable stream, in the requested order, for every row that
    # takes one; the others run on the arrays in arrival order
    stream = EdgeStream(src, dst, n, chunk_size=chunk_size, ordering=ordering,
                        seed=seed, device=dev)
    print(f"graph={graph} device={dev} |V|={n} |E|={src.size} k={k}")
    rows = []
    for name in (list(PARTITIONERS) if compare else [partitioner]):
        fn = PARTITIONERS[name]
        takes_stream = "stream" in inspect.signature(fn).parameters
        kw = {"stream": stream} if takes_stream else {"device": dev}
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
        note = "" if takes_stream or ordering == "natural" else "  [natural]"
        print(f"{name:10s} RF={rf:7.3f} balance={bal:5.2f} "
              f"gas_comm={comm/1e6:8.2f} MB/iter  {dt:6.1f}s{note}")
        if name in S5P_BASED:
            print(f"{'':10s} clusters={out.n_clusters} (head {out.n_head_clusters}) "
                  f"game_rounds={out.game_rounds} converged={out.game_converged} "
                  "seconds: " + " ".join(f"{p}={v:.3f}" for p, v in out.timings.items()))
    return rows


def _positive_int(value: str) -> int:
    v = int(value)
    if v < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {v}")
    return v


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--graph", default="community:4000",
                    help="rmat:S | powerlaw:N | community:N | toy")
    ap.add_argument("--k", type=_positive_int, default=8)
    ap.add_argument("--partitioner", default="s5p", choices=list(PARTITIONERS))
    ap.add_argument("--compare", action="store_true",
                    help="run every partitioner, one row each")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk-size", type=_positive_int, default=1 << 16)
    ap.add_argument("--ordering", choices=ORDERINGS, default="natural",
                    help="stream order of the partitioners that take a stream")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain versions)")
    a = ap.parse_args(argv)
    run(a.graph, a.k, a.partitioner, seed=a.seed, compare=a.compare,
        chunk_size=a.chunk_size, ordering=a.ordering, device=a.device)


if __name__ == "__main__":
    main()
