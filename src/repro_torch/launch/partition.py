"""Partitioning driver of the port: S5P on one graph.

  python -m repro_torch.launch.partition --graph rmat:16 --k 32
  python -m repro_torch.launch.partition --graph community:4000 --k 8 --device cpu

Prints |V|, |E|, clusters, game rounds, RF, balance and per-phase seconds.
Runs on ``cuda`` unless ``--device`` names another device.  The baselines
and ``--compare`` wait for slice 2 of the port.
"""

from __future__ import annotations

import argparse

import torch

from .._device import resolve_device
from ..core.metrics import load_balance, replication_factor
from ..core.s5p import S5PConfig, s5p_partition
from ..graphs import community_graph, powerlaw_graph, rmat_graph, toy_graph_fig3
from ..streaming import ORDERINGS


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


def run(graph: str, k: int, *, seed: int = 0, chunk_size: int = 1 << 16,
        ordering: str = "natural", device=None) -> dict:
    dev = resolve_device(device)
    src, dst, n = load_graph(graph, seed)
    cfg = S5PConfig(k=k, seed=seed, chunk_size=chunk_size, ordering=ordering)
    out = s5p_partition(src, dst, n, cfg, device=dev)
    s = torch.from_numpy(src).to(dev)
    d = torch.from_numpy(dst).to(dev)
    return {
        "graph": graph, "device": str(dev), "V": n, "E": int(src.shape[0]),
        "clusters": out.n_clusters, "head_clusters": out.n_head_clusters,
        "game_rounds": out.game_rounds, "game_converged": out.game_converged,
        "rf": replication_factor(s, d, out.parts, n_vertices=n, k=k),
        "balance": load_balance(out.parts, k=k),
        "seconds": out.timings,
    }


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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk-size", type=_positive_int, default=1 << 16)
    ap.add_argument("--ordering", choices=ORDERINGS, default="natural")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain versions)")
    a = ap.parse_args(argv)
    r = run(a.graph, a.k, seed=a.seed, chunk_size=a.chunk_size,
            ordering=a.ordering, device=a.device)
    print(f"graph={r['graph']} device={r['device']} |V|={r['V']} |E|={r['E']}")
    print(f"clusters={r['clusters']} (head {r['head_clusters']}) "
          f"game_rounds={r['game_rounds']} converged={r['game_converged']}")
    print(f"RF={r['rf']:.4f} balance={r['balance']:.4f}")
    print("seconds: " + " ".join(f"{k}={v:.3f}" for k, v in r["seconds"].items()))


if __name__ == "__main__":
    main()
