"""Serving entry point of the port: batched greedy decoding of an LM (dense
or Mixtral's MoE), batched scoring of the recsys model, and live partition
serving of a graph.

  python -m repro_torch.launch.serve --arch llama3-8b --tokens 16 --device cpu
  python -m repro_torch.launch.serve --arch mixtral-8x7b --tokens 32 --device cpu
  python -m repro_torch.launch.serve --arch llama3-8b --full --batch 4 --prompt-len 4096 --tokens 32
  python -m repro_torch.launch.serve --arch xdeepfm --device cpu
  python -m repro_torch.launch.serve --arch xdeepfm --full --batch 512

``serve_lm`` draws the parameters and the prompts from one key, runs
``prefill`` over the prompts (K6 in every layer on the card) and then one
``decode_step`` per generated token.  ``serve_recsys`` draws xDeepFM's
parameters and one id column per field from one key and scores them
(K7 in every CIN layer on the card).  Both print the reference's line
(``repro.launch.serve``).  The smoke config runs unless ``--full`` asks for
the published one.  Runs on ``cuda`` unless ``--device`` names another
device.

  python -m repro_torch.launch.serve --graph block-rmat --window 4096 [--background]

``serve_graph`` runs the live partition-serving loop instead: a
sliding-window S5P chain churns (in a background ingest thread with
``--background``), each step published as an atomic bundle swap, while a
GAS PageRank reader runs supersteps and point queries over the pinned
versions (:mod:`repro_torch.serving`).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from .. import random as jrandom
from .._device import resolve_device
from ..configs import get_arch
from ..models import lm as LM
from ..models import recsys as R

__all__ = ["serve_lm", "serve_recsys", "recsys_ids", "serve_graph", "main"]


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_lm(arch: str, prompt_len: int = 32, gen_tokens: int = 16, batch: int = 2,
             smoke: bool = True, seed: int = 0, device=None, stats: dict | None = None,
             n_layers: int | None = None):
    """Greedy decoding of ``gen_tokens`` tokens after ``batch`` random
    prompts of ``prompt_len`` tokens; returns the (batch, gen_tokens) int32
    tokens.  Parameters and prompts come from ``PRNGKey(seed)`` as in the
    reference (``randint`` over the vocabulary for the prompts).
    ``n_layers`` cuts the config's depth (default: the config's).

    With a ``stats`` dict the run also records, on the host clock around
    work that ends in a device synchronise: ``init_s``, ``prefill_s``,
    ``decode_s`` (one entry per decode step), the first and last logits
    (``prefill_logits``, ``last_logits``), on the card the peak device
    memory after the parameters are drawn (``init_peak_bytes``), and for
    an MoE model ``moe``: per layer of the prefill, the ``dropped``
    assignments and each expert's ``load`` (assignments given it), per
    batch row, read from the block's own routing."""
    dev = resolve_device(device)
    spec = get_arch(arch)
    cfg = spec.smoke_config if smoke else spec.config
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    key = jrandom.PRNGKey(seed)
    timed = stats is not None
    t0 = time.perf_counter()
    params = LM.init_params(cfg, key, device=dev)
    prompts = jrandom.randint(key, (batch, prompt_len), 0, cfg.vocab, device=dev)
    max_seq = prompt_len + gen_tokens
    if timed:
        _sync(dev)
        stats["init_s"] = time.perf_counter() - t0
        if dev.type == "cuda":
            stats["init_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        stats["decode_s"] = []
    routes = [] if timed and cfg.is_moe else None
    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, cache = LM.prefill(params, prompts, cfg, max_seq=max_seq, device=dev,
                                   routes=routes)
        toks = torch.argmax(logits, dim=-1)
        out = [toks]
        if timed:
            _sync(dev)
            stats["prefill_s"] = time.perf_counter() - t0
            stats["prefill_logits"] = logits
        for i in range(gen_tokens - 1):
            t1 = time.perf_counter()
            pos = torch.full((batch,), prompt_len + i, dtype=torch.int32, device=dev)
            logits, cache = LM.decode_step(params, cache, toks, pos, cfg, device=dev)
            toks = torch.argmax(logits, dim=-1)
            out.append(toks)
            if timed:
                _sync(dev)
                stats["decode_s"].append(time.perf_counter() - t1)
        seqs = torch.stack(out, dim=1).to(torch.int32)
        _sync(dev)
    dt = time.perf_counter() - t0
    if timed:
        stats["last_logits"] = logits
        if routes is not None:
            stats["moe"] = [{"dropped": (~r["keep"]).sum(dim=-1).tolist(),
                             "load": r["load"].tolist()} for r in routes]
    print(f"[serve] {arch}: {batch}×{gen_tokens} tokens in {dt:.2f}s "
          f"({dt / gen_tokens * 1e3:.1f} ms/token)")
    return seqs


def recsys_ids(key, cfg: R.XDeepFMConfig, batch: int, device) -> torch.Tensor:
    """(batch, n_fields) int32 ids as the reference draws a request: field
    ``f`` is ``randint(fold_in(key, f), (batch,), 0, vocab_f)``."""
    cols = [jrandom.randint(jrandom.fold_in(key, f), (batch,), 0, v, device=device)
            for f, v in enumerate(cfg.vocabs())]
    return torch.stack(cols, dim=1)


def serve_recsys(arch: str = "xdeepfm", batch: int = 64, smoke: bool = True, seed: int = 0,
                 device=None, stats: dict | None = None) -> torch.Tensor:
    """Score one request of ``batch`` samples; returns the (batch,) logits.
    Parameters and ids come from ``PRNGKey(seed)`` as in the reference.

    With a ``stats`` dict the run also records, on the host clock around
    work that ends in a device synchronise: ``init_s`` (parameters and
    ids), ``forward_s``, the ``scores``, the ``params`` and ``ids`` it
    drew, each CIN layer's ``pools`` and, on the card, the peak device
    memory after the parameters are drawn (``init_peak_bytes``) and after
    the forward (``peak_bytes``)."""
    dev = resolve_device(device)
    spec = get_arch(arch)
    cfg = spec.smoke_config if smoke else spec.config
    key = jrandom.PRNGKey(seed)
    timed = stats is not None
    t0 = time.perf_counter()
    params = R.xdeepfm_init(cfg, key, device=dev)
    ids = recsys_ids(key, cfg, batch, dev)
    if timed:
        _sync(dev)
        stats["init_s"] = time.perf_counter() - t0
        if dev.type == "cuda":
            stats["init_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    pools = [] if timed else None
    with torch.inference_mode():
        t0 = time.perf_counter()
        scores = R.xdeepfm_forward(params, ids, cfg, pools=pools)
        _sync(dev)
    dt = time.perf_counter() - t0
    if timed:
        stats.update(forward_s=dt, scores=scores, params=params, ids=ids, pools=pools)
        if dev.type == "cuda":
            stats["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    print(f"[serve] {arch}: scored {batch} in {dt * 1e3:.1f} ms")
    return scores


def serve_graph(graph: str = "block-rmat", k: int = 8,
                window_edges: int = 4096, step_edges: int | None = None,
                supersteps_per_swap: int = 4, queries_per_swap: int = 2,
                auto_cold_restart: bool = True, background: bool = False,
                seed: int = 0, verbose: bool = True, device=None):
    """The live partition-serving loop: a sliding-window S5P chain over
    ``graph``'s edge stream (``block-rmat`` or ``community``, the
    reference's sizes), a :class:`~repro_torch.serving.ServingController`
    publishing each step's live window as an atomic bundle swap, and a
    :class:`~repro_torch.serving.GASServer` running PageRank supersteps and
    point queries over the pinned versions.  ``background`` runs ingest on
    its own thread with a free-running reader; otherwise churn and compute
    interleave deterministically.  Returns ``(server, controller)``."""
    import numpy as np

    from ..core.s5p import S5PConfig
    from ..graphs import block_rmat_graph, community_graph
    from ..incremental import S5PWindowChain
    from ..serving import BundleRegistry, GASServer, ServingController

    dev = resolve_device(device)
    if graph == "block-rmat":
        src, dst, n = block_rmat_graph(block_scale=6, n_blocks=16,
                                       edge_factor=8, seed=seed)
    elif graph == "community":
        src, dst, n = community_graph(4096, n_communities=32, seed=seed)
    else:
        raise ValueError(f"unknown --graph {graph!r}; one of block-rmat | community")
    cfg = S5PConfig(k=k, seed=seed, chunk_size=max(window_edges, 1024))
    chain = S5PWindowChain(src, dst, n, cfg, window_edges,
                           step_edges=step_edges,
                           auto_cold_restart=auto_cold_restart, device=dev)
    registry = BundleRegistry()
    controller = ServingController(registry, chain)
    server = GASServer(registry)
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    if background:
        controller.start(throttle_s=0.001)
        while not controller.done.is_set() or registry.current is None:
            if server.superstep() is None:
                time.sleep(0.001)
                continue
            server.query_pagerank(rng.integers(0, n, 16))
            if controller.done.is_set():
                break
        controller.join()
    else:
        while controller.step() is not None:
            if registry.current is None:
                continue  # window still filling
            for _ in range(supersteps_per_swap):
                server.superstep()
            for _ in range(queries_per_swap):
                server.query_pagerank(rng.integers(0, n, 16))
    server.run_to_convergence()
    if verbose:
        s = server.metrics.summary()
        print(f"[serve] graph={graph} V={n} E={src.size} k={k} "
              f"window={window_edges}")
        print(f"[serve] versions={controller.version} "
              f"swaps_observed={s['swaps_observed']} "
              f"supersteps={s['supersteps']} "
              f"bytes/superstep={s['sync_bytes_per_superstep']:.0f} "
              f"rf={s['rf_final']:.3f} "
              f"query_lat={s['query_latency_us_mean']:.0f}us "
              f"wall={time.perf_counter() - t0:.1f}s")
    return server, controller


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--full", action="store_true",
                    help="the published config instead of the smoke config")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--graph", default=None,
                    help="serve a live-partitioned graph instead of a "
                         "model: block-rmat | community")
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--window", type=int, default=4096)
    ap.add_argument("--step-edges", type=int, default=None)
    ap.add_argument("--background", action="store_true",
                    help="run ingest on a background thread (free-running "
                         "reader) instead of deterministic interleave")
    ap.add_argument("--no-cold-restart", action="store_true")
    args = ap.parse_args(argv)
    if args.graph is not None:
        serve_graph(args.graph, k=args.k, window_edges=args.window,
                    step_edges=args.step_edges, background=args.background,
                    auto_cold_restart=not args.no_cold_restart, seed=args.seed,
                    device=args.device)
    elif get_arch(args.arch).family == "recsys":
        serve_recsys(args.arch, batch=args.batch, smoke=not args.full, seed=args.seed,
                     device=args.device)
    else:
        serve_lm(args.arch, prompt_len=args.prompt_len, gen_tokens=args.tokens,
                 batch=args.batch, smoke=not args.full, seed=args.seed,
                 device=args.device)


if __name__ == "__main__":
    main()
