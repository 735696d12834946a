"""Serving entry point of the port: batched greedy decoding of a dense LM,
and batched scoring of the recsys model.

  python -m repro_torch.launch.serve --arch llama3-8b --tokens 16 --device cpu
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
device.  ``--graph`` waits for the incremental slice (``S5PWindowChain``).
"""

from __future__ import annotations

import argparse
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
             smoke: bool = True, seed: int = 0, device=None, stats: dict | None = None):
    """Greedy decoding of ``gen_tokens`` tokens after ``batch`` random
    prompts of ``prompt_len`` tokens; returns the (batch, gen_tokens) int32
    tokens.  Parameters and prompts come from ``PRNGKey(seed)`` as in the
    reference (``randint`` over the vocabulary for the prompts).

    With a ``stats`` dict the run also records, on the host clock around
    work that ends in a device synchronise: ``init_s``, ``prefill_s``,
    ``decode_s`` (one entry per decode step), the first and last logits
    (``prefill_logits``, ``last_logits``) and, on the card, the peak device
    memory after the parameters are drawn (``init_peak_bytes``)."""
    dev = resolve_device(device)
    spec = get_arch(arch)
    cfg = spec.smoke_config if smoke else spec.config
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
    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, cache = LM.prefill(params, prompts, cfg, max_seq=max_seq, device=dev)
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


def serve_graph(graph: str = "block-rmat", **kwargs):
    raise NotImplementedError("serve_graph needs S5PWindowChain and the serving "
                              "controller, ported with the incremental slice")


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
                    help="serve a live-partitioned graph (not ported yet)")
    args = ap.parse_args(argv)
    if args.graph is not None:
        serve_graph(args.graph)
    elif get_arch(args.arch).family == "recsys":
        serve_recsys(args.arch, batch=args.batch, smoke=not args.full, seed=args.seed,
                     device=args.device)
    else:
        serve_lm(args.arch, prompt_len=args.prompt_len, gen_tokens=args.tokens,
                 batch=args.batch, smoke=not args.full, seed=args.seed,
                 device=args.device)


if __name__ == "__main__":
    main()
