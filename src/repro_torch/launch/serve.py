"""Serving entry point of the port: batched greedy decoding of a dense LM.

  python -m repro_torch.launch.serve --arch llama3-8b --tokens 16 --device cpu
  python -m repro_torch.launch.serve --arch llama3-8b --full --batch 4 --prompt-len 4096 --tokens 32

``serve_lm`` draws the parameters and the prompts from one key, runs
``prefill`` over the prompts (K6 in every layer on the card) and then one
``decode_step`` per generated token, and prints the reference's line
(``repro.launch.serve``).  The smoke config runs unless ``--full`` asks for
the published one.  Runs on ``cuda`` unless ``--device`` names another
device.  ``serve_recsys`` waits for the recsys slice (xDeepFM, K7) and
``--graph`` for the incremental slice (``S5PWindowChain``).
"""

from __future__ import annotations

import argparse
import time

import torch

from .. import random as jrandom
from .._device import resolve_device
from ..configs import get_arch
from ..models import lm as LM

__all__ = ["serve_lm", "serve_recsys", "serve_graph", "main"]

_RECSYS = ("xdeepfm",)


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


def serve_recsys(arch: str = "xdeepfm", batch: int = 64, smoke: bool = True, seed: int = 0):
    raise NotImplementedError("serve_recsys (xDeepFM with the CIN kernel K7) is ported "
                              "with the recsys serving slice")


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
    elif args.arch in _RECSYS:
        serve_recsys(args.arch, batch=args.batch)
    else:
        serve_lm(args.arch, prompt_len=args.prompt_len, gen_tokens=args.tokens,
                 batch=args.batch, smoke=not args.full, seed=args.seed,
                 device=args.device)


if __name__ == "__main__":
    main()
