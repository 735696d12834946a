#!/usr/bin/env python3
"""Profile the port's LM serving path on one GPU with ``torch.profiler``.

    python3 scripts/profile_lm.py                  # llama3-8b, 4 × 4,096 tokens
    python3 scripts/profile_lm.py --layers 4       # a shorter run (fewer layers)

Draws ``llama3-8b``'s parameters (bf16, seed 0) and 4 prompts, runs one
prefill to warm up, then profiles one ``prefill`` and ``--steps`` greedy
``decode_step`` calls separately.  Prints one JSON line: for each of the
two, the profiled wall time, the device's busy share (CUDA kernel and
memcpy/memset time over wall time), device time by group (K6, cuBLAS
matmuls and batched products, everything else) and the top kernels and
host operators.  The full tables go to ``chiprun_out/profile_lm.txt``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dev_us(e):
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def _group(name: str) -> str:
    if "fa_fwd" in name:
        return "k6"
    low = name.lower()
    if any(t in low for t in ("gemm", "gemv", "nvjet", "cutlass", "xmma", "sm90_", "splitk")):
        return "matmul"
    return "other"


def _summary(prof, wall: float, group=_group) -> dict:
    """Busy share, device time by ``group(kernel name)``, top kernels and
    host operators of one profiled window of ``wall`` seconds."""
    events = prof.key_averages()
    kernels = [e for e in events if _dev_us(e) > 0 and e.device_type is not None
               and "cuda" in str(e.device_type).lower()]
    busy_us = sum(_dev_us(e) for e in kernels)
    groups: dict[str, float] = {}
    for e in kernels:
        groups[group(e.key)] = groups.get(group(e.key), 0.0) + _dev_us(e) / 1e6
    top = sorted(kernels, key=_dev_us, reverse=True)[:12]
    ops = sorted((e for e in events if e not in kernels),
                 key=lambda e: e.self_cpu_time_total, reverse=True)[:12]
    return {"profiled_wall_s": wall, "device_busy_s": busy_us / 1e6,
            "device_busy_share": busy_us / 1e6 / wall, "device_s_by_group": groups,
            "top_kernels": [{"name": e.key[:90], "calls": e.count,
                             "device_s": _dev_us(e) / 1e6} for e in top],
            "top_ops": [{"name": e.key[:60], "calls": e.count,
                         "self_cpu_s": e.self_cpu_time_total / 1e6} for e in ops],
            "table": events.table(sort_by="self_cuda_time_total", row_limit=40)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=None, help="cut the depth (default: 32)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import random as trandom
    from repro_torch.configs import get_arch
    from repro_torch.models import lm as LM

    if not torch.cuda.is_available():
        print("profile_lm: no CUDA device", file=sys.stderr)
        return 2
    cfg = get_arch("llama3-8b").config
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    dev = torch.device("cuda")
    key = trandom.PRNGKey(0)
    params = LM.init_params(cfg, key, device=dev)
    B, S = args.batch, args.prompt_len
    prompts = trandom.randint(key, (B, S), 0, cfg.vocab, device=dev)
    max_seq = S + args.steps + 2
    out = {"arch": "llama3-8b", "layers": cfg.n_layers, "batch": B, "prompt_len": S}
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.inference_mode():
        LM.prefill(params, prompts, cfg, max_seq=max_seq, device=dev)  # warm-up
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            logits, cache = LM.prefill(params, prompts, cfg, max_seq=max_seq, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out["prefill"] = _summary(prof, wall)
        toks = torch.argmax(logits, -1)
        for i in range(2):  # warm-up
            pos = torch.full((B,), S + i, dtype=torch.int32, device=dev)
            logits, cache = LM.decode_step(params, cache, toks, pos, cfg, device=dev)
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for i in range(args.steps):
                pos = torch.full((B,), S + 2 + i, dtype=torch.int32, device=dev)
                logits, cache = LM.decode_step(params, cache, toks, pos, cfg, device=dev)
                toks = torch.argmax(logits, -1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out["decode"] = _summary(prof, wall)
        out["decode"]["steps"] = args.steps
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "profile_lm.txt"), "w") as f:
        for part in ("prefill", "decode"):
            f.write(f"== {part}\n{out[part].pop('table')}\n")
    out["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
