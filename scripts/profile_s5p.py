#!/usr/bin/env python3
"""Profile the port's S5P main path on one GPU with ``torch.profiler``.

    python3 scripts/profile_s5p.py --scale 18

Runs ``s5p_partition`` once to warm up, then once under the profiler on
the Graph500 R-MAT (``rmat_graph(scale, edge_factor=16)``), k = 32, default
``S5PConfig``.  Prints one JSON line: per-phase seconds, the device's busy
share of the profiled wall time (sum of CUDA kernel and memcpy/memset time
over wall time), and the top operators and kernels by CUDA time.  The full
table goes to ``chiprun_out/profile_s5p.txt``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=18)
    ap.add_argument("--k", type=int, default=32)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.s5p import S5PConfig, s5p_partition
    from repro_torch.graphs import rmat_graph

    if not torch.cuda.is_available():
        print("profile_s5p: no CUDA device", file=sys.stderr)
        return 2
    src, dst, n = rmat_graph(args.scale, edge_factor=16, seed=0)
    cfg = S5PConfig(k=args.k)
    s5p_partition(src, dst, n, cfg, device="cuda")  # builds kernels, warms up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = s5p_partition(src, dst, n, cfg, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    kernels = [e for e in events if dev_us(e) > 0 and e.device_type is not None
               and "cuda" in str(e.device_type).lower()]
    busy_us = sum(dev_us(e) for e in kernels)
    top = sorted(kernels, key=dev_us, reverse=True)[:15]
    ops = sorted((e for e in events if e not in kernels),
                 key=lambda e: e.self_cpu_time_total, reverse=True)[:15]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "profile_s5p.txt"), "w") as f:
        f.write(events.table(sort_by="self_cuda_time_total", row_limit=60))
    print(json.dumps({
        "graph": f"rmat:{args.scale} edge_factor=16 seed=0", "E": int(src.size),
        "k": args.k, "clusters": out.n_clusters, "game_rounds": out.game_rounds,
        "seconds": out.timings, "profiled_wall_s": wall,
        "device_busy_s": busy_us / 1e6, "device_busy_share": busy_us / 1e6 / wall,
        "top_kernels": [{"name": e.key[:80], "calls": e.count, "device_s": dev_us(e) / 1e6}
                        for e in top],
        "top_ops": [{"name": e.key[:80], "calls": e.count,
                     "self_cpu_s": e.self_cpu_time_total / 1e6} for e in ops],
        "nvidia_smi": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
