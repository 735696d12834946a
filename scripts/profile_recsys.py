#!/usr/bin/env python3
"""Profile the port's recsys serving path on one GPU with ``torch.profiler``.

    python3 scripts/profile_recsys.py              # xDeepFM, published config
    python3 scripts/profile_recsys.py --requests 4 --bulk 65536

Draws xDeepFM's published parameters (float32, seed 0), warms up with two
512-sample requests and one retrieval, then profiles separately:
``--requests`` ``serve_p99`` requests of 512 samples (each a forward and a
copy of the scores to the host), one ``serve_bulk`` request of ``--bulk``
samples, and one retrieval of 1 query against 1,000,000 candidates (top
100).  Prints one JSON line: for each, the profiled wall time, the device's
busy share (kernel and memcpy/memset time over wall time), device time by
group (K7, the embedding gathers, cuBLAS matmuls, everything else) and the
top kernels and host operators.  The full tables go to
``chiprun_out/profile_recsys.txt``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from profile_lm import _group as _lm_group  # noqa: E402
from profile_lm import _summary  # noqa: E402


def _group(name: str) -> str:
    if "cin_kernel" in name:
        return "k7"
    low = name.lower()
    if "index" in low and ("select" in low or "gather" in low):
        return "gather"
    return _lm_group(name)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--bulk", type=int, default=262_144)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import random as trandom
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import recsys_ids
    from repro_torch.models import recsys as R

    if not torch.cuda.is_available():
        print("profile_recsys: no CUDA device", file=sys.stderr)
        return 2
    cfg = get_arch("xdeepfm").config
    dev = torch.device("cuda")
    params = R.xdeepfm_init(cfg, trandom.PRNGKey(0), device=dev)
    p99_ids = [recsys_ids(trandom.PRNGKey(r), cfg, 512, dev) for r in range(args.requests)]
    bulk_ids = recsys_ids(trandom.PRNGKey(1000), cfg, args.bulk, dev)
    query = recsys_ids(trandom.PRNGKey(1001), cfg, 1, dev)
    cand = trandom.normal(trandom.PRNGKey(1002), (1_000_000, cfg.embed_dim), dev)
    out = {"arch": "xdeepfm", "params": "published, float32, seed 0",
           "p99_requests": args.requests, "bulk_batch": args.bulk}
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def window(fn):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return _summary(prof, wall, _group)

    with torch.inference_mode():
        for ids in p99_ids[:2]:  # warm-up
            R.xdeepfm_forward(params, ids, cfg).cpu()
        R.retrieval_scores(params, query, cand, cfg)[0].cpu()
        out["serve_p99"] = window(
            lambda: [R.xdeepfm_forward(params, ids, cfg).cpu() for ids in p99_ids])
        out["serve_bulk"] = window(lambda: R.xdeepfm_forward(params, bulk_ids, cfg).cpu())
        out["retrieval"] = window(
            lambda: [t.cpu() for t in R.retrieval_scores(params, query, cand, cfg)])
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "profile_recsys.txt"), "w") as f:
        for part in ("serve_p99", "serve_bulk", "retrieval"):
            f.write(f"== {part}\n{out[part].pop('table')}\n")
    out["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
