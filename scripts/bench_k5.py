#!/usr/bin/env python3
"""Time K5 (segment aggregation) on one GPU at the served graph's shapes.

    python3 scripts/bench_k5.py                         # ogbn_products_like, scale 1.0
    python3 scripts/bench_k5.py --scale 0.05 --sweep 2048,4096

Builds ``ogbn_products_like(seed=0)`` and the GCN's forward layout over its
edges (``gcn_norm``), then for each long-row threshold T of ``--sweep``
(rows of more than T edges get a block each) times K5 by CUDA events at
the four shapes of ``chip_smoke.py``'s K5 rows: the degree counts (d = 1,
weights 1), layers 1 and 2 (d = 16 and 7, float32) and the features
(d = 100, bf16), with ``torch.sparse.mm`` on the same CSR matrix beside
it.  Inputs are random, from ``--seed``.  At the default T it also times
the hub row alone (a layout holding only the longest row's edges) and each
class of rows alone (short, medium, long), and holds every shape bitwise
against the plain version on the CPU.  Prints
one JSON line per (T, shape) and a last line with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHORT_ROW_EDGES = 64  # csrc/segment_agg.cu kMedium: longer rows go to a warp


def _ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _with_threshold(layout, t: int):
    import torch

    counts = layout.row_ptr.diff()
    rows = torch.nonzero(counts > t)[:, 0]
    rows = rows[torch.sort(counts[rows], descending=True, stable=True).indices]
    return layout._replace(long_rows=rows.to(torch.int32).contiguous(), long_row_edges=t)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--sweep", default="2048,4096,8192,16384")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    if not torch.cuda.is_available():
        print("bench_k5: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.graphs import ogbn_products_like
    from repro_torch.kernels.segment_agg import (LONG_ROW_EDGES, kernel_attributes,
                                                 segment_agg, segment_layout)
    from repro_torch.models.gnn import gcn_norm

    dev = torch.device("cuda")
    g = ogbn_products_like(seed=0, scale=args.scale)
    n = g.n_vertices
    lay = gcn_norm(g.src, g.dst, n, device=dev).fwd
    unit = lay.with_weights(torch.ones(lay.n_edges, device=dev))
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    shapes = [("degrees d=1 f32", torch.ones(n, 1, device=dev), unit),
              ("layer 1 d=16 f32", torch.randn(n, 16, device=dev, generator=gen), lay),
              ("layer 2 d=7 f32", torch.randn(n, 7, device=dev, generator=gen), lay),
              ("features d=100 bf16",
               torch.randn(n, 100, device=dev, generator=gen).to(torch.bfloat16), lay)]
    counts = lay.row_ptr.diff()
    hub = int(torch.argmax(counts))
    e0, e1 = int(lay.row_ptr[hub]), int(lay.row_ptr[hub + 1])
    for t in [int(v) for v in args.sweep.split(",")]:
        for name, x, base in shapes:
            layout = _with_threshold(base, t)
            n_long = int(layout.long_rows.numel())
            flags = torch.zeros(n_long, dtype=torch.int32, device=dev)
            segment_agg(x, layout, tree_flags=flags)
            row = {"T": t, "shape": name, "V": n, "edges": int(layout.src.numel()),
                   "max_row": int(counts.max()), "n_long": n_long,
                   "tree_rows": int(flags.sum()),
                   "ms": _ms(lambda: segment_agg(x, layout), args.reps)}
            if t == LONG_ROW_EDGES:
                csr = torch.sparse_csr_tensor(layout.row_ptr, layout.src.long(),
                                              layout.w.to(x.dtype), size=(n, n))
                row["library_ms"] = _ms(lambda: torch.sparse.mm(csr, x), args.reps)
                hub_lay = segment_layout(layout.src[e0:e1],
                                         torch.zeros(e1 - e0, dtype=torch.int32, device=dev),
                                         1, layout.w[e0:e1], device=dev)
                row["hub_row_ms"] = _ms(lambda: segment_agg(x, hub_lay), args.reps)
                # the same launch over each class of rows alone: short (a group of
                # threads), medium (a warp), long (a block per slice of columns)
                per_edge = counts[layout.dst.long()]
                for cls, keep in (("short", per_edge <= SHORT_ROW_EDGES),
                                  ("medium", (per_edge > SHORT_ROW_EDGES) & (per_edge <= t)),
                                  ("long", per_edge > t)):
                    sub = segment_layout(layout.src[keep], layout.dst[keep], n, layout.w[keep],
                                         device=dev)
                    row[f"{cls}_rows_ms"] = _ms(lambda: segment_agg(x, sub), args.reps)
                row["kernel"] = kernel_attributes(x)
                got = segment_agg(x, layout).cpu()
                cpu = layout._replace(**{k: getattr(layout, k).cpu() for k in
                                         ("src", "dst", "w", "row_ptr", "order", "long_rows")})
                want = segment_agg(x.cpu(), cpu)
                bits = torch.int32 if x.dtype == torch.float32 else torch.int16
                row["bitwise"] = bool(torch.equal(got.view(bits), want.view(bits)))
            print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
