#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py              # the full run: R-MAT scale 20, k = 32
    python3 chip_smoke.py --scale 16   # a shorter main path and compare

Phases, each printing one JSON line:

1. device   — the card, as ``nvidia-smi`` reports its name and power limit;
2. build    — ``nvcc`` builds every kernel source of the port (in parallel);
3. main     — S5P under the default ``S5PConfig`` (CMS Θ, chunk 65,536, one
              stream) on the Graph500 R-MAT (a=0.57, b=c=0.19, seed 0),
              k = 32, with every kernel launch counter set to 0 just before
              and read just after; max load must hold and every kernel of
              the path (K1, K2, K4a, K4b) must have launched;
4. compare  — every other entry of ``PARTITIONERS`` on the main path's
              graph and k (the S5P row is the main run's), each with the
              launch counters set to 0 just before and read just after:
              parts must lie in [0, k), K3 must launch once per chunk for
              Greedy and HDRF, G1 once per chunk for grid; the rows that
              run S5P's pipeline report its per-phase seconds; then the
              delete path: the HDRF stream's last chunk is retracted from
              its final carry (``HdrfCarry.retract_chunk``, K3 with sign
              = -1, once) and the carry must equal the one rebuilt without
              that chunk; then PageRank (10 iterations) on the S5P and HDRF
              partitions: mirror-sync bytes, their ratio, seconds of the
              layout build and of the supersteps;
5. kernels  — each kernel's wrapper on card tensors at the main path's
              shapes against its plain PyTorch version on the same inputs:
              all must be bitwise equal (tolerance 0); times by CUDA
              events, the plain version's time, the bound, and a PyTorch
              library call where one computes the same function.  K3 and
              G1 run 4,096 edges onto the final state of the compare run;
6. parity   — every partitioner on ``community_graph(2000, 32, 8,
              seed=5)``, k = 8, on ``cuda`` and on ``cpu``: the parts must be
              identical.

Then one ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Any failure raises: the script exits
non-zero and prints no result.  It needs the rest of the repository
(``src/repro_torch``) and a CUDA device.  Long outputs (the compiler's
register report, the full results) go to ``chiprun_out/``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")

# H100 SXM peaks (NVIDIA data sheet):
# HBM3 bytes/s, and the float32 rate outside the tensor cores, used for
# the 32-bit integer work of these kernels.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int, setup=None) -> float:
    """Mean device time of ``fn`` by CUDA events over ``reps`` runs (after
    one warm-up); ``setup`` runs before each, outside the timed region."""
    import torch

    if setup is not None:
        setup()
    fn()
    total = 0.0
    for _ in range(reps):
        if setup is not None:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(stop)
    return total / reps


def host_time_ms(fn, reps: int = 1) -> float:
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(a, b) -> int:
    import torch

    if a.shape != b.shape:
        raise SystemExit(f"chip_smoke: shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")
    if not a.numel():
        return 0
    return int((a.cpu().to(torch.int64) - b.cpu().to(torch.int64)).abs().max())


def launch_counts() -> dict:
    from repro_torch.kernels.cms_sketch import kernel as cms_k
    from repro_torch.kernels.stream_scan import kernel as scan_k

    counts = scan_k.launch_counts()
    counts.update(cms_k.launch_counts())
    return counts


def reset_launch_counts() -> None:
    from repro_torch.kernels.cms_sketch import kernel as cms_k
    from repro_torch.kernels.stream_scan import kernel as scan_k

    scan_k.reset_launch_counts()
    cms_k.reset_launch_counts()


# --------------------------------------------------------------------- phases


def phase_device() -> dict:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    smi = nvidia_smi_line()
    print(smi, flush=True)
    info = {"phase": "device", "nvidia_smi": smi,
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0]}
    emit(info)
    return info


def phase_build() -> dict:
    from repro_torch.kernels import _build

    res = _build.build_all()
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "ptxas.log"), "w") as f:
        for name, log in res["logs"].items():
            f.write(f"== {name}\n{log}\n")
    info = {"phase": "build", "seconds": res["seconds"],
            "sources": {n: os.path.relpath(str(p), ROOT)
                        for n, p in _build.SOURCES.items()}}
    emit(info)
    return info


def phase_main(scale: int) -> dict:
    import torch

    from repro_torch.core.metrics import load_balance, partition_loads, replication_factor
    from repro_torch.core.s5p import S5PConfig, s5p_partition
    from repro_torch.graphs import rmat_graph

    t0 = time.perf_counter()
    src, dst, n = rmat_graph(scale, edge_factor=16, a=0.57, b=0.19, c=0.19, seed=0)
    gen_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    cfg = S5PConfig(k=32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = s5p_partition(src, dst, n, cfg, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()

    E = int(src.shape[0])
    parts = out.parts
    s_t = torch.from_numpy(src).to(dev)
    d_t = torch.from_numpy(dst).to(dev)
    loads = partition_loads(parts, k=cfg.k)
    info = {
        "phase": "main", "graph": f"rmat:{scale} edge_factor=16 seed=0",
        "V": n, "E": E, "k": cfg.k, "generate_s": gen_s,
        "clusters": out.n_clusters, "head_clusters": out.n_head_clusters,
        "tail_clusters": out.n_clusters - out.n_head_clusters,
        "xi": out.xi, "kappa": out.kappa,
        "game_rounds": out.game_rounds, "game_converged": out.game_converged,
        "rf": replication_factor(s_t, d_t, parts, n_vertices=n, k=cfg.k),
        "balance": load_balance(parts, k=cfg.k),
        "max_load": int(loads.max()), "max_load_cap": out.max_load,
        "seconds": out.timings, "wall_s": wall,
        "clustering_edges_per_s": E / out.timings["clustering"],
        "placement_edges_per_s": E / out.timings["postprocess"],
        "max_memory_allocated": peak, "launches": launches,
        "pairs": out.aux["n_pairs"],
    }
    emit(info)
    n_chunks = math.ceil(E / cfg.chunk_size)
    problems = []
    if info["max_load"] > out.max_load:
        problems.append(f"max load {info['max_load']} > cap {out.max_load}")
    if launches["cluster_scan"] != n_chunks or launches["assign_scan"] != n_chunks:
        problems.append(f"K1/K2 launches {launches} != {n_chunks} chunks")
    if launches["cms_update"] < 1 or launches["cms_query"] < 1:
        problems.append(f"CMS kernels not launched: {launches}")
    p = parts.cpu().numpy()
    if p.shape != (E,) or p.min() < 0 or p.max() >= cfg.k:
        problems.append("parts outside [0, k) on a graph without self-loops")
    if not math.isfinite(info["rf"]) or not 1.0 <= info["rf"] <= cfg.k:
        problems.append(f"RF {info['rf']} outside [1, k]")
    if problems:
        raise SystemExit("chip_smoke main path failed: " + "; ".join(problems))
    return {"info": info, "out": out, "src": src, "dst": dst, "n": n,
            "launches": launches, "cfg": cfg}


def check_k1(main) -> dict:
    import torch

    from repro_torch.core.clustering import ClusterState
    from repro_torch.kernels.stream_scan import cluster_chunk_oracle, cluster_scan

    out, cfg = main["out"], main["cfg"]
    state = out.aux["incremental"]["cluster_state"]
    degrees = out.aux["incremental"]["degrees"]
    E = 4096
    src = torch.from_numpy(main["src"][:E]).cuda()
    dst = torch.from_numpy(main["dst"][:E]).cuda()
    kw = dict(xi=out.xi, kappa=out.kappa, global_tail=cfg.bounded)
    work = [t.clone() for t in state]

    def reset():
        for w, s in zip(work, state):
            w.copy_(s)

    def run():
        cluster_scan(tuple(work), src, dst, degrees, **kw)

    ms = cuda_time_ms(run, reps=5, setup=reset)
    reset()
    got = cluster_scan(tuple(work), src, dst, degrees, **kw)
    torch.cuda.synchronize()
    plain_state = tuple(t.cpu() for t in state)
    cpu_args = (src.cpu(), dst.cpu(), degrees.cpu())
    want = None

    def run_plain():
        nonlocal want
        copy = tuple(t.clone() for t in plain_state)
        want = cluster_chunk_oracle(copy, *cpu_args, **kw)

    plain_ms = host_time_ms(run_plain)
    err = max(max_abs_err(g, w) for g, w in zip(got, want))
    uniq = int(torch.unique(torch.cat([src, dst])).numel())
    n_bytes = 8 * E + uniq * (7 * 4 + 6 * 4 + 4 * 4)
    n_ops = 60 * E
    b, by = bound_ms(n_bytes, n_ops)
    return {"name": "K1 cluster_scan (Alg. 1 fold)", "route": "cuda",
            "source": "src/repro_torch/kernels/stream_scan/csrc/stream_scan.cu",
            "replaces": "src/repro/kernels/stream_scan/kernel.py:467",
            "launches": main["launches"]["cluster_scan"], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
            "library_ms": None,
            "shape": {"V": int(degrees.shape[0]), "chunk": E,
                      "distinct_vertices": uniq,
                      "leaves": list(ClusterState._fields)}}


def check_k2(main, k: int) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels.stream_scan import assign_chunk_oracle, assign_scan

    out, E_all = main["out"], main["src"].shape[0]
    E = 4096
    src = torch.from_numpy(main["src"][:E]).cuda()
    dst = torch.from_numpy(main["dst"][:E]).cuda()
    rng = np.random.default_rng(k)
    if k == main["cfg"].k:  # the main path's own placement inputs
        res = out.aux["incremental"]["compact"]
        deg = out.aux["incremental"]["degrees"]
        from repro_torch.core.s5p import _edge_clusters

        cu, cv, head = _edge_clusters(src, dst, res, deg, out.xi)
        c2p = torch.from_numpy(out.cluster_assignment).cuda()
        pcu = c2p[cu.clamp(min=0).long()].contiguous()
        pcv = c2p[cv.clamp(min=0).long()].contiguous()
        load0 = out.aux["incremental"]["load"].clone()
        cap = out.max_load
    else:  # same edges, partitions drawn from a seed, loads near the cap
        cap = math.ceil(E_all / k)
        head = torch.from_numpy(rng.random(E) < 0.3).cuda()
        pcu = torch.from_numpy(rng.integers(0, k, E).astype(np.int32)).cuda()
        pcv = torch.from_numpy(rng.integers(0, k, E).astype(np.int32)).cuda()
        load0 = torch.from_numpy(
            rng.integers(cap - 64, cap + 2, k).astype(np.int32)).cuda()
    load = load0.clone()

    def reset():
        load.copy_(load0)

    def run_ins():
        assign_scan(load, src, dst, head, pcu, pcv, max_load=cap)

    ms = cuda_time_ms(run_ins, reps=10, setup=reset)
    reset()
    parts, load_ins = assign_scan(load, src, dst, head, pcu, pcv, max_load=cap)
    load_ins = load_ins.clone()
    zeros = torch.zeros_like(src)
    _, load_ret = assign_scan(load, src, dst, zeros, zeros, zeros, max_load=cap,
                              sign=-1, parts=parts, n_valid=E)
    torch.cuda.synchronize()
    cpu = [t.cpu() for t in (src, dst, head, pcu, pcv)]
    want = {}

    def run_plain():
        want["ins"] = assign_chunk_oracle(load0.cpu(), *cpu, max_load=cap)

    plain_ms = host_time_ms(run_plain)
    p_want, l_want = want["ins"]
    z = torch.zeros(E, dtype=torch.int32)
    _, l_ret_want = assign_chunk_oracle(l_want, cpu[0], cpu[1], z, z, z,
                                        max_load=cap, sign=-1, parts=p_want,
                                        n_valid=E)
    err = max(max_abs_err(parts, p_want), max_abs_err(load_ins, l_want),
              max_abs_err(load_ret, l_ret_want), max_abs_err(load_ret, load0))
    overflow = int(((load_ins.cpu() >= cap).sum()))
    n_bytes = E * (6 * 4 + 4) + 2 * 4 * k
    n_ops = 12 * E + 4 * k * E
    b, by = bound_ms(n_bytes, n_ops)
    return {"name": f"K2 assign_scan (Alg. 3 placement) k={k}", "route": "cuda",
            "source": "src/repro_torch/kernels/stream_scan/csrc/stream_scan.cu",
            "replaces": "src/repro/kernels/stream_scan/kernel.py:581",
            "launches": main["launches"]["assign_scan"], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
            "library_ms": None,
            "shape": {"k": k, "chunk": E, "cap": cap,
                      "full_partitions_after": overflow}}


def check_cms(main) -> list[dict]:
    import torch

    from repro_torch.core.cms import _row_cols, make_sketch, pair_key, suggest_params
    from repro_torch.kernels.cms_sketch import cms_query, cms_update, query_ref, update_ref
    from repro_torch.kernels import _build
    from repro_torch.kernels.cms_sketch import kernel as cms_k
    from repro_torch.kernels.cms_sketch.kernel import u32_bits

    out = main["out"]
    C = out.n_clusters
    w, d = suggest_params(0.1, 0.01)
    width = w * max(1, int(math.sqrt(C)))
    seeds = make_sketch(width, d, seed=0, device="cuda").seeds
    pa = out.aux["incremental"]["pair_a"]
    pb = out.aux["incremental"]["pair_b"]
    N = 1 << 18
    reps = -(-N // pa.numel())
    keys = pair_key(pa.repeat(reps)[:N], pb.repeat(reps)[:N])
    counts = torch.ones_like(keys)
    counts[-1000:] = 0  # the padding of a last chunk
    counts[:1000] = -1  # retractions wrap in Z/2^32

    table = cms_update(keys, seeds, width, d, counts)
    est = cms_query(table, keys, seeds)
    # the kernels alone, on the operands the wrappers hand them (the
    # wrappers' uint32 conversions are not part of the kernel's time)
    lib, stream = cms_k._lib(), torch.cuda.current_stream().cuda_stream
    k32, c32, s32 = u32_bits(keys), u32_bits(counts), u32_bits(seeds)
    scratch = torch.zeros_like(table)
    out32 = torch.empty(N, dtype=torch.int32, device="cuda")
    ms_u = cuda_time_ms(lambda: _build.check(lib.cms_update_launch(
        k32.data_ptr(), c32.data_ptr(), s32.data_ptr(), N, d, width,
        scratch.data_ptr(), stream), "cms_update"), reps=20, setup=scratch.zero_)
    ms_q = cuda_time_ms(lambda: _build.check(lib.cms_query_launch(
        k32.data_ptr(), s32.data_ptr(), table.data_ptr(), N, d, width,
        out32.data_ptr(), stream), "cms_query"), reps=20)
    torch.cuda.synchronize()
    kc, sc, cc = keys.cpu(), seeds.cpu(), counts.cpu()
    res = {}
    plain_u = host_time_ms(lambda: res.__setitem__("t", update_ref(kc, sc, width, d, cc)))
    plain_q = host_time_ms(lambda: res.__setitem__("q", query_ref(table.cpu(), kc, sc)))
    err_u = max_abs_err(table, res["t"])
    err_q = max_abs_err(est, res["q"])

    # yardstick: one PyTorch call that accumulates the same counts into the
    # same table, given the hashed columns (hashing is not part of it)
    cols = _row_cols(keys, seeds, width)
    flat = (torch.arange(d, device="cuda")[:, None] * width + cols).reshape(-1)
    vals = u32_bits(counts).expand(d, -1).reshape(-1).contiguous()
    lib_table = torch.zeros(d * width, dtype=torch.int32, device="cuda")
    lib_ms = cuda_time_ms(lambda: lib_table.index_put_((flat,), vals, accumulate=True),
                          reps=20, setup=lib_table.zero_)
    b_u, by_u = bound_ms(8 * N + 4 * d + 4 * d * width, 11 * N * d)
    b_q, by_q = bound_ms(8 * N + 4 * d + 4 * d * width, 11 * N * d)
    shape = {"keys": N, "depth": d, "width": width, "clusters": C}
    launches = main["launches"]
    return [
        {"name": "K4a cms_update", "route": "cuda",
         "source": "src/repro_torch/kernels/cms_sketch/csrc/cms_sketch.cu",
         "replaces": "src/repro/kernels/cms_sketch/kernel.py:89",
         "launches": launches["cms_update"], "max_abs_err": err_u,
         "ms": ms_u, "plain_ms": plain_u, "bound_ms": b_u, "bound_by": by_u,
         "library_ms": lib_ms, "shape": shape},
        {"name": "K4b cms_query", "route": "cuda",
         "source": "src/repro_torch/kernels/cms_sketch/csrc/cms_sketch.cu",
         "replaces": "src/repro/kernels/cms_sketch/kernel.py:114",
         "launches": launches["cms_query"], "max_abs_err": err_q,
         "ms": ms_q, "plain_ms": plain_q, "bound_ms": b_q, "bound_by": by_q,
         "library_ms": None, "shape": shape},
    ]


def phase_compare(main) -> dict:
    import torch

    from repro_torch.core.baselines import PARTITIONERS, S5P_BASED
    from repro_torch.core.metrics import gas_comm_bytes, load_balance, partition_loads, replication_factor
    from repro_torch.gas import build_gas_graph, comm_stats, pagerank

    src, dst, n, k = main["src"], main["dst"], main["n"], main["cfg"].k
    dev = torch.device("cuda")
    s_t = torch.from_numpy(src).to(dev)
    d_t = torch.from_numpy(dst).to(dev)
    E = int(src.shape[0])
    n_chunks = math.ceil(E / (1 << 16))
    rows, parts_of, problems = {}, {}, []
    for name, fn in PARTITIONERS.items():
        kw = {"full_output": True} if name in S5P_BASED else {}
        if name == "s5p":  # the main run, under the same arguments
            out, dt, launches = main["out"], main["info"]["wall_s"], main["launches"]
        else:
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            out = fn(src, dst, n, k, 0, device=dev, **kw)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = launch_counts()
        parts = out.parts if kw else out
        loads = partition_loads(parts, k=k)
        row = {"phase": "compare", "partitioner": name,
               "rf": replication_factor(s_t, d_t, parts, n_vertices=n, k=k),
               "balance": load_balance(parts, k=k), "max_load": int(loads.max()),
               "gas_comm_bytes": gas_comm_bytes(s_t, d_t, parts, n_vertices=n, k=k),
               "seconds": dt, "launches": launches}
        if kw:
            row.update(clusters=out.n_clusters, head_clusters=out.n_head_clusters,
                       game_rounds=out.game_rounds, game_converged=out.game_converged,
                       seconds_by_phase=out.timings)
        emit(row)
        rows[name] = row
        parts_of[name] = parts
        if int(parts.min()) < 0 or int(parts.max()) >= k or parts.shape != (E,):
            problems.append(f"{name}: a part outside [0, {k})")
    for name, kernel in (("greedy", "scoring_scan"), ("hdrf", "scoring_scan"),
                         ("grid", "grid_scan")):
        if rows[name]["launches"][kernel] != n_chunks:
            problems.append(f"{name}: {kernel} launched {rows[name]['launches'][kernel]}"
                            f" times, not once per chunk ({n_chunks})")
    retract = _compare_retract(main, parts_of["hdrf"], s_t, d_t)
    if not retract["restored"] or retract["launches"]["scoring_retract"] != 1:
        problems.append(f"HDRF retract of the last chunk: {retract}")
    pr = {}
    for name in ("s5p", "hdrf"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = build_gas_graph(s_t, d_t, parts_of[name], n, k, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        values, stats = pagerank(g, iterations=10)
        torch.cuda.synchronize()
        pr[name] = {"bytes": stats.total_bytes(), "layout_s": t1 - t0,
                    "supersteps_s": time.perf_counter() - t1,
                    "mirrors_per_step": comm_stats(g).mirror_to_master_msgs,
                    "values": values}
        if not bool(torch.isfinite(values).all()):
            problems.append(f"PageRank on {name}: values not finite")
    # PageRank is replica-exact, so its values do not depend on the cut;
    # the float32 sums run in another order for each layout (and atomics
    # in a varying one), so the two agree to a relative 1e-4
    a, b = pr["s5p"]["values"], pr["hdrf"]["values"]
    pr_diff = float(((a - b).abs() / torch.maximum(a.abs(), b.abs())).max())
    if pr_diff > 1e-4:
        problems.append(f"PageRank values differ between cuts by {pr_diff} (relative)")
    info = {"phase": "pagerank", "iterations": 10,
            "s5p_bytes": pr["s5p"]["bytes"], "hdrf_bytes": pr["hdrf"]["bytes"],
            "s5p_over_hdrf": pr["s5p"]["bytes"] / pr["hdrf"]["bytes"],
            "s5p_layout_s": pr["s5p"]["layout_s"], "s5p_supersteps_s": pr["s5p"]["supersteps_s"],
            "hdrf_layout_s": pr["hdrf"]["layout_s"],
            "hdrf_supersteps_s": pr["hdrf"]["supersteps_s"],
            "max_rel_value_diff": pr_diff}
    emit(info)
    if problems:
        raise SystemExit("chip_smoke compare phase failed: " + "; ".join(problems))
    return {"rows": rows, "pagerank": info, "parts": parts_of, "retract": retract,
            "launches": {name: r["launches"] for name, r in rows.items()}}


def _compare_retract(main, hdrf_parts, s_t, d_t) -> dict:
    """The delete path: retract the HDRF stream's last chunk from the
    run's final carry with ``HdrfCarry.retract_chunk`` (launch counters
    set to 0 just before, read just after).  The carry must then equal the
    one rebuilt from the parts without that chunk; the partial degrees
    lose every entry of the chunk."""
    import torch

    from repro_torch.kernels.stream_scan import HdrfCarry

    n, k = main["n"], main["cfg"].k
    E = int(s_t.numel())
    L = 1 << 16
    start = (math.ceil(E / L) - 1) * L
    carry = HdrfCarry(n, k, lam=1.1, device="cuda").init()
    for leaf, t in zip(carry[:3], _scoring_state(main, hdrf_parts, hdrf=True)):
        leaf.copy_(t)
    src, dst = s_t[start:].contiguous(), d_t[start:].contiguous()
    chunk_parts = hdrf_parts[start:].contiguous()
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    carry = HdrfCarry(n, k, lam=1.1, device="cuda").retract_chunk(
        carry, src, dst, E - start, chunk_parts)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    kept = hdrf_parts.clone()
    kept[start:] = -1
    want = _scoring_state(main, kept, hdrf=True)
    want[2] -= torch.bincount(torch.cat([src, dst]).long(), minlength=n).to(torch.int32)
    restored = all(torch.equal(a, b) for a, b in zip(carry[:3], want))
    info = {"phase": "compare", "step": "hdrf retract of the last chunk",
            "edges": E - start, "seconds": dt, "launches": launches,
            "restored": restored}
    emit(info)
    return info


def _scoring_state(main, parts, hdrf: bool):
    """The final (load, rep[, pd]) of a Greedy/HDRF run over the main graph,
    rebuilt from its parts: the counted tables are functions of them, and
    pd counts every endpoint entry, the last chunk's (0, 0) padding too."""
    import torch

    from repro_torch.core.clustering import compute_degrees

    n, k = main["n"], main["cfg"].k
    s = torch.from_numpy(main["src"]).cuda()
    d = torch.from_numpy(main["dst"]).cuda()
    ok = (parts >= 0).to(torch.int32)
    p = parts.clamp(min=0).long()
    load = torch.zeros(k, dtype=torch.int32, device="cuda").index_add_(0, p, ok)
    rep = torch.zeros(n * k, dtype=torch.int32, device="cuda")
    rep.index_add_(0, s.long() * k + p, ok).index_add_(0, d.long() * k + p, ok)
    state = [load, rep.view(n, k)]
    if hdrf:
        pd = compute_degrees(s, d, n)
        pad = (-s.numel()) % (1 << 16) if s.numel() > (1 << 16) else 0
        pd[0] += 2 * pad
        state.append(pd)
    return state


def _k3_bytes(src, dst, parts, uniq, k, hdrf, retract):
    """Each input read once, each output written once: edge ids and parts
    (read too on retract), the touched replica rows read whole, the
    partial degrees (HDRF) in and out, the loads, and of the table only the
    32-byte sectors (8 counters) that hold a changed counter."""
    import torch

    E = int(src.numel())
    ok = parts >= 0
    p = parts[ok].long()
    cells = torch.cat([src[ok].long() * k + p, dst[ok].long() * k + p])
    sectors = int(torch.unique(cells // 8).numel())
    return ((16 if retract else 12) * E + uniq * k * 4 + (8 * uniq if hdrf else 0)
            + 32 * sectors + 8 * k)


def check_k3_g1(main, compare) -> list[dict]:
    import numpy as np
    import torch

    from repro_torch.core.baselines import _grid_dims, _grid_rowcol
    from repro_torch.kernels.stream_scan import (grid_chunk_oracle, grid_scan,
                                                 scoring_chunk_oracle, scoring_scan)

    n, k = main["n"], main["cfg"].k
    E = 4096
    src = torch.from_numpy(main["src"][:E]).cuda()
    dst = torch.from_numpy(main["dst"][:E]).cuda()
    cs, cd = src.cpu(), dst.cpu()
    uniq = int(torch.unique(torch.cat([src, dst])).numel())
    launches = compare["launches"]
    rows = []

    def one(name, mode, sign, state0, parts_in=None):
        hdrf = mode == "hdrf"
        # launches on the path that runs this mode: the compare row's
        # inserts, the delete path's retracts
        n_launches = (launches[mode]["scoring_scan"] if sign > 0
                      else compare["retract"]["launches"]["scoring_retract"])
        work = [t.clone() for t in state0]
        lam = 1.1 if hdrf else None
        kw = dict(mode=mode, sign=sign, parts=parts_in, n_valid=E if sign < 0 else None)

        def reset():
            for w, t in zip(work, state0):
                w.copy_(t)

        def run():
            scoring_scan(src, dst, *work[:2], work[2] if hdrf else None, lam, **kw)

        ms = cuda_time_ms(run, reps=5, setup=reset)
        reset()
        got = scoring_scan(src, dst, *work[:2], work[2] if hdrf else None, lam, **kw)
        torch.cuda.synchronize()
        plain = [t.to("cpu", copy=True) for t in state0]
        ckw = dict(kw, parts=None if parts_in is None else parts_in.cpu())
        want = {}

        def run_plain():
            want["out"] = scoring_chunk_oracle(cs, cd, *plain[:2],
                                               plain[2] if hdrf else None, lam, **ckw)

        plain_ms = host_time_ms(run_plain)
        err = max(max_abs_err(g, w) for g, w in zip(got, want["out"]) if w is not None)
        n_bytes = _k3_bytes(src, dst, got[0], uniq, k, hdrf, sign < 0)
        n_ops = (12 if hdrf else 8) * k * E
        b, by = bound_ms(n_bytes, n_ops)
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/stream_scan/csrc/scoring_scan.cu",
                     "replaces": "src/repro/kernels/stream_scan/kernel.py:124",
                     "launches": n_launches, "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                     "library_ms": None,
                     "shape": {"V": n, "k": k, "chunk": E, "distinct_vertices": uniq,
                               "state": "final state of the compare run"}})
        return got

    g_state = _scoring_state(main, compare["parts"]["greedy"], hdrf=False)
    one("K3 scoring_scan greedy insert", "greedy", 1, g_state)
    del g_state
    h_state = _scoring_state(main, compare["parts"]["hdrf"], hdrf=True)
    parts_ins = one("K3 scoring_scan hdrf insert", "hdrf", 1, h_state)[0]
    after = [t.clone() for t in h_state]
    scoring_scan(src, dst, *after, 1.1, mode="hdrf")
    one("K3 scoring_scan hdrf retract (sign=-1)", "hdrf", -1, after, parts_ins.clone())
    # the retract gives back exactly what the insert added
    scoring_scan(src, dst, *after, mode="hdrf", sign=-1, parts=parts_ins, n_valid=E)
    roundtrip = max(max_abs_err(a, b) for a, b in zip(after, h_state))
    rows[-1]["max_abs_err"] = max(rows[-1]["max_abs_err"], roundtrip)
    del h_state, after

    _, c = _grid_dims(k)
    row_t, col_t = _grid_rowcol(n, k, c, 0, "cuda")
    gp = compare["parts"]["grid"]
    load0 = torch.zeros(k, dtype=torch.int32, device="cuda").index_add_(
        0, gp.clamp(min=0).long(), (gp >= 0).to(torch.int32))
    load = load0.clone()
    ms = cuda_time_ms(lambda: grid_scan(load, row_t, col_t, c, src, dst), reps=10,
                      setup=lambda: load.copy_(load0))
    load.copy_(load0)
    got = grid_scan(load, row_t, col_t, c, src, dst)
    torch.cuda.synchronize()
    want = {}
    rc, cc = row_t.cpu(), col_t.cpu()
    plain_ms = host_time_ms(lambda: want.__setitem__(
        "out", grid_chunk_oracle(load0.to("cpu", copy=True), rc, cc, c, cs, cd)))
    err = max(max_abs_err(a, b) for a, b in zip(got, want["out"]))
    # edge ids in, parts out; row[·] and col[·] of each touched vertex; loads
    b, by = bound_ms(12 * E + uniq * 8 + 8 * k, 6 * E)
    rows.append({"name": "G1 grid_scan", "route": "cuda",
                 "source": "src/repro_torch/kernels/stream_scan/csrc/scoring_scan.cu",
                 "replaces": "src/repro/kernels/stream_scan/ref.py:191 (lax.scan, no Pallas kernel)",
                 "launches": launches["grid"]["grid_scan"], "max_abs_err": err,
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                 "library_ms": None,
                 "shape": {"V": n, "k": k, "chunk": E, "distinct_vertices": uniq}})
    return rows


def phase_kernels(main, compare) -> list[dict]:
    k1 = check_k1(main)
    k2 = [check_k2(main, k) for k in (8, 32, 256)]
    cms = check_cms(main)
    k3_g1 = check_k3_g1(main, compare)
    rows = [k1, *k2, *cms, *k3_g1]
    for r in rows:
        emit({"phase": "kernel", **r})
    bad = [r["name"] for r in rows if r["max_abs_err"] != 0]
    if bad:
        raise SystemExit(f"chip_smoke: kernels disagree with their plain versions: {bad}")
    main_k2 = next(r for r in k2 if r["shape"]["k"] == main["cfg"].k)
    return [k1, main_k2, *cms, *k3_g1], rows


def phase_parity() -> dict:
    import numpy as np

    from repro_torch.core.baselines import PARTITIONERS
    from repro_torch.graphs import community_graph

    src, dst, n = community_graph(2000, n_communities=32, avg_degree=8, seed=5)
    differing, seconds = {}, {}
    for name, fn in PARTITIONERS.items():
        t0 = time.perf_counter()
        gpu = fn(src, dst, n, 8, 0, device="cuda").cpu().numpy()
        t1 = time.perf_counter()
        cpu = fn(src, dst, n, 8, 0, device="cpu").numpy()
        seconds[name] = [t1 - t0, time.perf_counter() - t1]
        differing[name] = int((gpu != cpu).sum()) if gpu.shape == cpu.shape else -1
    same = all(v == 0 for v in differing.values())
    info = {"phase": "parity", "graph": "community_graph(2000, 32, 8, seed=5)",
            "k": 8, "E": int(src.shape[0]), "parts_identical": same,
            "differing_edges": differing, "cuda_cpu_s": seconds}
    emit(info)
    if not same:
        raise SystemExit(f"chip_smoke: cuda and cpu parts differ on the community graph: {differing}")
    return info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=20,
                    help="R-MAT scale of the main path (default 20)")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    t_start = time.perf_counter()
    dev = phase_device()
    build = phase_build()
    main_run = phase_main(args.scale)
    compare = phase_compare(main_run)
    summary, all_rows = phase_kernels(main_run, compare)
    parity = phase_parity()
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"device": dev, "build": build, "main": main_run["info"],
                   "compare": compare["rows"], "pagerank": compare["pagerank"],
                   "kernels": all_rows, "parity": parity,
                   "total_s": time.perf_counter() - t_start}, f, indent=1)
    emit({"kernels": [{k: v for k, v in r.items() if k != "shape"} for r in summary]})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
