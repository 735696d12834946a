#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py              # the full run: R-MAT scale 20, k = 32
    python3 chip_smoke.py --scale 16 --products-scale 0.1   # a shorter run

Phases, each printing one JSON line:

1. device   — the card, as ``nvidia-smi`` reports its name and power limit;
2. build    — ``nvcc`` builds every kernel source of the port (in parallel);
3. main     — S5P under the default ``S5PConfig`` (CMS Θ, chunk 65,536, one
              stream) on the Graph500 R-MAT (a=0.57, b=c=0.19, seed 0),
              k = 32, with every kernel launch counter set to 0 just before
              and read just after; max load must hold and every kernel of
              the path (K1, K2, K4a, K4b, and K5 twice for the game's
              cluster degrees) must have launched; the game's δ on the
              card must have the CPU's bits (``game_audit``);
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
5. serve    — the serving read side with GCN inference: the
              ``ogbn_products_like(seed=0)`` graph at scale 1.0 (2,449,029
              vertices), S5P at k = 32, ``build_bundle`` and
              ``BundleRegistry.publish``, ``GASServer`` for 10 PageRank
              supersteps, 16 ``query_pagerank`` calls of 16 vertices, one
              ``query_components(5)``, one ``gcn_forward`` of gcn-cora at
              d_feat 100 over ``products_features``, ``query_gnn`` for all
              vertices and then 16 times for 16 vertices; launch counters
              set to 0 just before and read just after, K5 launched 6 times
              per forward (and twice in S5P's game); one more ``query_gnn``
              under ``torch.profiler``, its device time split into K5 and
              the rest; the full logits held against the same forward
              on ``device="cpu"`` (rtol 1e-4, atol 1e-5: only ``x @ W``
              differs); one line each for the graph, S5P, GAS, latency,
              GCN and device numbers;
6. kernels  — each kernel's wrapper on card tensors at the main path's
              shapes against its plain PyTorch version on the same inputs:
              K1–K5 bitwise equal (tolerance 0), K6 within the tolerance
              its row states (below); times by CUDA
              events, the plain version's time, the bound, and a PyTorch
              library call where one computes the same function; for the
              serial scans also a latency bound (edges × the chain's
              dependent steps × the round trips that a pointer chase and a
              reduction chain measure on the card first, ``latency.py``).
              K1 and K3 run the main path's 65,536-edge chunks from the
              empty state and from the state after half the chunks (K1
              under S5P, S5P-B, 2PS-L's ξ = -1 and CLUGP's ξ; K3 in both
              modes, each insert followed by its retract, which must
              restore the state), and 4,096 edges onto the final state;
              each row also holds two launches against each other and
              names the first differing leaf and index on a mismatch; K3's
              rung and tile and K1's tile are printed for k = 8, 32, 256
              and 4,096 (``kernel_plan``).  G1 runs the grid row's chunk;
              K5 runs the serve phase's degree counts (d = 1, every long
              row on the tree), layer-1 (d = 16) and layer-2 (d = 7)
              aggregations and one over its features in bfloat16 (d = 100),
              recording the long rows, the tree rows and the compiled
              kernel's registers, with ``torch.sparse.mm`` on the same CSR matrix as
              the library call (for bf16 a CSR of bf16 weights; where
              PyTorch refuses it, the row records the error text);
7. lm       — the LM serving path at full width: ``serve_lm`` of
              ``llama3-8b`` (32 layers, 8,030,261,248 parameters, bf16,
              seed 0) over 4 prompts of 4,096 tokens, then 32 greedy
              tokens, with the launch counters set to 0 just before and
              read just after: init seconds and peak memory, prefill seconds
              and tokens/s, decode ms per token (mean, p99), K6 launched
              exactly once per layer of the prefill (32), the logits finite;
              then a float32 check at full width and 2 layers: the logits
              of ``prefill(prompt[:S])`` against ``prefill(prompt[:S-1])``
              followed by ``decode_step(prompt[S-1])`` within atol 2e-3,
              rtol 1e-3 (the reference's decode-against-forward
              tolerance), which holds K6 against the plain decode path.
              Phase ``kernels`` then holds K6 against its plain version
              (``flash_attention_ref`` over K6's key tiles on the same card
              tensors, float32 products in full float32, no TF32) at
              llama3-8b's prefill layer, qwen3-14b's 5-head groups,
              Mixtral's 4,096 window over 8,192 tokens and a ragged,
              padded float32 case, within ``K6_LIMITS`` (bf16: per-row and
              mean relative error), shows that a dropped kv tile and q, p
              left in float32 fail those limits, times
              ``scaled_dot_product_attention`` beside it (a boolean mask
              from the positions where not causal alone), and states the
              tile classes (``kv_tile_classes``) and the compiled kernel's
              registers, spills and shared memory;
8. recsys   — the recsys serving path at xDeepFM's published config (39
              fields, embed 10, CIN 200-200-200, MLP 400-400, float32,
              50,453,809 parameters, seed 0): ``serve_recsys`` (init and the
              first ``serve_p99`` request), 16 more requests of 512 samples
              (ids drawn from ``PRNGKey(r)`` as the reference draws them), 2
              ``serve_bulk`` requests of 262,144 samples and a retrieval of
              1 query against 1,000,000 candidates (top 100, twice: the
              first call pays the first use of its kernels), each ending in
              a copy to the host, with the launch counters set to 0 just
              before and read just after: init seconds, latency mean and
              p99, samples/s, peak memory, K7 launched exactly 3 times per
              forward; the last p99 request and the first 1,024 rows of the
              last bulk request again on the CPU forward: logits within rtol
              1e-4, atol 1e-6 and each CIN layer's pools within 1e-5 of its
              max (the logits cannot see a K7 that drops a term).  Phase
              ``kernels`` then holds K7 against ``cin_layer_ref`` at layer
              1's and layer 2's shapes (B = 512, float32 and bf16), a
              ragged B = 1,000 and ``serve_bulk``'s layer 2 (B = 262,144),
              within ``K7_LIMITS``; two launches must give equal bits; a
              dropped h slice and, where ``plan`` splits the K stages, a
              dropped split's partial (``cin_split_partials``) must fail the
              limits; one ``torch.einsum`` is timed beside it where its
              intermediate fits the card, and the bound is stated on the
              tensor cores (``k7_bounds``) beside the scalar one;
9. parity   — every partitioner on ``community_graph(2000, 32, 8,
              seed=5)``, k = 8, on ``cuda`` and on ``cpu``: the parts must be
              identical; and the game's δ where Σ(degs + sizes) passes 2**24
              (Θ scaled by 3001), on both: the same bits and assignment.

The kernel checks of phase 6 run after phases 7 and 8.

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
BF16_TENSOR_OPS_PER_S = 989e12  # dense bf16 tensor-core rate
TF32_TENSOR_OPS_PER_S = 495e12  # dense TF32 tensor-core rate


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
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


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float = SCALAR_OPS_PER_S
             ) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(a, b) -> int:
    import torch

    if a.shape != b.shape:
        raise SystemExit(f"chip_smoke: shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")
    if not a.numel():
        return 0
    return int((a.cpu().to(torch.int64) - b.cpu().to(torch.int64)).abs().max())


def _kernel_modules():
    from repro_torch.kernels.cin import kernel as cin_k
    from repro_torch.kernels.cms_sketch import kernel as cms_k
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.segment_agg import kernel as seg_k
    from repro_torch.kernels.stream_scan import kernel as scan_k

    return scan_k, cms_k, seg_k, fa_k, cin_k


def launch_counts() -> dict:
    counts = {}
    for mod in _kernel_modules():
        counts.update(mod.launch_counts())
    return counts


def reset_launch_counts() -> None:
    for mod in _kernel_modules():
        mod.reset_launch_counts()


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
                        for n, p in _build.SOURCES.items()},
            "k6_kernels": ptxas_kernels(res["logs"].get("flash_attention", "")),
            "k7_kernels": ptxas_kernels(res["logs"].get("cin", ""))}
    emit(info)
    return info


def _kernel_label(mangled: str) -> str:
    """``_ZN12_GLOBAL__N_111fa_fwd_bf16ILi128EEEv…`` → ``fa_fwd_bf16<128>``:
    the last of the length-prefixed names, and its template argument (an
    int, ``float`` or ``__nv_bfloat16``)."""
    import re

    pos, name = re.match(r"_ZN?", mangled).end() if mangled.startswith("_Z") else 0, mangled
    while pos < len(mangled) and mangled[pos].isdigit():
        n = re.match(r"\d+", mangled[pos:])
        pos += n.end()
        name, pos = mangled[pos:pos + int(n.group())], pos + int(n.group())
    t = re.match(r"I(?:Li(\d+)E|(f)|\d+(__nv_bfloat16))E", mangled[pos:])
    if not t:
        return name
    arg = t.group(1) or ("float" if t.group(2) else t.group(3))
    return f"{name}<{arg}>"


def ptxas_kernels(log: str) -> dict:
    """``-Xptxas -v``'s figures per kernel of one source: registers, spill
    stores and loads (bytes), stack frame (bytes); templates named as
    ``fa_fwd_bf16<128>``."""
    import re

    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = out.setdefault(_kernel_label(m.group(1)), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def _game_audit(out) -> dict:
    """The game's float32 totals on this run's inputs, in float64: a sum of
    integer-valued float32 terms is exact in any order only below 2**24.
    δ's two sums follow the reference's order; the per-cluster degrees,
    W[i, p] and the part sizes are atomics on the card, exact while each
    total is below 2**24.  δ on the card against δ on the CPU, bitwise."""
    import torch

    from repro_torch.core import game as G

    st = out.aux["incremental"]
    sizes, pa, pb, pw = st["sizes"], st["pair_a"], st["pair_b"], st["pair_w"]
    C, k = out.n_clusters, out.k
    a, b = pa.long().clamp(max=C), pb.long().clamp(max=C)
    w64 = pw.double()
    deg = torch.zeros(C + 1, dtype=torch.float64, device=pw.device)
    deg = deg.index_add(0, a, w64).index_add(0, b, w64)[:C]
    assign = torch.as_tensor(out.cluster_assignment, device=pw.device).long()
    ext = torch.cat([assign, assign.new_zeros(1)])
    wip = torch.zeros((C + 1) * k, dtype=torch.float64, device=pw.device)
    wip.index_add_(0, a * k + ext[b], w64).index_add_(0, b * k + ext[a], w64)
    parts = torch.zeros(k, dtype=torch.float64, device=pw.device).index_add_(
        0, assign, sizes.double())
    inputs = G.GameInputs(sizes, pa, pb, pw, 0, k)
    d_dev = G.compute_delta(sizes, G._cluster_degrees(inputs, C), k)
    cpu = G.GameInputs(sizes.cpu(), pa.cpu(), pb.cpu(), pw.cpu(), 0, k)
    d_cpu = G.compute_delta(cpu.sizes, G._cluster_degrees(cpu, C), k)
    total = float(deg.sum() + sizes.double().sum())
    return {"sum_degs_sizes": total, "max_cluster_degree": float(deg.max()),
            "max_w_ip": float(wip.max()), "max_part_size": float(parts.max()),
            "delta_bits_cuda": int(d_dev.cpu().view(torch.int32)),
            "delta_bits_cpu": int(d_cpu.view(torch.int32)),
            "delta_sum_above_2^24": total >= 2**24,
            "atomic_totals_below_2^24": max(float(deg.max()), float(wip.max()),
                                            float(parts.max())) < 2**24}


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
        "pairs": out.aux["n_pairs"], "game_audit": _game_audit(out),
    }
    emit(info)
    n_chunks = math.ceil(E / cfg.chunk_size)
    problems = []
    if info["max_load"] > out.max_load:
        problems.append(f"max load {info['max_load']} > cap {out.max_load}")
    audit = info["game_audit"]
    if audit["delta_bits_cuda"] != audit["delta_bits_cpu"]:
        problems.append(f"the game's δ differs between cuda and cpu: {audit}")
    if launches["cluster_scan"] != n_chunks or launches["assign_scan"] != n_chunks:
        problems.append(f"K1/K2 launches {launches} != {n_chunks} chunks")
    if launches["cms_update"] < 1 or launches["cms_query"] < 1:
        problems.append(f"CMS kernels not launched: {launches}")
    if launches["segment_agg"] != 2:
        problems.append(f"K5 launched {launches['segment_agg']} times by the game, not 2")
    p = parts.cpu().numpy()
    if p.shape != (E,) or p.min() < 0 or p.max() >= cfg.k:
        problems.append("parts outside [0, k) on a graph without self-loops")
    if not math.isfinite(info["rf"]) or not 1.0 <= info["rf"] <= cfg.k:
        problems.append(f"RF {info['rf']} outside [1, k]")
    if problems:
        raise SystemExit("chip_smoke main path failed: " + "; ".join(problems))
    return {"info": info, "out": out, "src": src, "dst": dst, "n": n,
            "launches": launches, "cfg": cfg}


def first_diff(got, want, names) -> str | None:
    """The first leaf and index where two sequences of tensors differ."""
    import torch

    for name, a, b in zip(names, got, want):
        if a is None and b is None:
            continue
        a, b = a.cpu(), b.cpu()
        if a.shape != b.shape:
            return f"leaf {name}: shape {tuple(a.shape)} vs {tuple(b.shape)}"
        if not torch.equal(a, b):
            i = int((a.reshape(-1) != b.reshape(-1)).nonzero()[0])
            return f"leaf {name} index {i}: {int(a.reshape(-1)[i])} vs {int(b.reshape(-1)[i])}"
    return None


def twice(run, reset, outs) -> bool:
    """Whether two launches from one state give the same bits: ``run``
    launches, ``outs()`` lists what it left."""
    import torch

    reset()
    run()
    first = [t.clone() for t in outs() if t is not None]
    reset()
    run()
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(first, [t for t in outs() if t is not None]))


def main_chunk(main, c: int):
    """Chunk ``c`` of the main stream (65,536 edges; no chunk but the last
    is padded) on the card."""
    import torch

    L = 1 << 16
    return (torch.from_numpy(main["src"][c * L:(c + 1) * L]).cuda(),
            torch.from_numpy(main["dst"][c * L:(c + 1) * L]).cuda())


def _k1_row(label, state0, src, dst, degrees, kw, rt, launches, shape) -> dict:
    """K1 on card tensors from ``state0`` against the plain fold on the same
    inputs, bitwise, and two launches against each other."""
    import torch

    from repro_torch.core.clustering import ClusterState
    from repro_torch.kernels.stream_scan import cluster_chunk_oracle, cluster_scan
    from repro_torch.kernels.stream_scan.latency import latency_bound_ms

    E = int(src.numel())
    work = [t.clone() for t in state0]

    def reset():
        for w, t in zip(work, state0):
            w.copy_(t)

    def run():
        cluster_scan(tuple(work), src, dst, degrees, **kw)

    ms = cuda_time_ms(run, reps=3, setup=reset)
    same = twice(run, reset, lambda: work)
    plain_state = tuple(t.cpu() for t in state0)
    cpu_args = (src.cpu(), dst.cpu(), degrees.cpu())
    want = {}

    def run_plain():
        want["out"] = cluster_chunk_oracle(tuple(t.clone() for t in plain_state),
                                           *cpu_args, **kw)

    plain_ms = host_time_ms(run_plain)
    diff = first_diff(work, want["out"], ClusterState._fields)
    err = max(max_abs_err(g, w) for g, w in zip(work, want["out"]))
    uniq = int(torch.unique(torch.cat([src, dst])).numel())
    n_bytes = 8 * E + uniq * (7 * 4 + 6 * 4 + 4 * 4)
    b, by = bound_ms(n_bytes, 60 * E)
    return {"name": label, "route": "cuda",
            "source": "src/repro_torch/kernels/stream_scan/csrc/stream_scan.cu",
            "replaces": "src/repro/kernels/stream_scan/kernel.py:467",
            "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
            "library_ms": None, "latency_bound_ms": latency_bound_ms("K1", E, rt),
            "shape": {"V": int(degrees.shape[0]), "chunk": E, "distinct_vertices": uniq,
                      "new_head_ids": int(want["out"][5]) - int(state0[5]),
                      "new_tail_ids": int(want["out"][6]) - int(state0[6]),
                      "bitwise": diff is None and same, "first_diff": diff,
                      "equal_on_two_launches": same, "xi": kw["xi"], "kappa": kw["kappa"],
                      "global_tail": kw["global_tail"], **shape}}


def check_k1(main, rt) -> list[dict]:
    """K1 where the main path and the baselines run it: 65,536-edge chunks
    from the empty state and from the state after half the chunks, under
    S5P's ξ and κ, S5P-B's global tail at κ = 2^31 - 1, 2PS-L's ξ = -1 (all
    head) and CLUGP's ξ (all tail); and 4,096 edges onto the main run's
    final state.  The first row is the main path's chunk."""
    import torch

    from repro_torch.core.clustering import init_state
    from repro_torch.kernels.stream_scan import cluster_scan

    out, cfg, n = main["out"], main["cfg"], main["n"]
    inc = out.aux["incremental"]
    degrees = inc["degrees"]
    E_all = int(main["src"].shape[0])
    mid = math.ceil(E_all / (1 << 16)) // 2
    kappa = max(math.ceil(2.0 * E_all / cfg.k), 2)
    variants = [("S5P", out.xi, out.kappa, cfg.bounded, ("mid", "empty")),
                ("S5P-B", out.xi, 2**31 - 1, True, ("mid", "empty")),
                ("2PS-L xi=-1", -1, kappa, False, ("mid", "empty")),
                ("CLUGP xi=2^31-2", 2**31 - 2, kappa, False, ("mid",))]
    launches = main["launches"]["cluster_scan"]
    rows = []
    for name, xi, kap, gt, states in variants:
        kw = dict(xi=xi, kappa=kap, global_tail=gt)
        state = tuple(init_state(n, "cuda"))
        snaps = {"empty": tuple(t.clone() for t in state)}
        for c in range(mid):
            cluster_scan(state, *main_chunk(main, c), degrees, **kw)
        snaps["mid"] = state
        for st in states:
            c = mid if st == "mid" else 0
            rows.append(_k1_row(f"K1 cluster_scan (Alg. 1 fold) {name}, {st} state",
                                snaps[st], *main_chunk(main, c), degrees, kw, rt,
                                launches, {"variant": name, "state": st, "chunk_index": c}))
        del state, snaps
    E = 4096
    src, dst = (torch.from_numpy(a[:E]).cuda() for a in (main["src"], main["dst"]))
    kw = dict(xi=out.xi, kappa=out.kappa, global_tail=cfg.bounded)
    rows.append(_k1_row("K1 cluster_scan (Alg. 1 fold) S5P, 4,096 edges, final state",
                        inc["cluster_state"], src, dst, degrees, kw, rt, launches,
                        {"variant": "S5P", "state": "final", "chunk_index": 0}))
    return rows


def check_k2(main, k: int, rt) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels.stream_scan import assign_chunk_oracle, assign_scan
    from repro_torch.kernels.stream_scan.latency import latency_bound_ms

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
            "library_ms": None, "latency_bound_ms": latency_bound_ms("K2", E, rt),
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


def _scoring_state(main, parts, hdrf: bool, n_edges: int | None = None):
    """The (load, rep[, pd]) of a Greedy/HDRF run over the main graph's
    first ``n_edges`` edges (default all), rebuilt from their parts: the
    counted tables are functions of them, and pd counts every endpoint
    entry, the last chunk's (0, 0) padding too."""
    import torch

    from repro_torch.core.clustering import compute_degrees

    n, k = main["n"], main["cfg"].k
    m = int(main["src"].shape[0]) if n_edges is None else n_edges
    s = torch.from_numpy(main["src"][:m]).cuda()
    d = torch.from_numpy(main["dst"][:m]).cuda()
    ok = (parts[:m] >= 0).to(torch.int32)
    p = parts[:m].clamp(min=0).long()
    load = torch.zeros(k, dtype=torch.int32, device="cuda").index_add_(0, p, ok)
    rep = torch.zeros(n * k, dtype=torch.int32, device="cuda")
    rep.index_add_(0, s.long() * k + p, ok).index_add_(0, d.long() * k + p, ok)
    state = [load, rep.view(n, k)]
    if hdrf:
        pd = compute_degrees(s, d, n)
        if n_edges is None:
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


def _k3_row(label, mode, sign, state0, src, dst, parts_in, rt, launches, shape):
    """K3 on card tensors from ``state0`` against the plain version on the
    same inputs, bitwise, and two launches against each other.  Returns the
    row and the kernel's (parts, load, rep, pd)."""
    import torch

    from repro_torch.kernels.stream_scan import scoring_chunk_oracle, scoring_scan
    from repro_torch.kernels.stream_scan.latency import latency_bound_ms
    from repro_torch.kernels.stream_scan.plan import scoring_plan

    hdrf = mode == "hdrf"
    E = int(src.numel())
    k = int(state0[0].numel())
    work = [t.clone() for t in state0]
    lam = 1.1 if hdrf else None
    kw = dict(mode=mode, sign=sign, parts=parts_in, n_valid=E if sign < 0 else None)
    got = {}

    def reset():
        for w, t in zip(work, state0):
            w.copy_(t)

    def run():
        got["out"] = scoring_scan(src, dst, *work[:2], work[2] if hdrf else None, lam, **kw)

    ms = cuda_time_ms(run, reps=3, setup=reset)
    same = twice(run, reset, lambda: got["out"])
    out = got["out"]
    plain = [t.to("cpu", copy=True) for t in state0]
    ckw = dict(kw, parts=None if parts_in is None else parts_in.cpu())
    want = {}

    def run_plain():
        want["out"] = scoring_chunk_oracle(src.cpu(), dst.cpu(), *plain[:2],
                                           plain[2] if hdrf else None, lam, **ckw)

    plain_ms = host_time_ms(run_plain)
    diff = first_diff(out, want["out"], ("parts", "load", "rep", "pd"))
    err = max(max_abs_err(g, w) for g, w in zip(out, want["out"]) if w is not None)
    uniq = int(torch.unique(torch.cat([src, dst])).numel())
    b, by = bound_ms(_k3_bytes(src, dst, out[0], uniq, k, hdrf, sign < 0),
                     (12 if hdrf else 8) * k * E)
    p = scoring_plan(k)
    chain = "K3 retract" if sign < 0 else f"K3 {mode}"
    row = {"name": label, "route": "cuda",
           "source": "src/repro_torch/kernels/stream_scan/csrc/scoring_scan.cu",
           "replaces": "src/repro/kernels/stream_scan/kernel.py:124",
           "launches": launches, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
           "library_ms": None, "latency_bound_ms": latency_bound_ms(chain, E, rt),
           "shape": {"V": int(state0[1].shape[0]), "k": k, "chunk": E,
                     "distinct_vertices": uniq, "rung": p.rung, "tile": p.tile,
                     "bitwise": diff is None and same, "first_diff": diff,
                     "equal_on_two_launches": same, **shape}}
    return row, out


def check_k3_g1(main, compare, rt) -> list[dict]:
    """K3 where the Greedy and HDRF rows run it: 65,536-edge chunks from the
    empty state and from the state after half the chunks, insert and then
    the retract of what that insert placed, in both modes; and the 4,096-edge
    rows onto the compare run's final state.  G1 on the grid row's chunk.
    The first three rows are the main path's: Greedy and HDRF inserts and
    HDRF's retract, mid-stream."""
    import torch

    from repro_torch.core.baselines import _grid_dims, _grid_rowcol
    from repro_torch.kernels.stream_scan import grid_chunk_oracle, grid_scan
    from repro_torch.kernels.stream_scan.latency import latency_bound_ms

    n, k = main["n"], main["cfg"].k
    L = 1 << 16
    E_all = int(main["src"].shape[0])
    mid = math.ceil(E_all / L) // 2
    launches = compare["launches"]
    n_ret = compare["retract"]["launches"]["scoring_retract"]
    made = {}
    for mode in ("greedy", "hdrf"):
        hdrf = mode == "hdrf"
        parts = compare["parts"][mode]
        for st in ("mid", "empty"):
            c = mid if st == "mid" else 0
            if st == "mid":
                state0 = _scoring_state(main, parts, hdrf, n_edges=mid * L)
            else:
                state0 = [torch.zeros(k, dtype=torch.int32, device="cuda"),
                          torch.zeros((n, k), dtype=torch.int32, device="cuda")]
                if hdrf:
                    state0.append(torch.zeros(n, dtype=torch.int32, device="cuda"))
            src, dst = main_chunk(main, c)
            shape = {"state": st, "chunk_index": c}
            ins, out = _k3_row(f"K3 scoring_scan {mode} insert, {st} state", mode, 1,
                               state0, src, dst, None, rt, launches[mode]["scoring_scan"],
                               shape)
            after = [t.clone() for t in out[1:] if t is not None]
            ret, undone = _k3_row(f"K3 scoring_scan {mode} retract (sign=-1), {st} state",
                                  mode, -1, after, src, dst, out[0].clone(), rt,
                                  n_ret if hdrf else 0, shape)
            # the retract gives back exactly what the insert added
            ret["shape"]["restores_state"] = first_diff(
                undone[1:], state0, ("load", "rep", "pd")) is None
            ret["shape"]["bitwise"] &= ret["shape"]["restores_state"]
            made[mode, st, 1], made[mode, st, -1] = ins, ret
            del state0, after, out, undone
    # the main path's three: Greedy's and HDRF's inserts and HDRF's retract
    main_rows = [made.pop(("greedy", "mid", 1)), made.pop(("hdrf", "mid", 1)),
                 made.pop(("hdrf", "mid", -1))]
    extra = list(made.values())

    E = 4096
    src, dst = (torch.from_numpy(a[:E]).cuda() for a in (main["src"], main["dst"]))
    g_state = _scoring_state(main, compare["parts"]["greedy"], hdrf=False)
    extra.append(_k3_row("K3 scoring_scan greedy insert, 4,096 edges, final state",
                         "greedy", 1, g_state, src, dst, None, rt,
                         launches["greedy"]["scoring_scan"], {"state": "final"})[0])
    del g_state
    h_state = _scoring_state(main, compare["parts"]["hdrf"], hdrf=True)
    row, out = _k3_row("K3 scoring_scan hdrf insert, 4,096 edges, final state", "hdrf", 1,
                       h_state, src, dst, None, rt, launches["hdrf"]["scoring_scan"],
                       {"state": "final"})
    extra.append(row)
    after = [t.clone() for t in out[1:]]
    extra.append(_k3_row("K3 scoring_scan hdrf retract (sign=-1), 4,096 edges, final state",
                         "hdrf", -1, after, src, dst, out[0].clone(), rt, n_ret,
                         {"state": "final"})[0])
    del h_state, after, out

    # G1: the grid row's chunk, onto the loads of the chunks before it
    _, c = _grid_dims(k)
    row_t, col_t = _grid_rowcol(n, k, c, 0, "cuda")
    gp = compare["parts"]["grid"][:mid * L]
    load0 = torch.zeros(k, dtype=torch.int32, device="cuda").index_add_(
        0, gp.clamp(min=0).long(), (gp >= 0).to(torch.int32))
    load = load0.clone()
    src, dst = main_chunk(main, mid)
    E = int(src.numel())
    ms = cuda_time_ms(lambda: grid_scan(load, row_t, col_t, c, src, dst), reps=10,
                      setup=lambda: load.copy_(load0))
    load.copy_(load0)
    got = grid_scan(load, row_t, col_t, c, src, dst)
    torch.cuda.synchronize()
    want = {}
    rc, cc, cs, cd = row_t.cpu(), col_t.cpu(), src.cpu(), dst.cpu()
    plain_ms = host_time_ms(lambda: want.__setitem__(
        "out", grid_chunk_oracle(load0.to("cpu", copy=True), rc, cc, c, cs, cd)))
    err = max(max_abs_err(a, b) for a, b in zip(got, want["out"]))
    uniq = int(torch.unique(torch.cat([src, dst])).numel())
    # edge ids in, parts out; row[·] and col[·] of each touched vertex; loads
    b, by = bound_ms(12 * E + uniq * 8 + 8 * k, 6 * E)
    g1 = {"name": "G1 grid_scan", "route": "cuda",
          "source": "src/repro_torch/kernels/stream_scan/csrc/scoring_scan.cu",
          "replaces": "src/repro/kernels/stream_scan/ref.py:191 (lax.scan, no Pallas kernel)",
          "launches": launches["grid"]["grid_scan"], "max_abs_err": err,
          "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
          "library_ms": None, "latency_bound_ms": latency_bound_ms("G1", E, rt),
          "shape": {"V": n, "k": k, "chunk": E, "distinct_vertices": uniq,
                    "state": "mid", "chunk_index": mid}}
    return [*main_rows, g1], extra


def kernel_plan() -> dict:
    """K1's tile and K3's rung and tile for k = 8, 32, 256 and 4,096, as
    ``plan`` sizes them and as the C sources lay out their bytes (which must
    agree)."""
    from repro_torch.kernels.stream_scan import kernel as scan_k
    from repro_torch.kernels.stream_scan import plan

    k1_c = scan_k._lib().cluster_smem_bytes(plan.K1_TILE)
    info = {"phase": "kernel_plan",
            "k1": {"tile": plan.K1_TILE, "threads": plan.K1_THREADS,
                   "smem_bytes": plan.cluster_smem_bytes(plan.K1_TILE),
                   "smem_bytes_c": k1_c},
            "k3": {}}
    bad = k1_c != info["k1"]["smem_bytes"]
    for k in (8, 32, 256, 4096):
        p = plan.scoring_plan(k)
        c_bytes = scan_k._scoring_lib().scoring_smem_bytes(
            k, p.tile if p.rung == "shared" else 0)
        info["k3"][k] = {"rung": p.rung, "tile": p.tile, "smem_bytes": p.smem_bytes,
                         "smem_bytes_c": c_bytes}
        bad |= c_bytes != p.smem_bytes
    emit(info)
    if bad:
        raise SystemExit(f"chip_smoke: plan and C sources disagree on shared bytes: {info}")
    return info


def phase_kernels(main, compare, serve, lm, recsys, build) -> list[dict]:
    from repro_torch.kernels.stream_scan.latency import measure_round_trips

    rt = measure_round_trips()
    emit({"phase": "latency_probe", **rt, "nvidia_smi_clocks_sm": nvidia_smi_line("clocks.sm")})
    kernel_plan()
    k1 = check_k1(main, rt)
    k2 = [check_k2(main, k, rt) for k in (8, 32, 256)]
    cms = check_cms(main)
    k3_g1, k3_extra = check_k3_g1(main, compare, rt)
    k5 = check_k5(serve)
    k6 = check_k6(lm, build)
    k7 = check_k7(recsys, build)
    rows = [*k1, *k2, *cms, *k3_g1, *k3_extra, *k5, *k6, *k7]
    _check_rows(rows)
    main_k2 = next(r for r in k2 if r["shape"]["k"] == main["cfg"].k)
    summary = [k1[0], main_k2, *cms, *k3_g1, *k5, k6[0], k7[1]]
    for r in summary:  # a latency bound for the serial scans, none for the rest
        r.setdefault("latency_bound_ms", None)
    return summary, rows


def _check_rows(rows) -> None:
    """Each row within its stated limits, or else its tolerance (0 unless it
    states one)."""
    for r in rows:
        emit({"phase": "kernel", **r})
    bad = [r["name"] for r in rows
           if (not _within(r["shape"]["errors"], r["shape"]["limits"])
               if "limits" in r["shape"] else
               r["max_abs_err"] > r["shape"].get("tolerance", 0)
               or not r["shape"].get("bitwise", True))]
    if bad:
        raise SystemExit(f"chip_smoke: kernels disagree with their plain versions: {bad}")


def _latency(us: list) -> dict:
    import numpy as np

    a = np.asarray(us, np.float64)
    return {"n": int(a.size), "mean_us": float(a.mean()), "p99_us": float(np.percentile(a, 99))}


def phase_serve(products_scale: float) -> dict:
    """The serving read side over the products-shaped graph: S5P, bundle,
    registry, PageRank supersteps and queries, GCN inference through K5."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import random as trandom
    from repro_torch.configs import get_arch
    from repro_torch.core.metrics import load_balance, replication_factor
    from repro_torch.core.s5p import S5PConfig, s5p_partition
    from repro_torch.graphs import ogbn_products_like, products_features
    from repro_torch.models.gnn import gcn_forward, gcn_init
    from repro_torch.serving import BundleRegistry, GASServer, build_bundle

    t0 = time.perf_counter()
    g = ogbn_products_like(seed=0, scale=products_scale)
    graph_s = time.perf_counter() - t0
    n, E = g.n_vertices, int(g.src.size)
    t0 = time.perf_counter()
    feats_np = products_features(np.arange(n), 100, seed=0)
    feats_s = time.perf_counter() - t0
    # gcn-cora at the ogb_products shape's d_feat, as launch/cells.py sizes it
    cfg = dataclasses.replace(get_arch("gcn-cora").config,
                              d_feat=get_arch("gcn-cora").shapes["ogb_products"]["d_feat"])
    dev = torch.device("cuda")
    params = gcn_init(cfg, trandom.PRNGKey(0), device=dev)
    feats = torch.from_numpy(feats_np).to(dev)
    rng = np.random.default_rng(0)
    problems = []

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = s5p_partition(g.src, g.dst, n, S5PConfig(k=32), device=dev)
    torch.cuda.synchronize()
    s5p_s = time.perf_counter() - t0
    game_k5 = launch_counts()["segment_agg"]  # the game's two degree sums
    s_t, d_t = torch.from_numpy(g.src).to(dev), torch.from_numpy(g.dst).to(dev)
    rf = replication_factor(s_t, d_t, out.parts, n_vertices=n, k=32)
    bal = load_balance(out.parts, k=32)
    del s_t, d_t
    t0 = time.perf_counter()
    bundle = build_bundle(1, g.src, g.dst, out.parts.cpu().numpy(), n, 32, rf=rf,
                          balance=bal, device=dev)
    torch.cuda.synchronize()
    layout_s = time.perf_counter() - t0
    registry = BundleRegistry()
    registry.publish(bundle)
    server = GASServer(registry)
    t0 = time.perf_counter()
    server.run(10)
    torch.cuda.synchronize()
    supersteps_s = time.perf_counter() - t0
    lat = server.metrics.query_latency_us

    pr_vals = [server.query_pagerank(rng.integers(0, n, 16)) for _ in range(16)]
    pr_lat = lat[-16:]
    labels = server.query_components(5)
    comp_lat = lat[-1:]

    from repro_torch.kernels.segment_agg import launch_counts as k5_counts

    def k5_delta(fn):
        before = k5_counts()["segment_agg"]
        res = fn()
        return res, k5_counts()["segment_agg"] - before

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits_dev, fwd_k5 = k5_delta(lambda: gcn_forward(params, feats, bundle.edge_src,
                                                      bundle.edge_dst, n, cfg, device=dev))
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    del logits_dev
    logits, full_k5 = k5_delta(lambda: server.query_gnn(params, feats, cfg))
    full_lat = lat[-1:]
    point_k5 = []
    for _ in range(16):
        vs = rng.integers(0, n, 16)
        got, k5 = k5_delta(lambda: server.query_gnn(params, feats, cfg, vertices=vs))
        point_k5.append(k5)
        if not np.array_equal(got, logits[vs]):
            problems.append("query_gnn for 16 vertices differs from the full query's rows")
    gnn_lat = lat[-16:]
    torch.cuda.synchronize()
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    gnn_profile = _profile_query_gnn(server, params, feats, cfg)
    audit = _game_audit(out)
    if audit["delta_bits_cuda"] != audit["delta_bits_cpu"]:
        problems.append(f"the game's δ differs between cuda and cpu: {audit}")

    # the same forward on the CPU, through the plain K5
    t0 = time.perf_counter()
    params_cpu = {"layers": [{"w": layer["w"].cpu()} for layer in params["layers"]]}
    want = gcn_forward(params_cpu, feats_np, g.src, g.dst, n, cfg, device="cpu").numpy()
    cpu_forward_s = time.perf_counter() - t0
    close = bool(np.allclose(logits, want, rtol=1e-4, atol=1e-5))
    max_abs = float(np.abs(logits - want).max())

    n_chunks = math.ceil(E / S5PConfig(k=32).chunk_size)
    if fwd_k5 != 6 or full_k5 != 6 or any(k != 6 for k in point_k5):
        problems.append(f"K5 launches per forward {fwd_k5}, {full_k5}, {point_k5}, not 6")
    if game_k5 != 2 or launches["segment_agg"] - game_k5 != 6 * 18:
        problems.append(f"K5 launched {launches['segment_agg']} times, {game_k5} in S5P's "
                        "game: not 2 + 6 x 18")
    if launches["cluster_scan"] != n_chunks or launches["assign_scan"] != n_chunks:
        problems.append(f"K1/K2 launches {launches} != {n_chunks} chunks")
    if launches["cms_update"] < 1 or launches["cms_query"] < 1:
        problems.append(f"CMS kernels not launched: {launches}")
    if not close:
        problems.append(f"cuda logits differ from cpu beyond rtol 1e-4, atol 1e-5 (max {max_abs})")
    if logits.shape != (n, cfg.n_classes) or not np.isfinite(logits).all():
        problems.append(f"logits of shape {logits.shape}, or not finite")
    if not all(np.isfinite(v).all() and (v > 0).all() and v.shape == (16,) for v in pr_vals):
        problems.append("PageRank values not finite and positive")
    if labels.shape != (n,) or (labels > np.arange(n)).any() or labels.min() < 0:
        problems.append("component labels outside [0, v]")
    if not 1.0 <= rf <= 32:
        problems.append(f"RF {rf} outside [1, k]")
    info = {
        "phase": "serve", "graph": f"ogbn_products_like(seed=0, scale={products_scale})",
        "V": n, "E": E, "k": 32, "generate_graph_s": graph_s, "generate_features_s": feats_s,
        "s5p_s": s5p_s, "s5p_seconds": out.timings, "rf": rf, "balance": bal,
        "sync_bytes_per_superstep": server.metrics.bytes_per_superstep(),
        "layout_s": layout_s, "supersteps": 10, "supersteps_s": supersteps_s,
        "latency": {"query_pagerank": _latency(pr_lat),
                    "query_components": _latency(comp_lat),
                    "query_gnn_all": _latency(full_lat),
                    "query_gnn_16": _latency(gnn_lat)},
        "gcn": {"d_feat": cfg.d_feat, "d_hidden": cfg.d_hidden, "n_classes": cfg.n_classes,
                "forward_s": forward_s, "k5_per_forward": fwd_k5,
                "cpu_forward_s": cpu_forward_s, "max_abs_err_vs_cpu": max_abs,
                "within_rtol_1e-4": close},
        "components": int(np.unique(labels).size),
        "max_memory_allocated": peak, "launches": launches,
        "query_gnn_profile": gnn_profile, "game_audit": audit,
    }
    for step, keys in (("graph", ("graph", "V", "E", "generate_graph_s", "generate_features_s")),
                       ("s5p", ("k", "rf", "balance", "s5p_s", "s5p_seconds", "game_audit")),
                       ("gas", ("sync_bytes_per_superstep", "layout_s", "supersteps",
                                "supersteps_s", "components")),
                       ("latency", ("latency", "query_gnn_profile")), ("gcn", ("gcn",)),
                       ("device", ("max_memory_allocated", "launches"))):
        emit({"phase": "serve", "step": step, **{key: info[key] for key in keys}})
    if problems:
        raise SystemExit("chip_smoke serve phase failed: " + "; ".join(problems))
    return {"info": info, "params": params, "feats": feats, "bundle": bundle, "cfg": cfg,
            "launches": launches}


def _profile_query_gnn(server, params, feats, cfg) -> dict:
    """One more ``query_gnn`` (all vertices) under ``torch.profiler``: its
    device time split into K5, the sorts of ``gcn_norm``'s two layouts, the
    matmuls and the rest, against the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def group(name: str) -> str:
        low = name.lower()
        if "segment_agg_kernel" in name:
            return "k5"
        if "sort" in low or "radix" in low or "onesweep" in low:
            return "sort"
        if any(t in low for t in ("gemm", "gemv", "nvjet", "cutlass", "xmma", "sm90_")):
            return "matmul"
        return "other"

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.query_gnn(params, feats, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups: dict[str, float] = {}
    kernels = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if us > 0 and e.device_type is not None and "cuda" in str(e.device_type).lower():
            groups[group(e.key)] = groups.get(group(e.key), 0.0) + us / 1e3
            kernels.append({"name": e.key[:90], "calls": e.count, "device_ms": us / 1e3})
    busy = sum(groups.values())
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "device_ms_by_group": groups, "k5_ms": groups.get("k5", 0.0),
            "rest_device_ms": busy - groups.get("k5", 0.0),
            "top_kernels": sorted(kernels, key=lambda k: -k["device_ms"])[:10]}


def check_k5(serve) -> list[dict]:
    """K5 at the serve phase's shapes against the plain version on the CPU."""
    import torch

    from repro_torch.kernels.segment_agg import kernel_attributes, segment_agg
    from repro_torch.models.gnn import gcn_layer, gcn_norm

    bundle, params, feats = serve["bundle"], serve["params"], serve["feats"]
    n = bundle.n_vertices
    norm = gcn_norm(bundle.edge_src, bundle.edge_dst, n, device="cuda")
    lay = norm.fwd  # the forward direction's layout, the GCN's weights
    x1 = feats @ params["layers"][0]["w"]
    x2 = torch.relu(gcn_layer(x1, norm)) @ params["layers"][1]["w"]
    E = int(lay.src.numel())
    unit = lay.with_weights(torch.ones(lay.n_edges, device="cuda"))
    cases = [("K5 segment_agg degrees (d=1, f32)", torch.ones(n, 1, device="cuda"), unit),
             ("K5 segment_agg layer 1 (d=16, f32)", x1, lay),
             ("K5 segment_agg layer 2 (d=7, f32)", x2, lay),
             ("K5 segment_agg features (d=100, bf16)", feats.to(torch.bfloat16), lay)]
    rows = []
    for name, x, layout in cases:
        x = x.contiguous()
        cpu_lay = layout._replace(src=layout.src.cpu(), dst=layout.dst.cpu(),
                                  w=layout.w.cpu(), row_ptr=layout.row_ptr.cpu(),
                                  order=layout.order.cpu(), long_rows=layout.long_rows.cpu())
        n_long = int(layout.long_rows.numel())
        flags = torch.zeros(n_long, dtype=torch.int32, device="cuda")
        segment_agg(x, layout, tree_flags=flags)
        csr = torch.sparse_csr_tensor(layout.row_ptr, layout.src.long(), layout.w,
                                      size=(n, n))
        ms = cuda_time_ms(lambda: segment_agg(x, layout), reps=5)
        got = segment_agg(x, layout)
        torch.cuda.synchronize()
        xc = x.cpu()
        want = {}
        plain_ms = host_time_ms(lambda: want.__setitem__("out", segment_agg(xc, cpu_lay)))
        g, w = got.cpu(), want["out"]
        if g.shape != w.shape or g.dtype != w.dtype:
            raise SystemExit(f"chip_smoke: K5 gave {g.shape} {g.dtype}, not {w.shape} {w.dtype}")
        err = float((g.float() - w.float()).abs().max()) if g.numel() else 0.0
        bits = torch.int32 if g.dtype == torch.float32 else torch.int16
        bitwise = torch.equal(g.view(bits), w.view(bits))
        d, esize = int(x.shape[1]), x.element_size()
        # each input read once, each output written once
        n_bytes = 8 * E + 8 * (n + 1) + n * d * esize + n * d * esize
        b, by = bound_ms(n_bytes, 2 * E * d)
        # no reuse of gathered rows: each costs at least one 32-byte sector
        sectors = -(-d * esize // 32) * 32
        no_reuse, _ = bound_ms(8 * E + 8 * (n + 1) + E * sectors + n * d * esize, 0)
        lib_ms, lib_error = None, None
        if x.dtype == torch.bfloat16:  # the same CSR with bf16 weights, as x's type
            csr = torch.sparse_csr_tensor(layout.row_ptr, layout.src.long(),
                                          layout.w.to(torch.bfloat16), size=(n, n))
        try:
            lib_ms = cuda_time_ms(lambda: torch.sparse.mm(csr, x), reps=5)
        except RuntimeError as e:  # a yardstick only: record why there is none
            lib_error = str(e).splitlines()[0]
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/segment_agg/csrc/segment_agg.cu",
                     "replaces": "src/repro/kernels/segment_agg/kernel.py:61",
                     "launches": serve["launches"]["segment_agg"], "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                     "library_ms": lib_ms,
                     "shape": {"rows": n, "V": n, "d": d, "dtype": str(x.dtype),
                               "bitwise": bitwise,
                               "edges": E, "max_row": int(layout.row_ptr.diff().max()),
                               "long_row_edges": layout.long_row_edges, "n_long": n_long,
                               "tree_rows": int(flags.sum()), "kernel": kernel_attributes(x),
                               "no_reuse_bound_ms": no_reuse,
                               "library": "torch.sparse.mm(CSR of the weights, x)",
                               "library_error": lib_error}})
    return rows


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
    delta = _delta_above_2_24()
    info = {"phase": "parity", "graph": "community_graph(2000, 32, 8, seed=5)",
            "k": 8, "E": int(src.shape[0]), "parts_identical": same,
            "differing_edges": differing, "cuda_cpu_s": seconds, "delta_above_2^24": delta}
    emit(info)
    if not same:
        raise SystemExit(f"chip_smoke: cuda and cpu parts differ on the community graph: {differing}")
    if not delta["same"]:
        raise SystemExit(f"chip_smoke: the game's δ above 2**24 differs, cuda vs cpu: {delta}")
    return info


def _delta_above_2_24() -> dict:
    """The game's δ where Σ(degs + sizes) passes 2**24: the Θ inputs of
    ``community_graph(600, 8, 6, seed=3)`` at k = 8 (CMS Θ, two-stage),
    sizes and Θ scaled by 3001, on the card and on the CPU; δ's bits and
    the game's assignment must agree (the reference gives 0x371b42d7)."""
    import numpy as np
    import torch

    from repro_torch.core import clustering as cl
    from repro_torch.core import game as G
    from repro_torch.core.s5p import cluster_statistics
    from repro_torch.graphs import community_graph

    src, dst, n = community_graph(600, n_communities=8, avg_degree=6, seed=3)
    s, d = torch.from_numpy(src).int(), torch.from_numpy(dst).int()
    deg = cl.compute_degrees(s, d, n)
    xi, kappa = int(2.0 * src.size / n), max(int(np.ceil(2.0 * src.size / 8)), 2)
    res = cl.compact_clusters(cl.cluster_stream(s, d, n, xi=xi, kappa=kappa, device="cpu"),
                              deg, xi)
    sizes, pa, pb, pw, _ = cluster_statistics(s, d, res, deg, xi, use_cms=True,
                                              cms_epsilon=0.1, cms_nu=0.01, seed=0)
    C = res.n_clusters
    cpu = G.GameInputs(sizes * 3001, pa, pb, pw * 3001, res.n_head, 8)
    dev = G.GameInputs(*(t.cuda() for t in cpu[:4]), res.n_head, 8)
    bits = [int(G.compute_delta(g.sizes, G._cluster_degrees(g, C), 8).cpu().view(torch.int32))
            for g in (dev, cpu)]
    kw = dict(batch_size=G.default_batch_size(256, C), accept_prob=0.9, seed=3)
    g_dev, g_cpu = G.run_game(dev, C, **kw), G.run_game(cpu, C, **kw)
    total = float((G._cluster_degrees(cpu, C) + cpu.sizes).double().sum())
    same = (bits[0] == bits[1] and g_dev.rounds == g_cpu.rounds
            and torch.equal(g_dev.assignment.cpu(), g_cpu.assignment))
    return {"sum_degs_sizes": total, "delta_bits_cuda": hex(bits[0]),
            "delta_bits_cpu": hex(bits[1]), "game_rounds": g_cpu.rounds, "same": same}


def _highest_f32() -> None:
    """Float32 matmuls in full float32 on the card (no TF32), stated."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def phase_lm(prompt_len: int = 4096, batch: int = 4, gen_tokens: int = 32,
             f32_layers: int = 2) -> dict:
    """The LM serving path at full width (llama3-8b), then the float32
    prefill-against-decode check at full width and ``f32_layers`` layers."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import random as trandom
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models import lm as LM

    _highest_f32()
    arch = "llama3-8b"
    cfg = get_arch(arch).config
    dev = torch.device("cuda")
    problems = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    stats = {}
    t0 = time.perf_counter()
    seqs = serve_lm(arch, prompt_len=prompt_len, gen_tokens=gen_tokens, batch=batch,
                    smoke=False, seed=0, device=dev, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    decode_ms = np.asarray(stats["decode_s"]) * 1e3
    first, last = stats.pop("prefill_logits"), stats.pop("last_logits")
    finite = bool(torch.isfinite(first).all()) and bool(torch.isfinite(last).all())
    toks = seqs.cpu().numpy()
    info = {
        "phase": "lm", "arch": arch, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "params": LM.count_params(cfg), "dtype": str(cfg.dtype), "seed": 0,
        "batch": batch, "prompt_len": prompt_len, "gen_tokens": gen_tokens,
        "init_s": stats["init_s"], "init_peak_bytes": stats["init_peak_bytes"],
        "prefill_s": stats["prefill_s"],
        "prefill_tokens_per_s": batch * prompt_len / stats["prefill_s"],
        "decode_ms_per_token": {"n": int(decode_ms.size), "mean": float(decode_ms.mean()),
                                "p99": float(np.percentile(decode_ms, 99))},
        "decode_tokens_per_s": batch / float(decode_ms.mean()) * 1e3,
        "wall_s": wall, "max_memory_allocated": peak, "launches": launches,
        "logits_finite": finite, "logits_abs_max": float(first.float().abs().max()),
        "tokens_head": toks[:, :8].tolist(),
    }
    emit(info)
    if launches["flash_attention"] != cfg.n_layers:
        problems.append(f"K6 launched {launches['flash_attention']} times in the prefill, "
                        f"not once per layer ({cfg.n_layers})")
    if toks.shape != (batch, gen_tokens) or toks.min() < 0 or toks.max() >= cfg.vocab:
        problems.append(f"tokens of shape {toks.shape} or outside the vocabulary")
    if not finite:
        problems.append("logits not finite")

    # float32 at full width, f32_layers layers: K6 (prefill) against the plain
    # decode path on the same card
    cfg32 = dataclasses.replace(cfg, n_layers=f32_layers, dtype=torch.float32)
    key = trandom.PRNGKey(0)
    torch.cuda.reset_peak_memory_stats()
    params = LM.init_params(cfg32, key, device=dev)
    prompts = trandom.randint(key, (batch, prompt_len), 0, cfg.vocab, device=dev)
    reset_launch_counts()
    with torch.inference_mode():
        want, _ = LM.prefill(params, prompts, cfg32, max_seq=prompt_len, device=dev)
        _, cache = LM.prefill(params, prompts[:, :-1], cfg32, max_seq=prompt_len, device=dev)
        pos = torch.full((batch,), prompt_len - 1, dtype=torch.int32, device=dev)
        got, _ = LM.decode_step(params, cache, prompts[:, -1], pos, cfg32, device=dev)
    torch.cuda.synchronize()
    k6_f32 = launch_counts()["flash_attention"]
    err = float((got - want).abs().max())
    close = bool(torch.allclose(got, want, atol=2e-3, rtol=1e-3))
    check = {"phase": "lm", "step": "float32 prefill against decode",
             "layers": f32_layers, "d_model": cfg.d_model, "batch": batch,
             "prompt_len": prompt_len, "max_abs_err": err,
             "logits_abs_max": float(want.abs().max()), "within_atol_2e-3_rtol_1e-3": close,
             "k6_launches": k6_f32, "max_memory_allocated": torch.cuda.max_memory_allocated()}
    emit(check)
    del params, cache, prompts
    if not close or not math.isfinite(err):
        problems.append(f"float32 prefill and decode logits differ by {err}")
    if k6_f32 != 2 * f32_layers:
        problems.append(f"K6 launched {k6_f32} times in two float32 prefills of "
                        f"{f32_layers} layers")
    if problems:
        raise SystemExit("chip_smoke lm phase failed: " + "; ".join(problems))
    return {"info": info, "f32_check": check, "launches": launches}


def _visible_pairs(q_pos, kv_pos, causal, window) -> int:
    """Visible (query, key) pairs per head, summed over the batch rows: for
    each query, the keys with ``kv_pos >= 0`` and ``q − window < kv_pos <= q``
    (as the masks say), counted on sorted key positions."""
    import torch

    total = 0
    for qp, kp in zip(q_pos.long(), kv_pos.long()):
        keys = torch.sort(kp[kp >= 0]).values
        hi = torch.searchsorted(keys, qp, right=True) if causal else \
            torch.full_like(qp, keys.numel())
        lo = torch.searchsorted(keys, qp - window, right=True) if window is not None else \
            torch.zeros_like(qp)
        total += int((hi - lo).clamp(min=0).sum())
    return total


# K6's limits against its plain version.  float32: atol 2e-5, as the flash
# sweep of tests/test_kernels.py.  bfloat16, where a flat atol would be as
# large as a typical output of a long row: per (query, head) row, the
# largest |got − want| over the row's largest |want| (two bf16 ulps of it;
# one output rounding flipped is at most one), and mean |got − want| over
# mean |want|.  The mean limit lies between what K6 reads on the H100
# (about 1e-5) and what q and p left unrounded read (about 2e-3; PERF.md
# §6).  Every check also shows that two planted faults fail the limits.
K6_LIMITS = {"bfloat16": {"row_rel_err": 2**-6, "mean_rel_err": 2**-13},
             "float32": {"max_abs_err": 2e-5}}


def _k6_errs(got, want, hd: int) -> dict:
    d = (got.float() - want.float()).abs().view(-1, hd)
    w = want.float().abs().view(-1, hd)
    return {"max_abs_err": float(d.max()),
            "row_rel_err": float((d.amax(1) / w.amax(1).clamp(min=1e-30)).max()),
            "mean_rel_err": float(d.mean() / w.mean())}


def _within(errs: dict, limits: dict) -> bool:
    return all(errs[k] <= v for k, v in limits.items())


K6_CASES = [  # name, B, S, T, H, KV, dtype, window, padded keys
    ("K6 flash_attention llama3-8b prefill (bf16, causal)", 4, 4096, 4096, 32, 8,
     "bfloat16", None, 0),
    ("K6 flash_attention qwen3-14b groups G=5 (bf16, causal)", 1, 4096, 4096, 40, 8,
     "bfloat16", None, 0),
    ("K6 flash_attention Mixtral window 4096 over 8192 (bf16)", 1, 8192, 8192, 32, 8,
     "bfloat16", 4096, 0),
    ("K6 flash_attention ragged, padded keys (f32, causal)", 2, 1000, 1100, 32, 8,
     "float32", None, 37),
]
K6_HD = 128


def k6_inputs(case, gen) -> tuple:
    """q (B·KV, S, G·hd), k, v (B·KV, T, hd) from ``gen`` on the card, and
    the positions: queries at the last S of T, the last keys padding."""
    import torch

    _, B, S, T, H, KV, dtn, _, pad = case
    dt, G, hd = getattr(torch, dtn), H // KV, K6_HD
    q = torch.randn(B * KV, S, G * hd, device="cuda", generator=gen).to(dt)
    k = torch.randn(B * KV, T, hd, device="cuda", generator=gen).to(dt)
    v = torch.randn(B * KV, T, hd, device="cuda", generator=gen).to(dt)
    qp = torch.arange(T - S, T, dtype=torch.int32, device="cuda").expand(B * KV, S).contiguous()
    kp = torch.arange(T, dtype=torch.int32, device="cuda").expand(B * KV, T).contiguous()
    if pad:  # the last keys are padding
        kp[:, T - pad:] = -(2**30)
    return q, k, v, qp, kp


def k6_tile_classes(case, qp, kp) -> dict:
    """How many (q tile, kv tile) pairs of one kv head K6 skips, masks and
    takes whole, from ``kv_tile_classes`` (the kernel's rule in torch)."""
    import torch

    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention import ref as fa_ref

    _, B, S, T, H, KV, dtn, window, _ = case
    dt = getattr(torch, dtn)
    cls = fa_ref.kv_tile_classes(qp[::KV], kp[::KV], H // KV, fa_k.ROW_TILE[dt],
                                 fa_k.KEY_TILE[dt], causal=True, window=window)
    return {"rows": fa_k.ROW_TILE[dt], "keys": fa_k.KEY_TILE[dt],
            "skip": int((cls == fa_ref.SKIP).sum()), "partial": int((cls == fa_ref.PARTIAL).sum()),
            "full": int((cls == fa_ref.FULL).sum())}


def check_k6(lm, build) -> list[dict]:
    """K6 at the LM's shapes against ``flash_attention_ref`` on the same
    card tensors (float32 products in full float32), within ``K6_LIMITS``.
    The plain version runs over K6's key tiles (``KEY_TILE``), so each
    row's running max, and with it each p rounded to bf16, is K6's: over
    other tiles the two would round p apart, as far apart as a p left
    unrounded.
    Two planted faults, computed by the plain version on altered inputs,
    must fail those limits: one kv tile in the middle dropped (its keys
    masked), and, in bf16, q and p kept in float32 (the inputs upcast).
    ``scaled_dot_product_attention`` is the yardstick: ``is_causal`` where
    the mask is causal alone, else a boolean mask built from the positions
    (every query row sees a key, so the sentinel decides nothing).  Each
    row also states the tile classes and the compiled kernel's registers,
    spills and shared memory."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention import flash_attention_fwd, flash_attention_ref

    _highest_f32()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    hd = K6_HD
    for case in K6_CASES:
        name, B, S, T, H, KV, dtn, window, pad = case
        dt, G = getattr(torch, dtn), H // KV
        q, k, v, qp, kp = k6_inputs(case, gen)
        ms = cuda_time_ms(lambda: flash_attention_fwd(q, k, v, qp, kp, causal=True,
                                                      window=window), reps=10)
        got = flash_attention_fwd(q, k, v, qp, kp, causal=True, window=window)
        torch.cuda.synchronize()
        out = {}

        def plain(qq=q, kk=k, vv=v, kpos=kp):
            return flash_attention_ref(qq, kk, vv, qp, kpos, causal=True, window=window,
                                       block_q=1024, block_k=fa_k.KEY_TILE[dt])

        plain_ms = cuda_time_ms(lambda: out.__setitem__("ref", plain()), reps=2)
        limits = K6_LIMITS[dtn]
        errs = _k6_errs(got, out["ref"], hd)
        j0 = (T // 2) // 64 * 64
        kp_drop = kp.clone()
        kp_drop[:, j0:j0 + 64] = -1
        faults = {f"kv tile {j0}..{j0 + 63} dropped": _k6_errs(got, plain(kpos=kp_drop), hd)}
        if dt == torch.bfloat16:
            faults["q and p kept in float32"] = _k6_errs(
                got, plain(q.float(), k.float(), v.float()).to(dt), hd)
        passed = [f for f, e in faults.items() if _within(e, limits)]
        if passed:
            raise SystemExit(f"chip_smoke: {name}: the limits {limits} do not see the "
                             f"planted faults {passed}: {faults}")
        ql = q.view(B, KV, S, G, hd).permute(0, 1, 3, 2, 4).reshape(B, H, S, hd)
        kl, vl = k.view(B, KV, T, hd), v.view(B, KV, T, hd)
        if window is None and not pad and S == T:
            library = "scaled_dot_product_attention(is_causal=True, enable_gqa=True)"
            lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
                ql, kl, vl, is_causal=True, enable_gqa=True), reps=10)
        else:
            library = ("scaled_dot_product_attention(attn_mask=(B, 1, S, T) bool from the "
                       "positions, enable_gqa=True)")
            dp = qp[::KV, :, None] - kp[::KV, None, :]
            mask = (kp[::KV, None, :] >= 0) & (dp >= 0)
            if window is not None:
                mask &= dp < window
            mask = mask[:, None]
            lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
                ql, kl, vl, attn_mask=mask, enable_gqa=True), reps=10)
            del mask, dp
        pairs = _visible_pairs(qp[::KV], kp[::KV], True, window) * H
        es = q.element_size()
        n_bytes = (2 * q.numel() + k.numel() + v.numel()) * es + 4 * (qp.numel() + kp.numel())
        n_ops = 4 * hd * pairs  # q·k and p·v per visible pair
        peak = BF16_TENSOR_OPS_PER_S if dt == torch.bfloat16 else SCALAR_OPS_PER_S
        b, by = bound_ms(n_bytes, n_ops, peak)
        kern = f"fa_fwd_{'bf16' if dt == torch.bfloat16 else 'f32'}<{hd}>"
        compiled = dict(build.get("k6_kernels", {}).get(kern, {}),
                        smem_bytes=fa_k.smem_bytes(hd, dt))
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
                     "replaces": "src/repro/kernels/flash_attention/kernel.py:36",
                     "launches": lm["launches"]["flash_attention"],
                     "max_abs_err": errs["max_abs_err"],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                     "library_ms": lib_ms,
                     "shape": {"B": B, "S": S, "T": T, "H": H, "KV": KV, "hd": hd,
                               "dtype": dtn, "window": window, "padded_keys": pad,
                               "errors": errs, "limits": limits, "planted_faults": faults,
                               "visible_pairs_per_head": pairs // H,
                               "tile_classes": k6_tile_classes(case, qp, kp),
                               "kernel": kern, "compiled": compiled,
                               "flops": n_ops, "bytes": n_bytes,
                               "tflops_per_s": n_ops / ms / 1e9,
                               "plain": f"flash_attention_ref(block_q=1024, "
                                        f"block_k={fa_k.KEY_TILE[dt]}), on the card, TF32 off",
                               "library": library,
                               "launches_on": "llama3-8b prefill (phase lm)"}})
        del q, k, v, ql, got, out
    return rows


def _tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tree_leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _tree_leaves(v)]
    return [tree]


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
    return tree.to(dev)


def _pool_errs(got: list, want: list) -> list:
    """Each CIN layer's max |got − want| over the layer's max |want|."""
    return [float((g.cpu() - w).abs().max() / w.abs().max()) for g, w in zip(got, want)]


XDEEPFM_PARAMS = 50_453_809


def phase_recsys(p99_requests: int = 16, bulk_batch: int = 262_144, bulk_requests: int = 2,
                 n_candidates: int = 1_000_000, cpu_rows: int = 1024) -> dict:
    """The recsys serving path at xDeepFM's published config: ``serve_recsys``
    (the first ``serve_p99`` request), ``p99_requests`` more of 512 samples,
    ``bulk_requests`` of ``bulk_batch``, one retrieval of 1 query against
    ``n_candidates``; then the last p99 request and the first ``cpu_rows``
    rows of the last bulk request again on the CPU."""
    import numpy as np
    import torch

    from repro_torch import random as trandom
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import recsys_ids, serve_recsys
    from repro_torch.models import recsys as R

    _highest_f32()
    arch = "xdeepfm"
    cfg = get_arch(arch).config
    dev = torch.device("cuda")
    problems = []

    def request(ids):
        """One request: the forward and a copy of the scores to the host."""
        pools = []
        torch.cuda.synchronize()
        c0 = launch_counts()["cin"]
        t0 = time.perf_counter()
        with torch.inference_mode():
            host = R.xdeepfm_forward(params, ids, cfg, pools=pools).cpu()
        return time.perf_counter() - t0, host, pools, launch_counts()["cin"] - c0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    stats = {}
    t0 = time.perf_counter()
    serve_recsys(arch, batch=512, smoke=False, seed=0, device=dev, stats=stats)
    first_scores = stats["scores"].cpu()
    first_s = time.perf_counter() - t0
    params = stats["params"]
    n_params = sum(t.numel() for t in _tree_leaves(params))
    per_forward = [launch_counts()["cin"]]
    finite = bool(torch.isfinite(first_scores).all())

    p99_s = []
    for r in range(1, p99_requests + 1):
        ids = recsys_ids(trandom.PRNGKey(r), cfg, 512, dev)
        s, host, pools, k7 = request(ids)
        p99_s.append(s)
        per_forward.append(k7)
        finite &= bool(torch.isfinite(host).all())
    p99_check = (ids, host, pools)

    bulk_s = []
    for r in range(bulk_requests):
        ids = recsys_ids(trandom.PRNGKey(p99_requests + 1 + r), cfg, bulk_batch, dev)
        s, host, pools, k7 = request(ids)
        bulk_s.append(s)
        per_forward.append(k7)
        finite &= bool(torch.isfinite(host).all()) and host.shape == (bulk_batch,)
    bulk_check = (ids[:cpu_rows], host[:cpu_rows], [p[:cpu_rows] for p in pools])
    del pools

    query = recsys_ids(trandom.PRNGKey(p99_requests + bulk_requests + 1), cfg, 1, dev)
    cand = trandom.normal(trandom.PRNGKey(p99_requests + bulk_requests + 2),
                          (n_candidates, cfg.embed_dim), dev)
    retrieval_s = []  # the first call pays the first use of its kernels
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            top_v, top_i = R.retrieval_scores(params, query, cand, cfg, top_k=100)
            top_v, top_i = top_v.cpu(), top_i.cpu()
        retrieval_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()

    # the same requests on the CPU forward, same parameters and ids
    cpu_params = _tree_to(params, "cpu")
    checks = {}
    for name, (ids, got, got_pools) in (("serve_p99 last request", p99_check),
                                        (f"serve_bulk first {cpu_rows} rows", bulk_check)):
        want_pools = []
        t0 = time.perf_counter()
        want = R.xdeepfm_forward(cpu_params, ids.cpu(), cfg, pools=want_pools)
        checks[name] = {
            "rows": int(want.shape[0]), "cpu_forward_s": time.perf_counter() - t0,
            "logits_max_abs_err": float((got - want).abs().max()),
            "logits_abs_max": float(want.abs().max()),
            "logits_within_rtol_1e-4_atol_1e-6": bool(torch.allclose(got, want, rtol=1e-4,
                                                                     atol=1e-6)),
            "pool_rel_errs": _pool_errs(got_pools, want_pools),
            "pool_abs_max": [float(w.abs().max()) for w in want_pools]}
    # every candidate scored on the CPU: the card's top 100 must carry the
    # CPU's top values, in order (a near-tie may swap two indices)
    all_v, all_i = R.retrieval_scores(cpu_params, query.cpu(), cand.cpu(), cfg,
                                      top_k=n_candidates)
    cpu_score = torch.empty(n_candidates)
    cpu_score[all_i[0].long()] = all_v[0]
    want_v = all_v[0, :100]
    retrieval_ok = bool(torch.allclose(top_v[0], want_v, rtol=1e-4, atol=1e-6)
                        and torch.allclose(cpu_score[top_i[0].long()], want_v, rtol=1e-4,
                                           atol=1e-6)
                        and (top_v[0].diff() <= 0).all())

    p99_ms = np.asarray(p99_s) * 1e3
    info = {
        "phase": "recsys", "arch": arch, "params": n_params, "dtype": str(cfg.dtype),
        "seed": 0, "n_fields": cfg.n_fields, "embed_dim": cfg.embed_dim,
        "cin_layers": list(cfg.cin_layers), "mlp_dims": list(cfg.mlp_dims),
        "embedding_rows": sum(cfg.vocabs()),
        "init_s": stats["init_s"], "init_peak_bytes": stats["init_peak_bytes"],
        "first_request_s": first_s, "first_forward_s": stats["forward_s"],
        "serve_p99": {"batch": 512, "requests": p99_requests,
                      "latency_ms": {"mean": float(p99_ms.mean()),
                                     "p99": float(np.percentile(p99_ms, 99)),
                                     "min": float(p99_ms.min())}},
        "serve_bulk": {"batch": bulk_batch, "requests": bulk_requests, "seconds": bulk_s,
                       "samples_per_s": [bulk_batch / s for s in bulk_s]},
        "retrieval": {"queries": 1, "candidates": n_candidates, "top_k": 100,
                      "latency_ms": retrieval_s[1] * 1e3,
                      "first_call_ms": retrieval_s[0] * 1e3, "matches_cpu": retrieval_ok},
        "k7_per_forward": per_forward, "launches": launches,
        "max_memory_allocated": peak, "logits_finite": finite, "cpu_checks": checks,
    }
    emit(info)
    n_forwards = 1 + p99_requests + bulk_requests
    if n_params != XDEEPFM_PARAMS:
        problems.append(f"{n_params} parameters, not {XDEEPFM_PARAMS}")
    if any(k != len(cfg.cin_layers) for k in per_forward) or \
            launches["cin"] != len(cfg.cin_layers) * n_forwards:
        problems.append(f"K7 launched {per_forward} times per forward ({launches['cin']} in "
                        f"all), not {len(cfg.cin_layers)} per forward")
    if not finite:
        problems.append("logits not finite")
    for name, c in checks.items():
        if not c["logits_within_rtol_1e-4_atol_1e-6"]:
            problems.append(f"{name}: logits differ from the CPU beyond rtol 1e-4, atol 1e-6")
        if not all(e <= 1e-5 for e in c["pool_rel_errs"]):
            problems.append(f"{name}: CIN pools differ from the CPU by {c['pool_rel_errs']} "
                            "of their max, above 1e-5")
    if not retrieval_ok:
        problems.append("retrieval top 100 differs from the CPU")
    if problems:
        raise SystemExit("chip_smoke recsys phase failed: " + "; ".join(problems))
    return {"info": info, "launches": launches}


# K7's limits against its plain version.  float32: max |Δ| over max |want|
# (the reference's jnp CIN, the Pallas kernel and the plain version agree
# to ~6e-7 of it at the published shapes).  bfloat16: per element
# |Δ| ≤ 2^-7·|want| + 2^-15·max |want| (one output rounding, and the
# float32 sums' disagreement near zero), as the ratio ``elem_ratio`` ≤ 1;
# and mean |Δ| over mean |want| ≤ 2^-16, about 10× what K7 read at layer
# 2's shape on an NVIDIA H100 80GB HBM3 at 700 W (1.42e-6) and 1/3,700 of
# a dropped h slice (0.056; PERF.md §6).
K7_LIMITS = {"float32": {"rel_err": 1e-5},
             "bfloat16": {"elem_ratio": 1.0, "mean_rel_err": 2**-16}}


def _k7_errs(got, want) -> dict:
    d = (got.float() - want.float()).abs()
    w = want.float().abs()
    top = w.max()
    return {"max_abs_err": float(d.max()), "rel_err": float(d.max() / top),
            "elem_ratio": float((d / (2**-7 * w + 2**-15 * top)).max()),
            "mean_rel_err": float(d.mean() / w.mean())}


K7_CASES = [  # name, B, Hk, dtype: m = 39, H' = 200, D = 10 (the published widths)
    ("K7 cin serve_p99 layer 1 (B=512, f32)", 512, 39, "float32"),
    ("K7 cin serve_p99 layer 2 (B=512, f32)", 512, 200, "float32"),
    ("K7 cin serve_p99 layer 2 (B=512, bf16)", 512, 200, "bfloat16"),
    ("K7 cin ragged layer 2 (B=1000, f32)", 1000, 200, "float32"),
    ("K7 cin serve_bulk layer 2 (B=262144, f32)", 262_144, 200, "float32"),
]


def k7_inputs(B: int, Hk: int, dt, gen, m: int = 39, Hn: int = 200, D: int = 10):
    """xk, x0, w at the model's scales: embeddings 0.01, layer-1 outputs
    ~5e-4, w 0.1 (layer 1 takes x0 as xk)."""
    import torch

    x0 = (0.01 * torch.randn(B, m, D, device="cuda", generator=gen)).to(dt)
    xk = x0 if Hk == m else \
        (5e-4 * torch.randn(B, Hk, D, device="cuda", generator=gen)).to(dt)
    w = (0.1 * torch.randn(Hk * m, Hn, device="cuda", generator=gen)).to(dt)
    return xk, x0, w


def k7_bounds(B: int, Hk: int, m: int, D: int, Hn: int, dtn: str, elem: int) -> dict:
    """K7's bound on the tensor cores (3 TF32 products in float32 at 495
    TFLOP/s, 2 bf16 products in bf16 at 989: the passes its rounding needs)
    and the scalar-rate bound that the scalar kernel was held to (one
    product at 67 TFLOP/s)."""
    n_ops = 2 * B * D * Hk * m * Hn
    n_bytes = (B * D * (Hk + m + Hn) + Hk * m * Hn) * elem
    passes, rate = (3, TF32_TENSOR_OPS_PER_S) if dtn == "float32" else \
        (2, BF16_TENSOR_OPS_PER_S)
    b, by = bound_ms(n_bytes, passes * n_ops, rate)
    return {"bound_ms": b, "bound_by": by, "bound_scalar_ms": bound_ms(n_bytes, n_ops)[0],
            "flops": n_ops, "tensor_flops": passes * n_ops, "bytes": n_bytes}


def check_k7(recsys, build) -> list[dict]:
    """K7 at the recsys path's shapes against ``cin_layer_ref`` on the same
    card tensors (float32 products in full float32), within ``K7_LIMITS``.
    Two launches on the same inputs must give equal bits.  Two planted
    faults must fail those limits: the plain version with one h slice of
    ``xk`` zeroed, and, where ``plan`` splits the K stages, the emulated
    partials (``cin_split_partials``) summed without one split.  The
    yardstick is one ``torch.einsum`` of the same function with TF32 off,
    where its (B, Hk, m, D) intermediate fits the card."""
    import torch

    from repro_torch.kernels.cin import cin_layer, cin_layer_ref, cin_split_partials, plan
    from repro_torch.kernels.cin.kernel import _lib, _slots

    _highest_f32()
    gen = torch.Generator(device="cuda").manual_seed(0)
    m, Hn, D = 39, 200, 10
    compiled = {k: v for k, v in build.get("k7_kernels", {}).items() if "cin_kernel" in k}
    rows = []
    for name, B, Hk, dtn in K7_CASES:
        dt = getattr(torch, dtn)
        bulk = B > 100_000
        xk, x0, w = k7_inputs(B, Hk, dt, gen)
        is_bf16 = int(dt == torch.bfloat16)
        cut = plan(B, Hk, m, D, Hn, dt, _slots(_lib(), xk.device, m, is_bf16), _lib())
        ms = cuda_time_ms(lambda: cin_layer(xk, x0, w), reps=3 if bulk else 10)
        got = cin_layer(xk, x0, w)
        again = cin_layer(xk, x0, w)
        torch.cuda.synchronize()
        as_int = torch.int16 if is_bf16 else torch.int32
        repeatable = bool(torch.equal(got.view(as_int), again.view(as_int)))
        del again
        out = {}
        plain_ms = cuda_time_ms(lambda: out.__setitem__("ref", cin_layer_ref(xk, x0, w)),
                                reps=1 if bulk else 3)
        limits = K7_LIMITS[dtn]
        errs = _k7_errs(got, out["ref"])
        h_drop = Hk // 2
        xk_drop = xk.clone()
        xk_drop[:, h_drop] = 0
        faults = {f"h = {h_drop} dropped": _k7_errs(got, cin_layer_ref(xk_drop, x0, w))}
        del xk_drop
        emulation = None
        if not bulk:
            parts = cin_split_partials(xk, x0, w, splits=cut["splits"])
            emulation = _k7_errs(got, sum(parts[1:], parts[0]).to(dt))
            if len(parts) > 1:
                s_drop = len(parts) // 2
                kept = [p for i, p in enumerate(parts) if i != s_drop]
                faults[f"split {s_drop} of {len(parts)} dropped"] = \
                    _k7_errs(got, sum(kept[1:], kept[0]).to(dt))
            del parts
        for fault, fe in faults.items():
            if _within(fe, limits):
                raise SystemExit(f"chip_smoke: {name}: the limits {limits} do not see the "
                                 f"planted fault ({fault}): {fe}")
        if not repeatable:
            raise SystemExit(f"chip_smoke: {name}: two launches on the same inputs differ")
        w3 = w.view(Hk, m, Hn)
        z_bytes = B * Hk * m * D * 4
        if z_bytes < torch.cuda.mem_get_info()[0] // 4:
            lib_ms = cuda_time_ms(lambda: torch.einsum("bhd,bmd,hmn->bnd", xk, x0, w3), reps=10)
            library = "torch.einsum('bhd,bmd,hmn->bnd'), TF32 off, opt_einsum " + \
                ("on" if torch.backends.opt_einsum.enabled else "off")
        else:
            lib_ms = None
            library = (f"none: one torch.einsum forms the {z_bytes:,}-byte (B, Hk, m, D) "
                       "product, more than the card holds")
        bounds = k7_bounds(B, Hk, m, D, Hn, dtn, xk.element_size())
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/cin/csrc/cin.cu",
                     "replaces": "src/repro/kernels/cin/kernel.py:39",
                     "launches": recsys["launches"]["cin"],
                     "max_abs_err": errs["max_abs_err"],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bounds["bound_ms"],
                     "bound_by": bounds["bound_by"], "library_ms": lib_ms,
                     "shape": {"B": B, "Hk": Hk, "m": m, "H'": Hn, "D": D, "dtype": dtn,
                               "plan": cut, "errors": errs, "limits": limits,
                               "repeatable_bits": repeatable,
                               "emulation_errors": emulation,
                               "planted_faults": faults,
                               "flops": bounds["flops"], "tensor_flops": bounds["tensor_flops"],
                               "bytes": bounds["bytes"],
                               "bound_scalar_ms": bounds["bound_scalar_ms"],
                               "tflops_per_s": bounds["flops"] / ms / 1e9,
                               "tensor_tflops_per_s": bounds["tensor_flops"] / ms / 1e9,
                               "compiled": compiled,
                               "plain": "cin_layer_ref on the card, TF32 off",
                               "library": library,
                               "launches_on": "xDeepFM serving (phase recsys)"}})
        del x0, xk, w, got, out
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=20,
                    help="R-MAT scale of the main path (default 20)")
    ap.add_argument("--products-scale", type=float, default=1.0,
                    help="scale of the served ogbn_products_like graph (default 1.0)")
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
    results = {"device": dev, "build": build}
    main_run = phase_main(args.scale)
    compare = phase_compare(main_run)
    serve = phase_serve(args.products_scale)
    lm = phase_lm()
    recsys = phase_recsys()
    summary, all_rows = phase_kernels(main_run, compare, serve, lm, recsys, build)
    results.update(main=main_run["info"], compare=compare["rows"],
                   pagerank=compare["pagerank"], serve=serve["info"])
    del serve
    results["parity"] = phase_parity()
    results.update(lm=lm["info"], lm_f32_check=lm["f32_check"], recsys=recsys["info"],
                   kernels=all_rows, total_s=time.perf_counter() - t_start)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(results, f, indent=1)
    emit({"kernels": [{k: v for k, v in r.items() if k != "shape"} for r in summary]})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
