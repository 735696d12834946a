#!/usr/bin/env python3
"""Time K1 (the Alg. 1 fold) and K3 (the Greedy/HDRF scan) on one GPU at the
main path's shapes, with their latency bounds.

    python3 scripts/bench_k1k3.py
    python3 scripts/bench_k1k3.py --baseline build/parent/stream_scan.cu \\
        --baseline build/parent/scoring_scan.cu

Builds the Graph500 R-MAT of ``chip_smoke.py`` (``--scale`` 20, edge factor
16, a = 0.57, b = c = 0.19, seed 0), then the states the kernels meet on
the main path, by running this checkout's kernels chunk by chunk (65,536
edges, the last chunk padded with (0, 0) as ``EdgeStream`` pads it): K1
under S5P's ξ and κ (and 2PS-L's ξ = -1, all head; CLUGP's ξ, all tail;
S5P-B's global tail at κ = 2^31 - 1), Greedy's and HDRF's carries at
``--k``; each empty, after
half the chunks ("mid") and after all of them ("final").  Each row folds
the first 4,096 or all 65,536 edges of the next chunk (the first chunk
again from "final") from one state, timed by CUDA events with the state
reset before every launch.

Each ``--baseline`` is another ``stream_scan.cu`` (K1) or
``scoring_scan.cu`` (K3), with this checkout's C entry point or the one
before the staged tiles (no ``V`` and ``tile`` arguments).  It is built
with the port's nvcc flags and timed on the same inputs in turns
(baseline, new, new, baseline); its outputs must equal the new kernel's
bit for bit.  Without a baseline the new kernel is timed twice.

It also runs the probes behind the latency bound (a pointer chase through
shared memory, a chain of ``__shfl_sync``, a chain of ``redux.sync``;
``kernels/stream_scan/latency.py``) and states each row's bound: edges ×
the chain's dependent steps × the measured round trips.  With
``--phases`` it builds copies of both sources in which thread 0 adds
``clock64`` spans of each tile's stage, fold and write-back into a device
array, and prints their cycles an edge for chunk 0 and the middle chunk of
the stream (K1 under S5P and CLUGP, K3 in both modes at ``--k``).  One
JSON line per row; last, the card's name and power limit.  ``--out`` keeps
every line in a file too.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 1 << 16
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LINES: list[dict] = []


def _emit(obj) -> None:
    _LINES.append(obj)
    print(json.dumps(obj), flush=True)


def _smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def _build_lib(src: str, tag: str):
    """Build a kernel source with the port's nvcc flags."""
    from repro_torch.kernels import _build

    out = os.path.join(str(_build.BUILD_DIR), f"lib{tag}.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"bench_k1k3: {src} does not build:\n{proc.stderr}")
    return ctypes.CDLL(out), proc.stdout + proc.stderr


def _k1_launcher(lib):
    """(state, src, dst, deg, xi, kappa, gt) -> None on the current stream,
    for either C entry point of K1."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.stream_scan.plan import K1_TILE

    staged = hasattr(lib, "cluster_smem_bytes")
    lib.cluster_scan_launch.restype = _I
    lib.cluster_scan_launch.argtypes = (
        [_P, _P, _I, _I, _P, _I] + [_P] * 10 + [_I] * 4 + [_P] if staged
        else [_P, _P, _I, _I, _P] + [_P] * 10 + [_I] * 3 + [_P])

    def run(state, src, dst, deg, xi, kappa, gt):
        E, V = int(src.numel()), int(deg.numel())
        head = [src.data_ptr(), dst.data_ptr(), E, E, deg.data_ptr()]
        if staged:
            head.append(V)
        tail = [int(xi), int(kappa), int(gt)] + ([K1_TILE] if staged else [])
        _build.check(lib.cluster_scan_launch(
            *head, *(t.data_ptr() for t in state), *tail,
            torch.cuda.current_stream().cuda_stream), "K1")
    return run


def _k3_launcher(lib):
    """(src, dst, load, rep, pd, parts_in, n_valid, sign, hdrf, k, parts_out)
    -> None, for either C entry point of K3 (the new one at its plan)."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.stream_scan.plan import scoring_plan

    staged = hasattr(lib, "scoring_smem_bytes")
    lib.scoring_scan_launch.restype = _I
    lib.scoring_scan_launch.argtypes = ([_P] * 3 + [_I] * 6 + [_F, _F] + [_P] * 4
                                       + ([_I] if staged else []) + [_P])

    def run(src, dst, load, rep, pd, parts_in, n_valid, sign, hdrf, out):
        E, k = int(src.numel()), int(rep.shape[1])
        plan = scoring_plan(k)
        extra = [plan.tile if plan.rung == "shared" else 0] if staged else []
        _build.check(lib.scoring_scan_launch(
            src.data_ptr(), dst.data_ptr(), None if sign > 0 else parts_in.data_ptr(),
            E, E if sign > 0 else int(n_valid), int(sign), int(hdrf), k, k,
            1.1 if hdrf and sign > 0 else 0.0, 1e-3, load.data_ptr(), rep.data_ptr(),
            pd.data_ptr() if hdrf else None, out.data_ptr(), *extra,
            torch.cuda.current_stream().cuda_stream), "K3")
    return run


def _chunk(src_t, dst_t, c: int):
    """Chunk ``c`` of the stream, padded with (0, 0) to CHUNK edges."""
    import torch

    s, d = src_t[c * CHUNK:(c + 1) * CHUNK], dst_t[c * CHUNK:(c + 1) * CHUNK]
    pad = CHUNK - int(s.numel())
    if pad:
        z = torch.zeros(pad, dtype=torch.int32, device=s.device)
        s, d = torch.cat([s, z]), torch.cat([d, z])
    return s.contiguous(), d.contiguous()


def _time(fn, reset, reps: int) -> float:
    import torch

    reset()
    fn()
    total = 0.0
    for _ in range(reps):
        reset()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def _turns(new, base, reset, reps: int) -> dict:
    """baseline, new, new, baseline (new twice without a baseline)."""
    if base is None:
        return {"ms": [_time(new, reset, reps), _time(new, reset, reps)]}
    b1 = _time(base, reset, reps)
    n1, n2 = _time(new, reset, reps), _time(new, reset, reps)
    return {"ms": [n1, n2], "baseline_ms": [b1, _time(base, reset, reps)]}


def _same(run_a, run_b, reset, outs) -> bool:
    """Whether two kernels leave the same bits in ``outs`` from one state."""
    import torch

    reset()
    run_a()
    first = [t.clone() for t in outs]
    reset()
    run_b()
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(first, outs))


# (anchor, text put before it) in each source: the spans of a tile's stage,
# fold and write-back, added by thread 0 into g_phase[0..2], edges in [3]
_PHASE_DECL = "__device__ unsigned long long g_phase[4];\n"
_PHASE_READ = """
extern "C" int phase_read(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
}
extern "C" int phase_reset() {
  unsigned long long z[4] = {0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(z));
}
"""
_PHASE_ADD = ("    if (threadIdx.x == 0) { g_phase[0] += t_b - t_a; g_phase[1] += t_c - t_b; "
              "g_phase[2] += clock64() - t_c; g_phase[3] += cnt; }\n")
_PHASE_MARKS = {
    "stream_scan": [
        ("    for (int j = me; j < H; j += nthr) {\n      vkey[j] = -1;",
         "    const long long t_a = clock64();\n"),
        ("    // 6. the fold, one thread, in edge order\n", "    const long long t_b = clock64();\n"),
        ("    // 7. write back, slots turned into ids", "    const long long t_c = clock64();\n"),
        ("  }\n  if (me == 0) {\n    *s.nexth = sc[5];", _PHASE_ADD)],
    "scoring_scan": [
        ("    for (int j = me; j < H; j += kStagedThreads) vkey[j] = -1;",
         "    const long long t_a = clock64();\n"),
        ("    if (warp == 0) {\n      if (k <= 32) {", "    const long long t_b = clock64();\n"),
        ("    copy_rows<false>(", "    const long long t_c = clock64();\n"),
        ("  }\n  for (int j = me; j < k; j += kStagedThreads) load[j] = s_load[j];\n}\n\n"
         "// G1", _PHASE_ADD)],
}


def _phase_source(name: str, out_dir: str) -> str:
    """A copy of ``name``'s source with the phase spans put in."""
    from repro_torch.kernels import _build

    text = _build.SOURCES[name].read_text()
    text = text.replace("namespace {\n", "namespace {\n" + _PHASE_DECL, 1)
    for anchor, put in _PHASE_MARKS[name]:
        if text.count(anchor) != 1:
            raise SystemExit(f"bench_k1k3: {name}: the phase anchor {anchor!r} is not unique")
        text = text.replace(anchor, put + anchor)
    path = os.path.join(out_dir, f"{name}_phases.cu")
    with open(path, "w") as f:
        f.write(text + _PHASE_READ)
    return path


def bench_phases(g) -> None:
    """Cycles an edge of each tile's stage, fold and write-back."""
    import torch

    from repro_torch.core.clustering import compute_degrees, init_state
    from repro_torch.kernels import _build

    libs = {}
    for name in ("stream_scan", "scoring_scan"):
        lib, _ = _build_lib(_phase_source(name, str(_build.BUILD_DIR)), f"{name}_phases")
        lib.phase_read.argtypes = [_P]
        libs[name] = lib
    src_t, dst_t, n, n_chunks, E_all, k = g["src"], g["dst"], g["n"], g["chunks"], g["E"], g["k"]
    probe_at = (0, n_chunks // 2)

    def phases(lib, what, c):
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 4)()
        lib.phase_read(ctypes.byref(buf))
        cyc = list(buf)
        _emit({"phases": what, "chunk": c, "edges": cyc[3],
               **{f"{p}_cycles_per_edge": cyc[i] / cyc[3]
                  for i, p in enumerate(("stage", "fold", "write_back"))}})

    deg = compute_degrees(src_t, dst_t, n)
    xi = int(2.0 * E_all / n)
    kappa = max(int(math.ceil(2.0 * E_all / k)), 2)
    k1 = _k1_launcher(libs["stream_scan"])
    for name, x in (("K1 s5p", xi), ("K1 clugp xi=2^31-2", 2**31 - 2)):
        state = tuple(init_state(n, "cuda"))
        for c in range(n_chunks):
            if c in probe_at:
                libs["stream_scan"].phase_reset()
            k1(state, *_chunk(src_t, dst_t, c), deg, x, kappa, False)
            if c in probe_at:
                phases(libs["stream_scan"], name, c)
    k3 = _k3_launcher(libs["scoring_scan"])
    out = torch.empty(CHUNK, dtype=torch.int32, device="cuda")
    for mode in ("greedy", "hdrf"):
        hdrf = mode == "hdrf"
        state = [torch.zeros(k, dtype=torch.int32, device="cuda"),
                 torch.zeros((n, k), dtype=torch.int32, device="cuda"),
                 torch.zeros(n, dtype=torch.int32, device="cuda") if hdrf else None]
        for c in range(n_chunks):
            if c in probe_at:
                libs["scoring_scan"].phase_reset()
            k3(*_chunk(src_t, dst_t, c), *state, None, None, 1, hdrf, out)
            if c in probe_at:
                phases(libs["scoring_scan"], f"K3 {mode} k={k}", c)


def bench_k1(g, rt, base, reps: int) -> None:
    import torch

    from repro_torch.core.clustering import compute_degrees, init_state
    from repro_torch.kernels.stream_scan.latency import latency_bound_ms

    src_t, dst_t, n, n_chunks, E_all, k = g["src"], g["dst"], g["n"], g["chunks"], g["E"], g["k"]
    deg = compute_degrees(src_t, dst_t, n)
    xi = int(2.0 * E_all / n)
    kappa = max(int(math.ceil(2.0 * E_all / k)), 2)
    variants = {"s5p": (xi, kappa, False), "2ps-l xi=-1": (-1, kappa, False),
                "clugp xi=2^31-2": (2**31 - 2, kappa, False),
                "s5p-b kappa=2^31-1": (xi, 2**31 - 1, True)}
    new = g["k1_new"]
    for name, (x, kap, gt) in variants.items():
        state = tuple(init_state(n, "cuda"))
        snaps = {"empty": tuple(t.clone() for t in state)}
        for c in range(n_chunks):
            s, d = _chunk(src_t, dst_t, c)
            new(state, s, d, deg, x, kap, gt)
            if c + 1 == n_chunks // 2:
                snaps["mid"] = tuple(t.clone() for t in state)
        snaps["final"] = state
        torch.cuda.synchronize()
        states = ("empty", "mid", "final") if name == "s5p" else ("mid",)
        for st in states:
            c = n_chunks // 2 if st == "mid" else 0
            s_full, d_full = _chunk(src_t, dst_t, c)
            for E in (4096, CHUNK):
                s, d = s_full[:E].contiguous(), d_full[:E].contiguous()
                work = tuple(t.clone() for t in snaps[st])

                def reset(work=work, st=st):
                    for w, t in zip(work, snaps[st]):
                        w.copy_(t)

                run_new = (lambda work=work, s=s, d=d: new(work, s, d, deg, x, kap, gt))
                run_base = (None if base is None else
                            (lambda work=work, s=s, d=d: base(work, s, d, deg, x, kap, gt)))
                row = {"kernel": "K1", "variant": name, "state": st, "edges": E,
                       "V": n, "xi": x, "kappa": kap, "global_tail": gt,
                       **_turns(run_new, run_base, reset, reps),
                       "latency_bound_ms": latency_bound_ms("K1", E, rt)}
                reset()
                before = int(work[5])
                run_new()
                row["new_head_ids"] = int(work[5]) - before
                if run_base is not None:
                    row["bitwise_equal_to_baseline"] = _same(run_new, run_base, reset, work)
                _emit(row)


def _scoring_states(g, mode: str):
    """Empty, mid and final (load, rep[, pd]) of a ``mode`` run over the
    stream at k, built chunk by chunk with this checkout's K3."""
    import torch

    n, k = g["n"], g["k"]
    hdrf = mode == "hdrf"
    state = [torch.zeros(k, dtype=torch.int32, device="cuda"),
             torch.zeros((n, k), dtype=torch.int32, device="cuda")]
    state.append(torch.zeros(n, dtype=torch.int32, device="cuda") if hdrf else None)
    snaps = {"empty": [t.clone() if t is not None else None for t in state]}
    out = torch.empty(CHUNK, dtype=torch.int32, device="cuda")
    for c in range(g["chunks"]):
        s, d = _chunk(g["src"], g["dst"], c)
        g["k3_new"](s, d, *state, None, None, 1, hdrf, out)
        if c + 1 == g["chunks"] // 2:
            snaps["mid"] = [t.clone() if t is not None else None for t in state]
    snaps["final"] = state
    torch.cuda.synchronize()
    return snaps


def bench_k3(g, rt, base, reps: int) -> None:
    import torch

    from repro_torch.kernels.stream_scan.latency import latency_bound_ms
    from repro_torch.kernels.stream_scan.plan import scoring_plan

    new = g["k3_new"]
    plan = scoring_plan(g["k"])
    for mode in ("greedy", "hdrf"):
        hdrf = mode == "hdrf"
        snaps = _scoring_states(g, mode)
        for st in ("empty", "mid", "final"):
            c = g["chunks"] // 2 if st == "mid" else 0
            s_full, d_full = _chunk(g["src"], g["dst"], c)
            for E in (4096, CHUNK):
                s, d = s_full[:E].contiguous(), d_full[:E].contiguous()
                signs = (1, -1) if hdrf and st == "final" else (1,)
                for sign in signs:
                    start = snaps[st]
                    parts_in = None
                    if sign < 0:  # retract what an insert of these edges placed
                        start = [t.clone() for t in snaps[st]]
                        parts_in = torch.empty(E, dtype=torch.int32, device="cuda")
                        new(s, d, *start, None, None, 1, hdrf, parts_in)
                    work = [t.clone() if t is not None else None for t in start]
                    out = torch.empty(E, dtype=torch.int32, device="cuda")

                    def reset(work=work, start=start):
                        for w, t in zip(work, start):
                            if w is not None:
                                w.copy_(t)

                    def call(fn, work=work, s=s, d=d, parts_in=parts_in, sign=sign, out=out):
                        return lambda: fn(s, d, *work, parts_in, E, sign, hdrf, out)

                    chain = "K3 retract" if sign < 0 else f"K3 {mode}"
                    row = {"kernel": "K3", "mode": mode, "sign": sign, "state": st,
                           "edges": E, "V": g["n"], "k": g["k"], "rung": plan.rung,
                           "tile": plan.tile,
                           **_turns(call(new), None if base is None else call(base),
                                    reset, reps),
                           "latency_bound_ms": latency_bound_ms(chain, E, rt)}
                    if base is not None:
                        outs = [out, *(t for t in work if t is not None)]
                        row["bitwise_equal_to_baseline"] = _same(call(new), call(base),
                                                                 reset, outs)
                    _emit(row)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--baseline", action="append", default=[],
                    help="another stream_scan.cu (K1) or scoring_scan.cu (K3)")
    ap.add_argument("--phases", action="store_true",
                    help="also time each tile's stage, fold and write-back (clock64)")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "bench_k1k3.jsonl"))
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_k1k3: no CUDA device")
    from repro_torch.graphs import rmat_graph
    from repro_torch.kernels import _build
    from repro_torch.kernels.stream_scan.latency import measure_round_trips

    new_k1, log1 = _build_lib(str(_build.SOURCES["stream_scan"]), "k1k3_new_k1")
    new_k3, log3 = _build_lib(str(_build.SOURCES["scoring_scan"]), "k1k3_new_k3")
    _emit({"build": "new", "ptxas_stream_scan": log1.splitlines()[-12:],
           "ptxas_scoring_scan": log3.splitlines()[-20:]})
    base_k1 = base_k3 = None
    for i, path in enumerate(args.baseline):
        lib, log = _build_lib(path, f"k1k3_base{i}")
        if hasattr(lib, "cluster_scan_launch"):
            base_k1 = _k1_launcher(lib)
        if hasattr(lib, "scoring_scan_launch"):
            base_k3 = _k3_launcher(lib)
        _emit({"build": "baseline", "source": path})
    rt = measure_round_trips()
    _emit({"probe": rt, "clocks_sm_mhz": _smi("clocks.sm")})
    src, dst, n = rmat_graph(args.scale, edge_factor=16, a=0.57, b=0.19, c=0.19, seed=0)
    E = int(src.size)
    g = {"src": torch.from_numpy(src).cuda(), "dst": torch.from_numpy(dst).cuda(), "n": n,
         "E": E, "k": args.k, "chunks": math.ceil(E / CHUNK),
         "k1_new": _k1_launcher(new_k1), "k3_new": _k3_launcher(new_k3)}
    if args.phases:
        bench_phases(g)
    bench_k1(g, rt, base_k1, args.reps)
    bench_k3(g, rt, base_k3, args.reps)
    smi = _smi("name,power.limit")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        for line in _LINES:
            f.write(json.dumps(line) + "\n")
        f.write(json.dumps({"nvidia_smi": smi}) + "\n")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
