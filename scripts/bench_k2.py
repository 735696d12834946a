#!/usr/bin/env python3
"""Time K2 (the Alg. 3 placement) on one GPU where the main path meets it,
with its bounds, and in turns with another K2 source.

    python3 scripts/bench_k2.py
    python3 scripts/bench_k2.py --baseline build/parent/stream_scan.cu --phases

Runs ``chip_smoke.py``'s phase ``main`` (S5P on the Graph500 R-MAT at
``--scale`` 20, k = 32, on the card) and takes K2's cases from
``chip_smoke.k2_cases``: the main path's 65,536-edge chunks 0, 120 and
239 with the loads before each, 4,096 edges onto the final loads, a chunk
with no room, a chunk under the wrap guard, the last chunk's retract and
4,096 edges at k = 8 and 256.  The chunks before each are replayed through
this script's build of this checkout's ``stream_scan.cu``, which must end
at the main run's loads.  Each case is timed by CUDA events over
``--reps`` launches with the loads reset before every launch.

Each ``--baseline`` (repeatable) is another ``stream_scan.cu`` with the
same C entry point ``assign_scan_launch``, built with the port's nvcc flags
and timed on the same inputs in turns (baseline, new, new, baseline); its
outputs must equal the new kernel's bit for bit, or the script exits
non-zero after the last row.  Without a baseline the new kernel is timed
twice.  ``--phases`` builds the source again with ``-DK2_PHASES``, in which
the kernel adds ``clock64`` spans of each tile's stage (a producer thread),
fold (thread 0) and write-back (a producer thread) into a device array, and
counts the edges folded in each mode (room, full, wrap); it prints their
cycles an edge for every insert case.

Each row also states the overflow edges (placed with both endpoint
partitions full) and the edges of each mode from ``ref.assign_chunk_planned``
on the host, the latency bound of the chain (``latency.py``) and the bytes
bound.  One JSON line per row; last, the card's name and power limit.
``--out`` keeps every line in a file too.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_P, _I = ctypes.c_void_p, ctypes.c_int
_LINES: list[dict] = []


def _emit(obj) -> None:
    _LINES.append(obj)
    print(json.dumps(obj), flush=True)


def _build_lib(src: str, tag: str, extra=()):
    """Build a kernel source with the port's nvcc flags (and ``extra``)."""
    from repro_torch.kernels import _build

    out = os.path.join(str(_build.BUILD_DIR), f"lib{tag}.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *extra, "-o", out, src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"bench_k2: {src} does not build:\n{proc.stderr}")
    return ctypes.CDLL(out), proc.stdout + proc.stderr


def _launcher(lib):
    """(load, case, out) -> None: one K2 launch on the current stream, the
    case's sign, cap, recorded parts and n_valid."""
    import torch

    from repro_torch.kernels import _build

    lib.assign_scan_launch.argtypes = [_P] * 6 + [_I] * 5 + [_P] * 3
    lib.assign_scan_launch.restype = _I

    def run(load, c, out):
        E = int(c["src"].numel())
        if "head_i32" not in c:
            c["head_i32"] = c["head"].to(torch.int32).contiguous()
            c["pin"] = (c["parts"] if c.get("parts") is not None else
                        torch.full((E,), -1, dtype=torch.int32, device="cuda"))
        sign = c.get("sign", 1)
        limit = E if sign > 0 else int(c["n_valid"])
        _build.check(lib.assign_scan_launch(
            c["src"].data_ptr(), c["dst"].data_ptr(), c["head_i32"].data_ptr(),
            c["pcu"].data_ptr(), c["pcv"].data_ptr(), c["pin"].data_ptr(), E, limit,
            sign, int(c["cap"]), int(load.numel()), load.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "K2")
    return run


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


def _turns(new, bases: dict, reset, reps: int) -> dict:
    """For each baseline: baseline, new, new, baseline (new twice without
    one).  ``ms`` holds the new kernel's times, ``baseline_ms`` each
    baseline's, by source."""
    if not bases:
        return {"ms": [_time(new, reset, reps), _time(new, reset, reps)]}
    ms, base_ms = [], {}
    for path, base in bases.items():
        b1 = _time(base, reset, reps)
        ms += [_time(new, reset, reps), _time(new, reset, reps)]
        base_ms[path] = [b1, _time(base, reset, reps)]
    return {"ms": ms, "baseline_ms": base_ms}


def _phases(lib, run, reset) -> dict:
    """One launch of the ``-DK2_PHASES`` build: cycles an edge of the stage,
    fold and write-back, and the edges of each mode."""
    import torch

    lib.k2_phase_read.argtypes = [_P]
    lib.k2_phase_reset()
    reset()
    run()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 7)()
    lib.k2_phase_read(ctypes.byref(buf))
    cyc = list(buf)
    return {**{f"{p}_cycles_per_edge": cyc[i] / cyc[3]
               for i, p in enumerate(("stage", "fold", "write_back"))},
            "edges": cyc[3], "room_edges": cyc[4], "full_edges": cyc[5], "wrap_edges": cyc[6]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--baseline", action="append", default=[],
                    help="another stream_scan.cu, timed in turns (repeatable)")
    ap.add_argument("--phases", action="store_true",
                    help="also time each tile's stage, fold and write-back (clock64)")
    ap.add_argument("--out", default=None,
                    help="also write every line here (default: bench_k2.jsonl in "
                         "chip_smoke.py's output directory)")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_k2: no CUDA device")
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.stream_scan.latency import measure_round_trips
    from repro_torch.kernels.stream_scan.ref import assign_chunk_planned

    source = str(_build.SOURCES["stream_scan"])
    new_lib, log = _build_lib(source, "k2_new")
    _emit({"build": "new", "source": source, "ptxas": log.splitlines()[-12:]})
    new = _launcher(new_lib)
    bases = {}
    for i, path in enumerate(args.baseline):
        base_lib, log = _build_lib(path, f"k2_base{i}")
        bases[path] = _launcher(base_lib)
        _emit({"build": "baseline", "source": path, "ptxas": log.splitlines()[-12:]})
    phase_lib = phase_run = None
    if args.phases:
        phase_lib, _ = _build_lib(source, "k2_phases", ["-DK2_PHASES"])
        phase_run = _launcher(phase_lib)
    rt = measure_round_trips()
    _emit({"probe": rt, "clocks_sm_mhz": cs.nvidia_smi_line("clocks.sm")})
    main_run = cs.phase_main(args.scale)

    def step(load, x):
        x = {**x, "cap": main_run["out"].max_load}
        out = torch.empty_like(x["src"])
        new(load, x, out)
        return out, load

    for c in cs.k2_cases(main_run, step):
        E = int(c["src"].numel())
        load = c["load"].clone()
        out = torch.empty(E, dtype=torch.int32, device="cuda")

        def reset(load=load, c=c):
            load.copy_(c["load"])

        row = {"kernel": "K2", "case": c["name"], "k": c["k"], "edges": E, "cap": c["cap"],
               "sign": c["sign"], "state": c["state"], "chunk_index": c["chunk_index"],
               **_turns(lambda: new(load, c, out),
                        {p: (lambda b=b: b(load, c, out)) for p, b in bases.items()},
                        reset, args.reps)}
        bounds = cs.k2_bounds(c, rt)
        row.update(bound_ms=bounds["bound_ms"], bound_by=bounds["bound_by"],
                   latency_bound_ms=bounds["latency_bound_ms"])
        if c["sign"] > 0:
            stats = {}
            cpu = [c[f].cpu() for f in ("src", "dst", "head", "pcu", "pcv")]
            assign_chunk_planned(c["load"].cpu(), *cpu, max_load=c["cap"], stats=stats)
            row.update(overflow_edges=stats["overflow"],
                       mode_edges={m: stats[m] for m in ("room", "full", "wrap")})
        if bases:
            outs = []
            for fn in (new, *bases.values()):
                reset()
                fn(load, c, out)
                torch.cuda.synchronize()
                outs.append((out.clone(), load.clone()))
            row["bitwise_equal_to_baseline"] = all(
                torch.equal(a, b) for o in outs[1:] for a, b in zip(outs[0], o))
        if phase_run is not None and c["sign"] > 0:
            row["phases"] = _phases(phase_lib, lambda: phase_run(load, c, out), reset)
        _emit(row)
    smi = cs.nvidia_smi_line()
    differ = [r["case"] for r in _LINES if r.get("bitwise_equal_to_baseline") is False]
    out_path = args.out or os.path.join(cs.OUT_DIR, "bench_k2.jsonl")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        for line in _LINES:
            f.write(json.dumps(line) + "\n")
        f.write(json.dumps({"nvidia_smi": smi}) + "\n")
    print(smi)
    if differ:
        raise SystemExit(f"bench_k2: a baseline's bits differ from the new kernel's: {differ}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
