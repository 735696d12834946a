#!/usr/bin/env python3
"""Time K4a/K4b (the count-min sketch update and query) on one GPU where
the main path meets them, with their floors, and in turns with another K4.

    python3 scripts/bench_k4.py
    python3 scripts/bench_k4.py --baseline build/parent/cms_sketch.cu --sweep

Runs ``chip_smoke.py``'s phase ``main`` (S5P on the Graph500 R-MAT at
``--scale`` 20, k = 32, on the card) and, unless ``--no-serve``, S5P on
``ogbn_products_like(seed=0)`` at ``--products-scale`` 1.0, and replays
each run's Θ stream from its own clusters (``chip_smoke.theta_capture``,
which must end at the run's sketch).  The cases: the first, the middle and
the last 2^18-key chunk of each stream, each onto the table it found; a
hot-key chunk (one key 2^18 times); K4b at each run's real pair count P on
its final sketch.

Each case is timed by CUDA events over ``--reps`` calls, two ways: the
kernel alone (its C entry point called on ready operands; K4a onto a
scratch copy of the table, reset before every call) and the whole call
(``core.cms.cms_update``, ``core.cms.cms_query``).
Each ``--baseline`` (repeatable) is an older ``cms_sketch.cu`` with the C
entry points of the first K4 (uint32 keys, counts and seeds; the update
returns the batch's own table), built with the port's nvcc flags and timed
in turns (baseline, new, new, baseline), its whole call as that K4's
wrapper made it (three conversions to uint32, a zeroed table, the launch,
the wrapping add into the sketch); its bits must equal the new kernel's,
or the script exits non-zero after the last row.  Each call's device
operations are counted by ``torch.profiler`` where it traces the card.
Each ``--variant`` (repeatable) is another ``cms_sketch.cu`` with this
K4's C entry points (a design tried beside it), timed in turns the same
way, kernel alone, its bits held to the new kernel's.  ``--sweep`` times
the new K4a at several key slices a table row on the main run's chunks.
The floors: an empty launch and d × keys global atomic adds at the card's
rate (``latency.measure_launch_floor``), beside the bytes bound.  One JSON line per row; last, the card's name and power limit.
``--out`` keeps every line in a file too (default ``bench_k4.jsonl`` in
``chip_smoke.py``'s output directory).
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
M32 = 0xFFFFFFFF


def _emit(obj) -> None:
    _LINES.append(obj)
    print(json.dumps(obj), flush=True)


def _build_lib(src: str, tag: str, api: str = "old"):
    from repro_torch.kernels import _build

    out = os.path.join(str(_build.BUILD_DIR), f"lib{tag}.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"bench_k4: {src} does not build:\n{proc.stderr}")
    lib = ctypes.CDLL(out)
    n = ctypes.c_longlong if api == "new" else _I
    upd = [_P, _P, _P, n, _I, _I, _P] + ([_I] if api == "new" else []) + [_P]
    lib.cms_update_launch.argtypes = upd
    lib.cms_update_launch.restype = _I
    lib.cms_query_launch.argtypes = [_P, _P, _P, n, _I, _I, _P, _P]
    lib.cms_query_launch.restype = _I
    return lib, proc.stdout + proc.stderr


class _Variant:
    """A source with this K4's C entry points (int64 operands, K4a into the
    handed table), called directly."""

    def __init__(self, lib):
        self.lib = lib

    def add(self, table, keys, counts, seeds, blocks_per_row=0):
        import torch

        from repro_torch.kernels import _build

        d, w = table.shape
        _build.check(self.lib.cms_update_launch(
            keys.data_ptr(), counts.data_ptr(), seeds.data_ptr(), int(keys.numel()), d, w,
            table.data_ptr(), blocks_per_row, torch.cuda.current_stream().cuda_stream), "K4a")

    def query(self, table, keys, seeds, out):
        import torch

        from repro_torch.kernels import _build

        d, w = table.shape
        _build.check(self.lib.cms_query_launch(
            keys.data_ptr(), seeds.data_ptr(), table.data_ptr(), int(keys.numel()), d, w,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream), "K4b")


def _u32(x):
    """The first K4's conversion: int64 (any sign) → int32 bit pattern."""
    import torch

    x = x.to(torch.int64) & M32
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32).contiguous()


class _Old:
    """An older K4 (uint32 operands; the update returns the batch's table)
    and the wrapper that the first K4 had around it."""

    def __init__(self, lib):
        self.lib = lib

    def update(self, k32, c32, s32, out):
        import torch

        from repro_torch.kernels import _build

        d, w = out.shape
        _build.check(self.lib.cms_update_launch(
            k32.data_ptr(), c32.data_ptr(), s32.data_ptr(), int(k32.numel()), d, w,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream), "old K4a")

    def query(self, k32, s32, table, out):
        import torch

        from repro_torch.kernels import _build

        d, w = table.shape
        _build.check(self.lib.cms_query_launch(
            k32.data_ptr(), s32.data_ptr(), table.data_ptr(), int(k32.numel()), d, w,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream), "old K4b")

    def update_call(self, table, keys, counts, seeds):
        import torch

        delta = torch.zeros_like(table)
        self.update(_u32(keys), _u32(counts), _u32(seeds), delta)
        return _u32(table.to(torch.int64) + delta.to(torch.int64))

    def query_call(self, table, keys, seeds):
        import torch

        out = torch.empty(keys.numel(), dtype=torch.int32, device=keys.device)
        self.query(_u32(keys), _u32(seeds), table.contiguous(), out)
        return out.to(torch.int64) & M32


def _device_ops(fn) -> int | None:
    """Device kernels and copies of one call, by ``torch.profiler`` (None
    where it records no device activity)."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    return n or None


def _turns(cs, new, olds: dict, setup, reps: int) -> dict:
    """For each baseline: baseline, new, new, baseline (new twice without one)."""
    t = lambda fn: cs.cuda_time_ms(fn, reps=reps, setup=setup)  # noqa: E731
    if not olds:
        return {"ms": [t(new), t(new)]}
    ms, old_ms = [], {}
    for path, old in olds.items():
        first = t(old)
        ms += [t(new), t(new)]
        old_ms[path] = [first, t(old)]
    return {"ms": ms, "baseline_ms": old_ms}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--products-scale", type=float, default=1.0)
    ap.add_argument("--no-serve", action="store_true", help="leave out the served graph")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--baseline", action="append", default=[],
                    help="an older cms_sketch.cu, timed in turns (repeatable)")
    ap.add_argument("--variant", action="append", default=[],
                    help="another cms_sketch.cu with this K4's entry points, in turns (repeatable)")
    ap.add_argument("--sweep", action="store_true",
                    help="also time K4a at several key slices a row (main run's chunks)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_k4: no CUDA device")
    import chip_smoke as cs
    from repro_torch.core.cms import CMSketch, cms_query, cms_update
    from repro_torch.core.s5p import S5PConfig, s5p_partition
    from repro_torch.graphs import ogbn_products_like
    from repro_torch.kernels import _build
    from repro_torch.kernels.cms_sketch import kernel as cms_k
    from repro_torch.kernels.cms_sketch.kernel import default_blocks_per_row
    from repro_torch.kernels.stream_scan.latency import measure_launch_floor

    build = _build.build_all()
    raw = _Variant(cms_k._lib())
    _emit({"build": "new", "ptxas": cs.ptxas_kernels(build["logs"].get("cms_sketch", ""))})
    olds = {}
    for i, path in enumerate(args.baseline):
        lib, log = _build_lib(path, f"k4_base{i}")
        olds[path] = _Old(lib)
        _emit({"build": "baseline", "source": path, "ptxas": cs.ptxas_kernels(log)})
    variants = {}
    for i, path in enumerate(args.variant):
        lib, log = _build_lib(path, f"k4_variant{i}", api="new")
        variants[path] = _Variant(lib)
        _emit({"build": "variant", "source": path, "ptxas": cs.ptxas_kernels(log)})

    main_run = cs.phase_main(args.scale)
    runs = [("main", cs.theta_capture(main_run["src"], main_run["dst"], main_run["out"],
                                      main_run["cfg"]), main_run["out"])]
    del main_run
    if not args.no_serve:
        g = ogbn_products_like(seed=0, scale=args.products_scale)
        out = s5p_partition(g.src, g.dst, g.n_vertices, S5PConfig(k=32), device="cuda")
        runs.append(("serve", cs.theta_capture(g.src, g.dst, out, S5PConfig(k=32)), out))
        del g
    bad = []
    for run, theta, _ in runs:
        _emit({"stream": run, "n_chunks": theta["n_chunks"], "pairs": theta["pairs_streamed"],
               "ends_at_run_sketch": theta["ends_at_run_sketch"]})
        if not theta["ends_at_run_sketch"]:
            bad.append(f"{run}: the replay does not end at the run's sketch")
    seeds, d, w = runs[0][1]["seeds"], runs[0][1]["depth"], runs[0][1]["width"]
    floor = measure_launch_floor(d * w)
    _emit({"floor": floor, "clocks_sm_mhz": cs.nvidia_smi_line("clocks.sm")})

    cases = []
    for run, theta, _ in runs:
        for i, c in sorted(theta["chunks"].items()):
            cases.append((f"{run} chunk {i} of {theta['n_chunks']}", c["keys"], c["counts"],
                          c["table"], theta["seeds"]))
    mid = runs[0][1]["chunks"][runs[0][1]["n_chunks"] // 2]
    hot = torch.full_like(mid["keys"], int(mid["keys"][0]))
    cases.append(("hot key, 2^18 times", hot, torch.ones_like(hot), mid["table"], seeds))

    for name, keys, counts, table0, sd in cases:
        n = int(keys.numel())
        scratch = table0.clone()
        delta = torch.zeros_like(table0)
        k32, c32, s32 = _u32(keys), _u32(counts), _u32(sd)
        sketch = CMSketch(table=table0, seeds=sd)
        kernel = _turns(cs, lambda: raw.add(scratch, keys, counts, sd),
                        {p: (lambda o=o: o.update(k32, c32, s32, delta)) for p, o in olds.items()},
                        lambda: (scratch.copy_(table0), delta.zero_()), args.reps)
        call = _turns(cs, lambda: cms_update(sketch, keys, counts),
                      {p: (lambda o=o: o.update_call(table0, keys, counts, sd))
                       for p, o in olds.items()}, None, args.reps)
        want = cms_update(sketch, keys, counts).table
        vscratch = table0.clone()
        for p, v in variants.items():
            vscratch.copy_(table0)
            v.add(vscratch, keys, counts, sd)
            if not torch.equal(vscratch, want):
                bad.append(f"{name}: variant {p}")
        vkernel = _turns(cs, lambda: raw.add(scratch, keys, counts, sd),
                         {p: (lambda v=v: v.add(vscratch, keys, counts, sd))
                          for p, v in variants.items()},
                         lambda: (scratch.copy_(table0), vscratch.copy_(table0)),
                         args.reps) if variants else None
        row = {"kernel": "K4a", "case": name, "keys": n, "depth": d, "width": w,
               "blocks_per_row": default_blocks_per_row(n, d, w),
               "kernel_ms": kernel, "call_ms": call, "variant_kernel_ms": vkernel,
               "call_device_ops": _device_ops(lambda: cms_update(sketch, keys, counts)),
               "bytes_bound_ms": cs.k4_bounds(n, d, w, query=False)[0],
               "floor_ms": max(floor["empty_launch_ms"], d * n / floor["atomic_adds_per_s"] * 1e3)}
        for p, o in olds.items():
            row.setdefault("baseline_device_ops", {})[p] = _device_ops(
                lambda o=o: o.update_call(table0, keys, counts, sd))
            same = torch.equal(o.update_call(table0, keys, counts, sd), want)
            row.setdefault("bitwise_equal_to_baseline", {})[p] = same
            if not same:
                bad.append(f"{name}: {p}")
        if args.sweep and name.startswith("main"):
            sweep = {}
            for b in (1, 2, 3, 4, 6, 8, 11, 16, 26, 52):
                got = table0.clone()
                raw.add(got, keys, counts, sd, b)
                if not torch.equal(got, want):
                    bad.append(f"{name}: blocks_per_row {b}")
                sweep[b] = cs.cuda_time_ms(
                    lambda b=b: raw.add(scratch, keys, counts, sd, b),
                    reps=args.reps, setup=lambda: scratch.copy_(table0))
            row["sweep_ms_by_blocks_per_row"] = sweep
        _emit(row)

    for run, theta, out in runs:
        st = out.aux["incremental"]
        from repro_torch.core.cms import pair_key

        keys = pair_key(st["pair_a"], st["pair_b"])
        sk = out.aux["sketch"]
        n = int(keys.numel())
        k32, s32 = _u32(keys), _u32(sk.seeds)
        q32 = torch.empty(n, dtype=torch.int32, device="cuda")
        q64 = torch.empty(n, dtype=torch.int64, device="cuda")
        kernel = _turns(cs, lambda: raw.query(sk.table, keys, sk.seeds, q64),
                        {p: (lambda o=o: o.query(k32, s32, sk.table, q32)) for p, o in olds.items()},
                        None, args.reps)
        call = _turns(cs, lambda: cms_query(sk, keys),
                      {p: (lambda o=o: o.query_call(sk.table, keys, sk.seeds))
                       for p, o in olds.items()}, None, args.reps)
        want = cms_query(sk, keys)
        vout = torch.empty_like(want)
        for p, v in variants.items():
            v.query(sk.table, keys, sk.seeds, vout)
            if not torch.equal(vout, want):
                bad.append(f"K4b {run}: variant {p}")
        vkernel = _turns(cs, lambda: raw.query(sk.table, keys, sk.seeds, q64),
                         {p: (lambda v=v: v.query(sk.table, keys, sk.seeds, vout))
                          for p, v in variants.items()}, None, args.reps) if variants else None
        row = {"kernel": "K4b", "case": f"{run}: the real pair count P", "keys": n,
               "depth": d, "width": int(sk.table.shape[1]), "kernel_ms": kernel, "call_ms": call,
               "variant_kernel_ms": vkernel,
               "call_device_ops": _device_ops(lambda: cms_query(sk, keys)),
               "bytes_bound_ms": cs.k4_bounds(n, d, int(sk.table.shape[1]), query=True)[0],
               "floor_ms": floor["empty_launch_ms"],
               "equals_pair_w": bool(torch.equal(want.to(torch.float32), st["pair_w"]))}
        for p, o in olds.items():
            same = torch.equal(o.query_call(sk.table, keys, sk.seeds), want)
            row.setdefault("bitwise_equal_to_baseline", {})[p] = same
            if not same:
                bad.append(f"K4b {run}: {p}")
        _emit(row)

    _emit({"nvidia_smi": cs.nvidia_smi_line()})
    path = args.out or os.path.join(cs.OUT_DIR, "bench_k4.jsonl")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for line in _LINES:
            f.write(json.dumps(line) + "\n")
    if bad:
        raise SystemExit(f"bench_k4: bits differ: {bad}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
