#!/usr/bin/env python3
"""Time K7 (the xDeepFM CIN layer) on one GPU at the recsys serving shapes.

    python3 scripts/bench_k7.py
    python3 scripts/bench_k7.py --baseline build/k7_parent/cin.cu [--baseline ...]

Builds K7 and prints what ``-Xptxas -v`` says of each of its kernels, with
the dynamic shared memory of one block.  It then runs one small launch of
each type against the plain version, and ``chip_smoke.py``'s K7 rows
(``serve_p99``'s layers 1 and 2 in float32, layer 2 in bf16, a ragged
B = 1,000 and ``serve_bulk``'s layer 2 at B = 262,144): errors within
``K7_LIMITS``, equal bits on two launches, the planted faults, the plan's
splits, the bound on the tensor cores beside the scalar one, and
``torch.einsum`` beside K7.  Each ``--baseline`` is another K7 source, with
this one's C entry point or with the scalar kernel's that it replaced
(``cin_launch(xk, x0, w, out, B, Hk, m, D, Hn, is_bf16, stream)``), built
and timed on the same inputs as K7, in turns (baseline, K7, K7, baseline).
With ``--serve-p99 N`` each baseline is also timed end to end: N
``serve_p99`` requests of xDeepFM at its published config (512 samples, a
forward and a copy of the scores to the host, on the host's clock), the
model's CIN layers going through the baseline or through K7, in the same
turns.  One JSON line per row; last, the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _build_lib(src: str, tag: str):
    """Build a K7 source with the port's nvcc flags; the library and its
    compiler output."""
    from repro_torch.kernels import _build

    out = os.path.join(str(_build.BUILD_DIR), f"libk7_{tag}.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"bench_k7: {src} does not build:\n{proc.stderr}")
    return ctypes.CDLL(out), proc.stdout + proc.stderr


def _launcher(lib):
    """A function (xk, x0, w, out) -> None that launches ``lib``'s K7 on the
    current stream, whichever of the two C entry points it has."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.cin import kernel as cin_k

    P, I = ctypes.c_void_p, ctypes.c_int
    if hasattr(lib, "cin_blocks_per_sm"):  # the tensor-core kernel's entry point
        lib.cin_launch.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, P]
        lib.cin_launch.restype = I
        lib.cin_blocks_per_sm.argtypes = [I, I, I]
        lib.cin_blocks_per_sm.restype = I
        lib.cin_smem_bytes.argtypes = [I, I, I]
        lib.cin_smem_bytes.restype = ctypes.c_longlong
        sms = torch.cuda.get_device_properties(0).multi_processor_count

        def run(xk, x0, w, out):
            B, Hk, D = xk.shape
            m, Hn = x0.shape[1], w.shape[1]
            slots = max(1, lib.cin_blocks_per_sm(m, 1, int(xk.dtype == torch.bfloat16))) * sms
            p = cin_k.plan(B, Hk, m, D, Hn, xk.dtype, slots, lib)
            _build.check(cin_k.launch(lib, xk, x0, w, out, p["splits"], p["h_span"]),
                         "K7 baseline")
        return run

    lib.cin_launch.argtypes = [P, P, P, P, I, I, I, I, I, I, P]
    lib.cin_launch.restype = I

    def run_scalar(xk, x0, w, out):
        B, Hk, D = xk.shape
        _build.check(lib.cin_launch(xk.data_ptr(), x0.data_ptr(), w.data_ptr(), out.data_ptr(),
                                    B, Hk, x0.shape[1], D, w.shape[1],
                                    int(xk.dtype == torch.bfloat16),
                                    torch.cuda.current_stream().cuda_stream), "K7 baseline")
    return run_scalar


def _serve_p99(baseline_run, n: int):
    """``{"baseline": [...], "k7": [...]}``: the mean, p99 and min ms of
    ``n`` ``serve_p99`` requests in each turn, the model's CIN layers on
    ``baseline_run`` or on K7."""
    import numpy as np
    import torch

    from repro_torch import random as trandom
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import recsys_ids
    from repro_torch.models import recsys as R

    cfg = get_arch("xdeepfm").config
    dev = torch.device("cuda")
    params = R.xdeepfm_init(cfg, trandom.PRNGKey(0), device=dev)
    requests = [recsys_ids(trandom.PRNGKey(r), cfg, 512, dev) for r in range(n)]
    k7_layer = R.cin_layer_kernel

    def base_layer(xk, x0, w):
        xk, x0, w = xk.contiguous(), x0.contiguous(), w.contiguous()
        out = torch.empty((xk.shape[0], w.shape[1], xk.shape[2]), dtype=xk.dtype,
                          device=xk.device)
        baseline_run(xk, x0, w, out)
        return out

    ms = {"baseline": [], "k7": []}
    try:
        for who, layer in [("baseline", base_layer), ("k7", k7_layer), ("k7", k7_layer),
                           ("baseline", base_layer)]:
            R.cin_layer_kernel = layer
            t = []
            with torch.inference_mode():
                for ids in requests[:2] + requests:  # two warm-up requests
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    R.xdeepfm_forward(params, ids, cfg).cpu()
                    t.append((time.perf_counter() - t0) * 1e3)
            t = np.array(t[2:])
            ms[who].append({"mean": float(t.mean()), "p99": float(np.percentile(t, 99)),
                            "min": float(t.min())})
    finally:
        R.cin_layer_kernel = k7_layer
    return ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", action="append", default=[],
                    help="another cin.cu to time beside K7 (repeatable)")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--serve-p99", type=int, default=0, metavar="N",
                    help="also time N serve_p99 requests with each baseline and with K7")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("bench_k7: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.cin import cin_layer, cin_layer_ref
    from repro_torch.kernels.cin.kernel import _lib

    smi = cs.nvidia_smi_line()
    res = _build.build_all()
    log = res["logs"].get("cin")
    if log is None:  # built before this process: build once more to read -Xptxas -v
        log = _build_lib(str(_build.SOURCES["cin"]), "log")[1]
    kernels = cs.ptxas_kernels(log)
    lib = _lib()
    smem = {dt: {hr: lib.cin_smem_bytes(39, hr, int(dt == "bf16")) for hr in (1, 39, 200)}
            for dt in ("f32", "bf16")}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "k7_ptxas.log"), "w") as f:
        f.write(log)
    _emit({"build_s": res["seconds"], "k7_kernels": kernels, "smem_bytes_m39_by_h_span": smem,
           "blocks_per_sm_m39": {dt: lib.cin_blocks_per_sm(39, 1, int(dt == "bf16"))
                                 for dt in ("f32", "bf16")},
           "ptxas_warnings": [ln for ln in log.splitlines() if "arning" in ln]})

    # one small launch first: a ragged B, K not a multiple of the stage
    cs._highest_f32()
    gen = torch.Generator(device="cuda").manual_seed(1)
    for dt in (torch.float32, torch.bfloat16):
        xk, x0, w = cs.k7_inputs(37, 7, dt, gen, m=13, Hn=41, D=3)
        got = cin_layer(xk, x0, w)
        torch.cuda.synchronize()
        errs = cs._k7_errs(got, cin_layer_ref(xk, x0, w))
        _emit({"smoke": str(dt), "errors": errs})
        if not cs._within(errs, cs.K7_LIMITS[str(dt).removeprefix("torch.")]):
            raise SystemExit(f"bench_k7: {dt}: K7 differs from its plain version: {errs}")

    for i, src in enumerate(args.baseline):
        blib, blog = _build_lib(src, f"baseline{i}")
        base_run = _launcher(blib)
        _emit({"baseline": src, "k7_kernels": cs.ptxas_kernels(blog),
               "ptxas_warnings": [ln for ln in blog.splitlines() if "arning" in ln]})
        gen = torch.Generator(device="cuda").manual_seed(0)
        for name, B, Hk, dtn in cs.K7_CASES:
            xk, x0, w = cs.k7_inputs(B, Hk, getattr(torch, dtn), gen)
            out = torch.empty((B, w.shape[1], xk.shape[2]), dtype=xk.dtype, device="cuda")
            reps = max(1, args.reps // 3) if B > 100_000 else args.reps

            def base():
                base_run(xk, x0, w, out)

            def new():
                cin_layer(xk, x0, w)

            ms = {"baseline": [], "k7": []}
            for who, fn in [("baseline", base), ("k7", new), ("k7", new), ("baseline", base)]:
                ms[who].append(cs.cuda_time_ms(fn, reps=reps))
            got = cin_layer(xk, x0, w)
            base()
            torch.cuda.synchronize()
            _emit({"name": name, "baseline": src, "k7_ms": ms["k7"],
                   "baseline_ms": ms["baseline"],
                   "k7_vs_baseline": cs._k7_errs(got, out)})
            del xk, x0, w, out, got
        if args.serve_p99:
            _emit({"serve_p99_ms": _serve_p99(base_run, args.serve_p99), "baseline": src,
                   "requests": args.serve_p99, "batch": 512})

    bad = []
    for row in cs.check_k7({"launches": {"cin": None}}, {"k7_kernels": kernels}):
        row["within_limits"] = cs._within(row["shape"]["errors"], row["shape"]["limits"])
        bad += [] if row["within_limits"] else [row["name"]]
        _emit(row)
    print(smi, flush=True)
    if bad:
        print(f"bench_k7: outside K7_LIMITS: {bad}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
