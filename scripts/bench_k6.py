#!/usr/bin/env python3
"""Time K6 (flash attention forward) on one GPU at the LM serving shapes.

    python3 scripts/bench_k6.py
    python3 scripts/bench_k6.py --baseline build/k6_parent/flash_attention.cu [--baseline ...]
    python3 scripts/bench_k6.py --trace

Builds K6 and prints what ``-Xptxas -v`` says of each of its kernels, with
the dynamic shared memory of one block.  It refuses to launch the bf16
kernel unless it was compiled to the 168 registers a thread that its
``setmaxnreg`` split needs (384 threads: 40 for the producer warpgroup,
232 for each consumer warpgroup).  It then runs one small launch against
the plain version, and ``chip_smoke.py``'s K6 rows (llama3-8b's prefill
layer, qwen3-14b's 5-head groups, Mixtral's window, a ragged float32
case): errors within ``K6_LIMITS``, the planted faults, the tile classes
and ``scaled_dot_product_attention`` beside K6.  Each ``--baseline`` is
another K6 source with the same C entry point, built and timed on the same
inputs as K6, in turns (baseline, K6, K6, baseline).  ``--trace`` builds
K6 with ``-DK6_TRACE`` (phase clocks of each block, kept by one consumer
thread; see the source) and prints, for each bf16 row, the traced build's
time beside K6's and the mean clocks of each phase: to Q loaded and scaled,
to the first tile, per tile waiting on the ring, in S = Q·Kᵀ, in the
softmax and in P·V, the epilogue, and the gaps between blocks on an SM.
One JSON line per row; last, the card's name and power limit.

    python3 scripts/bench_k6.py --bwd [--baseline old/flash_attention_bwd.cu ...] [--phases]

``--bwd`` times K6b (the backward) instead: its kernels' ``-Xptxas -v``
figures and shared memory, ``chip_smoke.py``'s K6b rows (llama3-8b's
training layer in bf16, a ragged float32 case with a window: errors within
``K6B_LIMITS``, equal bits twice, the plain version and SDPA's backward
beside it), and each ``--baseline`` (a ``flash_attention_bwd.cu`` with the
same C entry point) timed on the same inputs in turns.  ``--phases`` adds
the device time of each of K6b's kernels (delta, dK/dV, dQ) from
``torch.profiler``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REGISTERS_NEEDED = 168  # (128 x 40 + 256 x 232) / 384


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _baseline_lib(src: str, tag: str, flags=()):
    """Build a K6 source with the port's nvcc flags (and ``flags``); its
    launch function."""
    from repro_torch.kernels import _build

    out = os.path.join(str(_build.BUILD_DIR), f"libk6_{tag}.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", out, src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"bench_k6: the baseline does not build:\n{proc.stderr}")
    lib = ctypes.CDLL(out)
    P, I = ctypes.c_void_p, ctypes.c_int
    # sources since the training slice take an lse pointer (null: not written) after out
    lib.has_lse = "void* lse" in open(src).read()
    lib.flash_attention_launch.argtypes = [P, P, P, P, P, P, *([P] if lib.has_lse else []),
                                           I, I, I, I, I, ctypes.c_float, I, I, I, I, P]
    lib.flash_attention_launch.restype = I
    return lib, proc.stdout + proc.stderr


def _launch(lib, q, k, v, qp, kp, out, case) -> None:
    import torch

    from repro_torch.kernels import _build

    _, _, S, T, H, KV, _, window, _ = case
    hd = k.shape[2]
    _build.check(lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(), kp.data_ptr(), out.data_ptr(),
        *([None] if lib.has_lse else []), q.shape[0], S, T, H // KV, hd, hd ** -0.5,
        int(q.dtype == torch.bfloat16), 1, int(window is not None), int(window or 0),
        torch.cuda.current_stream().cuda_stream),
        "K6")


def _trace(cs, reps: int) -> None:
    """The bf16 rows in a -DK6_TRACE build: phase clocks per block."""
    import numpy as np
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention_fwd

    lib, _ = _baseline_lib(str(_build.SOURCES["flash_attention"]), "trace", ["-DK6_TRACE"])
    lib.flash_attention_trace.argtypes = [ctypes.c_void_p]
    lib.flash_attention_trace.restype = ctypes.c_int
    blocks, fields = 8192, 16  # csrc kTraceBlocks, kTraceFields
    gen = torch.Generator(device="cuda").manual_seed(0)
    for case in cs.K6_CASES:
        name, B, S, T, H, KV, dtn, window, _ = case
        if dtn != "bfloat16":
            continue
        q, k, v, qp, kp = cs.k6_inputs(case, gen)
        out = torch.empty_like(q)
        traced_ms = cs.cuda_time_ms(lambda: _launch(lib, q, k, v, qp, kp, out, case), reps)
        k6_ms = cs.cuda_time_ms(lambda: flash_attention_fwd(q, k, v, qp, kp, causal=True,
                                                            window=window), reps)
        _launch(lib, q, k, v, qp, kp, out, case)
        torch.cuda.synchronize()
        buf = np.zeros(blocks * fields, np.int64)
        _build.check(lib.flash_attention_trace(buf.ctypes.data), "K6 trace copy")
        n = min(blocks, -(-S * (H // KV) // 128) * B * KV)
        t = buf[:n * fields].reshape(n, fields).astype(np.float64)
        tiles = np.maximum(t[:, 7], 1)
        start, end = (t[:, 0] - t[:, 0].min()) / 1e3, (t[:, 12] - t[:, 0].min()) / 1e3
        gaps = []
        for sm in np.unique(t[:, 6]):
            i = np.where(t[:, 6] == sm)[0]
            i = i[np.argsort(start[i])]
            gaps.extend(start[i][1:] - end[i][:-1])
        _emit({"trace": name, "traced_ms": traced_ms, "k6_ms": k6_ms, "blocks": int(n),
               "tiles_per_block": float(t[:, 7].mean()), "block_us": float((end - start).mean()),
               "gap_between_blocks_us": float(np.mean(gaps)) if gaps else None,
               "clocks": {"q_loaded": float(t[:, 1].mean()), "q_scaled": float(t[:, 2].mean()),
                          "first_tile": float(t[:, 3].mean()),
                          "epilogue": float((t[:, 5] - t[:, 4]).mean()),
                          "block": float(t[:, 5].mean())},
               "clocks_per_tile": {"ring_wait": float((t[:, 8] / tiles).mean()),
                                   "s_gemm": float((t[:, 9] / tiles).mean()),
                                   "softmax": float((t[:, 10] / tiles).mean()),
                                   "pv_gemm": float((t[:, 11] / tiles).mean())}})
        del q, k, v, out


BWD_CASES = [  # (B, KV, S, G, hd, dtype, window): chip_smoke.check_k6b's shapes
    (2, 8, 4096, 4, 128, "bfloat16", None), (2, 4, 1000, 4, 128, "float32", 256)]


def _bwd_lib(src: str, tag: str):
    """Build a K6b source with the port's nvcc flags; its library and log."""
    from repro_torch.kernels import _build

    out = os.path.join(str(_build.BUILD_DIR), f"libk6b_{tag}.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"bench_k6: {src} does not build:\n{proc.stderr}")
    lib = ctypes.CDLL(out)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_bwd_launch.argtypes = [P] * 12 + [I] * 5 + [ctypes.c_float] + \
        [I] * 4 + [P]
    lib.flash_attention_bwd_launch.restype = I
    return lib, proc.stdout + proc.stderr


def _bwd_inputs(case, gen):
    import torch

    B, KV, S, G, hd, dtn, window = case
    dt, BK = getattr(torch, dtn), B * KV
    q, dout = (torch.randn((BK, S, G * hd), generator=gen, device="cuda").to(dt)
               for _ in range(2))
    k, v = (torch.randn((BK, S, hd), generator=gen, device="cuda").to(dt) for _ in range(2))
    pos = torch.arange(S, dtype=torch.int32, device="cuda").expand(BK, S).contiguous()
    return q, k, v, dout, pos


def profile_phases(fn, calls: int = 3) -> dict:
    """Device ms of each kernel name over ``calls`` calls of ``fn``, per
    call (torch.profiler's CUPTI trace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if us > 0:
            out[e.key[:120]] = us / calls / 1e3
    return out


def _bwd(cs, args, smi: str) -> int:
    """``--bwd``: K6b's build figures, baselines in turns, phases and rows."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.kernel import _k6, _lib_bwd, flash_attention_bwd

    lib, log = _bwd_lib(str(_build.SOURCES["flash_attention_bwd"]), "log")
    _lib_bwd()
    lib.flash_attention_bwd_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    _emit({"k6b_kernels": cs.ptxas_kernels(log),
           "smem_bytes": {hd: {"bf16": lib.flash_attention_bwd_smem_bytes(hd, 1),
                               "f32": lib.flash_attention_bwd_smem_bytes(hd, 0)}
                          for hd in (16, 32, 64, 128)},
           "ptxas_warnings": [ln for ln in log.splitlines() if "arning" in ln]})
    cs._highest_f32()
    for i, src in enumerate(args.baseline):
        blib, blog = _bwd_lib(src, f"baseline{i}")
        _emit({"baseline": src, "k6b_kernels": cs.ptxas_kernels(blog)})
        for case in BWD_CASES:
            B, KV, S, G, hd, dtn, window = case
            q, k, v, dout, pos = _bwd_inputs(case, torch.Generator("cuda").manual_seed(S))
            out, lse = _k6(q, k, v, pos, pos, True, window, True)
            bout = [torch.empty_like(t) for t in (q, k, v)]
            delta = torch.empty_like(lse)

            def base():
                _build.check(blib.flash_attention_bwd_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), pos.data_ptr(), pos.data_ptr(),
                    *(t.data_ptr() for t in bout), B * KV, S, S, G, hd, hd ** -0.5,
                    int(dtn == "bfloat16"), 1, int(window is not None), int(window or 0),
                    torch.cuda.current_stream().cuda_stream), "K6b baseline")

            def new():
                return flash_attention_bwd(q, k, v, out, lse, dout, pos, pos, causal=True,
                                           window=window)

            ms = {"baseline": [], "k6b": []}
            for who, fn in [("baseline", base), ("k6b", new), ("k6b", new), ("baseline", base)]:
                ms[who].append(cs.cuda_time_ms(fn, reps=args.reps))
            got = new()
            base()
            torch.cuda.synchronize()
            diff = [float((a.float() - b.float()).abs().max() / b.float().abs().max())
                    for a, b in zip(got, bout)]
            _emit({"case": case, "baseline": src, "k6b_ms": ms["k6b"],
                   "baseline_ms": ms["baseline"], "rel_diff_dq_dk_dv": diff})
            del q, k, v, dout, out, lse, bout, got
            torch.cuda.empty_cache()
    if args.phases:
        for case in BWD_CASES:
            q, k, v, dout, pos = _bwd_inputs(case, torch.Generator("cuda").manual_seed(0))
            out, lse = _k6(q, k, v, pos, pos, True, case[6], True)
            _emit({"phases": case, "device_ms": profile_phases(
                lambda: flash_attention_bwd(q, k, v, out, lse, dout, pos, pos, causal=True,
                                            window=case[6]))})
            del q, k, v, dout, out, lse
    bad = []
    for row in cs.check_k6b(None):
        ok = cs._within(row["shape"]["errors"], row["shape"]["limits"]) and \
            row["shape"]["repeat_bitwise"]
        bad += [] if ok else [row["name"]]
        _emit(row)
    print(smi, flush=True)
    if bad:
        print(f"bench_k6: outside K6B_LIMITS or not repeating: {bad}", file=sys.stderr)
    return 1 if bad else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", action="append", default=[],
                    help="another flash_attention.cu to time beside K6 (repeatable)")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--trace", action="store_true",
                    help="time K6's phases in a build with -DK6_TRACE")
    ap.add_argument("--bwd", action="store_true",
                    help="time K6b, the backward (--baseline: flash_attention_bwd.cu sources)")
    ap.add_argument("--phases", action="store_true",
                    help="with --bwd: device time of each of K6b's kernels")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("bench_k6: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention_fwd, flash_attention_ref
    from repro_torch.kernels.flash_attention import kernel as fa_k

    smi = cs.nvidia_smi_line()
    if args.bwd:
        return _bwd(cs, args, smi)
    res = _build.build_all()
    log = res["logs"].get("flash_attention")
    if log is None:  # built before this process: build once more to read -Xptxas -v
        log = _baseline_lib(str(_build.SOURCES["flash_attention"]), "log")[1]
    kernels = cs.ptxas_kernels(log)
    for hd in fa_k.HEAD_DIMS:
        for dt in (torch.bfloat16, torch.float32):
            name = f"fa_fwd_{'bf16' if dt == torch.bfloat16 else 'f32'}<{hd}>"
            kernels.setdefault(name, {})["smem_bytes"] = fa_k.smem_bytes(hd, dt)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "k6_ptxas.log"), "w") as f:
        f.write(log)
    _emit({"build_s": res["seconds"], "k6_kernels": kernels,
           "ptxas_warnings": [ln for ln in log.splitlines() if "arning" in ln]})
    short = [n for n, k in kernels.items()
             if n.startswith("fa_fwd_bf16") and k.get("registers", 0) < REGISTERS_NEEDED]
    if short:
        raise SystemExit(f"bench_k6: {short} compiled below {REGISTERS_NEEDED} registers: "
                         "setmaxnreg.inc would wait for registers that no warp frees")

    # one small launch first: every head dim, causal, two q tiles and two kv tiles
    cs._highest_f32()
    gen = torch.Generator(device="cuda").manual_seed(1)
    for hd in fa_k.HEAD_DIMS:
        q = torch.randn(2, 160, 2 * hd, device="cuda", generator=gen).to(torch.bfloat16)
        k = torch.randn(2, 200, hd, device="cuda", generator=gen).to(torch.bfloat16)
        v = torch.randn(2, 200, hd, device="cuda", generator=gen).to(torch.bfloat16)
        qp = torch.arange(40, 200, dtype=torch.int32, device="cuda").expand(2, 160).contiguous()
        kp = torch.arange(200, dtype=torch.int32, device="cuda").expand(2, 200).contiguous()
        got = flash_attention_fwd(q, k, v, qp, kp, causal=True)
        torch.cuda.synchronize()
        want = flash_attention_ref(q, k, v, qp, kp, causal=True, block_k=128)
        err = float((got.float() - want.float()).abs().max())
        _emit({"smoke": {"hd": hd, "max_abs_err": err}})
        if not err <= 2e-2:
            raise SystemExit(f"bench_k6: hd {hd}: K6 differs from its plain version by {err}")

    if args.trace:
        _trace(cs, args.reps)
    for i, src in enumerate(args.baseline):
        lib, log = _baseline_lib(src, f"baseline{i}")
        _emit({"baseline": src, "k6_kernels": cs.ptxas_kernels(log),
               "ptxas_warnings": [ln for ln in log.splitlines() if "arning" in ln]})
        gen = torch.Generator(device="cuda").manual_seed(0)
        for case in cs.K6_CASES:
            name, window = case[0], case[7]
            q, k, v, qp, kp = cs.k6_inputs(case, gen)
            out = torch.empty_like(q)

            def base():
                _launch(lib, q, k, v, qp, kp, out, case)

            def new():
                flash_attention_fwd(q, k, v, qp, kp, causal=True, window=window)

            turns = [("baseline", base), ("k6", new), ("k6", new), ("baseline", base)]
            ms = {"baseline": [], "k6": []}
            for who, fn in turns:
                ms[who].append(cs.cuda_time_ms(fn, reps=args.reps))
            got = flash_attention_fwd(q, k, v, qp, kp, causal=True, window=window)
            base()
            torch.cuda.synchronize()
            _emit({"name": name, "baseline": src, "k6_ms": ms["k6"], "baseline_ms": ms["baseline"],
                   "k6_vs_baseline_max_abs": float((got.float() - out.float()).abs().max())})
            del q, k, v, out, got

    bad = []
    for row in cs.check_k6({"launches": {"flash_attention": None}},
                           {"k6_kernels": kernels}):
        row["within_limits"] = cs._within(row["shape"]["errors"], row["shape"]["limits"])
        bad += [] if row["within_limits"] else [row["name"]]
        _emit(row)
    print(smi, flush=True)
    if bad:
        print(f"bench_k6: outside K6_LIMITS: {bad}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
