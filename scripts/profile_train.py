#!/usr/bin/env python3
"""Profile the port's LM training step on one GPU: where a step's time goes.

    python3 scripts/profile_train.py                 # llama3-8b, 4 of 32 layers, B = 2
    python3 scripts/profile_train.py --layers 2 --batch 1
    python3 scripts/profile_train.py --save        # and time the state's checkpoint

Times, in a fresh process, the import of ``torch._dynamo`` (which
``torch.utils.checkpoint``, the remat of each layer, pays at its first
call); then builds the ``train_4k`` cell of llama3-8b at published width,
cut to ``--layers`` layers and ``--batch`` sequences of 4,096, draws its
state (seed 0) and takes ``--steps`` steps split into the loss's forward,
the backward (``torch.autograd.grad``) and AdamW, each timed on the host
clock ending in a synchronise (the first step pays CUDA's module loading
and the allocator's first blocks); then profiles one more step with
``torch.profiler``.  Prints one JSON line: the parts' seconds a step, the
profiled step's device busy share and device time by group (K6, K6b,
matmuls, everything else).  The full table goes to
``chiprun_out/profile_train.txt``.  With ``--save`` it then times the
checkpoint that ``FaultTolerantLoop`` writes at a run's end (a
``CheckpointManager`` save without the async writer: the host snapshot
and the write) under ``build/``, and removes it.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from profile_lm import _group as _lm_group  # noqa: E402
from profile_lm import _summary  # noqa: E402


def _group(name: str) -> str:
    if "fa_bwd" in name:
        return "k6b"
    return _lm_group(name)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--save", action="store_true")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    import torch._dynamo  # noqa: F401

    dynamo_s = time.perf_counter() - t0
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import random as trandom
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels import _build
    from repro_torch.launch import cells
    from repro_torch.models import lm as LM
    from repro_torch.optim import AdamWConfig, adamw_update
    from repro_torch.streaming.carry import tree_flatten, tree_unflatten

    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 2
    _build.build_all()

    def clock() -> float:
        torch.cuda.synchronize()
        return time.perf_counter()

    cfg = dataclasses.replace(cells.get_arch("llama3-8b").config, n_layers=args.layers)
    cell = cells.build_cell("llama3-8b", "train_4k", device="cuda", n_layers=args.layers,
                            batch=args.batch)
    key = trandom.PRNGKey(0)
    t0 = clock()
    state = cell.init_state(key)
    init_s = clock() - t0
    loss_fn = functools.partial(LM.loss_fn, device="cuda")
    opt = AdamWConfig()

    def step(state, batch, parts):
        leaves, spec = tree_flatten(state.params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        t0 = clock()
        loss, _ = loss_fn(tree_unflatten(spec, live), batch, cfg)
        t1 = clock()
        grads = torch.autograd.grad(loss, live)
        t2 = clock()
        state = adamw_update(state, tree_unflatten(spec, list(grads)), opt)
        t3 = clock()
        parts.append({"forward_s": t1 - t0, "backward_s": t2 - t1, "adamw_s": t3 - t2,
                      "loss": float(loss.detach())})
        return state

    parts: list = []
    for i in range(args.steps):
        state = step(state, cell.make_batch(trandom.fold_in(key, i))[0], parts)
    batch = cell.make_batch(trandom.fold_in(key, args.steps))[0]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = clock()
        state = step(state, batch, parts)
        wall = clock() - t0
    summary = _summary(prof, wall, group=_group)
    save = None
    if args.save:
        d = os.path.join(ROOT, "build", "profile_train_ckpt")
        t0 = clock()
        try:
            CheckpointManager(d, async_write=False).save(args.steps + 1, state)
            save = {"seconds": time.perf_counter() - t0,
                    "bytes": sum(os.path.getsize(os.path.join(r, f))
                                 for r, _, fs in os.walk(d) for f in fs)}
        except OSError as e:
            save = {"error": str(e).splitlines()[0], "after_s": time.perf_counter() - t0}
        finally:
            shutil.rmtree(d, ignore_errors=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "profile_train.txt"), "w") as f:
        f.write(summary.pop("table"))
    print(json.dumps({"layers": args.layers, "batch": args.batch, "seq": 4096,
                      "dynamo_import_s": dynamo_s, "init_s": init_s, "steps": parts,
                      "max_memory_allocated": torch.cuda.max_memory_allocated(),
                      "profiled_step": summary, "final_save": save}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
