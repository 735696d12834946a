"""Training entry point: ``python -m repro_torch.launch.train --arch <id> --shape <s>``
(port of ``repro.launch.train``).

Composes the cell (model + step, :mod:`.cells`), AdamW, the fault-tolerant
loop, checkpointing and the straggler monitor.  With ``--smoke`` (the
default, as the reference's) the reduced config runs; ``--full`` the
published one.  It runs on the card unless ``--device cpu`` is given.
``--n-layers`` and ``--batch`` cut a configuration that one card cannot
hold whole; the ``[train]`` line names the cuts it used.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b --shape train_4k \\
        --steps 3 --device cpu
"""

from __future__ import annotations

import argparse
import logging
import os
import tempfile
import time

from .. import random as jrandom
from .._device import resolve_device
from ..checkpoint import CheckpointManager
from ..runtime import FaultInjector, FaultTolerantLoop, StragglerMonitor
from .cells import build_cell

log = logging.getLogger(__name__)

__all__ = ["train", "main"]


def train(arch: str, shape: str, steps: int = 100, smoke: bool = True,
          ckpt_dir: str | None = None, ckpt_every: int = 50,
          fail_at: tuple[int, ...] = (), seed: int = 0, log_every: int = 10, *,
          n_layers: int | None = None, batch: int | None = None, device=None,
          info: dict | None = None):
    """Train ``arch`` × ``shape`` for ``steps`` steps from ``PRNGKey(seed)``;
    returns ``(state, metrics)``, the last step's metrics as floats.
    ``ckpt_dir`` defaults to ``repro_ckpt`` under the temporary directory.
    ``info``, a dict, receives the run's figures: steps, seconds, restarts,
    the entry copy's seconds, the cuts, each step's seconds (device time:
    the loop waits for the step's metrics) and loss, and the cell's FLOPs a
    step."""
    dev = resolve_device(device)
    ckpt_dir = ckpt_dir or os.path.join(tempfile.gettempdir(), "repro_ckpt")
    cell = build_cell(arch, shape, smoke=smoke, device=dev, n_layers=n_layers, batch=batch)
    key = jrandom.PRNGKey(seed)
    state = cell.init_state(key)

    def data_fn(step: int):
        return cell.make_batch(jrandom.fold_in(key, step))

    manager = CheckpointManager(f"{ckpt_dir}/{arch}_{shape}", keep=3)
    monitor = StragglerMonitor(n_shards=1)
    losses = []  # each executed step's loss (a replayed step again)

    def step_fn(s, b):
        s, metrics = cell.step_fn(s, *b)
        losses.append(metrics["loss"])
        return s, metrics

    loop = FaultTolerantLoop(
        step_fn, data_fn, manager,
        ckpt_every=ckpt_every, injector=FaultInjector(fail_at),
        straggler_monitor=monitor,
    )
    t0 = time.time()
    state, step, metrics = loop.run(state, steps)
    dt = time.time() - t0
    out = {k: float(v) for k, v in metrics.items()} if isinstance(metrics, dict) else {}
    cuts = "".join(f" {k}={v}" for k, v in cell.cuts.items())
    print(f"[train] {arch} × {shape}: {step} steps in {dt:.1f}s "
          f"({dt / max(step, 1) * 1e3:.1f} ms/step) metrics={out} "
          f"restarts={loop.restarts}" + (f" cuts:{cuts}" if cuts else ""))
    if info is not None:
        info.update(steps=step, seconds=dt, restarts=loop.restarts,
                    entry_copy_s=loop.entry_copy_s, cuts=dict(cell.cuts),
                    step_s=[h[2] for h in monitor.history], losses=[float(x) for x in losses],
                    model_flops=cell.model_flops)
    return state, out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--full", action="store_true", help="full (non-smoke) config")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke config (the default; kept for symmetry with --full)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--n-layers", type=int, default=None, help="cut an LM to this depth")
    ap.add_argument("--batch", type=int, default=None, help="cut the shape's batch")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.full and args.smoke:
        ap.error("--full and --smoke exclude each other")
    train(args.arch, args.shape, steps=args.steps, smoke=not args.full,
          ckpt_every=args.ckpt_every, fail_at=tuple(args.fail_at),
          n_layers=args.n_layers, batch=args.batch, device=args.device)


if __name__ == "__main__":
    main()
