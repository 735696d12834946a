"""Fault-tolerant loop: checkpoint/restart with failure injection (the
port of ``repro.runtime.fault``).

Any step may raise; the run resumes from the last committed checkpoint
with bit-identical state.  :class:`FaultInjector` raises at chosen steps;
:class:`LaneFaultInjector` kills a parallel-ingest lane at a chosen chunk
(``run_parallel(lane_injector=..., on_lane_failure="replay")`` must
survive it bit for bit).

:class:`FaultTolerantLoop` keeps a host copy of the entry state (every
tensor leaf cloned to the CPU through the carry flattener), synchronises
the device that holds each step's metrics before it reads the step's
time (so a :class:`~repro_torch.runtime.straggler.StragglerMonitor` sees
device time), and restarts through
:meth:`~repro_torch.checkpoint.CheckpointManager.restore` (``like=`` the
state: leaves come back in its dtypes and on its devices) or, before the
first checkpoint, from the entry copy placed back by
:func:`~repro_torch.checkpoint.reshard.reshard_state`.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Iterable

import torch

from ..checkpoint import CheckpointManager
from ..checkpoint.reshard import reshard_state
from ..streaming.carry import tree_flatten, tree_unflatten

log = logging.getLogger(__name__)

__all__ = ["FaultInjector", "LaneFaultInjector", "FaultTolerantLoop"]


class FaultInjector:
    """Raises RuntimeError at the given steps (once each)."""

    def __init__(self, fail_at: Iterable[int] = ()):
        self.fail_at = set(fail_at)

    def check(self, step: int) -> None:
        if step in self.fail_at:
            self.fail_at.discard(step)
            raise RuntimeError(f"injected failure at step {step}")


class LaneFaultInjector:
    """Kill parallel-ingest lanes at named (lane, chunk) points (once each).

    Plugged into :func:`repro_torch.streaming.run_parallel` through
    ``lane_injector=``: the raise lands inside the lane's fold, mid-super-
    chunk.  A replayed lane re-folds its own chunks (under hub sharding its
    pinned chunk registry) from the last committed merge base, so the
    recovered drive is bit-identical to the undisturbed one.
    """

    def __init__(self, fail_at: Iterable[tuple[int, int]] = ()):
        self.fail_at = {(int(lane), int(chunk)) for lane, chunk in fail_at}
        self.fired: list[tuple[int, int]] = []

    def check(self, lane: int, chunk_id: int) -> None:
        key = (int(lane), int(chunk_id))
        if key in self.fail_at:
            self.fail_at.discard(key)
            self.fired.append(key)
            raise RuntimeError(
                f"injected lane {lane} failure at chunk {chunk_id}")


def _host_copy(tree):
    """Every tensor leaf cloned to the host; other leaves as they are."""
    leaves, spec = tree_flatten(tree)
    return tree_unflatten(spec, [x.detach().to("cpu", copy=True)
                                 if isinstance(x, torch.Tensor) else x for x in leaves])


def _devices(tree) -> list:
    """Each leaf's device in flattening order (``None``: not a tensor)."""
    return [x.device if isinstance(x, torch.Tensor) else None
            for x in tree_flatten(tree)[0]]


def _place(host_tree, devices: list):
    """A copy of the host copy's leaves on their devices, leaf by leaf (a
    step may write into its state's tensors: the host copy stays as taken)."""
    leaves, spec = tree_flatten(host_tree)
    placed = [reshard_state(x, d) for x, d in zip(leaves, devices)]
    return tree_unflatten(spec, [y.clone() if y is x and isinstance(x, torch.Tensor) else y
                                 for x, y in zip(leaves, placed)])


def _synchronize(tree) -> None:
    """Wait for the devices that hold ``tree``'s tensors."""
    for dev in {d for d in _devices(tree) if d is not None and d.type == "cuda"}:
        torch.cuda.synchronize(dev)


class FaultTolerantLoop:
    """Run ``step_fn`` with periodic checkpoints and automatic restart.

    ``step_fn(state, batch) → (state, metrics)``; ``data_fn(step) → batch``
    must be step-addressable (deterministic replay from any step).
    ``shard_fn(step) → shard`` attributes each step's time to a lane for
    the straggler monitor; without it every step is charged to shard 0.
    ``entry_copy_s`` holds the seconds of the last run's host copy of its
    entry state.
    """

    def __init__(self, step_fn: Callable, data_fn: Callable[[int], Any],
                 manager: CheckpointManager, ckpt_every: int = 50,
                 max_restarts: int = 8, injector: FaultInjector | None = None,
                 straggler_monitor=None,
                 shard_fn: Callable[[int], int] | None = None):
        self.step_fn = step_fn
        self.data_fn = data_fn
        self.manager = manager
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.injector = injector
        self.straggler_monitor = straggler_monitor
        self.shard_fn = shard_fn
        self.restarts = 0
        self.entry_copy_s = 0.0

    def run(self, state, n_steps: int, start_step: int = 0):
        # the entry state: a failure before the first checkpoint replays
        # from here (the crashed attempt's state would double-apply steps)
        t0 = time.perf_counter()
        init_state = _host_copy(state)
        self.entry_copy_s = time.perf_counter() - t0
        init_devices = _devices(state)
        step = start_step
        metrics = {}
        while step < n_steps:
            try:
                while step < n_steps:
                    batch = self.data_fn(step)
                    if self.injector is not None:
                        self.injector.check(step)
                    t0 = time.perf_counter()
                    state, metrics = self.step_fn(state, batch)
                    _synchronize(metrics)
                    if self.straggler_monitor is not None:
                        shard = (self.shard_fn(step)
                                 if self.shard_fn is not None else 0)
                        self.straggler_monitor.record(
                            step, time.perf_counter() - t0, shard=shard)
                    step += 1
                    if step % self.ckpt_every == 0:
                        self.manager.save(step, state)
            except (RuntimeError, OSError) as e:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                log.warning("step %d failed (%s); restarting from checkpoint", step, e)
                try:
                    state, step = self.manager.restore(like=state)
                except FileNotFoundError:
                    # no checkpoint yet: restart from the entry state
                    state = _place(init_state, init_devices)
                    step = start_step
        self.manager.save(step, state)
        self.manager.wait()
        return state, step, metrics
