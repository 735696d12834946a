"""A rank's view of a ``torch.distributed`` world (multi-device S5P).

SPMD: one process a rank, and every rank runs the same host code.  The
collectives take a *group*: ``None`` (the default group), a
``ProcessGroup``, a one-dimensional ``DeviceMesh`` or a ``(DeviceMesh,
dim name)`` pair (:func:`group_of`).

Where the tensors travel is picked from the group's backend, never from a
caught exception:

- ``nccl`` (one card a rank): on the rank's card;
- ``gloo`` (ranks sharing one card, or CPU ranks): through host copies the
  helpers make explicitly, every time.

Integer reductions travel as int64, so no backend ever sees a ``uint32``
(gloo refuses it) and a SUM of 32-bit leaves wraps in ℤ/2³² after the sum,
exactly as ``merge`` adds them on one rank; bools travel as int32.
:func:`collective_bytes` counts the payload each collective moved on this
rank (an all-reduce's wire tensor, an all-gather's gathered buffers, a
send's or a receive's buffer), read and reset like the kernels' launch
counters.
"""

from __future__ import annotations

import os
import pickle
import threading
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ._device import resolve_device

__all__ = ["SUM", "MAX", "MIN", "is_up", "group_of", "rank", "world_size",
           "rank_device", "init_world", "shutdown", "spawn_world", "world_mesh",
           "wrap", "all_reduce", "all_gather_arrays", "send", "recv", "collective_bytes",
           "reset_collective_bytes"]

SUM, MAX, MIN = "sum", "max", "min"
_OPS = {SUM: dist.ReduceOp.SUM, MAX: dist.ReduceOp.MAX, MIN: dist.ReduceOp.MIN}

_BYTES = {"all_reduce": 0, "all_gather": 0, "send_recv": 0}
_BYTES_LOCK = threading.Lock()


def _add_bytes(kind: str, n: int) -> None:
    with _BYTES_LOCK:
        _BYTES[kind] += int(n)


def collective_bytes() -> dict[str, int]:
    """Bytes this rank's collectives moved since the last reset, by kind."""
    return dict(_BYTES)


def reset_collective_bytes() -> None:
    for kind in _BYTES:
        _BYTES[kind] = 0


# ------------------------------------------------------------------ world


def is_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def group_of(group=None):
    """The ``ProcessGroup`` behind ``group`` (see the module docstring)."""
    from torch.distributed.device_mesh import DeviceMesh

    if isinstance(group, tuple):
        mesh, name = group
        return mesh.get_group(name)
    if isinstance(group, DeviceMesh):
        if group.ndim != 1:
            raise ValueError(f"a {group.ndim}-D mesh needs a dim name: pass (mesh, name)")
        return group.get_group()
    if group is None and not is_up():
        raise ValueError("no process group is up: world size 1 with no collectives; "
                         "call init_world (or torch.distributed.init_process_group) first")
    return group


def rank(group=None) -> int:
    return dist.get_rank(group_of(group))


def world_size(group=None) -> int:
    return dist.get_world_size(group_of(group))


def _local_rank(rank_: int) -> int:
    """The rank's index on its host: ``LOCAL_RANK`` (torchrun), else the
    global rank (every rank on one host, as :func:`spawn_world` starts them)."""
    return int(os.environ.get("LOCAL_RANK", rank_))


def rank_device(device=None) -> torch.device:
    """The rank's device: ``device`` when the caller names one, else its
    card (the local rank modulo the cards on the host), and no card raises."""
    if device is not None:
        return torch.device(device)
    resolve_device(None)
    local = _local_rank(dist.get_rank() if is_up() else 0)
    return torch.device("cuda", local % torch.cuda.device_count())


def init_world(rank_: int, world: int, init_method: str, device=None) -> torch.device:
    """Bring up the default group: NCCL when every rank has a card of its
    own (the host's ranks, ``LOCAL_WORLD_SIZE`` or else the whole world,
    no more than its cards), gloo when ranks share one card or run on the
    CPU.  Returns the rank's device (set current on the card): its local
    rank's card under NCCL, card 0 under gloo."""
    dev = torch.device(device) if device is not None else resolve_device(None)
    backend = "gloo"
    if dev.type == "cuda":
        if torch.cuda.device_count() >= int(os.environ.get("LOCAL_WORLD_SIZE", world)):
            backend = "nccl"
            dev = torch.device("cuda", _local_rank(rank_))
        else:
            dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank_,
                            world_size=world)
    return dev


def shutdown() -> None:
    if is_up():
        dist.destroy_process_group()


def _rank_entry(rank_: int, world: int, init: str, device, fn, args, work: str) -> None:
    dev = init_world(rank_, world, init, device)
    if dev.type == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    try:
        out = fn(rank_, world, dev, *args)
        tmp = Path(work) / f"rank{rank_}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(out, f)
        os.replace(tmp, Path(work) / f"rank{rank_}.pkl")
    finally:
        shutdown()


def spawn_world(fn, world: int, args: tuple = (), *, work_dir, device=None) -> list:
    """Run ``fn(rank, world, device, *args)`` in ``world`` spawned processes,
    one a rank, each with the default group up (:func:`init_world`, a file
    store in ``work_dir``), and wait for all of them.  ``fn`` must be a
    module-level function (spawn imports its module in every rank).
    Returns each rank's return value in rank order, pickled through
    ``work_dir``."""
    import torch.multiprocessing as mp

    work = Path(work_dir)
    work.mkdir(parents=True, exist_ok=True)
    init = work / f"store-{os.getpid()}-{world}"
    for f in [init] + [work / f"rank{r}.pkl" for r in range(world)]:
        f.unlink(missing_ok=True)
    mp.spawn(_rank_entry, nprocs=world, join=True,
             args=(world, f"file://{init.resolve()}", None if device is None else str(device),
                   fn, tuple(args), str(work)))
    init.unlink(missing_ok=True)
    out = []
    for r in range(world):
        with open(work / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def world_mesh(device_type: str, name: str = "data"):
    """A one-dimensional ``DeviceMesh`` over the whole default group."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (dist.get_world_size(),), mesh_dim_names=(name,))


def _wire_device(pg, like: torch.device) -> torch.device:
    if dist.get_backend(pg) == "gloo":
        return torch.device("cpu")
    return like if like.type == "cuda" else torch.device("cuda", torch.cuda.current_device())


def wrap(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An int64 sum back to ``dtype``'s width, modulo 2^bits."""
    info = torch.iinfo(dtype)
    if info.bits == 64:
        return x.to(dtype)
    x = x & ((1 << info.bits) - 1)
    if info.min < 0:
        x = torch.where(x >= (1 << (info.bits - 1)), x - (1 << info.bits), x)
    return x.to(dtype)


def all_reduce(t: torch.Tensor, op: str = SUM, group=None) -> torch.Tensor:
    """A new tensor on ``t``'s device and of its dtype: the SUM, MAX or MIN
    of ``t`` over the group.  Integer sums wrap to ``t``'s width."""
    pg = group_of(group)
    dt = t.dtype
    wire_dt = dt
    if dt == torch.bool:
        if op == SUM:
            raise ValueError("a SUM of bools is not defined; carry them as int32")
        wire_dt = torch.int32
    elif not dt.is_floating_point and not dt.is_complex:
        wire_dt = torch.int64
    w = t.to(device=_wire_device(pg, t.device), dtype=wire_dt, copy=True).contiguous()
    dist.all_reduce(w, op=_OPS[op], group=pg)
    _add_bytes("all_reduce", w.numel() * w.element_size())
    if dt == torch.bool:
        out = w > 0
    elif wire_dt == torch.int64 and dt != torch.int64:
        out = wrap(w, dt)
    else:
        out = w
    return out.to(t.device)


def all_gather_arrays(arr, group=None) -> list[np.ndarray]:
    """Every rank's host array (any length along axis 0, the same trailing
    shape and dtype on every rank), in rank order."""
    pg = group_of(group)
    a = np.ascontiguousarray(arr)
    if a.ndim == 0:
        raise ValueError("all_gather_arrays takes arrays of one or more dims")
    width = a.dtype.itemsize * int(np.prod(a.shape[1:], dtype=np.int64))
    n = world_size(pg)
    dev = _wire_device(pg, torch.device("cpu"))
    lens = torch.tensor([a.shape[0]], dtype=torch.int64, device=dev)
    got = [torch.zeros_like(lens) for _ in range(n)]
    dist.all_gather(got, lens, group=pg)
    lengths = [int(x) for x in torch.cat(got).cpu()]
    buf = torch.zeros((max(max(lengths), 1), width), dtype=torch.uint8, device=dev)
    buf[: a.shape[0]] = torch.from_numpy(a.reshape(-1).view(np.uint8).reshape(a.shape[0], width)).to(dev)
    outs = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(outs, buf, group=pg)
    _add_bytes("all_gather", n * (buf.numel() + 8))
    return [o[:length].cpu().numpy().reshape(-1).view(a.dtype).reshape((length,) + a.shape[1:])
            for length, o in zip(lengths, outs)]


def _global(pg, r: int) -> int:
    return dist.get_global_rank(pg if pg is not None else dist.group.WORLD, r)


def send(t: torch.Tensor, dst: int, group=None) -> None:
    """Send ``t`` to group rank ``dst`` (a host copy on gloo)."""
    pg = group_of(group)
    w = t.to(_wire_device(pg, t.device)).contiguous()
    dist.send(w, dst=_global(pg, dst), group=pg)
    _add_bytes("send_recv", w.numel() * w.element_size())


def recv(like: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Receive a tensor shaped and typed as ``like`` from group rank
    ``src``; returned on ``like``'s device."""
    pg = group_of(group)
    w = torch.empty(like.shape, dtype=like.dtype, device=_wire_device(pg, like.device))
    dist.recv(w, src=_global(pg, src), group=pg)
    _add_bytes("send_recv", w.numel() * w.element_size())
    return w.to(like.device)
