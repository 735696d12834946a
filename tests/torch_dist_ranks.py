"""Rank functions of ``tests/test_torch_distributed.py``: each runs in every
rank of a spawned gloo world on the CPU (``repro_torch._dist.spawn_world``)
and returns numpy results for the test to hold against the reference.

Spawn imports this module in every rank, so it imports ``repro_torch``
only: never ``jax`` or ``repro`` (``tests/test_torch_isolation.py``)."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import _dist
from repro_torch.core.distributed import distributed_partition, last_partition_stats
from repro_torch.core.s5p import S5PConfig, s5p_partition
from repro_torch.streaming import EdgeStream, last_ingest_stats, run_parallel
from repro_torch.streaming.carry import tree_leaves

K = 4
CPU = "cpu"


def _np(tree) -> list:
    return [x.numpy().copy() if isinstance(x, torch.Tensor) else x for x in tree_leaves(tree)]


def partition(rank, world, dev, src, dst, n, cases):
    """``distributed_partition`` at S = world for each ``(use_cms, by_mesh)``
    case: the parts, ``info``, this rank's stats and collective bytes."""
    out = []
    for use_cms, by_mesh in cases:
        mesh = _dist.world_mesh(CPU, "data") if by_mesh else None
        _dist.reset_collective_bytes()
        parts, info = distributed_partition(src, dst, n, S5PConfig(k=K, use_cms=use_cms),
                                            mesh, device=dev)
        out.append({"parts": parts.cpu().numpy(), "info": info, "stats": last_partition_stats(),
                    "bytes": _dist.collective_bytes()})
    return out


def carries(n, deg, c2p, row):
    from repro_torch.core.clustering import ClusterCarry, DegreeCarry
    from repro_torch.core.cms import SketchCarry
    from repro_torch.core.postprocess import AssignCarry
    from repro_torch.hybrid.planner import DegreeSketchCarry
    from repro_torch.kernels.stream_scan import GreedyCarry, GridCarry, HdrfCarry

    t = torch.from_numpy
    return {
        "hdrf": lambda: HdrfCarry(n, K, 1.1, device=CPU),
        "greedy": lambda: GreedyCarry(n, K, device=CPU),
        "grid": lambda: GridCarry(K, t(row), t(row), 2, device=CPU),
        "cluster": lambda: ClusterCarry(t(deg), n, xi=3, kappa=40),
        "sketch": lambda: SketchCarry(64, 4, seed=3, device=CPU),
        "assign": lambda: AssignCarry(K, 60, t(c2p)),
        "degree": lambda: DegreeCarry(n, device=CPU),
        "degree_sketch": lambda: DegreeSketchCarry(32, 3, seed=2, device=CPU),
    }


def ingest(rank, world, dev, src, dst, n, names, extras, chunk, s5p_chunk):
    """``run_parallel`` at S = world with no backend named (a world S ranks
    wide resolves to ``shard_map``) for each consumer, and
    ``s5p_partition(num_streams=world)``."""
    deg = np.full((n,), 5, np.int32)
    c2p = np.arange(8, dtype=np.int32) % K
    row = np.arange(n, dtype=np.int32) % 2
    made = carries(n, deg, c2p, row)
    out = {}
    for name in names:
        ex = tuple(torch.from_numpy(e) for e in extras) if name == "assign" else ()
        stream = EdgeStream(src, dst, n, chunk_size=chunk, device=CPU)
        parts, carry = run_parallel(stream, made[name](), *ex, num_streams=world,
                                    super_chunk=2)
        out[name] = {"parts": None if parts is None else parts.numpy(), "carry": _np(carry),
                     "backend": last_ingest_stats().backend}
    cfg = S5PConfig(k=K, num_streams=world, chunk_size=s5p_chunk)
    res = s5p_partition(src, dst, n, cfg, device=CPU)
    out["s5p"] = {"parts": res.parts.numpy(), "n_clusters": res.n_clusters,
                  "game_rounds": res.game_rounds,
                  "touch_up": {k: v for k, v in res.aux.get("touch_up", {}).items()
                               if k != "game"},
                  "backend": res.aux["parallel_ingest"]["backend"]}
    try_mesh = _dist.world_mesh(CPU, "streams")
    stream = EdgeStream(src, dst, n, chunk_size=chunk, device=CPU)
    parts, carry = run_parallel(stream, made["hdrf"](), num_streams=world, super_chunk=2,
                                backend="shard_map", mesh=try_mesh)
    out["hdrf_mesh"] = {"parts": parts.numpy(), "carry": _np(carry)}
    return out


def merges(rank, world, dev, n, lanes_chunks, top_bit):
    """For every carry class: the lanes' carries folded from one base (each
    rank folds every lane, so it knows the ranks' carries), then
    ``merge_collective`` of its own lane against ``merge`` and
    ``merge_stacked`` of all of them, leaf by leaf."""
    deg = np.full((n,), 5, np.int32)
    c2p = np.arange(8, dtype=np.int32) % K
    row = np.arange(n, dtype=np.int32) % 2
    out = {}
    for name, make in carries(n, deg, c2p, row).items():
        pc = make()
        base = pc.init()
        if name in ("sketch", "degree_sketch"):  # cells with the top bit set
            base = base._replace(table=base.table + int(np.uint32(top_bit).view(np.int32)))
        lanes = []
        for chunks in lanes_chunks:
            local = _clone(base)
            for s, d, ex in chunks:
                exs = [torch.from_numpy(e) for e in ex] if name == "assign" else []
                local, _ = pc.step_chunk(local, torch.from_numpy(s), torch.from_numpy(d),
                                         len(s), *exs)
            lanes.append(local)
        got = pc.merge_collective(lanes[rank], base, None)
        want = pc.merge(lanes, base=base)
        out[name] = {"collective": _np(got), "merge": _np(want), "base": _np(base),
                     "lanes": [_np(c) for c in lanes]}
    return out


def _clone(tree):
    from repro_torch.streaming.carry import tree_flatten, tree_unflatten

    leaves, spec = tree_flatten(tree)
    return tree_unflatten(spec, [x.clone() if isinstance(x, torch.Tensor) else x
                                 for x in leaves])


def placement(rank, world, dev, state, work):
    """``reshard_state`` onto a mesh of the world (replicated and sharded
    leaves), ``make_test_mesh``, then ``ElasticController`` resizing the
    placed state to the first rank alone."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.reshard import reshard_state
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.runtime import ElasticController

    test_mesh = make_test_mesh(device_type=CPU)
    mesh = DeviceMesh(CPU, list(range(world)), mesh_dim_names=("data",))
    placed = reshard_state(state, {"w": (mesh, [Shard(0)]), "table": (mesh, [Replicate()]),
                                   "step": mesh})
    full = {k: v.full_tensor().numpy() for k, v in placed.items()}
    local_rows = placed["w"].to_local().shape[0]

    def make_mesh(size):
        return DeviceMesh(CPU, list(range(size)), mesh_dim_names=("data",))

    ctl = ElasticController(CheckpointManager(f"{work}/ckpt{rank}", async_write=False),
                            make_mesh=make_mesh,
                            make_shardings=lambda m: {"w": (m, [Shard(0)]),
                                                      "table": (m, [Replicate()]), "step": m})
    new_state, new_mesh, parts, step = ctl.resize(placed, 3, 1)
    inside = new_mesh.get_coordinate() is not None
    resized = {k: (v.full_tensor().numpy() if inside else v.to_local().numpy())
               for k, v in new_state.items()}
    return {"mesh_shape": tuple(test_mesh.shape), "mesh_names": test_mesh.mesh_dim_names,
            "full": full, "local_rows": local_rows, "inside": inside, "resized": resized,
            "dtensor": all(isinstance(v, DTensor) for v in new_state.values()), "step": step}


def wrong_mesh(rank, world, dev, src, dst, n):
    """``shard_map`` over a mesh narrower than S raises ``ValueError``."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.kernels.stream_scan import GreedyCarry

    one = DeviceMesh(CPU, [0], mesh_dim_names=("streams",))
    try:
        run_parallel(EdgeStream(src, dst, n, chunk_size=32, device=CPU),
                     GreedyCarry(n, K, device=CPU), num_streams=world, backend="shard_map",
                     mesh=one)
    except ValueError as e:
        return str(e)
    return "no error"


def collectives(rank, world, dev):
    """The helpers of ``repro_torch._dist`` on every dtype the carries use."""
    top = torch.tensor([0xFFFFFFF0, 3], dtype=torch.uint32)
    i32 = torch.tensor([2**31 - 1, -5], dtype=torch.int32) * (rank + 1)
    got = {
        "u32_sum": _dist.all_reduce(top, _dist.SUM).to(torch.int64).numpy(),
        "u32_max": _dist.all_reduce(top, _dist.MAX).to(torch.int64).numpy(),
        "i32_sum": _dist.all_reduce(i32, _dist.SUM).numpy(),
        "i32_min": _dist.all_reduce(i32, _dist.MIN).numpy(),
        "bool_max": _dist.all_reduce(torch.tensor([rank == 0, False]), _dist.MAX).numpy(),
        "f64_sum": _dist.all_reduce(torch.full((2,), 0.5 * (rank + 1), dtype=torch.float64),
                                    _dist.SUM).numpy(),
        "gathered": _dist.all_gather_arrays(np.arange(rank * 3, dtype=np.int64).reshape(rank, 3)
                                            if rank else np.zeros((0, 3), np.int64)),
    }
    ring = torch.tensor([rank], dtype=torch.int32)
    if world > 1:
        if rank == 0:
            _dist.send(ring, 1)
            ring = _dist.recv(ring, world - 1)
        else:
            ring = _dist.recv(ring, rank - 1) + 1
            _dist.send(ring, (rank + 1) % world)
    got["ring"] = int(ring)
    got["bytes"] = _dist.collective_bytes()
    return got


def run_all(rank, world, dev, jobs):
    """Several rank functions in one world, in order: ``{name: result}``."""
    fns = {"partition": partition, "ingest": ingest, "merges": merges,
           "placement": placement, "wrong_mesh": wrong_mesh, "collectives": collectives}
    return {name: fns[name](rank, world, dev, *args) for name, args in jobs}
