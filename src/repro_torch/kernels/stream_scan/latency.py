"""Latency bounds of the serial scans K1, K2, K3 and G1.

Each scan folds a chunk edge by edge, and every edge reads what the edge
before wrote, so neither bytes nor operations bound it: the chain does.
The least time the card could take for one chunk is

    edges × (dependent shared-memory steps × one shared-memory round trip
             + dependent warp reductions × one reduction round trip),

with the steps counted from the reference's statement order (below) and
the round trips measured on the card by :func:`measure_round_trips` (a
reduction across the warp is one ``redux.sync``, the cheapest cross-lane
step that the card offers for it).  The arithmetic on the chain (K3's IEEE
divisions, K1's compares and selects) is not counted, so the bound is a
floor.

Chains, per edge:

- **K1** (Alg. 1): the endpoints' clusters, then those clusters' volumes,
  then the stores the next edge's loads wait on: 3 shared steps.
- **K2** (Alg. 3): the endpoints' loads (the overflow choice's load beside
  them: the room pointers need no reduction), then the store of the pick: 2.
  K2's retract is no chain: it counts the recorded parts in parallel, so
  bytes bound it (:func:`retract_bytes_bound_ms`).
- **K3 Greedy**: the rows and loads (1 shared), the least value over the
  k partitions (1 reduction), the least index that holds it (1), the
  counter stores (1 shared): 2 shared, 2 reductions.
- **K3 HDRF insert**: the loads (1 shared), their max and min (1
  reduction), the best score (1), the least index that holds it (1), the
  stores (1 shared): 2 shared, 3 reductions; pd[u], pd[v] are read beside
  the loads.
- **K3 retract**: the picked counters read and written: 2 shared.
- **G1** (grid): the two candidate loads, then the store: 2 shared.

:func:`measure_launch_floor` measures what K4a (the CMS update, no chain)
can reach at best: an empty launch, and the card's rate of global atomic
adds at distinct, scattered addresses of an L2-resident table (the old
K4a's one add a row and key).
"""

from __future__ import annotations

import ctypes

__all__ = ["CHAIN_STEPS", "HBM_BYTES_PER_S", "latency_bound_ms",
           "measure_launch_floor", "measure_round_trips", "retract_bytes_bound_ms"]

HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)

# (dependent shared-memory steps, dependent warp reductions) per edge
CHAIN_STEPS = {
    "K1": (3, 0),
    "K2": (2, 0),
    "K3 greedy": (2, 2),
    "K3 hdrf": (2, 3),
    "K3 retract": (2, 0),
    "G1": (2, 0),
}


def latency_bound_ms(chain: str, edges: int, round_trips: dict) -> float:
    """``edges`` × the chain of :data:`CHAIN_STEPS` ``[chain]`` at the
    round trips of :func:`measure_round_trips`, in ms."""
    n_shared, n_redux = CHAIN_STEPS[chain]
    return edges * (n_shared * round_trips["shared_ns"]
                    + n_redux * round_trips["redux_ns"]) * 1e-6


def retract_bytes_bound_ms(edges: int, k: int) -> float:
    """K2's retract in ms at the card's memory rate: src, dst and the
    recorded parts read once (12 bytes an edge), the parts written once (4),
    the ``(k,)`` load read and written (8k)."""
    return (16 * edges + 8 * k) / HBM_BYTES_PER_S * 1e3


def measure_round_trips(steps: int = 1 << 20, reps: int = 5) -> dict:
    """One shared-memory, one shuffle and one reduction round trip on the
    current CUDA device, each from a chain of ``steps`` dependent steps in
    one thread (one warp): ns by CUDA events over the whole launch (the
    least of ``reps``), cycles by ``clock64`` inside it, and the clock they
    imply (MHz)."""
    import torch

    from .. import _build

    lib = _build.load("latency_probe")
    probes = (("shared", lib.shared_chase_launch), ("shuffle", lib.shuffle_chain_launch),
              ("redux", lib.redux_chain_launch))
    for _, fn in probes:
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    out = torch.zeros(2, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    for name, fn in probes:
        _build.check(fn(steps, out.data_ptr(), stream), f"{name} probe")
        best = float("inf")
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            _build.check(fn(steps, out.data_ptr(), stream), f"{name} probe")
            stop.record()
            torch.cuda.synchronize()
            best = min(best, start.elapsed_time(stop))
        cycles = int(out[1]) / steps
        ns = best * 1e6 / steps
        res[f"{name}_ns"] = ns
        res[f"{name}_cycles"] = cycles
        res[f"{name}_mhz"] = cycles / ns * 1e3
    res["steps"] = steps
    return res


def measure_launch_floor(table_words: int, adds: int = 1 << 24, reps: int = 20) -> dict:
    """On the current CUDA device: ``empty_launch_ms``, the mean CUDA-event
    time of one empty launch (events around it, as ``chip_smoke.py`` times
    a kernel); and ``atomic_adds_per_s``, the rate of ``adds`` global atomic
    adds at distinct, scattered words of a ``table_words``-word table (the
    least of ``reps`` launches, over 8 blocks of 256 threads an SM)."""
    import torch

    from .. import _build

    lib = _build.load("latency_probe")
    lib.empty_launch.argtypes = [ctypes.c_void_p]
    lib.empty_launch.restype = ctypes.c_int
    lib.atomic_rate_launch.argtypes = [ctypes.c_void_p, ctypes.c_uint, ctypes.c_longlong,
                                       ctypes.c_int, ctypes.c_void_p]
    lib.atomic_rate_launch.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    table = torch.zeros(int(table_words), dtype=torch.int32, device="cuda")
    blocks = 8 * torch.cuda.get_device_properties(0).multi_processor_count

    def timed(launch) -> list[float]:
        _build.check(launch(), "launch floor probe")
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            _build.check(launch(), "launch floor probe")
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop))
        return times

    empty = timed(lambda: lib.empty_launch(stream))
    atomic = timed(lambda: lib.atomic_rate_launch(table.data_ptr(), int(table_words),
                                                 int(adds), blocks, stream))
    return {"empty_launch_ms": sum(empty) / len(empty),
            "atomic_adds_per_s": adds / (min(atomic) * 1e-3),
            "atomic_probe_ms": min(atomic), "atomic_probe_adds": int(adds),
            "atomic_probe_table_words": int(table_words)}
