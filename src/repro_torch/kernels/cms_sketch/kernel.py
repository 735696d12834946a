"""Wrappers of the Hopper kernels K4a (CMS update) and K4b (CMS query).

:func:`cms_update` has the contract of
``repro.kernels.cms_sketch.kernel.cms_update_tpu``: it returns the
``(depth, width)`` table of this batch's counts.  :func:`cms_add` adds the
counts into a table it is handed, in place, wrapping in ℤ/2³² (what the
sketch's update needs: one launch, no second pass).  :func:`cms_query` has
the contract of ``cms_query_tpu``: the min-over-rows estimate per key.
uint32 values travel as int64 (keys, counts, seeds, query results; the
kernels read their low 32 bits) or as the bit pattern in int32 (tables).
On CUDA tensors each wrapper launches its kernel from ``csrc/cms_sketch.cu``
and counts the launch; on CPU tensors it runs the plain version in
:mod:`.ref`.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .. import _build
from . import ref

__all__ = ["cms_update", "cms_add", "cms_query", "default_blocks_per_row", "launch_counts",
           "reset_launch_counts"]

_LAUNCHES = {"cms_update": 0, "cms_query": 0}
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


_COUNT_LOCK = threading.Lock()  # parallel-ingest lanes launch from threads


def _count(name: str) -> None:
    with _COUNT_LOCK:
        _LAUNCHES[name] += 1


def launch_counts() -> dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def _lib():
    lib = _build.load("cms_sketch")
    if not getattr(lib, "_typed", False):
        lib.cms_update_launch.argtypes = [_P, _P, _P, _L, _I, _I, _P, _I, _P]
        lib.cms_update_launch.restype = _I
        lib.cms_query_launch.argtypes = [_P, _P, _P, _L, _I, _I, _P, _P]
        lib.cms_query_launch.restype = _I
        lib.cms_update_blocks_per_row.argtypes = [_L, _I, _I]
        lib.cms_update_blocks_per_row.restype = _I
        lib._typed = True
    return lib


def default_blocks_per_row(n: int, depth: int, width: int) -> int:
    """The key slices a table row that K4a takes for ``n`` keys (the C
    entry point takes another count where it is given one, as
    ``scripts/bench_k4.py --sweep`` does)."""
    return int(_lib().cms_update_blocks_per_row(int(n), int(depth), int(width)))


def _i64(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64).contiguous()


def _checked(keys, seeds, counts, depth):
    dev = keys.device
    for t in (seeds, counts):
        if t is not None and t.device != dev:
            raise ValueError(f"all tensors must be on {dev}, got {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"CMS kernels run on cuda or cpu, not {dev}")
    if keys.dim() != 1 or (counts is not None and counts.shape != keys.shape):
        raise ValueError("keys and counts must be (N,) tensors of one shape")
    if tuple(seeds.shape) != (depth,):
        raise ValueError(f"seeds must have shape ({depth},)")
    return dev


def cms_add(table: torch.Tensor, keys: torch.Tensor, seeds: torch.Tensor,
            counts: torch.Tensor | None = None) -> torch.Tensor:
    """Add ``counts`` (default 1 a key) at ``keys`` into the (depth, width)
    int32 ``table`` in place, wrapping in ℤ/2³²; returns ``table``."""
    depth, width = table.shape
    dev = _checked(keys, seeds, counts, depth)
    if table.device != dev or table.dtype != torch.int32 or not table.is_contiguous():
        raise ValueError(f"table must be a contiguous int32 (d, w) tensor on {dev}")
    if dev.type == "cpu":
        return table.copy_(ref.add_ref(table, keys, seeds, counts))
    n = int(keys.numel())
    if n == 0:
        return table
    k64, s64 = _i64(keys), _i64(seeds)
    c64 = None if counts is None else _i64(counts)
    _count("cms_update")
    code = _lib().cms_update_launch(
        k64.data_ptr(), None if c64 is None else c64.data_ptr(), s64.data_ptr(), n,
        int(depth), int(width), table.data_ptr(), 0,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "cms_update")
    return table


def cms_update(keys: torch.Tensor, seeds: torch.Tensor, width: int,
               depth: int, counts: torch.Tensor | None = None) -> torch.Tensor:
    """(N,) keys → (depth, width) int32 table of wrapped count sums."""
    table = torch.zeros((depth, width), dtype=torch.int32, device=keys.device)
    return cms_add(table, keys, seeds, counts)


def cms_query(table: torch.Tensor, keys: torch.Tensor,
              seeds: torch.Tensor) -> torch.Tensor:
    """(N,) keys → (N,) int64 min-estimates (uint32 values)."""
    depth, width = table.shape
    dev = _checked(keys, seeds, None, depth)
    if table.device != dev or table.dtype != torch.int32:
        raise ValueError(f"table must be an int32 (d, w) tensor on {dev}")
    if dev.type == "cpu":
        return ref.query_ref(table, keys, seeds)
    n = int(keys.numel())
    out = torch.empty((n,), dtype=torch.int64, device=dev)
    if n:
        k64, s64 = _i64(keys), _i64(seeds)
        tab = table.contiguous()
        _count("cms_query")
        code = _lib().cms_query_launch(
            k64.data_ptr(), s64.data_ptr(), tab.data_ptr(), n, int(depth),
            int(width), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        _build.check(code, "cms_query")
    return out
