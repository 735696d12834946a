"""Wrappers of the Hopper kernels K4a (CMS update) and K4b (CMS query).

Same contract as ``repro.kernels.cms_sketch.kernel.cms_update_tpu`` and
``cms_query_tpu``: the update returns the ``(depth, width)`` table of this
batch's counts (the caller adds it to the sketch), the query returns the
min-over-rows estimate per key.  uint32 values travel as int64 (keys,
counts, seeds, query results) or as the bit pattern in int32 (tables).
On CUDA tensors each wrapper launches its kernel from
``csrc/cms_sketch.cu`` and counts the launch; on CPU tensors it runs the
plain version in :mod:`.ref`.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import ref

__all__ = ["cms_update", "cms_query", "launch_counts", "reset_launch_counts"]

_LAUNCHES = {"cms_update": 0, "cms_query": 0}
_P = ctypes.c_void_p
_I = ctypes.c_int


def launch_counts() -> dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def _lib():
    lib = _build.load("cms_sketch")
    if not getattr(lib, "_typed", False):
        lib.cms_update_launch.argtypes = [_P, _P, _P, _I, _I, _I, _P, _P]
        lib.cms_update_launch.restype = _I
        lib.cms_query_launch.argtypes = [_P, _P, _P, _I, _I, _I, _P, _P]
        lib.cms_query_launch.restype = _I
        lib._typed = True
    return lib


def u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 (any sign) → the low 32 bits as an int32 bit pattern."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32).contiguous()


def _check_device(*ts):
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"all tensors must be on {dev}, got {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"CMS kernels run on cuda or cpu, not {dev}")
    return dev


def cms_update(keys: torch.Tensor, seeds: torch.Tensor, width: int,
               depth: int, counts: torch.Tensor | None = None) -> torch.Tensor:
    """(N,) keys → (depth, width) int32 table of wrapped count sums."""
    if counts is None:
        counts = torch.ones_like(keys)
    dev = _check_device(keys, seeds, counts)
    if keys.shape != counts.shape or keys.dim() != 1:
        raise ValueError("keys and counts must be (N,) tensors of one shape")
    if tuple(seeds.shape) != (depth,):
        raise ValueError(f"seeds must have shape ({depth},)")
    if dev.type == "cpu":
        return ref.update_ref(keys, seeds, width, depth, counts)
    table = torch.zeros((depth, width), dtype=torch.int32, device=dev)
    n = int(keys.shape[0])
    if n == 0:
        return table
    k32, c32, s32 = u32_bits(keys), u32_bits(counts), u32_bits(seeds)
    _LAUNCHES["cms_update"] += 1
    code = _lib().cms_update_launch(
        k32.data_ptr(), c32.data_ptr(), s32.data_ptr(), n, int(depth),
        int(width), table.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "cms_update")
    return table


def cms_query(table: torch.Tensor, keys: torch.Tensor,
              seeds: torch.Tensor) -> torch.Tensor:
    """(N,) keys → (N,) int64 min-estimates (uint32 values)."""
    dev = _check_device(table, keys, seeds)
    depth, width = table.shape
    if table.dtype != torch.int32 or tuple(seeds.shape) != (depth,):
        raise ValueError("table must be int32 (d, w) and seeds (d,)")
    if dev.type == "cpu":
        return ref.query_ref(table, keys, seeds)
    n = int(keys.shape[0])
    out = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        k32, s32 = u32_bits(keys), u32_bits(seeds)
        tab = table.contiguous()
        _LAUNCHES["cms_query"] += 1
        code = _lib().cms_query_launch(
            k32.data_ptr(), s32.data_ptr(), tab.data_ptr(), n, int(depth),
            int(width), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        _build.check(code, "cms_query")
    return out.to(torch.int64) & 0xFFFFFFFF
