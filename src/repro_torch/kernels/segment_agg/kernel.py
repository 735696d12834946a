"""Wrapper of the Hopper kernel K5 (segment aggregation).

``segment_agg(x, layout)`` computes ``out[r] = Σ_e w[e]·x[src[e]]`` over
the edges of row ``r`` of a :class:`~.ops.SegmentLayout` (edges in stable
destination order, ``row_ptr``).  On CUDA tensors it launches
``segment_agg_launch`` from ``csrc/segment_agg.cu`` and counts the launch;
on CPU tensors it runs the plain version in :mod:`.ref`.  A CUDA tensor
never takes the plain path: a failed build or launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import ref

__all__ = ["segment_agg", "launch_counts", "reset_launch_counts"]

_LAUNCHES = {"segment_agg": 0}
_P = ctypes.c_void_p
_I = ctypes.c_int


def launch_counts() -> dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def _lib():
    lib = _build.load("segment_agg")
    if not getattr(lib, "_typed", False):
        lib.segment_agg_launch.argtypes = [_P, _I, _P, _P, _P, _I, _I, _P, _P]
        lib.segment_agg_launch.restype = _I
        lib._typed = True
    return lib


def segment_agg(x: torch.Tensor, layout) -> torch.Tensor:
    """(V, d) float32 or bfloat16 ``x`` → (n_rows, d) of ``x.dtype``."""
    dev = x.device
    for t in (layout.src, layout.w, layout.row_ptr):
        if t.device != dev:
            raise ValueError(f"x is on {dev}, the layout on {t.device}")
    if x.dim() != 2:
        raise ValueError(f"x must be (V, d), got shape {tuple(x.shape)}")
    if layout.n_src > x.shape[0]:
        raise ValueError(f"a src id is >= x's {x.shape[0]} rows")
    if dev.type == "cpu":
        return ref.segment_agg_ref(x, layout.src, layout.dst, layout.w, layout.n_rows)
    if dev.type != "cuda":
        raise ValueError(f"the segment aggregation runs on cuda or cpu, not {dev}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"K5 takes float32 or bfloat16 x, not {x.dtype}")
    n_rows, d = layout.n_rows, int(x.shape[1])
    if n_rows >= 2**31:
        raise ValueError("K5 takes fewer than 2**31 rows")
    x = x.contiguous()
    out = torch.empty((n_rows, d), dtype=x.dtype, device=dev)
    if n_rows == 0 or d == 0:
        return out
    _LAUNCHES["segment_agg"] += 1
    code = _lib().segment_agg_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), layout.src.data_ptr(),
        layout.w.data_ptr(), layout.row_ptr.data_ptr(), n_rows, d, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "segment_agg")
    return out
