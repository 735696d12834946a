"""Wrapper of the Hopper kernel K5 (segment aggregation).

``segment_agg(x, layout)`` computes ``out[r] = Σ_e w[e]·x[src[e]]`` over
the edges of row ``r`` of a :class:`~.ops.SegmentLayout` (edges in stable
destination order, ``row_ptr``; ``long_rows``, the rows of more than
``long_row_edges`` edges).  On CUDA tensors it launches
``segment_agg_launch`` from ``csrc/segment_agg.cu`` once and counts the
launch; on CPU tensors it runs the plain version in :mod:`.ref`.  A CUDA
tensor never takes the plain path: a failed build or launch raises.

:func:`tree_exact` is the plain statement of the rule by which K5 sums a
long row's column as a tree instead of a chain: the tree gives the
chain's bits only where no partial sum can round.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import ref

__all__ = ["segment_agg", "launch_counts", "reset_launch_counts", "tree_exact",
           "kernel_attributes"]

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
        lib.segment_agg_launch.argtypes = [_P, _I, _P, _P, _P, _I, _I, _P, _I, _I, _P,
                                           _P, _P]
        lib.segment_agg_launch.restype = _I
        lib.segment_agg_attributes.argtypes = [_I, _I, ctypes.c_ulonglong, _P]
        lib.segment_agg_attributes.restype = _I
        lib._typed = True
    return lib


def segment_agg(x: torch.Tensor, layout, *, tree_flags: torch.Tensor | None = None
                ) -> torch.Tensor:
    """(V, d) float32 or bfloat16 ``x`` → (n_rows, d) of ``x.dtype``.

    ``tree_flags``, an (n_long,) int32 CUDA tensor, receives for each long
    row (in ``layout.long_rows`` order) 1 where K5 summed every slice of
    its columns as a tree and 0 where a slice ran the chain (a diagnostic:
    both give the same bits)."""
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
    if layout.long_rows.device != dev:
        raise ValueError(f"x is on {dev}, the layout's long rows on {layout.long_rows.device}")
    n_long = int(layout.long_rows.numel())
    if tree_flags is not None and (tree_flags.device != dev or tree_flags.dtype != torch.int32
                                   or tuple(tree_flags.shape) != (n_long,)):
        raise ValueError(f"tree_flags must be an ({n_long},) int32 tensor on {dev}")
    x = x.contiguous()
    out = torch.empty((n_rows, d), dtype=x.dtype, device=dev)
    if n_rows == 0 or d == 0:
        return out
    if tree_flags is not None:
        tree_flags.fill_(1)  # a slice of a long row that runs the chain clears its row's flag
    _LAUNCHES["segment_agg"] += 1
    code = _lib().segment_agg_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), layout.src.data_ptr(),
        layout.w.data_ptr(), layout.row_ptr.data_ptr(), n_rows, d,
        layout.long_rows.data_ptr(), n_long, layout.long_row_edges, out.data_ptr(),
        None if tree_flags is None else tree_flags.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "segment_agg")
    return out


def kernel_attributes(x: torch.Tensor) -> dict:
    """The compiled kernel that :func:`segment_agg` launches for ``x`` (a
    CUDA tensor): chunk bytes, registers, spill bytes, shared memory."""
    vals = (ctypes.c_int * 6)()
    code = _lib().segment_agg_attributes(int(x.dtype == torch.bfloat16), int(x.shape[1]),
                                         x.contiguous().data_ptr(), vals)
    _build.check(code, "segment_agg_attributes")
    keys = ("chunk_bytes", "registers", "spill_bytes", "static_smem_bytes",
            "dynamic_smem_bytes", "threads")
    return dict(zip(keys, vals))


def tree_exact(products: torch.Tensor) -> torch.Tensor:
    """For (n, d) float32 products (one long row, in edge order), which
    columns K5 may sum as a tree: every product finite and, with 2^q the
    lowest set bit over the column's non-zero products, n·max|p| < 2^(24+q)
    and n·max|p| < 2^128.  Then every partial sum in every order is a
    multiple of 2^q below 2^(24+q), so no add rounds, and a tree from +0.0
    gives the edge-order chain's bits.  K5 takes the tree for a long row
    only where every column passes."""
    p = products.to(torch.float32)
    n = p.shape[0]
    bits = p.view(torch.int32).to(torch.int64) & 0x7FFFFFFF
    finite = (bits < 0x7F800000).all(dim=0)
    nz = (bits != 0) & (bits < 0x7F800000)
    ex = bits >> 23
    mant = torch.where(ex > 0, (bits & 0x7FFFFF) | 0x800000, bits)
    low = mant & -mant  # lowest set bit of the significand
    lb = torch.where(ex > 0, ex - 150, torch.full_like(ex, -149)) + torch.log2(
        low.clamp(min=1).double()).round().long()
    big = torch.iinfo(torch.int64).max
    q = torch.where(nz, lb, torch.full_like(lb, big)).amin(dim=0)
    mb = torch.where(nz, bits, torch.zeros_like(bits)).amax(dim=0)
    m_ex = mb >> 23
    m_mant = torch.where(m_ex > 0, (mb & 0x7FFFFF) | 0x800000, mb)
    m_e = torch.where(m_ex > 0, m_ex - 150, torch.full_like(m_ex, -149))
    sh = m_e - torch.where(q == big, m_e, q)
    k = torch.where(sh >= 0, m_mant << sh.clamp(0, 23), m_mant >> (-sh).clamp(0, 63))
    max_abs = mb.to(torch.int32).view(torch.float32).double()
    ok = (sh < 24) & (k < 2**24) & (n * k < 2**24) & (n * max_abs < 2.0**128)
    return finite & ((q == big) | ok)
