"""Plain PyTorch version of K5: ``out[dst] += w·x[src]`` on the CPU.

The contract of ``repro.kernels.segment_agg.ref.segment_agg_ref``: each
message is the float32 product ``x[src]·w`` (rounded once), rows with
``dst < 0`` (padding) are dropped, the sums are float32 and the result is
cast to ``x.dtype``.  Each row is summed in edge order: one column at a
time, ``index_add_`` on a CPU tensor adds in index order, one float32 add
after another (no FMA).  That is the order K5 sums in, so the two are
bitwise equal.  On CUDA ``index_add_`` adds with atomics in a varying
order, so this version refuses any device but the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["segment_agg_ref"]


def segment_agg_ref(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                    w: torch.Tensor, n_rows: int) -> torch.Tensor:
    """(V, d) x, (E,) ids and float32 weights → (n_rows, d) of ``x.dtype``.
    Ids outside ``[0, n_rows)`` other than the ``dst < 0`` padding raise."""
    if x.device.type != "cpu":
        raise ValueError(f"the plain segment aggregation runs on the CPU, not {x.device}")
    keep = dst >= 0
    src, dst, w = src[keep].long(), dst[keep].long(), w[keep].float()
    if dst.numel() and int(dst.max()) >= n_rows:
        raise ValueError(f"a dst id is >= n_rows = {n_rows}")
    cols = x.t().contiguous()  # (d, V): each column gathers contiguously
    out = torch.zeros((x.shape[1], n_rows), dtype=torch.float32)
    for c in range(x.shape[1]):
        out[c].index_add_(0, dst, cols[c][src].float() * w)
    return out.t().contiguous().to(x.dtype)
