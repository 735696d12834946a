"""Plain PyTorch versions of K4a/K4b: the same hashing as ``core.cms``
(imported lazily — ``core`` imports the kernels package at module level)."""

from __future__ import annotations

import torch

__all__ = ["u32_bits", "update_ref", "add_ref", "query_ref"]


def u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 (any sign) → the low 32 bits as an int32 bit pattern."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32).contiguous()


def update_ref(keys, seeds, width, depth, counts=None):
    """(depth, width) int32 bit patterns of Σ counts per cell, mod 2**32."""
    from ...core.cms import _row_cols

    if counts is None:
        counts = torch.ones_like(keys, dtype=torch.int64)
    cols = _row_cols(keys.to(torch.int64) & 0xFFFFFFFF, seeds, width)  # (d, n)
    rows = torch.arange(depth, device=keys.device)[:, None] * width
    c = (counts.to(torch.int64) & 0xFFFFFFFF).expand(depth, -1)
    flat = torch.zeros(depth * width, dtype=torch.int64, device=keys.device)
    flat.index_add_(0, (rows + cols).reshape(-1), c.reshape(-1))
    return u32_bits(flat).reshape(depth, width)


def add_ref(table, keys, seeds, counts=None):
    """``table`` plus the counts at ``keys``, wrapped in ℤ/2³² (a new table)."""
    depth, width = table.shape
    batch = update_ref(keys, seeds, width, depth, counts)
    return u32_bits(table.to(torch.int64) + batch.to(torch.int64)).reshape(depth, width)


def query_ref(table, keys, seeds):
    """Min over rows of the unsigned cells each key hashes to (int64)."""
    from ...core.cms import _row_cols

    cols = _row_cols(keys.to(torch.int64) & 0xFFFFFFFF, seeds, table.shape[1])
    vals = torch.gather(table.to(torch.int64) & 0xFFFFFFFF, 1, cols)
    return vals.amin(dim=0)
