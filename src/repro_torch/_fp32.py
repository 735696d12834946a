"""float32 arithmetic as the reference's compiled programs round it."""

from __future__ import annotations

import torch

__all__ = ["fma_f32"]


def fma_f32(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """float32 ``x*y + z`` with one rounding, as a fused multiply-add gives.

    XLA's CPU backend contracts some of the reference's expressions into
    FMAs, so the port computes one too, on any device: the float32 product
    is exact in float64, the float64 sum is rounded to odd (TwoSum error
    folded into the last bit), and rounding that to float32 is then the
    correctly rounded result (53 >= 24 + 2 bits).
    """
    p = x.double() * y.double()
    zd = z.double()
    s = p + zd
    bb = s - p
    err = (p - (s - bb)) + (zd - bb)
    bits = s.view(torch.int64)
    even_inexact = (err != 0) & ((bits & 1) == 0)
    toward = torch.where((err > 0) == (s > 0), 1, -1)  # grow or shrink |s|
    s = torch.where(even_inexact, bits + toward, bits).view(torch.float64)
    return s.to(torch.float32)
