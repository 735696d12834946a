"""float32 arithmetic as the reference's compiled programs round it."""

from __future__ import annotations

import torch

__all__ = ["fma_f32", "xla_sum_f32", "xla_sum_f32_columns"]


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


def xla_sum_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 sum of every element of ``x``, in the order of the
    reference's ``jnp.sum`` on XLA's CPU backend, on any device.

    XLA 0.9's CPU backend rewrites a reduction of more than 32 values into
    windows of 32 (its tree-reduction rewrite, then the reduce emitter):
    while more than 32 values are left, they are padded with zeros to a
    multiple of 32, ⌊pad/2⌋ of them in front and the rest behind, and each
    window is summed in sequence from 0; the last ≤ 32 values are then
    summed in sequence from 0.  Read from ``--xla_dump_to`` dumps (f32[118]
    → ``reduce-window(size=32 stride=32 pad=5_5)`` → f32[4] → ``reduce``).
    The match depends on that emitter, as :func:`fma_f32`'s on its fusions.
    Only elementwise float32 adds are used, so the bits are the same on
    the CPU and on ``cuda``.
    """
    return xla_sum_f32_columns(x.reshape(-1, 1))[0]


def xla_sum_f32_columns(x: torch.Tensor) -> torch.Tensor:
    """:func:`xla_sum_f32` of each column of a (n, m) tensor at once: the
    reference's ``jnp.sum(y, axis=1)`` of its (m, n) transpose.  Rows are
    contiguous, so each add reads whole lines."""
    x = x.to(torch.float32)
    while x.shape[0] > 32:
        n = x.shape[0]
        n_win = -(-n // 32)
        pad = n_win * 32 - n
        x = torch.nn.functional.pad(x, (0, 0, pad // 2, pad - pad // 2))
        x = x.view(n_win, 32, x.shape[1])
        acc = torch.zeros((n_win, x.shape[2]), dtype=torch.float32, device=x.device)
        for j in range(32):
            acc = acc + x[:, j]
        x = acc
    acc = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
    for j in range(x.shape[0]):
        acc = acc + x[j]
    return acc
