"""Bit-exact PyTorch port of the ``jax.random`` calls on the S5P main path.

Covers ``PRNGKey``, ``fold_in``, ``split``, ``uniform`` and ``randint`` of
the threefry-2x32 implementation in the ``jax_threefry_partitionable=True``
mode (JAX 0.9's default), where element ``i`` of a draw of shape ``s`` is
``threefry2x32(key, (hi(i), lo(i)))`` of the flat index ``i`` — so any
slice of a draw can be computed on its own.  The other mode is not ported.

uint32 is emulated in int64 masked with ``0xFFFFFFFF``: PyTorch's CPU
uint32 lacks ``>>``, ``%``, ``+`` and ``min``.  The threefry rounds work
on Python ints and on int64 tensors alike, so scalar key derivations stay
on the host and per-element draws run on whatever device the counters
live on.  A key is a pair ``(k0, k1)`` of Python ints, or of int64
tensors for a batch of keys.
"""

from __future__ import annotations

import math

import torch

__all__ = ["PRNGKey", "fold_in", "split", "threefry2x32", "random_bits",
           "bits_to_uniform", "uniform", "randint", "mul32"]

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def mul32(a, b: int):
    """``(a * b) mod 2**32`` for uint32 values held in int64 (no overflow:
    the 32×16-bit partial products stay below 2**48)."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds, as ``jax._src.prng`` lowers it."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r)
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def PRNGKey(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey`` for a 32-bit seed: ``(0, seed mod 2**32)``."""
    seed = int(seed)
    if not -(2**31) <= seed < 2**31:
        raise OverflowError(f"seed {seed} does not fit int32")
    return 0, seed & M32


def fold_in(key, data):
    """``jax.random.fold_in``; ``data`` may be an int or an int tensor
    (one folded key per element)."""
    return threefry2x32(key[0], key[1], 0, data & M32)


def split(key, num: int = 2) -> list[tuple[int, int]]:
    """``jax.random.split`` (fold-like: key ``j`` hashes counter ``j``)."""
    return [threefry2x32(key[0], key[1], 0, j) for j in range(num)]


def _counters(n: int, device):
    if n >= 2**32:
        raise NotImplementedError("draws of 2**32 elements or more")
    return torch.arange(n, dtype=torch.int64, device=device)


def random_bits(key, shape, device="cpu") -> torch.Tensor:
    """32 random bits per element of ``shape`` (uint32 values in int64)."""
    n = math.prod(shape)
    y0, y1 = threefry2x32(key[0], key[1], 0, _counters(n, device))
    return (y0 ^ y1).reshape(shape)


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """Mantissa trick of ``jax.random.uniform`` on [0, 1): float32."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (float32 on [0, 1))."""
    return bits_to_uniform(random_bits(key, shape, device))


def randint(key, shape, minval: int, maxval: int, device="cpu") -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, dtype=int32)``."""
    if not -(2**31) <= minval < 2**31 or not -(2**31) <= maxval < 2**31:
        raise OverflowError("randint bounds must fit int32")
    k1, k2 = split(key)
    higher = random_bits(k1, shape, device)
    lower = random_bits(k2, shape, device)
    span = 1 if maxval <= minval else (maxval - minval) & M32
    multiplier = (2**16) % span
    multiplier = ((multiplier * multiplier) & M32) % span
    offset = (mul32(higher % span, multiplier) + lower % span) & M32
    offset = offset % span
    out = (minval + offset) & M32
    return torch.where(out >= 2**31, out - 2**32, out).to(torch.int32)
