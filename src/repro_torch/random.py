"""Bit-exact PyTorch port of the ``jax.random`` calls on the S5P main path.

Covers ``PRNGKey``, ``fold_in``, ``split``, ``uniform``, ``randint``,
``normal`` and ``truncated_normal`` of the threefry-2x32 implementation in
the ``jax_threefry_partitionable=True`` mode (JAX 0.9's default), where
element ``i`` of a draw of shape ``s`` is ``threefry2x32(key, (i >> 32,
i & 0xFFFFFFFF))`` of the flat index ``i`` (draws of up to 2^64
elements) — so any slice of a draw can be computed on its own:
:func:`random_bits` takes a flat-index range ``[start, stop)``
and :func:`truncated_normal` can fill a preallocated output slice by slice,
bitwise equal to the whole draw (a draw of 10^9 elements would otherwise
keep several int64 arrays of that size alive at once).

The other mode (``jax_threefry_partitionable=False``) runs inside
``with threefry_partitionable(False):``, a scoped switch (the port has no
global config to read).  There a draw of
``n`` elements hashes the counter pairs ``(i, i + m)`` for ``i < m =
⌈n/2⌉`` (the last one ``(m − 1, 0)`` when ``n`` is odd) and lays the first
words of the pairs before the second words; ``split(key, num)`` is the draw
of ``2·num`` elements read as ``num`` consecutive pairs.  :func:`fold_in`
and :func:`PRNGKey` are the same in both modes.  ``normal`` and
``truncated_normal`` draw JAX's uniform bits exactly but use PyTorch's
erfinv (a few ulp from XLA's).

uint32 is emulated in int64 masked with ``0xFFFFFFFF``: PyTorch's CPU
uint32 lacks ``>>``, ``%``, ``+`` and ``min``.  The threefry rounds work
on Python ints and on int64 tensors alike, so scalar key derivations stay
on the host and per-element draws run on whatever device the counters
live on.  A key is a pair ``(k0, k1)`` of Python ints, or of int64
tensors for a batch of keys.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from ._fp32 import fma_f32

__all__ = ["PRNGKey", "fold_in", "split", "threefry2x32", "random_bits",
           "bits_at", "bits_to_uniform", "uniform", "randint", "mul32", "normal",
           "truncated_normal", "threefry_partitionable", "partitionable",
           "SLICE_ELEMS"]

M32 = 0xFFFFFFFF
SLICE_ELEMS = 1 << 26  # elements per slice of a draw filled into ``out``
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARTITIONABLE = [True]  # the mode of every draw; see threefry_partitionable


@contextlib.contextmanager
def threefry_partitionable(flag: bool):
    """Draw in JAX's ``jax_threefry_partitionable=flag`` mode inside the
    ``with`` block (``True``, JAX 0.9's default, outside any block)."""
    prev = _PARTITIONABLE[0]
    _PARTITIONABLE[0] = bool(flag)
    try:
        yield
    finally:
        _PARTITIONABLE[0] = prev


def partitionable() -> bool:
    """The mode draws are made in (see :func:`threefry_partitionable`)."""
    return _PARTITIONABLE[0]


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
    """``jax.random.split``: key ``j`` hashes counter ``j`` (partitionable
    mode), or is words ``2j`` and ``2j + 1`` of a ``2·num``-element draw."""
    if partitionable():
        return [threefry2x32(key[0], key[1], 0, j) for j in range(num)]
    words = [bits_at(key[0], key[1], 2 * num, i) for i in range(2 * num)]
    return [(words[2 * j], words[2 * j + 1]) for j in range(num)]


def bits_at(k0, k1, n: int, idx):
    """Element ``idx`` of a draw of ``n`` 32-bit words under key ``(k0,
    k1)``, in the current mode; ``idx`` (and the key words) may be Python
    ints or int64 tensors."""
    if partitionable():
        return _hashed(k0, k1, idx >> 32, idx & M32)
    if n > 2**32 - 1:  # the reference splits such draws into blocks
        raise NotImplementedError("draws of 2**32 - 1 elements or more")
    m = (n + 1) // 2
    if isinstance(idx, int):
        lo = idx < m
        x0, x1 = (idx, idx + m if idx + m < n else 0) if lo else (idx - m, idx)
        y0, y1 = threefry2x32(k0, k1, x0, x1)
        return y0 if lo else y1
    lo = idx < m
    x0 = torch.where(lo, idx, idx - m)
    x1 = torch.where(lo, idx + m, idx)
    x1 = torch.where(x1 < n, x1, torch.zeros_like(x1))
    y0, y1 = threefry2x32(k0, k1, x0, x1)
    return torch.where(lo, y0, y1)


def _hashed(k0, k1, hi, lo):
    """The partitionable mode's word for the counter pair ``(hi, lo)``."""
    y0, y1 = threefry2x32(k0, k1, hi, lo)
    return y0 ^ y1


def _counters(start: int, stop: int, device):
    """The flat indices ``[start, stop)`` as their ``(hi, lo)`` 32-bit
    words, without an index past int64 (``stop`` may reach 2**64)."""
    base_lo = start & M32
    lo = torch.arange(base_lo, base_lo + stop - start, dtype=torch.int64, device=device)
    return (start >> 32) + (lo >> 32), lo & M32


def random_bits(key, shape, device="cpu", start: int = 0,
                stop: int | None = None) -> torch.Tensor:
    """32 random bits per element of ``shape`` (uint32 values in int64).

    With ``start``/``stop`` only the flat elements ``[start, stop)`` of
    the draw are computed, as a 1-D tensor: element ``i`` depends on ``i``
    alone, so the slice is bitwise the whole draw's ``reshape(-1)[start:stop]``.
    """
    n = math.prod(shape)
    if n > 2**64:  # as JAX
        raise NotImplementedError("random bits array of size exceeding 2 ** 64")
    whole = start == 0 and stop is None
    stop = n if stop is None else stop
    if not 0 <= start <= stop <= n:
        raise ValueError(f"range [{start}, {stop}) outside a draw of {n} elements")
    if partitionable():
        bits = _hashed(key[0], key[1], *_counters(start, stop, device))
    else:
        idx = torch.arange(start, stop, dtype=torch.int64, device=device)
        bits = bits_at(key[0], key[1], n, idx)
    return bits.reshape(shape) if whole else bits


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """Mantissa trick of ``jax.random.uniform`` on [0, 1): float32."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key, shape, device="cpu", minval=0.0, maxval=1.0, start: int = 0,
            stop: int | None = None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, minval=, maxval=)`` (float32), or
    the flat elements ``[start, stop)`` of it (see :func:`random_bits`).

    JAX scales the [0, 1) draw as ``max(lo, f·(hi − lo) + lo)``, and XLA's
    CPU backend contracts that into an FMA; the port computes the FMA too,
    so the draw is bitwise equal on any range."""
    floats = bits_to_uniform(random_bits(key, shape, device, start, stop))
    if (minval, maxval) == (0.0, 1.0):
        return floats
    lo = torch.as_tensor(minval, dtype=torch.float32, device=floats.device)
    hi = torch.as_tensor(maxval, dtype=torch.float32, device=floats.device)
    scaled = fma_f32(floats, (hi - lo).expand_as(floats), lo.expand_as(floats))
    return torch.maximum(lo, scaled)


_SQRT2 = float(np.float32(np.sqrt(2)))


def normal(key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.normal(key, shape)`` (float32): ``√2·erfinv(u)`` of a
    uniform draw on (−1, 1).  The uniform draw is bitwise JAX's; the
    erfinv is PyTorch's, another approximation than XLA's, so a value may
    differ from JAX's by a few ulp (the tests hold it to a relative 1e-5)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    return _SQRT2 * torch.erfinv(uniform(key, shape, device, lo, 1.0))


def truncated_normal(key, lower: float, upper: float, shape, device="cpu", *,
                     out: torch.Tensor | None = None, scale: float | None = None,
                     slice_elems: int = SLICE_ELEMS) -> torch.Tensor:
    """``jax.random.truncated_normal(key, lower, upper, shape)`` (float32):
    a uniform draw over ``(erf(lower/√2), erf(upper/√2))``, then ``√2·erfinv``,
    clipped into the open interval.  Same ulp caveat as :func:`normal`.

    With ``out`` (a contiguous tensor of ``shape``, any float type, on any
    device) the draw is made ``slice_elems`` elements at a time, each
    multiplied by ``scale`` in float32 if given and cast into ``out``:
    bitwise ``(truncated_normal(...) * scale).to(out.dtype)``, without the
    whole float32 draw or its int64 counters ever alive at once."""
    if out is None:
        return _truncated_normal_slice(key, lower, upper, shape, device, 0, None, scale)
    if tuple(out.shape) != tuple(shape) or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous tensor of shape {tuple(shape)}")
    flat = out.view(-1)
    for a in range(0, flat.numel(), slice_elems):
        b = min(a + slice_elems, flat.numel())
        flat[a:b] = _truncated_normal_slice(key, lower, upper, shape, out.device, a, b, scale)
    return out


def _truncated_normal_slice(key, lower, upper, shape, device, start, stop, scale):
    """The flat elements ``[start, stop)`` of the draw (see :func:`random_bits`)."""
    lower32 = torch.tensor(lower, dtype=torch.float32)
    upper32 = torch.tensor(upper, dtype=torch.float32)
    a = torch.erf(lower32 / _SQRT2)
    b = torch.erf(upper32 / _SQRT2)
    u = uniform(key, shape, device, a.to(device), b.to(device), start, stop)
    out = (_SQRT2 * torch.erfinv(u)).clamp(
        float(np.nextafter(np.float32(lower), np.float32(np.inf))),
        float(np.nextafter(np.float32(upper), np.float32(-np.inf))))
    return out if scale is None else out * scale


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
