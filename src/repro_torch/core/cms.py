"""Count-Min Sketch (CMS) for inter-cluster edge counts (paper §4.4).

``Θ(c_i, c_j)`` is posted into a ``(d, w)`` table of uint32 counts: row
``r`` adds at column ``avalanche(key ^ seed_r·0x9E3779B1) % w``, and a
point query takes the min over rows.  The table is the group ℤ/2³², so
negative counts retract exactly.  Hashing and row seeds are bit-identical
to ``repro.core.cms`` (the seeds come from :func:`repro_torch.random.randint`).

Representation: uint32 arithmetic is emulated in int64 masked with
``0xFFFFFFFF`` (keys and query results are int64 holding uint32 values);
the table keeps the uint32 bit pattern in an int32 tensor.  On CUDA,
update and query run in the K4a/K4b kernels (``kernels/cms_sketch``): an
update copies the table and K4a adds into the copy, one launch beside the
copy.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import random as _random
from .._device import resolve_device
from ..kernels.cms_sketch import ops as _ops
from ..kernels.cms_sketch.ref import u32_bits
from ..random import M32, mul32
from ..streaming import REPLICATED, SUM, PartitionerCarry

__all__ = [
    "CMSketch",
    "SketchCarry",
    "make_sketch",
    "pair_key",
    "vertex_key",
    "cms_update",
    "cms_retract",
    "cms_query",
    "cms_merge",
    "suggest_params",
]

_GOLDEN = 0x9E3779B1
_MIX1 = 0x85EBCA6B
_MIX2 = 0xC2B2AE35


class CMSketch(NamedTuple):
    """``table`` (d, w) int32 holding uint32 bit patterns; ``seeds`` (d,)
    int64 holding uint32 values."""

    table: torch.Tensor
    seeds: torch.Tensor

    @property
    def depth(self) -> int:
        return self.table.shape[0]

    @property
    def width(self) -> int:
        return self.table.shape[1]

    def memory_bytes(self) -> int:
        return self.table.numel() * 4 + self.seeds.numel() * 4


def suggest_params(epsilon: float = 0.1, nu: float = 0.01) -> tuple[int, int]:
    """Paper §4.4: w = ⌈e/ε⌉, d = ⌈ln(1/ν)⌉ (ε=0.1, ν=0.01 ⇒ w=28, d=5)."""
    return math.ceil(math.e / epsilon), math.ceil(math.log(1.0 / nu))


def make_sketch(width: int, depth: int, seed: int = 0, device=None) -> CMSketch:
    dev = resolve_device(device)
    seeds = _random.randint(_random.PRNGKey(seed), (depth,), 1, 2**31 - 1,
                            device=dev).to(torch.int64) & M32
    return CMSketch(table=torch.zeros((depth, width), dtype=torch.int32,
                                      device=dev), seeds=seeds)


def _avalanche(h: torch.Tensor) -> torch.Tensor:
    """xxhash/murmur-style 32-bit finalizer on uint32 values in int64."""
    h = h ^ (h >> 16)
    h = mul32(h, _MIX1)
    h = h ^ (h >> 13)
    h = mul32(h, _MIX2)
    return h ^ (h >> 16)


def pair_key(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Order-insensitive uint32 key (int64) for a cluster-id pair."""
    a = a.to(torch.int64) & M32
    b = b.to(torch.int64) & M32
    lo = torch.minimum(a, b)
    hi = torch.maximum(a, b)
    return _avalanche(mul32(lo, _GOLDEN) ^ hi)


def vertex_key(v: torch.Tensor) -> torch.Tensor:
    """uint32 sketch key (int64) for a single vertex id."""
    return pair_key(v, v)


def _row_cols(keys: torch.Tensor, seeds: torch.Tensor, width: int) -> torch.Tensor:
    """Column of every (row, key): (d, n) int64."""
    h = _avalanche(keys[None, :] ^ mul32(seeds[:, None], _GOLDEN))
    return h % width


def cms_update(sketch: CMSketch, keys: torch.Tensor,
               counts: torch.Tensor | None = None) -> CMSketch:
    """Add ``counts`` (default 1, may be negative) at ``keys``: a new
    sketch whose table wraps in ℤ/2³²."""
    return _ops.cms_update_kernel(sketch, keys, counts)


def cms_query(sketch: CMSketch, keys: torch.Tensor) -> torch.Tensor:
    """Point query: min over rows (unsigned), as int64 holding uint32."""
    return _ops.cms_query_kernel(sketch, keys)


def cms_merge(a: CMSketch, b: CMSketch) -> CMSketch:
    """Merge two sketches built with identical seeds (element-wise sum)."""
    table = u32_bits(a.table.to(torch.int64) + b.table.to(torch.int64))
    return CMSketch(table=table, seeds=a.seeds)


def cms_retract(sketch: CMSketch, keys: torch.Tensor,
                counts: torch.Tensor | None = None) -> CMSketch:
    """Subtract ``counts`` (default 1) at ``keys``: the exact inverse of the
    same :func:`cms_update`."""
    if counts is None:
        counts = torch.ones_like(keys, dtype=torch.int64)
    return cms_update(sketch, keys, -counts.to(torch.int64))


class SketchCarry(PartitionerCarry):
    """The Θ statistics pass as a carry: a CMS over cluster-pair keys.

    The stream's (src, dst) are cluster-id pairs; each valid pair adds one
    at its order-insensitive key (padding adds zero).  The table SUMs in
    ℤ/2³² (int32 adds wrap), so lanes merge exactly; the seeds are
    REPLICATED."""

    emits_parts = False
    supports_retract = True
    retract_exact = True
    merge_ops = (SUM, REPLICATED)

    def __init__(self, width: int, depth: int, seed: int = 0, device=None):
        self.width = int(width)
        self.depth = int(depth)
        self.seed = int(seed)
        self.device = resolve_device(device)

    def init(self) -> CMSketch:
        return make_sketch(self.width, self.depth, seed=self.seed,
                           device=self.device)

    def _counts(self, src, n_valid):
        return (torch.arange(src.shape[0], device=src.device) < n_valid).to(torch.int64)

    def step_chunk(self, carry, src, dst, n_valid, *extras):
        return cms_update(carry, pair_key(src, dst), self._counts(src, n_valid)), None

    def retract_chunk(self, carry, src, dst, n_valid, parts, *extras):
        return cms_retract(carry, pair_key(src, dst), self._counts(src, n_valid))
