"""Tile plans of K1 (the Alg. 1 fold), K2 (the Alg. 3 placement) and K3
(the Greedy/HDRF scan).

Both kernels fold one chunk in edge order, and both now run that fold on
shared memory: each tile of ``T`` edges is staged (its endpoints deduplicated
into vertex slots and their state gathered), folded by one thread (K1) or
one warp (K3), and written back, by the whole block.  These pure functions
say how large a tile is and how many bytes of shared memory it takes; the
CUDA sources lay out the same bytes (``cluster_smem_bytes`` and
``scoring_smem_bytes`` in ``csrc/``), and the wrappers pass the tile to the
launch.

K3 stages the tile's replica rows, ``2T`` rows of ``k`` counters, so its
tile shrinks with ``k``.  Below :data:`K3_MIN_TILE` edges a tile would
spend more on staging than on folding, and K3 takes its **global** rung
instead: the unchanged loop that reads rows from global memory.  The rung
is chosen by ``k`` alone, before the launch; it is never a fallback on a
failure.

K2's producer warps pack each edge of a tile into one 32-bit record while
warp 0 folds the tile before (one thread, in groups of :data:`K2_GROUP`
edges, while some partition has room); records and parts are
double-buffered beside the ``(k,)`` load vector (:func:`assign_smem_bytes`).
"""

from __future__ import annotations

from typing import NamedTuple

__all__ = [
    "SHARED_MEM_BYTES",
    "K1_TILE",
    "K1_THREADS",
    "K3_MAX_TILE",
    "K3_MIN_TILE",
    "K3_GLOBAL_TILE",
    "K2_TILE",
    "K2_GROUP",
    "K2_THREADS",
    "ScoringPlan",
    "cluster_smem_bytes",
    "assign_smem_bytes",
    "scoring_row_stride",
    "scoring_smem_bytes",
    "scoring_plan",
]

SHARED_MEM_BYTES = 232_448  # what one H100 block may opt in to
K1_TILE = 1024  # edges a staged K1 tile holds
K1_THREADS = 512  # threads that stage and write back a K1 tile
K2_TILE = 2048  # edges a staged K2 tile
K2_GROUP = 16  # edges K2's room mode folds between two checks
K2_THREADS = 256  # warp 0 folds, warps 1-7 stage and write back
K3_MAX_TILE = 1024
K3_MIN_TILE = 32  # below this many edges a tile, K3 reads rows from global memory
K3_GLOBAL_TILE = 1024  # edge ids the global rung stages a tile (double-buffered)


def cluster_smem_bytes(tile: int) -> int:
    """Shared bytes of one K1 tile of ``tile`` edges: 8 scalars; ``2T``
    vertex slots of the fold's int4 (head slot, tail slot, local degree,
    degree: 8T) and six more leaves (id, the head and tail ids the tile
    starts with, the two counts, the allocation: 12T); per edge the packed
    slots and flags (T); a vertex hash of ``4T`` keys and slots (8T); a head
    and a tail cluster hash of ``4T`` keys and slots each (16T); ``2T`` head
    and ``2T`` tail cluster slots of (id, volume) (8T).  53T + 8 int32."""
    return 4 * (53 * tile + 8)


def assign_smem_bytes(k: int) -> int:
    """Shared bytes of one K2 insert block at ``k`` partitions: the load
    vector (``k`` rounded up to 32), two tiles of records, each with the
    group read past it (2T + 2G), two tiles of parts (2T), and 4 scalars
    (first, last, the wrap flag)."""
    return 4 * ((k + 31) // 32 * 32 + 4 * K2_TILE + 2 * K2_GROUP + 4)


def scoring_row_stride(k: int) -> int:
    """Counters between two staged replica rows: ``k`` rounded up to 4, so
    every row starts on 16 bytes and is gathered in 16-byte loads."""
    return (k + 3) // 4 * 4


def scoring_smem_bytes(k: int, tile: int) -> int:
    """Shared bytes of one K3 tile of ``tile`` edges at ``k`` partitions:
    4 scalars; the load vector (``k`` rounded up to 32); ``2T`` staged rows
    of :func:`scoring_row_stride` counters; per edge the packed slots and
    the recorded part (2T); a vertex hash of ``4T`` keys and slots (8T);
    per vertex slot its id and partial degree (4T)."""
    kpad = (k + 31) // 32 * 32
    return 4 * (4 + kpad + 2 * tile * scoring_row_stride(k) + 14 * tile)


class ScoringPlan(NamedTuple):
    rung: str  # "shared" (staged rows) or "global" (rows read in place)
    tile: int  # edges a tile (the global rung stages edge ids only)
    smem_bytes: int  # dynamic shared memory of one block


def scoring_plan(k: int) -> ScoringPlan:
    """K3's rung and tile at ``k`` partitions: the largest tile of at most
    :data:`K3_MAX_TILE` edges whose stage fits :data:`SHARED_MEM_BYTES`;
    the global rung where that tile is under :data:`K3_MIN_TILE`."""
    if k < 1:
        raise ValueError(f"k must be positive, got {k}")
    fixed = scoring_smem_bytes(k, 0)
    per_edge = scoring_smem_bytes(k, 1) - fixed
    tile = min(K3_MAX_TILE, (SHARED_MEM_BYTES - fixed) // per_edge)
    if tile < K3_MIN_TILE:
        kpad = (k + 31) // 32 * 32
        return ScoringPlan("global", K3_GLOBAL_TILE, 4 * (kpad + 6 * K3_GLOBAL_TILE))
    return ScoringPlan("shared", tile, scoring_smem_bytes(k, tile))
