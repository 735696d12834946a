"""Where the scans' state lives on the card, and the scoring carries.

``select_path`` is the reference's fused → tiled → oracle VMEM ladder
(``repro.kernels.stream_scan.ops``), re-based on the H100:

- **global** — on a CUDA device.  The per-vertex state (K3's counted
  ``(V, k)`` replica table and HDRF's partial degrees, K1's cluster tables)
  lives in global memory; K1 and K3 stage each tile's share of it in
  shared memory (:mod:`.plan`), and the ``(k,)`` load vector lives there.
  One launch per chunk at any V: the card never answers ``"oracle"``.
- **oracle** — on the CPU: the plain versions in :mod:`.ref`.

Whether the whole state would fit one block's 227 KB
(``SHARED_MEM_BYTES``) is only logged.  The chosen rung is logged once per
(consumer, mode, rung) per process (``reset_path_log`` re-arms it).

The Greedy, HDRF and grid baselines' :class:`~repro_torch.streaming.
PartitionerCarry` implementations live here too (``GreedyCarry`` /
``HdrfCarry`` / ``GridCarry``).  Their ``step_chunk`` runs K3 or G1 on a
CUDA carry and the plain version on a CPU one; ``retract_chunk`` is K3
with ``sign=-1`` (grid: the vectorised inverse), which subtracts exactly
the load, replica-count and partial-degree accounting the insert added.
The parallel-ingest merge algebra of the reference's carries is not
ported yet.
"""

from __future__ import annotations

import logging

from ..._device import resolve_device
from ...streaming.carry import PartitionerCarry
from . import ref as _ref
from .kernel import grid_scan, scoring_scan
from .plan import SHARED_MEM_BYTES

__all__ = [
    "SHARED_MEM_BYTES",
    "GreedyCarry",
    "GridCarry",
    "HdrfCarry",
    "cluster_state_bytes",
    "make_chunk_fn",
    "reset_path_log",
    "scoring_state_bytes",
    "select_path",
]


_log = logging.getLogger(__name__)
_logged_paths: set[tuple] = set()


def scoring_state_bytes(n_vertices: int, k: int, mode: str = "hdrf") -> int:
    """Per-vertex and load state of the scoring scan (int32 bytes)."""
    pd = n_vertices * 4 if mode == "hdrf" else 0
    return n_vertices * k * 4 + k * 4 + pd


def cluster_state_bytes(n_vertices: int) -> int:
    """State of the Alg. 1 fold: 8 (V,) leaves, 2 (V+1,) volume arrays,
    the degree table, 2 scalar id counters."""
    return (11 * n_vertices + 4) * 4


def select_path(n_vertices: int, k: int, chunk_size: int, *,
                mode: str = "hdrf", consumer: str = "stream_scan",
                device=None) -> str:
    """``"global"`` on a CUDA device, ``"oracle"`` on the CPU; logs the
    choice once per run."""
    dev = resolve_device(device)
    path = "global" if dev.type == "cuda" else "oracle"
    state = (cluster_state_bytes(n_vertices) if consumer == "cluster"
             else scoring_state_bytes(n_vertices, k, mode))
    key = (consumer, mode, path)
    if key not in _logged_paths:
        _logged_paths.add(key)
        _log.info("%s[%s]: %s path (state %.1f KiB, %s one block's shared "
                  "memory; chunk %d edges)", consumer, mode, path,
                  state / 1024, "fits" if state <= SHARED_MEM_BYTES else
                  "exceeds", chunk_size)
    return path


def reset_path_log() -> None:
    """Re-arm the once-per-run path logging (used by tests)."""
    _logged_paths.clear()


# ---------------------------------------------------------------------------
# chunk functions (engine contract: (carry, src, dst) -> (carry, parts))
# ---------------------------------------------------------------------------


def _greedy_step(carry, src, dst):
    load, rep = carry
    parts, *_ = scoring_scan(src, dst, load, rep, mode="greedy")
    return (load, rep), parts


def _hdrf_step(carry, src, dst):
    """``kmask`` is ``arange(k) < k_active``, as ``hdrf_init`` builds it."""
    load, rep, pd, lam, kmask = carry
    parts, *_ = scoring_scan(src, dst, load, rep, pd, float(lam), mode="hdrf",
                             k_active=int(kmask.sum()))
    return carry, parts


def _grid_step(carry, src, dst):
    load, row, col, c = carry
    parts, _ = grid_scan(load, row, col, c, src, dst)
    return carry, parts


def make_chunk_fn(mode: str):
    """Chunk function of ``mode`` (``greedy | hdrf | grid``): K3 or G1 on a
    CUDA carry, the plain version on a CPU one."""
    fns = {"greedy": _greedy_step, "hdrf": _hdrf_step, "grid": _grid_step}
    if mode not in fns:
        raise ValueError(f"unknown mode {mode!r}")
    return fns[mode]


# ---------------------------------------------------------------------------
# PartitionerCarry implementations
# ---------------------------------------------------------------------------


class GreedyCarry(PartitionerCarry):
    """PowerGraph Greedy as a carry: (load, counted replica table)."""

    supports_retract = True

    def __init__(self, n_vertices: int, k: int, *, device=None):
        self.n_vertices = int(n_vertices)
        self.k = int(k)
        self.device = resolve_device(device)

    def init(self):
        return _ref.greedy_init(self.n_vertices, self.k, self.device)

    def step_chunk(self, carry, src, dst, n_valid, *extras):
        return _greedy_step(carry, src, dst)

    def retract_chunk(self, carry, src, dst, n_valid, parts, *extras):
        load, rep = carry
        scoring_scan(src, dst, load, rep, mode="greedy", sign=-1,
                     parts=parts, n_valid=n_valid)
        return (load, rep)


class HdrfCarry(PartitionerCarry):
    """HDRF as a carry: (load, counted replica table, partial degrees, λ,
    active-partition mask).  ``k_active < k`` pads the carry as the
    reference's multi-k batches do; K3 scores only the active partitions,
    so the card runs it too."""

    supports_retract = True

    def __init__(self, n_vertices: int, k: int, lam: float = 1.1, *,
                 k_active: int | None = None, device=None):
        self.n_vertices = int(n_vertices)
        self.k = int(k)
        self.lam = float(lam)
        self.k_active = k_active
        self.device = resolve_device(device)

    def init(self):
        return _ref.hdrf_init(self.n_vertices, self.k, self.lam,
                              k_active=self.k_active, device=self.device)

    def step_chunk(self, carry, src, dst, n_valid, *extras):
        return _hdrf_step(carry, src, dst)

    def retract_chunk(self, carry, src, dst, n_valid, parts, *extras):
        load, rep, pd, _, _ = carry
        scoring_scan(src, dst, load, rep, pd, mode="hdrf", sign=-1,
                     parts=parts, n_valid=n_valid)
        return carry


class GridCarry(PartitionerCarry):
    """Grid partitioning as a carry: (load, row/col tables, #cols)."""

    supports_retract = True

    def __init__(self, k: int, row, col, n_cols: int, *, device=None):
        self.k = int(k)
        self.row = row
        self.col = col
        self.n_cols = int(n_cols)
        self.device = resolve_device(device)

    def init(self):
        return _ref.grid_init(self.k, self.row, self.col, self.n_cols,
                              device=self.device)

    def step_chunk(self, carry, src, dst, n_valid, *extras):
        return _grid_step(carry, src, dst)

    def retract_chunk(self, carry, src, dst, n_valid, parts, *extras):
        return _ref.grid_retract_chunk(carry, src, dst, n_valid, parts)
