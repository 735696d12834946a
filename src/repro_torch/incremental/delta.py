"""Delta ingestion: replay only the new edges against a restored carry.

A warm-start replay is function composition: every streaming consumer
folds its carry edge by edge, so ``fold(fold(init, prefix), delta) ==
fold(init, prefix + delta)`` whenever the step closure (degrees, ξ, κ, λ,
grid tables, c2p) is held fixed and padding self-loops are no-ops.
:class:`DeltaStream` wraps an insertion (or deletion) batch as a standard
:class:`~repro_torch.streaming.EdgeStream`, and
:func:`run_incremental_carry` drives any carry over it from a saved carry
instead of ``init()``; on the card each chunk runs in the consumer's
kernel (K1 for Alg. 1, K2 for Alg. 3, K3 and G1 for the scan
partitioners, K4a for the Θ sketch).

:func:`grow_carry` widens a carry to a larger vertex count: new rows are
the identity (unassigned ``-1``, zero counters, volumes and degrees), so
growth commutes with folding; the grid's per-vertex hash tables are
recomputed, and the old prefix's rows come out the same.
"""

from __future__ import annotations

import torch

from ..streaming import EdgeStream, run_carry, run_parallel
from ..streaming.stream import DEFAULT_CHUNK

__all__ = ["DeltaStream", "run_incremental_carry", "grow_carry"]


class DeltaStream(EdgeStream):
    """A churn batch as a standard EdgeStream, tagged ``sign`` ±1.

    ``sign=+1`` (default) is an insertion batch, ``sign=-1`` a deletion
    batch; ``base_offset`` records where the batch sits in the full stream
    (for insertions: the edges ingested before it).  Natural order by
    default: insertion order is the stream order of a dynamic graph."""

    def __init__(self, src, dst, n_vertices: int | None = None, *,
                 base_offset: int = 0, sign: int = +1,
                 chunk_size: int = DEFAULT_CHUNK,
                 ordering: str = "natural", seed: int = 0,
                 window: int = 4096, device=None):
        if base_offset < 0:
            raise ValueError("base_offset must be >= 0")
        if sign not in (+1, -1):
            raise ValueError(f"sign must be +1 or -1, got {sign}")
        super().__init__(src, dst, n_vertices, chunk_size=chunk_size,
                         ordering=ordering, seed=seed, window=window,
                         device=device)
        self.base_offset = int(base_offset)
        self.sign = int(sign)


def run_incremental_carry(stream, pc, *extras, carry, num_streams: int = 1,
                          super_chunk: int | str = 8):
    """Drive ``pc`` over ``stream`` seeded with a restored ``carry``:
    ``(delta_parts | None, pc.finalize(final_carry))``, as ``run_carry``.
    ``num_streams > 1`` shards the delta through ``run_parallel`` with the
    restored carry as the merge base.  The carry's tensors may be updated
    in place."""
    if num_streams > 1:
        return run_parallel(stream, pc, *extras, num_streams=num_streams,
                            super_chunk=super_chunk, carry=carry)
    return run_carry(stream, pc, *extras, carry=carry)


# ---------------------------------------------------------------------------
# vertex-set growth
# ---------------------------------------------------------------------------


def _pad_rows(x: torch.Tensor, n_new: int, fill) -> torch.Tensor:
    if n_new <= x.shape[0]:
        return x
    pad = torch.full((n_new - x.shape[0],) + tuple(x.shape[1:]), fill,
                     dtype=x.dtype, device=x.device)
    return torch.cat([x, pad])


def grow_carry(consumer: str, carry, n_old: int, n_new: int, *,
               k: int | None = None, seed: int = 0):
    """Widen a consumer's carry from ``n_old`` to ``n_new`` vertices.

    Assignment tables pad with ``-1``, counted tables, volumes and degrees
    with ``0``; O(k) and scalar leaves pass through.  ``consumer`` is one
    of greedy, hdrf, grid, cluster, degree, sketch, assign."""
    if n_new < n_old:
        raise ValueError(f"cannot shrink a carry ({n_new} < {n_old})")
    if n_new == n_old:
        return carry
    if consumer == "degree":
        return _pad_rows(carry, n_new, 0)
    if consumer == "greedy":
        load, rep = carry
        return (load, _pad_rows(rep, n_new, 0))
    if consumer == "hdrf":
        load, rep, pd, lam, kmask = carry
        return (load, _pad_rows(rep, n_new, 0), _pad_rows(pd, n_new, 0), lam, kmask)
    if consumer == "grid":
        from ..core.baselines import _grid_dims, _grid_rowcol

        load = carry[0]
        if k is None:
            k = int(load.shape[0])
        _, c = _grid_dims(k)
        row, col = _grid_rowcol(n_new, k, c, seed, load.device)
        return (load, row.to(torch.int32), col.to(torch.int32), carry[3])
    if consumer == "cluster":
        from ..core.clustering import ClusterState

        st = carry
        # the volume arrays end in a sink slot that stays 0: growing keeps
        # it as a regular (zero) cluster slot and appends a fresh sink
        return ClusterState(
            v2c_h=_pad_rows(st.v2c_h, n_new, -1),
            v2c_t=_pad_rows(st.v2c_t, n_new, -1),
            vol_h=_pad_rows(st.vol_h, n_new + 1, 0),
            vol_t=_pad_rows(st.vol_t, n_new + 1, 0),
            ld=_pad_rows(st.ld, n_new, 0),
            next_h=st.next_h, next_t=st.next_t,
            cnt_h=_pad_rows(st.cnt_h, n_new, 0),
            cnt_t=_pad_rows(st.cnt_t, n_new, 0),
            alloc_h=_pad_rows(st.alloc_h, n_new, 0))
    if consumer in ("sketch", "assign"):
        return carry  # no per-vertex state
    raise ValueError(f"unknown consumer {consumer!r}")
