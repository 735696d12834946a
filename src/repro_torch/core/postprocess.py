"""Edge-placement postprocessing (paper Algorithm 3).

After the game fixes the cluster→partition map ``c2p``, a final streaming
pass assigns every edge under the hard capacity ``L = ⌈τ|E|/k⌉``: when
both endpoint partitions are full, head edges take the first partition
with room and tail edges the last (else the least-loaded); otherwise the
less-loaded endpoint partition (ties to ``P_u``).

On CUDA each chunk runs in the K2 kernel (``kernels/stream_scan``); on the
CPU in :func:`_assign_steps`, a sequential transcription.  The carry is
the ``(k,)`` int32 load vector (merge op SUM, so S lanes place at once
through ``run_parallel``).
"""

from __future__ import annotations

import torch

from ..kernels.stream_scan import kernel as _scan
from ..streaming import SUM, PartitionerCarry, as_stream, run_parallel
from .clustering import _w32

__all__ = ["AssignCarry", "assign_edges", "assign_edges_stream"]


def _assign_steps(load, src, dst, is_head_edge, pcu, pcv, *, max_load: int):
    """Algorithm 3 over one chunk, edge by edge (plain version).

    ``pcu``/``pcv`` are endpoint partition ids.  Self-loops (the chunk's
    padding included) place nothing and get part -1.  Returns
    ``(parts, load)`` as new tensors.
    """
    ld = load.tolist()
    k = len(ld)
    parts = []
    for u, v, head, a, b in zip(src.tolist(), dst.tolist(),
                                is_head_edge.tolist(), pcu.tolist(), pcv.tolist()):
        lu, lv = ld[a], ld[b]
        if lu >= max_load and lv >= max_load:
            room = [j for j in range(k) if ld[j] < max_load]
            if room:
                part = room[0] if head else room[-1]
            else:
                part = min(range(k), key=ld.__getitem__)  # lowest id on ties
        else:
            part = b if lu > lv else a  # lines 9-10: tie -> P_u
        if u != v:
            ld[part] = _w32(ld[part] + 1)
            parts.append(part)
        else:
            parts.append(-1)
    dev = load.device
    return (torch.tensor(parts, dtype=torch.int32, device=dev),
            torch.tensor(ld, dtype=torch.int32, device=dev))


def _assign_chunk(load, max_load, src, dst, is_head_edge, cu, cv, c2p, *, k: int):
    """One streamed chunk of Algorithm 3 (plain).  Returns (load, parts)."""
    parts, load = _assign_steps(load, src, dst, is_head_edge, c2p[cu.long()],
                                c2p[cv.long()], max_load=int(max_load))
    return load, parts


def _retract_load(load, src, dst, n_valid, parts):
    """Exact inverse of a chunk's load accounting (one unit per placed edge)."""
    real = torch.arange(src.shape[0], device=src.device) < n_valid
    w = (real & (src != dst) & (parts >= 0)).to(load.dtype)
    return load - torch.zeros_like(load).index_add_(0, parts.clamp(min=0).long(), w)


class AssignCarry(PartitionerCarry):
    """Algorithm 3 as a carry: the ``(k,)`` load vector.  Per-edge extras
    (head flag, endpoint clusters) ride the chunk; ``c2p`` and the capacity
    are constants.  Each chunk goes through ``assign_scan`` (K2 on CUDA)."""

    supports_retract = True
    retract_exact = True
    merge_ops = (SUM,)

    def __init__(self, k: int, max_load: int, c2p: torch.Tensor):
        self.k = int(k)
        self.max_load = int(max_load)
        self.c2p = c2p.to(torch.int32)

    def init(self) -> torch.Tensor:
        return torch.zeros((self.k,), dtype=torch.int32, device=self.c2p.device)

    def step_chunk(self, carry, src, dst, n_valid, *extras):
        h, a, b = extras
        parts, load = _scan.assign_scan(
            carry, src, dst, h, self.c2p[a.long()], self.c2p[b.long()],
            max_load=self.max_load)
        return load, parts

    def retract_chunk(self, carry, src, dst, n_valid, parts, *extras):
        zeros = torch.zeros_like(src)
        _, load = _scan.assign_scan(carry, src, dst, zeros, zeros, zeros,
                                    max_load=self.max_load, sign=-1,
                                    parts=parts, n_valid=n_valid)
        return load


def assign_edges_stream(src, dst, is_head_edge, cu, cv, c2p, k: int,
                        max_load: int, *, chunk_size: int = 1 << 16,
                        stream=None, num_streams: int = 1, super_chunk=8,
                        shard: str = "range", device=None):
    """Algorithm 3 over the full stream.  Returns (parts (E,), load (k,)).

    The per-edge attributes ride along the stream as extras, so a
    reordered stream keeps them aligned; parts come back in arrival order.
    Runs on ``stream.device`` when a stream is given, else on ``device``.
    ``num_streams > 1`` places S lanes at once (``run_parallel``).
    """
    stream = as_stream(src, dst, stream=stream, chunk_size=chunk_size,
                       device=device)
    pc = AssignCarry(k, max_load, torch.as_tensor(c2p).to(stream.device))
    return run_parallel(stream, pc, is_head_edge, cu, cv,
                        num_streams=num_streams, super_chunk=super_chunk,
                        shard=shard)


def assign_edges(src, dst, is_head_edge, cu, cv, c2p, k: int, max_load: int,
                 *, device=None):
    """Single-shot convenience wrapper (no chunking)."""
    return assign_edges_stream(src, dst, is_head_edge, cu, cv, c2p, k,
                               max_load, chunk_size=max(int(src.shape[0]), 1),
                               device=device)
