"""Scan drivers: thread a carry through EdgeStream chunks.

:func:`run_carry` drives one :class:`~repro_torch.streaming.carry.
PartitionerCarry` over a stream in order; ``run_parallel``
(:mod:`.parallel`) drives it over S lanes.  :func:`run_retract` drives a
consumer's retraction (sharded through
:class:`~repro_torch.streaming.carry.RetractCarry` when asked).
:func:`run_scan` is the ``(carry0, chunk_fn)`` surface;
:func:`run_scan_batched` steps one chunk function over every row of a
stacked carry (seeds, λ values, padded partition counts), reading the
stream once.
"""

from __future__ import annotations

from typing import Callable

import torch

from .carry import FnCarry, PartitionerCarry, tree_flatten, tree_unflatten
from .stream import DEFAULT_CHUNK, EdgeStream

__all__ = ["as_stream", "run_carry", "run_retract", "run_scan",
           "run_scan_batched", "stack_carries"]


def as_stream(src, dst, n_vertices=None, *, stream=None, chunk_size=None,
              device=None) -> EdgeStream:
    """Normalize (arrays | existing stream) to an :class:`EdgeStream`."""
    if stream is not None:
        return stream
    return EdgeStream(src, dst, n_vertices,
                      chunk_size=chunk_size or DEFAULT_CHUNK, device=device)


def run_carry(stream: EdgeStream, pc: PartitionerCarry, *extras, carry=None):
    """Drive ``pc`` over every chunk of ``stream``.

    Returns ``(parts, result)``: ``parts`` in arrival order (``None`` for
    state-only consumers) and ``result = pc.finalize(final_carry)``.
    A given ``carry`` may be updated in place.
    """
    if carry is None:
        carry = pc.init()
    outs = []
    for ch in stream.chunks(*extras):
        carry, parts = pc.step_chunk(carry, ch.src, ch.dst, ch.n_valid,
                                     *ch.extras)
        if parts is not None:
            outs.append(parts[: ch.n_valid])
    result = pc.finalize(carry)
    if not outs:
        return None, result
    parts = outs[0] if len(outs) == 1 else torch.cat(outs)
    return stream.scatter_back(parts), result


def run_retract(stream: EdgeStream, pc: PartitionerCarry, parts, *extras,
                carry, num_streams: int = 1, super_chunk: int | str = 8,
                shard: str = "range", backend=None, mesh=None):
    """Drive ``pc.retract_chunk`` over every chunk of ``stream``.

    ``stream`` holds the edges being deleted and ``parts`` their recorded
    per-edge results (``None`` for state-only consumers).  With
    ``num_streams > 1`` (or a ``backend``) the batch shards through
    ``run_parallel`` as a :class:`~repro_torch.streaming.carry.RetractCarry`
    fold, bit-identical to the sequential drive (retraction only
    subtracts on group leaves).  Returns the retracted carry (not
    finalized)."""
    if num_streams > 1 or backend is not None or mesh is not None:
        from .carry import RetractCarry
        from .parallel import run_parallel

        adapter = RetractCarry(pc, with_parts=parts is not None)
        first = () if parts is None else (parts,)
        _, carry = run_parallel(stream, adapter, *first, *extras,
                                num_streams=num_streams,
                                super_chunk=super_chunk, shard=shard,
                                backend=backend, mesh=mesh, carry=carry)
        return carry
    if parts is None:
        for ch in stream.chunks(*extras):
            carry = pc.retract_chunk(carry, ch.src, ch.dst, ch.n_valid, None,
                                     *ch.extras)
        return carry
    for ch in stream.chunks(parts, *extras):
        carry = pc.retract_chunk(carry, ch.src, ch.dst, ch.n_valid,
                                 ch.extras[0], *ch.extras[1:])
    return carry


def run_scan(stream: EdgeStream, carry, chunk_fn: Callable, *extras):
    """``chunk_fn(carry, src, dst, *extras) -> (carry, parts)`` over every
    chunk; returns ``(parts in arrival order, final carry)``."""
    return run_carry(stream, FnCarry(carry, chunk_fn), *extras)


def stack_carries(carries):
    """Stack per-scenario carries of one structure: tensor leaves along a
    new leading axis; every other leaf must be equal in all of them and
    stays shared."""
    flats = [tree_flatten(c) for c in carries]
    spec = flats[0][1]
    out = []
    for leaves in zip(*(f[0] for f in flats)):
        if isinstance(leaves[0], torch.Tensor):
            out.append(torch.stack(leaves))
        elif any(x != leaves[0] for x in leaves[1:]):
            raise ValueError("non-tensor carry leaves must agree across the batch")
        else:
            out.append(leaves[0])
    return tree_unflatten(spec, out)


def rows_of(stacked) -> list:
    """The rows of a stacked carry: views of each tensor leaf's rows, the
    other leaves shared."""
    flat, spec = tree_flatten(stacked)
    n_rows = next(x.shape[0] for x in flat if isinstance(x, torch.Tensor))
    return [tree_unflatten(spec, [x[b] if isinstance(x, torch.Tensor) else x
                                  for x in flat]) for b in range(n_rows)]


def write_row(row, new) -> None:
    """Copy a step's result into the row views it was handed, where the
    step returned new tensors instead of updating in place."""
    for r, n in zip(tree_flatten(row)[0], tree_flatten(new)[0]):
        if isinstance(r, torch.Tensor) and n is not r:
            r.copy_(n)


def run_scan_batched(stream: EdgeStream, carries, chunk_fn: Callable, *extras):
    """Batched ``run_scan``: ``carries`` has a leading batch axis on every
    tensor leaf (:func:`stack_carries`); each chunk is read once and
    ``chunk_fn`` steps it over every row, in row order.  Returns
    ``(parts (B, E) in arrival order, final carries)``."""
    rows = rows_of(carries)
    outs = []
    for ch in stream.chunks(*extras):
        chunk_parts = []
        for row in rows:
            new, parts = chunk_fn(row, ch.src, ch.dst, *ch.extras)
            write_row(row, new)
            chunk_parts.append(parts[: ch.n_valid])
        outs.append(torch.stack(chunk_parts))
    parts = outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)
    return stream.scatter_back(parts), carries
