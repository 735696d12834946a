"""Scan drivers: thread a carry through EdgeStream chunks, in order."""

from __future__ import annotations

import torch

from .carry import PartitionerCarry
from .stream import DEFAULT_CHUNK, EdgeStream

__all__ = ["as_stream", "run_carry", "run_retract"]


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
                carry):
    """Drive ``pc.retract_chunk`` over every chunk of ``stream``.

    ``stream`` holds the edges being deleted and ``parts`` their recorded
    per-edge results (``None`` for state-only consumers).  Returns the
    retracted carry (not finalized)."""
    if parts is None:
        for ch in stream.chunks(*extras):
            carry = pc.retract_chunk(carry, ch.src, ch.dst, ch.n_valid, None,
                                     *ch.extras)
        return carry
    for ch in stream.chunks(parts, *extras):
        carry = pc.retract_chunk(carry, ch.src, ch.dst, ch.n_valid,
                                 ch.extras[0], *ch.extras[1:])
    return carry
