"""PartitionerCarry — the carry protocol every streaming consumer speaks.

A streaming partitioner is an ``init / step_chunk / retract_chunk /
finalize`` quadruple over an O(|V| + k) carry:

- ``init()``          — the identity carry (empty tables, zero loads);
- ``step_chunk``      — fold one EdgeStream chunk into the carry and
  optionally emit per-edge results (``parts``) for that chunk;
- ``retract_chunk``   — undo the accounting ``step_chunk`` did for these
  edges, given their recorded ``parts``;
- ``finalize``        — extract the consumer-facing result.

The merge algebra of ``repro.streaming.carry`` (parallel ingest) is not
ported yet.
"""

from __future__ import annotations

__all__ = ["PartitionerCarry"]


class PartitionerCarry:
    """Base class: implement ``init`` and ``step_chunk``.

    ``step_chunk(carry, src, dst, n_valid, *extras) -> (carry, parts)``;
    ``n_valid`` is the chunk's unpadded length (padding entries are (0, 0)
    self-loops).  ``parts`` is the per-edge result, or ``None`` for
    state-only consumers (clustering, the Θ pass).  The port's carries
    may update the carry's tensors in place and return them.
    """

    #: False for state-only consumers whose step_chunk returns parts=None
    emits_parts: bool = True

    #: True once the consumer implements :meth:`retract_chunk`
    supports_retract: bool = False

    def init(self):
        raise NotImplementedError

    def step_chunk(self, carry, src, dst, n_valid, *extras):
        raise NotImplementedError

    def retract_chunk(self, carry, src, dst, n_valid, parts, *extras):
        """Subtract what ``step_chunk`` added for the first ``n_valid``
        entries of this chunk, given their recorded ``parts``."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support edge deletion")

    def finalize(self, carry):
        return carry
