"""Models of the port.  Ported so far: the shared primitives
(``common``), the GCN of ``gnn``, and the dense LM (``lm``, with
``attention``); the MoE block, recsys, SchNet, EGNN and DimeNet are not."""

from . import attention, common, gnn, lm  # noqa: F401
