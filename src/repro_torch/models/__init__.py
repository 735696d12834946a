"""Models of the port.  Ported so far: the shared primitives
(``common``), the GCN of ``gnn``, the dense LM (``lm``, with
``attention``) and xDeepFM (``recsys``); the MoE block, SchNet, EGNN and
DimeNet are not."""

from . import attention, common, gnn, lm, recsys  # noqa: F401
