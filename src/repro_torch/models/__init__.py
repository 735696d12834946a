"""Models of the port: the shared primitives (``common``), the GNNs of
``gnn`` (GCN, SchNet, EGNN, DimeNet), the dense and MoE LM (``lm``, with
``attention``) and xDeepFM (``recsys``)."""

from . import attention, common, gnn, lm, recsys  # noqa: F401
