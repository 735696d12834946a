"""Models of the port.  Ported so far: the shared primitives
(``common``) and the GCN of ``gnn``; the LM, recsys, SchNet, EGNN and
DimeNet models are not."""

from . import common, gnn  # noqa: F401
