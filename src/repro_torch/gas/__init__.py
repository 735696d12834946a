"""The GAS (gather-apply-scatter) engine of the port: PageRank and label
propagation over a vertex cut, with exact mirror-sync accounting."""

from .engine import (  # noqa: F401
    CommStats,
    GASGraph,
    build_gas_graph,
    carry_values,
    comm_stats,
    label_propagation,
    label_propagation_step,
    out_degree_inv,
    pagerank,
    pagerank_step,
)
