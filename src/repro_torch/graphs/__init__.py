from .datasets import GraphData, cora_like, ogbn_products_like, products_features  # noqa: F401
from .generators import (  # noqa: F401
    block_rmat_graph,
    community_graph,
    erdos_renyi_graph,
    graph_skewness,
    powerlaw_graph,
    rmat_graph,
    toy_graph_fig3,
)
