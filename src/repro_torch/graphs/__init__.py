from .datasets import (  # noqa: F401
    GraphData,
    MoleculeBatch,
    cora_like,
    molecule_batch,
    ogbn_products_like,
    products_features,
)
from .generators import (  # noqa: F401
    block_rmat_graph,
    community_graph,
    erdos_renyi_graph,
    graph_skewness,
    powerlaw_graph,
    rmat_graph,
    toy_graph_fig3,
)
from .sampler import CSRGraph, NeighborSampler, SampledSubgraph, build_csr  # noqa: F401
