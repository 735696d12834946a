"""EGNN: n_layers=4 d_hidden=64, E(n)-equivariant [arXiv:2102.09844]."""
from ..models.gnn import EGNNConfig
from .base import ArchSpec, GNN_SHAPES

ARCH = ArchSpec(
    name="egnn",
    family="gnn",
    config=EGNNConfig(n_layers=4, d_hidden=64),
    smoke_config=EGNNConfig(n_layers=2, d_hidden=16),
    shapes=GNN_SHAPES,
)
