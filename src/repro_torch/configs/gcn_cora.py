"""GCN (Cora): 2 layers d_hidden=16 sym-normalized mean agg [arXiv:1609.02907]."""
from ..models.gnn import GCNConfig
from .base import ArchSpec, GNN_SHAPES

ARCH = ArchSpec(
    name="gcn-cora",
    family="gnn",
    config=GCNConfig(n_layers=2, d_hidden=16, d_feat=1433, n_classes=7),
    smoke_config=GCNConfig(n_layers=2, d_hidden=8, d_feat=32, n_classes=4),
    shapes=GNN_SHAPES,
)
