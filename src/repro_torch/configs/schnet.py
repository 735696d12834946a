"""SchNet: n_interactions=3 d_hidden=64 rbf=300 cutoff=10 [arXiv:1706.08566]."""
from ..models.gnn import SchNetConfig
from .base import ArchSpec, GNN_SHAPES

ARCH = ArchSpec(
    name="schnet",
    family="gnn",
    config=SchNetConfig(n_interactions=3, d_hidden=64, n_rbf=300, cutoff=10.0),
    smoke_config=SchNetConfig(n_interactions=2, d_hidden=16, n_rbf=16, cutoff=10.0),
    shapes=GNN_SHAPES,
    notes="non-molecular shapes use synthetic 3-D positions (point-cloud reading)",
)
