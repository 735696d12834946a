"""DimeNet: n_blocks=6 d_hidden=128 bilinear=8 spherical=7 radial=6
[arXiv:2003.03123].  Triplet lists are capped at 2·|E| for the large
full-graph shapes and at 4·|E| for molecules (a budgeted gather)."""
from ..models.gnn import DimeNetConfig
from .base import ArchSpec, GNN_SHAPES

ARCH = ArchSpec(
    name="dimenet",
    family="gnn",
    config=DimeNetConfig(n_blocks=6, d_hidden=128, n_bilinear=8,
                         n_spherical=7, n_radial=6),
    smoke_config=DimeNetConfig(n_blocks=2, d_hidden=16, n_bilinear=4,
                               n_spherical=3, n_radial=4),
    shapes=GNN_SHAPES,
)
