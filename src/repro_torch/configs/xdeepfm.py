"""xDeepFM: 39 sparse fields, embed_dim=10, CIN 200-200-200, MLP 400-400
[arXiv:1803.05170].

A data copy of ``repro.configs.xdeepfm``.
"""
from ..models.recsys import XDeepFMConfig
from .base import ArchSpec, RECSYS_SHAPES

ARCH = ArchSpec(
    name="xdeepfm",
    family="recsys",
    config=XDeepFMConfig(n_fields=39, embed_dim=10, cin_layers=(200, 200, 200),
                         mlp_dims=(400, 400)),
    smoke_config=XDeepFMConfig(n_fields=6, embed_dim=4, cin_layers=(8, 8),
                               mlp_dims=(16, 16),
                               field_vocabs=(64, 32, 32, 16, 16, 16)),
    shapes=RECSYS_SHAPES,
)
