"""Llama-3-8B: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.

GQA, 128k vocab [arXiv:2407.21783].  Full attention ⇒ long_500k skipped.

A data copy of ``repro.configs.llama3_8b``.
"""
from ..models.lm import LMConfig
from .base import ArchSpec, LM_SHAPES

ARCH = ArchSpec(
    name="llama3-8b",
    family="lm",
    config=LMConfig(
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
        d_ff=14336, vocab=128256, rope_theta=5e5,
    ),
    smoke_config=LMConfig(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_head=32,
        d_ff=256, vocab=512, rope_theta=5e5, attn_chunk=64,
    ),
    shapes=LM_SHAPES,
    skips={"long_500k": "pure full attention — no sub-quadratic path (DESIGN.md §4)"},
)
