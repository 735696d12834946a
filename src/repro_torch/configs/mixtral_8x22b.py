"""Mixtral-8x22B: 56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768,
MoE 8 experts top-2, sliding-window attention [arXiv:2401.04088].

A data copy of ``repro.configs.mixtral_8x22b``.
"""
from ..models.lm import LMConfig
from .base import ArchSpec, LM_SHAPES

ARCH = ArchSpec(
    name="mixtral-8x22b",
    family="lm",
    config=LMConfig(
        n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
        d_ff=16384, vocab=32768, sliding_window=4096, n_experts=8, top_k=2,
        rope_theta=1e6,
    ),
    smoke_config=LMConfig(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_head=32,
        d_ff=256, vocab=512, sliding_window=32, n_experts=4, top_k=2,
        rope_theta=1e6, attn_chunk=64,
    ),
    shapes=LM_SHAPES,
)
