"""Mixtral-8x7B: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000,
MoE 8 experts top-2, sliding-window attention [arXiv:2401.04088].

SWA ⇒ long_500k RUNS (rolling window-sized KV cache).

A data copy of ``repro.configs.mixtral_8x7b``.
"""
from ..models.lm import LMConfig
from .base import ArchSpec, LM_SHAPES

ARCH = ArchSpec(
    name="mixtral-8x7b",
    family="lm",
    config=LMConfig(
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
        d_ff=14336, vocab=32000, sliding_window=4096, n_experts=8, top_k=2,
        rope_theta=1e6,
    ),
    smoke_config=LMConfig(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_head=32,
        d_ff=256, vocab=512, sliding_window=32, n_experts=4, top_k=2,
        rope_theta=1e6, attn_chunk=64,
    ),
    shapes=LM_SHAPES,
)
