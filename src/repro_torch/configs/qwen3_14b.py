"""Qwen3-14B: 40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936.

qk_norm + GQA [hf:Qwen/Qwen3-8B family].  Full attention ⇒ long_500k skip.

A data copy of ``repro.configs.qwen3_14b``.
"""
from ..models.lm import LMConfig
from .base import ArchSpec, LM_SHAPES

ARCH = ArchSpec(
    name="qwen3-14b",
    family="lm",
    config=LMConfig(
        n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
        d_ff=17408, vocab=151936, qk_norm=True, rope_theta=1e6,
    ),
    smoke_config=LMConfig(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_head=32,
        d_ff=256, vocab=512, qk_norm=True, rope_theta=1e6, attn_chunk=64,
    ),
    shapes=LM_SHAPES,
    skips={"long_500k": "pure full attention — no sub-quadratic path (DESIGN.md §4)"},
)
