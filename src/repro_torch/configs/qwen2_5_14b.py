"""Qwen2.5-14B: 48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064.

GQA + QKV bias [hf:Qwen/Qwen2.5-0.5B family].  Pure full attention ⇒
long_500k is a documented skip (DESIGN.md §4).

A data copy of ``repro.configs.qwen2_5_14b``.
"""
from ..models.lm import LMConfig
from .base import ArchSpec, LM_SHAPES

ARCH = ArchSpec(
    name="qwen2.5-14b",
    family="lm",
    config=LMConfig(
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
        d_ff=13824, vocab=152064, qkv_bias=True, rope_theta=1e6,
    ),
    smoke_config=LMConfig(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_head=32,
        d_ff=256, vocab=512, qkv_bias=True, rope_theta=1e6, attn_chunk=64,
    ),
    shapes=LM_SHAPES,
    skips={"long_500k": "pure full attention — no sub-quadratic path (DESIGN.md §4)"},
)
