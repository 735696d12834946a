"""Attention of the LM (port of ``repro.models.attention``).

- :func:`flash_attention`: the blocked online-softmax forward of
  ``_flash_fwd`` and its recompute gradient ``_fa_bwd`` (the reference's
  ``jax.custom_vjp``), one ``torch.autograd.Function``.  On the card the
  forward is K6 (``kernels.flash_attention``, one launch per call, writing
  the log-sum-exp too when a gradient is wanted) and the backward K6b; on
  the CPU they are the plain versions, ``flash_attention_ref`` and
  ``flash_attention_bwd_ref``, blocked by ``q_chunk``/``kv_chunk`` as the
  reference is.
- :func:`decode_attention`: one query against a (possibly rolling) cache, a
  direct softmax in plain torch on both devices, as the reference computes
  it outside any kernel.
- :func:`_mask`: visibility from positions.

Shapes: q (B, S, H, hd); k/v (B, T, KV, hd); H = KV·G.  Positions: q_pos
(B, S); kv_pos (B, T); ``kv_pos < 0`` ⇒ masked (padding).  The masked score
is the sentinel −1e30, not −inf (see ``kernels/flash_attention/ref.py``).
"""

from __future__ import annotations

import torch

from ..kernels.flash_attention import ops as fa_ops

__all__ = ["flash_attention", "decode_attention"]

_NEG = -1e30


def _mask(q_pos_blk, kv_pos_blk, causal, window):
    """(B, Sq) × (B, Tc) → (B, Sq, Tc) bool."""
    dp = q_pos_blk[:, :, None] - kv_pos_blk[:, None, :]
    ok = kv_pos_blk[:, None, :] >= 0
    if causal:
        ok = ok & (dp >= 0)
    if window is not None:
        ok = ok & (dp < window)
    return ok


def flash_attention(q, k, v, q_pos, kv_pos, causal=True, window=None,
                    q_chunk=512, kv_chunk=1024) -> torch.Tensor:
    """(B, S, H, hd) → (B, S, H, hd) of q's type, through
    ``kernels.flash_attention.ops``: K6 (backward K6b) on CUDA tensors (the
    chunks do not apply: the kernels tile by themselves), the plain
    versions blocked by ``q_chunk``/``kv_chunk`` on CPU tensors."""
    return fa_ops.flash_attention(q, k, v, q_pos, kv_pos, causal=causal, window=window,
                                  block_q=q_chunk, block_k=kv_chunk)


def decode_attention(q, k, v, q_pos, kv_pos, *, causal=True, window=None) -> torch.Tensor:
    """Single-query attention against a (possibly rolling) cache.

    q: (B, 1, H, hd); k/v: (B, T, KV, hd); a direct softmax over the (B, H, T)
    scores: q is scaled in its own type, scores and softmax are float32, p
    is rounded to v's type before ``p·v`` (float32 sums), as the reference.
    Plain torch on both devices (serving never differentiates it).
    """
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd) * (hd ** -0.5)
    s = torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float())
    ok = _mask(q_pos, kv_pos, causal, window)
    s = torch.where(ok[:, None, None], s, _NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", p.to(v.dtype).float(), v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)
