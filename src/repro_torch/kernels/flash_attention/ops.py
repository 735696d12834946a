"""Model layout ↔ kernel layout around K6: the counterpart of
``repro.kernels.flash_attention.ops.flash_attention_tpu``.

``flash_attention(q, k, v, q_pos, kv_pos, *, causal, window)`` takes q
(B, S, H, hd), k/v (B, T, KV, hd) and positions (B, S)/(B, T) (or already
repeated per kv head, (B·KV, S)/(B·KV, T)).  It folds (B, KV), groups the
G = H/KV q-heads of each kv head into q's last axis, repeats the positions
per kv head, runs :func:`.kernel.flash_attention_fwd` (K6 on the card, its
plain version on the CPU) and unfolds the result to (B, S, H, hd).  S and T
pass unpadded: K6 masks the ragged tails of its last tiles itself.
"""

from __future__ import annotations

import torch

from .kernel import flash_attention_fwd

__all__ = ["flash_attention"]


def _fold_pos(pos: torch.Tensor, B: int, KV: int) -> torch.Tensor:
    """(B, n) → (B·KV, n), row b·KV + h = row b (an expand: a
    ``repeat_interleave`` would synchronise with the card for its size)."""
    pos = pos.to(torch.int32)
    if pos.shape[0] == B:
        pos = pos[:, None].expand(B, KV, pos.shape[1]).reshape(B * KV, pos.shape[1])
    return pos.contiguous()


def flash_attention(q, k, v, q_pos, kv_pos, *, causal: bool = True, window=None,
                    block_q: int = 64, block_k: int = 64) -> torch.Tensor:
    """(B, S, H, hd) q, (B, T, KV, hd) k and v → (B, S, H, hd).  ``block_q``
    and ``block_k`` block the plain version on the CPU; K6 tiles by itself."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    if H % KV:
        raise ValueError(f"{H} q heads do not group over {KV} kv heads")
    G = H // KV
    qk = q.reshape(B, S, KV, G, hd).permute(0, 2, 1, 3, 4).reshape(B * KV, S, G * hd)
    kk = k.permute(0, 2, 1, 3).reshape(B * KV, T, hd)
    vk = v.permute(0, 2, 1, 3).reshape(B * KV, T, hd)
    qp, kp = _fold_pos(q_pos, B, KV), _fold_pos(kv_pos, B, KV)
    out = flash_attention_fwd(qk.contiguous(), kk.contiguous(), vk.contiguous(), qp, kp,
                              causal=causal, window=window, block_q=block_q, block_k=block_k)
    return out.reshape(B, KV, S, G, hd).permute(0, 2, 1, 3, 4).reshape(B, S, H, hd)
