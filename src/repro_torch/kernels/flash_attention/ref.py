"""Plain PyTorch versions of K6 (flash attention forward), in the kernel's
grouped layout: q (BK, S, G·hd), k/v (BK, T, hd), positions (BK, S)/(BK, T)
int32, where BK folds (batch, kv head) and the G q-heads of one kv head sit
side by side in q's last axis.

- :func:`attention_ref` is the port of ``repro.kernels.flash_attention.ref
  .attention_ref``: the direct softmax, all in float32.
- :func:`flash_attention_ref` is the blocked online-softmax forward that
  ``repro.kernels.flash_attention.kernel._fa_kernel`` computes, with the
  rounding of the path the JAX LM runs (``repro.models.attention._flash_fwd``):
  q is scaled in float32 and rounded to q's type, the scores and the running
  max/sum are float32, p is rounded to v's type before ``p·v`` (float32
  sums), and the output is rounded to q's type.  The masked score is the
  sentinel −1e30, not −inf: a row masked in every tile so far has
  ``m = −1e30`` and ``exp(s − m) = 1`` there, which the first visible key
  wipes with ``corr = exp(−1e30 − m) = 0``; a row that never sees a key
  returns garbage.  K6 computes this function on the card.  With
  ``return_lse`` it also returns each row's float32 log-sum-exp
  ``m + log(max(l, 1e-30))``, (BK, S·G), as ``_flash_fwd`` returns it.
- :func:`flash_attention_bwd_ref` is the port of the reference's recompute
  backward, ``repro.models.attention._fa_bwd`` (FlashAttention-2), in the
  kernel layout: ``delta = Σ dO·O`` per row in float32; per block of
  ``block_q`` queries × ``block_k`` keys, ``s = (q·k)·scale`` in float32
  (masked to −1e30), ``p = exp(s − lse)``, ``dp = dO·v``,
  ``ds = p·(dp − delta)·scale``; ``dv += p·dO`` with ``p`` rounded to dO's
  type, ``dk += ds·q`` and ``dq += ds·k`` with ``ds`` rounded to the
  inputs' type; float32 sums, each result rounded once to its input's
  type.  The reference pads S and T to whole blocks (queries at position
  −2^30 with ``lse`` 1.0 and zero ``dO``, keys at −2^30); a padded query
  adds ``p·0 = 0`` and a padded key ``exp(−1e30 − lse) = 0``, so here the
  last blocks are short instead.  K6b computes this function on the card.

Masks are built from positions: a key is visible where ``kv_pos >= 0``,
``q_pos − kv_pos >= 0`` (causal) and ``q_pos − kv_pos < window`` (sliding
window), in int32 arithmetic as the reference's.

:func:`kv_tile_classes` is the rule by which K6's bf16 kernel (and K6b's dQ
kernel) sorts its kv tiles into ``SKIP`` (not loaded), ``PARTIAL`` (masked
element by element) and ``FULL`` (every pair visible: no mask), stated in
torch; :func:`row_tile_classes` is the same rule the other way round, by
which K6b's dK/dV kernel sorts the row tiles of each key tile.
"""

from __future__ import annotations

import torch

__all__ = ["attention_ref", "flash_attention_ref", "flash_attention_bwd_ref",
           "kv_tile_classes", "row_tile_classes", "NEG", "SKIP", "PARTIAL", "FULL"]

NEG = -1e30
SKIP, PARTIAL, FULL = 0, 1, 2  # csrc/flash_attention.cu kSkip, kPartial, kFull


def _visible(q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool, window) -> torch.Tensor:
    """(BK, R) × (BK, Tc) → (BK, R, Tc) bool."""
    dp = q_pos[:, :, None] - kv_pos[:, None, :]
    ok = kv_pos[:, None, :] >= 0
    if causal:
        ok = ok & (dp >= 0)
    if window is not None:
        ok = ok & (dp < window)
    return ok


def attention_ref(q, k, v, q_pos, kv_pos, *, causal=True, window=None) -> torch.Tensor:
    """Direct softmax attention in float32; the result in q's type."""
    BK, S, Ghd = q.shape
    hd = k.shape[2]
    g = Ghd // hd
    qh = q.reshape(BK, S * g, hd).float() * (hd ** -0.5)
    s = torch.einsum("bqh,bth->bqt", qh, k.float())
    qp = torch.repeat_interleave(q_pos, g, dim=1)  # (BK, S·g): rows grouped per query
    s = torch.where(_visible(qp, kv_pos, causal, window), s, NEG)
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = p / torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bqt,bth->bqh", p, v.float())
    return out.reshape(BK, S, Ghd).to(q.dtype)


def flash_attention_ref(q, k, v, q_pos, kv_pos, *, causal=True, window=None,
                        block_q: int = 64, block_k: int = 64, return_lse: bool = False):
    """The online-softmax forward over ``block_q`` queries × ``block_k`` keys
    at a time (any S and T: the last blocks may be short); with
    ``return_lse``, ``(out, lse)``."""
    BK, S, Ghd = q.shape
    T, hd = k.shape[1], k.shape[2]
    g = Ghd // hd
    if Ghd != g * hd:
        raise ValueError(f"q's last axis {Ghd} is not a multiple of d_head {hd}")
    scale = hd ** -0.5
    qs = (q.float() * scale).to(q.dtype).reshape(BK, S * g, hd).float()
    qp = torch.repeat_interleave(q_pos, g, dim=1)
    kf, vf = k.float(), v.float()
    out = torch.empty((BK, S * g, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((BK, S * g), dtype=torch.float32, device=q.device) if return_lse else None
    for i0 in range(0, S, block_q):
        rows = slice(i0 * g, min(i0 + block_q, S) * g)
        qb, qpb = qs[:, rows], qp[:, rows]
        R = qb.shape[1]
        m = torch.full((BK, R), NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros((BK, R), dtype=torch.float32, device=q.device)
        acc = torch.zeros((BK, R, hd), dtype=torch.float32, device=q.device)
        for j0 in range(0, T, block_k):
            keys = slice(j0, min(j0 + block_k, T))
            s = torch.einsum("brh,bth->brt", qb, kf[:, keys])
            s = torch.where(_visible(qpb, kv_pos[:, keys], causal, window), s, NEG)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            pv = torch.einsum("brt,bth->brh", p.to(v.dtype).float(), vf[:, keys])
            acc = acc * corr[..., None] + pv
            m = m_new
        out[:, rows] = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
        if return_lse:
            lse[:, rows] = m + torch.log(torch.clamp(l, min=1e-30))
    out = out.reshape(BK, S, Ghd)
    return (out, lse) if return_lse else out


def flash_attention_bwd_ref(q, k, v, out, lse, dout, q_pos, kv_pos, *, causal=True,
                            window=None, block_q: int = 64, block_k: int = 64):
    """(dq, dk, dv) of :func:`flash_attention_ref` for the output gradient
    ``dout`` (like q), from its ``out`` and float32 ``lse`` (BK, S·G); dq
    like q, dk and dv like k and v."""
    BK, S, Ghd = q.shape
    T, hd = k.shape[1], k.shape[2]
    g = Ghd // hd
    scale = hd ** -0.5
    rows_q = q.reshape(BK, S * g, hd)
    rows_g = dout.reshape(BK, S * g, hd)
    delta = torch.sum(rows_g.float() * out.reshape(BK, S * g, hd).float(), dim=-1)
    qp = torch.repeat_interleave(q_pos, g, dim=1)
    dq = torch.zeros((BK, S * g, hd), dtype=torch.float32, device=q.device)
    dk = torch.zeros((BK, T, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros((BK, T, hd), dtype=torch.float32, device=q.device)
    for i0 in range(0, S, block_q):
        rows = slice(i0 * g, min(i0 + block_q, S) * g)
        qb, gb = rows_q[:, rows].float(), rows_g[:, rows].float()
        lb, db, qpb = lse[:, rows], delta[:, rows], qp[:, rows]
        for j0 in range(0, T, block_k):
            keys = slice(j0, min(j0 + block_k, T))
            kb, vb = k[:, keys].float(), v[:, keys].float()
            s = torch.einsum("brh,bth->brt", qb, kb) * scale
            s = torch.where(_visible(qpb, kv_pos[:, keys], causal, window), s, NEG)
            p = torch.exp(s - lb[..., None])
            dp = torch.einsum("brh,bth->brt", gb, vb)
            ds = p * (dp - db[..., None]) * scale
            ds_r = ds.to(k.dtype).float()
            dq[:, rows] += torch.einsum("brt,bth->brh", ds_r, kb)
            dk[:, keys] += torch.einsum("brt,brh->bth", ds.to(q.dtype).float(), qb)
            dv[:, keys] += torch.einsum("brt,brh->bth", p.to(dout.dtype).float(), gb)
    return (dq.reshape(BK, S, Ghd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


def kv_tile_classes(q_pos: torch.Tensor, kv_pos: torch.Tensor, G: int, rows: int, keys: int,
                    causal: bool = True, window=None) -> torch.Tensor:
    """(BK, S) and (BK, T) positions → (BK, ⌈S·G/rows⌉, ⌈T/keys⌉) int8 of
    ``SKIP``, ``PARTIAL`` or ``FULL``, for q tiles of ``rows`` flattened
    (query, head) rows and kv tiles of ``keys`` keys (keys past T are
    padding, position −1).  With [qmin, qmax] the positions of a q tile's
    rows below S·G: a kv tile is SKIP where no key is valid and inside
    [qmin − window + 1, qmax]; FULL where every key is valid, the largest
    key ≤ qmin (causal) and qmax − the smallest < window; else PARTIAL.
    Positions lie in [−2^30, 2^30), where these bounds need no wrap."""
    BK, S = q_pos.shape
    T = kv_pos.shape[1]
    nq, nk = -(-S * G // rows), -(-T // keys)
    big = 2**40
    qp = torch.repeat_interleave(q_pos.long(), G, dim=1)
    qp_lo = torch.full((BK, nq * rows), big, dtype=torch.int64, device=qp.device)
    qp_hi = torch.full((BK, nq * rows), -big, dtype=torch.int64, device=qp.device)
    qp_lo[:, :S * G] = qp
    qp_hi[:, :S * G] = qp
    qmin = qp_lo.view(BK, nq, rows).amin(-1)[:, :, None]  # (BK, nq, 1)
    qmax = qp_hi.view(BK, nq, rows).amax(-1)[:, :, None]
    kp = torch.full((BK, nk * keys), -1, dtype=torch.int64, device=kv_pos.device)
    kp[:, :T] = kv_pos.long()
    kp = kp.view(BK, nk, keys)
    valid = kp >= 0
    seen = valid[:, None]  # (BK, 1, nk, keys): could a row of the q tile see the key?
    if causal:
        seen = seen & (qmax[..., None] - kp[:, None] >= 0)
    if window is not None:
        seen = seen & (qmin[..., None] - kp[:, None] < window)
    kmin = torch.where(valid, kp, big).amin(-1)[:, None]  # (BK, 1, nk)
    kmax = torch.where(valid, kp, -big).amax(-1)[:, None]
    full = valid.all(-1)[:, None].expand(BK, nq, nk)
    if causal:
        full = full & (kmax <= qmin)
    if window is not None:
        full = full & (qmax - kmin < window)
    cls = torch.full((BK, nq, nk), PARTIAL, dtype=torch.int8, device=q_pos.device)
    cls[full] = FULL
    cls[~seen.any(-1)] = SKIP
    return cls


def row_tile_classes(q_pos: torch.Tensor, kv_pos: torch.Tensor, G: int, rows: int, keys: int,
                     causal: bool = True, window=None) -> torch.Tensor:
    """(BK, S) and (BK, T) positions → (BK, ⌈T/keys⌉, ⌈S·G/rows⌉) int8 of
    ``SKIP``, ``PARTIAL`` or ``FULL``, for key tiles of ``keys`` keys (keys
    past T are padding, position −1) and row tiles of ``rows`` flattened
    (query, head) rows (rows past S·G are not rows).  With [kmin, kmax] the
    positions of a key tile's valid keys: a row tile is SKIP where the key
    tile has no valid key or no row of it lies in [kmin, kmax + window − 1]
    (the causal bound from kmin, the window's from kmax); FULL where every
    key is valid, the smallest row position ≥ kmax (causal) and the largest
    − kmin < window; else PARTIAL."""
    BK, S = q_pos.shape
    T = kv_pos.shape[1]
    nq, nk = -(-S * G // rows), -(-T // keys)
    big = 2**40
    qp = torch.repeat_interleave(q_pos.long(), G, dim=1)
    qv = torch.zeros((BK, nq * rows), dtype=torch.bool, device=qp.device)
    qv[:, :S * G] = True
    qpad = torch.zeros((BK, nq * rows), dtype=torch.int64, device=qp.device)
    qpad[:, :S * G] = qp
    qpad, qv = qpad.view(BK, 1, nq, rows), qv.view(BK, 1, nq, rows)
    kp = torch.full((BK, nk * keys), -1, dtype=torch.int64, device=kv_pos.device)
    kp[:, :T] = kv_pos.long()
    kp = kp.view(BK, nk, keys)
    valid = kp >= 0
    kmin = torch.where(valid, kp, big).amin(-1)[:, :, None, None]  # (BK, nk, 1, 1)
    kmax = torch.where(valid, kp, -big).amax(-1)[:, :, None, None]
    seen = qv & valid.any(-1)[:, :, None, None]  # (BK, nk, nq, rows): could the row see a key?
    if causal:
        seen = seen & (qpad - kmin >= 0)
    if window is not None:
        seen = seen & (qpad - kmax < window)
    qmin = torch.where(qv, qpad, big).amin(-1)  # (BK, 1, nq)
    qmax = torch.where(qv, qpad, -big).amax(-1)
    kmin, kmax = kmin[..., 0], kmax[..., 0]
    full = valid.all(-1)[:, :, None].expand(BK, nk, nq)
    if causal:
        full = full & (qmin >= kmax)
    if window is not None:
        full = full & (qmax - kmin < window)
    cls = torch.full((BK, nk, nq), PARTIAL, dtype=torch.int8, device=q_pos.device)
    cls[full] = FULL
    cls[~seen.any(-1)] = SKIP
    return cls
