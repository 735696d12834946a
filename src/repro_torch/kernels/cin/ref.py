"""Plain PyTorch version of K7, the xDeepFM CIN layer, and an emulation of
K7's arithmetic.

``out[b, n, d] = Σ_{h<Hk, j<m} w[h·m + j, n] · xk[b, h, d] · x0[b, j, d]``:
the outer product ``z = xk[:, :, None, :] · x0[:, None, :, :]`` along the
fields, flattened to ``(B, Hk·m, D)`` and contracted with ``w`` (a 1×1
convolution).  :func:`cin_layer_ref` works in float32 whatever the input
type, as the Pallas kernel ``repro.kernels.cin.kernel._cin_kernel`` casts
(``kernel.py:25-32``): ``z`` is the float32 product, the sums are float32,
and the result is rounded once to ``xk``'s type.  ``z`` is formed ``chunk``
samples at a time, so the plain version's memory stays bounded at any batch.

:func:`cin_layer_bwd_ref` is the layer's gradient for an output gradient
``g`` (B, H', D), the three einsums in float32 (``t = w·g`` per sample,
then ``dxk = Σ_j t·x0``, ``dx0 = Σ_h t·xk``, ``dw = Σ_{b,d} z·g`` with
``z`` the float32 outer product), each result rounded once to its input's
type: the function K7b computes on the card.

:func:`cin_split_partials` follows the tensor-core kernel (``csrc/cin.cu``)
step by step, for the tests and ``chip_smoke.py`` (nothing on the main path
calls it): the fields padded with zeros to ``pad_fields(m)``, the k order
(h, then j), stages of ``STAGE_K`` k values, each stage's products summed
apart (in float64 here: the tensor cores' own order cannot be repeated)
and added in order to a float32 sum, one sum per split of the stages.  The
products: in float32 ``z`` and ``w`` split into TF32 ``hi + lo`` with
round-to-nearest, ties away (``cvt.rna.tf32.f32``), and
``hi·w_lo + lo·w_hi + hi·w_hi``; in bfloat16 ``z = z_hi + z_lo``, two bf16
values (exact: a product of two bf16 values has at most 16 significant
bits), times ``w``.

:func:`cin_bwd_split_partials` follows K7b (``csrc/cin_bwd.cu``) the same
way: ``t = g·wᵀ`` in stages of 32 channels and ``dw = zᵀ·g`` in stages of
32 rows of each of ``splits`` fixed cuts of the B·D rows
(:func:`bwd_split_row`), every operand split into TF32 ``hi + lo``, each
stage's ``hi·lo + lo·hi + hi·hi`` summed apart (float64 here) and added in
order to a float32 sum; ``dxk`` and ``dx0`` from ``t`` in float32; the
splits' partials of ``dw`` added in split order.
"""

from __future__ import annotations

import torch

__all__ = ["cin_layer_ref", "cin_layer_bwd_ref", "cin_split_partials", "cin_bwd_split_partials",
           "bwd_split_row", "pad_fields",
           "stage_range", "tf32_rna", "STAGE_K"]

_Z_ELEMS = 1 << 26  # float32 elements of z alive at once
_EMU_ELEMS = 1 << 24  # and in the emulation, which keeps four float64 copies

# k values of one stage of the kernel's ring (one 128-byte row of w's copy)
STAGE_K = {torch.float32: 32, torch.bfloat16: 64}


def cin_layer_ref(xk: torch.Tensor, x0: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, Hk, D) ``xk``, (B, m, D) ``x0``, (Hk·m, H') ``w`` → (B, H', D)
    of ``xk.dtype``."""
    B, Hk, D = xk.shape
    m = x0.shape[1]
    wf = w.float()
    out = torch.empty((B, w.shape[1], D), dtype=xk.dtype, device=xk.device)
    chunk = max(1, _Z_ELEMS // max(1, Hk * m * D))
    for b0 in range(0, B, chunk):
        b1 = min(B, b0 + chunk)
        z = xk[b0:b1, :, None, :].float() * x0[b0:b1, None, :, :].float()
        z = z.reshape(b1 - b0, Hk * m, D)
        out[b0:b1] = torch.einsum("bzd,zn->bnd", z, wf).to(xk.dtype)
    return out


def cin_layer_bwd_ref(xk: torch.Tensor, x0: torch.Tensor, w: torch.Tensor, g: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dxk, dx0, dw)`` of :func:`cin_layer_ref` for the output gradient
    ``g`` (B, H', D), each of its input's type."""
    B, Hk, D = xk.shape
    m = x0.shape[1]
    wf = w.float().reshape(Hk, m, w.shape[1])
    dxk = torch.empty_like(xk)
    dx0 = torch.empty_like(x0)
    dw = torch.zeros(wf.shape, dtype=torch.float32, device=w.device)
    chunk = max(1, _Z_ELEMS // max(1, Hk * m * D))
    for b0 in range(0, B, chunk):
        b1 = min(B, b0 + chunk)
        xkf, x0f, gf = xk[b0:b1].float(), x0[b0:b1].float(), g[b0:b1].float()
        t = torch.einsum("hjn,bnd->bhjd", wf, gf)
        dxk[b0:b1] = torch.einsum("bhjd,bjd->bhd", t, x0f).to(xk.dtype)
        dx0[b0:b1] = torch.einsum("bhjd,bhd->bjd", t, xkf).to(x0.dtype)
        del t
        z = xkf[:, :, None, :] * x0f[:, None, :, :]
        dw += torch.einsum("bhjd,bnd->hjn", z, gf)
    return dxk, dx0, dw.reshape(w.shape).to(w.dtype)


def pad_fields(m: int) -> int:
    """The kernel's fields per h: ``m`` rounded up to 8, so that a k step of
    8 lies in one h."""
    return -(-m // 8) * 8


def stage_range(k_stages: int, splits: int, split: int) -> tuple[int, int]:
    """The stages ``[t0, t1)`` of one split, as the kernel cuts them."""
    return split * k_stages // splits, (split + 1) * k_stages // splits


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """The nearest TF32 value of each float32 (ties away from zero), as
    ``cvt.rna.tf32.f32``: half a TF32 ulp added to the magnitude's bits, the
    low 13 bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _padded(xk, x0, w, kc):
    """z as (rows = B·D, K) and w as (K, H'), both float32, in the kernel's k
    order with zero fields up to ``pad_fields(m)`` and zero k up to a whole
    number of stages."""
    B, Hk, D = xk.shape
    m, Hn = x0.shape[1], w.shape[1]
    mp = pad_fields(m)
    k_pad = -(-Hk * mp // kc) * kc
    z = torch.zeros((B, Hk, mp, D), dtype=torch.float32, device=xk.device)
    z[:, :, :m] = xk[:, :, None, :].float() * x0[:, None, :, :].float()
    z = z.reshape(B, Hk * mp, D).permute(0, 2, 1).reshape(B * D, Hk * mp)
    z = torch.nn.functional.pad(z, (0, k_pad - Hk * mp))
    wp = torch.zeros((Hk, mp, Hn), dtype=torch.float32, device=w.device)
    wp[:, :m] = w.float().reshape(Hk, m, Hn)
    wp = torch.nn.functional.pad(wp.reshape(Hk * mp, Hn), (0, 0, 0, k_pad - Hk * mp))
    return z, wp


def cin_split_partials(xk: torch.Tensor, x0: torch.Tensor, w: torch.Tensor,
                       splits: int = 1) -> list[torch.Tensor]:
    """K7's float32 partial sums, one (B, H', D) tensor per split of the
    stages; their sum in split order, rounded to ``xk``'s type, is K7's
    result up to the order of the sums inside a stage."""
    B, Hk, D = xk.shape
    m, Hn = x0.shape[1], w.shape[1]
    kc = STAGE_K[xk.dtype]
    k_stages = -(-Hk * pad_fields(m) // kc)
    if not 1 <= splits <= max(1, k_stages):
        raise ValueError(f"{splits} splits of {k_stages} stages")
    parts = [torch.zeros((B, Hn, D), dtype=torch.float32, device=xk.device)
             for _ in range(splits)]
    chunk = max(1, _EMU_ELEMS // max(1, k_stages * kc * D))
    for b0 in range(0, B, chunk):
        b1 = min(B, b0 + chunk)
        z, wp = _padded(xk[b0:b1], x0[b0:b1], w, kc)
        if xk.dtype == torch.bfloat16:
            z_hi = z.bfloat16().float()
            pairs = [((z - z_hi).bfloat16().float(), wp), (z_hi, wp)]
        else:
            z_hi, w_hi = tf32_rna(z), tf32_rna(wp)
            pairs = [(z_hi, tf32_rna(wp - w_hi)), (tf32_rna(z - z_hi), w_hi), (z_hi, w_hi)]
        pairs = [(a.double(), b.double()) for a, b in pairs]
        for s in range(splits):
            acc = torch.zeros((z.shape[0], Hn), dtype=torch.float32, device=xk.device)
            for t in range(*stage_range(k_stages, splits, s)):
                ks = slice(t * kc, (t + 1) * kc)
                acc = acc + sum(a[:, ks] @ b[ks] for a, b in pairs).float()
            parts[s][b0:b1] = acc.reshape(b1 - b0, D, Hn).permute(0, 2, 1)
    return parts


def _tf32_parts(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def _staged_3xtf32(a: torch.Tensor, b: torch.Tensor, depth: int) -> torch.Tensor:
    """a (M, K) · b (K, N), both float32, as K7b sums it: stages of ``depth``
    along K, each stage's ``hi·lo + lo·hi + hi·hi`` in float64, then added in
    order to a float32 sum."""
    (ah, al), (bh, bl) = _tf32_parts(a), _tf32_parts(b)
    ah, al, bh, bl = (x.double() for x in (ah, al, bh, bl))
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32, device=a.device)
    for k0 in range(0, a.shape[1], depth):
        ks = slice(k0, k0 + depth)
        acc = acc + (ah[:, ks] @ bl[ks] + al[:, ks] @ bh[ks] + ah[:, ks] @ bh[ks]).float()
    return acc


def bwd_split_row(R: int, s: int, splits: int) -> int:
    """The first of the B·D rows in K7b's split ``s`` (``R`` past the last):
    ``R·s / splits`` rounded down to a whole stage of 32 rows."""
    return R if s >= splits else R * s // splits // 32 * 32


def cin_bwd_split_partials(xk: torch.Tensor, x0: torch.Tensor, w: torch.Tensor,
                           g: torch.Tensor, splits: int = 1):
    """K7b's arithmetic: ``(dxk, dx0, dw_parts)`` in float32, with ``dw_parts``
    one (Hk·m, H') partial per split of the B·D rows; their sum in split
    order, rounded to the inputs' type, is K7b's ``dw``."""
    B, Hk, D = xk.shape
    m, Hn = x0.shape[1], w.shape[1]
    R = B * D
    def rows(x):  # (B, C, D) -> (R, C)
        return x.float().permute(0, 2, 1).reshape(R, x.shape[1])

    def back(x):  # (R, C) -> (B, C, D)
        return x.view(B, D, -1).permute(0, 2, 1)

    gr, xkr, x0r = rows(g), rows(xk), rows(x0)
    t = _staged_3xtf32(gr, w.float().t(), 32).view(R, Hk, m)
    dxk = (t * x0r[:, None, :]).sum(-1)
    dx0 = (t * xkr[:, :, None]).sum(1)
    z = (xkr[:, :, None] * x0r[:, None, :]).reshape(R, Hk * m)
    parts = []
    for s in range(splits):
        lo, hi = bwd_split_row(R, s, splits), bwd_split_row(R, s + 1, splits)
        parts.append(_staged_3xtf32(z[lo:hi].t(), gr[lo:hi], 32))
    return back(dxk), back(dx0), parts
