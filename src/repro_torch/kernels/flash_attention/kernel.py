"""Wrapper of the Hopper kernel K6 (flash attention forward).

``flash_attention_fwd(q, k, v, q_pos, kv_pos, *, causal, window)`` takes
the kernel layout of ``repro.kernels.flash_attention.kernel``: q is
(BK, S, G·hd), k and v are (BK, T, hd), float32 or bfloat16, where BK folds
(batch, kv head) and the G q-heads of one kv head sit side by side; q_pos
and kv_pos are int32 (BK, S) and (BK, T).  On CUDA tensors it launches
``flash_attention_launch`` from ``csrc/flash_attention.cu`` and counts the
launch; on CPU tensors it runs :func:`.ref.flash_attention_ref`.  A CUDA
tensor never takes the plain path: a failed build or launch raises.  K6 has
no backward kernel yet: a gradient through it raises (the training slice
ports ``_fa_bwd``).

K6 tiles the flattened (query, head) rows by ``ROW_TILE`` and the keys by
``KEY_TILE``, per dtype.  p is rounded to bf16 against the running max of
each key tile, so a plain version that is to match K6 in bf16 runs over
``block_k=KEY_TILE[dtype]``; :func:`.ref.kv_tile_classes` mirrors which of
those tiles K6 skips, masks or takes whole.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import ref

__all__ = ["flash_attention_fwd", "launch_counts", "reset_launch_counts", "smem_bytes",
           "HEAD_DIMS", "KEY_TILE", "ROW_TILE"]

HEAD_DIMS = (16, 32, 64, 128)
KEY_TILE = {torch.bfloat16: 128, torch.float32: 32}  # keys per kv tile (csrc kBfKeys, kF32Keys)
ROW_TILE = {torch.bfloat16: 128, torch.float32: 64}  # flattened rows per block (kBfRows, kRows)
_LAUNCHES = {"flash_attention": 0}
_P = ctypes.c_void_p
_I = ctypes.c_int


def launch_counts() -> dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def _lib():
    lib = _build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        lib.flash_attention_launch.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                               ctypes.c_float, _I, _I, _I, _I, _P]
        lib.flash_attention_launch.restype = _I
        lib.flash_attention_smem_bytes.argtypes = [_I, _I]
        lib.flash_attention_smem_bytes.restype = _I
        lib._typed = True
    return lib


def smem_bytes(hd: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one K6 block at ``hd`` in ``dtype`` (builds K6)."""
    if hd not in HEAD_DIMS or dtype not in KEY_TILE:
        raise ValueError(f"K6 takes d_head in {HEAD_DIMS} and float32 or bfloat16")
    return int(_lib().flash_attention_smem_bytes(hd, int(dtype == torch.bfloat16)))


def _check(q, k, v, q_pos, kv_pos) -> tuple[int, int, int, int, int]:
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"q must be (BK, S, G·hd) and k, v (BK, T, hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    BK, S, Ghd = q.shape
    T, hd = int(k.shape[1]), int(k.shape[2])
    if k.shape[0] != BK or hd == 0 or Ghd % hd:
        raise ValueError(f"q {tuple(q.shape)} does not group over k {tuple(k.shape)}")
    if tuple(q_pos.shape) != (BK, S) or tuple(kv_pos.shape) != (BK, T):
        raise ValueError(f"positions must be ({BK}, {S}) and ({BK}, {T}), got "
                         f"{tuple(q_pos.shape)} and {tuple(kv_pos.shape)}")
    if q_pos.dtype != torch.int32 or kv_pos.dtype != torch.int32:
        raise ValueError("positions must be int32")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"K6 takes float32 or bfloat16 q, k, v of one type, not "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    for t in (k, v, q_pos, kv_pos):
        if t.device != q.device:
            raise ValueError(f"q is on {q.device}, another input on {t.device}")
    return int(BK), int(S), T, Ghd // hd, hd


class _K6(torch.autograd.Function):
    """The launch; a gradient through it raises instead of being dropped."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, causal, window):
        BK, S, T, G, hd = _check(q, k, v, q_pos, kv_pos)
        if hd not in HEAD_DIMS:
            raise ValueError(f"K6 takes d_head in {HEAD_DIMS}, not {hd}")
        if S * G >= 2**31 or BK >= 2**16:
            raise ValueError("K6 takes S·G < 2**31 rows and BK < 65536")
        for name, t in (("q", q), ("k", k), ("v", v), ("q_pos", q_pos), ("kv_pos", kv_pos)):
            if not t.is_contiguous():
                raise ValueError(f"K6 takes contiguous tensors; {name} is not")
        if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("K6 takes 16-byte aligned bfloat16 q, k and v (its TMA maps)")
        out = torch.empty_like(q)
        if S == 0 or BK == 0:
            return out
        _LAUNCHES["flash_attention"] += 1
        code = _lib().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(), kv_pos.data_ptr(),
            out.data_ptr(), BK, S, T, G, hd, hd ** -0.5, int(q.dtype == torch.bfloat16),
            int(bool(causal)), int(window is not None), int(window or 0),
            torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(code, "flash_attention")
        return out

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "K6 has no backward kernel: the gradient of flash attention (_fa_bwd) is "
            "ported with the training slice")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_pos: torch.Tensor, kv_pos: torch.Tensor, *, causal: bool = True,
                        window: int | None = None, block_q: int = 64,
                        block_k: int = 64) -> torch.Tensor:
    """(BK, S, G·hd) q and (BK, T, hd) k, v → (BK, S, G·hd) of q's type.

    Positions lie in [−2^30, 2^30); a key is visible where ``kv_pos >= 0``,
    ``q_pos − kv_pos >= 0`` (``causal``) and ``q_pos − kv_pos < window``.
    A row that sees no key returns garbage.  ``block_q``/``block_k`` block
    the plain version on CPU tensors; K6 tiles by itself (``KEY_TILE``)."""
    dev = q.device
    if dev.type == "cpu":
        _check(q, k, v, q_pos, kv_pos)
        return ref.flash_attention_ref(q, k, v, q_pos, kv_pos, causal=causal, window=window,
                                       block_q=block_q, block_k=block_k)
    if dev.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not {dev}")
    if window is not None and not 0 < window < 2**31:
        raise ValueError(f"window must be a positive int32, not {window}")
    return _K6.apply(q, k, v, q_pos, kv_pos, causal, window)
