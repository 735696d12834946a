"""Wrapper of the Hopper kernel K7 (the xDeepFM CIN layer).

``cin_layer(xk, x0, w)`` takes ``xk`` (B, Hk, D), ``x0`` (B, m, D) and
``w`` (Hk·m, H'), contiguous, of one type (float32 or bfloat16), on one
device, and returns ``out`` (B, H', D) of that type with
``out[b, n, d] = Σ_{h, j} w[h·m + j, n] · xk[b, h, d] · x0[b, j, d]``
(float32 products and sums, one rounding).  On CUDA tensors it launches
``cin_launch`` from ``csrc/cin.cu`` and counts the launch; on CPU tensors
it runs :func:`.ref.cin_layer_ref`.  A CUDA tensor never takes the plain
path: a failed build or launch raises.  K7 has no backward kernel (the
Pallas kernel has none): a gradient through it raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import ref

__all__ = ["cin_layer", "launch_counts", "reset_launch_counts"]

_LAUNCHES = {"cin": 0}
_SMEM_LIMIT = 232448  # opt-in shared memory of one H100 block
_P = ctypes.c_void_p
_I = ctypes.c_int


def launch_counts() -> dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def _lib():
    lib = _build.load("cin")
    if not getattr(lib, "_typed", False):
        lib.cin_launch.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
        lib.cin_launch.restype = _I
        lib.cin_smem_bytes.argtypes = [_I]
        lib.cin_smem_bytes.restype = ctypes.c_longlong
        lib._typed = True
    return lib


def _check(xk, x0, w) -> tuple[int, int, int, int, int]:
    if xk.dim() != 3 or x0.dim() != 3 or w.dim() != 2:
        raise ValueError(f"xk must be (B, Hk, D), x0 (B, m, D) and w (Hk·m, H'); got "
                         f"{tuple(xk.shape)}, {tuple(x0.shape)}, {tuple(w.shape)}")
    B, Hk, D = (int(s) for s in xk.shape)
    m = int(x0.shape[1])
    if x0.shape[0] != B or x0.shape[2] != D or w.shape[0] != Hk * m:
        raise ValueError(f"xk {tuple(xk.shape)}, x0 {tuple(x0.shape)} and w "
                         f"{tuple(w.shape)} do not fit one CIN layer")
    if xk.dtype not in (torch.float32, torch.bfloat16) or x0.dtype != xk.dtype \
            or w.dtype != xk.dtype:
        raise ValueError(f"K7 takes float32 or bfloat16 xk, x0, w of one type, not "
                         f"{xk.dtype}, {x0.dtype}, {w.dtype}")
    for t in (x0, w):
        if t.device != xk.device:
            raise ValueError(f"xk is on {xk.device}, another input on {t.device}")
    return B, Hk, m, D, int(w.shape[1])


class _K7(torch.autograd.Function):
    """The launch; a gradient through it raises instead of being dropped."""

    @staticmethod
    def forward(ctx, xk, x0, w):
        B, Hk, m, D, Hn = _check(xk, x0, w)
        if B * D * max(Hk, m, Hn) >= 2**31 or Hk * m * Hn >= 2**31:
            raise ValueError("K7 indexes with int32: B·D·max(Hk, m, H') and Hk·m·H' "
                             "must stay below 2**31")
        for name, t in (("xk", xk), ("x0", x0), ("w", w)):
            if not t.is_contiguous():
                raise ValueError(f"K7 takes contiguous tensors; {name} is not")
        out = torch.empty((B, Hn, D), dtype=xk.dtype, device=xk.device)
        if out.numel() == 0:
            return out
        lib = _lib()
        if lib.cin_smem_bytes(m) > _SMEM_LIMIT:
            raise ValueError(f"K7 keeps x0's {m} fields in shared memory; "
                             f"{lib.cin_smem_bytes(m)} bytes exceed a block's {_SMEM_LIMIT}")
        _LAUNCHES["cin"] += 1
        code = lib.cin_launch(xk.data_ptr(), x0.data_ptr(), w.data_ptr(), out.data_ptr(),
                              B, Hk, m, D, Hn, int(xk.dtype == torch.bfloat16),
                              torch.cuda.current_stream(xk.device).cuda_stream)
        _build.check(code, "cin")
        return out

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "K7 has no backward kernel: the CIN layer's gradient is ported with the "
            "training slice")


def cin_layer(xk: torch.Tensor, x0: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, Hk, D) ``xk``, (B, m, D) ``x0``, (Hk·m, H') ``w`` → (B, H', D)."""
    dev = xk.device
    if dev.type == "cpu":
        _check(xk, x0, w)
        return ref.cin_layer_ref(xk, x0, w)
    if dev.type != "cuda":
        raise ValueError(f"the CIN layer runs on cuda or cpu, not {dev}")
    return _K7.apply(xk, x0, w)
