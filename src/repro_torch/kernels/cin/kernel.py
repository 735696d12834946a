"""Wrapper of the Hopper kernel K7 (the xDeepFM CIN layer).

``cin_layer(xk, x0, w)`` takes ``xk`` (B, Hk, D), ``x0`` (B, m, D) and
``w`` (Hk·m, H'), contiguous, of one type (float32 or bfloat16), on one
device, and returns ``out`` (B, H', D) of that type with
``out[b, n, d] = Σ_{h, j} w[h·m + j, n] · xk[b, h, d] · x0[b, j, d]``
(float32 sums, one rounding).  On CUDA tensors it launches ``cin_launch``
from ``csrc/cin.cu`` (the tensor-core kernel with its w copy and, when the
K stages are split, the fixed-order sum of the splits) and counts one
launch; on CPU tensors it runs :func:`.ref.cin_layer_ref`.  A CUDA tensor
never takes the plain path: a failed build or launch raises.  K7 has no
backward kernel (the Pallas kernel has none): a gradient through it raises.

:func:`plan` states how a call is cut: tiles of ``ROWS`` (b, d) rows and
``COLS`` channels, stages of ``STAGE_K`` k values, and the number of splits
of the stages, chosen from the shape so that the blocks fill the card's
block slots in as few waves as they can.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _build
from . import ref

__all__ = ["cin_layer", "launch", "launch_counts", "plan", "reset_launch_counts", "smem_bytes",
           "ROWS", "COLS", "MAX_SPLITS", "SMEM_LIMIT"]

_LAUNCHES = {"cin": 0}
SMEM_LIMIT = 232448  # opt-in shared memory of one H100 block
_P = ctypes.c_void_p
_I = ctypes.c_int
ROWS = 64    # (b, d) rows of a block's tile
COLS = 208   # channels of a tile (two warpgroups of 104)
MAX_SPLITS = 8


def launch_counts() -> dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def _lib():
    lib = _build.load("cin")
    if not getattr(lib, "_typed", False):
        lib.cin_launch.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                   _P]
        lib.cin_launch.restype = _I
        lib.cin_smem_bytes.argtypes = [_I, _I, _I]
        lib.cin_smem_bytes.restype = ctypes.c_longlong
        lib.cin_blocks_per_sm.argtypes = [_I, _I, _I]
        lib.cin_blocks_per_sm.restype = _I
        lib._typed = True
    return lib


_RING_BYTES = {torch.float32: 3 * 2 * COLS * 128, torch.bfloat16: 3 * COLS * 128}


def smem_bytes(m: int, hr: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block: the w ring, its barriers, x0 and
    ``hr`` values of h of xk as float, and the alignment slack.  The formula
    of ``csrc/cin.cu`` ``smem_bytes``, for planning without the card; on the
    card :func:`plan` asks the kernel's ``cin_smem_bytes``."""
    return _RING_BYTES[dtype] + 64 + ROWS * (ref.pad_fields(m) + 4 + hr) * 4 + 1024


def _h_span(k_stages: int, splits: int, kc: int, mp: int, Hk: int) -> int:
    """The most h that one split of the K stages spans."""
    most = 1
    for s in range(splits):
        t0, t1 = ref.stage_range(k_stages, splits, s)
        h0 = t0 * kc // mp
        most = max(most, min((t1 * kc - 1) // mp + 1, Hk) - h0)
    return most


def plan(B: int, Hk: int, m: int, D: int, Hn: int, dtype: torch.dtype, slots: int,
         lib=None) -> dict:
    """How K7 cuts one call: row and channel tiles, K stages, and ``splits``,
    the smallest number of splits of the stages (at most ``MAX_SPLITS``)
    whose waves of blocks over ``slots`` block slots, each wave taking
    1/splits of a tile's work, come within 10 % of the fewest, among those
    whose xk fits a block's shared memory (more splits where none does).
    ``h_span``, the most h that one split spans, goes to the launch, which
    sizes shared memory by it.  Shared memory is the built kernel's
    ``cin_smem_bytes`` when ``lib`` is given, else :func:`smem_bytes`."""
    return dict(_plan(B, Hk, m, D, Hn, dtype, slots, lib))


@functools.lru_cache(maxsize=256)
def _plan(B, Hk, m, D, Hn, dtype, slots, lib) -> dict:
    if lib is None:
        def smem(hr):
            return smem_bytes(m, hr, dtype)
    else:
        def smem(hr):
            return int(lib.cin_smem_bytes(m, hr, int(dtype == torch.bfloat16)))
    if smem(1) > SMEM_LIMIT:
        raise ValueError(f"K7 keeps x0's {m} fields in shared memory beside its w ring; "
                         f"{smem(1)} bytes exceed a block's {SMEM_LIMIT}")
    rows = B * D
    row_tiles, col_tiles = -(-rows // ROWS), -(-Hn // COLS)
    kc, mp = ref.STAGE_K[dtype], ref.pad_fields(m)
    k_stages = -(-Hk * mp // kc)
    tiles = row_tiles * col_tiles
    if k_stages == 0:  # an empty sum: the launch writes zeros
        return {"row_tiles": row_tiles, "col_tiles": col_tiles, "k_stages": 0, "splits": 1,
                "blocks": 0, "h_span": 0, "smem_bytes": 0}

    def fits(s):
        return smem(_h_span(k_stages, s, kc, mp, Hk)) <= SMEM_LIMIT

    cands = [s for s in range(1, min(MAX_SPLITS, k_stages) + 1) if fits(s)]
    if not cands:
        cands = [s for s in range(MAX_SPLITS + 1, k_stages + 1) if fits(s)][:1]
    if not cands:
        raise ValueError(f"K7 keeps xk of at least one h beside x0 and its w ring in shared "
                         f"memory; {m} fields leave no room for it")
    cost = {s: math.ceil(tiles * s / max(1, slots)) / s for s in cands}
    best = min(cost.values())
    splits = min(s for s in cands if cost[s] <= 1.1 * best)
    hr = _h_span(k_stages, splits, kc, mp, Hk)
    return {"row_tiles": row_tiles, "col_tiles": col_tiles, "k_stages": k_stages,
            "splits": splits, "blocks": tiles * splits, "h_span": hr,
            "smem_bytes": smem(hr)}


_SLOTS: dict[tuple, int] = {}


def _slots(lib, dev: torch.device, m: int, is_bf16: int) -> int:
    """Block slots of the card: SMs times the blocks one SM holds."""
    key = (dev.index, m, is_bf16)
    if key not in _SLOTS:
        per_sm = lib.cin_blocks_per_sm(m, 1, is_bf16)
        if per_sm < 0:
            raise RuntimeError("K7: the occupancy query failed")
        _SLOTS[key] = max(1, per_sm) * torch.cuda.get_device_properties(dev).multi_processor_count
    return _SLOTS[key]


def launch(lib, xk, x0, w, out, splits: int, h_span: int) -> int:
    """One ``cin_launch`` of ``lib`` on checked tensors, with its scratch, the
    K stages cut in ``splits``, each spanning at most ``h_span`` values of h
    (:func:`plan`); its ``cudaError_t``.  Counts nothing."""
    B, Hk, D = xk.shape
    m, Hn = x0.shape[1], w.shape[1]
    is_bf16 = int(xk.dtype == torch.bfloat16)
    # one scratch allocation: w's copies (hi; lo in float32 only), then the
    # splits' partials, each at a 256-byte boundary
    wt_bytes = -(-Hn * Hk * ref.pad_fields(m) * xk.element_size() // 256) * 256
    n_wt = 1 if is_bf16 else 2
    part_bytes = splits * B * Hn * D * 4 if splits > 1 else 0
    scratch = torch.empty(n_wt * wt_bytes + part_bytes, dtype=torch.uint8, device=xk.device)
    base = scratch.data_ptr()
    return lib.cin_launch(xk.data_ptr(), x0.data_ptr(), w.data_ptr(), out.data_ptr(),
                          base, base + wt_bytes if n_wt == 2 else 0,
                          base + n_wt * wt_bytes if part_bytes else 0,
                          B, Hk, m, D, Hn, is_bf16, splits, h_span,
                          torch.cuda.current_stream(xk.device).cuda_stream)


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
        if B * D * max(Hk, m, Hn) >= 2**31 or Hk * ref.pad_fields(m) * Hn >= 2**31:
            raise ValueError("K7 indexes with int32: B·D·max(Hk, m, H') and Hk·m·H' "
                             "must stay below 2**31")
        for name, t in (("xk", xk), ("x0", x0), ("w", w)):
            if not t.is_contiguous():
                raise ValueError(f"K7 takes contiguous tensors; {name} is not")
        out = torch.empty((B, Hn, D), dtype=xk.dtype, device=xk.device)
        if out.numel() == 0:
            return out
        lib = _lib()
        slots = _slots(lib, xk.device, m, int(xk.dtype == torch.bfloat16))
        p = _plan(B, Hk, m, D, Hn, xk.dtype, slots, lib)  # refuses an m whose x0 does not fit
        _LAUNCHES["cin"] += 1
        _build.check(launch(lib, xk, x0, w, out, p["splits"], p["h_span"]), "cin")
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
