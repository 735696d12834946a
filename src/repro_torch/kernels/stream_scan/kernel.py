"""Wrappers of the Hopper kernels K1 (Alg. 1 fold) and K2 (Alg. 3 placement).

Same signatures as ``repro.kernels.stream_scan.kernel.cluster_scan`` and
``assign_scan``.  On CUDA tensors each wrapper launches its kernel from
``csrc/stream_scan.cu`` (one thread block per chunk, on PyTorch's current
stream, no synchronisation) and counts the launch; on CPU tensors it runs
the plain version in :mod:`.ref`.  K1 updates the state leaves in place
and returns them, as the Pallas call aliases its inputs to its outputs.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import ref

__all__ = ["cluster_scan", "assign_scan", "launch_counts",
           "reset_launch_counts"]

_LAUNCHES = {"cluster_scan": 0, "assign_scan": 0}
_P = ctypes.c_void_p
_I = ctypes.c_int


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def _lib():
    lib = _build.load("stream_scan")
    if not getattr(lib, "_typed", False):
        lib.cluster_scan_launch.argtypes = [_P, _P, _I, _I, _P] + [_P] * 10 + [_I, _I, _I, _P]
        lib.cluster_scan_launch.restype = _I
        lib.assign_scan_launch.argtypes = [_P] * 6 + [_I] * 5 + [_P, _P, _P]
        lib.assign_scan_launch.restype = _I
        lib._typed = True
    return lib


def _stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check_int32(name: str, t: torch.Tensor, device, shape=None) -> None:
    if t.device != device or t.dtype != torch.int32 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous int32 tensor on "
                         f"{device}, got {t.dtype} on {t.device}")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")


def cluster_scan(state, src, dst, degrees, *, xi: int, kappa: int,
                 global_tail: bool = False):
    """One Alg. 1 chunk (insert path) on the 10-leaf ``ClusterState`` tuple.

    ``limit`` is the chunk's full length: padding ``(0, 0)`` edges drop
    out because ``u == v``, exactly as in the reference.
    """
    state = tuple(state)
    E = int(src.shape[0])
    if src.device.type == "cpu":
        return ref.cluster_chunk_oracle(state, src, dst, degrees, xi=xi,
                                        kappa=kappa, global_tail=global_tail)
    if src.device.type != "cuda":
        raise ValueError(f"cluster_scan runs on cuda or cpu, not {src.device}")
    dev = src.device
    V = int(degrees.shape[0])
    shapes = [(V,), (V,), (V + 1,), (V + 1,), (V,), (), (), (V,), (V,), (V,)]
    for i, (leaf, shp) in enumerate(zip(state, shapes)):
        _check_int32(f"state[{i}]", leaf, dev, shp)
    for name, t in (("src", src), ("dst", dst)):
        _check_int32(name, t, dev, (E,))
    _check_int32("degrees", degrees, dev, (V,))
    if E == 0:
        return state
    _LAUNCHES["cluster_scan"] += 1
    code = _lib().cluster_scan_launch(
        src.data_ptr(), dst.data_ptr(), E, E, degrees.data_ptr(),
        *(leaf.data_ptr() for leaf in state), int(xi), int(kappa),
        int(bool(global_tail)), _stream_ptr(dev))
    _build.check(code, "cluster_scan")
    return state


def assign_scan(load, src, dst, is_head_edge, pcu, pcv, *, max_load,
                sign: int = 1, parts=None, n_valid=None):
    """One Alg. 3 chunk, insert (``sign=+1``) or retract (``sign=-1``).

    ``pcu``/``pcv`` are the endpoint partition ids (``c2p`` gathered
    outside).  Retract needs ``n_valid`` and the recorded ``parts``.
    Returns ``(parts, load)``; on CUDA ``load`` is updated in place.
    """
    if sign not in (1, -1):
        raise ValueError(f"sign must be +1 or -1, got {sign!r}")
    if sign < 0 and (n_valid is None or parts is None):
        raise ValueError("retract needs n_valid and recorded parts")
    if src.device.type == "cpu":
        return ref.assign_chunk_oracle(load, src, dst, is_head_edge, pcu, pcv,
                                       max_load=max_load, sign=sign,
                                       parts=parts, n_valid=n_valid)
    if src.device.type != "cuda":
        raise ValueError(f"assign_scan runs on cuda or cpu, not {src.device}")
    dev = src.device
    E = int(src.shape[0])
    k = int(load.shape[0])
    if not 1 <= k <= 4096:
        raise ValueError(f"assign_scan takes 1 <= k <= 4096, got {k}")
    head = is_head_edge.to(torch.int32).contiguous()
    pin = (torch.full((E,), -1, dtype=torch.int32, device=dev)
           if parts is None else parts)
    for name, t in (("src", src), ("dst", dst), ("is_head_edge", head),
                    ("pcu", pcu), ("pcv", pcv), ("parts", pin)):
        _check_int32(name, t, dev, (E,))
    _check_int32("load", load, dev, (k,))
    out = torch.empty((E,), dtype=torch.int32, device=dev)
    if E == 0:
        return out, load
    limit = E if sign > 0 else int(n_valid)
    _LAUNCHES["assign_scan"] += 1
    code = _lib().assign_scan_launch(
        src.data_ptr(), dst.data_ptr(), head.data_ptr(), pcu.data_ptr(),
        pcv.data_ptr(), pin.data_ptr(), E, limit, int(sign), int(max_load),
        k, load.data_ptr(), out.data_ptr(), _stream_ptr(dev))
    _build.check(code, "assign_scan")
    return out, load
