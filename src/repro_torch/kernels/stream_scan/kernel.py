"""Wrappers of the Hopper kernels K1 (Alg. 1 fold), K2 (Alg. 3 placement),
K3 (Greedy/HDRF scoring scan) and G1 (grid scan).

Same signatures as ``repro.kernels.stream_scan.kernel.cluster_scan``,
``assign_scan`` and ``scoring_scan``; G1 has no Pallas counterpart (the
reference runs ``ref.grid_chunk`` as a ``lax.scan``).  On CUDA tensors each
wrapper launches its kernel from ``csrc/stream_scan.cu`` (K1, K2) or
``csrc/scoring_scan.cu`` (K3, G1) — one thread block per chunk, on
PyTorch's current stream, no synchronisation — and counts the launch; on
CPU tensors it runs the plain version in :mod:`.ref`.  K1 and K3's shared
rung fold staged tiles of edges in shared memory, sized by :mod:`.plan`
(K3's rung and tile by ``k``: :func:`.plan.scoring_plan`); K2 packs each
edge into one record while warp 0 folds the tile before, and retracts by a
parallel count (one launch either way).  K1, K3 and G1
update their state in place and return it, as the Pallas call aliases its
inputs to its outputs.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .. import _build
from . import ref
from .plan import K1_TILE, scoring_plan

__all__ = ["cluster_scan", "assign_scan", "scoring_scan", "grid_scan",
           "launch_counts", "reset_launch_counts"]

# K3 counts its inserts and its retracts apart
_LAUNCHES = {"cluster_scan": 0, "assign_scan": 0, "scoring_scan": 0,
             "scoring_retract": 0, "grid_scan": 0}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_MAX_K = 4096


_COUNT_LOCK = threading.Lock()  # parallel-ingest lanes launch from threads


def _count(name: str) -> None:
    with _COUNT_LOCK:
        _LAUNCHES[name] += 1


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def _lib():
    lib = _build.load("stream_scan")
    if not getattr(lib, "_typed", False):
        lib.cluster_scan_launch.argtypes = ([_P, _P, _I, _I, _P, _I] + [_P] * 10
                                            + [_I] * 4 + [_P])
        lib.cluster_scan_launch.restype = _I
        lib.cluster_smem_bytes.argtypes = [_I]
        lib.cluster_smem_bytes.restype = _I
        lib.assign_scan_launch.argtypes = [_P] * 6 + [_I] * 5 + [_P, _P, _P]
        lib.assign_scan_launch.restype = _I
        lib.assign_smem_bytes.argtypes = [_I]
        lib.assign_smem_bytes.restype = _I
        lib._typed = True
    return lib


def _scoring_lib():
    lib = _build.load("scoring_scan")
    if not getattr(lib, "_typed", False):
        lib.scoring_scan_launch.argtypes = ([_P] * 3 + [_I] * 6 + [_F, _F]
                                            + [_P] * 4 + [_I, _P])
        lib.scoring_scan_launch.restype = _I
        lib.scoring_smem_bytes.argtypes = [_I, _I]
        lib.scoring_smem_bytes.restype = _I
        lib.grid_scan_launch.argtypes = [_P] * 4 + [_I] * 3 + [_P] * 3
        lib.grid_scan_launch.restype = _I
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
    _count("cluster_scan")
    code = _lib().cluster_scan_launch(
        src.data_ptr(), dst.data_ptr(), E, E, degrees.data_ptr(), V,
        *(leaf.data_ptr() for leaf in state), int(xi), int(kappa),
        int(bool(global_tail)), K1_TILE, _stream_ptr(dev))
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
    if not 1 <= k <= _MAX_K:
        raise ValueError(f"assign_scan takes 1 <= k <= {_MAX_K}, got {k}")
    head = is_head_edge.to(torch.int32).contiguous()
    for name, t in (("src", src), ("dst", dst), ("is_head_edge", head),
                    ("pcu", pcu), ("pcv", pcv)):
        _check_int32(name, t, dev, (E,))
    if parts is not None:  # only the retract reads them
        _check_int32("parts", parts, dev, (E,))
    _check_int32("load", load, dev, (k,))
    out = torch.empty((E,), dtype=torch.int32, device=dev)
    if E == 0:
        return out, load
    limit = E if sign > 0 else int(n_valid)
    _count("assign_scan")
    code = _lib().assign_scan_launch(
        src.data_ptr(), dst.data_ptr(), head.data_ptr(), pcu.data_ptr(),
        pcv.data_ptr(), parts.data_ptr() if sign < 0 else None, E, limit,
        int(sign), int(max_load), k, load.data_ptr(), out.data_ptr(),
        _stream_ptr(dev))
    _build.check(code, "assign_scan")
    return out, load


def scoring_scan(src, dst, load, rep, pd=None, lam=None, *, mode: str,
                 sign: int = 1, parts=None, n_valid=None, eps: float = 1e-3,
                 k_active: int | None = None):
    """One Greedy/HDRF chunk (K3): insert (``sign=+1``) or retract
    (``sign=-1``, with the recorded per-edge ``parts`` and ``n_valid``).

    src/dst: (E,) int32; load: (k,) int32; rep: (V, k) int32 **counted**
    replica table; pd: (V,) int32 partial degrees (HDRF only); lam: λ
    (HDRF only).  HDRF scores the first ``k_active`` partitions (default
    all k), the padded multi-k carry of the reference's oracle.  Updates
    ``load``/``rep``/``pd`` in place and returns ``(parts (E,), load, rep,
    pd)``; retract echoes ``parts``.
    """
    if mode not in ("greedy", "hdrf"):
        raise ValueError(f"unknown mode {mode!r}")
    if sign not in (1, -1):
        raise ValueError(f"sign must be +1 or -1, got {sign!r}")
    if sign < 0 and (n_valid is None or parts is None):
        raise ValueError("retract needs n_valid and recorded parts")
    hdrf = mode == "hdrf"
    if hdrf and (pd is None or (sign > 0 and lam is None)):
        raise ValueError("hdrf needs pd, and lam to insert")
    if src.device.type == "cpu":
        return ref.scoring_chunk_oracle(
            src, dst, load, rep, pd if hdrf else None, lam, mode=mode,
            sign=sign, parts=parts, n_valid=n_valid, eps=eps,
            k_active=k_active)
    if src.device.type != "cuda":
        raise ValueError(f"scoring_scan runs on cuda or cpu, not {src.device}")
    dev = src.device
    E = int(src.shape[0])
    V, k = (int(x) for x in rep.shape)
    if not 1 <= k <= _MAX_K:
        raise ValueError(f"scoring_scan takes 1 <= k <= {_MAX_K}, got {k}")
    k_act = k if k_active is None else int(k_active)
    if not 1 <= k_act <= k:
        raise ValueError(f"k_active must lie in [1, {k}], got {k_act}")
    for name, t in (("src", src), ("dst", dst)):
        _check_int32(name, t, dev, (E,))
    _check_int32("load", load, dev, (k,))
    _check_int32("rep", rep, dev, (V, k))
    if hdrf:
        _check_int32("pd", pd, dev, (V,))
    if sign < 0:
        _check_int32("parts", parts, dev, (E,))
    out = torch.empty((E,), dtype=torch.int32, device=dev)
    if E == 0:
        return out, load, rep, pd if hdrf else None
    limit = E if sign > 0 else int(n_valid)
    plan = scoring_plan(k)
    _count("scoring_scan" if sign > 0 else "scoring_retract")
    code = _scoring_lib().scoring_scan_launch(
        src.data_ptr(), dst.data_ptr(), None if sign > 0 else parts.data_ptr(),
        E, limit, int(sign), int(hdrf), k, k_act,
        float(lam) if hdrf and sign > 0 else 0.0, float(eps),
        load.data_ptr(), rep.data_ptr(), pd.data_ptr() if hdrf else None,
        out.data_ptr(), plan.tile if plan.rung == "shared" else 0,
        _stream_ptr(dev))
    _build.check(code, "scoring_scan")
    return out, load, rep, pd if hdrf else None


def grid_scan(load, row, col, n_cols: int, src, dst):
    """One grid chunk (G1), insert only: each edge takes the less-loaded
    of the cells ``row[u]·c + col[v]`` and ``row[v]·c + col[u]`` (the first
    on ties); self-loops place nothing and get part -1.  Updates ``load``
    in place and returns ``(parts (E,), load)``.
    """
    if src.device.type == "cpu":
        return ref.grid_chunk_oracle(load, row, col, n_cols, src, dst)
    if src.device.type != "cuda":
        raise ValueError(f"grid_scan runs on cuda or cpu, not {src.device}")
    dev = src.device
    E = int(src.shape[0])
    load_k = int(load.shape[0])
    if not 1 <= load_k <= _MAX_K:
        raise ValueError(f"grid_scan takes 1 <= k <= {_MAX_K}, got {load_k}")
    for name, t in (("src", src), ("dst", dst)):
        _check_int32(name, t, dev, (E,))
    _check_int32("load", load, dev, (load_k,))
    _check_int32("row", row, dev)
    _check_int32("col", col, dev, tuple(row.shape))
    out = torch.empty((E,), dtype=torch.int32, device=dev)
    if E == 0:
        return out, load
    _count("grid_scan")
    code = _scoring_lib().grid_scan_launch(
        src.data_ptr(), dst.data_ptr(), row.data_ptr(), col.data_ptr(), E,
        int(n_cols), load_k, load.data_ptr(), out.data_ptr(), _stream_ptr(dev))
    _build.check(code, "grid_scan")
    return out, load
