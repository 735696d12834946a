"""Versioned partition bundles and the atomic-swap registry (port of
``repro.serving.bundle``).

A :class:`PartitionBundle` is an immutable snapshot of one partitioned
graph version: the live window's edges, their partition assignment, the
prebuilt GAS vertex-cut layout and its per-vertex scratch
(``out_deg_inv``) on the bundle's device, device copies of the edges for
GNN queries, and the provenance and quality metrics.  The ingest side
never mutates a published bundle, so a swap is one reference assignment.

:class:`BundleRegistry` is that swap point, RCU-style with explicit pins:
writers :meth:`~BundleRegistry.publish`; readers wrap each super-step in
``with registry.pin() as bundle:`` and see one consistent version for the
whole step; a superseded version stays valid while pinned and is retired
(``versions_retired``) when its last pin drops.
"""

from __future__ import annotations

import threading
import zlib
from contextlib import contextmanager
from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from ..gas import GASGraph, build_gas_graph, comm_stats, out_degree_inv

__all__ = ["PartitionBundle", "BundleRegistry", "build_bundle"]


class PartitionBundle(NamedTuple):
    """One immutable partitioned-graph version (see module docstring)."""

    version: int
    src: np.ndarray  # (E_live,) int32 — the live window's edges
    dst: np.ndarray  # (E_live,)
    parts: np.ndarray  # (E_live,) int32 — their partition assignment
    n_vertices: int
    k: int
    gas: GASGraph  # prebuilt vertex-cut layout of exactly these edges
    out_deg_inv: torch.Tensor  # cached per-vertex scratch for pagerank_step
    edge_src: torch.Tensor  # src and dst on the bundle's device, same order
    edge_dst: torch.Tensor
    lo: int  # window coordinates: arrivals [lo, hi)
    hi: int
    rf: float
    balance: float
    origin: str  # "cold" | "delta" | "refine" | "cold-restart" | "resize" | ...
    fingerprint: int  # CRC over (version, src, dst, parts)

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def device(self) -> torch.device:
        return self.edge_src.device

    def bytes_per_superstep(self, bytes_per_value: int = 8) -> int:
        """Mirror-sync volume of one GAS super-step on this version."""
        return comm_stats(self.gas).total_bytes(bytes_per_value)

    def check(self) -> None:
        """Raise if the snapshot is not internally consistent (torn)."""
        got = _fingerprint(self.version, self.src, self.dst, self.parts)
        if got != self.fingerprint:
            raise AssertionError(
                f"bundle v{self.version} is torn: fingerprint "
                f"{got:#010x} != {self.fingerprint:#010x}")


def _fingerprint(version: int, src, dst, parts) -> int:
    crc = zlib.crc32(np.int64(version).tobytes())
    for arr in (src, dst, parts):
        crc = zlib.crc32(np.ascontiguousarray(arr, np.int32).tobytes(), crc)
    return crc


def build_bundle(version: int, src, dst, parts, n_vertices: int, k: int, *,
                 lo: int = 0, hi: int = 0, rf: float = 0.0,
                 balance: float = 0.0, origin: str = "cold", device=None,
                 ) -> PartitionBundle:
    """Snapshot a routing table into a servable :class:`PartitionBundle` on
    ``device`` (default ``cuda``).

    Copies the inputs (the snapshot must not alias ingest-side buffers),
    builds the GAS layout once and caches the per-vertex scratch, so
    readers pay no per-superstep setup.
    """
    dev = resolve_device(device)
    src = np.array(src, np.int32)
    dst = np.array(dst, np.int32)
    parts = np.array(parts, np.int32)
    edge_src = torch.from_numpy(src).to(dev)
    edge_dst = torch.from_numpy(dst).to(dev)
    gas = build_gas_graph(edge_src, edge_dst, torch.from_numpy(parts), n_vertices, k,
                          device=dev)
    return PartitionBundle(
        version=int(version), src=src, dst=dst, parts=parts,
        n_vertices=int(n_vertices), k=int(k), gas=gas,
        out_deg_inv=out_degree_inv(gas), edge_src=edge_src, edge_dst=edge_dst,
        lo=int(lo), hi=int(hi), rf=float(rf), balance=float(balance),
        origin=str(origin), fingerprint=_fingerprint(version, src, dst, parts))


class BundleRegistry:
    """RCU-style publish/pin registry (see module docstring)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._current: PartitionBundle | None = None
        self._pins: dict[int, int] = {}  # version → active pin count
        self.swap_count = 0  # publishes that replaced a previous version
        self.versions_retired = 0  # superseded versions whose pins drained

    def publish(self, bundle: PartitionBundle) -> None:
        """Atomically make ``bundle`` the version new pins will see."""
        with self._cond:
            prev = self._current
            self._current = bundle
            if prev is not None:
                self.swap_count += 1
                if self._pins.get(prev.version, 0) == 0:
                    self.versions_retired += 1
            self._cond.notify_all()

    @property
    def current(self) -> PartitionBundle | None:
        """The latest published bundle (unpinned peek — metrics only)."""
        with self._lock:
            return self._current

    @property
    def current_version(self) -> int:
        with self._lock:
            return -1 if self._current is None else self._current.version

    @contextmanager
    def pin(self):
        """Pin the current version for the duration of one super-step.

        Yields ``None`` when nothing has been published yet.  The pinned
        bundle stays valid across concurrent publishes; its version is
        retired only after the last pin drops.
        """
        with self._lock:
            bundle = self._current
            if bundle is not None:
                self._pins[bundle.version] = self._pins.get(bundle.version, 0) + 1
        try:
            yield bundle
        finally:
            if bundle is not None:
                with self._cond:
                    n = self._pins[bundle.version] - 1
                    if n:
                        self._pins[bundle.version] = n
                    else:
                        del self._pins[bundle.version]
                        cur = self._current
                        if cur is None or cur.version != bundle.version:
                            self.versions_retired += 1
                    # a drop can shrink reader lag — wake throttled writers
                    self._cond.notify_all()

    def oldest_pinned_version(self) -> int:
        """The oldest version a reader still pins (−1 when none are)."""
        with self._lock:
            return min(self._pins) if self._pins else -1

    def reader_lag(self) -> int:
        """Published-ahead distance: newest version − oldest pinned (0 when
        nothing is published or nothing is pinned)."""
        with self._lock:
            if self._current is None or not self._pins:
                return 0
            return self._current.version - min(self._pins)

    def wait_reader_lag(self, max_lag: int, timeout: float | None = None) -> bool:
        """Block until ``reader_lag() <= max_lag`` (writer backpressure)."""
        def _ok():
            if self._current is None or not self._pins:
                return True
            return self._current.version - min(self._pins) <= max_lag

        with self._cond:
            return self._cond.wait_for(_ok, timeout)

    def wait_version(self, version: int, timeout: float | None = None) -> bool:
        """Block until a bundle with ``version`` or newer is published."""
        with self._cond:
            return self._cond.wait_for(
                lambda: (self._current is not None
                         and self._current.version >= version), timeout)

    @property
    def active_pins(self) -> int:
        with self._lock:
            return sum(self._pins.values())
