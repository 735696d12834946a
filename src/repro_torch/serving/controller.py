"""The ingest → refine → swap controller of the serving loop (the port of
``repro.serving.controller``).

:class:`ServingController` sits between a windowed partitioner chain and
the :class:`~repro_torch.serving.bundle.BundleRegistry`: each :meth:`step`
applies one churn event through the chain (delta fold, expiry
retraction, drift-triggered refinement, compactions, the automatic cold
restart), snapshots the live window and publishes it as the next
:class:`~repro_torch.serving.bundle.PartitionBundle` version, built on the
chain's device.  Readers see only published snapshots: the chain's bundle
is private to the controller, and every mutation (a step,
:meth:`request_cold_restart`, :meth:`resize`) runs under the controller's
lock, so out-of-band ones land at a step boundary.

The chain is duck-typed: ``step() -> record | None``,
``live_partition() -> (src, dst, parts) | None``, ``lo``/``hi``,
``n_vertices`` and ``config.k`` (:class:`~repro_torch.incremental.
S5PWindowChain`, whose ``device`` the bundles follow).  Run it
synchronously (:meth:`step` / :meth:`run`) or as a background ingest
thread (:meth:`start` / :meth:`stop` / :meth:`join`, with ``throttle_s``
and ``max_lag`` reader backpressure).
"""

from __future__ import annotations

import threading
import time

import numpy as np

from .bundle import BundleRegistry, build_bundle

__all__ = ["ServingController"]


class ServingController:
    """Drive a window chain and publish each step's live partition."""

    def __init__(self, registry: BundleRegistry, chain, *,
                 origin_hook=None):
        self.registry = registry
        self.chain = chain
        self.history: list = []
        self._origin_hook = origin_hook
        self._version = 0
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.done = threading.Event()
        # serialises every chain/bundle mutation: the ingest thread's
        # step() against request_cold_restart()/resize() from the control
        # plane
        self._lock = threading.RLock()

    # ------------------------------------------------------------ stepping
    def _origin_of(self, rec) -> str:
        if self._origin_hook is not None:
            return self._origin_hook(rec)
        if self._version == 0:
            # nothing published yet: this bundle is the fill's cold partition
            return "cold"
        if getattr(rec, "cold_restarted", False):
            return "cold-restart"
        if getattr(rec, "rolled_back", False):
            return "rollback"
        if getattr(rec, "refined", False):
            return "refine"
        return "delta"

    def _publish(self, src, dst, parts, *, rf: float, balance: float, origin: str) -> None:
        chain = self.chain
        self._version += 1
        self.registry.publish(build_bundle(
            self._version, src, dst, parts, chain.n_vertices, chain.config.k,
            lo=chain.lo, hi=chain.hi, rf=rf, balance=balance, origin=origin,
            device=getattr(chain, "device", None)))

    def step(self):
        """One churn event → at most one published version.  Returns the
        chain's step record, or ``None`` when the stream is exhausted.
        Fill-phase events publish nothing."""
        with self._lock:
            rec = self.chain.step()
            if rec is None:
                self.done.set()
                return None
            self.history.append(rec)
            if getattr(rec, "filling", False):
                return rec
            snap = self.chain.live_partition()
            if snap is None:
                return rec
            # provenance first: "cold" keys off the count before this publish
            origin = self._origin_of(rec)
            self._publish(*snap, rf=float(getattr(rec, "rf", 0.0)),
                          balance=float(getattr(rec, "balance", 0.0)), origin=origin)
            return rec

    def run(self):
        """Drain the whole churn schedule synchronously."""
        while self.step() is not None:
            pass
        return self.history

    def request_cold_restart(self) -> bool:
        """Re-partition the current live window from scratch now and publish
        it (origin ``"cold-restart"``); readers keep their pinned version
        meanwhile.  Returns False while the window is filling."""
        from ..incremental import s5p_cold_restart

        with self._lock:
            chain = self.chain
            if chain.bundle is None:
                return False
            bundle, res = s5p_cold_restart(chain.bundle, chain.config,
                                           chain.seen_src, chain.seen_dst,
                                           device=getattr(chain, "device", None))
            chain.bundle = bundle
            self._publish(*chain.live_partition(), rf=res.rf, balance=res.balance,
                          origin="cold-restart")
            return True

    def resize(self, k_new: int):
        """Elastic resize: reshard the live window onto ``k_new`` partitions
        (the chain's ``resize``, bounded migration) and publish it as one
        more swap (origin ``"resize"``).  Readers keep the pinned k-era
        version until then; later steps publish at k′.  Returns the chain's
        result (``None`` while the window is filling)."""
        with self._lock:
            res = self.chain.resize(k_new)
            if res is None:
                return None
            self._publish(*self.chain.live_partition(), rf=float(res.rf),
                          balance=float(res.balance), origin="resize")
            return res

    # ---------------------------------------------------------- background
    def start(self, *, throttle_s: float = 0.0,
              max_lag: int | None = None) -> None:
        """Run the churn schedule on a background ingest thread.

        ``throttle_s`` sleeps between events.  ``max_lag`` adds reader
        backpressure: before each event the thread waits while the newest
        version is more than ``max_lag`` ahead of the oldest pinned one
        (``registry.wait_reader_lag``); an idle registry never throttles,
        and ``stop()`` wakes a blocked wait through its poll timeout.
        """
        if self._thread is not None:
            raise RuntimeError("controller already started")
        if max_lag is not None and max_lag < 0:
            raise ValueError("max_lag must be >= 0")
        self._stop.clear()

        def ingest():
            try:
                while not self._stop.is_set():
                    if max_lag is not None:
                        while not self._stop.is_set() and not \
                                self.registry.wait_reader_lag(max_lag, timeout=0.05):
                            pass
                        if self._stop.is_set():
                            break
                    if self.step() is None:
                        break
                    if throttle_s:
                        time.sleep(throttle_s)
            finally:
                self.done.set()

        self._thread = threading.Thread(target=ingest, name="serving-ingest",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def join(self, timeout: float | None = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    @property
    def version(self) -> int:
        return self._version

    @property
    def n_live_edges(self) -> int:
        snap = self.chain.live_partition()
        return 0 if snap is None else int(np.asarray(snap[0]).shape[0])
