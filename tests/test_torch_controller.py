"""The serving controller of the port (``repro_torch.serving.controller``,
``launch.serve.serve_graph``) against the live reference
(``repro.serving.controller``), on the CPU.

Tolerance: bitwise for every published version (number, origin, k,
window, edges, parts, RF and balance) and every step record: the chain
is the port's ``S5PWindowChain``, already the reference's bit for bit.
PageRank values carried across swaps are float32 sums in another order
(``tests/test_torch_gas.py``), held to the reference test's rtol 1e-3,
atol 1e-5 against a cold run.  Each controller test of
``tests/test_serving.py`` has a counterpart here; the ones that race
threads run on the port alone, with the reference test's assertions.
"""

from __future__ import annotations

import threading
import time

import jax
import numpy as np
import pytest
import torch

import repro.incremental as JI
import repro.serving as JS
import repro.streaming as js
from repro.core import S5PConfig as JConfig
from repro.kernels.stream_scan import GreedyCarry as JGreedy
from repro.kernels.stream_scan import GridCarry as JGrid
from repro.kernels.stream_scan import HdrfCarry as JHdrf
from repro_torch import random as trandom
from repro_torch.core.metrics import replication_factor
from repro_torch.core.s5p import S5PConfig
from repro_torch.gas import pagerank
from repro_torch.graphs import block_rmat_graph, community_graph
from repro_torch.incremental import S5PWindowChain
from repro_torch.kernels.stream_scan import GreedyCarry, GridCarry, HdrfCarry
from repro_torch.launch.serve import serve_graph
from repro_torch.serving import BundleRegistry, GASServer, ServingController
from repro_torch.streaming import EdgeStream, run_carry, run_retract
from repro_torch.streaming.carry import tree_flatten, tree_leaves, tree_unflatten
from test_torch_incremental import same_bundle, same_result

CPU = "cpu"
K = 4


@pytest.fixture(autouse=True)
def _threefry_partitionable():
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    with trandom.threefry_partitionable(True):
        yield
    jax.config.update("jax_threefry_partitionable", prev)


def _small_graph(seed=0):
    return community_graph(512, n_communities=8, avg_degree=6, p_intra=0.9, seed=seed)


def _recording(base):
    """A registry of ``base``'s class that keeps every published bundle."""

    class _Rec(base):
        def __init__(self):
            super().__init__()
            self.published = []

        def publish(self, bundle):
            self.published.append(bundle)
            super().publish(bundle)

    return _Rec()


def _pair(src, dst, n, window, step, *, k=K, chunk=None, cfg_kw=None, **kw):
    """The same chain and controller in each package."""
    cfg_kw = dict(k=k, seed=0, chunk_size=chunk or max(window, 256), **(cfg_kw or {}))
    jchain = JI.S5PWindowChain(src, dst, n, JConfig(**cfg_kw), window, step_edges=step, **kw)
    tchain = S5PWindowChain(src, dst, n, S5PConfig(**cfg_kw), window, step_edges=step,
                            device=CPU, **kw)
    jreg, reg = _recording(JS.BundleRegistry), _recording(BundleRegistry)
    return (JS.ServingController(jreg, jchain), jreg), (ServingController(reg, tchain), reg)


def _same_published(jreg, reg):
    assert len(jreg.published) == len(reg.published)
    for a, b in zip(jreg.published, reg.published):
        for f in ("version", "origin", "k", "lo", "hi", "n_vertices", "rf", "balance",
                  "fingerprint"):
            assert getattr(a, f) == getattr(b, f), (a.version, f)
        for f in ("src", "dst", "parts"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        b.check()
    assert jreg.current_version == reg.current_version
    assert jreg.swap_count == reg.swap_count


def _step_both(jctl, ctl):
    js_, ts = jctl.step(), ctl.step()
    assert (js_ is None) == (ts is None)
    if js_ is not None:
        same_result(js_, ts)
    return ts


def test_versions_origins_and_parts_equal_the_reference():
    """A whole churn schedule with a resize and a forced cold restart in
    the middle: every published version equal, the chains' bundles too."""
    src, dst, n = _small_graph(13)
    E = src.size
    (jctl, jreg), (ctl, reg) = _pair(src, dst, n, E // 3, E // 6, chunk=max(E // 3, 256))
    assert jctl.resize(K + 1) is None and ctl.resize(K + 1) is None  # filling: k only
    assert ctl.chain.config.k == K + 1
    while reg.current is None:
        assert _step_both(jctl, ctl) is not None
    _step_both(jctl, ctl)
    jres, res = jctl.resize(K + 3), ctl.resize(K + 3)
    assert tuple(jres) == tuple(res) and reg.current.origin == "resize"
    _step_both(jctl, ctl)
    assert jctl.request_cold_restart() and ctl.request_cold_restart()
    assert reg.current.origin == "cold-restart"
    while _step_both(jctl, ctl) is not None:
        pass
    _same_published(jreg, reg)
    same_bundle(jctl.chain.bundle, ctl.chain.bundle, "final")
    origins = [b.origin for b in reg.published]
    assert origins[0] == "cold" and "resize" in origins and "cold-restart" in origins
    assert ctl.version == jctl.version == len(reg.published)
    assert ctl.n_live_edges == jctl.n_live_edges == reg.current.n_edges
    assert ctl.done.is_set() and len(ctl.history) == len(jctl.history)


# ================================================ 4b. cold restart acted on

def test_auto_cold_restart_acts_and_swaps():
    src, dst, n = _small_graph(10)
    E = src.size
    # a fixed window never drifts ξ: the trigger is forced, the acting is tested
    (jctl, jreg), (ctl, reg) = _pair(src, dst, n, E // 3, E // 6, chunk=max(E // 3, 256),
                                     cfg_kw=dict(xi_refresh_threshold=-1.0),
                                     auto_cold_restart=True)
    jctl.run()
    ctl.run()
    for a, b in zip(jctl.history, ctl.history):
        same_result(a, b)
    _same_published(jreg, reg)
    restarts = [r for r in ctl.history if not r.filling and r.cold_restarted]
    assert restarts and all(r.needs_cold_restart and r.rf > 0 for r in restarts)
    assert reg.swap_count >= 1 and reg.current.origin == "cold-restart"
    s, d, p = ctl.chain.live_partition()
    assert reg.current.n_edges == s.size and np.all(p >= 0)


def test_request_cold_restart_publishes_swap():
    src, dst, n = _small_graph(8)
    E = src.size
    (jctl, jreg), (ctl, reg) = _pair(src, dst, n, E // 2, E // 4, chunk=max(E // 2, 256),
                                     auto_cold_restart=False)
    assert not ctl.request_cold_restart() and not jctl.request_cold_restart()
    while reg.current is None:
        assert _step_both(jctl, ctl) is not None
    v0, rf0 = reg.current_version, reg.current.rf
    assert ctl.request_cold_restart() and jctl.request_cold_restart()
    assert reg.current_version == v0 + 1 and reg.current.origin == "cold-restart"
    _same_published(jreg, reg)
    same_bundle(jctl.chain.bundle, ctl.chain.bundle, "restart")
    s, d, p = ctl.chain.live_partition()
    assert reg.current.n_edges == s.size and np.all(p >= 0)
    want = replication_factor(torch.from_numpy(s), torch.from_numpy(d), torch.from_numpy(p),
                              n_vertices=n, k=K)
    assert reg.current.rf == pytest.approx(float(want)) and rf0 > 0


# ================================================ 4d. origin provenance

def test_first_published_version_origin_is_cold():
    src, dst, n = _small_graph(11)
    E = src.size
    (jctl, jreg), (ctl, reg) = _pair(src, dst, n, E // 2, E // 4, chunk=max(E // 2, 256))
    while reg.current is None:
        assert _step_both(jctl, ctl) is not None
    assert reg.current.version == 1 and reg.current.origin == "cold"
    while _step_both(jctl, ctl) is not None:
        pass
    _same_published(jreg, reg)
    assert reg.current.version > 1 and reg.current.origin != "cold"


# ================================================ 4e. restart/ingest race

def test_cold_restart_races_background_ingest():
    src, dst, n = _small_graph(12)
    E = src.size
    cfg = S5PConfig(k=K, seed=0, chunk_size=max(E // 4, 256))
    chain = S5PWindowChain(src, dst, n, cfg, E // 4, step_edges=E // 16, device=CPU)
    reg = BundleRegistry()
    controller = ServingController(reg, chain)
    errors: list[BaseException] = []

    def restarter():
        try:
            while not controller.done.is_set():
                controller.request_cold_restart()
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    t = threading.Thread(target=restarter)
    controller.start()
    t.start()
    controller.join(120)
    t.join(120)
    assert not errors, errors
    assert controller.done.is_set()
    b = reg.current
    b.check()
    s, d, p = chain.live_partition()
    assert b.n_edges == s.size
    np.testing.assert_array_equal(b.parts, p)
    assert np.all(p >= 0)
    assert any(r.cold_restarted for r in controller.history) or controller.version > len(
        [r for r in controller.history if not getattr(r, "filling", False)])
    with pytest.raises(RuntimeError, match="already started"):
        controller.start()


# ================================================ 4f. elastic resize swap

def test_resize_publishes_swap_and_keeps_serving():
    """The resize lands as one more swap (origin "resize", the reference's
    bits); a reader that pinned the previous version still reads k, and
    churn publishes at k′ afterwards."""
    src, dst, n = _small_graph(13)
    E = src.size
    (jctl, jreg), (ctl, reg) = _pair(src, dst, n, E // 3, E // 6, chunk=max(E // 3, 256))
    # while filling only k changes: the cold start runs at K + 2
    assert ctl.resize(K + 2) is None and jctl.resize(K + 2) is None
    while reg.current is None:
        assert _step_both(jctl, ctl) is not None
    v0, k0, k2 = reg.current_version, reg.current.k, K + 4
    assert k0 == K + 2
    with reg.pin() as held:
        jres, res = jctl.resize(k2), ctl.resize(k2)
        assert held.version == v0 and held.k == k0  # the pinned reader still reads k
        held.check()
    assert tuple(jres) == tuple(res) and res.k_new == k2
    assert res.migrated_fraction < 1.0
    assert reg.current_version == v0 + 1 and reg.current.origin == "resize"
    assert reg.current.k == k2 and np.all(reg.current.parts < k2)
    reg.current.check()
    server = GASServer(reg)
    server.run(2)
    assert _step_both(jctl, ctl) is not None
    while _step_both(jctl, ctl) is not None:
        pass
    _same_published(jreg, reg)
    assert reg.current.k == k2 and np.all(reg.current.parts < k2)
    assert reg.current_version > v0 + 1


# ================================================ 4c. sharded retraction

@pytest.mark.parametrize("name", ["greedy", "hdrf", "grid"])
def test_parallel_retraction_bit_parity(name):
    src, dst, n = _small_graph(9)
    E = src.size
    if name == "greedy":
        jpc, pc = JGreedy(n, K), GreedyCarry(n, K, device=CPU)
    elif name == "hdrf":
        jpc, pc = JHdrf(n, K, 1.1), HdrfCarry(n, K, 1.1, device=CPU)
    else:
        rng = np.random.default_rng(0)
        row = rng.integers(0, 2, n).astype(np.int32)
        col = rng.integers(0, 2, n).astype(np.int32)
        jpc, pc = JGrid(K, row, col, 2), GridCarry(K, row, col, 2, device=CPU)
    jparts, jcarry = js.run_carry(js.EdgeStream(src, dst, n, chunk_size=128), jpc)
    parts, carry = run_carry(EdgeStream(src, dst, n, chunk_size=128, device=CPU), pc)
    parts = parts.numpy()
    np.testing.assert_array_equal(np.asarray(jparts), parts)
    idx = np.arange(0, E, 3, dtype=np.int64)
    jback = js.EdgeStream(src[idx], dst[idx], n, chunk_size=64)
    want = js.run_retract(jback, jpc, parts[idx], carry=jcarry)

    leaves, spec = tree_flatten(carry)

    def back(**kw):
        start = tree_unflatten(spec, [x.clone() if isinstance(x, torch.Tensor) else x
                                      for x in leaves])
        got = run_retract(EdgeStream(src[idx], dst[idx], n, chunk_size=64, device=CPU), pc,
                          parts[idx], carry=start, **kw)
        for a, b in zip(jax.tree_util.tree_leaves(want), tree_leaves(got)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        return tree_leaves(got)

    seq = back()
    back(num_streams=3)
    back(num_streams=3, backend="vmap")
    assert not all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(seq, leaves))


# ================================================ 8. reader backpressure

def test_backpressure_max_lag_blocks_behind_slow_reader():
    src, dst, n = _small_graph(5)
    E = src.size
    cfg = S5PConfig(k=K, seed=0, chunk_size=max(E, 256))
    chain = S5PWindowChain(src, dst, n, cfg, E // 2, step_edges=E // 12, device=CPU)
    reg = BundleRegistry()
    controller = ServingController(reg, chain)
    while reg.current is None:
        assert controller.step() is not None
    assert reg.reader_lag() == 0
    pin_cm = reg.pin()
    held = pin_cm.__enter__()
    try:
        v0 = held.version
        assert reg.oldest_pinned_version() == v0
        controller.start(max_lag=1)
        assert reg.wait_version(v0 + 1, timeout=60)
        assert not controller.done.wait(0.5)
        assert reg.current_version <= v0 + 2
        assert reg.reader_lag() <= 2
        assert not controller.done.is_set()
        blocked_at = reg.current_version
    finally:
        pin_cm.__exit__(None, None, None)
    assert controller.done.wait(120)
    controller.join(5)
    assert reg.current_version > blocked_at
    assert reg.active_pins == 0


def test_backpressure_rejects_negative_lag():
    controller = ServingController(BundleRegistry(), object())
    with pytest.raises(ValueError):
        controller.start(max_lag=-1)
    assert controller._thread is None


def test_stop_ends_the_ingest_thread():
    src, dst, n = _small_graph(2)
    E = src.size
    chain = S5PWindowChain(src, dst, n, S5PConfig(k=K, seed=0, chunk_size=max(E, 256)),
                           E // 2, step_edges=E // 12, device=CPU)
    reg = BundleRegistry()
    controller = ServingController(reg, chain)
    controller.start(throttle_s=0.05)
    assert reg.wait_version(1, timeout=60)
    controller.stop()
    controller.join(60)
    assert controller.done.is_set()
    assert len(controller.history) < chain.n_steps


# ================================================ 9. multi-reader fan-out

def test_fanout_eight_readers_under_churn():
    src, dst, n = _small_graph(6)
    E = src.size
    cfg = S5PConfig(k=K, seed=0, chunk_size=max(E, 256))
    chain = S5PWindowChain(src, dst, n, cfg, E // 2, step_edges=E // 4, device=CPU)
    reg = BundleRegistry()
    controller = ServingController(reg, chain)
    servers = [GASServer(reg) for _ in range(8)]
    stop = threading.Event()
    errors: list[BaseException] = []

    def reader(srv):
        seen = -1
        try:
            while not stop.is_set():
                with reg.pin() as b:
                    if b is None:
                        time.sleep(0.01)
                        continue
                    b.check()
                    assert b.version >= seen
                    seen = b.version
                srv.superstep()
                time.sleep(0.005)
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=reader, args=(s,)) for s in servers]
    for t in threads:
        t.start()
    controller.start()
    assert controller.done.wait(180)
    controller.join(5)
    stop.set()
    for t in threads:
        t.join()
    assert not errors, errors
    assert reg.active_pins == 0
    assert reg.swap_count == controller.version - 1
    assert reg.versions_retired == reg.swap_count
    b = reg.current
    b.check()
    cold_vals, _ = pagerank(b.gas, iterations=300)
    for srv in servers:
        srv.run_to_convergence(tol=1e-7, max_steps=300)
        np.testing.assert_allclose(srv.values.numpy(), cold_vals.numpy(),
                                   rtol=1e-3, atol=1e-5)


# ================================================ 2./3. the serving loop

def _serve_chain(src, dst, n, *, window, step, seed=0, supersteps_per_swap=2):
    (jctl, jreg), (ctl, reg) = _pair(src, dst, n, window, step, auto_cold_restart=True)
    server = GASServer(reg)
    rng = np.random.default_rng(seed)
    last = -1
    while _step_both(jctl, ctl) is not None:
        if reg.current_version == last:
            continue
        last = reg.current_version
        server.run(supersteps_per_swap)
        server.query_pagerank(rng.integers(0, n, 8))
    _same_published(jreg, reg)
    return server, ctl, reg


def test_serving_smoke_two_swaps_and_exact_bytes():
    src, dst, n = block_rmat_graph(block_scale=5, n_blocks=8, edge_factor=6, seed=0)
    E = src.size
    server, controller, reg = _serve_chain(src, dst, n, window=E // 2, step=E // 6)
    s = server.metrics.summary()
    assert s["swaps_observed"] >= 2 and controller.version >= 3
    assert reg.active_pins == 0
    b = reg.current
    b.check()
    key = np.stack([np.concatenate([b.src, b.dst]), np.concatenate([b.parts, b.parts])],
                   axis=1)
    counts = np.bincount(np.unique(key, axis=0)[:, 0], minlength=n)
    mirrors = int(np.maximum(counts - 1, 0).sum())
    assert b.bytes_per_superstep() == 2 * mirrors * 8
    assert server.metrics.supersteps[-1].version == b.version
    assert server.metrics.supersteps[-1].sync_bytes == 2 * mirrors * 8


def test_pagerank_under_churn_matches_from_scratch():
    src, dst, n = _small_graph(3)
    E = src.size
    server, controller, reg = _serve_chain(src, dst, n, window=E // 2, step=E // 4)
    assert server.metrics.swaps_observed >= 1
    server.run_to_convergence(tol=1e-7, max_steps=300)
    cold_vals, _ = pagerank(reg.current.gas, iterations=300)
    np.testing.assert_allclose(server.values.numpy(), cold_vals.numpy(),
                               rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("background", [False, True])
def test_serve_graph_publishes_the_reference_versions(background, capsys):
    """``serve_graph`` (the CLI's ``--graph``) on the CPU: the same window
    chain as the reference's, so the same versions and final partition;
    with a background ingest thread every version is still published."""
    from repro.launch.serve import serve_graph as j_serve_graph

    server, controller = serve_graph("block-rmat", window_edges=2048, background=background,
                                     device=CPU)
    out = capsys.readouterr().out
    assert "[serve] graph=block-rmat V=1024" in out and "versions=" in out
    assert controller.done.is_set() or not background
    if background:
        assert controller.version >= 2 and server.metrics.n_supersteps > 0
        return
    jserver, jcontroller = j_serve_graph("block-rmat", window_edges=2048, verbose=False)
    assert controller.version == jcontroller.version
    np.testing.assert_array_equal(controller.registry.current.parts,
                                  jcontroller.registry.current.parts)
    assert controller.registry.current.rf == jcontroller.registry.current.rf
    np.testing.assert_allclose(server.values.numpy(), np.asarray(jserver.values),
                               rtol=1e-3, atol=1e-5)
