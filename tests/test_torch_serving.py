"""Port parity for serving's read side.

``repro_torch.serving`` against the live ``repro.serving`` on the same
edges and parts: bundle fingerprints equal; the registry's pin, refcount
and retire behaviour as ``tests/test_serving.py`` pins it (the writer
side, ``ServingController``, is held in ``test_torch_controller.py``);
``GASServer`` PageRank values after n
super-steps within rtol 1e-5 (float32 sums in another order, as in
``test_torch_gas.py``); component labels exact; ``query_gnn`` within the
GCN tolerance of ``test_torch_gnn.py`` (rtol 1e-5, atol 1e-6), against
both the reference's ``query_gnn`` and its ``gcn_forward``.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import gnn as jgnn
from repro.serving import BundleRegistry as JRegistry
from repro.serving import GASServer as JServer
from repro.serving import build_bundle as jbuild
from repro_torch import interop
from repro_torch.graphs import community_graph
from repro_torch.models import gnn as tgnn
from repro_torch.serving import BundleRegistry, GASServer, build_bundle

K = 4
RTOL, ATOL = 1e-5, 1e-6


def _small_graph(seed=0):
    return community_graph(512, n_communities=8, avg_degree=6, p_intra=0.9, seed=seed)


def _bundle(version, src, dst, parts, n, **kw):
    return build_bundle(version, src, dst, parts, n, K, device="cpu", **kw)


@pytest.mark.parametrize("version", [1, 7, 2**40])
@pytest.mark.parametrize("seed", [0, 4])
def test_bundle_fingerprint_and_bytes_match_reference(version, seed):
    src, dst, n = _small_graph(seed)
    parts = np.random.default_rng(seed).integers(0, K, src.size).astype(np.int32)
    ours = _bundle(version, src, dst, parts, n, rf=1.5, balance=1.01, lo=3, hi=9)
    ref = jbuild(version, src, dst, parts, n, K, rf=1.5, balance=1.01, lo=3, hi=9)
    assert ours.fingerprint == ref.fingerprint
    assert ours.bytes_per_superstep() == ref.bytes_per_superstep()
    assert (ours.n_edges, ours.lo, ours.hi, ours.origin) == (ref.n_edges, 3, 9, "cold")
    np.testing.assert_array_equal(ours.out_deg_inv.numpy(), np.asarray(ref.out_deg_inv))
    assert torch.equal(ours.edge_src, torch.from_numpy(src))
    ours.check()
    torn = ours._replace(parts=np.ones(src.size, np.int32))
    with pytest.raises(AssertionError, match="torn"):
        torn.check()


def test_bundle_copies_its_inputs():
    src, dst, n = _small_graph()
    parts = np.zeros(src.size, np.int32)
    b = _bundle(1, src, dst, parts, n)
    parts[:] = 3
    src[0] = dst[0]
    b.check()
    assert not b.parts.any()


def test_registry_pin_refcount_and_retirement():
    src, dst, n = _small_graph()
    reg = BundleRegistry()
    assert reg.current is None and reg.current_version == -1
    with reg.pin() as b:
        assert b is None
    parts = np.zeros(src.size, np.int32)
    reg.publish(_bundle(1, src, dst, parts, n))
    assert reg.swap_count == 0 and reg.current_version == 1
    with reg.pin() as b1:
        b1.check()
        assert reg.active_pins == 1 and reg.oldest_pinned_version() == 1
        reg.publish(_bundle(2, src, dst, parts, n))
        # superseded version stays valid while pinned
        assert reg.swap_count == 1 and reg.versions_retired == 0
        assert reg.reader_lag() == 1
        b1.check()
        assert b1.version == 1
    assert reg.versions_retired == 1  # retired when the last pin dropped
    assert reg.reader_lag() == 0 and reg.oldest_pinned_version() == -1
    with reg.pin() as b2:
        assert b2.version == 2
    assert reg.active_pins == 0
    reg.publish(_bundle(3, src, dst, parts, n))  # nothing pinned: retired at once
    assert reg.swap_count == 2 and reg.versions_retired == 2


def test_registry_swap_atomicity_under_thread_churn():
    """Readers pinning during concurrent publishes never see a torn bundle,
    and versions advance monotonically per reader."""
    src, dst, n = _small_graph()
    rng = np.random.default_rng(0)
    reg = BundleRegistry()
    stop = threading.Event()
    errors: list[BaseException] = []

    def reader():
        seen = -1
        try:
            while not stop.is_set():
                with reg.pin() as b:
                    if b is None:
                        continue
                    b.check()
                    assert b.version >= seen
                    seen = b.version
                    assert b.parts.shape == b.src.shape == b.dst.shape
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=reader) for _ in range(4)]
    for t in threads:
        t.start()
    for v in range(1, 30):
        m = int(rng.integers(50, src.size))
        parts = rng.integers(0, K, m).astype(np.int32)
        reg.publish(_bundle(v, src[:m], dst[:m], parts, n))
    stop.set()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errors, errors
    assert reg.swap_count == 28 and reg.versions_retired == 28
    assert reg.active_pins == 0


def test_wait_version_and_reader_lag_backpressure():
    src, dst, n = _small_graph()
    parts = np.zeros(src.size, np.int32)
    reg = BundleRegistry()
    assert not reg.wait_version(1, timeout=0.01)
    assert reg.wait_reader_lag(0, timeout=0.01)
    reg.publish(_bundle(1, src, dst, parts, n))
    assert reg.wait_version(1, timeout=1.0)
    released = threading.Event()

    def slow_reader():
        with reg.pin():
            released.wait(timeout=30)

    t = threading.Thread(target=slow_reader)
    t.start()
    deadline = time.monotonic() + 30
    while reg.active_pins == 0 and time.monotonic() < deadline:
        time.sleep(0.001)
    assert reg.active_pins == 1
    reg.publish(_bundle(2, src, dst, parts, n))
    reg.publish(_bundle(3, src, dst, parts, n))
    assert reg.reader_lag() == 2
    assert not reg.wait_reader_lag(1, timeout=0.05)
    released.set()
    assert reg.wait_reader_lag(1, timeout=30)
    t.join(timeout=30)
    assert not t.is_alive() and reg.reader_lag() == 0


def _servers(seed=4, n_steps=5):
    src, dst, n = _small_graph(seed)
    parts = (src % K).astype(np.int32)
    jreg, treg = JRegistry(), BundleRegistry()
    jreg.publish(jbuild(1, src, dst, parts, n, K))
    treg.publish(_bundle(1, src, dst, parts, n))
    js, ts = JServer(jreg), GASServer(treg)
    jrec, trec = js.run(n_steps), ts.run(n_steps)
    return (src, dst, n), js, ts, jrec, trec


@pytest.mark.parametrize("n_steps", [1, 5, 20])
def test_pagerank_supersteps_match_reference(n_steps):
    _, js, ts, jrec, trec = _servers(n_steps=n_steps)
    assert [tuple(r) for r in trec] == [tuple(r) for r in jrec]
    np.testing.assert_allclose(ts.values.numpy(), np.asarray(js.values), rtol=RTOL)
    vs = [0, 3, 100, 511]
    np.testing.assert_allclose(ts.query_pagerank(vs), js.query_pagerank(vs), rtol=RTOL)
    assert ts.metrics.summary().keys() == js.metrics.summary().keys()
    assert ts.metrics.total_sync_bytes == js.metrics.total_sync_bytes


def test_components_exact_and_queries_timed():
    (src, dst, n), js, ts, _, _ = _servers()
    for it in (1, 3, 5):
        got, want = ts.query_components(iterations=it), js.query_components(iterations=it)
        assert got.dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got, np.asarray(want))
    assert len(ts.metrics.query_latency_us) == 3
    assert all(t > 0 for t in ts.metrics.query_latency_us)


def test_empty_registry_queries():
    s = GASServer(BundleRegistry())
    assert s.superstep() is None and s.run(3) == []
    np.testing.assert_array_equal(s.query_pagerank([1, 2]), np.zeros(2, np.float32))
    assert s.query_components() is None
    assert s.query_gnn({}, None, None) is None


def test_run_to_convergence_matches_reference():
    _, js, ts, _, _ = _servers(n_steps=2)
    steps_j = js.run_to_convergence(tol=1e-6, max_steps=300)
    steps_t = ts.run_to_convergence(tol=1e-6, max_steps=300)
    assert abs(steps_j - steps_t) <= 2
    np.testing.assert_allclose(ts.values.numpy(), np.asarray(js.values), rtol=1e-4)
    assert GASServer.comm_of(ts.registry.current) == JServer.comm_of(js.registry.current)


@pytest.mark.parametrize("vertices", [None, [0, 5], [511, 2, 2]])
def test_query_gnn_matches_reference(vertices):
    """``tests/test_serving.py::test_queries_over_pinned_bundle``, both sides."""
    (src, dst, n), js, ts, _, _ = _servers()
    jcfg = jgnn.GCNConfig(n_layers=2, d_hidden=8, d_feat=4, n_classes=3)
    tcfg = tgnn.GCNConfig(n_layers=2, d_hidden=8, d_feat=4, n_classes=3)
    params = jgnn.gcn_init(jcfg, jax.random.PRNGKey(0))
    feats = np.array(jax.random.normal(jax.random.PRNGKey(1), (n, 4)))
    want = js.query_gnn(params, jnp.asarray(feats), jcfg, vertices=vertices)
    got = ts.query_gnn(interop.gcn_params(params, device="cpu"), feats, tcfg,
                       vertices=vertices)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    full = np.asarray(jgnn.gcn_forward(params, jnp.asarray(feats), src, dst, n, jcfg))
    np.testing.assert_allclose(got, full if vertices is None else full[vertices],
                               rtol=RTOL, atol=ATOL)
