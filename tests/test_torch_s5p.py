"""Port parity for slice 1 as a whole: ``repro_torch.core.s5p.s5p_partition``
on the CPU is bitwise equal to the live ``repro.core.s5p.s5p_partition``
(parts, cluster assignment, game rounds), and RF and balance are equal."""

import jax
import numpy as np
import pytest
import torch
from proptest import random_graph

from repro.core import S5PConfig as JConfig
from repro.core import s5p_partition as jax_s5p
from repro.core.metrics import load_balance as j_balance
from repro.core.metrics import replication_factor as j_rf
from repro.graphs.generators import community_graph
from repro_torch.core import metrics as tmetrics
from repro_torch.core.s5p import S5PConfig, s5p_partition


@pytest.fixture(autouse=True)
def _threefry_partitionable():
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", prev)


def _check(src, dst, n, **kw):
    ref = jax_s5p(src, dst, n, JConfig(**kw))
    out = s5p_partition(src, dst, n, S5PConfig(**kw), device="cpu")
    np.testing.assert_array_equal(np.asarray(ref.parts), out.parts.numpy())
    np.testing.assert_array_equal(np.asarray(ref.cluster_assignment),
                                  out.cluster_assignment)
    assert (ref.n_clusters, ref.n_head_clusters, int(ref.game_rounds),
            bool(ref.game_converged), ref.xi, ref.kappa, ref.max_load) == (
        out.n_clusters, out.n_head_clusters, out.game_rounds,
        out.game_converged, out.xi, out.kappa, out.max_load)
    k = kw["k"]
    s, d = torch.from_numpy(src), torch.from_numpy(dst)
    assert j_rf(src, dst, ref.parts, n_vertices=n, k=k) == tmetrics.replication_factor(
        s, d, out.parts, n_vertices=n, k=k)
    assert j_balance(ref.parts, k=k) == tmetrics.load_balance(out.parts, k=k)
    return out


@pytest.mark.parametrize("use_cms", [True, False])
@pytest.mark.parametrize("seed", range(4))
def test_random_graphs(seed, use_cms):
    src, dst, n, _ = random_graph(seed)
    _check(src, dst, n, k=4, use_cms=use_cms)


@pytest.mark.parametrize("seed", [1, 2])
def test_bounded_s5p_b(seed):
    src, dst, n, _ = random_graph(seed)
    _check(src, dst, n, k=4, bounded=True)


@pytest.mark.parametrize("seed", [1, 2])
def test_one_stage(seed):
    src, dst, n, _ = random_graph(seed)
    _check(src, dst, n, k=4, one_stage=True)


@pytest.mark.parametrize("ordering", ["shuffled", "windowed"])
def test_orderings_and_small_chunks(ordering):
    src, dst, n, _ = random_graph(1)
    _check(src, dst, n, k=3, ordering=ordering, chunk_size=32, seed=2)


@pytest.mark.parametrize("use_cms", [True, False])
def test_community_fixture_k8(community_bench_graph, use_cms):
    src, dst, n = community_bench_graph
    np.testing.assert_array_equal(
        src, community_graph(2000, n_communities=32, avg_degree=8, seed=5)[0])
    out = _check(src, dst, n, k=8, use_cms=use_cms)
    assert out.timings.keys() >= {"clustering", "statistics", "game", "postprocess"}


def test_unported_options_raise():
    """No option raises any more: ``host_budget`` (the hybrid's knob) is
    accepted and ignored by ``s5p_partition``, as in the reference."""
    src, dst, n, _ = random_graph(2)
    cfg = S5PConfig(k=4, host_budget=1 << 20)
    assert cfg.host_budget == 1 << 20
    with_budget = s5p_partition(src, dst, n, cfg, device="cpu")
    without = s5p_partition(src, dst, n, S5PConfig(k=4), device="cpu")
    ref = jax_s5p(src, dst, n, JConfig(k=4, host_budget=1 << 20))
    np.testing.assert_array_equal(with_budget.parts.numpy(), without.parts.numpy())
    np.testing.assert_array_equal(np.asarray(ref.parts), with_budget.parts.numpy())
    # the parallel-ingest options, the touch-up and the drift knobs of
    # incremental re-partitioning are ported
    for kw in ({"num_streams": 2}, {"shard": "hub"}, {"super_chunk": 4},
               {"super_chunk": "auto"}, {"touch_up": False}, {"refine_rounds": 3},
               {"drift_rf_threshold": 0.1}, {"drift_balance_threshold": 0.2},
               {"drift_churn_threshold": 0.5}, {"xi_refresh_threshold": 0.1}):
        cfg = S5PConfig(k=4, **kw)
        assert all(getattr(cfg, key) == v for key, v in kw.items())


def test_no_valid_edges():
    src = np.array([1, 2], np.int32)
    out = s5p_partition(src, src, 3, S5PConfig(k=2), device="cpu")
    assert out.n_clusters == 0 and out.parts.tolist() == [-1, -1]
