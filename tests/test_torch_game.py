"""Port parity: the Alg. 2 Stackelberg game.  Game inputs computed by the
reference pipeline are carried across with ``repro_torch.interop``; both
sides must return the same assignment, rounds and convergence flag."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from proptest import random_graph

from repro.core import clustering as jcl
from repro.core import game as jgame
from repro.core.s5p import cluster_statistics
from repro.graphs.generators import community_graph
from repro_torch import interop
from repro_torch.core import game as tgame


@pytest.fixture(autouse=True)
def _threefry_partitionable():
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", prev)


def _game_inputs(graph, k, use_cms, one_stage):
    src, dst, n = graph
    deg = jcl.compute_degrees(src, dst, n)
    xi = int(2.0 * src.size / n)
    kappa = max(int(np.ceil(2.0 * src.size / k)), 2)
    state = jcl.cluster_stream(src, dst, n, xi=xi, kappa=kappa)
    res = jcl.compact_clusters(state, deg, xi)
    sizes, pa, pb, pw, _ = cluster_statistics(
        jnp.asarray(src), jnp.asarray(dst), res, deg, xi, use_cms=use_cms,
        cms_epsilon=0.1, cms_nu=0.01, seed=0)
    n_head = res.n_clusters if one_stage else res.n_head
    inputs = jgame.GameInputs(sizes=sizes.astype(jnp.float32), pair_a=pa, pair_b=pb,
                              pair_w=pw.astype(jnp.float32), n_head=n_head, k=k)
    return inputs, res.n_clusters


def _graph(name):
    if name == "community":
        return community_graph(600, n_communities=8, avg_degree=6, seed=3)
    src, dst, n, _ = random_graph(int(name))
    return src, dst, n


@pytest.mark.parametrize("one_stage", [False, True])
@pytest.mark.parametrize("accept_prob", [0.9, 1.0])
@pytest.mark.parametrize("graph,k,use_cms", [("0", 4, True), ("1", 4, False),
                                             ("2", 3, True), ("community", 8, True)])
def test_run_game_identical(graph, k, use_cms, accept_prob, one_stage):
    inputs, C = _game_inputs(_graph(graph), k, use_cms, one_stage)
    # the scatter-adds of the port sum integer-valued float32 Θ in another
    # order than the reference; that is exact only below 2**24
    sizes, pw = np.asarray(inputs.sizes), np.asarray(inputs.pair_w)
    assert np.all(pw == np.round(pw)) and np.all(2 * sizes == np.round(2 * sizes))
    assert 2 * pw.sum() + sizes.sum() < 2**23
    bs = jgame.default_batch_size(256, C)
    kw = dict(batch_size=bs, max_rounds=64, accept_prob=accept_prob, seed=3)
    ref = jgame.run_game(inputs, C, **kw)
    port_inputs = interop.game_inputs(inputs, device="cpu")
    port = tgame.run_game(port_inputs, C, **kw)
    np.testing.assert_array_equal(np.asarray(ref.assignment), port.assignment.numpy())
    assert (int(ref.rounds), bool(ref.converged)) == (port.rounds, port.converged)

    degs_ref = jgame._cluster_degrees(inputs, C)
    degs = tgame._cluster_degrees(port_inputs, C)
    np.testing.assert_array_equal(np.asarray(degs_ref), degs.numpy())
    d_ref = jgame.compute_delta(inputs.sizes, degs_ref, k)
    d = tgame.compute_delta(port_inputs.sizes, degs, k)
    assert np.float32(d_ref).view(np.uint32) == d.numpy().view(np.uint32)
    np.testing.assert_array_equal(
        np.asarray(jgame._neighbor_partition_weight(inputs, ref.assignment, C)),
        tgame._neighbor_partition_weight(port_inputs, port.assignment, C).numpy())
    assert float(jgame.best_response_gap(inputs, ref.assignment, C)) == float(
        tgame.best_response_gap(port_inputs, port.assignment, C))
    np.testing.assert_allclose(
        float(jgame.social_welfare(inputs, ref.assignment, d_ref)),
        float(tgame.social_welfare(port_inputs, port.assignment, d)), rtol=1e-6)


def test_given_start_assignment_and_delta():
    inputs, C = _game_inputs(_graph("community"), 8, True, False)
    rng = np.random.default_rng(0)
    assign0 = rng.integers(0, 8, C).astype(np.int32)
    kw = dict(batch_size=16, max_rounds=8, accept_prob=0.7, seed=1, delta=0.01)
    ref = jgame.run_game(inputs, C, assign0=assign0, **kw)
    port_inputs, a0 = interop.game_inputs(inputs, device="cpu", assign0=assign0)
    port = tgame.run_game(port_inputs, C, assign0=a0.numpy(), **kw)
    np.testing.assert_array_equal(np.asarray(ref.assignment), port.assignment.numpy())
    assert int(ref.rounds) == port.rounds


def test_init_assignment_and_batch_size():
    sizes = np.random.default_rng(1).random(50).astype(np.float32)
    np.testing.assert_array_equal(jgame.init_assignment(sizes, 4),
                                  tgame.init_assignment(torch.from_numpy(sizes), 4))
    for req, c in [(256, 10), (256, 100000), (32, 4000)]:
        assert jgame.default_batch_size(req, c) == tgame.default_batch_size(req, c)


def test_masked_game_raises():
    """The masked game and its migration cost are ported
    (tests/test_torch_elastic.py holds the cost to the reference at several
    scales): with ``move_mask`` given, a cost or a home alone plays the
    reference's game bit for bit."""
    inputs, C = _game_inputs(_graph("0"), 4, False, False)
    ti = interop.game_inputs(inputs, device="cpu")
    for kw in ({"move_cost": np.ones(C, np.float32)}, {"home": np.zeros(C, np.int32)}):
        ref = jgame.run_game(inputs, C, move_mask=np.ones(C, bool), **kw)
        port = tgame.run_game(ti, C, move_mask=np.ones(C, bool), **kw)
        np.testing.assert_array_equal(np.asarray(ref.assignment), port.assignment.numpy())
        assert int(ref.rounds) == port.rounds


@pytest.mark.parametrize("scale", [3001, 4097, 4099, 7919, 8191])
def test_delta_and_game_above_2_24(scale):
    """Θ and the sizes scaled so that Σ(degs + sizes) passes 2**24: there
    the order of δ's sums decides its last bits, so the port sums in the
    order of the reference's ``jnp.sum`` (:func:`repro_torch._fp32.xla_sum_f32`)."""
    inputs, C = _game_inputs(_graph("community"), 8, True, False)
    inputs = inputs._replace(sizes=inputs.sizes * scale, pair_w=inputs.pair_w * scale)
    sizes, pw = np.asarray(inputs.sizes), np.asarray(inputs.pair_w)
    assert np.all(pw == np.round(pw)) and pw.max() < 2**24 and sizes.max() < 2**24
    assert 2 * pw.astype(np.float64).sum() + sizes.astype(np.float64).sum() > 2**24
    port_inputs = interop.game_inputs(inputs, device="cpu")
    degs_ref = jgame._cluster_degrees(inputs, C)
    degs = tgame._cluster_degrees(port_inputs, C)
    np.testing.assert_array_equal(np.asarray(degs_ref), degs.numpy())
    d_ref = jgame.compute_delta(inputs.sizes, degs_ref, 8)
    d = tgame.compute_delta(port_inputs.sizes, degs, 8)
    assert np.float32(d_ref).view(np.uint32) == d.numpy().view(np.uint32)
    kw = dict(batch_size=jgame.default_batch_size(256, C), max_rounds=64,
              accept_prob=0.9, seed=3)
    ref = jgame.run_game(inputs, C, **kw)
    port = tgame.run_game(port_inputs, C, **kw)
    np.testing.assert_array_equal(np.asarray(ref.assignment), port.assignment.numpy())
    assert (int(ref.rounds), bool(ref.converged)) == (port.rounds, port.converged)
    s_ref = np.float32(jgame.social_welfare(inputs, ref.assignment, d_ref))
    s = tgame.social_welfare(port_inputs, port.assignment, d).numpy()
    assert s_ref.view(np.uint32) == s.view(np.uint32)


@pytest.mark.parametrize("kind", ["integer", "normal"])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 118, 1023, 1024, 1025, 1420, 32769, 100_000])
def test_xla_sum_order_equals_jnp_sum(n, kind):
    """Lengths on both sides of the 32-wide windows, one to three levels."""
    from repro_torch._fp32 import xla_sum_f32

    rng = np.random.default_rng(n)
    if kind == "integer":  # partial sums pass 2**24, so the order shows
        v = rng.integers(0, 3001 * 64, n).astype(np.float32)
    else:
        v = rng.standard_normal(n).astype(np.float32)
    want = np.float32(jnp.sum(jnp.asarray(v))).view(np.uint32)
    assert xla_sum_f32(torch.from_numpy(v)).numpy().view(np.uint32) == want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cluster_degrees_above_2_24(seed):
    """Cluster degrees ~100× 2**24 (a CMS Θ overestimates them past 2**24 at
    R-MAT scale 20): each segment summed in the reference's order, which
    is not the exact sum."""
    rng = np.random.default_rng(seed)
    C = 50
    a, b = rng.integers(0, C, 20_000), rng.integers(0, C, 20_000)
    a, b = np.minimum(a, b)[a != b], np.maximum(a, b)[a != b]
    w = (rng.integers(1, 3000, a.size) * rng.choice([1, 7, 4099], a.size)).astype(np.float32)
    sizes = rng.integers(1, 100, C).astype(np.float32)
    ji = jgame.GameInputs(jnp.asarray(sizes), jnp.asarray(a, jnp.int32), jnp.asarray(b, jnp.int32),
                          jnp.asarray(w), 5, 8)
    ti = interop.game_inputs(ji, device="cpu")
    want = np.asarray(jgame._cluster_degrees(ji, C))
    got = tgame._cluster_degrees(ti, C).numpy()
    exact = np.zeros(C)
    np.add.at(exact, a, w.astype(np.float64))
    np.add.at(exact, b, w.astype(np.float64))
    assert exact.max() > 2**24 and not np.array_equal(want, exact.astype(np.float32))
    np.testing.assert_array_equal(got, want)
    d_ref = jgame.compute_delta(ji.sizes, jnp.asarray(want), 8)
    assert np.float32(d_ref).view(np.uint32) == tgame.compute_delta(
        ti.sizes, torch.from_numpy(got), 8).numpy().view(np.uint32)


def _hub_inputs(w_scale, size_scale):
    """The community graph's game inputs with the pairs of its largest-degree
    cluster scaled by ``w_scale`` (its W[i, p] passes 2**24 during the
    rounds) and the sizes by ``size_scale`` (a partition passes 2**23):
    odd factors, so the float32 sums past those limits round."""
    inputs, C = _game_inputs(_graph("community"), 8, True, False)
    pa, pb, pw = (np.asarray(x) for x in (inputs.pair_a, inputs.pair_b, inputs.pair_w))
    deg = np.zeros(C + 1)
    np.add.at(deg, pa, pw)
    np.add.at(deg, pb, pw)
    hub = int(np.argmax(deg[:C]))
    w = np.where((pa == hub) | (pb == hub), pw * np.float32(w_scale), pw).astype(np.float32)
    return inputs._replace(sizes=inputs.sizes * np.float32(size_scale),
                           pair_w=jnp.asarray(w)), C


@pytest.mark.parametrize("w_scale,size_scale", [(1, 1), (100_003, 1), (1, 45_001),
                                                (100_003, 45_001), (2_700_001, 56_789)])
def test_game_hub_batches_and_guarded_sizes(w_scale, size_scale):
    """W past 2**24 in a hub batch and partition sizes past 2**23 during the
    rounds: the port's ordered sums and replayed rounds keep the reference's
    assignment, rounds and welfare bits, and its report says they ran."""
    inputs, C = _hub_inputs(w_scale, size_scale)
    kw = dict(batch_size=jgame.default_batch_size(256, C), max_rounds=64,
              accept_prob=0.9, seed=3)
    ref = jgame.run_game(inputs, C, **kw)
    port_inputs = interop.game_inputs(inputs, device="cpu")
    port = tgame.run_game(port_inputs, C, **kw)
    np.testing.assert_array_equal(np.asarray(ref.assignment), port.assignment.numpy())
    assert (int(ref.rounds), bool(ref.converged)) == (port.rounds, port.converged)
    d_ref = jgame.compute_delta(inputs.sizes, jgame._cluster_degrees(inputs, C), 8)
    d = tgame.compute_delta(port_inputs.sizes, tgame._cluster_degrees(port_inputs, C), 8)
    assert np.float32(d_ref).view(np.uint32) == d.numpy().view(np.uint32)
    s_ref = np.float32(jgame.social_welfare(inputs, ref.assignment, d_ref))
    s = tgame.social_welfare(port_inputs, port.assignment, d).numpy()
    assert s_ref.view(np.uint32) == s.view(np.uint32)
    assert float(jgame.best_response_gap(inputs, ref.assignment, C)) == float(
        tgame.best_response_gap(port_inputs, port.assignment, C))
    if w_scale > 1:
        assert port.hub_batches > 0 and port.max_w_hub >= 2**24
        assert port.ordered_sums >= port.hub_batches * port.rounds
    else:
        assert port.hub_batches == 0 and port.max_w_hub == 0
    if size_scale > 1:
        assert port.size_guard and port.replayed_rounds > 0
        assert port.ordered_rounds >= port.replayed_rounds
        assert port.max_part_size >= 2**23
    else:
        assert not port.size_guard and port.replayed_rounds == port.ordered_rounds == 0
    if w_scale == size_scale == 1:
        assert port.ordered_sums == 0


def test_hub_w_in_reference_order():
    """A hub batch's W, summed on the ordered path over the adjacency's
    slice grouped stably by cell, equals the reference's ``w.at[a, ·].add``
    followed by ``w.at[b, ·].add`` bit for bit, where the other order of
    the two scatters gives other bits (the sums round)."""
    inputs, C = _hub_inputs(2_700_001, 1)
    k = 8
    port_inputs = interop.game_inputs(inputs, device="cpu")
    assign = np.random.default_rng(4).integers(0, k, C).astype(np.int32)
    want = np.asarray(jgame._neighbor_partition_weight(inputs, jnp.asarray(assign), C))
    t_assign = torch.from_numpy(assign)
    adj = tgame._adjacency(port_inputs, C)
    got = np.concatenate([tgame._batch_w(adj, t_assign, lo, min(lo + 16, C), k, True).numpy()
                          for lo in range(0, C, 16)])
    assert want.max() >= 2**24
    np.testing.assert_array_equal(want, got)
    np.testing.assert_array_equal(
        want, tgame._neighbor_partition_weight(port_inputs, t_assign, C).numpy())
    ext = np.concatenate([assign, [0]])
    pa, pb, pw = (np.asarray(x) for x in (inputs.pair_a, inputs.pair_b, inputs.pair_w))
    other = np.zeros((C + 1, k), np.float32)
    for i in range(pa.size):  # b's scatter first
        other[pb[i], ext[pa[i]]] += pw[i]
    for i in range(pa.size):
        other[pa[i], ext[pb[i]]] += pw[i]
    assert not np.array_equal(other[:C], want)


@pytest.mark.parametrize("scale", [1, 3001, 160_001, 700_001])
def test_part_sizes_in_order_equal_a_float32_chain(scale):
    """The ordered partition sizes (K5 from each chain's exact head) equal a
    plain float32 chain in index order, where the totals pass 2**23 and
    2**24 (odd multiples of ½, so the adds past the limit round), and
    ``index_add_`` on the CPU does too."""
    rng = np.random.default_rng(scale)
    C, k = 3000, 5
    sizes = (rng.integers(1, 200, C) * 0.5 * scale).astype(np.float32)
    assign = rng.choice(k, C, p=[0.7, 0.1, 0.1, 0.1, 0.0]).astype(np.int32)
    want = np.zeros(k, np.float32)
    for i in range(C):
        want[assign[i]] = np.float32(want[assign[i]] + sizes[i])
    t_sizes, t_assign = torch.from_numpy(sizes), torch.from_numpy(assign)
    for exact_below in (2.0**23, 0.0):
        got = tgame._part_sizes(t_sizes, t_assign, k, exact_below).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(tgame._part_sizes(t_sizes, t_assign, k).numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(jax.ops.segment_sum(jnp.asarray(sizes), jnp.asarray(assign), k)), want)
    if scale > 1:
        assert want.max() >= 2**23
        exact = np.zeros(k)
        np.add.at(exact, assign, sizes.astype(np.float64))
        assert not np.array_equal(exact, want.astype(np.float64))  # the chain rounded
