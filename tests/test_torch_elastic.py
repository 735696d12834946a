"""Elastic k→k′ resharding of the port (``repro_torch.elastic``, the
migration-cost game, ``repro_torch.runtime.elastic``) against the live
reference (``repro.elastic``), on the CPU.

The tolerance is "bitwise" throughout: every leaf on this path is an
integer or a float32 summed in the reference's order.  Each test of
``tests/test_elastic.py`` (but the GAS label propagation, which
``tests/test_torch_gas.py`` holds) has its counterpart here: the same
inputs through both packages, every bundle leaf, every ``ReshardResult``
field, the game's assignment and rounds, Greedy's and HDRF's carries and
parts equal, and the reference test's postconditions asserted on the
port's output.  The controller's state is a plain tree of tensors (the
reference's optimizer, ``repro.optim``, is not ported).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.elastic as JE
from repro.core import S5PConfig as JConfig
from repro.core import game as jgame
from repro.incremental import s5p_apply_delta as j_apply_delta
from repro.incremental import s5p_cold_bundle as j_cold_bundle
from repro.incremental.store import CarryStore as JStore
from repro.kernels.stream_scan import GreedyCarry as JGreedy
from repro.kernels.stream_scan import HdrfCarry as JHdrf
from repro.streaming import EdgeStream as JStream
from repro.streaming import run_carry as j_run_carry
from repro_torch import random as trandom
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import game as tgame
from repro_torch.core.metrics import replication_factor
from repro_torch.core.s5p import S5PConfig
from repro_torch.elastic import ReshardResult, reshard_bundle, reshard_carry, reshard_scan_carry
from repro_torch.graphs import community_graph
from repro_torch.incremental import CarryStore, s5p_apply_delta, s5p_cold_bundle
from repro_torch.incremental.pipeline import last_games
from repro_torch.kernels.stream_scan import GreedyCarry, GridCarry, HdrfCarry
from repro_torch.runtime import ElasticController, ElasticPartition
from repro_torch.streaming import EdgeStream, run_carry
from test_torch_incremental import same_bundle, same_result

CPU = "cpu"
K = 8


@pytest.fixture(autouse=True)
def _threefry_partitionable():
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    with trandom.threefry_partitionable(True):
        yield
    jax.config.update("jax_threefry_partitionable", prev)


def _warm_bundle(seed=0, k=K):
    """The reference test's bundle, cold in each package: both equal."""
    src, dst, n = community_graph(800, n_communities=16, avg_degree=6,
                                  p_intra=0.9, seed=seed)
    jcfg = JConfig(k=k, seed=seed, chunk_size=512)
    tcfg = S5PConfig(k=k, seed=seed, chunk_size=512)
    _, jb = j_cold_bundle(src, dst, n, jcfg)
    _, tb = s5p_cold_bundle(src, dst, n, tcfg, device=CPU)
    same_bundle(jb, tb, "cold")
    return src, dst, n, jcfg, tcfg, jb, tb


def _both(jb, tb, jcfg, tcfg, k_new, src, dst, **kw):
    """One reshard in each package: every bundle leaf and result field equal."""
    jb2, jcfg2, jres = JE.reshard_bundle(jb, jcfg, k_new, src, dst, **kw)
    tb2, tcfg2, tres = reshard_bundle(tb, tcfg, k_new, src, dst, device=CPU, **kw)
    assert tcfg2.k == jcfg2.k == k_new
    assert tuple(jres) == tuple(tres) and jres.migrated_fraction == tres.migrated_fraction
    same_bundle(jb2, tb2, f"k'={k_new}")
    return tb2, tcfg2, tres


def _check_invariants(bundle, res, src, dst, n):
    """The reference test's postconditions, on the port's bundle."""
    k = res.k_new
    parts = np.asarray(bundle["parts"], np.int32)
    alive = np.asarray(bundle["alive"], bool)
    placed = alive & (parts >= 0)
    assert parts[placed].max() < k
    np.testing.assert_array_equal(np.asarray(bundle["load"]),
                                  np.bincount(parts[placed], minlength=k))
    assert np.asarray(bundle["c2p"]).max() < k
    arr = np.asarray(bundle["arrival"])[placed]
    assert res.rf == pytest.approx(replication_factor(
        torch.from_numpy(src[arr]), torch.from_numpy(dst[arr]),
        torch.from_numpy(parts[placed]), n_vertices=n, k=k))


# ================================================== bundle reshard

def test_reshard_grow_bounded_migration():
    src, dst, n, jcfg, tcfg, jb, tb = _warm_bundle()
    old_parts = np.asarray(tb["parts"], np.int32).copy()
    old_c2p = np.asarray(tb["c2p"], np.int32).copy()
    b2, cfg2, res = _both(jb, tb, jcfg, tcfg, 12, src, dst)
    assert res.k_old == K and res.k_new == 12
    _check_invariants(b2, res, src, dst, n)
    assert res.n_displaced == 0 and res.migrated_fraction < 1.0
    moved_c = np.asarray(b2["c2p"], np.int32) != old_c2p
    cu = np.asarray(b2["edge_cu"], np.int32)
    cv = np.asarray(b2["edge_cv"], np.int32)
    stable = (~moved_c[np.maximum(cu, 0)]) & (~moved_c[np.maximum(cv, 0)])
    np.testing.assert_array_equal(np.asarray(b2["parts"])[stable], old_parts[stable])
    np.testing.assert_array_equal(np.asarray(tb["parts"], np.int32), old_parts)  # not mutated
    (game,) = last_games()
    assert game["game"] == "reshard" and game["rounds"] == res.game_rounds
    assert game["seconds"] > 0


def test_reshard_shrink_displaces_dead_partitions():
    src, dst, n, jcfg, tcfg, jb, tb = _warm_bundle(1)
    old_parts = np.asarray(tb["parts"], np.int32).copy()
    b2, _, res = _both(jb, tb, jcfg, tcfg, 4, src, dst)
    _check_invariants(b2, res, src, dst, n)
    alive = np.asarray(tb["alive"], bool)
    assert res.n_displaced == int(np.count_nonzero(alive & (old_parts >= 4))) > 0
    assert res.migrated_edges >= res.n_displaced
    assert res.migrated_fraction < 1.0


def test_reshard_noop_and_validation():
    src, dst, n, jcfg, tcfg, jb, tb = _warm_bundle(2)
    b2, _, res = _both(jb, tb, jcfg, tcfg, K, src, dst)
    assert res.migrated_edges == 0 and res.game_rounds == 0
    np.testing.assert_array_equal(np.asarray(b2["parts"]), np.asarray(tb["parts"]))
    with pytest.raises(ValueError, match="k_new"):
        reshard_bundle(tb, tcfg, 0, src, dst, device=CPU)


def test_resharded_bundle_keeps_absorbing_deltas():
    src, dst, n = community_graph(800, n_communities=16, avg_degree=6,
                                  p_intra=0.9, seed=3)
    E0 = int(src.size * 0.95)
    jcfg, tcfg = JConfig(k=K, seed=0, chunk_size=512), S5PConfig(k=K, seed=0, chunk_size=512)
    _, jb = j_cold_bundle(src[:E0], dst[:E0], n, jcfg)
    _, tb = s5p_cold_bundle(src[:E0], dst[:E0], n, tcfg, device=CPU)
    jb2, jcfg2, _ = JE.reshard_bundle(jb, jcfg, 12, src[:E0], dst[:E0])
    tb2, tcfg2, _ = reshard_bundle(tb, tcfg, 12, src[:E0], dst[:E0], device=CPU)
    jb3, jres = j_apply_delta(jb2, jcfg2, src, dst, E0)
    tb3, tres = s5p_apply_delta(tb2, tcfg2, src, dst, E0, device=CPU)
    same_result(jres, tres, "delta at k'")
    same_bundle(jb3, tb3, "delta at k'")
    assert not tres.needs_cold_restart
    assert np.all(tres.parts[E0:] >= 0) and np.all(tres.parts[E0:] < 12)


def test_freeze_at_high_move_cost():
    src, dst, n, jcfg, tcfg, jb, tb = _warm_bundle(4)
    _, _, res = _both(jb, tb, jcfg, tcfg, 12, src, dst, move_cost_scale=1e9)
    assert res.migrated_edges == 0 and res.moved_clusters == 0


@pytest.mark.parametrize("k_new", [10, 6])
@pytest.mark.parametrize("scale", [0.0, 0.25, 1.0, 4.0])
def test_reshard_move_cost_scales(k_new, scale):
    """Grow and shrink at several migration costs, 0 included: the game's
    penalty is added in the reference's float32 form at every scale."""
    src, dst, n, jcfg, tcfg, jb, tb = _warm_bundle(0)
    b2, _, res = _both(jb, tb, jcfg, tcfg, k_new, src, dst, move_cost_scale=scale)
    _check_invariants(b2, res, src, dst, n)


def test_reshard_carry_dispatches_bundles():
    src, dst, n, jcfg, tcfg, jb, tb = _warm_bundle(5)
    jb2, _, jres = JE.reshard_carry(jb, 12, jcfg, src, dst)
    tb2, _, tres = reshard_carry(tb, 12, tcfg, src, dst, device=CPU)
    assert tuple(jres) == tuple(tres)
    same_bundle(jb2, tb2, "dispatch")


def test_bundle_from_the_reference_store_reshards_as_the_reference(tmp_path):
    """Interop: a bundle the reference's ``CarryStore`` wrote, loaded by the
    port's and resharded by the port, equals the reference's reshard of
    the bundle it saved."""
    src, dst, n = community_graph(800, n_communities=16, avg_degree=6,
                                  p_intra=0.9, seed=8)
    jcfg = JConfig(k=K, seed=8, chunk_size=512)
    _, jb = j_cold_bundle(src, dst, n, jcfg)
    JStore(tmp_path).save(jb, consumer="s5p", config={"k": K}, stream_pos=src.size)
    tb, meta = CarryStore(tmp_path).load(consumer="s5p", config={"k": K})
    assert int(meta["stream_pos"]) == src.size
    tcfg = S5PConfig(k=K, seed=8, chunk_size=512)
    for k_new in (12, 5):
        jb2, _, jres = JE.reshard_bundle(jb, jcfg, k_new, src, dst)
        tb2, _, tres = reshard_bundle(tb, tcfg, k_new, src, dst, device=CPU)
        assert tuple(jres) == tuple(tres)
        same_bundle(jb2, tb2, f"interop k'={k_new}")


# ================================================== game move_cost payoff

def _game_fixture(seed=0):
    src, dst, n, jcfg, tcfg, jb, tb = _warm_bundle(seed)
    sizes = np.asarray(jb["sizes"], np.float32)
    pa, pb = np.asarray(jb["pair_a"], np.int32), np.asarray(jb["pair_b"], np.int32)
    pw = np.asarray(jb["pair_w"], np.float32)
    ji = jgame.GameInputs(jnp.asarray(sizes), jnp.asarray(pa), jnp.asarray(pb),
                          jnp.asarray(pw), 0, K)
    ti = tgame.GameInputs(torch.tensor(sizes), torch.tensor(pa), torch.tensor(pb),
                          torch.tensor(pw), 0, K)
    C = sizes.shape[0]
    assign0 = np.random.default_rng(seed).integers(0, K, C).astype(np.int32)
    return ji, ti, C, assign0, np.asarray(jb["comb_is_head"], bool)


def _same_game(ji, ti, C, **kw):
    ref = jgame.run_game(ji, C, **kw)
    port = tgame.run_game(ti, C, **kw)
    np.testing.assert_array_equal(np.asarray(ref.assignment), port.assignment.numpy())
    assert int(ref.rounds) == port.rounds and bool(ref.converged) == port.converged
    return port


def test_game_zero_move_cost_bitwise_noop():
    ji, ti, C, assign0, leader = _game_fixture()
    kw = dict(batch_size=tgame.default_batch_size(0, C), max_rounds=6,
              assign0=assign0, seed=7, leader_mask=leader)
    base = _same_game(ji, ti, C, **kw)
    zeroed = _same_game(ji, ti, C, **kw, move_cost=np.zeros(C, np.float32), home=assign0)
    np.testing.assert_array_equal(base.assignment.numpy(), zeroed.assignment.numpy())
    assert base.rounds == zeroed.rounds


def test_game_huge_move_cost_freezes_home():
    ji, ti, C, assign0, leader = _game_fixture(1)
    res = _same_game(ji, ti, C, batch_size=tgame.default_batch_size(0, C), max_rounds=6,
                     assign0=assign0, seed=7, leader_mask=leader,
                     move_cost=np.full(C, 1e9, np.float32), home=assign0)
    np.testing.assert_array_equal(res.assignment.numpy(), assign0)


@pytest.mark.parametrize("seed", [0, 2])
def test_game_move_cost_with_displaced_homes(seed):
    """Costs of every magnitude, some clusters with no home (``home = -1``),
    the default home (``assign0``), and a cost with no mask (the leader
    prefix)."""
    ji, ti, C, assign0, leader = _game_fixture(seed)
    rng = np.random.default_rng(seed + 10)
    cost = (rng.random(C) * rng.choice([0.01, 1.0, 30.0], C)).astype(np.float32)
    home = np.where(rng.random(C) < 0.2, -1, assign0).astype(np.int32)
    kw = dict(batch_size=tgame.default_batch_size(256, C), max_rounds=64,
              assign0=assign0, seed=seed, move_cost=cost)
    _same_game(ji, ti, C, leader_mask=leader, move_mask=rng.random(C) < 0.8, home=home, **kw)
    _same_game(ji, ti, C, leader_mask=leader, **kw)
    _same_game(ji, ti, C, **kw)


def _flip_case():
    """A small game whose acceptance draws and near-ties make the cost's
    rounding decide a best response (found by a search over seeds)."""
    k, C, P = 3, 32, 96
    rng = np.random.default_rng(FLIP_SEED)
    sizes = (rng.integers(1, 40, C) / 2).astype(np.float32)
    pa, pb = rng.integers(0, C, P), rng.integers(0, C, P)
    lo, hi = np.minimum(pa, pb), np.maximum(pa, pb)
    ok = lo != hi
    pa = np.where(ok, lo, C).astype(np.int32)
    pb = np.where(ok, hi, C).astype(np.int32)
    pw = rng.integers(1, 6, P).astype(np.float32)
    assign0 = rng.integers(0, k, C).astype(np.int32)
    home = np.where(rng.random(C) < 0.2, -1, assign0).astype(np.int32)
    cost = (rng.random(C) * sizes / k * rng.choice([0.01, 0.1, 1.0], C)).astype(np.float32)
    leader = rng.random(C) < 0.3
    ji = jgame.GameInputs(jnp.asarray(sizes), jnp.asarray(pa), jnp.asarray(pb),
                          jnp.asarray(pw), 0, k)
    ti = tgame.GameInputs(torch.tensor(sizes), torch.tensor(pa), torch.tensor(pb),
                          torch.tensor(pw), 0, k)
    kw = dict(batch_size=4, max_rounds=8, accept_prob=0.9, assign0=assign0, seed=FLIP_SEED,
              leader_mask=leader, move_cost=cost, home=home)
    return ji, ti, C, kw


FLIP_SEED = 3


def test_move_cost_form_decides_a_best_response(monkeypatch):
    """The reference adds the (C, k) penalty buffer after the cost's FMA
    (read from the compiled HLO of ``_run_game_masked_jit`` with
    ``use_move_cost=True``: the penalty is its own fusion's output, an
    operand of the reduce and of the gather).  The port's form gives the
    reference's assignment; the penalty folded into the FMA's addend gives
    another, so this input would catch a wrong form."""
    from repro_torch._fp32 import fma_f32

    ji, ti, C, kw = _flip_case()
    want = _same_game(ji, ti, C, **kw).assignment.numpy()

    def folded(a, hyp, t, inv_k, cur_p, pen=None):
        col = cur_p[:, None]
        t_cur = t.gather(1, col)
        cost = fma_f32(a, hyp, t * inv_k + pen)
        cur = fma_f32(t_cur, torch.full_like(t_cur, inv_k),
                      a * hyp.gather(1, col) + pen.gather(1, col))
        return cost, cur[:, 0]

    monkeypatch.setattr(tgame, "_costs", folded)
    got = tgame.run_game(ti, C, **kw).assignment.numpy()
    assert not np.array_equal(got, want)


# ================================================== scan-carry reshard

@pytest.mark.parametrize("name", ["greedy", "hdrf"])
@pytest.mark.parametrize("k_new", [12, 4])
def test_reshard_scan_carry(name, k_new):
    src, dst, n = community_graph(600, n_communities=8, avg_degree=5, seed=5)
    if name == "greedy":
        jmake, tmake = (lambda k: JGreedy(n, k)), (lambda k: GreedyCarry(n, k, device=CPU))
    else:
        jmake = lambda k: JHdrf(n, k, 1.1)  # noqa: E731
        tmake = lambda k: HdrfCarry(n, k, 1.1, device=CPU)  # noqa: E731
    jparts, jc = j_run_carry(JStream(src, dst, n, chunk_size=256), jmake(K))
    tparts, tc = run_carry(EdgeStream(src, dst, n, chunk_size=256, device=CPU), tmake(K))
    parts = tparts.numpy()
    np.testing.assert_array_equal(np.asarray(jparts), parts)
    before = [x.clone() for x in tc]
    jw, jp, jres = JE.reshard_carry(jmake(k_new), k_new, src, dst, parts, carry=jc)
    tw, tp, tres = reshard_carry(tmake(k_new), k_new, src, dst, parts, carry=tc)
    assert isinstance(tres, ReshardResult) and tuple(jres) == tuple(tres)
    np.testing.assert_array_equal(jp, tp)
    assert len(jw) == len(tw)
    for a, b in zip(jw, tw):
        assert np.asarray(a).dtype == b.numpy().dtype
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for a, b in zip(before, tc):  # the input carry is not modified
        assert torch.equal(a, b)
    assert tp.min() >= 0 and tp.max() < k_new
    np.testing.assert_array_equal(tw[0].numpy(), np.bincount(tp, minlength=k_new))
    if k_new > K:
        assert tres.migrated_edges == 0
        np.testing.assert_array_equal(tp, parts)
    else:
        assert tres.n_displaced == int(np.count_nonzero(parts >= k_new))
        moved = tp != parts
        assert tres.migrated_edges == int(np.count_nonzero(moved))
        np.testing.assert_array_equal(moved, parts >= k_new)
    # the same k: a no-op with the reference's metrics
    jw0, _, jres0 = JE.reshard_scan_carry(jmake(K), jc, K, src, dst, parts)
    tw0, _, tres0 = reshard_scan_carry(tmake(K), tc, K, src, dst, parts)
    assert tuple(jres0) == tuple(tres0) and tw0 is tc


def test_reshard_grid_carry_refuses():
    rng = np.random.default_rng(0)
    n = 64
    pc = GridCarry(4, rng.integers(0, 2, n).astype(np.int32),
                   rng.integers(0, 2, n).astype(np.int32), 2, device=CPU)
    with pytest.raises(ValueError, match="grid"):
        reshard_carry(pc, 8, np.zeros(4, np.int32), np.ones(4, np.int32),
                      np.zeros(4, np.int32), carry=pc.init())
    with pytest.raises(ValueError, match="cannot reshard"):
        reshard_scan_carry(object(), (torch.zeros(4),), 8, [], [], [])


# ================================================== elastic controller

def test_elastic_partition_warm_resize():
    from repro.runtime import ElasticPartition as JPartition

    src, dst, n, jcfg, tcfg, jb, tb = _warm_bundle(6)
    jpart = JPartition(jb, jcfg, src, dst)
    part = ElasticPartition(tb, tcfg, src, dst, device=CPU)
    assert part.k == K
    p0 = part.parts
    np.testing.assert_array_equal(jpart.parts, p0)
    assert p0.shape == (src.size,) and p0.max() < K
    for k_new in (12, 4):
        before = part.parts
        jres, res = jpart.resize(k_new), part.resize(k_new)
        assert tuple(jres) == tuple(res) and part.k == k_new == res.k_new
        np.testing.assert_array_equal(jpart.parts, part.parts)
        same_bundle(jpart.bundle, part.bundle, f"partition k'={k_new}")
        assert part.parts.max() < k_new and res.migrated_fraction < 1.0
        assert np.count_nonzero(part.parts != before) == res.migrated_edges


def _state():
    """A plain tree of tensors standing for a job's state."""
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(6, generator=g), "b": torch.randn(2, 3, generator=g),
            "step": torch.tensor(5, dtype=torch.int32),
            "opt": (torch.arange(6, dtype=torch.float32), torch.ones(2, 3))}


def _leaves(tree):
    from repro_torch.streaming.carry import tree_leaves

    return tree_leaves(tree)


def test_elastic_controller_warm_resize_roundtrip(tmp_path):
    """The whole flow (checkpoint, devices, restore and place, warm
    reshard) returns bitwise-equal leaves on the device and the
    reference's reshard."""
    src, dst, n, jcfg, tcfg, jb, tb = _warm_bundle(7)
    part = ElasticPartition(tb, tcfg, src, dst, device=CPU)
    state = _state()
    dev = torch.device(CPU)
    controller = ElasticController(
        CheckpointManager(tmp_path, keep=2, async_write=False),
        make_mesh=lambda size: dev, make_shardings=lambda m: m, partition=part)
    new_state, mesh, res, step = controller.resize(state, 5, 12)
    assert step == 5 and mesh is dev
    assert isinstance(res, ReshardResult) and tuple(res) == tuple(
        JE.reshard_bundle(jb, jcfg, 12, src, dst)[2])
    assert part.k == 12
    for a, b in zip(_leaves(state), _leaves(new_state)):
        assert a.dtype == b.dtype and b.device == dev and torch.equal(a, b)
    with pytest.raises(TypeError, match="a placement is a device, a DeviceMesh"):
        ElasticController(CheckpointManager(tmp_path / "m", async_write=False),
                          make_mesh=lambda size: object()).resize(state, 1, 2)


def test_elastic_resize_preserves_state(tmp_path):
    state = _state()
    manager = CheckpointManager(tmp_path, keep=2, async_write=False)
    calls = []
    controller = ElasticController(manager, make_mesh=lambda n: torch.device(CPU),
                                   repartition=lambda k: calls.append(k) or k)
    new_state, mesh, parts, step = controller.resize(state, 3, 7)
    assert calls == [7] and parts == 7 and step == 3
    for a, b in zip(_leaves(state), _leaves(new_state)):
        assert torch.equal(a, b)
    assert manager.steps() == [3]
