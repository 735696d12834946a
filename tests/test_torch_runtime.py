"""The runtime of the port (``repro_torch.runtime``: the lane fault
injector, the straggler monitor and its handoff in ``run_parallel``, the
fault-tolerant loop) against the live reference (``repro.runtime``), on
the CPU.

Tolerance: bitwise.  Parts, carries, lane plans and ``pin_map`` are
integers; the loop's state is float32 updated op by op in the same order
in both packages.  Each test of ``tests/test_fault.py`` and the straggler
and loop tests of ``tests/test_substrate.py`` have a counterpart here; the
loop's state is a plain tree, and in
``test_loop_over_the_reference_train_state`` the optimizer's ``TrainState``,
taken from the reference through ``interop.train_state`` and stepped by
each package's AdamW (within rtol 1e-5 of each other: ``pow`` and the
sums' order are other float32 routines; each package's resume bitwise).
The handoff is driven by a monitor whose times are fixed (:class:`_Fixed`),
so its plan does not depend on the host's timing.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.runtime as JR
import repro.streaming as js
from repro.checkpoint import CheckpointManager as JManager
from repro.incremental.store import CarryStore as JStore
from repro.kernels.stream_scan import GreedyCarry as JGreedy
from repro.kernels.stream_scan import HdrfCarry as JHdrf
from repro.streaming.parallel import _handoff_lanes as j_handoff
from repro_torch.checkpoint import CheckpointManager
from repro_torch.incremental import CarryStore
from repro_torch.kernels.stream_scan import GreedyCarry, HdrfCarry
from repro_torch.runtime import (FaultInjector, FaultTolerantLoop, LaneFaultInjector,
                                 StragglerMonitor)
from repro_torch.streaming import EdgeStream, ParallelEdgeStream, run_parallel
from repro_torch.streaming.carry import tree_leaves
from repro_torch.streaming.parallel import _handoff_lanes

CPU = "cpu"
V, E, K = 500, 8000, 8


def _graph(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, V, E).astype(np.int32),
            rng.integers(0, V, E).astype(np.int32))


def _make(name, k=K):
    if name == "greedy":
        return JGreedy(V, k), GreedyCarry(V, k, device=CPU)
    return JHdrf(V, k, 1.1), HdrfCarry(V, k, 1.1, device=CPU)


def _drive(pc, src, dst, **kw):
    st = EdgeStream(src, dst, V, chunk_size=256, device=CPU)
    parts, carry = run_parallel(st, pc, num_streams=4, super_chunk=2,
                                backend="threads", **kw)
    return parts.numpy(), carry


def _jdrive(pc, src, dst, **kw):
    st = js.EdgeStream(src, dst, V, chunk_size=256)
    parts, carry = js.run_parallel(st, pc, num_streams=4, super_chunk=2,
                                   backend="threads", **kw)
    return np.asarray(parts), carry


def _same_carry(jc, tc):
    jl, tl = jax.tree_util.tree_leaves(jc), tree_leaves(tc)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _fixed(base, slow: int):
    """A monitor of ``base``'s class whose times stay as seeded: lane
    ``slow`` at 100, the others at 1 (the fastest: lane 0, the first)."""

    class _Fixed(base):
        def record(self, step, dt, shard=0):
            self.n_shards = max(self.n_shards, int(shard) + 1)
            self.history.append((step, int(shard), dt))

    mon = _Fixed(threshold=1.01)
    for s in range(4):
        base.record(mon, 0, 100.0 if s == slow else 1.0, shard=s)
    return mon


# ================================================== kill-a-lane replay

@pytest.mark.parametrize("name", ["greedy", "hdrf"])
def test_lane_replay_bit_identical(name):
    src, dst = _graph()
    jpc, tpc = _make(name)
    want, jc = _jdrive(jpc, src, dst)
    inj = LaneFaultInjector(fail_at=[(1, 11)])
    got, tc = _drive(tpc, src, dst, on_lane_failure="replay", lane_injector=inj)
    assert inj.fired == [(1, 11)]
    np.testing.assert_array_equal(want, got)
    _same_carry(jc, tc)


@pytest.mark.parametrize("name", ["greedy", "hdrf"])
def test_hub_lane_replay_bit_identical(name):
    src, dst = _graph(3)
    probe = ParallelEdgeStream(EdgeStream(src, dst, V, chunk_size=256, device=CPU), 4,
                               shard="hub")
    jprobe = js.ParallelEdgeStream(js.EdgeStream(src, dst, V, chunk_size=256), 4,
                                   shard="hub")
    assert probe.n_hubs > 0 and probe.lanes == jprobe.lanes
    fail_cid = probe.lanes[1][2]
    jpc, tpc = _make(name)
    want, jc = _jdrive(jpc, src, dst, shard="hub")
    inj = LaneFaultInjector(fail_at=[(1, fail_cid)])
    got, tc = _drive(tpc, src, dst, shard="hub", on_lane_failure="replay",
                     lane_injector=inj)
    assert inj.fired == [(1, fail_cid)]
    np.testing.assert_array_equal(want, got)
    _same_carry(jc, tc)


def test_lane_replay_from_carrystore_checkpoint(tmp_path):
    src, dst = _graph(1)
    jpc, tpc = _make("greedy")
    want, jc = _jdrive(jpc, src, dst)
    store = CarryStore(tmp_path)
    inj = LaneFaultInjector(fail_at=[(1, 11), (3, 29)])
    got, tc = _drive(tpc, src, dst, on_lane_failure="replay", lane_injector=inj,
                     carry_store=store)
    assert inj.fired == [(1, 11), (3, 29)]
    np.testing.assert_array_equal(want, got)
    _same_carry(jc, tc)
    _, meta = store.load(like=tc, consumer="parallel:GreedyCarry", max_stream_pos=E)
    assert int(meta["stream_pos"]) > 0
    # the reference's store reads the port's merge bases
    jbase, jmeta = JStore(tmp_path).load(like=jc, consumer="parallel:GreedyCarry",
                                         max_stream_pos=E)
    assert int(jmeta["stream_pos"]) == int(meta["stream_pos"]) == E
    _same_carry(jbase, tc)


def test_lane_failure_raise_mode_propagates():
    src, dst = _graph()
    inj = LaneFaultInjector(fail_at=[(0, 0)])
    with pytest.raises(RuntimeError, match="injected lane 0"):
        _drive(GreedyCarry(V, K, device=CPU), src, dst, lane_injector=inj)
    assert inj.fired == [(0, 0)]


def test_fault_path_rejected_off_threads_backend():
    src, dst = _graph()
    st = EdgeStream(src, dst, V, chunk_size=256, device=CPU)
    for kw in (dict(on_lane_failure="replay"), dict(straggler=StragglerMonitor()),
               dict(lane_injector=LaneFaultInjector())):
        with pytest.raises(ValueError, match="threads"):
            run_parallel(st, GreedyCarry(V, K, device=CPU), num_streams=4, backend="vmap",
                         **kw)
    with pytest.raises(ValueError, match="on_lane_failure"):
        run_parallel(st, GreedyCarry(V, K, device=CPU), num_streams=4,
                     backend="threads", on_lane_failure="retry")


# ================================================== straggler handoff

@pytest.mark.parametrize("shard", ["range", "round-robin", "hub"])
@pytest.mark.parametrize("name", ["greedy", "hdrf"])
def test_straggler_handoff_equals_the_reference(shard, name):
    """A live handoff (lane 2 the straggler, lane 0 the receiver) in every
    shard mode: parts and carry equal to the reference's drive under the
    same plan, every edge placed once, the carry's load the parts'
    histogram, and the monitor fed once a lane a super-chunk."""
    src, dst = _graph({"range": 2, "round-robin": 6, "hub": 5}[shard])
    jpc, tpc = _make(name)
    jmon, mon = _fixed(JR.StragglerMonitor, 2), _fixed(StragglerMonitor, 2)
    want, jc = _jdrive(jpc, src, dst, shard=shard, straggler=jmon)
    got, tc = _drive(tpc, src, dst, shard=shard, straggler=mon)
    np.testing.assert_array_equal(want, got)
    _same_carry(jc, tc)
    placed = got >= 0  # self-loops are not placed
    assert got.shape == (E,) and np.array_equal(placed, src != dst)
    np.testing.assert_array_equal(tc[0].numpy(), np.bincount(got[placed], minlength=K))
    assert [h[:2] for h in mon.history] == [h[:2] for h in jmon.history]
    assert {h[1] for h in mon.history} == {0, 1, 2, 3} and len(mon.history) > 4
    # the handoff changed the drive: the undisturbed one differs
    plain, _ = _drive(_make(name)[1], src, dst, shard=shard)
    assert not np.array_equal(plain, got)


@pytest.mark.parametrize("shard", ["range", "round-robin", "hub"])
def test_handoff_plans_and_pins_equal_the_reference(shard):
    """``_handoff_lanes`` on one plan at two boundaries: the lanes, the plan
    chunks, ``pin_map`` and the lane of every position equal the
    reference's; a hub's edges stay on one lane, only the straggler gives
    and only the fastest lane receives."""
    src, dst = _graph(4)
    ps = ParallelEdgeStream(EdgeStream(src, dst, V, chunk_size=256, device=CPU), 4,
                            shard=shard)
    jps = js.ParallelEdgeStream(js.EdgeStream(src, dst, V, chunk_size=256), 4, shard=shard)
    pins_before = dict(ps.pin_map)
    plan_before = None if ps._lane_of_pos is None else ps._lane_of_pos.copy()
    lanes, jlanes = [list(x) for x in ps.lanes], [list(x) for x in jps.lanes]
    mon, jmon = _fixed(StragglerMonitor, 1), _fixed(JR.StragglerMonitor, 1)
    for pos in ([0, 0, 0, 0], [2, 2, 1, 2]):
        _handoff_lanes(ps, lanes, pos, mon)
        j_handoff(jps, jlanes, pos, jmon)
        assert lanes == jlanes and ps.pin_map == jps.pin_map
    assert lanes != [list(x) for x in ps.lanes]  # something moved
    if shard != "hub":
        return
    assert len(ps._chunk_pos) == len(jps._chunk_pos)
    for a, b in zip(ps._chunk_pos, jps._chunk_pos):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ps._lane_of_pos, jps._lane_of_pos)
    # the stream's kept plan is untouched: a new plan starts from it
    again = ParallelEdgeStream(ps.stream, 4, shard="hub")
    np.testing.assert_array_equal(again._lane_of_pos, plan_before)
    assert again.pin_map == pins_before
    allpos = np.concatenate([ps._chunk_pos[c] for lane in lanes for c in lane])
    np.testing.assert_array_equal(np.sort(allpos), np.arange(E))
    lane_of = np.empty(E, np.int32)
    for s, lane in enumerate(lanes):
        for c in lane:
            lane_of[ps._chunk_pos[c]] = s
    pv = ps._pin_vertex
    for v, lane in ps.pin_map.items():
        assert np.all(lane_of[pv == v] == lane), f"hub {v} split"
    moved = {v for v in pins_before if ps.pin_map[v] != pins_before[v]}
    assert moved and all(pins_before[v] == 1 for v in moved)
    assert all(ps.pin_map[v] == 0 for v in moved)


def test_straggler_monitor_multi_lane_trace():
    mons = (StragglerMonitor(threshold=1.5), JR.StragglerMonitor(threshold=1.5))
    for mon in mons:
        for step in range(30):
            for s in range(4):
                mon.record(step, {0: 1.0, 1: 1.1, 2: 4.0, 3: 1.2}[s], shard=s)
    mon, jmon = mons
    assert mon.n_shards == 4 and mon.stragglers() == jmon.stragglers() == [2]
    assert dict(mon.times) == dict(jmon.times) and mon.history == jmon.history
    ranges = [(0, 40), (40, 80), (80, 120), (120, 160)]
    plan = mon.rebalance_plan(ranges, give_frac=0.25)
    assert plan == jmon.rebalance_plan(ranges, give_frac=0.25)
    assert plan[2] == (80, 110) and plan[0] == (0, 50)
    assert plan[1] == (40, 80) and plan[3] == (120, 160)
    assert sum(hi - lo for lo, hi in plan) == 160


def test_straggler_record_default_shard_zero():
    mon = StragglerMonitor()
    mon.record(0, 1.0)
    assert mon.n_shards == 1 and mon.history == [(0, 0, 1.0)]
    assert mon.stragglers() == [] and StragglerMonitor().stragglers() == []
    assert StragglerMonitor().rebalance_plan([(0, 4)]) == [(0, 4)]


def test_straggler_monitor_flags_and_rebalances():
    mon, jmon = StragglerMonitor(n_shards=4, threshold=1.5), JR.StragglerMonitor(
        n_shards=4, threshold=1.5)
    for m in (mon, jmon):
        for step in range(20):
            for s in range(4):
                m.record(step, 1.0 if s != 2 else 3.0, shard=s)
    assert mon.stragglers() == jmon.stragglers() == [2]
    ranges = [(0, 100), (100, 200), (200, 300), (300, 400)]
    new = mon.rebalance_plan(ranges, give_frac=0.25)
    assert new == jmon.rebalance_plan(ranges, give_frac=0.25)
    assert new[2][1] - new[2][0] == 75
    assert sum(hi - lo for lo, hi in new) == 400


# ================================================== FaultTolerantLoop

LR, B1, B2, EPS = 0.05, 0.9, 0.999, 1e-8


def _t_step(state, batch):
    """An Adam-like update of a plain tree, op by op in float32."""
    g = 2 * (state["w"] - batch)
    m = B1 * state["m"] + (1 - B1) * g
    v = B2 * state["v"] + (1 - B2) * (g * g)
    w = state["w"] - LR * m / (torch.sqrt(v) + EPS)
    return {"w": w, "m": m, "v": v, "n": state["n"] + 1}, {"loss": (g * g).sum()}


def _j_step(state, batch):
    g = 2 * (state["w"] - batch)
    m = B1 * state["m"] + (1 - B1) * g
    v = B2 * state["v"] + (1 - B2) * (g * g)
    w = state["w"] - LR * m / (jnp.sqrt(v) + EPS)
    return {"w": w, "m": m, "v": v, "n": state["n"] + 1}, {"loss": jnp.sum(g * g)}


def _t_state():
    z = torch.zeros(3)
    return {"w": z, "m": z.clone(), "v": z.clone(), "n": torch.tensor(0, dtype=torch.int32)}


def _j_state():
    z = jnp.zeros(3, jnp.float32)
    return {"w": z, "m": z, "v": z, "n": jnp.int32(0)}


def _t_data(step):
    return torch.tensor(np.float32(np.sin(step)))


def _j_data(step):
    return jnp.float32(np.sin(step))


def _loops(tmp_path, n_steps, fail_at=(), **kw):
    """The same run in both packages: the port's state and the reference's."""
    loop = FaultTolerantLoop(_t_step, _t_data,
                             CheckpointManager(tmp_path / "t", keep=2, async_write=False),
                             injector=FaultInjector(fail_at), **kw)
    jloop = JR.FaultTolerantLoop(_j_step, _j_data,
                                 JManager(tmp_path / "j", keep=2, async_write=False),
                                 injector=JR.FaultInjector(fail_at), **kw)
    state, step, _ = loop.run(_t_state(), n_steps)
    jstate, jstep, _ = jloop.run(_j_state(), n_steps)
    assert step == jstep == n_steps and loop.restarts == jloop.restarts
    for key in ("w", "m", "v", "n"):
        np.testing.assert_array_equal(state[key].numpy(), np.asarray(jstate[key]))
    return state, loop


def _same_state(a, b):
    for key in a:
        assert torch.equal(a[key], b[key]), key


def test_loop_restart_before_first_checkpoint_is_exact(tmp_path):
    clean, _ = _loops(tmp_path / "clean", 8, ckpt_every=100)
    faulty, loop = _loops(tmp_path / "faulty", 8, fail_at=[5], ckpt_every=100)
    assert loop.restarts == 1
    _same_state(clean, faulty)


def test_fault_tolerant_loop_bitwise_resume(tmp_path):
    clean, loop0 = _loops(tmp_path / "clean", 20, ckpt_every=5)
    faulty, loop1 = _loops(tmp_path / "faulty", 20, fail_at=(7, 13), ckpt_every=5)
    assert loop0.restarts == 0 and loop1.restarts == 2
    _same_state(clean, faulty)
    assert int(faulty["n"]) == 20


def test_loop_gives_up_after_max_restarts(tmp_path):
    loop = FaultTolerantLoop(_t_step, _t_data,
                             CheckpointManager(tmp_path, async_write=False),
                             max_restarts=1, injector=FaultInjector([2, 3]))
    with pytest.raises(RuntimeError, match="injected failure at step 3"):
        loop.run(_t_state(), 6)


def test_loop_shard_fn_attributes_lanes(tmp_path):
    mon, jmon = StragglerMonitor(threshold=1.5), JR.StragglerMonitor(threshold=1.5)
    loop = FaultTolerantLoop(_t_step, _t_data,
                             CheckpointManager(tmp_path / "t2", async_write=False),
                             ckpt_every=4, straggler_monitor=mon,
                             shard_fn=lambda step: step % 3)
    jloop = JR.FaultTolerantLoop(_j_step, _j_data,
                                 JManager(tmp_path / "j2", async_write=False),
                                 ckpt_every=4, straggler_monitor=jmon,
                                 shard_fn=lambda step: step % 3)
    loop.run(_t_state(), 9)
    jloop.run(_j_state(), 9)
    assert mon.n_shards == jmon.n_shards == 3
    assert [h[:2] for h in mon.history] == [h[:2] for h in jmon.history]
    assert [h[1] for h in mon.history] == [s % 3 for s in range(9)]
    assert all(h[2] > 0 for h in mon.history)


def test_fault_injector_fires_once():
    inj = FaultInjector([2])
    inj.check(1)
    with pytest.raises(RuntimeError, match="step 2"):
        inj.check(2)
    inj.check(2)
    lane = LaneFaultInjector([(1, 4)])
    lane.check(1, 3)
    with pytest.raises(RuntimeError, match="lane 1 failure at chunk 4"):
        lane.check(1, 4)
    lane.check(1, 4)
    assert lane.fired == [(1, 4)]


def test_loop_over_the_reference_train_state(tmp_path):
    """The loop over AdamW: the reference's ``TrainState`` (its
    ``init_state``) through ``interop.train_state`` into the port, a fault
    before the first checkpoint and one after it; the port resumes to its
    clean run's bits and stays within rtol 1e-5 of the reference's loop."""
    from repro import optim as jopt
    from repro_torch import interop, optim

    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((4,)).astype(np.float32), "b": np.float32([0.5])}
    xs = rng.standard_normal((16, 4)).astype(np.float32)

    def t_loss(p, y, cfg):
        return torch.mean((torch.from_numpy(xs) @ p["w"] + p["b"][0] - y) ** 2), {}

    def j_loss(p, y, cfg):
        return jnp.mean((xs @ p["w"] + p["b"][0] - y) ** 2), {}

    def t_data(step):
        return torch.from_numpy(np.sin(xs.sum(1) + step).astype(np.float32))

    def j_data(step):
        return jnp.asarray(np.sin(xs.sum(1) + step).astype(np.float32))

    t_step = optim.make_train_step(t_loss, None, optim.AdamWConfig(lr=0.05))
    j_step = jopt.make_train_step(j_loss, None, jopt.AdamWConfig(lr=0.05))
    j_state = jopt.init_state(jax.tree.map(jnp.asarray, params))
    runs = {}
    for name, fail_at in (("clean", ()), ("faulty", (3, 8))):
        loop = FaultTolerantLoop(t_step, t_data,
                                 CheckpointManager(tmp_path / name, async_write=False),
                                 ckpt_every=5, injector=FaultInjector(fail_at))
        state, step, _ = loop.run(interop.train_state(j_state, device=CPU), 12)
        assert step == 12 and loop.restarts == len(fail_at)
        assert isinstance(state, optim.TrainState) and int(state.step) == 12
        runs[name] = state
    for a, b in zip(tree_leaves(runs["clean"]), tree_leaves(runs["faulty"])):
        assert torch.equal(a, b)
    jloop = JR.FaultTolerantLoop(j_step, j_data, JManager(tmp_path / "j", async_write=False),
                                 ckpt_every=5, injector=JR.FaultInjector((3, 8)))
    jfinal, _, _ = jloop.run(j_state, 12)
    for name in ("params", "mu", "nu"):
        for w, g in zip(jax.tree.leaves(getattr(jfinal, name)),
                        tree_leaves(getattr(runs["clean"], name))):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-7)


def test_loop_entry_copy_survives_in_place_steps(tmp_path):
    """AdamW writes each step into its state's tensors; two faults before
    the first checkpoint both restart from the entry state as it was taken,
    so the run ends on the clean run's bits (ten steps, faults at 2 and 4)."""
    from repro_torch import optim

    xs = torch.from_numpy(np.random.default_rng(1).standard_normal((8, 3)).astype(np.float32))

    def loss(p, y, cfg):
        return torch.mean((xs @ p["w"] - y) ** 2), {}

    step_fn = optim.make_train_step(loss, None, optim.AdamWConfig(lr=0.05))
    runs = {}
    for name, fail_at in (("clean", ()), ("faulty", (2, 4))):
        loop = FaultTolerantLoop(step_fn, lambda s: torch.sin(xs.sum(1) + s),
                                 CheckpointManager(tmp_path / name, async_write=False),
                                 ckpt_every=100, injector=FaultInjector(fail_at))
        state, step, _ = loop.run(optim.init_state({"w": torch.ones(3)}), 10)
        assert step == 10 and loop.restarts == len(fail_at)
        runs[name] = state
    for a, b in zip(tree_leaves(runs["clean"]), tree_leaves(runs["faulty"])):
        assert torch.equal(a, b)
