"""Port parity: deletions and sliding windows of ``repro_torch.incremental``
against the live reference.

Mirrors ``tests/test_window.py`` (scan and S5P deletions, compaction, the
refresh signal, the window chain) and the decremental parts of
``tests/test_carry.py`` on the port:

- ``cluster_retract_chunk`` (and ``ClusterCarry.retract_chunk``) bitwise
  against the reference, with recorded head flags and with the frozen-ξ
  classification, ids past the volume arrays dropped;
- insert then delete the same batch rolls the bundle back bitwise (and to
  the pinned golden under the non-partitionable threefry mode);
- the decremental path (churn counted, degrees subtracted exactly, double
  deletion refused) and its refinement, ``compact_bundle``,
  ``compact_edge_slots``, ``s5p_cold_restart`` and the refresh signal,
  each bundle and result equal to the reference's;
- ``S5PWindowChain`` step by step equal to the reference's
  ``WindowStep``s and final bundle, compaction included;
- scan-partitioner suffix deletion equals a cold run of the prefix;
- ``run_parallel(carry_store=...)`` with a duck-typed injector replays a
  failed lane from disk, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.incremental as R
from proptest import random_graph
from repro.core import S5PConfig as JConfig
from repro_torch import random as trandom
from repro_torch.core.s5p import S5PConfig
from repro_torch.incremental import (CarryStore, S5PWindowChain, compact_bundle,
                                     compact_edge_slots, cold_start, run_incremental,
                                     s5p_apply_delta, s5p_apply_deletion, s5p_cold_bundle,
                                     s5p_cold_restart)
from repro_torch.runtime import LaneFaultInjector
from test_torch_incremental import _h, community, same_bundle, same_result

K = 4
CPU = "cpu"
INF = float("inf")


@pytest.fixture(autouse=True)
def _threefry_partitionable():
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    with trandom.threefry_partitionable(True):
        yield
    jax.config.update("jax_threefry_partitionable", prev)


def _cfgs(**kw):
    base = dict(k=K, use_cms=True, seed=0, drift_rf_threshold=0.02,
                drift_churn_threshold=0.2, refine_rounds=8)
    base.update(kw)
    return JConfig(**base), S5PConfig(**base)


# ================================================ cluster_retract_chunk

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("flags", ["recorded", "frozen_xi"])
def test_cluster_retract_chunk_equals_the_reference(seed, flags):
    from repro.core import clustering as jcl
    from repro_torch.core import clustering as tcl
    from test_torch_carry_algebra import _same

    src, dst, n, _ = random_graph(seed)
    deg = np.bincount(src, minlength=n) + np.bincount(dst, minlength=n)
    deg = deg.astype(np.int32)
    xi = int(np.median(deg))
    kw = dict(xi=xi, kappa=int(2 * len(src) / K))
    jstate = jcl.cluster_chunk(jcl.init_state(n), jnp.asarray(src), jnp.asarray(dst),
                               jnp.asarray(deg), **kw)
    tstate = tcl.cluster_chunk(tcl.init_state(n, CPU), torch.from_numpy(src),
                               torch.from_numpy(dst), torch.from_numpy(deg), **kw)
    _same(jstate, tstate, "fold")
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.choice(len(src), size=max(len(src) // 3, 1), replace=False))
    ds, dd = src[idx], dst[idx]
    n_valid = idx.size - (1 if idx.size > 1 else 0)  # the last entry as padding
    if flags == "recorded":
        head = rng.random(idx.size) < 0.5
        jgot = jcl.cluster_retract_chunk(jstate, jnp.asarray(ds), jnp.asarray(dd), n_valid,
                                         is_head=jnp.asarray(head))
        tgot = tcl.cluster_retract_chunk(tstate, torch.from_numpy(ds), torch.from_numpy(dd),
                                         n_valid, is_head=torch.from_numpy(head))
    else:
        jgot = jcl.cluster_retract_chunk(jstate, jnp.asarray(ds), jnp.asarray(dd), n_valid,
                                         jnp.asarray(deg), xi=xi)
        tgot = tcl.cluster_retract_chunk(tstate, torch.from_numpy(ds), torch.from_numpy(dd),
                                         n_valid, torch.from_numpy(deg), xi=xi)
    _same(jgot, tgot, "retract")
    # the input state is untouched; the carry's retraction is the same
    _same(jstate, tstate, "input")
    pc = tcl.ClusterCarry(torch.from_numpy(deg), n, **kw)
    jpc = jcl.ClusterCarry(jnp.asarray(deg), n, **kw)
    assert pc.supports_retract and jpc.supports_retract and not pc.retract_exact
    _same(jpc.retract_chunk(jstate, jnp.asarray(ds), jnp.asarray(dd), n_valid, None),
          pc.retract_chunk(tstate, torch.from_numpy(ds), torch.from_numpy(dd), n_valid, None),
          "carry")
    with pytest.raises(ValueError, match="is_head"):
        tcl.cluster_retract_chunk(tstate, torch.from_numpy(ds), torch.from_numpy(dd), 1)


def test_cluster_retract_drops_ids_past_the_volume_arrays():
    """Merged lanes hand out ids past V + 1; a retraction's scatter there is
    dropped, as the reference's is."""
    from repro.core import clustering as jcl
    from repro_torch.core import clustering as tcl
    from test_torch_carry_algebra import _same

    n = 6
    st = jcl.init_state(n)._replace(
        v2c_t=jnp.asarray([9, 1, 12, -1, 2, 3], jnp.int32),
        v2c_h=jnp.asarray([10, -1, 1, 2, -1, 4], jnp.int32),
        cnt_t=jnp.asarray([1, 2, 1, 0, 1, 1], jnp.int32),
        cnt_h=jnp.asarray([1, 0, 2, 1, 0, 1], jnp.int32),
        alloc_h=jnp.asarray([5, 0, 3, 2, 0, 1], jnp.int32),
        vol_t=jnp.arange(n + 1, dtype=jnp.int32), vol_h=jnp.arange(n + 1, dtype=jnp.int32),
        next_t=jnp.int32(13), next_h=jnp.int32(11))
    tst = tcl.ClusterState(*[torch.from_numpy(np.array(x)) for x in st])
    src = np.array([0, 2, 0, 3], np.int32)
    dst = np.array([1, 4, 2, 5], np.int32)
    head = np.array([False, False, True, True])
    _same(jcl.cluster_retract_chunk(st, jnp.asarray(src), jnp.asarray(dst), 4,
                                    is_head=jnp.asarray(head)),
          tcl.cluster_retract_chunk(tst, torch.from_numpy(src), torch.from_numpy(dst), 4,
                                    is_head=torch.from_numpy(head)), "past V")


# ======================================================= s5p deletions

def test_insert_then_delete_restores_the_bundle_golden():
    """A 10 % insertion then its deletion rolls the bundle back bitwise; the
    restored parts are the pinned golden under the non-partitionable mode."""
    from repro_torch.incremental import JOURNAL_PREFIX

    src, dst, n, _ = random_graph(0)
    kw = dict(k=4, use_cms=False, game_accept_prob=0.7, game_max_rounds=64, seed=0,
              drift_rf_threshold=INF, drift_balance_threshold=INF,
              drift_churn_threshold=INF)
    cfg = S5PConfig(**kw)
    with trandom.threefry_partitionable(False):
        _, before = s5p_cold_bundle(src, dst, n, cfg, device=CPU)
        assert _h(before["parts"]) == "5c2abcabc60d546d"
        E0 = len(src)
        rng = np.random.default_rng(9)
        m = max(E0 // 10, 4)
        full_src = np.concatenate([src, rng.integers(0, n, m).astype(np.int32)])
        full_dst = np.concatenate([dst, rng.integers(0, n, m).astype(np.int32)])
        mid, _ = s5p_apply_delta(before, cfg, full_src, full_dst, E0, device=CPU)
        assert bool(mid["journal_valid"])
        after, res = s5p_apply_deletion(mid, cfg, full_src, full_dst, np.arange(E0, E0 + m),
                                        device=CPU)
    assert res.rolled_back and res.n_retracted == m
    skip = ("journal_valid", "journal_pos")
    same_bundle(before, after, "rollback",
                skip=skip + tuple(k for k in after if k.startswith(JOURNAL_PREFIX)))
    assert _h(after["parts"]) == "5c2abcabc60d546d"
    # the reference's rollback of the same batch gives the same bundle
    jcfg = JConfig(**kw)
    jax.config.update("jax_threefry_partitionable", False)
    try:
        _, jb = R.s5p_cold_bundle(src, dst, n, jcfg)
        jmid, _ = R.s5p_apply_delta(jb, jcfg, full_src, full_dst, E0)
        jafter, jres = R.s5p_apply_deletion(jmid, jcfg, full_src, full_dst,
                                            np.arange(E0, E0 + m))
    finally:
        jax.config.update("jax_threefry_partitionable", True)
    same_bundle(jmid, mid, "journaled")
    same_bundle(jafter, after, "rolled back")
    same_result(jres, res, "rollback")


@pytest.mark.parametrize("use_cms", [True, False])
@pytest.mark.parametrize("trip", ["none", "rf", "churn"])
def test_decremental_path_equals_the_reference(use_cms, trip):
    src, dst, n = community()
    over = {"none": dict(drift_rf_threshold=INF, drift_balance_threshold=INF,
                         drift_churn_threshold=INF),
            "rf": dict(drift_rf_threshold=-1.0, drift_churn_threshold=INF),
            "churn": dict(drift_rf_threshold=INF, drift_balance_threshold=INF,
                          drift_churn_threshold=0.05)}[trip]
    jcfg, tcfg = _cfgs(use_cms=use_cms, k=8, chunk_size=256, **over)
    _, jb = R.s5p_cold_bundle(src, dst, n, jcfg)
    _, tb = s5p_cold_bundle(src, dst, n, tcfg, device=CPU)
    rng = np.random.default_rng(3)
    idx = np.sort(rng.choice(len(src), size=len(src) // 10, replace=False))
    jb2, jr = R.s5p_apply_deletion(jb, jcfg, src, dst, idx)
    tb2, tr = s5p_apply_deletion(tb, tcfg, src, dst, idx, device=CPU)
    same_bundle(jb2, tb2, "deleted")
    same_result(jr, tr, "deletion")
    assert not tr.rolled_back and tr.n_retracted == idx.size and tr.churn > 0
    assert tr.refined == (trip != "none")
    parts = np.asarray(tb2["parts"])
    assert np.all(parts[idx] == -1)
    deg = np.asarray(tb["degrees"]).copy()
    np.subtract.at(deg, src[idx], 1)
    np.subtract.at(deg, dst[idx], 1)
    np.testing.assert_array_equal(np.asarray(tb2["degrees"]), deg)
    with pytest.raises(ValueError, match="already deleted"):
        s5p_apply_deletion(tb2, tcfg, src, dst, idx[:1], device=CPU)
    with pytest.raises(ValueError, match="must lie"):
        s5p_apply_deletion(tb2, tcfg, src, dst, [len(src)], device=CPU)
    # an empty deletion is a no-op with the reference's metrics
    same_result(R.s5p_apply_deletion(jb2, jcfg, src, dst, [])[1],
                s5p_apply_deletion(tb2, tcfg, src, dst, [], device=CPU)[1], "empty")


@pytest.mark.parametrize("use_cms", [True, False])
def test_compaction_and_cold_restart_equal_the_reference(use_cms):
    src, dst, n, _ = random_graph(1)
    jcfg, tcfg = _cfgs(refine_rounds=0, use_cms=use_cms, chunk_size=64)
    _, jb = R.s5p_cold_bundle(src, dst, n, jcfg)
    _, tb = s5p_cold_bundle(src, dst, n, tcfg, device=CPU)
    idx = np.arange(0, len(src) // 2)  # a big deletion: some clusters die
    jb, _ = R.s5p_apply_deletion(jb, jcfg, src, dst, idx)
    tb, _ = s5p_apply_deletion(tb, tcfg, src, dst, idx, device=CPU)
    jc, jd = R.compact_bundle(jb, jcfg)
    tc, td = compact_bundle(tb, tcfg, device=CPU)
    assert td == jd and td > 0
    same_bundle(jc, tc, "compacted")
    np.testing.assert_array_equal(tc["parts"], tb["parts"])
    assert compact_bundle(tc, tcfg, device=CPU)[1] == 0
    js, jn = R.compact_edge_slots(jc)
    ts, tn = compact_edge_slots(tc)
    assert tn == jn == idx.size
    same_bundle(js, ts, "slots")
    assert compact_edge_slots(ts)[1] == 0
    # later deletions still name global arrival indices
    more = np.arange(len(src) // 2, len(src) // 2 + 5)
    jm, jr = R.s5p_apply_deletion(js, jcfg, src, dst, more)
    tm, tr = s5p_apply_deletion(ts, tcfg, src, dst, more, device=CPU)
    same_bundle(jm, tm, "after slots")
    same_result(jr, tr, "after slots")
    with pytest.raises(ValueError, match="already deleted"):
        s5p_apply_deletion(ts, tcfg, src, dst, idx[:1], device=CPU)
    jr2, jres = R.s5p_cold_restart(tm, jcfg, src, dst)
    tr2, tres = s5p_cold_restart(tm, tcfg, src, dst, device=CPU)
    same_bundle(jr2, tr2, "cold restart")
    same_result(jres, tres, "cold restart")


def test_refresh_signal_fires_under_heavy_growth():
    src, dst, n, _ = random_graph(1)
    jcfg, tcfg = _cfgs(xi_refresh_threshold=0.2, refine_rounds=0,
                       drift_rf_threshold=INF, drift_balance_threshold=INF,
                       drift_churn_threshold=INF)
    E0 = len(src) // 3
    _, jb = R.s5p_cold_bundle(src[:E0], dst[:E0], n, jcfg)
    _, tb = s5p_cold_bundle(src[:E0], dst[:E0], n, tcfg, device=CPU)
    _, jr = R.s5p_apply_delta(jb, jcfg, src, dst, E0)
    _, tr = s5p_apply_delta(tb, tcfg, src, dst, E0, device=CPU)
    same_result(jr, tr, "refresh")
    assert tr.xi_drift > 0.2 and tr.needs_cold_restart


# ======================================================= window chain

@pytest.mark.parametrize("case", ["default", "maintenance"])
def test_window_chain_steps_equal_the_reference(case):
    src, dst, n, _ = random_graph(2)
    W, B = 128, 48
    # "maintenance": a cold restart, cluster-id and slot compaction all fire
    kw = {"default": {}, "maintenance": dict(compact_factor=1.0, slot_compact_factor=1.2,
                                             auto_cold_restart=True)}[case]
    jcfg, tcfg = _cfgs(xi_refresh_threshold=0.05)
    jchain = R.S5PWindowChain(src, dst, n, jcfg, W, step_edges=B, **kw)
    tchain = S5PWindowChain(src, dst, n, tcfg, W, step_edges=B, device=CPU, **kw)
    steps = []
    while True:
        js, ts = jchain.step(), tchain.step()
        if js is None:
            assert ts is None
            break
        same_result(js, ts, f"step {js.step}")
        if js.filling:
            assert tchain.live_partition() is None
        else:
            for a, b in zip(jchain.live_partition(), tchain.live_partition()):
                np.testing.assert_array_equal(a, b)
        steps.append(ts)
    same_bundle(jchain.bundle, tchain.bundle, "final")
    assert len(steps) == -(-len(src) // B)
    assert any(s.n_retracted > 0 for s in steps)
    if case == "maintenance":
        assert any(s.n_compacted for s in steps) and any(s.n_slots_freed for s in steps)
        assert any(s.cold_restarted for s in steps)
    live_s, live_d = tchain.live_edges()
    last = steps[-1]
    assert live_s.size == last.hi - last.lo
    # an elastic resize of the live window: the reference's reshard, bit for bit
    k2 = tcfg.k + 2
    jres, tres = jchain.resize(k2), tchain.resize(k2)
    assert tuple(jres) == tuple(tres) and tchain.config.k == k2
    same_bundle(jchain.bundle, tchain.bundle, "resized")


def test_sliding_window_tracks_the_live_set():
    from repro_torch.incremental import s5p_sliding_window

    src, dst, n, _ = random_graph(2)
    W, B = 128, 48
    _, tcfg = _cfgs()
    hist, bundle = s5p_sliding_window(src, dst, n, tcfg, W, step_edges=B, device=CPU)
    last = hist[-1]
    alive = np.asarray(bundle["alive"], bool)
    expect = np.zeros(last.hi, bool)
    expect[last.lo:last.hi] = True
    np.testing.assert_array_equal(alive, expect)
    parts = np.asarray(bundle["parts"])
    assert np.all(parts[~alive] == -1)
    valid = alive & (src[:last.hi] != dst[:last.hi])
    assert np.all(parts[valid] >= 0) and np.all(parts[valid] < K)
    assert all(h.hi - h.lo <= W for h in hist)


# ================================================ scan-partitioner deletion

@pytest.mark.parametrize("name", ["greedy", "grid"])
def test_scan_suffix_deletion_equals_prefix_cold_start(name, tmp_path):
    src, dst, n, _ = random_graph(1)
    E = len(src)
    cut = int(E * 0.8)
    cold_start(tmp_path / "full", name, src, dst, n, K, chunk_size=37, device=CPU)
    res = run_incremental(tmp_path / "full", name, src, dst, n, K, chunk_size=37,
                          delete=np.arange(cut, E), save=True, device=CPU)
    assert res.n_retracted == E - cut
    cold_start(tmp_path / "prefix", name, src[:cut], dst[:cut], n, K, chunk_size=37,
               device=CPU)
    flat_full, _ = CarryStore(tmp_path / "full").load()
    flat_pref, _ = CarryStore(tmp_path / "prefix").load()
    np.testing.assert_array_equal(np.asarray(flat_full["parts"])[:cut], flat_pref["parts"])
    assert np.all(np.asarray(flat_full["parts"])[cut:] == -1)
    for key in flat_pref:
        if key not in ("parts", "alive"):
            np.testing.assert_array_equal(flat_full[key], flat_pref[key], err_msg=key)


def test_hdrf_deletion_equals_the_reference(tmp_path):
    src, dst, n, _ = random_graph(2)
    E = len(src)
    idx = np.sort(np.random.default_rng(0).choice(E, size=E // 5, replace=False))
    cold_start(tmp_path / "t", "hdrf", src, dst, n, K, chunk_size=41, device=CPU)
    R.cold_start(tmp_path / "j", "hdrf", src, dst, n, K, chunk_size=41)
    res = run_incremental(tmp_path / "t", "hdrf", src, dst, n, K, chunk_size=41,
                          delete=idx, device=CPU)
    jres = R.run_incremental(tmp_path / "j", "hdrf", src, dst, n, K, chunk_size=41,
                             delete=idx)
    same_result(jres, res, "hdrf deletion")
    parts = np.asarray(res.parts)
    live = np.ones(E, bool)
    live[idx] = False
    live &= src != dst
    assert np.all(parts[idx] == -1)
    assert np.all(parts[live] >= 0) and np.all(parts[live] < K)
    with pytest.raises(ValueError, match="already deleted"):
        run_incremental(tmp_path / "t", "hdrf", src, dst, n, K, chunk_size=41,
                        delete=idx[:3], save=False, device=CPU)


# ====================================== run_parallel: replay from disk

class _CountingStore(CarryStore):
    loads = 0

    def load(self, *a, **kw):
        type(self).loads += 1
        return super().load(*a, **kw)


@pytest.mark.parametrize("name", ["hdrf", "cluster", "sketch"])
def test_run_parallel_carry_store_replays_from_disk(name, tmp_path):
    from repro_torch.streaming import EdgeStream, run_parallel
    from test_torch_carry_algebra import _impls

    src, dst, n, _ = random_graph(1)
    _, pc, _ = _impls(name, n)
    if name == "sketch":  # the Θ pass streams pairs of ids below its width
        src, dst = src % 32, dst % 32
    stream = EdgeStream(src, dst, n, chunk_size=11, device=CPU)
    kw = dict(num_streams=3, super_chunk=2)
    want_parts, want = run_parallel(stream, pc, **kw)
    store = _CountingStore(tmp_path / "bases", keep=2)
    inject = LaneFaultInjector([(1, stream.n_chunks // 2)])
    got_parts, got = run_parallel(stream, pc, carry_store=store, on_lane_failure="replay",
                                  lane_injector=inject, carry_consumer=f"lanes:{name}",
                                  carry_config={"n": n}, **kw)
    assert inject.fired and _CountingStore.loads >= 1
    from repro_torch.streaming.carry import tree_leaves

    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    if want_parts is not None:
        assert torch.equal(got_parts, want_parts)
    steps = store.steps()
    assert len(steps) == 2 and steps[-1] == len(src)
    flat, meta = store.load()
    assert meta["consumer"] == f"lanes:{name}" and meta["config"]["shard"] == "range"
    # without replay the failure propagates
    with pytest.raises(RuntimeError, match="injected"):
        run_parallel(stream, pc, carry_store=CarryStore(tmp_path / "b2"),
                     lane_injector=LaneFaultInjector([(0, 0)]), **kw)
