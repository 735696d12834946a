"""Port parity: ``repro_torch.hybrid`` (the memory-budget hybrid partitioner:
planner, core refiner, ``run_hybrid``, ``HybridServingChain``) and the
partition CLI's ``--host-budget`` / ``--hybrid`` against the live
``repro.hybrid`` and ``repro.launch.partition``, on the CPU.

Each of ``tests/test_hybrid.py``'s seven tests has a counterpart here that
runs the same inputs through both packages, asserts the reference test's
postconditions on the port's output and compares every field bitwise:
every ``BudgetPlan`` and ``HybridResult`` field (the timings only by their
keys: they are seconds), every bundle leaf with its dtype, the parts,
``accepted_levels``, ``game_rounds`` and ``peak_budget_bytes``.  Then the
pieces: the degree sketch at S = 1 and S = 4 hub lanes and its retract,
``plan_budget`` at five budgets, ``TailAssignCarry`` from a seeded load,
``place_core`` and ``core_move_mask``, a spill that retreats up the
ladder, a level that is not kept, S = 4 hub lanes, a ``ShardedEdgeStream``
input, the serving chain through the port's ``ServingController``, the
CLI row, its validation and ``--save-carry``'s store, and the auto-budget
helpers of ``tests/test_hub_ingest.py``.  No tolerance: every comparison
is exact.  Reference runs are shared through module-scoped fixtures.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.hybrid as RH
import repro.incremental as RI
import repro.launch.partition as rcli
import repro.serving as RS
import repro.streaming as rs
from repro.core import S5PConfig as JConfig
from repro.core.s5p import s5p_partition as j_s5p
from repro.hybrid.planner import DegreeSketchCarry as JDegreeSketchCarry
from repro.hybrid.refiner import CoreBuffer as JCoreBuffer
from repro.hybrid.refiner import TailAssignCarry as JTailAssignCarry
from repro_torch import random as trandom
from repro_torch.core.metrics import replication_factor
from repro_torch.core.s5p import S5PConfig, s5p_partition
from repro_torch.graphs import block_rmat_graph, community_graph
from repro_torch.hybrid import (CORE_EDGE_BYTES, HybridServingChain, core_move_mask,
                                place_core, plan_budget, run_hybrid)
from repro_torch.hybrid.planner import DegreeSketchCarry
from repro_torch.hybrid.refiner import CoreBuffer, TailAssignCarry
from repro_torch.incremental import CarryStore, run_incremental, s5p_identity_config
from repro_torch.incremental.driver import _prefix_crc
from repro_torch.launch import partition as cli
from repro_torch.launch.partition import (_fraction_arg, _parse_meminfo_available,
                                          _super_chunk_arg, auto_host_budget,
                                          detect_available_memory, parse_bytes)
from repro_torch.serving import BundleRegistry, ServingController
from repro_torch.streaming import EdgeStream, ShardedEdgeStream, run_carry, run_parallel, write_shards
from test_torch_controller import _recording, _same_published
from test_torch_incremental import same_bundle, same_files, same_result

K = 4
CPU = "cpu"


@contextlib.contextmanager
def _partitionable():
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    with trandom.threefry_partitionable(True):
        yield
    jax.config.update("jax_threefry_partitionable", prev)


@pytest.fixture(autouse=True)
def _threefry_partitionable():
    with _partitionable():
        yield


def _graph(seed=0):
    return community_graph(400, n_communities=8, avg_degree=6, p_intra=0.9, seed=seed)


def _cfgs(k=K, seed=0, chunk=1 << 12, **kw):
    kw = dict(k=k, seed=seed, chunk_size=chunk, **kw)
    return JConfig(**kw), S5PConfig(**kw)


def _hybrid_pair(src, dst, n, budget, **cfg_kw):
    jc, tc = _cfgs(**cfg_kw)
    with _partitionable():
        ref = RH.run_hybrid((src, dst, n), jc, host_budget=budget)
        port = run_hybrid((src, dst, n), tc, host_budget=budget, device=CPU)
    return ref, port


def same_plan(ref, port) -> None:
    assert type(ref)._fields == type(port)._fields
    assert tuple(ref) == tuple(port)
    assert ref.resident == port.resident


def same_hybrid(ref, port, what: str = "") -> None:
    """Every field of two ``HybridResult``s equal (timings by keys)."""
    assert type(ref)._fields == type(port)._fields, what
    for f in ref._fields:
        a, b = getattr(ref, f), getattr(port, f)
        if f == "timings":
            assert set(a) <= set(b), (what, a.keys(), b.keys())
        elif f == "bundle":
            same_bundle(a, b, f"{what} bundle")
        elif f == "plan":
            same_plan(a, b)
        elif f == "parts":
            assert b.dtype == np.int32
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=f"{what} parts")
        else:
            assert type(a) is type(b) and a == b, (what, f, a, b)


# ----------------------------------------------------- shared reference runs

@pytest.fixture(scope="module")
def frontier():
    src, dst, n = _graph(2)
    full = src.size * CORE_EDGE_BYTES * 2
    return [_hybrid_pair(src, dst, n, int(f * full)) for f in (0.0, 0.3, 1.0)]


@pytest.fixture(scope="module")
def block_rmat_run():
    src, dst, n = block_rmat_graph(block_scale=6, n_blocks=4, edge_factor=8, seed=0)
    budget = int(0.25 * src.size * CORE_EDGE_BYTES * 2)
    return (src, dst, n, budget), _hybrid_pair(src, dst, n, budget)


def _retreat_graph():
    """131,072 edges whose stride sample (every other edge) hides the hubs:
    the even positions hold 2,048 edges among 8 super vertices, 8,192
    among 1,024 mid vertices and a ring of low vertices; the odd ones
    edges among 512 hubs, whose degree lies between the mid and the super
    vertices'.  The planner's estimate then misses the hubs' edges at
    every threshold below the super vertices', and the spill retreats."""
    rng = np.random.default_rng(26)
    half = 1 << 16
    sup = rng.integers(0, 8, (2048, 2))
    mid = 8 + rng.integers(0, 1024, (8192, 2))
    low_ids = 8 + 1024 + 512 + np.arange(half - 2048 - 8192)
    low = np.stack([low_ids, np.roll(low_ids, 1)], 1)
    even = np.concatenate([sup, mid, low])[rng.permutation(half)]
    odd = 8 + 1024 + rng.integers(0, 512, (half, 2))
    e = np.empty((2 * half, 2), np.int64)
    e[0::2], e[1::2] = even, odd
    return e[:, 0].astype(np.int32), e[:, 1].astype(np.int32), int(e.max()) + 1


# ================================================= 1. budget planner

def test_planner_modes_and_ladder_prefix():
    src, dst, n = _graph()
    E = src.size
    full = E * CORE_EDGE_BYTES + (1 << 20)  # past every record + overhead
    plans = {}
    for name, b in (("zero", 0), ("none", 4500), ("mid", full // 4), ("big", full // 2),
                    ("full", full)):
        ref = RH.plan_budget(src, dst, n, b)
        plans[name] = plan_budget(src, dst, n, b, device=CPU)
        same_plan(ref, plans[name])
    p0, p_none, p_mid, p_big, p_full = plans.values()
    assert p0.mode == "streaming" and not p0.resident and p0.ladder == ()
    assert p0.sample_edges == 0 and p0.sketch_bytes == 0
    # a budget that affords no fraction still reports its sample and sketch
    assert p_none.mode == "streaming" and p_none.ladder == ()
    assert p_none.sample_edges == E and p_none.sketch_bytes > 0
    assert p_full.mode == "in_memory" and p_full.xi_star == 0 and p_full.ladder[-1] == 0
    assert p_big.ladder[:len(p_mid.ladder)] == p_mid.ladder
    assert p_full.ladder[:len(p_big.ladder)] == p_big.ladder
    for p in (p_mid, p_big):
        if p.resident:
            assert p.est_core_bytes <= p.budget_bytes


@pytest.mark.parametrize("lanes", [1, 4])
def test_degree_sketch_tables_and_retract(lanes):
    """The degree pass's CMS bit for bit at S = 1 and S = 4 hub lanes; one
    chunk's retract, and the whole stream's, bit for bit too."""
    src, dst, n = _graph(5)
    src = np.concatenate([src, np.array([7, 9], np.int32)])  # two self-loops
    dst = np.concatenate([dst, np.array([7, 9], np.int32)])
    chunk = 256
    jpc, tpc = JDegreeSketchCarry(90, 5, seed=3), DegreeSketchCarry(90, 5, seed=3, device=CPU)
    jst = rs.EdgeStream(src, dst, n, chunk_size=chunk)
    tst = EdgeStream(src, dst, n, chunk_size=chunk, device=CPU)
    kw = dict(num_streams=lanes, super_chunk=2, shard="hub")
    _, js_ = rs.run_parallel(jst, jpc, **kw)
    _, ts_ = run_parallel(tst, tpc, **kw)

    def same(j, t):
        np.testing.assert_array_equal(np.asarray(j.table),
                                      t.table.numpy().view(np.uint32))
        np.testing.assert_array_equal(np.asarray(j.seeds), t.seeds.numpy().astype(np.uint32))

    same(js_, ts_)
    assert js_.memory_bytes() == ts_.memory_bytes()
    deg = np.bincount(src[src != dst], minlength=n) + np.bincount(dst[src != dst], minlength=n)
    from repro_torch.core.cms import cms_query, vertex_key
    est = cms_query(ts_, vertex_key(torch.arange(n))).numpy()
    assert (est >= deg).all()  # one-sided over-estimate
    c0 = next(iter(tst.chunks()))
    jr = jpc.retract_chunk(js_, jnp.asarray(c0.src.numpy()), jnp.asarray(c0.dst.numpy()),
                           c0.n_valid, None)
    tr = tpc.retract_chunk(ts_, c0.src, c0.dst, c0.n_valid, None)
    same(jr, tr)
    for ch in list(tst.chunks())[1:]:
        tr = tpc.retract_chunk(tr, ch.src, ch.dst, ch.n_valid, None)
    assert not tr.table.any()


# ============================================== 2. zero-budget parity

def test_zero_budget_bit_identical_to_streaming():
    src, dst, n = _graph(1)
    jc, tc = _cfgs()
    ref_base = j_s5p(src, dst, n, jc)
    base = s5p_partition(src, dst, n, tc, device=CPU)
    ref, res = _hybrid_pair(src, dst, n, 0)
    same_hybrid(ref, res, "zero")
    assert res.mode == "streaming" and res.core_edges == 0
    np.testing.assert_array_equal(res.parts, base.parts.numpy())
    np.testing.assert_array_equal(res.parts, np.asarray(ref_base.parts))
    assert res.rf == res.rf_streaming and res.peak_budget_bytes == 0


# ============================================ 3. small-budget smoke

def test_small_budget_hybrid_gates(block_rmat_run):
    (src, dst, n, budget), (ref, res) = block_rmat_run
    same_hybrid(ref, res, "block-rmat")
    E = src.size
    assert res.mode in ("hybrid", "in_memory") and res.core_edges > 0
    assert res.peak_budget_bytes <= budget
    assert res.rf <= res.rf_streaming + 1e-9
    assert res.rf == replication_factor(torch.from_numpy(src), torch.from_numpy(dst),
                                        torch.from_numpy(res.parts), n_vertices=n, k=K)
    assert len(res.bundle) == 40
    for key in ("parts", "c2p", "load", "stream_pos", "arrival", "alive"):
        assert key in res.bundle
    assert int(res.bundle["stream_pos"]) == E


# ============================================== 4. monotone frontier

def test_frontier_monotone_rf(frontier):
    prev = None
    for i, (ref, res) in enumerate(frontier):
        same_hybrid(ref, res, f"rung {i}")
        if prev is not None:
            assert res.rf <= prev + 1e-9
        prev = res.rf


def test_level_not_kept_leaves_the_incumbent_load(frontier):
    """At the full rung some ladder levels play a game whose composed RF
    is not better: the bundle's load stays the kept placement's, equal to
    the reference's and to the parts' histogram."""
    ref, res = frontier[-1]
    played = [lv for lv in res.plan.ladder if lv not in res.accepted_levels]
    assert res.accepted_levels and played and res.game_rounds > 0
    np.testing.assert_array_equal(res.bundle["load"], ref.bundle["load"])
    live = res.parts[res.parts >= 0]
    np.testing.assert_array_equal(res.bundle["load"], np.bincount(live, minlength=K))


# ============================================ pieces of the refiner

def _core_and_tables(seed=4, n=300, E=2000, C=40):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, E).astype(np.int32)
    dst = rng.integers(0, n, E).astype(np.int32)
    degrees = (np.bincount(src, minlength=n) + np.bincount(dst, minlength=n)).astype(np.int32)
    degrees[0] = 10 * degrees.max()  # vertex 0 a hub: padding tags as core
    v2c_h = np.where(rng.random(n) < 0.3, rng.integers(0, C, n), -1).astype(np.int32)
    v2c_t = rng.integers(-1, C, n).astype(np.int32)
    c2p = rng.integers(0, K, C).astype(np.int32)
    return src, dst, n, degrees, v2c_h, v2c_t, c2p


def test_tail_assign_carry_from_a_seeded_load():
    src, dst, n, degrees, v2c_h, v2c_t, c2p = _core_and_tables()
    xi, level = int(np.median(degrees)), int(np.percentile(degrees, 80))
    load0 = np.array([30, 0, 120, 7], np.int32)
    max_load = int(np.ceil(src.size / K)) + 40
    jt = JTailAssignCarry(K, max_load, jnp.asarray(c2p), degrees=degrees, v2c_h=v2c_h,
                          v2c_t=v2c_t, xi=xi, core_threshold=level)
    tt = TailAssignCarry(K, max_load, torch.from_numpy(c2p), degrees=degrees,
                         v2c_h=v2c_h, v2c_t=v2c_t, xi=xi, core_threshold=level)
    jp, jl = rs.run_carry(rs.EdgeStream(src, dst, n, chunk_size=300), jt,
                          carry=jnp.asarray(load0))
    tp, tl = run_carry(EdgeStream(src, dst, n, chunk_size=300, device=CPU), tt,
                       carry=torch.from_numpy(load0.copy()))
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
    core = (degrees[src] > level) & (degrees[dst] > level)
    assert core.any() and (tp.numpy()[core] == -1).all()
    assert int(tl.sum() - load0.sum()) == int(((src != dst) & ~core).sum())


def test_place_core_and_move_mask():
    src, dst, n, degrees, v2c_h, v2c_t, c2p = _core_and_tables(7)
    head = (degrees[src] > 12) & (degrees[dst] > 12)
    cu = np.where(head, v2c_h[src], v2c_t[src]).astype(np.int32)
    cv = np.where(head, v2c_h[dst], v2c_t[dst]).astype(np.int32)
    m = src != dst
    fields = (src[m], dst[m], np.flatnonzero(m).astype(np.int64), cu[m], cv[m],
              np.minimum(degrees[src], degrees[dst])[m].astype(np.int32), head[m])
    jcore, tcore = JCoreBuffer(*fields), CoreBuffer(*fields)
    assert tcore.nbytes() == tcore.n_edges * CORE_EDGE_BYTES == jcore.nbytes()
    for chunk in (512, 1 << 16):  # several chunks, and one of min(chunk, M)
        jp, jl = RH.place_core(jcore, c2p, K, 600, n, chunk_size=chunk)
        tp, tl = place_core(tcore, c2p, K, 600, n, chunk_size=chunk, device=CPU)
        assert tp.dtype == np.int32 and tl.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(jp), tp)
        np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
    np.testing.assert_array_equal(RH.core_move_mask(jcore, 40), core_move_mask(tcore, 40))
    empty = tcore.select(np.zeros(tcore.n_edges, bool))
    ep, el = place_core(empty, c2p, K, 600, n, device=CPU)
    assert ep.shape == (0,) and el.tolist() == [0] * K


def test_spill_retreats_up_the_ladder():
    src, dst, n = _retreat_graph()
    ref, res = _hybrid_pair(src, dst, n, 800_000, k=8, chunk=1 << 14)
    same_hybrid(ref, res, "retreat")
    assert res.mode == "hybrid" and res.xi_star > res.plan.xi_star  # retreated
    assert res.xi_star in res.plan.ladder
    assert res.peak_budget_bytes <= 800_000 and res.core_edges > 0


def test_hub_lanes_and_sharded_stream(tmp_path):
    """S = 4 hub lanes (pass 0, the degree sketch and the tail), and the
    same graph paged from disk shards in each package."""
    src, dst, n = _graph(6)
    budget = src.size * CORE_EDGE_BYTES
    ref, res = _hybrid_pair(src, dst, n, budget, chunk=256, num_streams=4, shard="hub",
                            super_chunk=2)
    same_hybrid(ref, res, "hub lanes")
    assert res.core_edges > 0
    write_shards(tmp_path, src, dst, shard_edges=700, n_vertices=n)
    jc, tc = _cfgs(chunk=512)
    jst = rs.ShardedEdgeStream(tmp_path / "manifest.json", chunk_size=512)
    tst = ShardedEdgeStream(tmp_path / "manifest.json", chunk_size=512, device=CPU)
    try:
        same_hybrid(RH.run_hybrid(jst, jc, host_budget=budget),
                    run_hybrid(tst, tc, host_budget=budget), "sharded")
    finally:
        jst.close()
        tst.close()


# ========================================== 5a. incremental round-trip

def test_bundle_roundtrip_run_incremental(tmp_path):
    src, dst, n = _graph(3)
    E = src.size
    ref, res = _hybrid_pair(src, dst, n, E * CORE_EDGE_BYTES * 2)
    same_hybrid(ref, res, "roundtrip")
    jc, cfg = _cfgs()
    meta = {"n_vertices": int(n), "prefix_crc": _prefix_crc(src, dst, E)}
    CarryStore(tmp_path / "port").save(res.bundle, consumer="s5p",
                                       config=s5p_identity_config(cfg), stream_pos=E,
                                       extra_meta=meta)
    RI.CarryStore(tmp_path / "ref").save(ref.bundle, consumer="s5p",
                                         config=RI.s5p_identity_config(jc), stream_pos=E,
                                         extra_meta=meta)
    same_files(tmp_path / "ref", tmp_path / "port")
    rng = np.random.default_rng(7)
    dsrc = rng.integers(0, n, 64).astype(np.int32)
    ddst = rng.integers(0, n, 64).astype(np.int32)
    full_src = np.concatenate([src, dsrc])
    full_dst = np.concatenate([dst, ddst])
    inc = run_incremental(tmp_path / "port", "s5p", full_src, full_dst, n, K,
                          s5p_config=cfg, save=False, device=CPU)
    jinc = RI.run_incremental(tmp_path / "ref", "s5p", full_src, full_dst, n, K,
                              s5p_config=jc, save=False)
    same_result(jinc, inc, "warm start")
    assert inc.n_delta_edges == 64 and inc.parts.shape[0] == E + 64
    live = inc.parts >= 0
    assert inc.rf == pytest.approx(replication_factor(
        torch.from_numpy(full_src[live]), torch.from_numpy(full_dst[live]),
        torch.from_numpy(np.asarray(inc.parts[live], np.int32)), n_vertices=n, k=K), abs=1e-6)


# ============================================= 5b. serving round-trip

def test_serving_roundtrip_publishes_hybrid_bundle():
    src, dst, n = _graph(4)
    E = src.size
    ref, res = _hybrid_pair(src, dst, n, E * CORE_EDGE_BYTES * 2)
    same_hybrid(ref, res, "serving")
    jc, cfg = _cfgs()
    rng = np.random.default_rng(11)
    delta = (rng.integers(0, n, 48).astype(np.int32), rng.integers(0, n, 48).astype(np.int32))
    jreg, reg = _recording(RS.BundleRegistry), _recording(BundleRegistry)
    jctl = RS.ServingController(jreg, RH.HybridServingChain(ref, jc, src, dst, n,
                                                            deltas=[delta]))
    chain = HybridServingChain(res, cfg, src, dst, n, deltas=[delta], device=CPU)
    controller = ServingController(reg, chain)

    jrec, rec = jctl.step(), controller.step()
    assert tuple(jrec) == tuple(rec)
    b1 = reg.current
    assert b1.version == 1 and b1.origin == "cold"
    b1.check()
    assert b1.n_edges == E and b1.rf == res.rf

    jrec, rec = jctl.step(), controller.step()
    same_result(jrec, rec, "delta step")
    same_bundle(jctl.chain.bundle, chain.bundle, "after the delta")
    b2 = reg.current
    assert b2.version == 2 and b2.n_edges == E + 48 and b2.origin == jreg.current.origin
    b2.check()
    assert reg.swap_count == 1

    assert jctl.step() is None and controller.step() is None
    assert controller.done.is_set()
    _same_published(jreg, reg)


# ======================================================== 6. CLI

def test_parse_bytes_accepts_human_sizes():
    for spec in ("512M", "2G", "64KB", "1048576", "0", " 3k ", "7t"):
        assert parse_bytes(spec) == rcli.parse_bytes(spec)
    assert parse_bytes("512M") == 512 << 20 and parse_bytes("2G") == 2 << 30
    assert parse_bytes("64KB") == 64 << 10 and parse_bytes("0") == 0
    for bad in ("", "-1", "12Q", "G", "1.5.2M"):
        with pytest.raises(argparse.ArgumentTypeError):
            parse_bytes(bad)
    assert _fraction_arg("0.25") == 0.25 and _fraction_arg("1") == 1.0
    for bad in ("0", "1.01", "-0.5", "half"):
        with pytest.raises(argparse.ArgumentTypeError):
            _fraction_arg(bad)
    assert _super_chunk_arg("auto") == "auto"


def _row(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    rows = [ln for ln in buf.getvalue().splitlines() if ln.startswith("hybrid")]
    assert len(rows) == 1, buf.getvalue()
    # the columns without the trailing seconds
    return out, re.sub(r"\s+[0-9.]+s$", "", rows[0]), buf.getvalue()


def test_cli_host_budget_row_and_save_carry(tmp_path):
    kw = dict(chunk_size=1024, host_budget=parse_bytes("64K"))
    jres, jrow, _ = _row(rcli.run, "community:600", 8,
                         save_carry=str(tmp_path / "ref"), **kw)
    res, row, out = _row(cli.run, "community:600", 8, save_carry=str(tmp_path / "port"),
                         device=CPU, **kw)
    assert row == jrow and "mode=" in row and "peak=" in row
    same_hybrid(jres, res, "cli")
    assert "[hybrid] carry→" in out
    same_files(tmp_path / "ref", tmp_path / "port")
    got, _ = CarryStore(tmp_path / "port").load(consumer="s5p")
    want, _ = RI.CarryStore(tmp_path / "ref").load(consumer="s5p")
    same_bundle(want, got, "store")


@pytest.mark.parametrize("kw, match", [
    (dict(partitioner="hdrf"), "use --partitioner s5p"),
    (dict(compare=True), "single hybrid partition"),
    (dict(resize_k=3), "single hybrid partition"),
    (dict(window_edges=64), "single hybrid partition"),
    (dict(resume_carry="x"), "single hybrid partition"),
])
def test_cli_host_budget_validation(kw, match):
    for run in (rcli.run, lambda *a, **k: cli.run(*a, device=CPU, **k)):
        with pytest.raises(ValueError, match=match):
            run("toy", 2, host_budget=1 << 20, **kw)


def test_cli_hybrid_auto_sizes_the_budget(monkeypatch, capsys):
    monkeypatch.setattr(cli, "detect_available_memory", lambda: 8 << 20)
    res = cli.run("community:300", 4, hybrid=True, budget_fraction=0.25, chunk_size=512,
                  device=CPU)
    out = capsys.readouterr().out
    assert f"auto-sized --host-budget: {2 << 20} bytes (25% of available" in out
    assert res.budget_bytes == 2 << 20 and res.mode == "in_memory"


# ==================================================== --hybrid auto-budget
MEMINFO = """\
MemTotal:       16316412 kB
MemFree:         1056716 kB
MemAvailable:    9874456 kB
Buffers:          504812 kB
"""


def test_parse_meminfo_prefers_memavailable():
    assert _parse_meminfo_available(MEMINFO) == 9874456 * 1024
    assert rcli._parse_meminfo_available(MEMINFO) == _parse_meminfo_available(MEMINFO)


def test_parse_meminfo_falls_back_to_memfree():
    text = "MemTotal: 4096 kB\nMemFree: 2048 kB\n"
    assert _parse_meminfo_available(text) == 2048 * 1024


def test_parse_meminfo_units_and_garbage():
    assert _parse_meminfo_available("MemAvailable: 3 GB\n") == 3 << 30
    assert _parse_meminfo_available("MemAvailable: 7 MB\n") == 7 << 20
    assert _parse_meminfo_available("MemAvailable: 42 B\n") == 42
    for text in ("", "MemAvailable: lots kB\n", "MemAvailable: 5 parsecs\n"):
        assert _parse_meminfo_available(text) is None


def test_detect_available_memory_on_this_host():
    avail = detect_available_memory()
    assert avail is not None and avail > 0


def test_auto_host_budget_fraction_validation():
    with pytest.raises(ValueError, match="budget_fraction"):
        auto_host_budget(0.0)
    with pytest.raises(ValueError, match="budget_fraction"):
        auto_host_budget(1.5)
    half, full = auto_host_budget(0.5), auto_host_budget(1.0)
    assert 0 < half <= full
