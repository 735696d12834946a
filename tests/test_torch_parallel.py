"""Port parity: parallel ingest (``repro_torch.streaming.parallel``), the
masked game, S5P's touch-up, the batched engines and the CLI's parallel
flags, against the live reference on the same numpy inputs, at tolerance 0.

Mirrors the reference's ``tests/test_carry.py`` (engine part) and
``tests/test_hub_ingest.py``: the plans (lanes, per-edge lanes, pins,
hub threshold) equal the reference's in all three shard modes and keep
the hub-plan invariants; ``run_parallel`` gives the reference's parts and
merged carries for S ∈ {2, 4}, every shard mode, ``super_chunk`` ∈ {1, 8,
"auto"} and both backends; S = 1 is the sequential drive; a lane that
raises once and is replayed gives the same bits.  Every reference call
that draws threefry bits runs with ``jax_threefry_partitionable`` set."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from proptest import random_graph

import repro.streaming as js
from repro.core import S5PConfig as JConfig
from repro.core import game as jgame
from repro.core import s5p_partition as jax_s5p
from repro.core.baselines import grid_partition_multi_seed as j_grid_multi
from repro.core.baselines import hdrf_partition_batched as j_hdrf_batched
from repro.core.clustering import ClusterCarry as JCluster
from repro.core.clustering import DegreeCarry as JDegree
from repro.core.cms import SketchCarry as JSketch
from repro.core.postprocess import AssignCarry as JAssign
from repro.graphs.generators import block_rmat_graph, community_graph
from repro.kernels.stream_scan import GreedyCarry as JGreedy
from repro.kernels.stream_scan import GridCarry as JGrid
from repro.kernels.stream_scan import HdrfCarry as JHdrf
from repro_torch import interop
from repro_torch.core import baselines as tb
from repro_torch.core import clustering as tcl
from repro_torch.core import game as tgame
from repro_torch.core import metrics as tmetrics
from repro_torch.core.cms import SketchCarry
from repro_torch.core.postprocess import AssignCarry
from repro_torch.core.s5p import S5PConfig, s5p_partition
from repro_torch.kernels.stream_scan import GreedyCarry, GridCarry, HdrfCarry
from repro_torch.runtime import LaneFaultInjector
from repro_torch.streaming import (EdgeStream, ParallelEdgeStream, last_ingest_stats,
                                   reset_cadence_log, run_carry, run_parallel,
                                   run_retract)
from repro_torch.streaming.carry import tree_leaves
from repro_torch.streaming.parallel import ISOLATE_CADENCE, _compress_schedule

K = 4


@pytest.fixture(autouse=True)
def _threefry_partitionable():
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", prev)


def _bits(x) -> np.ndarray:
    a = np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _same(ref, port, what=""):
    lr = jax.tree_util.tree_leaves(ref)
    lp = tree_leaves(port)
    assert len(lr) == len(lp), what
    for i, (a, b) in enumerate(zip(lr, lp)):
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=f"{what} leaf {i}")


def _streams(src, dst, n, chunk, **kw):
    return (js.EdgeStream(src, dst, n, chunk_size=chunk, **kw),
            EdgeStream(src, dst, n, chunk_size=chunk, device="cpu", **kw))


# ---------------------------------------------------------------- the plans

def _graphs():
    out = [random_graph(s)[:3] for s in (0, 1, 3)]
    out.append(community_graph(600, 8, 6, seed=3))
    return out


@pytest.mark.parametrize("gi", range(4))
@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("shard", ["range", "rr", "hub"])
def test_plans_equal_the_reference(gi, S, shard):
    src, dst, n = _graphs()[gi]
    chunk = 16 if gi < 3 else 128
    jst, tst = _streams(src, dst, n, chunk)
    jp = js.ParallelEdgeStream(jst, S, shard=shard)
    tp = ParallelEdgeStream(tst, S, shard=shard)
    assert (jp.num_streams, jp.shard, jp.hub_threshold, jp.n_rounds) == (
        tp.num_streams, tp.shard, tp.hub_threshold, tp.n_rounds)
    assert jp.lanes == tp.lanes and jp.pin_map == tp.pin_map and jp.n_hubs == tp.n_hubs
    np.testing.assert_array_equal(jp.edge_lanes(), tp.edge_lanes())
    extra = np.arange(len(src), dtype=np.int32) * 3
    for lane in tp.lanes:
        for cid in lane:
            a, b = jp.chunk_for(cid, extra), tp.chunk_for(cid, torch.from_numpy(extra))
            assert (a.n_valid, a.start) == (b.n_valid, b.start)
            for x, y in ((a.src, b.src), (a.dst, b.dst), (a.extras[0], b.extras[0])):
                np.testing.assert_array_equal(np.asarray(x), y.numpy())
    ra, rb = jp.round_at(0), tp.round_at(0)
    for x, y in zip(ra[:3], rb[:3]):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    assert ra[4] == rb[4]


@pytest.mark.parametrize("seed", [0, 1, 3, 5])
@pytest.mark.parametrize("S", [2, 3, 4])
def test_hub_plan_invariants(seed, S):
    """Every edge on exactly one lane, each lane a subsequence of stream
    order, and every pinned hub's edges on its one rendezvous lane."""
    src, dst, n, _ = random_graph(seed)
    stream = EdgeStream(src, dst, n, chunk_size=16, ordering="shuffled", seed=2,
                        device="cpu")
    ps = ParallelEdgeStream(stream, S, shard="hub")
    seen = []
    for lane in ps.lanes:
        pos = np.concatenate([ps.chunk_positions(c) for c in lane]) if lane else []
        assert np.all(np.diff(pos) > 0)
        seen.append(pos)
    allpos = np.sort(np.concatenate(seen))
    np.testing.assert_array_equal(allpos, np.arange(len(src)))
    lanes = ps.edge_lanes()
    order = stream.order
    for v, lane in ps.pin_map.items():
        hub_pos = np.flatnonzero(ps._pin_vertex == v)
        assert np.all(lanes[order[hub_pos]] == lane)


def test_hub_threshold_override_and_cached_plan():
    src, dst, n, _ = random_graph(1)
    jst, tst = _streams(src, dst, n, 16)
    for thr in (2, 3, 50):
        jp = js.ParallelEdgeStream(jst, 4, shard="hub", hub_threshold=thr)
        tp = ParallelEdgeStream(tst, 4, shard="hub", hub_threshold=thr)
        assert jp.pin_map == tp.pin_map and jp.lanes == tp.lanes
    again = ParallelEdgeStream(tst, 4, shard="hub", hub_threshold=2)
    assert again._lane_of_pos is ParallelEdgeStream(tst, 4, shard="hub",
                                                    hub_threshold=2)._lane_of_pos


# ----------------------------------------------------------- run_parallel

def _carries(n):
    deg = np.full((n,), 5, np.int32)
    row = np.arange(n, dtype=np.int32) % 2
    c2p = np.arange(8, dtype=np.int32) % K
    return {
        "greedy": (lambda: JGreedy(n, K), lambda: GreedyCarry(n, K, device="cpu")),
        "hdrf": (lambda: JHdrf(n, K, 1.1), lambda: HdrfCarry(n, K, 1.1, device="cpu")),
        "grid": (lambda: JGrid(K, jnp.asarray(row), jnp.asarray(row), 2),
                 lambda: GridCarry(K, torch.from_numpy(row), torch.from_numpy(row), 2,
                                   device="cpu")),
        "cluster": (lambda: JCluster(jnp.asarray(deg), n, xi=3, kappa=40),
                    lambda: tcl.ClusterCarry(torch.from_numpy(deg), n, xi=3, kappa=40)),
        "assign": (lambda: JAssign(K, 60, jnp.asarray(c2p)),
                   lambda: AssignCarry(K, 60, torch.from_numpy(c2p))),
        "degree": (lambda: JDegree(n), lambda: tcl.DegreeCarry(n, device="cpu")),
        "sketch": (lambda: JSketch(64, 4, seed=3),
                   lambda: SketchCarry(64, 4, seed=3, device="cpu")),
    }


def _extras(E):
    rng = np.random.default_rng(0)
    return (rng.integers(0, 2, E).astype(bool), rng.integers(0, 8, E).astype(np.int32),
            rng.integers(0, 8, E).astype(np.int32))


_REF: dict = {}


def _reference(graph_seed, S, shard, sc, name):
    key = (graph_seed, S, shard, sc, name)
    if key not in _REF:
        src, dst, n, _ = random_graph(graph_seed)
        ex = _extras(len(src)) if name == "assign" else ()
        _REF[key] = js.run_parallel(js.EdgeStream(src, dst, n, chunk_size=13),
                                    _carries(n)[name][0](), *ex, num_streams=S,
                                    super_chunk=sc, shard=shard, backend="threads")
    return _REF[key]


@pytest.mark.parametrize("backend", ["threads", "vmap"])
@pytest.mark.parametrize("sc", [1, 8, "auto"])
@pytest.mark.parametrize("shard", ["range", "rr", "hub"])
@pytest.mark.parametrize("S", [2, 4])
def test_run_parallel_equals_the_reference(S, shard, sc, backend):
    """Parts and merged carries of all seven consumers, bit for bit."""
    graph_seed = 1
    src, dst, n, _ = random_graph(graph_seed)
    for name, (_, make) in _carries(n).items():
        jparts, jcarry = _reference(graph_seed, S, shard, sc, name)
        ex = _extras(len(src)) if name == "assign" else ()
        stream = EdgeStream(src, dst, n, chunk_size=13, device="cpu")
        tparts, tcarry = run_parallel(stream, make(), *ex, num_streams=S,
                                      super_chunk=sc, shard=shard, backend=backend)
        if jparts is None:
            assert tparts is None, name
        else:
            np.testing.assert_array_equal(np.asarray(jparts), tparts.numpy(), err_msg=name)
        _same(jcarry, tcarry, f"{name} {shard} S={S} sc={sc} {backend}")


@pytest.mark.parametrize("shard", ["range", "rr", "hub"])
@pytest.mark.parametrize("name", ["greedy", "hdrf", "cluster", "assign"])
def test_s1_is_the_sequential_drive(name, shard):
    src, dst, n, _ = random_graph(2)
    ex = _extras(len(src)) if name == "assign" else ()
    make = _carries(n)[name][1]
    stream = EdgeStream(src, dst, n, chunk_size=11, device="cpu")
    sp, sc_ = run_carry(stream, make(), *ex)
    pp, pc = run_parallel(stream, make(), *ex, num_streams=1, shard=shard,
                          super_chunk="auto")
    if sp is not None:
        assert torch.equal(sp, pp)
    for a, b in zip(tree_leaves(sc_), tree_leaves(pc)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    assert last_ingest_stats().backend == "sequential"


def test_s5p_s1_bit_identical_across_shards():
    src, dst, n, _ = random_graph(1)
    base = s5p_partition(src, dst, n, S5PConfig(k=K, chunk_size=17), device="cpu")
    for shard in ("range", "rr", "hub"):
        out = s5p_partition(src, dst, n, S5PConfig(k=K, chunk_size=17, shard=shard,
                                                   super_chunk="auto"), device="cpu")
        assert torch.equal(base.parts, out.parts)
        assert "touch_up" not in out.aux


@pytest.mark.parametrize("shard", ["range", "hub"])
@pytest.mark.parametrize("name", ["hdrf", "cluster", "sketch"])
def test_lane_replay_gives_the_unkilled_bits(name, shard):
    src, dst, n, _ = random_graph(1)
    make = _carries(n)[name][1]
    stream = EdgeStream(src, dst, n, chunk_size=13, device="cpu")
    kw = dict(num_streams=3, super_chunk=2, shard=shard)
    want_p, want = run_parallel(stream, make(), **kw)
    cid = ParallelEdgeStream(stream, 3, shard=shard).lanes[1][2]  # lane 1's third chunk
    inj = LaneFaultInjector([(1, cid)])
    got_p, got = run_parallel(stream, make(), on_lane_failure="replay",
                              lane_injector=inj, **kw)
    assert inj.fired == [(1, cid)]
    if want_p is not None:
        assert torch.equal(want_p, got_p)
    for a, b in zip(tree_leaves(want), tree_leaves(got)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    with pytest.raises(RuntimeError, match="injected lane 1"):
        run_parallel(stream, make(), lane_injector=LaneFaultInjector([(1, cid)]), **kw)


def test_linear_carries_are_exact_under_every_plan():
    src, dst, n, _ = random_graph(2)
    stream = EdgeStream(src, dst, n, chunk_size=9, device="cpu")
    want = tcl.compute_degrees(torch.from_numpy(src), torch.from_numpy(dst), n)
    _, seq = run_parallel(stream, SketchCarry(64, 4, seed=3, device="cpu"))
    for S in (2, 4, 8):
        for shard in ("range", "rr", "hub"):
            assert torch.equal(tcl.compute_degrees_stream(stream, S, 2, shard), want)
            _, sk = run_parallel(stream, SketchCarry(64, 4, seed=3, device="cpu"),
                                 num_streams=S, super_chunk="auto", shard=shard)
            assert torch.equal(sk.table, seq.table) and torch.equal(sk.seeds, seq.seeds)


@pytest.mark.parametrize("S", [1, 3])
def test_run_retract_sharded_equals_sequential(S):
    src, dst, n, _ = random_graph(1)
    stream = EdgeStream(src, dst, n, chunk_size=13, device="cpu")
    pc = HdrfCarry(n, K, device="cpu")
    parts, full = run_carry(stream, pc)
    cut = len(src) // 3
    back = EdgeStream(src[cut:], dst[cut:], n, chunk_size=7, device="cpu")
    jst = js.EdgeStream(src, dst, n, chunk_size=13)
    jpc = JHdrf(n, K, 1.1)
    jparts, jfull = js.run_carry(jst, jpc)
    jgot = js.run_retract(js.EdgeStream(src[cut:], dst[cut:], n, chunk_size=7), jpc,
                          np.asarray(jparts)[cut:], carry=jfull, num_streams=S)
    got = run_retract(back, pc, parts[cut:].numpy(), carry=tuple(
        x.clone() for x in full), num_streams=S)
    _same(jgot, got, f"retract S={S}")
    dc = tcl.DegreeCarry(n, device="cpu")
    _, deg = run_carry(stream, dc)
    left = run_retract(stream, dc, None, carry=deg.clone(), num_streams=S, shard="hub")
    assert int(left.abs().sum()) == 0


def test_auto_cadence_and_stats():
    src, dst, n, _ = random_graph(1)
    stream = EdgeStream(src, dst, n, chunk_size=7, device="cpu")
    run_parallel(stream, GreedyCarry(n, K, device="cpu"), num_streams=2,
                 super_chunk="auto")
    st = last_ingest_stats()
    assert st.schedule[0] == 1 and st.backend == "threads"
    assert sum(lane.edges for lane in st.lanes) == len(src)
    assert sum(lane.chunks for lane in st.lanes) == stream.n_chunks
    run_parallel(stream, tcl.DegreeCarry(n, device="cpu"), num_streams=3,
                 super_chunk="auto", shard="hub")
    st = last_ingest_stats()
    assert st.schedule == (ISOLATE_CADENCE,) and st.as_dict()["shard"] == "hub"
    assert sum(lane.edges for lane in st.lanes) == len(src)
    assert _compress_schedule([1, 1, 1, 2, 4, 8, 8]) == "1×3,2,4,8×2"
    assert _compress_schedule([ISOLATE_CADENCE]) == "all"


def test_cadence_logged_once_per_run(caplog):
    src, dst, n, _ = random_graph(1)
    stream = EdgeStream(src, dst, n, chunk_size=7, device="cpu")
    reset_cadence_log()
    with caplog.at_level(logging.INFO, logger="repro_torch.streaming.parallel"):
        for _ in range(2):
            run_parallel(stream, tcl.DegreeCarry(n, device="cpu"), num_streams=2,
                         super_chunk=3)
    assert sum("cadence" in r.message for r in caplog.records) == 1


def test_knobs_validate_and_unported_paths_raise(tmp_path):
    src, dst, n, _ = random_graph(1)
    stream = EdgeStream(src, dst, n, chunk_size=7, device="cpu")
    pc = tcl.DegreeCarry(n, device="cpu")
    for kw, err, match in [
            (dict(num_streams=0), ValueError, "num_streams"),
            (dict(super_chunk=0), ValueError, "super_chunk"),
            (dict(super_chunk="fast"), ValueError, "auto"),
            (dict(shard="diagonal"), ValueError, "shard mode"),
            (dict(on_lane_failure="ignore"), ValueError, "on_lane_failure"),
            (dict(num_streams=2, backend="gpus"), ValueError, "backend"),
            (dict(num_streams=2, backend="vmap", on_lane_failure="replay"),
             ValueError, "threads"),
            (dict(num_streams=2, backend="shard_map"), ValueError, "world size 1"),
            (dict(num_streams=2, backend="vmap", straggler=object()), ValueError,
             "threads"),
            (dict(num_streams=2, backend="vmap", carry_store=object()),
             ValueError, "threads")]:
        with pytest.raises(err, match=match):
            run_parallel(stream, pc, **kw)
    with pytest.raises(ValueError, match="num_streams"):
        ParallelEdgeStream(stream, 0)
    # carry_store checkpoints every merge base; a replay restores from disk
    from repro_torch.incremental import CarryStore

    store = CarryStore(tmp_path / "bases", keep=0)
    _, want = run_parallel(stream, pc, num_streams=2, super_chunk=2)
    _, got = run_parallel(stream, pc, num_streams=2, super_chunk=2,
                          carry_store=store, on_lane_failure="replay")
    assert torch.equal(got, want)
    assert store.steps() and store.steps()[-1] == int((src.size))


# -------------------------------------------------------- the masked game

def _masked_case(graph, k, use_cms, w_scale=1, size_scale=1):
    from test_torch_game import _game_inputs, _graph, _hub_inputs

    if w_scale > 1 or size_scale > 1:
        return _hub_inputs(w_scale, size_scale)
    return _game_inputs(_graph(graph), k, use_cms, False)


@pytest.mark.parametrize("mask", ["half", "tail", "sparse", "leaders", "none"])
@pytest.mark.parametrize("case", [("community", 8, True, 1, 1), ("0", 4, False, 1, 1),
                                  ("hub", 8, True, 100_003, 1),
                                  ("hub", 8, True, 1, 45_001)])
def test_masked_game_equals_the_reference(case, mask):
    """Leader and move masks, windows not offset at n_head, the role mask
    inside a window and the window-keyed draws; the scaled inputs whose hub
    W and partition sizes pass the float32 limits included."""
    inputs, C = _masked_case(*case)
    rng = np.random.default_rng(len(mask))
    move = {"half": rng.random(C) < 0.5, "tail": np.arange(C) >= C // 3,
            "sparse": rng.random(C) < 0.05, "leaders": np.arange(C) < inputs.n_head,
            "none": np.zeros(C, bool)}[mask]
    lead = rng.random(C) < 0.3 if mask == "half" else np.arange(C) < inputs.n_head
    assign0 = jgame.init_assignment(np.asarray(inputs.sizes), inputs.k)
    kw = dict(batch_size=jgame.default_batch_size(64, C), max_rounds=16,
              accept_prob=0.9, seed=5)
    ref = jgame.run_game(inputs, C, assign0=assign0, leader_mask=lead, move_mask=move, **kw)
    port = tgame.run_game(interop.game_inputs(inputs, device="cpu"), C, assign0=assign0,
                          leader_mask=lead, move_mask=move, **kw)
    np.testing.assert_array_equal(np.asarray(ref.assignment), port.assignment.numpy())
    assert (int(ref.rounds), bool(ref.converged)) == (port.rounds, port.converged)
    frozen = ~move
    np.testing.assert_array_equal(port.assignment.numpy()[frozen], assign0[frozen])
    if mask == "half":  # every window holds movable clusters of both roles
        assert (port.hub_batches > 0) == (case[3] > 1)
        assert port.size_guard == (case[4] > 1)


def test_masked_game_defaults_and_refusals():
    inputs, C = _masked_case("community", 8, True)
    kw = dict(batch_size=32, max_rounds=8, accept_prob=0.9, seed=1)
    ti = interop.game_inputs(inputs, device="cpu")
    ref = jgame.run_game(inputs, C, move_mask=np.ones(C, bool), **kw)
    port = tgame.run_game(ti, C, move_mask=np.ones(C, bool), **kw)
    np.testing.assert_array_equal(np.asarray(ref.assignment), port.assignment.numpy())
    ref = jgame.run_game(inputs, C, leader_mask=np.arange(C) < 5, **kw)
    port = tgame.run_game(ti, C, leader_mask=np.arange(C) < 5, **kw)
    np.testing.assert_array_equal(np.asarray(ref.assignment), port.assignment.numpy())
    # the migration cost alone plays the masked game (leader prefix, all
    # movable, home = assign0); home alone is ignored, as in the reference
    for kw2 in ({"move_cost": np.full(C, 0.5, np.float32)}, {"home": np.zeros(C, np.int32)}):
        ref = jgame.run_game(inputs, C, **kw, **kw2)
        port = tgame.run_game(ti, C, **kw, **kw2)
        np.testing.assert_array_equal(np.asarray(ref.assignment), port.assignment.numpy())
        assert int(ref.rounds) == port.rounds


# ------------------------------------------------------ S5P with touch-up

def _s5p_pair(src, dst, n, **kw):
    ref = jax_s5p(src, dst, n, JConfig(**kw))
    out = s5p_partition(src, dst, n, S5PConfig(**kw), device="cpu")
    np.testing.assert_array_equal(np.asarray(ref.parts), out.parts.numpy())
    np.testing.assert_array_equal(np.asarray(ref.cluster_assignment), out.cluster_assignment)
    assert (ref.n_clusters, ref.n_head_clusters, int(ref.game_rounds)) == (
        out.n_clusters, out.n_head_clusters, out.game_rounds)
    return ref, out


@pytest.mark.parametrize("kw", [
    dict(num_streams=4, shard="hub", super_chunk="auto", chunk_size=128),
    dict(num_streams=4, shard="range", super_chunk="auto", chunk_size=128),
    dict(num_streams=4, shard="rr", super_chunk=2, chunk_size=128, use_cms=False),
    dict(num_streams=3, shard="hub", super_chunk=1, chunk_size=64, one_stage=True)])
def test_s5p_parallel_with_touch_up_equals_the_reference(kw):
    src, dst, n = community_graph(600, 8, 6, seed=3)
    ref, out = _s5p_pair(src, dst, n, k=8, **kw)
    want = {f: ref.aux["touch_up"][f] for f in ("contested_clusters", "moved_clusters",
                                                "replayed_edges", "rounds")}
    got = {f: out.aux["touch_up"][f] for f in want}
    assert want == got
    assert ref.aux["parallel_ingest"]["schedule"] == out.aux["parallel_ingest"]["schedule"]
    assert [lane["edges"] for lane in ref.aux["parallel_ingest"]["lanes"]] == [
        lane["edges"] for lane in out.aux["parallel_ingest"]["lanes"]]
    load = out.aux["incremental"]["load"]
    assert torch.equal(load, torch.bincount(out.parts[out.parts >= 0].long(),
                                            minlength=8).to(load.dtype))
    # lanes place against loads as of the last merge, so the capacity can
    # be passed by what the lanes placed since; the reference's load too
    np.testing.assert_array_equal(np.asarray(ref.aux["incremental"]["load"]), load.numpy())
    assert "touch_up" in out.timings


def test_s5p_touch_up_moves_clusters_as_the_reference():
    """A case where the touch-up's game moves clusters and edges are
    placed again (the replay path)."""
    src, dst, n = community_graph(600, 8, 6, seed=3)
    ref, out = _s5p_pair(src, dst, n, k=8, num_streams=4, shard="range",
                         super_chunk=1, chunk_size=64, game_max_rounds=2)
    assert out.aux["touch_up"]["moved_clusters"] > 0
    assert out.aux["touch_up"]["replayed_edges"] > 0
    assert ref.aux["touch_up"]["replayed_edges"] == out.aux["touch_up"]["replayed_edges"]


def test_s5p_touch_up_off_and_refine_rounds():
    src, dst, n = community_graph(600, 8, 6, seed=3)
    for kw in (dict(touch_up=False), dict(refine_rounds=0), dict(refine_rounds=3)):
        ref, out = _s5p_pair(src, dst, n, k=8, num_streams=2, chunk_size=256,
                             shard="hub", super_chunk="auto", **kw)
        assert ("touch_up" in ref.aux) == ("touch_up" in out.aux)


def test_s5p_block_rmat_hub_auto_and_rf_gate():
    """S = 4 hub/auto with the touch-up on the hub-heavy block R-MAT equals
    the reference; S = 8 stays within 1.05× the sequential RF, the gate of
    ``benchmarks/parallel_ingest.py``."""
    src, dst, n = block_rmat_graph(block_scale=8, n_blocks=32, edge_factor=16, seed=1)
    _s5p_pair(src, dst, n, k=8, chunk_size=2048, num_streams=4, shard="hub",
              super_chunk="auto")
    s, d = torch.from_numpy(src), torch.from_numpy(dst)
    rf = {}
    for S in (1, 8):
        out = s5p_partition(src, dst, n, S5PConfig(k=8, chunk_size=2048, num_streams=S,
                                                   shard="hub", super_chunk="auto"),
                            device="cpu")
        rf[S] = tmetrics.replication_factor(s, d, out.parts, n_vertices=n, k=8)
    assert rf[8] <= 1.05 * rf[1], rf


def test_theta_table_under_lanes_equals_sequential():
    """cluster_statistics at S = 4: the Θ sketch is the sequential table."""
    from repro_torch.core.s5p import cluster_statistics

    src, dst, n = community_graph(600, 8, 6, seed=3)
    s, d = torch.from_numpy(src), torch.from_numpy(dst)
    deg = tcl.compute_degrees(s, d, n)
    xi = int(2 * len(src) / n)
    st = tcl.cluster_stream(src, dst, n, xi=xi, kappa=400, device="cpu")
    res = tcl.compact_clusters(st, deg, xi)
    kw = dict(use_cms=True, cms_epsilon=0.1, cms_nu=0.01, seed=0, chunk_size=256)
    a = cluster_statistics(s, d, res, deg, xi, **kw)
    for S, sc in ((4, "auto"), (3, 1)):
        b = cluster_statistics(s, d, res, deg, xi, num_streams=S, super_chunk=sc, **kw)
        assert torch.equal(a[4]["sketch"].table, b[4]["sketch"].table)
        assert torch.equal(a[3], b[3])


# -------------------------------------------- batched engines and the CLI

@pytest.mark.parametrize("chunk", [16, 64])
def test_batched_engines_equal_the_reference(chunk):
    src, dst, n, _ = random_graph(1)
    want = np.asarray(j_hdrf_batched(src, dst, n, [2, 4, 3], [1.1, 1.0, 2.0],
                                     chunk_size=chunk))
    got = tb.hdrf_partition_batched(src, dst, n, [2, 4, 3], [1.1, 1.0, 2.0],
                                    chunk_size=chunk, device="cpu")
    np.testing.assert_array_equal(want, got.numpy())
    for i, (k, lam) in enumerate(zip([2, 4, 3], [1.1, 1.0, 2.0])):
        if k == 4:
            np.testing.assert_array_equal(got[i].numpy(), tb.hdrf_partition(
                src, dst, n, k, lam=lam, chunk_size=chunk, device="cpu").numpy())
    want = np.asarray(j_grid_multi(src, dst, n, 6, [0, 3, 7], chunk_size=chunk))
    got = tb.grid_partition_multi_seed(src, dst, n, 6, [0, 3, 7], chunk_size=chunk,
                                       device="cpu")
    np.testing.assert_array_equal(want, got.numpy())
    with pytest.raises(ValueError, match="at least one"):
        tb.hdrf_partition_batched(src, dst, n, [], device="cpu")
    with pytest.raises(ValueError, match="mismatch"):
        tb.hdrf_partition_batched(src, dst, n, [2], [1.0, 2.0], device="cpu")


@pytest.mark.parametrize("name", ["grid", "greedy", "hdrf", "s5p", "s5p-exact"])
@pytest.mark.parametrize("shard", ["rr", "hub"])
def test_baselines_parallel_options_equal_the_reference(name, shard):
    from repro.core import baselines as jb

    src, dst, n, _ = random_graph(1)
    kw = dict(chunk_size=13, num_streams=3, super_chunk="auto", shard=shard)
    want = np.asarray(jb.PARTITIONERS[name](src, dst, n, K, 0, **kw))
    got = tb.PARTITIONERS[name](src, dst, n, K, 0, device="cpu", **kw)
    np.testing.assert_array_equal(want, got.numpy())


def test_cli_parallel_flags_run_and_validate(capsys):
    from repro.launch import partition as jcli
    from repro_torch.launch import partition as tcli

    kw = dict(chunk_size=512, num_streams=4, super_chunk="auto", shard="hub")
    got = tcli.run("community:1000", 4, compare=True, device="cpu", **kw)
    want = jcli.run("community:1000", 4, "s5p", 0, True, **kw)
    assert [r[:4] for r in got] == [tuple(r[:4]) for r in want]
    assert "touch_up=" in capsys.readouterr().out
    for bad in (dict(num_streams=100), dict(num_streams=4, super_chunk=100),
                dict(super_chunk="fast"), dict(shard="diag"), dict(num_streams=0)):
        with pytest.raises(ValueError):
            tcli.run("community:1000", 4, chunk_size=512, device="cpu", **bad)
    assert tcli._super_chunk_arg("auto") == "auto" and tcli._super_chunk_arg("3") == 3
    for bad in ("0", "x"):
        with pytest.raises(Exception, match="auto"):
            tcli._super_chunk_arg(bad)
    with pytest.raises(SystemExit):
        tcli.main(["--shard-mode", "diag", "--device", "cpu"])


@pytest.mark.parametrize("xi", [1 << 20, 3])
def test_merged_cluster_ids_past_the_tables_equal_the_reference(xi):
    """Lanes merged every chunk sum their id counters past V + 1: the plain
    fold reads the last volume slot and drops the writes for those ids, as
    the reference's gathers and scatters do (K1 does the same on the card)."""
    from repro.core.clustering import cluster_stream as j_cluster_stream
    from repro.graphs.generators import rmat_graph

    src, dst, n = rmat_graph(10, edge_factor=8, seed=4)
    kw = dict(xi=xi, kappa=1 << 20, chunk_size=256, num_streams=8, super_chunk=1)
    want = j_cluster_stream(src, dst, n, **kw)
    got = tcl.cluster_stream(src, dst, n, device="cpu", **kw)
    assert int(got.next_t) + int(got.next_h) > n + 1
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_launch_counters_keep_every_count_under_threads():
    """Lanes launch from threads: the counters' read-modify-write is locked,
    so no increment is lost under a short switch interval."""
    import sys
    import threading

    from repro_torch.kernels.cms_sketch import kernel as k4
    from repro_torch.kernels.stream_scan import kernel as k1

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for mod, name in ((k1, "cluster_scan"), (k4, "cms_update")):
            mod.reset_launch_counts()
            workers = [threading.Thread(target=lambda: [mod._count(name) for _ in range(5000)])
                       for _ in range(16)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=60)
            assert not any(w.is_alive() for w in workers)
            assert mod.launch_counts()[name] == 16 * 5000
            mod.reset_launch_counts()
    finally:
        sys.setswitchinterval(prev)
