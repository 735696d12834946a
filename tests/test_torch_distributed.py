"""Port parity: multi-device S5P over ``torch.distributed`` (gloo ranks on the
CPU, spawned once per world size), bit for bit against the live reference.

The reference's multi-device paths run in one subprocess with four forced
host devices (``--xla_force_host_platform_device_count=4``), its meshes
built with ``AxisType.Auto`` axes: under this tree's JAX,
``jax.make_mesh``'s default ``Explicit`` axes make ``distributed_partition``
raise for S ≥ 2 (ROADMAP Queue 3 n).  The port's ranks run the functions
of ``tests/torch_dist_ranks.py``, which imports ``repro_torch`` only.

Held: ``distributed_partition`` at S ∈ {1, 2, 4} (CMS Θ) and S = 4 (exact
Θ), parts and every ``info`` field, and the reference's quality band;
``run_parallel``'s ``shard_map`` backend at S = 2 for seven consumers and
``s5p_partition(num_streams=2)`` against the reference's ``shard_map`` and
the port's ``threads`` and ``vmap``; ``merge_collective`` against
``merge`` (and the reference's ``merge``) on every carry class, a CMS
table with its top bit set included; ``reshard_state`` and
``ElasticController`` onto meshes of ranks."""

import os
import pickle
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dist_ranks as R

from repro.graphs.generators import community_graph
from repro_torch import _dist
from repro_torch.core import metrics as tmetrics
from repro_torch.core.s5p import S5PConfig, s5p_partition
from repro_torch.streaming import EdgeStream, run_parallel

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
K = 4
CHUNK, S5P_CHUNK = 32, 64
NAMES = ["hdrf", "greedy", "grid", "cluster", "sketch", "assign", "degree"]
PARTITION_CASES = [(1, True), (2, True), (4, True), (4, False)]
TOP_BIT = 0x80000005


def _graph():
    src, dst, n = community_graph(300, n_communities=8, avg_degree=6, seed=1)
    return np.asarray(src, np.int32), np.asarray(dst, np.int32), int(n)


def _extras(E):
    rng = np.random.default_rng(0)
    return (rng.integers(0, 2, E).astype(bool), rng.integers(0, 8, E).astype(np.int32),
            rng.integers(0, 8, E).astype(np.int32))


def _lanes(n):
    """Two lanes of two random 17-edge chunks each (with Alg. 3's extras)."""
    rng = np.random.default_rng(1)
    return [[(rng.integers(0, n, 17).astype(np.int32), rng.integers(0, n, 17).astype(np.int32),
              [rng.integers(0, 2, 17).astype(bool), rng.integers(0, 8, 17).astype(np.int32),
               rng.integers(0, 8, 17).astype(np.int32)]) for _ in range(2)] for _ in range(2)]


REFERENCE = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
jax.config.update("jax_threefry_partitionable", True)
import repro.streaming as js
from repro.core import S5PConfig, s5p_partition
from repro.core.clustering import ClusterCarry, DegreeCarry
from repro.core.cms import SketchCarry
from repro.core.distributed import distributed_partition
from repro.core.postprocess import AssignCarry
from repro.graphs.generators import community_graph
from repro.kernels.stream_scan import GreedyCarry, GridCarry, HdrfCarry

K, CHUNK, S5P_CHUNK = {K}, {CHUNK}, {S5P_CHUNK}
src, dst, n = community_graph(300, n_communities=8, avg_degree=6, seed=1)
src, dst = np.asarray(src, np.int32), np.asarray(dst, np.int32)
out = {{"partition": {{}}, "ingest": {{}}}}
for S, cms in {PARTITION_CASES}:
    mesh = jax.make_mesh((S,), ("data",), devices=jax.devices()[:S],
                         axis_types=(jax.sharding.AxisType.Auto,))
    parts, info = distributed_partition(src, dst, n, S5PConfig(k=K, use_cms=cms), mesh)
    out["partition"][(S, cms)] = (np.asarray(parts), info)
deg = jnp.full((n,), 5, jnp.int32)
c2p = jnp.arange(8, dtype=jnp.int32) % K
row = jnp.arange(n, dtype=jnp.int32) % 2
rng = np.random.default_rng(0)
E = len(src)
extras = (rng.integers(0, 2, E).astype(bool), rng.integers(0, 8, E).astype(np.int32),
          rng.integers(0, 8, E).astype(np.int32))
made = {{"hdrf": lambda: HdrfCarry(n, K, 1.1), "greedy": lambda: GreedyCarry(n, K),
        "grid": lambda: GridCarry(K, row, row, 2),
        "cluster": lambda: ClusterCarry(deg, n, xi=3, kappa=40),
        "sketch": lambda: SketchCarry(64, 4, seed=3), "assign": lambda: AssignCarry(K, 60, c2p),
        "degree": lambda: DegreeCarry(n)}}
def bits(x):
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.uint32 else a
for name, make in made.items():
    ex = tuple(jnp.asarray(e) for e in extras) if name == "assign" else ()
    parts, carry = js.run_parallel(js.EdgeStream(src, dst, n, chunk_size=CHUNK), make(), *ex,
                                   num_streams=2, super_chunk=2, backend="shard_map")
    out["ingest"][name] = (None if parts is None else np.asarray(parts),
                           [bits(x) for x in jax.tree_util.tree_leaves(carry)],
                           js.last_ingest_stats().backend)
res = s5p_partition(src, dst, n, S5PConfig(k=K, num_streams=2, chunk_size=S5P_CHUNK))
out["s5p"] = {{"parts": np.asarray(res.parts), "n_clusters": res.n_clusters,
              "game_rounds": res.game_rounds,
              "touch_up": {{k: v for k, v in res.aux.get("touch_up", {{}}).items() if k != "game"}},
              "backend": res.aux["parallel_ingest"]["backend"]}}
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference subprocess (started first, run beside the spawns) and
    one spawned world a size: ``{"ref": ..., 1: ranks, 2: ranks, 4: ranks}``."""
    work = tmp_path_factory.mktemp("dist")
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    code = textwrap.dedent(REFERENCE.format(K=K, CHUNK=CHUNK, S5P_CHUNK=S5P_CHUNK,
                                            PARTITION_CASES=PARTITION_CASES))
    ref_out = work / "ref.pkl"
    proc = subprocess.Popen([sys.executable, "-c", code, str(ref_out)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    src, dst, n = _graph()
    state = {"w": np.arange(24, dtype=np.float32).reshape(6, 4) - 7.5,
             "table": np.array([-5, 2**31 - 1, -2**31], np.int32),
             "step": np.array([7], np.int64)}
    jobs = {
        1: [("partition", (src, dst, n, [(True, False)])), ("collectives", ())],
        2: [("partition", (src, dst, n, [(True, True)])),
            ("ingest", (src, dst, n, NAMES, _extras(len(src)), CHUNK, S5P_CHUNK)),
            ("merges", (n, _lanes(n), TOP_BIT)),
            ("placement", (state, str(work / "placement"))),
            ("wrong_mesh", (src, dst, n)), ("collectives", ())],
        4: [("partition", (src, dst, n, [(True, False), (False, True)])),
            ("collectives", ())],
    }
    out = {}
    try:
        for world, job in jobs.items():
            out[world] = _dist.spawn_world(R.run_all, world, (job,),
                                           work_dir=work / f"world{world}", device="cpu")
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    with open(ref_out, "rb") as f:
        out["ref"] = pickle.load(f)
    out["state"] = state
    return out


def _ranks_agree(ranks, pick):
    first = pick(ranks[0])
    for r in ranks[1:]:
        np.testing.assert_array_equal(pick(r), first)


# ------------------------------------------------------ distributed_partition

def _partition(runs, S, cms):
    cases = {1: [True], 2: [True], 4: [True, False]}[S]
    i = cases.index(cms)
    return [r["partition"][i] for r in runs[S]]


@pytest.mark.parametrize("S,cms", PARTITION_CASES, ids=["S1-cms", "S2-cms", "S4-cms", "S4-exact"])
def test_distributed_partition_equals_the_reference(runs, S, cms):
    ranks = _partition(runs, S, cms)
    want_parts, want_info = runs["ref"]["partition"][(S, cms)]
    for r in ranks:
        np.testing.assert_array_equal(r["parts"], want_parts)
        assert r["info"] == want_info
        assert r["stats"]["parts_hash"] == ranks[0]["stats"]["parts_hash"]


@pytest.mark.parametrize("S", [1, 2, 4])
def test_distributed_partition_quality_band(runs, S):
    """The reference's own band: ``rf_dist ≤ 1.35·rf_single + 0.2``; every
    valid edge placed, the game converged, max load at the cap."""
    src, dst, n = _graph()
    r = _partition(runs, S, True)[0]
    parts = torch.from_numpy(r["parts"])
    s, d = torch.from_numpy(src), torch.from_numpy(dst)
    single = s5p_partition(src, dst, n, S5PConfig(k=K), device="cpu")
    rf_dist = tmetrics.replication_factor(s, d, parts, n_vertices=n, k=K)
    rf_single = tmetrics.replication_factor(s, d, single.parts, n_vertices=n, k=K)
    assert rf_dist <= rf_single * 1.35 + 0.2
    valid = src != dst
    assert (r["parts"][valid] >= 0).all() and (r["parts"][~valid] == -1).all()
    assert r["info"]["converged"]
    assert np.bincount(r["parts"][valid], minlength=K).max() <= r["stats"]["max_load"]


@pytest.mark.parametrize("S", [1, 2, 4])
def test_distributed_partition_reports_its_phases(runs, S):
    r = _partition(runs, S, True)
    phases = ["clustering", "global_ids", "statistics", "game", "postprocess"]
    for rank in r:
        st = rank["stats"]
        assert list(st["seconds"]) == phases and list(st["collective_bytes"]) == phases
        assert st["place_chunk"] == max(65536 // S, 1024) and st["shard_edges"] == -(-307 // S)
        assert sum(st["collective_bytes"].values()) == sum(rank["bytes"].values())
        assert st["collective_bytes"]["postprocess"] > 0  # the parts' gather
        # Phase 4 hands the load vector on only between ranks
        assert (rank["bytes"]["send_recv"] > 0) == (S > 1)


# ----------------------------------------------------- run_parallel shard_map

@pytest.mark.parametrize("name", NAMES)
def test_shard_map_equals_the_reference(runs, name):
    want_parts, want_carry, backend = runs["ref"]["ingest"][name]
    assert backend == "shard_map"
    for rank in runs[2]:
        got = rank["ingest"][name]
        assert got["backend"] == "shard_map"
        if want_parts is None:
            assert got["parts"] is None
        else:
            np.testing.assert_array_equal(got["parts"], want_parts)
        assert len(got["carry"]) == len(want_carry)
        for a, b in zip(got["carry"], want_carry):
            np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("backend", ["threads", "vmap"])
@pytest.mark.parametrize("name", NAMES)
def test_shard_map_equals_threads_and_vmap(runs, name, backend):
    src, dst, n = _graph()
    made = R.carries(n, np.full((n,), 5, np.int32), np.arange(8, dtype=np.int32) % K,
                     np.arange(n, dtype=np.int32) % 2)
    ex = tuple(torch.from_numpy(e) for e in _extras(len(src))) if name == "assign" else ()
    parts, carry = run_parallel(EdgeStream(src, dst, n, chunk_size=CHUNK, device="cpu"),
                                made[name](), *ex, num_streams=2, super_chunk=2,
                                backend=backend)
    got = runs[2][0]["ingest"][name]
    if parts is None:
        assert got["parts"] is None
    else:
        np.testing.assert_array_equal(got["parts"], parts.numpy())
    for a, b in zip(got["carry"], R._np(carry)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_s5p_two_streams_equals_the_reference(runs):
    want = runs["ref"]["s5p"]
    assert want["backend"] == "shard_map"
    for rank in runs[2]:
        got = rank["ingest"]["s5p"]
        np.testing.assert_array_equal(got["parts"], want["parts"])
        for key in ("n_clusters", "game_rounds", "touch_up", "backend"):
            assert got[key] == want[key], key


def test_shard_map_over_a_mesh_and_every_rank_agree(runs):
    _ranks_agree(runs[2], lambda r: r["ingest"]["hdrf_mesh"]["parts"])
    for rank in runs[2]:
        np.testing.assert_array_equal(rank["ingest"]["hdrf_mesh"]["parts"],
                                      rank["ingest"]["hdrf"]["parts"])
        for name in NAMES:
            if rank["ingest"][name]["parts"] is not None:
                np.testing.assert_array_equal(rank["ingest"][name]["parts"],
                                              runs[2][0]["ingest"][name]["parts"])


def test_shard_map_needs_a_mesh_as_wide_as_the_lanes(runs):
    for rank in runs[2]:
        assert "needs a 2-wide mesh axis" in rank["wrong_mesh"]


def test_shard_map_without_a_process_group_names_the_world_size():
    src, dst, n = _graph()
    from repro_torch.kernels.stream_scan import GreedyCarry

    with pytest.raises(ValueError, match="process group of 2 ranks, got world size 1"):
        run_parallel(EdgeStream(src, dst, n, chunk_size=CHUNK, device="cpu"),
                     GreedyCarry(n, K, device="cpu"), num_streams=2, backend="shard_map")
    with pytest.raises(ValueError, match="no process group is up"):
        _dist.world_size()


@pytest.mark.parametrize("env,cards,want", [
    ({"WORLD": 8, "RANK": 5, "LOCAL_WORLD_SIZE": "4", "LOCAL_RANK": "1"}, 4, ("nccl", 1)),
    ({"WORLD": 4, "RANK": 3}, 4, ("nccl", 3)),
    ({"WORLD": 4, "RANK": 3}, 1, ("gloo", 0)),
    ({"WORLD": 8, "RANK": 6, "LOCAL_WORLD_SIZE": "4", "LOCAL_RANK": "2"}, 2, ("gloo", 0)),
], ids=["two-hosts", "one-host", "shared-card", "shared-cards-two-hosts"])
def test_init_world_picks_the_backend_from_the_hosts_ranks(monkeypatch, env, cards, want):
    """NCCL when each of the host's ranks has a card of its own, on its
    local rank's card, the card ``rank_device`` names; gloo on card 0 when
    the host's ranks share its cards.  The group itself is not brought up."""
    for key in ("LOCAL_WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
        if key in env:
            monkeypatch.setenv(key, env[key])
    got = {}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: got.setdefault("current", d))
    monkeypatch.setattr(_dist, "resolve_device", lambda d: torch.device("cuda"))
    monkeypatch.setattr(_dist.dist, "init_process_group",
                        lambda backend, **kw: got.update(backend=backend, **kw))
    dev = _dist.init_world(env["RANK"], env["WORLD"], "file:///nowhere")
    assert (got["backend"], dev.index) == want and got["current"] == dev
    assert (got["rank"], got["world_size"]) == (env["RANK"], env["WORLD"])
    if want[0] == "nccl":
        monkeypatch.setattr(_dist.dist, "get_rank", lambda: env["RANK"])
        monkeypatch.setattr(_dist, "is_up", lambda: True)
        assert _dist.rank_device() == dev


# ------------------------------------------------------------ merge_collective

MERGE_NAMES = NAMES + ["degree_sketch"]


@pytest.mark.parametrize("name", MERGE_NAMES)
def test_merge_collective_equals_merge(runs, name):
    for rank in runs[2]:
        got = rank["merges"][name]
        assert len(got["collective"]) == len(got["merge"])
        for a, b in zip(got["collective"], got["merge"]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert any(not np.array_equal(np.asarray(a), np.asarray(b))
                   for a, b in zip(got["lanes"][0], got["lanes"][1]))


@pytest.mark.parametrize("name", ["sketch", "degree_sketch"])
def test_merge_collective_of_top_bit_tables_equals_the_reference_merge(runs, name):
    """The table as the reference holds it (``uint32``, top bit set in
    every cell of the base) merged by the reference equals the ranks'
    collective merge of the port's int32 bit patterns."""
    from repro.core.cms import CMSketch as JSketch
    from repro.core.cms import SketchCarry as JSketchCarry

    got = runs[2][0]["merges"][name]
    base_table = got["base"][0]
    assert (base_table.view(np.uint32) >= 2**31).all()

    def j(leaves):
        return JSketch(table=jnp.asarray(leaves[0].view(np.uint32)),
                       seeds=jnp.asarray(leaves[1]))

    want = JSketchCarry(64, 4, seed=3).merge([j(c) for c in got["lanes"]], base=j(got["base"]))
    np.testing.assert_array_equal(np.asarray(want.table).view(np.int32), got["collective"][0])


# ------------------------------------------------------ placement onto meshes

def test_reshard_state_onto_a_mesh_of_ranks(runs):
    state = runs["state"]
    for rank in runs[2]:
        p = rank["placement"]
        assert p["mesh_shape"] == (1, 2) and p["mesh_names"] == ("data", "model")
        assert p["local_rows"] == 3  # Shard(0) of 6 rows over 2 ranks
        for key, v in state.items():
            assert p["full"][key].dtype == v.dtype
            np.testing.assert_array_equal(p["full"][key], v)


def test_elastic_controller_resizes_onto_fewer_ranks(runs):
    """2 ranks → 1: the rank inside the new mesh holds the checkpoint bit
    for bit, the rank outside empty local tensors."""
    state = runs["state"]
    inside, outside = (r["placement"] for r in runs[2])
    assert inside["inside"] and not outside["inside"]
    for p in (inside, outside):
        assert p["dtensor"] and p["step"] == 3
    for key, v in state.items():
        np.testing.assert_array_equal(inside["resized"][key], v)
        assert outside["resized"][key].size == 0


# ----------------------------------------------------------------- helpers

def _w32(x):
    """int64 values wrapped to int32, as two's complement."""
    return ((np.asarray(x, np.int64) + 2**31) % 2**32 - 2**31).astype(np.int32)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_collective_helpers(runs, world):
    for rank, got in enumerate(r["collectives"] for r in runs[world]):
        w = world
        u32 = np.array([0xFFFFFFF0, 3], np.int64)
        np.testing.assert_array_equal(got["u32_sum"], (u32 * w) % 2**32)
        np.testing.assert_array_equal(got["u32_max"], u32)
        i32 = [_w32(np.array([2**31 - 1, -5], np.int64) * r) for r in range(1, w + 1)]
        np.testing.assert_array_equal(got["i32_sum"], _w32(np.sum(i32, axis=0)))
        np.testing.assert_array_equal(got["i32_min"], np.min(i32, axis=0))
        np.testing.assert_array_equal(got["bool_max"], [True, False])
        np.testing.assert_array_equal(got["f64_sum"], [0.25 * w * (w + 1)] * 2)
        assert [g.shape for g in got["gathered"]] == [(r, 3) for r in range(w)]
        for r, g in enumerate(got["gathered"]):
            np.testing.assert_array_equal(g.reshape(-1), np.arange(r * 3))
        assert got["ring"] == (w - 1 if rank == 0 else rank)
        assert got["bytes"]["all_reduce"] > 0 and got["bytes"]["all_gather"] > 0
        assert (got["bytes"]["send_recv"] > 0) == (w > 1)


# ------------------------------------------------------------------ the CLI

def test_partition_cli_under_torchrun_equals_one_process():
    """``torchrun`` with 2 ranks and ``--num-streams 2``: one lane a rank
    (gloo on the CPU), rank 0 alone prints, and its rows equal the
    single-process run's (the threads backend) but for the seconds."""
    args = ["-m", "repro_torch.launch.partition", "--graph", "community:600", "--k", "4",
            "--num-streams", "2", "--chunk-size", "256", "--super-chunk", "2",
            "--device", "cpu"]
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    ranks = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                            "--nproc-per-node", "2", *args], capture_output=True, text=True,
                           env=env, timeout=300)
    assert ranks.returncode == 0, ranks.stderr[-3000:]
    one = subprocess.run([sys.executable, *args], capture_output=True, text=True, env=env,
                         timeout=300)
    assert one.returncode == 0, one.stderr[-3000:]

    def rows(out):
        return [line.rsplit(" ", 1)[0] if "RF=" in line else line.split("seconds:")[0]
                for line in out.splitlines() if line.strip()]

    assert ranks.stdout.count("graph=community:600") == 1
    assert rows(ranks.stdout) == rows(one.stdout)
