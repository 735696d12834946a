"""Port parity: out-of-core ingest (``repro_torch.streaming.oocstream``) and
the CLI's ``file:`` graphs, against the live reference on the same numpy
inputs, at tolerance 0.

Mirrors the reference's ``tests/test_oocstream.py``: chunks paged from disk
shards equal the in-memory stream's and the reference's in every ordering,
chunk size and shard size; each package reads the other's shard
directories, whose files are byte-identical; appends equal one write; the
host budget stays O(shard + chunk + window); Greedy, HDRF, grid, Alg. 1 and
S5P from disk equal the reference's from-disk runs (live runs, not the
pinned goldens: ROADMAP Queue 3 b); hub plans page through ``_edges_at``.
Reference calls that draw threefry bits run with
``jax_threefry_partitionable`` set."""

import filecmp
import gc
import os
import tracemalloc

import jax
import numpy as np
import pytest
import torch
from proptest import random_graph

import repro.streaming as js
from repro.core import S5PConfig as JConfig
from repro.core import s5p_partition as jax_s5p
from repro.core.baselines import greedy_partition as j_greedy
from repro.core.baselines import grid_partition as j_grid
from repro.core.baselines import hdrf_partition as j_hdrf
from repro.core.clustering import cluster_stream as j_cluster_stream
from repro.graphs.generators import community_graph, powerlaw_graph
from repro.launch import partition as jcli
from repro_torch.core import baselines as tb
from repro_torch.core import clustering as tcl
from repro_torch.core.s5p import S5PConfig, s5p_partition
from repro_torch.launch import partition as tcli
from repro_torch.streaming import (BudgetExceededError, EdgeStream, FnCarry, HostBudget,
                                   ParallelEdgeStream, ShardedEdgeStream, append_shards,
                                   read_manifest, run_carry, write_shards)

ORDERINGS = ("natural", "shuffled", "dst-sorted", "windowed")
CHUNK_SIZES = (1, 7, 1 << 16)
SHARD_EDGES = (13, 1 << 16)


@pytest.fixture(autouse=True)
def _threefry_partitionable():
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", prev)


def _sharded(man, **kw):
    return ShardedEdgeStream(man, device="cpu", **kw)


def _same_dirs(a, b):
    """Both directories hold the same file names with the same bytes."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


@pytest.fixture(scope="module")
def parity_setup(tmp_path_factory):
    """One graph, sharded at both sizes by the port's writer."""
    src, dst, n, _ = random_graph(1)
    manifests = {se: write_shards(tmp_path_factory.mktemp(f"shards-{se}"), src, dst,
                                  shard_edges=se, n_vertices=n) for se in SHARD_EDGES}
    return src, dst, n, manifests


# ---------------------------------------------------------------- chunks

@pytest.mark.parametrize("shard_edges", SHARD_EDGES)
@pytest.mark.parametrize("chunk_size", CHUNK_SIZES)
@pytest.mark.parametrize("ordering", ORDERINGS)
def test_sharded_chunks_equal_memory_and_reference(parity_setup, ordering, chunk_size,
                                                   shard_edges):
    src, dst, n, manifests = parity_setup
    man = manifests[shard_edges]
    tag = np.arange(len(src), dtype=np.int32)
    kw = dict(chunk_size=chunk_size, ordering=ordering, seed=5, window=16)
    mem = EdgeStream(src, dst, n, device="cpu", **kw)
    with _sharded(man, **kw) as got, js.ShardedEdgeStream(man, **kw) as ref:
        assert (got.n_edges, got.n_vertices, got.n_chunks) == (
            mem.n_edges, mem.n_vertices, mem.n_chunks)
        for i in range(mem.n_chunks):
            a, b, c = mem.chunk_at(i, tag), got.chunk_at(i, tag), ref.chunk_at(i, tag)
            assert a.start == b.start == c.start and a.n_valid == b.n_valid == c.n_valid
            assert b.src.dtype == torch.int32
            for x, y, z in ((a.src, b.src, c.src), (a.dst, b.dst, c.dst),
                            (a.extras[0], b.extras[0], c.extras[0])):
                assert torch.equal(x, y)
                np.testing.assert_array_equal(y.numpy(), np.asarray(z))
        unpadded = torch.cat([c.src for c in got.chunks(pad=False)])
        assert torch.equal(unpadded, torch.cat([c.src for c in mem.chunks(pad=False)]))
        vals = torch.arange(len(src), dtype=torch.float32)
        back = got.scatter_back(vals)
        assert torch.equal(back, mem.scatter_back(vals))
        np.testing.assert_array_equal(back.numpy(), np.asarray(ref.scatter_back(vals.numpy())))


def test_stored_extra_fields_page_through_chunks(tmp_path):
    """A field written into the shards rides through ``chunks()`` as the
    in-memory stream's host array does."""
    src, dst, n, _ = random_graph(0)
    w = np.random.default_rng(7).random(len(src)).astype(np.float32)
    xy = np.random.default_rng(8).integers(0, 9, (len(src), 2)).astype(np.int16)
    man = write_shards(tmp_path, src, dst, w, xy, shard_edges=19, n_vertices=n,
                       field_names=["w", "xy"])
    mem = EdgeStream(src, dst, n, chunk_size=23, ordering="dst-sorted", device="cpu")
    with _sharded(man, chunk_size=23, ordering="dst-sorted") as got:
        assert got.field_names == ("src", "dst", "w", "xy")
        vw, vxy = got.open_field("w"), got.open_field("xy")
        assert vw.shape == (len(src),) and vxy.shape == (len(src), 2) and len(vw) == len(src)
        for a, b in zip(mem.chunks(w, xy), got.chunks(vw, vxy)):
            assert torch.equal(a.extras[0], b.extras[0])
            assert torch.equal(a.extras[1], b.extras[1])
        np.testing.assert_array_equal(vw[3:40], w[3:40])
        with pytest.raises(IndexError):
            vw[::2]


# ------------------------------------------------------------ the format

@pytest.mark.parametrize("writer", ["port", "reference"])
def test_each_package_reads_the_others_shards(tmp_path, writer):
    """Either writer's directory reads back in both packages, and the two
    writers' files are byte for byte the same."""
    src, dst, n, _ = random_graph(2)
    w = np.arange(len(src), dtype=np.float32) / 3
    kw = dict(shard_edges=40, n_vertices=n + 3, field_names=["w"])
    port_man = write_shards(tmp_path / "port", src, dst, w, **kw)
    ref_man = js.write_shards(tmp_path / "ref", src, dst, w, **kw)
    _same_dirs(tmp_path / "port", tmp_path / "ref")
    man = port_man if writer == "port" else ref_man
    assert read_manifest(man)[1] == js.read_manifest(man)[1]
    for ordering in ORDERINGS:
        with _sharded(man, chunk_size=64, ordering=ordering, seed=2) as got, \
                js.ShardedEdgeStream(man, chunk_size=64, ordering=ordering, seed=2) as ref:
            assert got.n_vertices == ref.n_vertices == n + 3
            for i in range(got.n_chunks):
                a, b = got.chunk_at(i, got.open_field("w")), ref.chunk_at(i, ref.open_field("w"))
                np.testing.assert_array_equal(a.src.numpy(), np.asarray(b.src))
                np.testing.assert_array_equal(a.dst.numpy(), np.asarray(b.dst))
                np.testing.assert_array_equal(a.extras[0].numpy(), np.asarray(b.extras[0]))


@pytest.mark.parametrize("cut", [0, 5, 40, 57])
def test_append_equals_one_write(tmp_path, cut):
    """``append(prefix); append(delta)`` lays down the shards of one write of
    the concatenation, in both packages, with the same bytes."""
    src, dst, n, _ = random_graph(2)
    w = np.arange(len(src), dtype=np.float32)
    one = write_shards(tmp_path / "one", src, dst, w, shard_edges=20, n_vertices=n)
    grown = write_shards(tmp_path / "grown", src[:cut], dst[:cut], w[:cut], shard_edges=20,
                         n_vertices=0)
    append_shards(grown, src[cut:], dst[cut:], w[cut:])
    ref = js.write_shards(tmp_path / "ref", src[:cut], dst[:cut], w[:cut], shard_edges=20,
                          n_vertices=0)
    js.append_shards(ref, src[cut:], dst[cut:], w[cut:])
    _same_dirs(tmp_path / "grown", tmp_path / "ref")
    _same_dirs(tmp_path / "grown", tmp_path / "one")
    with _sharded(one, chunk_size=17) as a, _sharded(grown, chunk_size=17) as b:
        for x, y in zip(a.chunks(a.open_field("x0")), b.chunks(b.open_field("x0"))):
            assert torch.equal(x.src, y.src) and torch.equal(x.extras[0], y.extras[0])


def test_manifest_and_append_validation(tmp_path):
    src, dst, n, _ = random_graph(3)
    man = write_shards(tmp_path / "g", src, dst, shard_edges=11, n_vertices=n)
    path, meta = read_manifest(man.parent)  # a directory resolves to its manifest
    assert path == man and meta["format"] == "s5p-edge-shards"
    assert meta["n_edges"] == len(src) and meta["n_vertices"] == n
    assert sum(s["n_edges"] for s in meta["shards"]) == len(src)
    for bad in (dict(shard_edges=0), dict(dst=dst[:-1]), dict(extras=(src[:-1],)),
                dict(extras=(src,), field_names=["a", "b"]),
                dict(extras=(src,), field_names=["dst"])):
        kw = {"shard_edges": 5, **bad}
        d = kw.pop("dst", dst)
        extras = kw.pop("extras", ())
        with pytest.raises(ValueError):
            write_shards(tmp_path / "bad", src, d, *extras, **kw)
    for bad in ((src, dst[:-1]), (src, dst, src), (src.astype(np.int64)[:0], dst[:1])):
        with pytest.raises(ValueError):
            append_shards(man, *bad)
    with_field = write_shards(tmp_path / "f", src, dst, src.astype(np.float32), shard_edges=7)
    with pytest.raises(ValueError, match="expects dtype"):
        append_shards(with_field, src, dst, src)
    meta["version"] = 2
    (tmp_path / "v2").mkdir()
    (tmp_path / "v2" / "manifest.json").write_text(__import__("json").dumps(meta))
    with pytest.raises(ValueError, match="version"):
        read_manifest(tmp_path / "v2")
    for kw in (dict(ordering="sideways"), dict(chunk_size=0), dict(window=0)):
        with pytest.raises(ValueError):
            _sharded(man, **kw)
    with _sharded(man) as st:
        with pytest.raises(IndexError):
            st.chunk_at(st.n_chunks)
        with pytest.raises(AttributeError):  # no host-resident edge arrays
            st.src
        s, d = st.arrival_arrays()
        np.testing.assert_array_equal(s, src)
        np.testing.assert_array_equal(d, dst)


def test_empty_graph_round_trip(tmp_path):
    empty = np.empty(0, np.int32)
    man = write_shards(tmp_path, empty, empty, shard_edges=7, n_vertices=0)
    for ordering in ORDERINGS:
        with _sharded(man, ordering=ordering, chunk_size=4) as st:
            assert st.n_edges == 0 and st.n_chunks == 1
            (ch,) = list(st.chunks())
            assert ch.n_valid == 0 and tuple(ch.src.shape) == (0,)


# ------------------------------------------------------------ the budget

def test_host_budget_observe_mode():
    hb = HostBudget()
    assert hb.limit_bytes is None
    hb.charge(100)
    hb.charge(1 << 40)  # observe mode never raises
    assert hb.current_bytes == hb.peak_bytes == 100 + (1 << 40)
    hb.release(1 << 40)
    assert hb.current_bytes == 100 and hb.peak_bytes == 100 + (1 << 40)
    with hb.scoped(50):
        assert hb.current_bytes == 150
    assert hb.current_bytes == 100


def test_host_budget_hard_cap_raises_before_any_counter_moves():
    hb = HostBudget(limit_bytes=1000)
    hb.charge(600)
    with pytest.raises(BudgetExceededError) as ei:
        hb.charge(500)
    assert (ei.value.requested, ei.value.current, ei.value.limit) == (500, 600, 1000)
    assert isinstance(ei.value, MemoryError)
    assert hb.current_bytes == hb.peak_bytes == 600
    hb.charge(400)  # up to the cap is allowed
    with pytest.raises(BudgetExceededError):
        hb.charge(1)
    hb.release(1000)
    with hb.scoped(1000):
        assert hb.current_bytes == 1000
    assert hb.current_bytes == 0
    with pytest.raises(ValueError):
        HostBudget(limit_bytes=-1)


@pytest.fixture(scope="module")
def big_sharded(tmp_path_factory):
    """~100 k edges in small shards: O(E) and O(shard) host memory part."""
    src, dst, n = powerlaw_graph(30000, avg_degree=8, seed=3)
    man = write_shards(tmp_path_factory.mktemp("big-shards"), src, dst,
                       shard_edges=4096, n_vertices=n)
    return src, dst, n, man


def _bound(se, cs, w):
    """O(shard_edges + chunk + window), the reorder passes' constants."""
    return 8 * (3 * se + 4 * cs + 8 * w) + (1 << 14)


@pytest.mark.parametrize("ordering", ORDERINGS)
def test_host_budget_bounded(big_sharded, ordering):
    """A whole pass and a ``scatter_back`` add O(shard + chunk + window):
    the order mmap is walked in blocks, no O(E) inverse is built."""
    src, _, _, man = big_sharded
    with _sharded(man, chunk_size=2048, ordering=ordering, seed=1, window=512) as st:
        assert sum(ch.n_valid for ch in st.chunks()) == len(src)
        st.scatter_back(torch.zeros(len(src), dtype=torch.int32))
        peak = st.budget.peak_bytes
    assert peak <= _bound(4096, 2048, 512), ordering
    assert peak < (8 * len(src)) // 4, ordering


@pytest.mark.parametrize("ordering", ["dst-sorted", "windowed"])
def test_parts_pass_bounded_under_reordering(big_sharded, ordering):
    """A parts-emitting pass through a reordered disk stream (run_carry's
    scatter_back included) equals the in-memory stream's and stays within
    the bound."""
    src, dst, n, man = big_sharded

    def step(carry, s, d, *extras):
        return carry + int((s != d).sum()), (s * 7 + d) % 4

    kw = dict(chunk_size=4096, ordering=ordering, seed=1, window=512)
    want, wc = run_carry(EdgeStream(src, dst, n, device="cpu", **kw), FnCarry(0, step))
    with _sharded(man, **kw) as st:
        got, gc_ = run_carry(st, FnCarry(0, step))
        peak = st.budget.peak_bytes
    assert torch.equal(want, got) and wc == gc_
    assert peak <= _bound(4096, 4096, 512) and peak < (8 * len(src)) // 4, peak


def test_no_full_edge_list_on_read_path(big_sharded):
    """tracemalloc, which does not trust the stream's own accounting: a
    whole natural pass allocates far less than the edge list."""
    src, _, _, man = big_sharded
    st = _sharded(man, chunk_size=2048)
    gc.collect()
    tracemalloc.start()
    edges = sum(ch.n_valid for ch in st.chunks())
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    st.close()
    assert edges == len(src)
    assert peak < (8 * len(src)) // 3, peak


@pytest.mark.parametrize("ordering", ORDERINGS)
@pytest.mark.parametrize("graph_seed", [0, 2, 5])
def test_stream_invariants(tmp_path, ordering, graph_seed):
    """Order is a permutation, scatter_back round-trips (B, E) payloads, the
    tail pads with (0, 0) and zero extras, windowed never emits an edge
    more than ``window`` slots early."""
    src, dst, n, _ = random_graph(graph_seed)
    E = len(src)
    man = write_shards(tmp_path, src, dst, shard_edges=13, n_vertices=n)
    with _sharded(man, ordering=ordering, chunk_size=29, seed=9, window=8) as st:
        order = np.arange(E) if st.order is None else np.asarray(st.order)
        assert sorted(order.tolist()) == list(range(E))
        payload = torch.from_numpy(np.stack([order, order * 2 + 1]))
        back = st.scatter_back(payload)
        assert torch.equal(back[0], torch.arange(E)) and torch.equal(back[1], torch.arange(E) * 2 + 1)
        total = 0
        for ch in st.chunks(np.arange(E, dtype=np.int32) + 1):
            total += ch.n_valid
            for x in (ch.src, ch.dst, ch.extras[0]):
                assert not x[ch.n_valid:].any()
            if st.n_chunks > 1:
                assert ch.src.shape[0] == 29
        assert total == E
        if ordering == "windowed":
            assert all(p >= a - 8 for p, a in enumerate(order.tolist()))


# ------------------------------------------------------ partitions from disk

@pytest.fixture(scope="module")
def disk_graph(tmp_path_factory):
    src, dst, n = community_graph(600, 8, 6, seed=3)
    man = js.write_shards(tmp_path_factory.mktemp("disk"), src, dst, shard_edges=700,
                          n_vertices=n)
    return src, dst, n, man


@pytest.mark.parametrize("ordering", ["natural", "dst-sorted"])
@pytest.mark.parametrize("name", ["greedy", "hdrf", "grid"])
def test_scans_from_disk_equal_the_reference_from_disk(disk_graph, name, ordering):
    _, _, n, man = disk_graph
    jfn = {"greedy": j_greedy, "hdrf": j_hdrf, "grid": j_grid}[name]
    tfn = tb.PARTITIONERS[name]
    kw = dict(chunk_size=512, ordering=ordering, seed=4)
    with js.ShardedEdgeStream(man, **kw) as st:
        want = np.asarray(jfn(None, None, n, 4, 1, stream=st))
    with _sharded(man, **kw) as st:
        got = tfn(None, None, n, 4, 1, stream=st)
    np.testing.assert_array_equal(want, got.numpy())


def test_clustering_from_disk_equals_the_reference_from_disk(disk_graph):
    """Alg. 1 from disk: degrees by a chunked pass (no host arrays), then
    the fold; two range lanes too."""
    _, _, n, man = disk_graph
    for lanes in ({}, dict(num_streams=2, super_chunk=2)):
        with js.ShardedEdgeStream(man, chunk_size=256) as st:
            want = j_cluster_stream(None, None, n, xi=3, kappa=50, stream=st, **lanes)
        with _sharded(man, chunk_size=256) as st:
            got = tcl.cluster_stream(None, None, n, xi=3, kappa=50, stream=st, **lanes)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("ordering", ["natural", "shuffled"])
def test_s5p_from_disk_equals_the_reference_from_disk(disk_graph, ordering):
    src, dst, n, man = disk_graph
    kw = dict(chunk_size=512, ordering=ordering, seed=0)
    with js.ShardedEdgeStream(man, **kw) as st:
        want = jax_s5p(src, dst, n, JConfig(k=4, chunk_size=512, ordering=ordering), stream=st)
    with _sharded(man, **kw) as st:
        got = s5p_partition(src, dst, n, S5PConfig(k=4, chunk_size=512, ordering=ordering),
                            stream=st)
    np.testing.assert_array_equal(np.asarray(want.parts), got.parts.numpy())
    np.testing.assert_array_equal(np.asarray(want.cluster_assignment), got.cluster_assignment)


def test_hub_plan_over_natural_shards_equals_memory(disk_graph):
    """A hub plan pages its chunks through ``_edges_at``: over natural shards
    it is the in-memory plan, and HDRF's hub lanes give the same parts;
    over reordered shards it is refused, as in the reference."""
    src, dst, n, man = disk_graph
    mem = EdgeStream(src, dst, n, chunk_size=256, device="cpu")
    a = ParallelEdgeStream(mem, 4, shard="hub")
    with _sharded(man, chunk_size=256) as st:
        b = ParallelEdgeStream(st, 4, shard="hub")
        assert a.lanes == b.lanes and a.pin_map == b.pin_map
        np.testing.assert_array_equal(a.edge_lanes(), b.edge_lanes())
        for cid in range(len(a._chunk_pos)):
            x, y = a.chunk_for(cid), b.chunk_for(cid)
            assert torch.equal(x.src, y.src) and torch.equal(x.dst, y.dst)
        kw = dict(num_streams=4, shard="hub", super_chunk="auto")
        got = tb.hdrf_partition(None, None, n, 4, stream=st, **kw)
    assert torch.equal(got, tb.hdrf_partition(None, None, n, 4, stream=mem, **kw))
    for ordering in ("shuffled", "dst-sorted", "windowed"):
        with _sharded(man, chunk_size=256, ordering=ordering) as st:
            with pytest.raises(ValueError, match="hub"):
                ParallelEdgeStream(st, 4, shard="hub")
        with js.ShardedEdgeStream(man, chunk_size=256, ordering=ordering) as st:
            with pytest.raises(ValueError, match="hub"):
                js.ParallelEdgeStream(st, 4, shard="hub")


def test_range_lanes_over_reordered_shards_equal_memory(disk_graph):
    """Range and round-robin lanes stage reordered shards by stream-order
    ranges (respilled or gathered through the order)."""
    src, dst, n, man = disk_graph
    for ordering in ("shuffled", "windowed"):
        kw = dict(chunk_size=256, ordering=ordering, seed=1)
        mem = EdgeStream(src, dst, n, device="cpu", **kw)
        with _sharded(man, **kw) as st:
            for shard in ("range", "rr"):
                lanes = dict(num_streams=3, super_chunk=2, shard=shard)
                assert torch.equal(tb.greedy_partition(None, None, n, 4, stream=st, **lanes),
                                   tb.greedy_partition(None, None, n, 4, stream=mem, **lanes))


# -------------------------------------------------------------------- CLI

def test_cli_file_rows_equal_the_reference_cli(disk_graph, capsys):
    """``--graph file:`` rows (RF, balance, gas_comm) equal the reference
    CLI's; the rows that take no stream are marked ``[in-memory, natural]``."""
    _, _, _, man = disk_graph
    spec = f"file:{man}"
    for name, ordering in (("hdrf", "windowed"), ("s5p", "natural"), ("dbh", "natural")):
        want = jcli.run(spec, 4, name, 0, chunk_size=512, ordering=ordering, window=64)
        got = tcli.run(spec, 4, name, chunk_size=512, ordering=ordering, window=64,
                       device="cpu")
        assert [r[:4] for r in want] == [r[:4] for r in got]
    out = capsys.readouterr().out
    assert "[in-memory, natural]" in out and "[oocstream] peak" in out
    with pytest.raises(ValueError, match="file:"):
        tcli.load_graph(spec)


def test_cli_write_shards_and_append_read_back_in_the_reference(tmp_path):
    out = str(tmp_path / "g")
    tcli.main(["--graph", "community:300", "--write-shards", out, "--shard-edges", "100"])
    tcli.main(["--graph", "rmat:6", "--write-shards", out, "--append"])
    jcli.write_shards_cli("community:300", str(tmp_path / "j"), 100)
    jcli.write_shards_cli("rmat:6", str(tmp_path / "j"), 100, append=True)
    _same_dirs(out, tmp_path / "j")
    a, b = tcli.load_graph("community:300"), tcli.load_graph("rmat:6")
    with js.ShardedEdgeStream(out) as st:
        s, d = st.arrival_arrays()
    np.testing.assert_array_equal(s, np.concatenate([a[0], b[0]]))
    np.testing.assert_array_equal(d, np.concatenate([a[1], b[1]]))
    with pytest.raises(SystemExit):
        tcli.main(["--append"])
