"""Port parity: Alg. 1 clustering (repro_torch.core.clustering and the K1
plain version) against repro's lax.scan and its Pallas kernel in
interpret mode, leaf by leaf, with exact equality."""

import numpy as np
import pytest
import torch
from proptest import random_graph

from repro.core import clustering as jcl
from repro.kernels.stream_scan import cluster_scan as pallas_cluster_scan
from repro.streaming import EdgeStream as JaxStream
from repro_torch import interop
from repro_torch.core import clustering as tcl
from repro_torch.kernels.stream_scan import cluster_chunk_oracle, cluster_scan

XI, KAPPA, CHUNK = 3, 50, 64


def _assert_state_equal(ref, port, where):
    for name, a, b in zip(tcl.ClusterState._fields, ref, port):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=f"{where}: leaf {name}")


@pytest.mark.parametrize("global_tail", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_cluster_chunk_matches_reference_and_pallas(seed, global_tail):
    src, dst, n, _ = random_graph(seed)
    deg = jcl.compute_degrees(src, dst, n)
    deg_t = torch.from_numpy(np.array(deg))
    kw = dict(xi=XI, kappa=KAPPA, global_tail=global_tail)
    ref = jcl.init_state(n)
    pallas = tuple(jcl.init_state(n))
    port = interop.cluster_state(jcl.init_state(n), device="cpu")
    for i, ch in enumerate(JaxStream(src, dst, n, chunk_size=CHUNK).chunks()):
        ref = jcl.cluster_chunk(ref, ch.src, ch.dst, deg, **kw)
        pallas = pallas_cluster_scan(pallas, ch.src, ch.dst, deg, interpret=True, **kw)
        s = torch.from_numpy(np.asarray(ch.src))
        d = torch.from_numpy(np.asarray(ch.dst))
        port = tcl.cluster_chunk(port, s, d, deg_t, **kw)
        _assert_state_equal(ref, port, f"seed {seed} chunk {i} vs lax.scan")
        _assert_state_equal(pallas, port, f"seed {seed} chunk {i} vs Pallas")
    # the wrapper's CPU route is the same plain version
    again = interop.cluster_state(jcl.init_state(n), device="cpu")
    s = torch.from_numpy(src)
    d = torch.from_numpy(dst)
    full = cluster_scan(tuple(again), s, d, deg_t, **kw)
    oracle = cluster_chunk_oracle(tuple(interop.cluster_state(jcl.init_state(n), device="cpu")),
                                  s, d, deg_t, **kw)
    for a, b in zip(full, oracle):
        assert torch.equal(a, b)


@pytest.mark.parametrize("global_tail", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_cluster_stream_and_compaction_match(seed, global_tail):
    src, dst, n, _ = random_graph(seed)
    kw = dict(xi=XI, kappa=KAPPA, chunk_size=CHUNK, global_tail=global_tail)
    ref = jcl.cluster_stream(src, dst, n, **kw)
    port = tcl.cluster_stream(src, dst, n, device="cpu", **kw)
    _assert_state_equal(ref, port, f"seed {seed} cluster_stream")
    deg = jcl.compute_degrees(src, dst, n)
    deg_t = tcl.compute_degrees(torch.from_numpy(src), torch.from_numpy(dst), n)
    np.testing.assert_array_equal(np.asarray(deg), deg_t.numpy())
    rres = jcl.compact_clusters(ref, deg, XI)
    pres = tcl.compact_clusters(port, deg_t, XI)
    assert (rres.n_head, rres.n_clusters) == (pres.n_head, pres.n_clusters)
    for name in ("v2c", "v2c_h", "v2c_t", "is_head_vertex"):
        np.testing.assert_array_equal(np.asarray(getattr(rres, name)),
                                      getattr(pres, name).numpy(), err_msg=name)


def test_bounded_kappa_wraps_like_int32():
    """S5P-B: κ = 2³¹−1 makes ``vol + d < κ`` int32 arithmetic that wraps."""
    src, dst, n, _ = random_graph(1)
    kw = dict(xi=1, kappa=2**31 - 1, chunk_size=CHUNK, global_tail=True)
    ref = jcl.cluster_stream(src, dst, n, **kw)
    port = tcl.cluster_stream(src, dst, n, device="cpu", **kw)
    _assert_state_equal(ref, port, "bounded")


def test_degree_carry_masks_padding():
    src, dst, n, _ = random_graph(0)
    from repro_torch.streaming import EdgeStream, run_carry, run_retract

    stream = EdgeStream(src, dst, n, chunk_size=7, device="cpu")
    dc = tcl.DegreeCarry(n, device="cpu")
    _, deg = run_carry(stream, dc)
    want = tcl.compute_degrees(torch.from_numpy(src), torch.from_numpy(dst), n)
    assert torch.equal(deg, want)
    assert int(run_retract(stream, dc, None, carry=deg).abs().sum()) == 0


def test_parallel_options_raise():
    """Parallel clustering is ported (two lanes give the reference's state);
    only invalid parallel options raise."""
    src, dst, n, _ = random_graph(0)
    want = jcl.cluster_stream(src, dst, n, xi=XI, kappa=KAPPA, chunk_size=16,
                              num_streams=2, super_chunk=2)
    got = tcl.cluster_stream(src, dst, n, xi=XI, kappa=KAPPA, chunk_size=16,
                             num_streams=2, super_chunk=2, device="cpu")
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for kw in ({"super_chunk": 0}, {"shard": "diagonal"}, {"num_streams": 0}):
        with pytest.raises(ValueError):
            tcl.cluster_stream(src, dst, n, xi=XI, kappa=KAPPA, chunk_size=16,
                               device="cpu", **{"num_streams": 2, **kw})


# ------------------------------------------------ K1's tile plan (staged)

def _k1_case(name):
    """(src, dst, n, state-before, kw, tile) of one tile-plan case."""
    from repro_torch.core.clustering import init_state

    rng = np.random.default_rng(11)
    kw = dict(xi=XI, kappa=KAPPA, global_tail=False)
    tile = 32
    if name == "hub":  # vertex 0 is an endpoint of every edge of every tile
        n, E = 60, 150
        src = np.zeros(E, np.int32)
        dst = rng.integers(1, n, E).astype(np.int32)
        kw["xi"] = 2
        tile = 16
    elif name == "migrate-then-read":  # tail: 0 joins 1's cluster in tile 0
        n = 8
        src = np.array([0, 0, 3, 0, 2, 5], np.int32)
        dst = np.array([1, 2, 0, 4, 3, 0], np.int32)
        kw["xi"] = 100
        tile = 1
    else:
        src, dst, n, _ = random_graph(1)
        src, dst = src.astype(np.int32), dst.astype(np.int32)
        if name == "self-loops-padding":
            dst[::7] = src[::7]
            src = np.concatenate([src, np.zeros(13, np.int32)])
            dst = np.concatenate([dst, np.zeros(13, np.int32)])
        elif name == "tile-1":
            src, dst, tile = src[:120], dst[:120], 1
        elif name == "ragged-tile":
            src, dst, tile = src[:203], dst[:203], 64
        elif name == "kappa-max":
            kw = dict(xi=1, kappa=2**31 - 1, global_tail=True)
        elif name == "clugp":
            kw["xi"] = -1
        elif name == "global-tail":
            kw["global_tail"] = True
    state = tuple(init_state(n, "cpu"))
    if name in ("mid-stream", "past-V"):  # a warm state: the first half folded first
        half = src.size // 2
        cluster_chunk_oracle(state, torch.from_numpy(src[:half]),
                             torch.from_numpy(dst[:half]),
                             tcl.compute_degrees(torch.from_numpy(src),
                                                 torch.from_numpy(dst), n), **kw)
        src, dst = src[half:], dst[half:]
    if name == "past-V":  # merged lanes' id counters: new ids reach V and pass it
        state[5].fill_(n - 1)
        state[6].fill_(n - 2)
        state[2][n] = state[3][n] = KAPPA // 2  # slot V, read by every id past it
    return src, dst, n, state, kw, tile


K1_CASES = ["hub", "all-new", "migrate-then-read", "self-loops-padding", "tile-1",
            "ragged-tile", "kappa-max", "clugp", "global-tail", "mid-stream", "past-V"]


@pytest.mark.parametrize("slot_seed", [None, 5])
@pytest.mark.parametrize("case", K1_CASES)
def test_cluster_staged_matches_oracle(case, slot_seed):
    """K1's tile plan (vertex and cluster slots, the reserved new ids, the
    tile boundaries, counts off the fold, the write-back) gives the plain
    fold's bits, whatever the slots' numbering."""
    from repro_torch.kernels.stream_scan import cluster_chunk_staged

    src, dst, n, state, kw, tile = _k1_case(case)
    if case in ("mid-stream", "past-V"):
        full = _k1_case("all-new")
        deg = tcl.compute_degrees(torch.from_numpy(full[0]), torch.from_numpy(full[1]), n)
    else:
        deg = tcl.compute_degrees(torch.from_numpy(src), torch.from_numpy(dst), n)
    s, d = torch.from_numpy(src), torch.from_numpy(dst)
    want = cluster_chunk_oracle(tuple(t.clone() for t in state), s, d, deg, **kw)
    got = cluster_chunk_staged(tuple(t.clone() for t in state), s, d, deg, tile=tile,
                               slot_seed=slot_seed, **kw)
    for name, a, b in zip(tcl.ClusterState._fields, want, got):
        assert torch.equal(a, b), f"{case}: leaf {name}"
    if case == "migrate-then-read":
        # the first edge moved 0 into 1's tail cluster; tile 1 reads it
        one = cluster_chunk_oracle(tuple(t.clone() for t in state), s[:1], d[:1],
                                   deg, **kw)
        assert int(one[1][0]) == int(one[1][1]) >= 0 and 0 in (src[1], dst[1])


@pytest.mark.parametrize("case", ["hub", "self-loops-padding", "ragged-tile", "kappa-max"])
def test_cluster_staged_matches_reference(case):
    """The staged plan against the reference's lax.scan fold, directly."""
    from repro_torch.kernels.stream_scan import cluster_chunk_staged

    src, dst, n, _, kw, tile = _k1_case(case)
    deg = jcl.compute_degrees(src, dst, n)
    ref = jcl.cluster_chunk(jcl.init_state(n), src, dst, deg, **kw)
    port = cluster_chunk_staged(interop.cluster_state(jcl.init_state(n), device="cpu"),
                                torch.from_numpy(src), torch.from_numpy(dst),
                                torch.from_numpy(np.array(deg)), tile=tile, slot_seed=3, **kw)
    _assert_state_equal(ref, port, f"{case} staged vs lax.scan")


def test_cluster_plan_fits_shared_memory():
    from repro_torch.kernels.stream_scan import plan

    assert plan.cluster_smem_bytes(plan.K1_TILE) == 217_120 <= plan.SHARED_MEM_BYTES
    assert 2 * plan.K1_TILE <= 1 << 12  # vertex slots fit a record's 12 bits
    assert 4 * plan.K1_TILE <= 1 << 16  # hash positions fit 16 bits in stage
