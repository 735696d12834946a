"""K1, K2, K3, G1, K4a, K4b and K5 on the card against their plain PyTorch
versions (bitwise; K1, K2 and K3 also at the main path's 65,536-edge chunk,
K2 with no room, room that runs out and the wrap guard, K3 on every rung,
with equal bits on two launches; K4a with negative counts), K6 and K7 against
their plain versions within stated tolerances, the backward kernels K6b and
K7b within stated tolerances and K5ᵀ bitwise (each with equal bits on two
launches), a training step of each family's smoke cell on cuda against cpu
(and the GCN loss's gradient, which K5 dropped on the card before its
autograd function), the GCN, SchNet, EGNN,
DimeNet (and their K5 message layouts, bitwise), the LM and xDeepFM on
cuda against cpu, streams paged from disk shards onto the card, and incremental
re-partitioning (``cluster_retract_chunk``; a delta, its rollback, a deletion
and window steps; a bundle saved from the card), PageRank's K5 gather, the
hybrid partitioner and its carries on cuda against cpu, and
``distributed_partition`` in worlds of ranks on the card against the CPU.  Needs a
CUDA device and ``nvcc``; run on a machine with a card:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    """Decided when a test runs, never at import: the CPU suite skips."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.kernels import _build

    _build.build_all()
    return torch.device("cuda")


def _graph(scale=10, seed=0):
    from repro_torch.graphs import rmat_graph

    return rmat_graph(scale, edge_factor=8, seed=seed)


@pytest.mark.parametrize("global_tail", [False, True])
@pytest.mark.parametrize("kappa", [300, 2**31 - 1])
def test_k1_cluster_scan(cuda, global_tail, kappa):
    from repro_torch.core.clustering import compute_degrees, init_state
    from repro_torch.kernels.stream_scan import (cluster_chunk_oracle, cluster_scan,
                                                 launch_counts)

    src, dst, n = _graph()
    s, d = torch.from_numpy(src), torch.from_numpy(dst)
    deg = compute_degrees(s, d, n)
    kw = dict(xi=int(2 * src.size / n), kappa=kappa, global_tail=global_tail)
    want = cluster_chunk_oracle(tuple(init_state(n, "cpu")), s, d, deg, **kw)
    before = launch_counts()["cluster_scan"]
    got = cluster_scan(tuple(init_state(n, cuda)), s.to(cuda), d.to(cuda),
                       deg.to(cuda), **kw)
    torch.cuda.synchronize()
    assert launch_counts()["cluster_scan"] == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("k", [8, 32, 256])
def test_k2_assign_scan_insert_and_retract(cuda, k):
    from repro_torch.kernels.stream_scan import assign_chunk_oracle, assign_scan

    src, dst, n = _graph(seed=1)
    rng = np.random.default_rng(k)
    E = src.size
    cap = int(np.ceil(0.9 * E / k))
    head = torch.from_numpy(rng.random(E) < 0.4)
    pcu = torch.from_numpy(rng.integers(0, k, E).astype(np.int32))
    pcv = torch.from_numpy(rng.integers(0, k, E).astype(np.int32))
    s, d = torch.from_numpy(src), torch.from_numpy(dst)
    load0 = torch.zeros(k, dtype=torch.int32)
    p_want, l_want = assign_chunk_oracle(load0, s, d, head, pcu, pcv, max_load=cap)
    args = [t.to(cuda) for t in (s, d, head, pcu, pcv)]
    p_got, l_got = assign_scan(load0.to(cuda), *args, max_load=cap)
    assert torch.equal(p_got.cpu(), p_want) and torch.equal(l_got.cpu(), l_want)
    z = torch.zeros_like(args[0])
    _, back = assign_scan(l_got, args[0], args[1], z, z, z, max_load=cap, sign=-1,
                          parts=p_got, n_valid=E - 5)
    zc = z.cpu()
    _, back_want = assign_chunk_oracle(l_want, s, d, zc, zc, zc, max_load=cap,
                                       sign=-1, parts=p_want, n_valid=E - 5)
    assert torch.equal(back.cpu(), back_want)


def _k2_inputs(E, k, seed, *, loads, cap, pad=0, head_p=0.4):
    """E edges over 2^16 vertices (a few self-loops), endpoint partitions and
    head flags from a seed, then ``pad`` (0, 0) entries with zero extras,
    as ``EdgeStream`` pads a chunk; the loads are ``loads(rng)``."""
    rng = np.random.default_rng(seed)
    V = 1 << 16
    src = rng.integers(0, V, E).astype(np.int32)
    dst = np.where(rng.random(E) < 0.01, src, rng.integers(0, V, E)).astype(np.int32)
    cols = [src, dst, rng.random(E) < head_p, rng.integers(0, k, E).astype(np.int32),
            rng.integers(0, k, E).astype(np.int32)]
    cols = [np.concatenate([c, np.zeros(pad, c.dtype)]) for c in cols]
    load = np.asarray(loads(rng), np.int64).astype(np.int32)
    return [torch.from_numpy(c) for c in cols], torch.from_numpy(load), cap


_INT32_MAX = 2**31 - 1
# (E, k, loads, cap, pad): the main path's chunk (65,536 edges, loads near the
# cap, some full), the same at k = 4,096, no room from the start (one level,
# and one partition far below the rest), room that runs out mid-chunk, and
# loads within n of 2^31 - 1 under cap = 2^31 - 1 (the wrap guard)
K2_CASES = {
    "65536-k32": (65536, 32, lambda r: r.integers(40_000 - 2500, 40_000 + 3, 32), 40_000, 0),
    "65536-k4096": (65536, 4096, lambda r: r.integers(300 - 64, 300 + 3, 4096), 300, 0),
    "padded-k32": (37_029, 32, lambda r: r.integers(40_000 - 64, 40_000 + 3, 32), 40_000,
                   65536 - 37_029),
    "no-room-k32": (65536, 32, lambda r: np.full(32, 5000), 5000, 0),
    "no-room-k4096": (8192, 4096, lambda r: r.integers(100, 104, 4096), 100, 0),
    "no-room-lagging-k32": (16384, 32, lambda r: np.r_[np.full(16, 900), 100, np.full(15, 900)],
                            100, 0),
    "room-runs-out-k256": (65536, 256, lambda r: r.integers(300, 303, 256), 302, 0),
    "wrap-k32": (16384, 32, lambda r: _INT32_MAX - r.integers(0, 600, 32), _INT32_MAX, 0),
    "wrap-k5": (4096, 5, lambda r: _INT32_MAX - r.integers(0, 900, 5), _INT32_MAX, 0),
}


@pytest.mark.parametrize("case", list(K2_CASES))
def test_k2_cases(cuda, case):
    """K2 against its plain version, bitwise, insert then retract (of all but
    the last 1,000 entries, over many blocks), one launch a call, and equal
    bits on two launches from one state."""
    from repro_torch.kernels.stream_scan import (assign_chunk_oracle, assign_scan,
                                                 launch_counts)
    from repro_torch.kernels.stream_scan.ref import assign_chunk_planned

    E, k, loads, cap, pad = K2_CASES[case]
    cols, load0, cap = _k2_inputs(E, k, list(K2_CASES).index(case), loads=loads, cap=cap,
                                 pad=pad)
    stats = {}
    p_want, l_want = assign_chunk_planned(load0, *cols, max_load=cap, stats=stats)
    if k <= 256 or stats["overflow"] < 5000:  # the oracle scans k per overflow edge
        p_or, l_or = assign_chunk_oracle(load0, *cols, max_load=cap)
        assert torch.equal(p_or, p_want) and torch.equal(l_or, l_want)
    args = [t.to(cuda) for t in cols]
    runs = []
    for _ in range(2):
        before = launch_counts()["assign_scan"]
        load = load0.to(cuda)
        p_got, l_got = assign_scan(load, *args, max_load=cap)
        torch.cuda.synchronize()
        assert launch_counts()["assign_scan"] == before + 1
        assert l_got.data_ptr() == load.data_ptr()  # in place
        runs.append((p_got.cpu(), l_got.cpu()))
    for p_got, l_got in runs:
        assert torch.equal(p_got, p_want) and torch.equal(l_got, l_want)
    nv = E + pad - 1000
    z = torch.zeros_like(args[0])
    before = launch_counts()["assign_scan"]
    p_back, back = assign_scan(load0.to(cuda).copy_(l_want.to(cuda)), args[0], args[1], z, z,
                               z, max_load=cap, sign=-1, parts=p_want.to(cuda), n_valid=nv)
    torch.cuda.synchronize()
    assert launch_counts()["assign_scan"] == before + 1
    zc = z.cpu()
    _, back_want = assign_chunk_oracle(l_want, cols[0], cols[1], zc, zc, zc, max_load=cap,
                                       sign=-1, parts=p_want, n_valid=nv)
    assert torch.equal(back.cpu(), back_want) and torch.equal(p_back.cpu(), p_want)


@pytest.mark.parametrize("k", [1, 32, 4096])
def test_k2_retract_histogram(cuda, k):
    """Retract alone over 2^18 entries (256 blocks), recorded parts covering
    every partition, -1 and self-loops among them, n_valid < E: the load
    gives back exactly the count of each partition."""
    from repro_torch.kernels.stream_scan import assign_chunk_oracle, assign_scan

    rng = np.random.default_rng(k)
    E = 1 << 18
    src = torch.from_numpy(rng.integers(0, 100, E).astype(np.int32))
    dst = torch.from_numpy(rng.integers(0, 100, E).astype(np.int32))
    parts = torch.from_numpy(rng.integers(-1, k, E).astype(np.int32))
    load = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, k).astype(np.int32))
    z = torch.zeros(E, dtype=torch.int32)
    nv = E - 12345
    p_want, l_want = assign_chunk_oracle(load, src, dst, z, z, z, max_load=0, sign=-1,
                                         parts=parts, n_valid=nv)
    zc = z.to(cuda)
    p_got, l_got = assign_scan(load.to(cuda), src.to(cuda), dst.to(cuda), zc, zc, zc,
                               max_load=0, sign=-1, parts=parts.to(cuda), n_valid=nv)
    torch.cuda.synchronize()
    assert torch.equal(p_got.cpu(), p_want) and torch.equal(l_got.cpu(), l_want)


def test_k2_shared_bytes_match_plan(cuda):
    from repro_torch.kernels.stream_scan import kernel as K
    from repro_torch.kernels.stream_scan import plan

    for k in (1, 8, 32, 33, 256, 4096):
        assert K._lib().assign_smem_bytes(k) == plan.assign_smem_bytes(k)


def test_k4_cms_update_and_query(cuda):
    from repro_torch.core.cms import make_sketch, pair_key
    from repro_torch.kernels.cms_sketch import cms_query, cms_update, query_ref, update_ref

    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.integers(0, 5000, 1 << 16).astype(np.int32))
    b = torch.from_numpy(rng.integers(0, 5000, 1 << 16).astype(np.int32))
    keys = pair_key(a, b)
    counts = torch.from_numpy(rng.integers(-2, 3, keys.numel()))
    seeds = make_sketch(28 * 70, 5, seed=3, device="cpu").seeds
    want = update_ref(keys, seeds, 28 * 70, 5, counts)
    got = cms_update(keys.to(cuda), seeds.to(cuda), 28 * 70, 5, counts.to(cuda))
    assert torch.equal(got.cpu(), want)
    assert torch.equal(cms_query(got, keys.to(cuda), seeds.to(cuda)).cpu(),
                       query_ref(want, keys, seeds))


def _k4_keys(n, hot, seed=0):
    from repro_torch.core.cms import pair_key

    rng = np.random.default_rng(seed)
    if hot:  # one key n times
        return torch.full((n,), int(pair_key(torch.tensor([3]), torch.tensor([7]))[0]))
    a = torch.from_numpy(rng.integers(0, 5000, n).astype(np.int32))
    b = torch.from_numpy(rng.integers(0, 5000, n).astype(np.int32))
    high = torch.from_numpy(rng.integers(-2**30, 2**30, n)) << 32  # read as the low 32 bits
    return pair_key(a, b) + high


@pytest.mark.parametrize("blocks_per_row", [0, 1, 7])
@pytest.mark.parametrize("width", [28, 11_788, 16_384 + 1_000])
@pytest.mark.parametrize("n,hot", [(0, False), (1, False), ((1 << 18) + 1, False),
                                   (1 << 18, True)])
def test_k4_update_add_and_query(cuda, n, hot, width, blocks_per_row):
    """K4a and K4b bitwise against ``ref.py``: a hot-key stream (one key
    2^18 times), widths that are not a multiple of a block's share (one
    block's slice of 16,384 columns and a ragged second slice), n = 0, 1
    and 2^18 + 1, int64 keys with high bits set, counts that wrap; K4a both
    into its own table and into a given one, one launch a call."""
    from repro_torch.core.cms import make_sketch
    from repro_torch.kernels import _build
    from repro_torch.kernels.cms_sketch import (add_ref, cms_add, cms_query, cms_update,
                                                launch_counts, query_ref, update_ref)
    from repro_torch.kernels.cms_sketch.kernel import _lib

    keys = _k4_keys(n, hot, seed=width)
    rng = np.random.default_rng(n)
    counts = torch.from_numpy(rng.integers(-3, 4, n))
    seeds = make_sketch(width, 5, seed=3, device="cpu").seeds
    kc, sc, cc = keys.to(cuda), seeds.to(cuda), counts.to(cuda)
    before = launch_counts()
    got = cms_update(kc, sc, width, 5, cc)
    assert torch.equal(got.cpu(), update_ref(keys, seeds, width, 5, counts))
    start = torch.from_numpy(rng.integers(-2**31, 2**31, (5, width)).astype(np.int32))
    table = start.to(cuda)
    out = cms_add(table, kc, sc, cc)
    assert out.data_ptr() == table.data_ptr()
    want = add_ref(start, keys, seeds, counts)
    assert torch.equal(table.cpu(), want)
    ones = cms_add(start.to(cuda), kc, sc)
    assert torch.equal(ones.cpu(), add_ref(start, keys, seeds))
    # the key slices a row that the C entry point takes when given them
    sliced = start.to(cuda)
    _build.check(_lib().cms_update_launch(
        kc.data_ptr(), cc.data_ptr(), sc.data_ptr(), n, 5, width, sliced.data_ptr(),
        blocks_per_row, torch.cuda.current_stream().cuda_stream), "cms_update")
    assert torch.equal(sliced.cpu(), want)
    q = cms_query(table, kc, sc)
    assert q.dtype == torch.int64 and torch.equal(q.cpu(), query_ref(want, keys, seeds))
    torch.cuda.synchronize()
    after = launch_counts()
    assert after["cms_update"] - before["cms_update"] == (3 if n else 0)
    assert after["cms_query"] - before["cms_query"] == (1 if n else 0)


def test_k4_sketch_update_is_one_launch_and_a_copy(cuda):
    """``core.cms.cms_update`` copies the table and adds into the copy: one
    K4a launch and one other launch (the copy), the old sketch unchanged."""
    from repro_torch.core.cms import cms_update, make_sketch, pair_key
    from repro_torch.kernels.cms_sketch import launch_counts

    sketch = make_sketch(11_788, 5, seed=0, device=cuda)
    a = torch.arange(1 << 18, device=cuda, dtype=torch.int32) % 977
    keys = pair_key(a, a.flip(0))
    counts = torch.ones_like(keys)
    torch.cuda.synchronize()
    before = launch_counts()["cms_update"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        new = cms_update(sketch, keys, counts)
        torch.cuda.synchronize()
    assert launch_counts()["cms_update"] == before + 1
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) <= 2, [e.name for e in kernels]
    assert int(sketch.table.abs().sum()) == 0 and int(new.table.sum()) != 0


def _hub_game_inputs(w_scale, size_scale):
    """``community_graph(600, 8, 6, seed=3)``'s game inputs (CMS Θ, k = 8)
    with the pairs of its largest-degree cluster scaled by ``w_scale`` and
    the sizes by ``size_scale``, as ``tests/test_torch_game.py`` builds them."""
    from repro_torch.core import clustering as cl
    from repro_torch.core import game as tgame
    from repro_torch.core.s5p import cluster_statistics
    from repro_torch.graphs import community_graph

    src, dst, n = community_graph(600, n_communities=8, avg_degree=6, seed=3)
    s, d = torch.from_numpy(src).int(), torch.from_numpy(dst).int()
    deg = cl.compute_degrees(s, d, n)
    xi, kappa = int(2.0 * src.size / n), max(int(np.ceil(2.0 * src.size / 8)), 2)
    res = cl.compact_clusters(cl.cluster_stream(s, d, n, xi=xi, kappa=kappa, device="cpu"),
                              deg, xi)
    sizes, pa, pb, pw, _ = cluster_statistics(s, d, res, deg, xi, use_cms=True,
                                              cms_epsilon=0.1, cms_nu=0.01, seed=0)
    C = res.n_clusters
    cdeg = torch.zeros(C + 1, dtype=torch.float64)
    cdeg.index_add_(0, pa.long(), pw.double()).index_add_(0, pb.long(), pw.double())
    hub = int(cdeg[:C].argmax())
    touch = (pa == hub) | (pb == hub)
    pw = torch.where(touch, pw * np.float32(w_scale), pw)
    return tgame.GameInputs(sizes=sizes * np.float32(size_scale), pair_a=pa, pair_b=pb,
                            pair_w=pw, n_head=res.n_head, k=8), C


@pytest.mark.parametrize("w_scale,size_scale", [(100_003, 45_001), (2_700_001, 56_789)])
def test_game_hub_batches_and_replays_cuda_equal_cpu(cuda, w_scale, size_scale):
    """W past 2**24 in hub batches and partition sizes past 2**23 during the
    rounds: ten games in a row on the card equal the CPU's (the reference's
    order) in assignment, rounds and report; each game launches K5 twice
    for the degrees and once per ordered sum it reports."""
    from repro_torch.core import game as tgame
    from repro_torch.kernels.segment_agg import launch_counts

    inputs, C = _hub_game_inputs(w_scale, size_scale)
    on = tgame.GameInputs(*(t.to(cuda) for t in inputs[:4]), inputs.n_head, 8)
    kw = dict(batch_size=tgame.default_batch_size(256, C), accept_prob=0.9, seed=3)
    cpu = tgame.run_game(inputs, C, **kw)
    assert cpu.hub_batches > 0 and cpu.replayed_rounds > 0 and cpu.max_w_hub >= 2**24
    for _ in range(10):
        before = launch_counts()["segment_agg"]
        gpu = tgame.run_game(on, C, **kw)
        torch.cuda.synchronize()
        assert launch_counts()["segment_agg"] - before == 2 + gpu.ordered_sums
        assert torch.equal(gpu.assignment.cpu(), cpu.assignment)
        assert gpu._replace(assignment=None) == cpu._replace(assignment=None)
    d = tgame.compute_delta(inputs.sizes, tgame._cluster_degrees(inputs, C), 8)
    d_gpu = tgame.compute_delta(on.sizes, tgame._cluster_degrees(on, C), 8)
    s_cpu = tgame.social_welfare(inputs, cpu.assignment, d)
    s_gpu = tgame.social_welfare(on, gpu.assignment, d_gpu)
    assert s_cpu.view(torch.int32).item() == s_gpu.cpu().view(torch.int32).item()
    assert float(tgame.best_response_gap(inputs, cpu.assignment, C)) == float(
        tgame.best_response_gap(on, gpu.assignment, C))


def test_s5p_cuda_equals_cpu(cuda):
    from repro_torch.core.s5p import S5PConfig, s5p_partition
    from repro_torch.graphs import community_graph

    src, dst, n = community_graph(1000, n_communities=16, avg_degree=6, seed=2)
    gpu = s5p_partition(src, dst, n, S5PConfig(k=8), device=cuda)
    cpu = s5p_partition(src, dst, n, S5PConfig(k=8), device="cpu")
    assert torch.equal(gpu.parts.cpu(), cpu.parts)


def _scoring_state(n, k, rng, *, hdrf, load_base=0):
    """A warm state on the CPU: counted replicas, loads and partial degrees."""
    rep = torch.from_numpy((rng.random((n, k)) < 0.2).astype(np.int32)
                           * rng.integers(1, 4, (n, k)).astype(np.int32))
    load = torch.from_numpy(rng.integers(0, 50, k).astype(np.int32) + load_base)
    pd = torch.from_numpy(rng.integers(0, 20, n).astype(np.int32)) if hdrf else None
    return load, rep, pd


@pytest.mark.parametrize("mode,k,k_active", [
    ("greedy", 8, None), ("greedy", 32, None), ("greedy", 100, None),
    ("hdrf", 8, None), ("hdrf", 32, None), ("hdrf", 100, None),
    ("hdrf", 32, 29),
])
def test_k3_scoring_scan_insert_and_retract(cuda, mode, k, k_active):
    from repro_torch.kernels.stream_scan import launch_counts, scoring_chunk_oracle, scoring_scan

    src, dst, n = _graph(seed=2)
    src, dst = src[:3000], dst[:3000]
    src[::97] = dst[::97]  # self-loops: no placement, pd bumped twice
    rng = np.random.default_rng(k)
    hdrf = mode == "hdrf"
    load, rep, pd = _scoring_state(n, k, rng, hdrf=hdrf)
    s, d = torch.from_numpy(src), torch.from_numpy(dst)
    kw = dict(mode=mode, k_active=k_active)
    lam = 1.1 if hdrf else None
    want = scoring_chunk_oracle(s, d, load.clone(), rep.clone(),
                                pd.clone() if hdrf else None, lam, **kw)
    before = launch_counts()["scoring_scan"]
    got = scoring_scan(s.to(cuda), d.to(cuda), load.to(cuda), rep.to(cuda),
                       pd.to(cuda) if hdrf else None, lam, **kw)
    torch.cuda.synchronize()
    assert launch_counts()["scoring_scan"] == before + 1
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a.cpu(), b)
    nv = 2900
    retracts = launch_counts()["scoring_retract"]
    back = scoring_scan(s.to(cuda), d.to(cuda), *got[1:3], got[3], mode=mode,
                        sign=-1, parts=got[0], n_valid=nv)
    assert launch_counts()["scoring_retract"] == retracts + 1
    assert launch_counts()["scoring_scan"] == before + 1
    back_want = scoring_chunk_oracle(s, d, *want[1:3], want[3], mode=mode,
                                     sign=-1, parts=want[0], n_valid=nv)
    for a, b in zip(back, back_want):
        assert (a is None and b is None) or torch.equal(a.cpu(), b)


def test_k3_hdrf_equal_large_loads_score_nan(cuda):
    """Equal active loads >= 2**15 make bal 0/0: every active score is NaN
    and, as jnp.argmax does, the first active partition wins."""
    from repro_torch.kernels.stream_scan import scoring_chunk_oracle, scoring_scan

    n, k = 64, 8
    rng = np.random.default_rng(7)
    load = torch.full((k,), 40000, dtype=torch.int32)
    rep = torch.zeros((n, k), dtype=torch.int32)
    pd = torch.zeros(n, dtype=torch.int32)
    s = torch.from_numpy(rng.integers(0, n, 200).astype(np.int32))
    d = torch.from_numpy(rng.integers(0, n, 200).astype(np.int32))
    want = scoring_chunk_oracle(s, d, load.clone(), rep.clone(), pd.clone(), 1.1,
                                mode="hdrf", k_active=6)
    got = scoring_scan(s.to(cuda), d.to(cuda), load.to(cuda), rep.to(cuda),
                       pd.to(cuda), 1.1, mode="hdrf", k_active=6)
    assert int(want[0][0]) == 0
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def test_g1_grid_scan(cuda):
    from repro_torch.kernels.stream_scan import grid_chunk_oracle, grid_scan, launch_counts

    src, dst, n = _graph(seed=3)
    src[::50] = dst[::50]
    k, c = 32, 8
    rng = np.random.default_rng(0)
    row = torch.from_numpy(rng.integers(0, k // c, n).astype(np.int32))
    col = torch.from_numpy(rng.integers(0, c, n).astype(np.int32))
    load = torch.from_numpy(rng.integers(0, 9, k).astype(np.int32))
    s, d = torch.from_numpy(src), torch.from_numpy(dst)
    want = grid_chunk_oracle(load.clone(), row, col, c, s, d)
    before = launch_counts()["grid_scan"]
    got = grid_scan(load.to(cuda), row.to(cuda), col.to(cuda), c, s.to(cuda), d.to(cuda))
    torch.cuda.synchronize()
    assert launch_counts()["grid_scan"] == before + 1
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


# K1 and K3 at the main path's chunk of 65,536 edges, on the staged tiles:
# from the empty state and from the state after half a stream's chunks;
# two launches from one state must give the same bits.
MAIN_CHUNK = 1 << 16


def _first_diff(got, want, names):
    """The first leaf and index where two tuples of tensors differ."""
    for name, a, b in zip(names, got, want):
        if a is None and b is None:
            continue
        a = a.cpu()
        if not torch.equal(a, b):
            bad = (a.reshape(-1) != b.reshape(-1)).nonzero()
            i = int(bad[0]) if bad.numel() else -1
            return f"leaf {name} index {i}"
    return None


K1_VARIANTS = {  # name: (xi, kappa, global_tail); xi None = the mean degree
    "s5p": (None, 400, False),
    "s5p-b": (None, 400, True),
    "clugp": (-1, 400, False),
    "kappa-max": (None, 2**31 - 1, True),
}


@pytest.mark.parametrize("state", ["empty", "mid"])
@pytest.mark.parametrize("variant", list(K1_VARIANTS))
def test_k1_main_chunk(cuda, variant, state):
    from repro_torch.core.clustering import ClusterState, compute_degrees, init_state
    from repro_torch.kernels.stream_scan import cluster_chunk_oracle, cluster_scan

    src, dst, n = _graph(scale=15, seed=4)  # over two main chunks of edges
    s, d = torch.from_numpy(src), torch.from_numpy(dst)
    deg = compute_degrees(s, d, n)
    xi, kappa, gt = K1_VARIANTS[variant]
    kw = dict(xi=int(2 * src.size / n) if xi is None else xi, kappa=kappa,
              global_tail=gt)
    cpu = tuple(init_state(n, "cpu"))
    gpu = tuple(init_state(n, cuda))
    start = MAIN_CHUNK if state == "mid" else 0
    if start:
        cluster_chunk_oracle(cpu, s[:start], d[:start], deg, **kw)
        cluster_scan(gpu, s[:start].to(cuda), d[:start].to(cuda), deg.to(cuda), **kw)
    cs, cd = s[start:start + MAIN_CHUNK], d[start:start + MAIN_CHUNK]
    twice = []
    for _ in range(2):
        work = tuple(t.clone() for t in gpu)
        twice.append(cluster_scan(work, cs.to(cuda), cd.to(cuda), deg.to(cuda), **kw))
    torch.cuda.synchronize()
    want = cluster_chunk_oracle(tuple(t.clone() for t in cpu), cs, cd, deg, **kw)
    assert int(want[5]) > int(cpu[5]), "the chunk hands out new head ids"
    assert _first_diff(twice[0], want, ClusterState._fields) is None
    assert _first_diff(twice[1], [t.cpu() for t in twice[0]], ClusterState._fields) is None


@pytest.mark.parametrize("mode", ["greedy", "hdrf"])
@pytest.mark.parametrize("k", [8, 32, 256, 4096])
def test_k3_rungs(cuda, mode, k):
    """One row a rung (``scoring_plan``: shared at k = 8, 32, 256; global at
    4,096): insert from a warm state then retract, on R-MAT edges with
    self-loops and the (0, 0) padding of a last chunk."""
    from repro_torch.kernels.stream_scan import scoring_chunk_oracle, scoring_scan
    from repro_torch.kernels.stream_scan.plan import scoring_plan

    assert scoring_plan(k).rung == ("global" if k == 4096 else "shared")
    E = MAIN_CHUNK if k <= 32 else 1 << 14
    src, dst, n = _graph(scale=14 if k < 4096 else 12, seed=5)
    src, dst = src[:E].copy(), dst[:E].copy()
    src[::101] = dst[::101]
    pad = 37
    src[-pad:] = 0
    dst[-pad:] = 0
    hdrf = mode == "hdrf"
    load, rep, pd = _scoring_state(n, k, np.random.default_rng(k), hdrf=hdrf)
    s, d = torch.from_numpy(src), torch.from_numpy(dst)
    kw = dict(mode=mode, k_active=k - 3 if hdrf else None)
    lam = 1.1 if hdrf else None
    names = ("parts", "load", "rep", "pd")
    want = scoring_chunk_oracle(s, d, load.clone(), rep.clone(),
                                pd.clone() if hdrf else None, lam, **kw)
    twice = []
    for _ in range(2):
        twice.append(scoring_scan(s.to(cuda), d.to(cuda), load.to(cuda), rep.to(cuda),
                                  pd.to(cuda) if hdrf else None, lam, **kw))
    torch.cuda.synchronize()
    assert _first_diff(twice[0], want, names) is None
    assert _first_diff(twice[1], [t.cpu() if t is not None else None
                                  for t in twice[0]], names) is None
    nv = E - pad
    back_want = scoring_chunk_oracle(s, d, *want[1:3], want[3], mode=mode, sign=-1,
                                     parts=want[0], n_valid=nv)
    back = scoring_scan(s.to(cuda), d.to(cuda), *twice[0][1:3], twice[0][3], mode=mode,
                        sign=-1, parts=twice[0][0], n_valid=nv)
    torch.cuda.synchronize()
    assert _first_diff(back, back_want, names) is None


def test_k1_k3_shared_bytes_match_plan(cuda):
    """The C sources lay out the bytes that ``plan`` sizes the tiles by."""
    from repro_torch.kernels.stream_scan import kernel as K
    from repro_torch.kernels.stream_scan import plan

    assert K._lib().cluster_smem_bytes(plan.K1_TILE) == plan.cluster_smem_bytes(plan.K1_TILE)
    for k in (1, 5, 8, 32, 100, 256, 880, 900, 4096):
        p = plan.scoring_plan(k)
        tile = p.tile if p.rung == "shared" else 0
        assert K._scoring_lib().scoring_smem_bytes(k, tile) == p.smem_bytes <= plan.SHARED_MEM_BYTES


def test_latency_probe(cuda):
    from repro_torch.kernels.stream_scan.latency import latency_bound_ms, measure_round_trips

    rt = measure_round_trips(steps=1 << 16, reps=2)
    for name in ("shared", "shuffle", "redux"):
        assert 1 < rt[f"{name}_ns"] < 200 and 5 < rt[f"{name}_cycles"] < 400
    assert latency_bound_ms("K1", 4096, rt) > 0


@pytest.mark.parametrize("name", ["grid", "greedy", "hdrf", "2ps-l"])
def test_baselines_cuda_equal_cpu(cuda, name):
    from repro_torch.core.baselines import PARTITIONERS
    from repro_torch.graphs import community_graph

    src, dst, n = community_graph(1000, n_communities=16, avg_degree=6, seed=2)
    kw = {} if name == "2ps-l" else {"chunk_size": 1500}  # several chunks
    gpu = PARTITIONERS[name](src, dst, n, 8, 0, device=cuda, **kw)
    cpu = PARTITIONERS[name](src, dst, n, 8, 0, device="cpu", **kw)
    assert torch.equal(gpu.cpu(), cpu)


def _k5_inputs(V, d, seed, hub=100_000):
    """A power-law-ish edge list with a hub row of ``hub`` edges, empty
    rows, ``dst = -1`` padding and ``n_rows > max(dst) + 1``."""
    rng = np.random.default_rng(seed)
    E = hub + 20 * V
    dst = np.concatenate([np.full(hub, 3), rng.integers(0, V // 2, E - hub)]).astype(np.int32)
    rng.shuffle(dst)
    dst[::97] = -1
    src = rng.integers(0, V, E).astype(np.int32)
    x = (rng.standard_normal((V, d)) * np.exp(rng.uniform(-8, 8, (V, d)))).astype(np.float32)
    w = rng.standard_normal(E).astype(np.float32)
    return x, src, dst, w, V + 17


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 7, 16, 100])
def test_k5_segment_agg(cuda, d, dtype):
    from repro_torch.kernels.segment_agg import launch_counts, segment_agg, segment_layout

    x, src, dst, w, n_rows = _k5_inputs(5000, d, seed=d)
    xt = torch.from_numpy(x).to(dtype)
    want = segment_agg(xt, segment_layout(src, dst, n_rows, w, device="cpu"))
    lay = segment_layout(src, dst, n_rows, w, device=cuda)
    before = launch_counts()["segment_agg"]
    got = segment_agg(xt.to(cuda), lay)
    torch.cuda.synchronize()
    assert launch_counts()["segment_agg"] == before + 1
    assert got.dtype == dtype and got.shape == (n_rows, d)
    assert torch.equal(got.cpu(), want)  # bitwise: same order, same rounding
    assert not got[n_rows - 17:].any() and not got[5000 // 2:5000].any()


def test_k5_refuses_other_dtypes(cuda):
    from repro_torch.kernels.segment_agg import segment_agg, segment_layout

    lay = segment_layout([0, 1], [1, 0], 2, device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        segment_agg(torch.ones(2, 3, dtype=torch.float64, device=cuda), lay)


def _k5_long_inputs(d, seed):
    """Rows of 392,195 (the served graph's hub row), 2T, T + 1, T and T − 1
    edges, one layout, among 3,000 short rows; x spans 16 binades."""
    from repro_torch.kernels.segment_agg import LONG_ROW_EDGES as T

    rng = np.random.default_rng(seed)
    V = 3000
    lengths = {5: 392_195, 9: 2 * T, 17: T + 1, 33: T, 65: T - 1}
    rest = np.setdiff1d(np.arange(V), list(lengths))  # ~20 edges a row
    dst = np.concatenate([np.full(m, r) for r, m in lengths.items()]
                         + [rng.choice(rest, 20 * V)]).astype(np.int32)
    rng.shuffle(dst)
    src = rng.integers(0, V, dst.size).astype(np.int32)
    x = (rng.standard_normal((V, d)) * np.exp(rng.uniform(-8, 8, (V, d)))).astype(np.float32)
    w = rng.standard_normal(dst.size).astype(np.float32)
    return x, src, dst, w, V


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 7, 16, 33, 100])
def test_k5_long_rows(cuda, d, dtype):
    """Long rows of every kind in one launch, bitwise equal to the plain
    version; float products take the chain."""
    from repro_torch.kernels.segment_agg import (LONG_ROW_EDGES, launch_counts, segment_agg,
                                                 segment_layout)

    x, src, dst, w, V = _k5_long_inputs(d, seed=100 + d)
    xt = torch.from_numpy(x).to(dtype)
    want = segment_agg(xt, segment_layout(src, dst, V, w, device="cpu"))
    lay = segment_layout(src, dst, V, w, device=cuda)
    counts = np.bincount(dst, minlength=V)
    assert counts[[17, 33, 65]].tolist() == [LONG_ROW_EDGES + 1, LONG_ROW_EDGES, LONG_ROW_EDGES - 1]
    assert lay.long_rows.tolist() == [5, 9, 17]
    flags = torch.full((lay.long_rows.numel(),), -1, dtype=torch.int32, device=cuda)
    before = launch_counts()["segment_agg"]
    got = segment_agg(xt.to(cuda), lay, tree_flags=flags)
    torch.cuda.synchronize()
    assert launch_counts()["segment_agg"] == before + 1
    assert torch.equal(got.cpu(), want)
    assert flags.tolist() == [0] * lay.long_rows.numel()


def _tree_case(name, T):
    """One long row (row 1 of 4) of more than T edges, d = 1, with products
    on either side of the tree's rule.  n divides 2**24 − 1, so n equal
    products c sum to 2**24 − 1 with n·max|p| < 2**24: the tree."""
    n = next(m for m in range(T + 1, 2**24) if (2**24 - 1) % m == 0)
    c = (2**24 - 1) // n
    x = np.ones((n, 1), np.float32)
    w = np.ones(n, np.float32)
    if name == "sum_2^24-1":
        w[:] = c
    elif name == "sum_2^24+1":  # one product c + 2: n·max|p| > 2**24, the chain
        w[:] = c
        w[100] = c + 2
    elif name == "inf":
        x[7] = np.inf
    elif name == "nan":
        x[7] = np.nan
    elif name == "neg_zero":
        w[:] = -0.0
    return x, np.arange(n, dtype=np.int32), np.ones(n, np.int32), w, n


@pytest.mark.parametrize("name,tree", [("sum_2^24-1", 1), ("sum_2^24+1", 0), ("inf", 0),
                                       ("nan", 0), ("neg_zero", 1), ("degrees", 1)])
def test_k5_tree_and_chain_routes(cuda, name, tree):
    """Both long-row routes, bitwise equal to the plain version; the route
    K5 took is the one :func:`tree_exact` gives on the CPU."""
    from repro_torch.kernels.segment_agg import (LONG_ROW_EDGES, segment_agg, segment_layout,
                                                 tree_exact)

    x, src, dst, w, n = _tree_case(name, LONG_ROW_EDGES)
    assert n > LONG_ROW_EDGES
    xt = torch.from_numpy(x)
    cpu_lay = segment_layout(src, dst, 4, w, device="cpu")
    want = segment_agg(xt, cpu_lay)
    products = xt[cpu_lay.src.long()] * cpu_lay.w[:, None]
    assert bool(tree_exact(products).all()) == bool(tree)
    lay = segment_layout(src, dst, 4, w, device=cuda)
    flags = torch.full((1,), -1, dtype=torch.int32, device=cuda)
    got = segment_agg(xt.to(cuda), lay, tree_flags=flags)
    torch.cuda.synchronize()
    assert flags.tolist() == [tree]
    if name == "nan":  # the card's float units return the canonical NaN, the CPU its input's
        assert torch.isnan(got.cpu()).equal(torch.isnan(want)) and bool(torch.isnan(want[1]))
        got, want = got.cpu().nan_to_num(), want.nan_to_num()
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


def test_k5_tree_columns_mixed(cuda):
    """d = 33: integer columns pass, one float column fails, so the row
    runs the chain; all columns integer, it takes the tree."""
    from repro_torch.kernels.segment_agg import LONG_ROW_EDGES, segment_agg, segment_layout

    rng = np.random.default_rng(7)
    n, V = 3 * LONG_ROW_EDGES, 500
    src = rng.integers(0, V, n).astype(np.int32)
    dst = np.zeros(n, np.int32)
    x = rng.integers(-64, 64, (V, 33)).astype(np.float32)
    w = rng.integers(-8, 8, n).astype(np.float32)
    for float_col, tree in ((True, 0), (False, 1)):
        xc = x.copy()
        if float_col:
            xc[:, 20] = rng.standard_normal(V)
        xt = torch.from_numpy(xc)
        want = segment_agg(xt, segment_layout(src, dst, 1, w, device="cpu"))
        flags = torch.zeros(1, dtype=torch.int32, device=cuda)
        got = segment_agg(xt.to(cuda), segment_layout(src, dst, 1, w, device=cuda),
                          tree_flags=flags)
        torch.cuda.synchronize()
        assert flags.tolist() == [tree]
        assert torch.equal(got.cpu(), want)


def test_compute_delta_cuda_equals_cpu_above_2_24(cuda):
    """The game's δ on the card equals the CPU's bits where Σ(degs + sizes)
    passes 2**24 (Θ and the sizes scaled by 3001), and so does the game."""
    from repro_torch.core import clustering as cl
    from repro_torch.core import game as tgame
    from repro_torch.core.s5p import cluster_statistics
    from repro_torch.graphs import community_graph

    src, dst, n = community_graph(600, n_communities=8, avg_degree=6, seed=3)
    s, d = torch.from_numpy(src).int(), torch.from_numpy(dst).int()
    deg = cl.compute_degrees(s, d, n)
    xi, kappa = int(2.0 * src.size / n), max(int(np.ceil(2.0 * src.size / 8)), 2)
    res = cl.compact_clusters(cl.cluster_stream(s, d, n, xi=xi, kappa=kappa, device="cpu"),
                              deg, xi)
    sizes, pa, pb, pw, _ = cluster_statistics(s, d, res, deg, xi, use_cms=True,
                                              cms_epsilon=0.1, cms_nu=0.01, seed=0)
    C = res.n_clusters
    inputs = tgame.GameInputs(sizes=sizes * 3001, pair_a=pa, pair_b=pb, pair_w=pw * 3001,
                              n_head=res.n_head, k=8)
    assert float((tgame._cluster_degrees(inputs, C) + inputs.sizes).double().sum()) > 2**24
    on = tgame.GameInputs(*(t.to(cuda) for t in inputs[:4]), inputs.n_head, 8)
    d_cpu = tgame.compute_delta(inputs.sizes, tgame._cluster_degrees(inputs, C), 8)
    d_gpu = tgame.compute_delta(on.sizes, tgame._cluster_degrees(on, C), 8)
    assert d_cpu.view(torch.int32).item() == d_gpu.cpu().view(torch.int32).item() == 0x371B42D7
    kw = dict(batch_size=tgame.default_batch_size(256, C), accept_prob=0.9, seed=3)
    cpu, gpu = tgame.run_game(inputs, C, **kw), tgame.run_game(on, C, **kw)
    assert torch.equal(gpu.assignment.cpu(), cpu.assignment) and gpu.rounds == cpu.rounds


def test_cluster_degrees_cuda_equal_cpu_above_2_24(cuda):
    """The game's cluster degrees run on K5 on the card, in the CPU's (the
    reference's) order, where atomics would round differently."""
    from repro_torch.core import game as tgame
    from repro_torch.kernels.segment_agg import launch_counts

    rng = np.random.default_rng(3)
    C = 50
    a, b = rng.integers(0, C, 200_000), rng.integers(0, C, 200_000)
    a, b = np.minimum(a, b)[a != b], np.maximum(a, b)[a != b]
    w = (rng.integers(1, 3000, a.size) * rng.choice([1, 7, 4099], a.size)).astype(np.float32)
    t = [torch.from_numpy(v) for v in (rng.integers(1, 100, C).astype(np.float32),
                                         a.astype(np.int32), b.astype(np.int32), w)]
    cpu = tgame.GameInputs(*t, 5, 8)
    gpu = tgame.GameInputs(*(v.to(cuda) for v in t), 5, 8)
    want = tgame._cluster_degrees(cpu, C)
    before = launch_counts()["segment_agg"]
    got = tgame._cluster_degrees(gpu, C)
    torch.cuda.synchronize()
    assert launch_counts()["segment_agg"] == before + 2
    assert float(want.max()) > 2**24 and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("masked", [False, True])
def test_gcn_forward_cuda_equals_cpu(cuda, masked):
    """Only ``x @ W`` differs (cuBLAS against the CPU's BLAS, both in full
    float32): rtol 1e-4, atol 1e-5."""
    from repro_torch import random as trandom
    from repro_torch.graphs import ogbn_products_like, products_features
    from repro_torch.kernels.segment_agg import launch_counts
    from repro_torch.models.gnn import GCNConfig, gcn_forward, gcn_init

    g = ogbn_products_like(seed=0, scale=2e-3)
    n = g.n_vertices
    cfg = GCNConfig(n_layers=2, d_hidden=16, d_feat=100, n_classes=7)
    feats = products_features(np.arange(n), 100, seed=0)
    mask = (np.random.default_rng(0).random(g.src.size) < 0.9).astype(np.float32) \
        if masked else None
    params = gcn_init(cfg, trandom.PRNGKey(0), device="cpu")
    want = gcn_forward(params, feats, g.src, g.dst, n, cfg, mask, device="cpu")
    before = launch_counts()["segment_agg"]
    got = gcn_forward(params, feats, g.src, g.dst, n, cfg, mask, device=cuda)
    torch.cuda.synchronize()
    assert launch_counts()["segment_agg"] == before + 6
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("layout", ["by_dst", "by_src", "message"])
def test_k5_transposed_bitwise_and_repeats(cuda, layout):
    """The gradient of a sum through K5 is K5 over the transposed layout
    (K5ᵀ, counted apart): bitwise the CPU's gradient (the plain version over
    the same transposed layout), equal bits on two backwards.  GCN's two
    layouts (by destination, by source) carry weights made on the host, as
    the CPU's and the card's ``rsqrt`` differ by an ulp."""
    from repro_torch.graphs import ogbn_products_like
    from repro_torch.kernels.segment_agg import launch_counts, segment_agg, segment_layout
    from repro_torch.models.gnn import message_layout

    g = ogbn_products_like(seed=0, scale=2e-3)
    n, d = g.n_vertices, 16
    rng = np.random.default_rng(4)
    w = rng.random(g.src.size).astype(np.float32)
    rows = g.src.size if layout == "message" else n
    x = torch.from_numpy(rng.standard_normal((rows, d), np.float32))
    dout = torch.from_numpy(rng.standard_normal((n, d), np.float32))
    grads = {}
    for dev in ("cpu", cuda):
        if layout == "message":
            lay = message_layout(g.dst, n, device=dev)
        elif layout == "by_dst":
            lay = segment_layout(g.src, g.dst, n, w, device=dev)
        else:
            lay = segment_layout(g.dst, g.src, n, w, device=dev)
        outs = []
        for _ in range(2):
            xr = x.to(dev).detach().clone().requires_grad_()
            before = launch_counts()["segment_agg_transposed"]
            segment_agg(xr, lay).backward(dout.to(dev))
            if dev != "cpu":
                torch.cuda.synchronize()
                assert launch_counts()["segment_agg_transposed"] == before + 1
            outs.append(xr.grad.cpu())
        assert torch.equal(outs[0], outs[1])
        grads[str(dev)] = outs[0]
    assert torch.equal(grads["cuda"], grads["cpu"])


def test_gcn_loss_gradient_cuda_equals_cpu(cuda, highest_f32):
    """The K5 repair's pin: a GCN loss on the card has a gradient for every
    weight (before the repair K5's output had no ``grad_fn`` on the card),
    equal to the CPU's within rtol 1e-4, atol 1e-6 (``x @ W`` in cuBLAS
    against the CPU's BLAS; the sums and their gradients are bitwise)."""
    from repro_torch import random as trandom
    from repro_torch.graphs import ogbn_products_like, products_features
    from repro_torch.kernels.segment_agg import launch_counts
    from repro_torch.models.gnn import GCNConfig, gcn_init, gcn_loss

    g = ogbn_products_like(seed=0, scale=2e-3)
    n = g.n_vertices
    cfg = GCNConfig(n_layers=2, d_hidden=16, d_feat=100, n_classes=7)
    batch = {"feats": products_features(np.arange(n), 100, seed=0), "edge_src": g.src,
             "edge_dst": g.dst, "labels": np.random.default_rng(0).integers(0, 7, n)}
    grads = {}
    for dev in ("cpu", cuda):
        params = gcn_init(cfg, trandom.PRNGKey(0), device=dev)
        for layer in params["layers"]:
            layer["w"].requires_grad_()
        b = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        before = launch_counts()["segment_agg_transposed"]
        loss, _ = gcn_loss(params, b, cfg, device=dev)
        loss.backward()
        if dev != "cpu":
            torch.cuda.synchronize()
            assert launch_counts()["segment_agg_transposed"] == before + 4
        grads[str(dev)] = [layer["w"].grad.cpu() for layer in params["layers"]]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        assert torch.isfinite(a).all() and a.abs().max() > 0
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("arch,shape", [
    ("gcn-cora", "full_graph_sm"), ("gcn-cora", "molecule"), ("schnet", "molecule"),
    ("egnn", "molecule"), ("dimenet", "molecule"), ("xdeepfm", "train_batch"),
    ("llama3-8b", "train_4k"),
])
def test_train_step_cuda_equals_cpu(cuda, highest_f32, arch, shape):
    """One AdamW step of each family's smoke training cell, float32 (the LM
    cast from bf16), on cuda against cpu from the same state and batch: the
    first moment ``mu`` (0.1 × the clipped gradient) of every leaf within
    1e-4 of its largest magnitude (1e-3 for the LM, whose smoke weights make
    its attention nearly one-hot: tests/test_torch_train.py), the loss
    within rtol 1e-5; two steps on
    the card from the same state give the same bits.  (The MoE's combine
    adds with ``index_add_``, atomics on the card: Mixtral's step is held
    on the CPU only, tests/test_torch_train.py.)"""
    import dataclasses

    from repro_torch import random as trandom
    from repro_torch.launch import cells
    from repro_torch.streaming.carry import tree_flatten

    def build(dev):
        cell = cells.build_cell(arch, shape, smoke=True, device=dev)
        if cell.arch == "llama3-8b":
            spec = cells.get_arch(arch)
            cfg = dataclasses.replace(spec.smoke_config, dtype=torch.float32)
            cell = cells._lm_cell(spec, shape, dict(seq=64, batch=2, kind="lm_train"), cfg,
                                  torch.device(dev))
        return cell

    key = trandom.PRNGKey(0)
    out = {}
    for dev in ("cpu", "cuda"):
        cell = build(dev)
        runs = []
        for _ in range(2 if dev == "cuda" else 1):
            state = cell.init_state(key)
            new, metrics = cell.step_fn(state, *cell.make_batch(trandom.fold_in(key, 0)))
            runs.append(([t.cpu() for t in tree_flatten(new.mu)[0]],
                         float(metrics["loss"])))
        if dev == "cuda":
            assert all(torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))
            assert runs[0][1] == runs[1][1]
        out[dev] = runs[0]
    assert out["cuda"][1] == pytest.approx(out["cpu"][1], rel=1e-5)
    for a, b in zip(out["cuda"][0], out["cpu"][0]):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max() <= (1e-3 if arch == "llama3-8b" else 1e-4) * b.abs().max()


def _gnn3d_batch(n_mol, n_atoms, n_edges, pad_nodes=0):
    """``molecule_batch`` flattened with ``graph_idx``, padded nodes masked,
    triplets capped at 4E (as ``chip_smoke.py``'s molecule batch)."""
    from repro_torch.graphs import molecule_batch
    from repro_torch.models.gnn import build_triplets

    mb = molecule_batch(n_mol, n_atoms, n_edges, seed=0)
    V, E = n_mol * n_atoms + pad_nodes, n_mol * n_edges
    off = (np.arange(n_mol) * n_atoms)[:, None]
    pos = np.zeros((V, 3), np.float32)
    pos[:n_mol * n_atoms] = mb.positions.reshape(-1, 3)
    species = np.zeros(V, np.int32)
    species[:n_mol * n_atoms] = mb.species.reshape(-1)
    es, ed = (mb.edge_src + off).reshape(-1), (mb.edge_dst + off).reshape(-1)
    graph_idx = np.zeros(V, np.int32)
    graph_idx[:n_mol * n_atoms] = np.repeat(np.arange(n_mol), n_atoms)
    kj, ji, tm = build_triplets(es, ed, 4 * E)
    return {"species": species, "positions": pos, "edge_src": es.astype(np.int32),
            "edge_dst": ed.astype(np.int32), "edge_mask": np.ones(E, np.float32),
            "node_mask": (np.arange(V) < n_mol * n_atoms).astype(np.float32),
            "graph_idx": graph_idx, "n_graphs": n_mol, "targets": mb.energies,
            "tri_kj": kj, "tri_ji": ji, "tri_mask": tm}


@pytest.mark.parametrize("which", ["smoke_config", "molecule"])
@pytest.mark.parametrize("name", ["schnet", "egnn", "dimenet"])
def test_gnn3d_forward_cuda_equals_cpu(cuda, name, which):
    """Each model on the card against its CPU forward (plain K5): the smoke
    config on 4 small molecules, the published config at the ``molecule``
    shape (128 × 30 atoms padded to 4,096 nodes, 8,192 edges).  Energies
    within 1e-4 of their largest magnitude (``chip_smoke.GNN3D_TOL``), the
    loss within a relative 1e-4, K5 launched as the docstrings state."""
    from repro_torch import random as trandom
    from repro_torch.configs import get_arch
    from repro_torch.kernels.segment_agg import launch_counts
    from repro_torch.models import gnn

    cfg = get_arch(name).config if which == "molecule" else get_arch(name).smoke_config
    b = _gnn3d_batch(128, 30, 64, pad_nodes=256) if which == "molecule" else \
        _gnn3d_batch(4, 9, 16, pad_nodes=3)
    init = {"schnet": gnn.schnet_init, "egnn": gnn.egnn_init, "dimenet": gnn.dimenet_init}
    loss = {"schnet": gnn.schnet_loss, "egnn": gnn.egnn_loss, "dimenet": gnn.dimenet_loss}
    params = init[name](cfg, trandom.PRNGKey(0), device="cpu")
    want, want_aux = loss[name](params, b, cfg, device="cpu")
    on_card = {k: v if isinstance(v, int) else torch.as_tensor(v).to(cuda) for k, v in b.items()}
    params_card = torch.utils._pytree.tree_map(lambda t: t.to(cuda), params)
    before = launch_counts()["segment_agg"]
    got, got_aux = loss[name](params_card, on_card, cfg, device=cuda)
    torch.cuda.synchronize()
    n = {"schnet": lambda: cfg.n_interactions, "egnn": lambda: 1 + 2 * cfg.n_layers,
         "dimenet": lambda: 2 * cfg.n_blocks}[name]()
    assert launch_counts()["segment_agg"] - before == n + 1
    assert float(got) == pytest.approx(float(want), rel=1e-4)
    assert float(got_aux["mae"]) == pytest.approx(float(want_aux["mae"]), rel=1e-4)
    fwd = {"schnet": gnn.schnet_forward, "egnn": gnn.egnn_forward}
    kw = dict(edge_mask=b["edge_mask"], node_mask=b["node_mask"], graph_idx=b["graph_idx"],
              n_graphs=b["n_graphs"])
    args = (b["species"], b["positions"], b["edge_src"], b["edge_dst"])
    if name == "dimenet":
        e_cpu = gnn.dimenet_forward(params, *args, b["tri_kj"], b["tri_ji"],
                                    b["species"].size, cfg, tri_mask=b["tri_mask"], **kw,
                                    device="cpu")
        e_card = gnn.dimenet_forward(params_card, *args, b["tri_kj"], b["tri_ji"],
                                     b["species"].size, cfg, tri_mask=b["tri_mask"], **kw,
                                     device=cuda)
    else:
        e_cpu = fwd[name](params, *args, b["species"].size, cfg, **kw, device="cpu")
        e_card = fwd[name](params_card, *args, b["species"].size, cfg, **kw, device=cuda)
    assert e_card.shape == e_cpu.shape == (b["n_graphs"],)
    torch.testing.assert_close(e_card.cpu(), e_cpu, rtol=0,
                               atol=1e-4 * float(e_cpu.abs().max()))


@pytest.mark.parametrize("d", [3, 64, 128])
def test_k5_message_layouts_bitwise(cuda, d):
    """The models' identity-source layouts (message e into row idx[e],
    weights 1) with a padded row of 5,000 masked zeros: K5 against the
    plain version, bitwise."""
    from repro_torch.kernels.segment_agg import segment_agg
    from repro_torch.models.gnn import message_layout

    rng = np.random.default_rng(d)
    E, n = 20_000, 3_000
    idx = rng.integers(0, n, E).astype(np.int32)
    idx[-5_000:] = 0
    x = (rng.standard_normal((E, d)) * 10.0 ** rng.integers(-3, 4, (E, 1))).astype(np.float32)
    x[-5_000:] = 0.0
    xt = torch.from_numpy(x)
    want = segment_agg(xt, message_layout(idx, n, device="cpu"))
    got = segment_agg(xt.to(cuda), message_layout(idx, n, device=cuda))
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))

def _k6_inputs(BK, S, T, G, hd, dtype, seed, *, rolling=False, pad_keys=0):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((BK, S, G * hd), np.float32)).to(dtype)
    k = torch.from_numpy(rng.standard_normal((BK, T, hd), np.float32)).to(dtype)
    v = torch.from_numpy(rng.standard_normal((BK, T, hd), np.float32)).to(dtype)
    qp = np.broadcast_to(np.arange(T - S, T, dtype=np.int32), (BK, S)).copy()
    kp = np.broadcast_to(np.arange(T, dtype=np.int32), (BK, T)).copy()
    if rolling:  # a rolled cache: slots hold positions out of order
        kp = np.roll(kp, 37, axis=1)
    if pad_keys:  # the first keys of every row are padding (never a query's only key)
        kp[:, :pad_keys] = -(2**30)
    return q, k, v, torch.from_numpy(qp), torch.from_numpy(kp)


@pytest.fixture
def highest_f32():
    """The plain version's float32 products in full float32 (no TF32)."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev[0]
    torch.set_float32_matmul_precision(prev[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("G,window,causal,case", [
    (4, None, True, "plain"), (5, None, True, "plain"), (1, 64, True, "plain"),
    (2, None, True, "ragged"), (3, 48, True, "rolling"), (2, 40, False, "padded"),
    (4, None, True, "long"), (2, 300, True, "long"),
])
def test_k6_flash_attention(cuda, highest_f32, dtype, hd, G, window, causal, case):
    """K6 against ``flash_attention_ref`` over K6's key tiles on the same
    card tensors: atol 2e-5 in float32 and 2e-2 in bfloat16
    (tests/test_kernels.py's flash sweep): the kernel sums in another order
    and takes exp2 of log2e-scaled differences."""
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_attention_ref, launch_counts)
    from repro_torch.kernels.flash_attention.kernel import KEY_TILE

    S, T = {"ragged": (77, 141), "long": (1000, 1000)}.get(case, (192, 192))
    q, k, v, qp, kp = _k6_inputs(3, S, T, G, hd, dtype, seed=hd + G,
                                 rolling=case == "rolling",
                                 pad_keys=5 if case == "padded" else 0)
    args = [t.to(cuda) for t in (q, k, v, qp, kp)]
    before = launch_counts()["flash_attention"]
    got = flash_attention_fwd(*args, causal=causal, window=window)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == before + 1
    want = flash_attention_ref(*args, causal=causal, window=window, block_k=KEY_TILE[dtype])
    assert got.dtype == dtype and got.shape == q.shape
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


def test_k6_model_layout_and_refusals(cuda, highest_f32):
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_fwd

    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((2, 100, 8, 64), np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 100, 2, 64), np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 100, 2, 64), np.float32))
    pos = torch.arange(100, dtype=torch.int32).expand(2, 100)
    want = flash_attention(q, k, v, pos, pos, causal=True, window=None)
    got = flash_attention(q.to(cuda), k.to(cuda), v.to(cuda), pos.to(cuda), pos.to(cuda),
                          causal=True, window=None)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=2e-5)
    small = [t.to(cuda) for t in _k6_inputs(1, 8, 8, 1, 8, torch.float32, 0)]
    with pytest.raises(ValueError, match="d_head"):
        flash_attention_fwd(*small)
    half = [t.to(cuda) for t in _k6_inputs(1, 8, 8, 1, 16, torch.float16, 0)]
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention_fwd(*half)
    bq, bk_, bv, bqp, bkp = [t.to(cuda) for t in _k6_inputs(1, 8, 8, 1, 16, torch.bfloat16, 0)]
    shifted = torch.empty(bq.numel() + 1, dtype=torch.bfloat16, device=cuda)[1:].view(bq.shape)
    shifted.copy_(bq)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_fwd(shifted, bk_, bv, bqp, bkp)
    # a gradient through K6 runs K6b (counted once), never a plain version
    from repro_torch.kernels.flash_attention import launch_counts

    x = torch.ones(1, 16, 32, device=cuda, requires_grad=True)
    p16 = torch.arange(16, dtype=torch.int32, device=cuda)[None]
    out = flash_attention_fwd(x, x.detach(), x.detach(), p16, p16)
    before = launch_counts()["flash_attention_bwd"]
    out.sum().backward()
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention_bwd"] == before + 1
    assert torch.isfinite(x.grad).all()


@pytest.mark.parametrize("dtype,hd,G,S,T,window,causal,pad", [
    (torch.float32, 32, 3, 77, 141, 48, True, 0), (torch.float32, 16, 2, 100, 100, None,
                                                   False, 5),
    (torch.float32, 128, 4, 130, 130, None, True, 0), (torch.float32, 64, 1, 65, 65, 17, True, 0),
    (torch.bfloat16, 128, 4, 256, 256, None, True, 0), (torch.bfloat16, 64, 2, 200, 300, 64,
                                                        True, 3),
    (torch.bfloat16, 128, 4, 4096, 4096, None, True, 0), (torch.bfloat16, 32, 2, 64, 64, None,
                                                          True, 0),
    (torch.bfloat16, 16, 3, 77, 141, 48, True, 5),
    # the edges of K6b's bf16 tiles (64 rows a dK/dV stage, 128 keys a block,
    # 128 rows a dQ block): S·G and T off every tile size, at each hd
    (torch.bfloat16, 128, 3, 77, 141, None, True, 0), (torch.bfloat16, 64, 5, 51, 200, 70,
                                                       True, 0),
    (torch.bfloat16, 32, 1, 63, 129, None, False, 0), (torch.bfloat16, 16, 4, 200, 255, None,
                                                       True, 9),
    (torch.bfloat16, 128, 8, 130, 130, 33, True, 0),
])
def test_k6b_against_plain_version_and_repeats(cuda, highest_f32, dtype, hd, G, S, T, window,
                                               causal, pad):
    """K6b against ``flash_attention_bwd_ref`` on the same card tensors (q,
    k, v, K6's out and lse, dout): the largest error of each gradient at
    most 1e-5 (float32) or 2^-6 (bfloat16: p and ds are rounded to bf16
    from scores summed in another order) of its largest magnitude; two
    launches give the same bits."""
    from repro_torch.kernels.flash_attention import launch_counts
    from repro_torch.kernels.flash_attention.kernel import _k6, flash_attention_bwd
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref

    BK = 2 if S < 4096 else 4
    q, k, v, qp, kp = (t.to(cuda) for t in _k6_inputs(BK, S, T, G, hd, dtype, seed=hd + S,
                                                      pad_keys=pad))
    out, lse = _k6(q, k, v, qp, kp, causal, window, True)
    dout = torch.randn(q.shape, generator=torch.Generator(cuda).manual_seed(1), device=cuda
                       ).to(dtype)
    before = launch_counts()["flash_attention_bwd"]
    got = flash_attention_bwd(q, k, v, out, lse, dout, qp, kp, causal=causal, window=window)
    again = flash_attention_bwd(q, k, v, out, lse, dout, qp, kp, causal=causal, window=window)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention_bwd"] == before + 2
    want = flash_attention_bwd_ref(q, k, v, out, lse, dout, qp, kp, causal=causal,
                                   window=window, block_q=256, block_k=512)
    limit = 2**-6 if dtype == torch.bfloat16 else 1e-5
    for a, b, c in zip(got, again, want):
        assert a.dtype == dtype and a.shape == c.shape
        assert torch.equal(a, b)
        err = (a.float() - c.float()).abs().max() / c.float().abs().max()
        assert err <= limit, float(err)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd,G,S,T,window,pad", [(128, 4, 300, 700, None, 0),
                                                 (64, 2, 97, 513, 200, 40),
                                                 (128, 4, 64, 1024, None, 300)])
def test_k6b_rolled_and_padded_positions(cuda, highest_f32, dtype, hd, G, S, T, window, pad):
    """K6b with BK = 3 over a rolled cache (slots out of position order) and
    padded keys, where the position-range classes of both kernels decide
    which tiles run: within the limits of ``test_k6b_against_plain_version_
    and_repeats`` of ``flash_attention_bwd_ref``, the same bits twice."""
    from repro_torch.kernels.flash_attention.kernel import _k6, flash_attention_bwd
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref

    q, k, v, qp, kp = (t.to(cuda) for t in _k6_inputs(3, S, T, G, hd, dtype, seed=S + T,
                                                      rolling=True, pad_keys=pad))
    out, lse = _k6(q, k, v, qp, kp, True, window, True)
    dout = torch.randn(q.shape, generator=torch.Generator(cuda).manual_seed(3), device=cuda
                       ).to(dtype)
    got = flash_attention_bwd(q, k, v, out, lse, dout, qp, kp, causal=True, window=window)
    again = flash_attention_bwd(q, k, v, out, lse, dout, qp, kp, causal=True, window=window)
    want = flash_attention_bwd_ref(q, k, v, out, lse, dout, qp, kp, causal=True, window=window,
                                   block_q=128, block_k=256)
    limit = 2**-6 if dtype == torch.bfloat16 else 1e-5
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, b)
        err = (a.float() - c.float()).abs().max() / c.float().abs().max()
        assert err <= limit, float(err)


@pytest.mark.parametrize("model_layout", [False, True])
def test_k6_gradient_through_the_model_layout(cuda, highest_f32, model_layout):
    """``models.attention.flash_attention`` trains on the card: float32
    gradients of q, k and v within 1e-5 of their largest magnitude of the
    CPU's (the plain versions), K6 once and K6b once."""
    from repro_torch.kernels.flash_attention import launch_counts
    from repro_torch.models.attention import flash_attention

    rng = np.random.default_rng(3)
    B, S, H, KV, hd = 2, 90, 8, 2, 32
    arrays = [rng.standard_normal(s, np.float32) for s in
              ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd), (B, S, H, hd))]
    pos = torch.arange(S, dtype=torch.int32).expand(B, S)
    grads = {}
    for dev in ("cpu", cuda):
        q, k, v = (torch.from_numpy(a).to(dev).requires_grad_() for a in arrays[:3])
        p = pos.to(dev)
        before = launch_counts()
        out = flash_attention(q, k, v, p, p, True, 40 if model_layout else None, 32, 64)
        out.backward(torch.from_numpy(arrays[3]).to(dev))
        if dev != "cpu":
            torch.cuda.synchronize()
            after = launch_counts()
            assert after["flash_attention"] == before["flash_attention"] + 1
            assert after["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
        grads[str(dev)] = [t.grad.cpu() for t in (q, k, v)]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen2.5-14b", "qwen3-14b"])
def test_lm_prefill_and_decode_cuda_equal_cpu(cuda, highest_f32, arch):
    """The smoke configs in float32: prefill through K6 (one launch per
    layer) and decode on cuda against cpu, atol 2e-3, rtol 1e-3 (the
    reference's decode-against-forward tolerance)."""
    import dataclasses

    from repro_torch import random as trandom
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import launch_counts
    from repro_torch.models import lm as LM

    cfg = dataclasses.replace(get_arch(arch).smoke_config, dtype=torch.float32)
    params = LM.init_params(cfg, trandom.PRNGKey(0), device="cpu")
    toks = trandom.randint(trandom.PRNGKey(1), (2, 40), 0, cfg.vocab)
    want, cache = LM.prefill(params, toks, cfg, max_seq=48, device="cpu")
    gparams = _to(params, cuda)
    before = launch_counts()["flash_attention"]
    got, gcache = LM.prefill(gparams, toks.to(cuda), cfg, max_seq=48, device=cuda)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == before + cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=2e-3)
    nxt = torch.argmax(want, -1).to(torch.int32)
    pos = torch.full((2,), 40, dtype=torch.int32)
    want2, _ = LM.decode_step(params, cache, nxt, pos, cfg, device="cpu")
    got2, _ = LM.decode_step(gparams, gcache, nxt.to(cuda), pos.to(cuda), cfg, device=cuda)
    torch.testing.assert_close(got2.cpu(), want2, rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "mixtral-8x22b"])
def test_moe_prefill_and_decode_cuda_equal_cpu(cuda, highest_f32, arch):
    """Mixtral's smoke configs in float32, prompts of 40 tokens past the
    32-token window: the prefill (K6 once a layer) and two decode steps on
    cuda against cpu, each MoE layer's routing (``gate_e``, slots, ``keep``,
    loads) bitwise and the logits within atol 2e-3, rtol 1e-3."""
    import dataclasses

    from repro_torch import random as trandom
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import launch_counts
    from repro_torch.models import lm as LM

    cfg = dataclasses.replace(get_arch(arch).smoke_config, dtype=torch.float32)
    params = LM.init_params(cfg, trandom.PRNGKey(0), device="cpu")
    toks = trandom.randint(trandom.PRNGKey(1), (2, 40), 0, cfg.vocab)
    want_routes, got_routes = [], []
    want, cache = LM.prefill(params, toks, cfg, max_seq=48, device="cpu", routes=want_routes)
    gparams = _to(params, cuda)
    before = launch_counts()["flash_attention"]
    got, gcache = LM.prefill(gparams, toks.to(cuda), cfg, max_seq=48, device=cuda,
                             routes=got_routes)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == before + cfg.n_layers
    assert len(got_routes) == len(want_routes) == cfg.n_layers
    for g, w in zip(got_routes, want_routes):
        for name in ("gate_e", "order", "slot", "keep", "load"):
            assert torch.equal(g[name].cpu(), w[name]), name
    assert any(bool((~w["keep"]).any()) for w in want_routes)  # capacity binds
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=2e-3)
    nxt = torch.argmax(want, -1).to(torch.int32)
    for i in (40, 41):
        pos = torch.full((2,), i, dtype=torch.int32)
        want, cache = LM.decode_step(params, cache, nxt, pos, cfg, device="cpu")
        got, gcache = LM.decode_step(gparams, gcache, nxt.to(cuda), pos.to(cuda), cfg,
                                     device=cuda)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=2e-3)
        nxt = torch.argmax(want, -1).to(torch.int32)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def _k7_inputs(B, Hk, m, D, Hn, dtype, seed):
    rng = np.random.default_rng(seed)
    xk = torch.from_numpy(rng.standard_normal((B, Hk, D), np.float32)).to(dtype)
    x0 = torch.from_numpy(rng.standard_normal((B, m, D), np.float32)).to(dtype)
    w = torch.from_numpy((0.1 * rng.standard_normal((Hk * m, Hn))).astype(np.float32))
    return xk, x0, w.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hk,m,D,Hn", [
    (64, 6, 6, 4, 8), (77, 8, 6, 4, 8), (64, 10, 6, 8, 12), (512, 39, 39, 10, 200),
    (300, 200, 39, 10, 200), (1000, 200, 39, 10, 200), (5, 3, 2, 1, 41),
    (512, 200, 39, 10, 200), (64, 200, 39, 10, 200), (100, 20, 40, 10, 200),
    (3, 4, 5, 2, 300),
])
def test_k7_cin_layer(cuda, highest_f32, dtype, B, Hk, m, D, Hn):
    """K7 against ``cin_layer_ref`` on the same card tensors: float32 max
    |Δ| ≤ 1e-5 of max |want|; bfloat16 per element ≤ 2^-7·|want| (one
    output rounding) + 2^-15·max |want| (the float32 sums near zero)."""
    from repro_torch.kernels.cin import cin_layer, cin_layer_ref, launch_counts

    xk, x0, w = (t.to(cuda) for t in _k7_inputs(B, Hk, m, D, Hn, dtype, seed=B + Hk))
    before = launch_counts()["cin"]
    got = cin_layer(xk, x0, w)
    torch.cuda.synchronize()
    assert launch_counts()["cin"] == before + 1
    want = cin_layer_ref(xk, x0, w)
    assert got.dtype == dtype and got.shape == (B, Hn, D)
    d = (got.float() - want.float()).abs()
    top = want.float().abs().max()
    if dtype == torch.float32:
        assert float(d.max()) <= 1e-5 * float(top)
    else:
        assert bool((d <= 2**-7 * want.float().abs() + 2**-15 * top).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hk", [(512, 200), (64, 200), (512, 39), (2048, 200)])
def test_k7_repeatable_and_near_its_emulation(cuda, highest_f32, dtype, B, Hk):
    """K7 split over its K stages where the rows are too few to fill the
    card (``plan``): two launches give equal bits (no atomics), and the
    result is within ``test_k7_cin_layer``'s limits of
    ``cin_split_partials``' sum (the emulation sums each stage in another
    order)."""
    from repro_torch.kernels.cin import cin_layer, cin_split_partials, plan
    from repro_torch.kernels.cin.kernel import _lib, _slots

    m, D, Hn = 39, 10, 200
    xk, x0, w = (t.to(cuda) for t in _k7_inputs(B, Hk, m, D, Hn, dtype, seed=B + 1))
    is_bf16 = int(dtype == torch.bfloat16)
    p = plan(B, Hk, m, D, Hn, dtype, _slots(_lib(), xk.device, m, is_bf16), _lib())
    first = cin_layer(xk, x0, w)
    again = cin_layer(xk, x0, w)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int16 if is_bf16 else torch.int32),
                       again.view(torch.int16 if is_bf16 else torch.int32))
    parts = cin_split_partials(xk, x0, w, splits=p["splits"])
    want = sum(parts[1:], parts[0]).to(dtype)
    d = (first.float() - want.float()).abs()
    top = want.float().abs().max()
    if dtype == torch.float32:
        assert float(d.max()) <= 1e-5 * float(top)
    else:
        assert bool((d <= 2**-7 * want.float().abs() + 2**-15 * top).all())


def test_k6_float32_repeatable(cuda, highest_f32):
    """``test_k6_model_layout_and_refusals``' float32 case 300 times in one
    process: the card gives the same bits on every call, within atol 2e-5 of
    the plain version on the CPU."""
    from repro_torch.kernels.flash_attention import flash_attention

    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((2, 100, 8, 64), np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 100, 2, 64), np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 100, 2, 64), np.float32))
    pos = torch.arange(100, dtype=torch.int32).expand(2, 100)
    want = flash_attention(q, k, v, pos, pos, causal=True, window=None)
    args = [t.to(cuda) for t in (q, k, v, pos, pos)]
    first = flash_attention(*args, causal=True, window=None)
    differ = 0
    for _ in range(300):
        got = flash_attention(*args, causal=True, window=None)
        differ += int(not torch.equal(got, first))
    torch.cuda.synchronize()
    assert differ == 0
    torch.testing.assert_close(first.cpu(), want, rtol=0, atol=2e-5)


def test_k7_refusals_and_backward(cuda):
    from repro_torch.kernels.cin import cin_layer, cin_layer_kernel

    xk, x0, w = (t.to(cuda) for t in _k7_inputs(4, 3, 2, 5, 6, torch.float32, seed=0))
    with pytest.raises(ValueError, match="contiguous"):
        cin_layer(xk.transpose(0, 1).contiguous().transpose(0, 1), x0, w)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cin_layer(xk.half(), x0.half(), w.half())
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.ones(1, 400, 1, device=cuda)
        cin_layer(big[:, :1], big, torch.ones(400, 2, device=cuda))
    from repro_torch.kernels.cin.kernel import _lib, smem_bytes

    for dt in (torch.float32, torch.bfloat16):  # the wrapper's formula is the kernel's
        for m, hr in ((2, 1), (39, 39), (39, 200), (272, 1)):
            assert _lib().cin_smem_bytes(m, hr, int(dt == torch.bfloat16)) == \
                smem_bytes(m, hr, dt)
    # x0's fields beside the w ring: up to 272 in float32, 584 in bf16
    for dt, m_max in ((torch.float32, 272), (torch.bfloat16, 584)):
        for m, fits in ((m_max, True), (m_max + 1, False)):
            x0m = torch.ones(2, m, 3, device=cuda, dtype=dt)
            args = (x0m[:, :1].contiguous(), x0m, torch.ones(m, 5, device=cuda, dtype=dt))
            if fits:
                torch.testing.assert_close(cin_layer(*args).float(),
                                           torch.full((2, 5, 3), float(m), device=cuda))
            else:
                with pytest.raises(ValueError, match="shared memory"):
                    cin_layer(*args)
    torch.testing.assert_close(cin_layer_kernel(xk.transpose(1, 2).contiguous()
                                                .transpose(1, 2), x0, w),
                               cin_layer(xk, x0, w), rtol=0, atol=0)
    # a gradient through K7 runs K7b (counted once), never a plain version
    from repro_torch.kernels.cin import launch_counts

    w.requires_grad_(True)
    before = launch_counts()["cin_bwd"]
    cin_layer(xk, x0, w).sum().backward()
    torch.cuda.synchronize()
    assert launch_counts()["cin_bwd"] == before + 1 and torch.isfinite(w.grad).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hk,m,D,Hn", [
    (5, 3, 2, 1, 41), (77, 8, 6, 4, 8), (64, 39, 39, 10, 200), (48, 200, 39, 10, 200),
    (100, 20, 40, 10, 200), (2048, 200, 39, 10, 200),
    # the edges of K7b's tiles (128 rows a t block, 80 columns of (h, j) a t
    # tile, 128 k x 104 n a dw block, 32 rows a dw stage): m = 64 and
    # H' = 256 (the widest it takes), 10 h a tile (mp = 8), 3 h and 8 zero
    # columns a tile (mp = 24) with 9 splits, ragged B·D, H' off 8 and 32
    (300, 20, 64, 7, 256), (130, 11, 8, 3, 33), (1000, 9, 17, 10, 100), (3, 41, 39, 10, 13),
])
def test_k7b_against_plain_version_and_repeats(cuda, highest_f32, dtype, B, Hk, m, D, Hn):
    """K7b against ``cin_layer_bwd_ref`` on the same card tensors: the
    largest error of each gradient at most 1e-5 (float32) or 2^-7 (bfloat16,
    one rounding of the result) of its largest magnitude; two launches give
    the same bits."""
    from repro_torch.kernels.cin import launch_counts
    from repro_torch.kernels.cin.kernel import cin_layer_bwd
    from repro_torch.kernels.cin.ref import cin_layer_bwd_ref

    xk, x0, w = (t.to(cuda) for t in _k7_inputs(B, Hk, m, D, Hn, dtype, seed=B + Hk))
    g = torch.randn((B, Hn, D), generator=torch.Generator(cuda).manual_seed(2), device=cuda
                    ).to(dtype)
    from repro_torch.kernels.cin.kernel import _lib_bwd, bwd_scratch_bytes, bwd_splits

    splits = bwd_splits(B, Hk, m, D, Hn)
    assert _lib_bwd().cin_bwd_scratch_bytes(B, Hk, m, D, Hn, splits) == \
        bwd_scratch_bytes(B, Hk, m, D, Hn, splits)
    before = launch_counts()["cin_bwd"]
    got = cin_layer_bwd(xk, x0, w, g)
    again = cin_layer_bwd(xk, x0, w, g)
    torch.cuda.synchronize()
    assert launch_counts()["cin_bwd"] == before + 2
    want = cin_layer_bwd_ref(xk, x0, w, g)
    limit = 2**-7 if dtype == torch.bfloat16 else 1e-5
    for a, b, c in zip(got, again, want):
        assert a.dtype == dtype and a.shape == c.shape
        assert torch.equal(a, b)
        err = (a.float() - c.float()).abs().max() / c.float().abs().max()
        assert err <= limit, float(err)


def _published_xdeepfm():
    import dataclasses

    from repro_torch.configs import get_arch

    return dataclasses.replace(get_arch("xdeepfm").config,
                               field_vocabs=(64, 32) * 19 + (48,))


def test_xdeepfm_forward_cuda_equals_cpu(cuda, highest_f32):
    """The published widths with small vocabularies: three K7 launches per
    forward; logits within rtol 1e-4, atol 1e-6 of the CPU forward on the
    same parameters and ids (only cuBLAS against the CPU's matmul and K7's
    sum order differ); each CIN layer's pools within 1e-5 of its max."""
    from repro_torch import random as trandom
    from repro_torch.kernels.cin import launch_counts
    from repro_torch.launch.serve import recsys_ids
    from repro_torch.models import recsys as R

    cfg = _published_xdeepfm()
    params = R.xdeepfm_init(cfg, trandom.PRNGKey(0), device="cpu")
    ids = recsys_ids(trandom.PRNGKey(1), cfg, 300, "cpu")
    want_pools, got_pools = [], []
    want = R.xdeepfm_forward(params, ids, cfg, pools=want_pools)
    before = launch_counts()["cin"]
    got = R.xdeepfm_forward(_to(params, cuda), ids.to(cuda), cfg, pools=got_pools)
    torch.cuda.synchronize()
    assert launch_counts()["cin"] == before + 3
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-6)
    for g, w in zip(got_pools, want_pools):
        assert float((g.cpu() - w).abs().max()) <= 1e-5 * float(w.abs().max())


def test_serve_recsys_cuda_equals_cpu(cuda, highest_f32):
    from repro_torch.launch.serve import serve_recsys

    want, got = {}, {}
    serve_recsys("xdeepfm", batch=100, smoke=True, seed=3, device="cpu", stats=want)
    serve_recsys("xdeepfm", batch=100, smoke=True, seed=3, device=cuda, stats=got)
    assert torch.equal(got["ids"].cpu(), want["ids"])
    torch.testing.assert_close(got["scores"].cpu(), want["scores"], rtol=1e-4, atol=1e-6)
    for g, w in zip(got["pools"], want["pools"]):
        assert float((g.cpu() - w).abs().max()) <= 1e-5 * float(w.abs().max())
    assert got["peak_bytes"] > 0


def test_s5p_row_placement_cuda_equals_cpu(cuda):
    from repro_torch.models.recsys import s5p_row_placement

    rng = np.random.default_rng(0)
    rows = (rng.zipf(1.3, 3200) % 64).astype(np.int64)
    samples = np.repeat(np.arange(800), 4)
    shard_c, mat_c = s5p_row_placement(rows, samples, 64, k=4, device="cpu")
    shard_g, mat_g = s5p_row_placement(rows, samples, 64, k=4, device=cuda)
    np.testing.assert_array_equal(shard_g, shard_c)
    np.testing.assert_array_equal(mat_g, mat_c)


# ------------------------------------------------------ parallel ingest

def _lane_carries(n, dev):
    from repro_torch.core.clustering import ClusterCarry, DegreeCarry
    from repro_torch.core.cms import SketchCarry
    from repro_torch.core.postprocess import AssignCarry
    from repro_torch.kernels.stream_scan import GreedyCarry, GridCarry, HdrfCarry

    deg = torch.full((n,), 5, dtype=torch.int32, device=dev)
    row = (torch.arange(n, dtype=torch.int32, device=dev) % 4)
    c2p = torch.arange(64, dtype=torch.int32, device=dev) % 8
    return {
        "greedy": lambda: GreedyCarry(n, 8, device=dev),
        "hdrf": lambda: HdrfCarry(n, 8, device=dev),
        "grid": lambda: GridCarry(8, row, row % 2, 2, device=dev),
        "cluster": lambda: ClusterCarry(deg, n, xi=3, kappa=400),
        "assign": lambda: AssignCarry(8, 2000, c2p),
        "degree": lambda: DegreeCarry(n, device=dev),
        "sketch": lambda: SketchCarry(512, 5, seed=1, device=dev),
    }


@pytest.mark.parametrize("shard", ["range", "rr", "hub"])
@pytest.mark.parametrize("name", ["greedy", "hdrf", "grid", "cluster", "assign", "degree",
                                  "sketch"])
def test_parallel_lanes_on_streams_equal_one_stream(cuda, name, shard):
    """S = 4 lanes, each issuing on its own stream (threads), give the bits
    of the same lanes stepped on one stream (vmap) and of the CPU."""
    from repro_torch.streaming import EdgeStream, run_parallel
    from repro_torch.streaming.carry import tree_leaves

    src, dst, n = _graph(scale=11, seed=2)
    rng = np.random.default_rng(0)
    E = src.size
    ex = ((rng.random(E) < 0.4), rng.integers(0, 64, E).astype(np.int32),
          rng.integers(0, 64, E).astype(np.int32)) if name == "assign" else ()
    sc = "auto" if name in ("cluster", "hdrf") else 2
    got = {}
    for dev, backend in ((cuda, "threads"), (cuda, "vmap"), (torch.device("cpu"), "threads")):
        stream = EdgeStream(src, dst, n, chunk_size=1024, device=dev)
        exd = tuple(torch.from_numpy(e).to(dev) for e in ex)
        parts, carry = run_parallel(stream, _lane_carries(n, dev)[name](), *exd,
                                    num_streams=4, super_chunk=sc, shard=shard,
                                    backend=backend)
        torch.cuda.synchronize()
        got[(dev.type, backend)] = (None if parts is None else parts.cpu(),
                                    [x.cpu() if isinstance(x, torch.Tensor) else x
                                     for x in tree_leaves(carry)])
    want = got[("cpu", "threads")]
    for key in (("cuda", "threads"), ("cuda", "vmap")):
        p, leaves = got[key]
        assert (p is None) == (want[0] is None), key
        if p is not None:
            assert torch.equal(p, want[0]), key
        for i, (a, b) in enumerate(zip(leaves, want[1])):
            assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, (key, i)


def test_parallel_lanes_repeatable_and_counted(cuda):
    """HDRF at S = 8 hub lanes on a 2^14-vertex R-MAT, three times: equal
    bits each time, one K3 launch per plan chunk."""
    from repro_torch.kernels.stream_scan import HdrfCarry, launch_counts, reset_launch_counts
    from repro_torch.streaming import EdgeStream, last_ingest_stats, run_parallel

    src, dst, n = _graph(scale=14, seed=3)
    stream = EdgeStream(src, dst, n, chunk_size=4096, device=cuda)
    runs = []
    for _ in range(3):
        reset_launch_counts()
        parts, carry = run_parallel(stream, HdrfCarry(n, 32, device=cuda), num_streams=8,
                                    super_chunk="auto", shard="hub")
        torch.cuda.synchronize()
        chunks = sum(lane.chunks for lane in last_ingest_stats().lanes)
        assert launch_counts()["scoring_scan"] == chunks
        runs.append((parts.cpu(), carry[1].cpu()))
    for p, rep in runs[1:]:
        assert torch.equal(p, runs[0][0]) and torch.equal(rep, runs[0][1])


@pytest.mark.parametrize("shard", ["range", "hub"])
def test_s5p_parallel_with_touch_up_cuda_equals_cpu(cuda, shard):
    from repro_torch.core.s5p import S5PConfig, s5p_partition
    from repro_torch.graphs import community_graph

    src, dst, n = community_graph(2000, n_communities=32, avg_degree=8, seed=5)
    cfg = S5PConfig(k=8, chunk_size=512, num_streams=4, shard=shard, super_chunk="auto")
    a = s5p_partition(src, dst, n, cfg, device=cuda)
    b = s5p_partition(src, dst, n, cfg, device="cpu")
    assert torch.equal(a.parts.cpu(), b.parts)
    assert np.array_equal(a.cluster_assignment, b.cluster_assignment)
    keys = ("contested_clusters", "moved_clusters", "replayed_edges", "rounds")
    assert [a.aux["touch_up"][k] for k in keys] == [b.aux["touch_up"][k] for k in keys]


@pytest.mark.parametrize("xi", [1 << 20, 3])
def test_merged_cluster_ids_past_the_tables_equal_cpu_on_the_card(cuda, xi):
    """Fixed-cadence clustering lanes merge their id counters past V + 1
    (ROADMAP Queue 3 j's input: next_t reaches 2,237 against V = 1,024): K1
    reads slot V for the ids past it and drops their adds, as the plain fold
    and the reference do, so the card's state equals the CPU's bit for bit."""
    from repro_torch.core.clustering import cluster_stream

    src, dst, n = _graph(scale=10, seed=4)
    kw = dict(xi=xi, kappa=1 << 20, chunk_size=256, num_streams=8, super_chunk=1)
    want = cluster_stream(src, dst, n, device="cpu", **kw)
    got = cluster_stream(src, dst, n, device=cuda, **kw)
    assert int(want.next_t) + int(want.next_h) > n + 1
    for name, a, b in zip(want._fields, want, got):
        assert torch.equal(a, b.cpu()), name

# ---------------------------------------------------------------- out of core

@pytest.mark.parametrize("ordering", ["natural", "shuffled", "dst-sorted", "windowed"])
def test_sharded_stream_chunks_land_on_cuda(cuda, tmp_path, ordering):
    """Chunks paged from disk shards land on the card with the in-memory
    stream's bits, and scatter_back runs on the card."""
    from repro_torch.streaming import EdgeStream, ShardedEdgeStream, write_shards

    src, dst, n = _graph(scale=9, seed=2)
    man = write_shards(tmp_path, src, dst, shard_edges=777, n_vertices=n)
    tag = np.arange(src.size, dtype=np.int32)
    ref = EdgeStream(src, dst, n, chunk_size=500, ordering=ordering, seed=3,
                     window=64, device="cpu")
    with ShardedEdgeStream(man, chunk_size=500, ordering=ordering, seed=3,
                           window=64, device=cuda) as st:
        for a, b in zip(ref.chunks(tag), st.chunks(tag)):
            assert b.src.device.type == "cuda" and b.extras[0].device.type == "cuda"
            assert torch.equal(a.src, b.src.cpu()) and torch.equal(a.dst, b.dst.cpu())
            assert torch.equal(a.extras[0], b.extras[0].cpu())
        vals = torch.arange(src.size, dtype=torch.int32)
        assert torch.equal(ref.scatter_back(vals), st.scatter_back(vals.to(cuda)).cpu())


def test_s5p_and_hdrf_from_disk_cuda_equal_cpu(cuda, tmp_path):
    """S5P and HDRF (sequential and 4 hub lanes) from disk shards on the card
    equal the same runs from disk and from memory on the CPU."""
    from repro_torch.core.baselines import hdrf_partition
    from repro_torch.core.s5p import S5PConfig, s5p_partition
    from repro_torch.streaming import ShardedEdgeStream, write_shards

    src, dst, n = _graph(scale=10, seed=1)
    man = write_shards(tmp_path, src, dst, shard_edges=1000, n_vertices=n)
    cfg = S5PConfig(k=8, chunk_size=1024)
    want = s5p_partition(src, dst, n, cfg, device="cpu")
    for dev in (cuda, "cpu"):
        with ShardedEdgeStream(man, chunk_size=1024, device=dev) as st:
            got = s5p_partition(src, dst, n, cfg, stream=st)
        assert torch.equal(want.parts, got.parts.cpu())
        assert np.array_equal(want.cluster_assignment, got.cluster_assignment)
    for kw in ({}, dict(num_streams=4, shard="hub", super_chunk="auto")):
        want = hdrf_partition(src, dst, n, 8, chunk_size=1024, device="cpu", **kw)
        with ShardedEdgeStream(man, chunk_size=1024, device=cuda) as st:
            got = hdrf_partition(None, None, n, 8, stream=st, **kw)
        assert torch.equal(want, got.cpu())


# ------------------------------------------------ incremental re-partitioning

def test_k4a_negative_counts_and_retract_on_the_card(cuda):
    """K4a with negative counts (a Θ retraction) bitwise against its plain
    version; ``cms_retract ∘ cms_update`` is the identity on the card."""
    from repro_torch.core.cms import cms_retract, cms_update, make_sketch, pair_key
    from repro_torch.kernels.cms_sketch import add_ref, cms_add, launch_counts

    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.integers(0, 3000, 1 << 17).astype(np.int32))
    b = torch.from_numpy(rng.integers(0, 3000, 1 << 17).astype(np.int32))
    keys = pair_key(a, b)
    start = torch.from_numpy(rng.integers(-2**31, 2**31, (5, 4_096)).astype(np.int32))
    seeds = make_sketch(4_096, 5, seed=7, device="cpu").seeds
    neg = -torch.ones_like(keys)
    before = launch_counts()["cms_update"]
    got = cms_add(start.to(cuda), keys.to(cuda), seeds.to(cuda), neg.to(cuda))
    assert torch.equal(got.cpu(), add_ref(start, keys, seeds, neg))
    sketch = make_sketch(4_096, 5, seed=7, device=cuda)._replace(table=start.to(cuda))
    kc = keys.to(cuda)
    back = cms_retract(cms_update(sketch, kc), kc)
    torch.cuda.synchronize()
    assert torch.equal(back.table.cpu(), start)
    assert launch_counts()["cms_update"] == before + 3


@pytest.mark.parametrize("flags", ["recorded", "frozen_xi"])
def test_cluster_retract_chunk_cuda_equals_cpu(cuda, flags):
    from repro_torch.core.clustering import (ClusterState, cluster_retract_chunk,
                                             cluster_stream, compute_degrees)

    src, dst, n = _graph(seed=2)
    s, d = torch.from_numpy(src), torch.from_numpy(dst)
    deg = compute_degrees(s, d, n)
    xi = int(2 * src.size / n)
    state = cluster_stream(src, dst, n, xi=xi, kappa=int(src.size / 4), chunk_size=4096,
                           device="cpu")
    idx = torch.from_numpy(np.sort(np.random.default_rng(0).choice(src.size, src.size // 4,
                                                                   replace=False)))
    head = (deg[s[idx]] > xi) & (deg[d[idx]] > xi)
    kw = dict(is_head=head) if flags == "recorded" else dict(degrees=deg, xi=xi)
    want = cluster_retract_chunk(state, s[idx], d[idx], idx.numel() - 3, **kw)
    kc = {key: v.to(cuda) if isinstance(v, torch.Tensor) else v for key, v in kw.items()}
    got = cluster_retract_chunk(ClusterState(*[t.to(cuda) for t in state]), s[idx].to(cuda),
                                d[idx].to(cuda), idx.numel() - 3, **kc)
    for name, a, b in zip(ClusterState._fields, got, want):
        assert torch.equal(a.cpu(), b), name


def _incremental_sequence(dev):
    """Cold bundle → 10 % delta → its rollback → a 10 % decremental deletion
    → three window steps, on ``community_graph(600, 8, 6, seed=3)``."""
    from repro_torch.core.s5p import S5PConfig
    from repro_torch.graphs import community_graph
    from repro_torch.incremental import (S5PWindowChain, s5p_apply_delta,
                                         s5p_apply_deletion, s5p_cold_bundle)

    src, dst, n = community_graph(600, n_communities=8, avg_degree=6, seed=3)
    E = src.size
    E0 = int(E * 0.9)
    inf = float("inf")
    cfg = S5PConfig(k=8, chunk_size=256, drift_rf_threshold=inf,
                    drift_balance_threshold=inf, drift_churn_threshold=inf)
    _, b0 = s5p_cold_bundle(src[:E0], dst[:E0], n, cfg, device=dev)
    b1, r1 = s5p_apply_delta(b0, cfg, src, dst, E0, device=dev)
    b2, r2 = s5p_apply_deletion(b1, cfg, src, dst, np.arange(E0, E), device=dev)
    cfg_r = S5PConfig(k=8, chunk_size=256, drift_rf_threshold=0.0)
    b3, r3 = s5p_apply_delta(b0, cfg_r, src, dst, E0, device=dev)
    idx = np.sort(np.random.default_rng(1).choice(E, E // 10, replace=False))
    b4, r4 = s5p_apply_deletion(b3, cfg_r, src, dst, idx, device=dev)
    chain = S5PWindowChain(src, dst, n, cfg_r, 512, step_edges=256, device=dev)
    steps = [chain.step() for _ in range(4)]
    return [b0, b1, b2, b3, b4, chain.bundle], [r1, r2, r3, r4, *steps]


def test_incremental_sequence_cuda_equals_cpu(cuda):
    """Delta, rollback, deletion and window steps on the card give the CPU's
    bundles and results bit for bit (K1, K2, K4a/b, K5 on the card)."""
    from repro_torch.kernels.stream_scan import launch_counts

    before = launch_counts()
    gb, gr = _incremental_sequence(cuda)
    after = launch_counts()
    cb, cr = _incremental_sequence("cpu")
    assert gr[1].rolled_back and gr[2].refined
    assert after["cluster_scan"] > before["cluster_scan"]
    assert after["assign_scan"] > before["assign_scan"]
    for i, (g, c) in enumerate(zip(gb, cb)):
        assert sorted(g) == sorted(c), i
        for key in c:
            a, b = np.asarray(g[key]), np.asarray(c[key])
            assert a.dtype == b.dtype and np.array_equal(a, b), (i, key)
    for i, (g, c) in enumerate(zip(gr, cr)):
        for f in c._fields:
            x, y = getattr(g, f), getattr(c, f)
            assert (np.array_equal(x, y) if isinstance(x, np.ndarray) else x == y), (i, f)


def test_bundle_saved_from_the_card_loads_on_the_cpu(cuda, tmp_path):
    from repro_torch.core.s5p import S5PConfig
    from repro_torch.graphs import community_graph
    from repro_torch.incremental import (CarryStore, cold_start, run_incremental)

    src, dst, n = community_graph(600, n_communities=8, avg_degree=6, seed=3)
    E0 = int(src.size * 0.8)
    cfg = S5PConfig(k=8, chunk_size=256)
    cold_start(tmp_path / "card", "s5p", src[:E0], dst[:E0], n, 8, s5p_config=cfg,
               device=cuda)
    cold_start(tmp_path / "cpu", "s5p", src[:E0], dst[:E0], n, 8, s5p_config=cfg,
               device="cpu")
    card, _ = CarryStore(tmp_path / "card").load(consumer="s5p")
    host, _ = CarryStore(tmp_path / "cpu").load(consumer="s5p")
    assert sorted(card) == sorted(host)
    for key in host:
        assert np.array_equal(card[key], host[key]) and card[key].dtype == host[key].dtype
    res_cpu = run_incremental(tmp_path / "card", "s5p", src, dst, n, 8, s5p_config=cfg,
                              save=False, device="cpu")
    res_card = run_incremental(tmp_path / "cpu", "s5p", src, dst, n, 8, s5p_config=cfg,
                               save=False, device=cuda)
    assert np.array_equal(res_cpu.parts, res_card.parts) and res_cpu.rf == res_card.rf


# ---------------------------------------------------------------- elastic

def _warm_pair(cuda, seed=0, k=8):
    from repro_torch.core.s5p import S5PConfig
    from repro_torch.graphs import community_graph
    from repro_torch.incremental import s5p_cold_bundle

    src, dst, n = community_graph(800, n_communities=16, avg_degree=6, p_intra=0.9,
                                  seed=seed)
    cfg = S5PConfig(k=k, seed=seed, chunk_size=512)
    _, gb = s5p_cold_bundle(src, dst, n, cfg, device=cuda)
    _, cb = s5p_cold_bundle(src, dst, n, cfg, device="cpu")
    return src, dst, n, cfg, gb, cb


def _same_bundles(g, c):
    assert sorted(g) == sorted(c)
    for key in c:
        a, b = np.asarray(g[key]), np.asarray(c[key])
        assert a.dtype == b.dtype and np.array_equal(a, b), key


@pytest.mark.parametrize("k_new", [12, 5])
@pytest.mark.parametrize("scale", [0.0, 1.0])
def test_reshard_bundle_cuda_equals_cpu(cuda, k_new, scale):
    """Grow and shrink with the migration-cost game on the card (its sums
    on K5) and the affected edges placed again on K2: the CPU's bundle and
    result bit for bit."""
    from repro_torch.elastic import reshard_bundle
    from repro_torch.kernels import segment_agg, stream_scan

    def launch_counts():
        return {**stream_scan.launch_counts(), **segment_agg.launch_counts()}

    src, dst, n, cfg, gb, cb = _warm_pair(cuda, seed=1)
    _same_bundles(gb, cb)
    before = launch_counts()
    g2, _, gres = reshard_bundle(gb, cfg, k_new, src, dst, move_cost_scale=scale,
                                 device=cuda)
    after = launch_counts()
    c2, _, cres = reshard_bundle(cb, cfg, k_new, src, dst, move_cost_scale=scale,
                                 device="cpu")
    assert tuple(gres) == tuple(cres) and gres.game_rounds > 0
    _same_bundles(g2, c2)
    assert after["assign_scan"] > before["assign_scan"]
    assert after["segment_agg"] >= before["segment_agg"] + 2


@pytest.mark.parametrize("scale", [0.0, 0.5, 4.0])
def test_move_cost_game_cuda_equals_cpu(cuda, scale):
    from repro_torch.core import game as G

    src, dst, n, cfg, gb, _ = _warm_pair(cuda, seed=2)
    sizes = np.asarray(gb["sizes"], np.float32)
    C, k = sizes.size, 10
    rng = np.random.default_rng(3)
    assign0 = rng.integers(0, k, C).astype(np.int32)
    home = np.where(rng.random(C) < 0.2, -1, assign0).astype(np.int32)
    cost = (np.float32(scale) * sizes / np.float32(k)).astype(np.float32)
    out = []
    for dev in (cuda, "cpu"):
        inputs = G.GameInputs(*(torch.from_numpy(np.asarray(gb[key])).to(dev)
                                for key in ("sizes", "pair_a", "pair_b", "pair_w")), 0, k)
        res = G.run_game(inputs, C, batch_size=G.default_batch_size(256, C), max_rounds=64,
                         assign0=assign0, seed=4,
                         leader_mask=np.asarray(gb["comb_is_head"], bool),
                         move_mask=sizes > 0, move_cost=cost, home=home)
        out.append((res.assignment.cpu().numpy(), res.rounds))
    assert np.array_equal(out[0][0], out[1][0]) and out[0][1] == out[1][1]


@pytest.mark.parametrize("k_new", [12, 4])
@pytest.mark.parametrize("name", ["greedy", "hdrf"])
def test_reshard_scan_carry_cuda_equals_cpu(cuda, name, k_new):
    """K3's retract of the displaced edges and K3 at k′: the CPU's carry and
    parts."""
    from repro_torch.elastic import reshard_scan_carry
    from repro_torch.graphs import community_graph
    from repro_torch.kernels.stream_scan import GreedyCarry, HdrfCarry, launch_counts
    from repro_torch.streaming import EdgeStream, run_carry

    src, dst, n = community_graph(600, n_communities=8, avg_degree=5, seed=5)
    out = []
    for dev in (cuda, "cpu"):
        make = ((lambda k: GreedyCarry(n, k, device=dev)) if name == "greedy"
                else (lambda k: HdrfCarry(n, k, 1.1, device=dev)))
        parts, carry = run_carry(EdgeStream(src, dst, n, chunk_size=256, device=dev), make(8))
        before = launch_counts()
        work, new_parts, res = reshard_scan_carry(make(k_new), carry, k_new, src, dst,
                                                  parts.cpu().numpy(), chunk_size=256)
        after = launch_counts()
        out.append(([x.cpu() for x in work], new_parts, tuple(res)))
        if dev is cuda and k_new < 8:
            assert after["scoring_retract"] > before["scoring_retract"]
            assert after["scoring_scan"] > before["scoring_scan"]
    (gw, gp, gr), (cw, cp, cr) = out
    assert gr == cr and np.array_equal(gp, cp)
    assert all(torch.equal(a, b) for a, b in zip(gw, cw))


def _fixed_monitor():
    """A straggler monitor whose plan does not depend on timing: lane 2 is
    the straggler, lane 0 the fastest."""
    from repro_torch.runtime import StragglerMonitor

    class Fixed(StragglerMonitor):
        def record(self, step, dt, shard=0):
            self.n_shards = max(self.n_shards, int(shard) + 1)
            self.history.append((step, int(shard), dt))

    mon = Fixed(threshold=1.01)
    for s in range(4):
        StragglerMonitor.record(mon, 0, 100.0 if s == 2 else 1.0, shard=s)
    return mon


@pytest.mark.parametrize("shard", ["range", "rr", "hub"])
def test_straggler_handoff_cuda_equals_cpu(cuda, shard):
    """A forced handoff (and a lane killed and replayed) with the lanes on
    their own CUDA streams gives the CPU's parts and carry."""
    from repro_torch.graphs import rmat_graph
    from repro_torch.kernels.stream_scan import HdrfCarry
    from repro_torch.runtime import LaneFaultInjector
    from repro_torch.streaming import EdgeStream, ParallelEdgeStream, run_parallel

    src, dst, n = rmat_graph(11, edge_factor=8, seed=2)
    out = []
    for dev in (cuda, "cpu"):
        st = EdgeStream(src, dst, n, chunk_size=1024, device=dev)
        cid = ParallelEdgeStream(st, 4, shard=shard).lanes[1][1]
        inj = LaneFaultInjector([(1, cid)])
        parts, carry = run_parallel(st, HdrfCarry(n, 8, 1.1, device=dev), num_streams=4,
                                    super_chunk=2, shard=shard, straggler=_fixed_monitor(),
                                    on_lane_failure="replay", lane_injector=inj)
        assert inj.fired == [(1, cid)]
        out.append((parts.cpu(), [x.cpu() for x in carry]))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_serving_controller_resize_cuda_equals_cpu(cuda):
    """The controller over a window chain on the card, with a resize swap
    and a forced cold restart: the CPU's versions, origins and parts."""
    from repro_torch.core.s5p import S5PConfig
    from repro_torch.graphs import community_graph
    from repro_torch.incremental import S5PWindowChain
    from repro_torch.serving import BundleRegistry, ServingController

    src, dst, n = community_graph(512, n_communities=8, avg_degree=6, p_intra=0.9, seed=13)
    E = src.size
    runs = []
    for dev in (cuda, "cpu"):
        chain = S5PWindowChain(src, dst, n, S5PConfig(k=4, chunk_size=max(E // 3, 256)),
                               E // 3, step_edges=E // 6, device=dev)
        reg = BundleRegistry()
        ctl = ServingController(reg, chain)
        seen = []
        while reg.current is None:
            ctl.step()
        ctl.step()
        ctl.resize(6)
        seen.append(reg.current)
        ctl.request_cold_restart()
        seen.append(reg.current)
        while ctl.step() is not None:
            seen.append(reg.current)
        assert reg.current.device.type == torch.device(dev).type
        runs.append([(b.version, b.origin, b.k, b.parts) for b in seen])
    assert len(runs[0]) == len(runs[1])
    for a, b in zip(*runs):
        assert a[:3] == b[:3] and np.array_equal(a[3], b[3])
    assert runs[0][0][1] == "resize" and runs[0][1][1] == "cold-restart"


def test_fault_tolerant_loop_on_the_card_resumes_exactly(cuda, tmp_path):
    """Label propagation supersteps over a bundle on the card, checkpointed
    every 5 and failed at step 7: bitwise the undisturbed run."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.gas import build_gas_graph, label_propagation_step
    from repro_torch.graphs import community_graph
    from repro_torch.runtime import FaultInjector, FaultTolerantLoop

    src, dst, n = community_graph(600, n_communities=8, avg_degree=6, seed=3)
    parts = torch.from_numpy((src % 8).astype(np.int32))
    g = build_gas_graph(torch.from_numpy(src).to(cuda), torch.from_numpy(dst).to(cuda),
                        parts, n, 8, device=cuda)

    def step_fn(state, batch):
        labels = label_propagation_step(g, state["labels"])
        return {"labels": labels, "n": state["n"] + 1}, {"labels": labels}

    def run(d, fail_at):
        loop = FaultTolerantLoop(step_fn, lambda s: None,
                                 CheckpointManager(d, async_write=False), ckpt_every=5,
                                 injector=FaultInjector(fail_at))
        state = {"labels": torch.arange(n, dtype=torch.int32, device=cuda),
                 "n": torch.zeros((), dtype=torch.int32, device=cuda)}
        out, step, _ = loop.run(state, 12)
        return out, loop.restarts

    clean, r0 = run(tmp_path / "clean", ())
    faulty, r1 = run(tmp_path / "faulty", (7,))
    assert (r0, r1) == (0, 1) and int(faulty["n"]) == 12
    assert faulty["labels"].device.type == "cuda"
    assert torch.equal(clean["labels"], faulty["labels"])


@pytest.mark.parametrize("k", [8, 40])
def test_pagerank_on_the_card_repeats_and_equals_cpu(cuda, k):
    """PageRank's gather runs on K5: two runs on the card give the same
    bits, and the CPU's (the reference's order of sums and FMA)."""
    from repro_torch.gas import build_gas_graph, pagerank
    from repro_torch.kernels.segment_agg import launch_counts

    src, dst, n = _graph(12, seed=2)
    parts = torch.from_numpy((np.arange(src.size) % k).astype(np.int32))
    g = build_gas_graph(torch.from_numpy(src), torch.from_numpy(dst), parts, n, k, device=cuda)
    before = launch_counts()["segment_agg"]
    a = pagerank(g, 10)[0]
    b = pagerank(g, 10)[0]
    torch.cuda.synchronize()
    assert launch_counts()["segment_agg"] == before + 20  # one launch a superstep
    want = pagerank(build_gas_graph(src, dst, parts, n, k, device="cpu"), 10)[0]
    assert torch.equal(a, b) and torch.equal(a.cpu(), want)


def _hybrid_fields(res) -> dict:
    out = {f: getattr(res, f) for f in res._fields if f not in ("timings", "bundle")}
    out["plan"] = tuple(res.plan)
    return {**out, **{f"bundle.{key}": v for key, v in res.bundle.items()}}


def _same_fields(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for key in a:
        x, y = a[key], b[key]
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert np.asarray(x).dtype == np.asarray(y).dtype, key
            assert np.array_equal(x, y), key
        else:
            assert x == y, (key, x, y)


@pytest.mark.parametrize("frac", [0.0, 0.3, 1.0])
def test_run_hybrid_cuda_equals_cpu(cuda, frac):
    """``run_hybrid`` on the card: every ``HybridResult`` field and bundle
    leaf the CPU's; K2 once a chunk of each level's core and of the tail."""
    from repro_torch.core.s5p import S5PConfig
    from repro_torch.graphs import community_graph
    from repro_torch.hybrid import CORE_EDGE_BYTES, run_hybrid
    from repro_torch.kernels.stream_scan import launch_counts

    src, dst, n = community_graph(2000, n_communities=32, avg_degree=8, seed=5)
    cfg = S5PConfig(k=8, chunk_size=1024, host_budget=int(frac * src.size * CORE_EDGE_BYTES * 2))
    before = launch_counts()["assign_scan"]
    got = run_hybrid((src, dst, n), cfg, device=cuda)
    torch.cuda.synchronize()
    k2 = launch_counts()["assign_scan"] - before
    want = run_hybrid((src, dst, n), cfg, device="cpu")
    _same_fields(_hybrid_fields(got), _hybrid_fields(want))
    chunks = -(-src.size // 1024)
    if frac == 0.0:
        assert got.mode == "streaming" and k2 == chunks
    else:
        assert got.mode != "streaming" and k2 > chunks


def test_tail_and_degree_sketch_carries_cuda_equal_cpu(cuda):
    """``TailAssignCarry`` from a seeded load and ``DegreeSketchCarry`` at
    S = 1 and S = 4 hub lanes (and one chunk's retract) on the card."""
    from repro_torch.hybrid.planner import DegreeSketchCarry
    from repro_torch.hybrid.refiner import TailAssignCarry
    from repro_torch.streaming import EdgeStream, run_carry, run_parallel

    src, dst, n = _graph(11, seed=3)
    rng = np.random.default_rng(0)
    deg = (np.bincount(src, minlength=n) + np.bincount(dst, minlength=n)).astype(np.int32)
    v2c_h = np.where(deg > 40, rng.integers(0, 300, n), -1).astype(np.int32)
    v2c_t = rng.integers(0, 300, n).astype(np.int32)
    c2p = rng.integers(0, 8, 300).astype(np.int32)
    load0 = rng.integers(0, 500, 8).astype(np.int32)
    outs = []
    for dev in (cuda, "cpu"):
        tail = TailAssignCarry(8, src.size // 8 + 600, torch.from_numpy(c2p).to(dev),
                               degrees=deg, v2c_h=v2c_h, v2c_t=v2c_t, xi=20,
                               core_threshold=60)
        st = EdgeStream(src, dst, n, chunk_size=4096, device=dev)
        parts, load = run_carry(st, tail, carry=torch.from_numpy(load0.copy()).to(dev))
        sk = []
        for lanes in (1, 4):
            _, s = run_parallel(st, DegreeSketchCarry(400, 5, seed=2, device=dev),
                                num_streams=lanes, super_chunk=2, shard="hub")
            sk.append(s.table.cpu())
        ch = st.chunk_at(0)
        back = DegreeSketchCarry(400, 5, seed=2, device=dev).retract_chunk(
            s, ch.src, ch.dst, ch.n_valid, None)
        outs.append((parts.cpu(), load.cpu(), *sk, back.table.cpu()))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("world", [1, 2])
def test_distributed_partition_on_the_card_equals_cpu(cuda, world, tmp_path):
    """``distributed_partition`` in a world of ranks on the card (NCCL alone,
    gloo when two ranks share it) against the same world on the CPU: the
    parts, ``info`` and the collective bytes equal, CMS and exact Θ."""
    import torch_dist_ranks as R

    from repro_torch import _dist
    from repro_torch.graphs import community_graph

    src, dst, n = community_graph(300, n_communities=8, avg_degree=6, seed=1)
    cases = [(True, False), (False, False)]
    card = _dist.spawn_world(R.partition, world, (src, dst, n, cases), work_dir=tmp_path / "card")
    host = _dist.spawn_world(R.partition, world, (src, dst, n, cases), work_dir=tmp_path / "cpu",
                             device="cpu")
    for ranks in (card, host):
        for r in ranks[1:]:
            for a, b in zip(r, ranks[0]):
                np.testing.assert_array_equal(a["parts"], b["parts"])
    for c, h in zip(card[0], host[0]):
        np.testing.assert_array_equal(c["parts"], h["parts"])
        assert c["info"] == h["info"] and c["bytes"] == h["bytes"]
