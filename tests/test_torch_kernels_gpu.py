"""K1, K2, K3, G1, K4a, K4b and K5 on the card against their plain PyTorch
versions (bitwise; K1 and K3 also at the main path's 65,536-edge chunk, on
every K3 rung, with equal bits on two launches), K6 and K7 against their plain versions within stated
tolerances, and the GCN, the LM and xDeepFM on cuda against cpu.  Needs a CUDA device and ``nvcc``; run on a machine with a card:

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
    x = torch.ones(1, 16, 32, device=cuda, requires_grad=True)
    p16 = torch.arange(16, dtype=torch.int32, device=cuda)[None]
    out = flash_attention_fwd(x, x.detach(), x.detach(), p16, p16)
    with pytest.raises(NotImplementedError, match="training slice"):
        out.sum().backward()


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
    w.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="training slice"):
        cin_layer(xk, x0, w).sum().backward()


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
