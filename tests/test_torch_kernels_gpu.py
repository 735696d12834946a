"""K1, K2, K3, G1, K4a and K4b on the card against their plain PyTorch
versions (bitwise).  Needs a CUDA device and ``nvcc``; run on a machine with a card:

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


@pytest.mark.parametrize("name", ["grid", "greedy", "hdrf", "2ps-l"])
def test_baselines_cuda_equal_cpu(cuda, name):
    from repro_torch.core.baselines import PARTITIONERS
    from repro_torch.graphs import community_graph

    src, dst, n = community_graph(1000, n_communities=16, avg_degree=6, seed=2)
    kw = {} if name == "2ps-l" else {"chunk_size": 1500}  # several chunks
    gpu = PARTITIONERS[name](src, dst, n, 8, 0, device=cuda, **kw)
    cpu = PARTITIONERS[name](src, dst, n, 8, 0, device="cpu", **kw)
    assert torch.equal(gpu.cpu(), cpu)
