"""Port parity for the paper's baselines: every ``PARTITIONERS`` entry of
``repro_torch.core.baselines`` on the CPU gives parts bitwise equal to the
live ``repro.core.baselines`` — on ``random_graph`` seeds 0–3 at k = 4
(the draws behind ``tests/test_streaming.py``'s GOLDEN rows, run live
here) and on the community fixture at k = 8.  The S5P-based rows (s5p,
s5p-exact, clugp) draw their game's acceptance bits from threefry in the
mode the port implements, set explicitly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from proptest import random_graph

from repro.core import baselines as jb
from repro.core import metrics as jm
from repro_torch.core import baselines as tb
from repro_torch.core import metrics as tm


@pytest.fixture(autouse=True)
def _threefry_partitionable():
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", prev)


def test_the_same_partitioners():
    assert list(tb.PARTITIONERS) == list(jb.PARTITIONERS)


def _check(name, src, dst, n, k, seed=0):
    want = np.asarray(jb.PARTITIONERS[name](src, dst, n, k, seed))
    got = tb.PARTITIONERS[name](src, dst, n, k, seed, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(want, got.numpy(), err_msg=name)
    return want, got


@pytest.mark.parametrize("name", list(jb.PARTITIONERS))
@pytest.mark.parametrize("seed", range(4))
def test_random_graphs_k4(seed, name):
    src, dst, n, _ = random_graph(seed)
    _check(name, src, dst, n, 4)


@pytest.mark.parametrize("name", list(jb.PARTITIONERS))
def test_community_fixture_k8(community_bench_graph, name):
    src, dst, n = community_bench_graph
    want, got = _check(name, src, dst, n, 8)
    s, d = torch.from_numpy(src), torch.from_numpy(dst)
    kw = dict(n_vertices=n, k=8)
    assert tm.gas_comm_bytes(s, d, got, **kw) == jm.gas_comm_bytes(src, dst, want, **kw)
    assert tm.rf_by_degree(s, d, got, **kw) == jm.rf_by_degree(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(want), **kw)


@pytest.mark.parametrize("name", tb.S5P_BASED)
def test_s5p_rows_full_output(name):
    """``full_output=True`` returns the S5P run behind the row: the same
    parts, and its clusters, game rounds and per-phase seconds."""
    src, dst, n, _ = random_graph(1)
    out = tb.PARTITIONERS[name](src, dst, n, 4, 0, device="cpu", full_output=True)
    parts = tb.PARTITIONERS[name](src, dst, n, 4, 0, device="cpu")
    assert torch.equal(out.parts, parts)
    assert list(out.timings) == ["clustering", "statistics", "game", "postprocess"]
    assert out.game_rounds >= 1 and out.n_clusters >= out.n_head_clusters


@pytest.mark.parametrize("seed", [0, 1, 7, 123456])
def test_hash32(seed):
    x = np.random.default_rng(seed).integers(-(2**31), 2**31, 4096).astype(np.int32)
    want = np.asarray(jb._hash32(jnp.asarray(x), seed)).astype(np.int64)
    np.testing.assert_array_equal(want, tb._hash32(torch.from_numpy(x), seed).numpy())


@pytest.mark.parametrize("k", [1, 4, 7, 12, 32, 64])
def test_grid_dims_and_rowcol(k):
    assert tb._grid_dims(k) == jb._grid_dims(k)
    _, c = jb._grid_dims(k)
    for a, b in zip(jb._grid_rowcol(300, k, c, 5), tb._grid_rowcol(300, k, c, 5, "cpu")):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("name", ["grid", "greedy", "hdrf"])
@pytest.mark.parametrize("chunk_size", [7, 64])
def test_scans_at_other_chunk_sizes(name, chunk_size):
    src, dst, n, _ = random_graph(1)
    want = np.asarray(jb.PARTITIONERS[name](src, dst, n, 4, 0, chunk_size=chunk_size))
    got = tb.PARTITIONERS[name](src, dst, n, 4, 0, chunk_size=chunk_size, device="cpu")
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("name", ["grid", "greedy", "hdrf", "s5p", "s5p-exact"])
def test_parallel_ingest_is_not_ported(name):
    src, dst, n, _ = random_graph(1)
    with pytest.raises(NotImplementedError, match="slice 4"):
        tb.PARTITIONERS[name](src, dst, n, 4, 0, num_streams=2, device="cpu")


def test_baselines_need_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src, dst, n, _ = random_graph(1)
    for name, fn in tb.PARTITIONERS.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(src, dst, n, 4, 0)
