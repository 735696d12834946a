"""Port parity: graph generators and EdgeStream chunks (repro_torch vs repro)."""

import jax
import numpy as np
import pytest
import torch

from repro.graphs import generators as jgen
from repro.streaming import EdgeStream as JaxStream
from repro_torch.graphs import generators as tgen
from repro_torch.streaming import ORDERINGS, EdgeStream

GENERATORS = [
    ("rmat_graph", (8,), {"edge_factor": 4, "seed": 3}),
    ("rmat_graph", (7,), {"edge_factor": 16, "a": 0.57, "b": 0.19, "c": 0.19, "seed": 0}),
    ("community_graph", (300,), {"n_communities": 8, "seed": 5}),
    ("powerlaw_graph", (250,), {"avg_degree": 6.0, "seed": 2}),
    ("erdos_renyi_graph", (120,), {"avg_degree": 5.0, "seed": 1}),
    ("toy_graph_fig3", (), {}),
]


@pytest.mark.parametrize("name,args,kw", GENERATORS, ids=[g[0] for g in GENERATORS])
def test_generators_identical(name, args, kw):
    want = getattr(jgen, name)(*args, **kw)
    got = getattr(tgen, name)(*args, **kw)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        if isinstance(w, np.ndarray):
            assert w.dtype == g.dtype and np.array_equal(w, g)
        else:
            assert w == g


def _edges(seed=0, m=150, n=40):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    extra = rng.integers(-5, 5, m).astype(np.int32)
    flag = rng.random(m) < 0.5
    return src, dst, n, extra, flag


@pytest.mark.parametrize("ordering", ORDERINGS)
@pytest.mark.parametrize("chunk_size", [1, 7, 64])
def test_chunks_identical(ordering, chunk_size):
    src, dst, n, extra, flag = _edges()
    kw = dict(chunk_size=chunk_size, ordering=ordering, seed=11, window=5)
    ref = JaxStream(src, dst, n, **kw)
    port = EdgeStream(src, dst, n, device="cpu", **kw)
    assert port.n_chunks == ref.n_chunks
    flag_t = torch.from_numpy(flag)  # a tensor extra rides along too
    for a, b in zip(ref.chunks(extra, flag), port.chunks(extra, flag_t)):
        assert (a.start, a.n_valid) == (b.start, b.n_valid)
        np.testing.assert_array_equal(np.asarray(a.src), b.src.numpy())
        np.testing.assert_array_equal(np.asarray(a.dst), b.dst.numpy())
        for ea, eb in zip(a.extras, b.extras):
            np.testing.assert_array_equal(np.asarray(ea), eb.numpy())
    if ref.n_chunks > 1 and ref.n_edges % chunk_size:
        last = port.chunk_at(port.n_chunks - 1, extra)
        assert last.src.shape[0] == chunk_size  # padded with (0, 0)
        assert int(last.src[last.n_valid:].abs().sum()) == 0
        assert int(last.extras[0][last.n_valid:].abs().sum()) == 0


@pytest.mark.parametrize("ordering", ORDERINGS)
def test_scatter_back_round_trips(ordering):
    src, dst, n, extra, _ = _edges(seed=4)
    port = EdgeStream(src, dst, n, chunk_size=16, ordering=ordering, seed=3,
                      device="cpu")
    ref = JaxStream(src, dst, n, chunk_size=16, ordering=ordering, seed=3)
    stream_order = torch.cat([c.extras[0][: c.n_valid] for c in port.chunks(extra)])
    back = port.scatter_back(stream_order)
    np.testing.assert_array_equal(back.numpy(), extra)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(ref.scatter_back(jax.numpy.asarray(stream_order.numpy()))))


def test_single_chunk_stream_is_unpadded():
    src, dst, n, _, _ = _edges(m=10)
    port = EdgeStream(src, dst, n, chunk_size=64, device="cpu")
    (ch,) = list(port.chunks())
    assert ch.src.shape[0] == 10 and ch.n_valid == 10
