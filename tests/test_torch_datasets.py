"""Port parity for the GNN datasets: NumPy on both sides, so every array of
``repro_torch.graphs.datasets`` equals ``repro.graphs.datasets``'s bitwise."""

import numpy as np
import pytest

from repro.graphs import datasets as jd
from repro_torch.graphs import datasets as td


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("seed", [0, 1])
def test_cora_like(seed):
    _same(td.cora_like(seed), jd.cora_like(seed))


@pytest.mark.parametrize("seed,scale", [(0, 1e-3), (3, 2e-3)])
def test_ogbn_products_like(seed, scale):
    got = td.ogbn_products_like(seed, scale)
    _same(got, jd.ogbn_products_like(seed, scale))
    assert got.n_vertices == int(2_449_029 * scale) and got.features is None


@pytest.mark.parametrize("seed,d_feat", [(0, 100), (2, 16)])
def test_products_features(seed, d_feat):
    nodes = np.array([0, 1, 2, 999, 123_456, 2_449_028], np.int64)
    got = td.products_features(nodes, d_feat, seed)
    assert got.dtype == np.float32 and got.shape == (nodes.size, d_feat)
    np.testing.assert_array_equal(got, jd.products_features(nodes, d_feat, seed))
