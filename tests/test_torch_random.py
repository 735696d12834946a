"""Port parity: repro_torch.random is bitwise equal to jax.random
(threefry, ``jax_threefry_partitionable=True``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro_torch import random as trandom


@pytest.fixture(autouse=True)
def _threefry_partitionable():
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", prev)


def _key(k):
    return tuple(int(x) for x in np.asarray(k))


SEEDS = [0, 1, 5, 42, 2**31 - 1]


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_fold_in_split(seed):
    k = jax.random.PRNGKey(seed)
    kt = trandom.PRNGKey(seed)
    assert _key(k) == kt
    for data in (0, 1, 7, 2**32 - 1):
        assert _key(jax.random.fold_in(k, data)) == trandom.fold_in(kt, data)
    for num in (2, 3):
        ref = [_key(x) for x in jax.random.split(k, num)]
        assert ref == trandom.split(kt, num)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 2, 37, 1000])
def test_uniform_bits(seed, n):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    want = np.asarray(jax.random.uniform(key, (n,)))
    got = trandom.uniform(_key(key), (n,)).numpy()
    np.testing.assert_array_equal(want.view(np.uint32), got.view(np.uint32))


def test_uniform_2d_and_fold_in_vectorized():
    key = jax.random.PRNGKey(9)
    want = np.asarray(jax.random.uniform(key, (4, 6)))
    got = trandom.uniform(_key(key), (4, 6)).numpy()
    np.testing.assert_array_equal(want.view(np.uint32), got.view(np.uint32))
    import torch

    data = torch.arange(5)
    y0, y1 = trandom.fold_in(_key(key), data)
    for i in range(5):
        assert (int(y0[i]), int(y1[i])) == _key(jax.random.fold_in(key, i))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lo,hi,n", [(1, 2**31 - 1, 5), (0, 10, 17), (-50, 1000, 9),
                                     (3, 3, 4)])
def test_randint(seed, lo, hi, n):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.randint(key, (n,), lo, hi, dtype=jnp.int32))
    got = trandom.randint(_key(key), (n,), lo, hi).numpy()
    np.testing.assert_array_equal(want, got)
