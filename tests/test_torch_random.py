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


# ------------------------------------------------- draws past 2**32 elements


def _threefry_words(key, hi: int, lo):
    """JAX's partitionable word for the counter pairs ``(hi, lo)``: its
    threefry primitive, hashed as ``_threefry_random_bits_partitionable``
    hashes the flat index ``hi·2**32 + lo``."""
    from jax._src import prng

    b1, b2 = prng.threefry2x32_p.bind(np.uint32(key[0]), np.uint32(key[1]),
                                      np.full(lo.shape, hi, np.uint32), lo.astype(np.uint32))
    return np.asarray(b1 ^ b2).astype(np.int64)


@pytest.mark.parametrize("hi", [1, 3, 2**32 - 1])
@pytest.mark.parametrize("seed", [0, 42])
def test_bits_at_past_2_32_is_jaxs_counter_pair(seed, hi):
    import torch

    key = trandom.fold_in(trandom.PRNGKey(seed), 7)
    j = np.arange(0, 4096, 37, dtype=np.int64)
    want = _threefry_words(key, hi, j)
    n = 2**64
    if hi < 2**31:  # int64 indices
        got = trandom.bits_at(key[0], key[1], n, torch.from_numpy(j) + hi * 2**32)
        assert np.array_equal(got.numpy(), want)
    assert [trandom.bits_at(key[0], key[1], n, hi * 2**32 + int(i)) for i in j[:5]] == \
        want[:5].tolist()
    sl = trandom.random_bits(key, (2**32, 2**32), "cpu", hi * 2**32, hi * 2**32 + 4096)
    assert np.array_equal(sl.numpy()[j], want)


def test_random_bits_range_straddles_2_32():
    key = trandom.PRNGKey(3)
    shape = (5, 2**31)
    got = trandom.random_bits(key, shape, "cpu", 2**32 - 6, 2**32 + 6).numpy()
    lo = np.arange(2**32 - 6, 2**32 + 6, dtype=np.int64)
    want = np.concatenate([_threefry_words(key, 0, lo[:6]), _threefry_words(key, 1, lo[6:] - 2**32)])
    assert np.array_equal(got, want)
    with pytest.raises(NotImplementedError, match="2 \\*\\* 64"):
        trandom.random_bits(key, (2**33, 2**32), "cpu", 0, 1)


def test_truncated_normal_slice_straddling_2_32_is_its_halves():
    import torch

    key = trandom.fold_in(trandom.PRNGKey(1), 2)
    shape = (3, 2**31)  # 3·2**31 elements
    a, mid, b = 2**32 - 1000, 2**32, 2**32 + 777

    def draw(start, stop):  # the slice truncated_normal(out=...) fills
        return trandom._truncated_normal_slice(key, -2.0, 2.0, shape, "cpu", start, stop, None)

    whole = draw(a, b)
    assert whole.shape == (b - a,) and torch.equal(whole, torch.cat([draw(a, mid), draw(mid, b)]))
    assert bool(((whole > -2.0) & (whole < 2.0)).all())


def test_non_partitionable_mode_still_refuses_2_32():
    with trandom.threefry_partitionable(False), pytest.raises(NotImplementedError):
        trandom.random_bits(trandom.PRNGKey(0), (2**32,), "cpu", 0, 4)
