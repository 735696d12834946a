"""Port parity: the count-min sketch (repro_torch.core.cms and the K4a/K4b
plain versions) against repro.core.cms and the Pallas CMS kernels in
interpret mode, with exact (bitwise) equality."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cms as jcms
from repro.kernels.cms_sketch import cms_query_kernel as j_query_kernel
from repro.kernels.cms_sketch import cms_update_kernel as j_update_kernel
from repro.kernels.cms_sketch.kernel import cms_query_tpu, cms_update_tpu
from repro.streaming import EdgeStream as JaxStream
from repro.streaming import run_carry as jax_run_carry
from repro_torch import interop
from repro_torch.core import cms as tcms
from repro_torch.kernels import cms_sketch as kcms
from repro_torch.streaming import EdgeStream, run_carry


@pytest.fixture(autouse=True)
def _threefry_partitionable():
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", prev)


def _pairs(seed, n=500, hi=200):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, hi, n).astype(np.int32)
    b = rng.integers(0, hi, n).astype(np.int32)
    return a, b


def _u32(t: torch.Tensor) -> np.ndarray:
    """Port uint32 values (int64 or int32 bit patterns) as numpy uint32."""
    return (t.to(torch.int64) & 0xFFFFFFFF).numpy().astype(np.uint32)


@pytest.mark.parametrize("seed", range(3))
def test_pair_and_vertex_keys(seed):
    a, b = _pairs(seed)
    a[:5] = -1  # negative ids hash as their uint32 bit pattern
    want = np.asarray(jcms.pair_key(jnp.asarray(a), jnp.asarray(b)))
    got = tcms.pair_key(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(want, _u32(got))
    np.testing.assert_array_equal(np.asarray(jcms.vertex_key(jnp.asarray(a))),
                                  _u32(tcms.vertex_key(torch.from_numpy(a))))


@pytest.mark.parametrize("seed", [0, 3, 17])
@pytest.mark.parametrize("width,depth", [(28, 5), (28 * 14, 5), (61, 3)])
def test_update_query_match_reference_and_pallas(seed, width, depth):
    a, b = _pairs(seed)
    rng = np.random.default_rng(seed + 100)
    counts = rng.integers(-3, 4, a.size).astype(np.int32)  # signed: wraps
    ref = jcms.make_sketch(width, depth, seed=seed)
    port = tcms.make_sketch(width, depth, seed=seed, device="cpu")
    np.testing.assert_array_equal(np.asarray(ref.seeds), _u32(port.seeds))
    jkeys = jcms.pair_key(jnp.asarray(a), jnp.asarray(b))
    tkeys = tcms.pair_key(torch.from_numpy(a), torch.from_numpy(b))
    ref = jcms.cms_update(ref, jkeys, jnp.asarray(counts))
    port = tcms.cms_update(port, tkeys, torch.from_numpy(counts))
    np.testing.assert_array_equal(np.asarray(ref.table), _u32(port.table))
    pallas = cms_update_tpu(jkeys, ref.seeds, width, depth,
                            jnp.asarray(counts).astype(jnp.uint32), interpret=True)
    np.testing.assert_array_equal(np.asarray(pallas), _u32(port.table))

    want = np.asarray(jcms.cms_query(ref, jkeys))
    got = tcms.cms_query(port, tkeys)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(want, got.numpy())
    np.testing.assert_array_equal(
        np.asarray(cms_query_tpu(ref.table, jkeys, ref.seeds, interpret=True)),
        got.numpy())
    # the reference's float32 cast of the estimates (s5p.py) agrees too
    np.testing.assert_array_equal(np.asarray(jcms.cms_query(ref, jkeys)).astype(np.float32),
                                  got.to(torch.float32).numpy())


def test_retract_merge_and_interop():
    a, b = _pairs(7)
    ref = jcms.make_sketch(28, 5, seed=2)
    jk = jcms.pair_key(jnp.asarray(a), jnp.asarray(b))
    ref = jcms.cms_update(ref, jk)
    port = interop.sketch(ref, device="cpu")
    np.testing.assert_array_equal(np.asarray(ref.table), _u32(port.table))
    tk = tcms.pair_key(torch.from_numpy(a), torch.from_numpy(b))
    half = a.size // 2
    np.testing.assert_array_equal(
        np.asarray(jcms.cms_retract(ref, jk[:half]).table),
        _u32(tcms.cms_retract(port, tk[:half]).table))
    empty = tcms.cms_retract(port, tk)
    assert int(empty.table.abs().sum()) == 0
    np.testing.assert_array_equal(np.asarray(jcms.cms_merge(ref, ref).table),
                                  _u32(tcms.cms_merge(port, port).table))
    assert port.memory_bytes() == ref.memory_bytes()


@pytest.mark.parametrize("chunk_size", [64, 1000])
def test_sketch_carry_over_a_padded_pair_stream(chunk_size):
    a, b = _pairs(11, n=300)
    ref_stream = JaxStream(a, b, 201, chunk_size=chunk_size)
    port_stream = EdgeStream(a, b, 201, chunk_size=chunk_size, device="cpu")
    _, ref = jax_run_carry(ref_stream, jcms.SketchCarry(28 * 3, 5, seed=4))
    _, port = run_carry(port_stream, tcms.SketchCarry(28 * 3, 5, seed=4, device="cpu"))
    np.testing.assert_array_equal(np.asarray(ref.table), _u32(port.table))


def test_kernel_wrappers_cpu_route_is_the_plain_version():
    a, b = _pairs(5)
    keys = tcms.pair_key(torch.from_numpy(a), torch.from_numpy(b))
    seeds = tcms.make_sketch(56, 5, seed=1, device="cpu").seeds
    counts = torch.ones_like(keys)
    table = kcms.cms_update(keys, seeds, 56, 5, counts)
    assert torch.equal(table, kcms.update_ref(keys, seeds, 56, 5, counts))
    assert torch.equal(kcms.cms_query(table, keys, seeds),
                       kcms.query_ref(table, keys, seeds))
    assert kcms.launch_counts() == {"cms_update": 0, "cms_query": 0}


@pytest.mark.parametrize("seed", [0, 5])
def test_int64_keys_high_bits_and_wrapping_counts(seed):
    """The kernels read the low 32 bits of int64 keys and counts: keys with
    high bits set (and negative) hash as their uint32 pattern, negative
    counts wrap in Z/2^32 from an empty table, as the reference's uint32
    arithmetic does."""
    a, b = _pairs(seed)
    rng = np.random.default_rng(seed)
    low = tcms.pair_key(torch.from_numpy(a), torch.from_numpy(b))
    high = torch.from_numpy(rng.integers(-2**30, 2**30, low.numel())) << 32
    keys = low + high
    assert bool((keys >> 32 != 0).any()) and bool((keys < 0).any())
    counts = torch.from_numpy(rng.integers(-9, 0, low.numel()))  # all negative
    port = tcms.cms_update(tcms.make_sketch(61, 5, seed=seed, device="cpu"), keys, counts)
    ref = jcms.cms_update(jcms.make_sketch(61, 5, seed=seed),
                          jnp.asarray(low.numpy().astype(np.uint32)),
                          jnp.asarray(counts.numpy()).astype(jnp.uint32))
    np.testing.assert_array_equal(np.asarray(ref.table), _u32(port.table))
    assert int(_u32(port.table).max()) > 2**31  # the sums wrapped
    np.testing.assert_array_equal(np.asarray(jcms.cms_query(ref, jnp.asarray(
        low.numpy().astype(np.uint32)))), tcms.cms_query(port, keys).numpy())


def test_add_into_a_given_table():
    """``cms_add`` adds into the table it is handed, in place and wrapping;
    ``cms_update`` returns the batch's own table (the reference's contract)."""
    a, b = _pairs(9)
    keys = tcms.pair_key(torch.from_numpy(a), torch.from_numpy(b))
    seeds = tcms.make_sketch(56, 5, seed=2, device="cpu").seeds
    counts = torch.from_numpy(np.random.default_rng(9).integers(-3, 4, keys.numel()))
    start = torch.from_numpy(np.random.default_rng(10).integers(
        -2**31, 2**31, (5, 56)).astype(np.int32))
    table = start.clone()
    out = kcms.cms_add(table, keys, seeds, counts)
    assert out.data_ptr() == table.data_ptr()
    want = (start.numpy().view(np.uint32)
            + kcms.cms_update(keys, seeds, 56, 5, counts).numpy().view(np.uint32))
    np.testing.assert_array_equal(table.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(kcms.add_ref(start, keys, seeds, counts).numpy(),
                                  table.numpy())
    ones = kcms.cms_update(keys, seeds, 56, 5)
    assert torch.equal(ones, kcms.update_ref(keys, seeds, 56, 5, torch.ones_like(keys)))


@pytest.mark.parametrize("width,depth,n", [(64, 4, 1000), (256, 5, 5000),
                                           (32, 3, 100)])
def test_sketch_ops_match_reference_ops(width, depth, n):
    """``repro_torch.kernels.cms_sketch.ops`` against the reference's ops,
    run as ``tests/test_kernels.py::test_cms_kernel_bit_exact`` runs them
    (the Pallas kernels, in interpret mode on the CPU)."""
    sk = jcms.make_sketch(width, depth, seed=width)
    keys = jax.random.randint(jax.random.PRNGKey(n), (n,), 0, 2**31 - 1
                              ).astype(jnp.uint32)
    ref = j_update_kernel(sk, keys)
    port_sk = tcms.make_sketch(width, depth, seed=width, device="cpu")
    tkeys = torch.from_numpy(np.asarray(keys).astype(np.int64))
    port = kcms.cms_update_kernel(port_sk, tkeys)
    assert port.seeds is port_sk.seeds and port.table is not port_sk.table
    assert int(port_sk.table.abs().sum()) == 0  # the given sketch is left as it was
    np.testing.assert_array_equal(np.asarray(ref.table), _u32(port.table))
    q = keys[: min(n, 500)]
    np.testing.assert_array_equal(np.asarray(j_query_kernel(ref, q)),
                                  kcms.cms_query_kernel(port, tkeys[:q.shape[0]]).numpy())
    twice = kcms.cms_update_kernel(port, tkeys, -torch.ones_like(tkeys))
    assert int(twice.table.abs().sum()) == 0
