"""Port parity for K5's plain version (segment aggregation).

``repro_torch.kernels.segment_agg`` on the CPU against the live reference:
``repro.kernels.segment_agg.segment_agg_ref`` (gather + ``segment_sum``)
and ``segment_aggregate`` (the Pallas kernel in interpret mode, as
``tests/test_kernels.py`` runs it), bitwise in float32 and in bfloat16:
both form each message as one float32 product and add a row's messages in
edge order (the interpret-mode kernel sorts stably by dst and adds
``onehot·(x·w)``, exact for the row's own edge and +0 for the others).
Then the plain version alone against ``np.add.at`` (unbuffered, in index
order) on a hub row of 10^5 edges, padding, empty rows and
``n_rows > max(dst) + 1``, and the reusable layout.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segment_agg import segment_agg_ref as jref
from repro.kernels.segment_agg import segment_aggregate as jaggregate
from repro_torch.kernels.segment_agg import (segment_agg, segment_agg_ref,
                                             segment_aggregate, segment_layout)

SWEEP = [(200, 1000, 32), (513, 4097, 64), (64, 100, 16)]


def _inputs(V, E, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((V, d)).astype(np.float32)
    src = rng.integers(0, V, E).astype(np.int32)
    dst = rng.integers(0, V, E).astype(np.int32)
    w = rng.standard_normal(E).astype(np.float32)
    return x, src, dst, w


def _pair(x, dtype):
    if dtype == "float32":
        return jnp.asarray(x), torch.from_numpy(x)
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("V,E,d", SWEEP)
def test_plain_equals_reference_and_interpret_kernel(V, E, d, dtype):
    x, src, dst, w = _inputs(V, E, d, seed=V + E)
    jx, tx = _pair(x, dtype)
    want_ref = _np(jref(jx, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w), V))
    want_pallas = _np(jaggregate(jx, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w), V))
    got = segment_aggregate(tx, src, dst, w, V, device="cpu")
    assert got.dtype == tx.dtype and got.shape == (V, d)
    got = got.float().numpy()
    np.testing.assert_array_equal(got, want_ref)
    np.testing.assert_array_equal(got, want_pallas)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padding_empty_rows_and_extra_rows_match_reference(dtype):
    V, E, d, n_rows = 300, 2000, 8, 420  # rows 300..419 get no edge
    x, src, dst, w = _inputs(V, E, d, seed=3)
    dst[::7] = -1  # padding
    dst[dst == 5] = 6  # an empty row inside the range
    jx, tx = _pair(x, dtype)
    want = _np(jref(jx, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w), n_rows))
    got = segment_aggregate(tx, src, dst, w, n_rows, device="cpu").float().numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[5].any() and not got[V:].any()


def test_default_weights_are_ones():
    x, src, dst, _ = _inputs(100, 700, 4, seed=4)
    want = _np(jaggregate(jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst)))
    got = segment_aggregate(torch.from_numpy(x), src, dst, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


def test_hub_row_sums_in_edge_order():
    """A row of 10^5 edges whose terms span 40 binades: any other order or
    an FMA would change the float32 sum; ``np.add.at`` adds in index order."""
    rng = np.random.default_rng(5)
    V, d = 50, 3
    E_hub, E_rest = 100_000, 5_000
    dst = np.concatenate([np.full(E_hub, 7), rng.integers(0, V, E_rest)]).astype(np.int32)
    rng.shuffle(dst)
    src = rng.integers(0, V, dst.size).astype(np.int32)
    x = (rng.standard_normal((V, d)) * np.exp(rng.uniform(-10, 10, (V, d)))).astype(np.float32)
    w = (rng.standard_normal(dst.size) * np.exp(rng.uniform(-10, 10, dst.size))).astype(np.float32)
    msg = x[src] * w[:, None]
    want = np.zeros((V, d), np.float32)
    for c in range(d):
        np.add.at(want[:, c], dst, msg[:, c])
    got = segment_aggregate(torch.from_numpy(x), src, dst, w, V, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, _np(jref(jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w), V)))
    wide = np.zeros((V, d), np.float64)
    np.add.at(wide, dst, msg.astype(np.float64))
    assert not np.array_equal(wide.astype(np.float32)[7], want[7])  # the order shows


def test_layout_is_reusable_across_tables_and_weights():
    V, E = 150, 900
    x, src, dst, w = _inputs(V, E, 6, seed=6)
    dst[:10] = -1
    lay = segment_layout(src, dst, V, device="cpu")
    assert lay.row_ptr.shape == (V + 1,) and int(lay.row_ptr[-1]) == E - 10
    assert torch.equal(lay.dst, torch.sort(lay.dst, stable=True).values)
    for seed in range(3):
        y = np.random.default_rng(seed).standard_normal((V, 5)).astype(np.float32)
        w2 = np.random.default_rng(seed + 10).standard_normal(E).astype(np.float32)
        want = _np(jref(jnp.asarray(y), jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w2), V))
        got = segment_agg(torch.from_numpy(y), lay.with_weights(w2)).numpy()
        np.testing.assert_array_equal(got, want)


def test_plain_version_is_the_layouts_cpu_path():
    V, E = 90, 500
    x, src, dst, w = _inputs(V, E, 3, seed=7)
    t = [torch.from_numpy(a) for a in (x, src, dst, w)]
    assert torch.equal(segment_agg_ref(*t, V), segment_aggregate(*t, V, device="cpu"))


def test_bad_ids_and_devices_raise():
    x, src, dst, w = _inputs(20, 50, 2, seed=8)
    dst[0] = 20
    with pytest.raises(ValueError, match="n_rows"):
        segment_aggregate(x, src, dst, w, 20, device="cpu")
    lay = segment_layout(src, np.abs(dst) % 5, 5, device="cpu")
    with pytest.raises(ValueError, match="src id"):
        segment_agg(torch.zeros(3, 2), lay)
    with pytest.raises(ValueError, match=r"\(50,\)"):
        lay.with_weights(np.ones(49, np.float32))
    meta = lay._replace(src=lay.src.to("meta"), w=lay.w.to("meta"),
                        row_ptr=lay.row_ptr.to("meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        segment_agg(torch.zeros(20, 2, device="meta"), meta)
