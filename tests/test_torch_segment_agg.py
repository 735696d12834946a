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

try:  # optional, as in tests/test_carry.py
    from hypothesis import given, settings
    from hypothesis import strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

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


def test_long_rows_listed_longest_first_and_carried():
    """Rows of more than T edges, longest first (ties by row id), carried
    by ``with_weights``; none when no row passes T."""
    from repro_torch.kernels.segment_agg import LONG_ROW_EDGES as T

    rng = np.random.default_rng(11)
    lengths = {3: T + 40, 8: T + 12, 1: T + 40, 6: T + 1, 0: T, 5: 7}
    dst = np.concatenate([np.full(m, r) for r, m in lengths.items()]).astype(np.int32)
    rng.shuffle(dst)
    src = rng.integers(0, 9, dst.size).astype(np.int32)
    lay = segment_layout(src, dst, 9, device="cpu")
    assert lay.long_rows.dtype == torch.int32 and lay.long_row_edges == T
    assert lay.long_rows.tolist() == [1, 3, 8, 6]
    again = lay.with_weights(rng.standard_normal(dst.size).astype(np.float32))
    assert torch.equal(again.long_rows, lay.long_rows) and again.long_row_edges == T
    short = segment_layout(src[dst == 0], dst[dst == 0], 9, device="cpu")
    assert short.long_rows.numel() == 0


def _edge_order_sum(p):
    """The plain version's sum of each column, edge by edge from +0.0."""
    n = p.shape[0]
    return segment_agg_ref(p, torch.arange(n), torch.zeros(n, dtype=torch.long),
                           torch.ones(n), 1)[0]


def _pairwise_sum(p):
    while p.shape[0] > 1:
        if p.shape[0] % 2:
            p = torch.cat([p, torch.zeros_like(p[:1])])
        p = p[0::2] + p[1::2]
    return 0.0 + p[0]


if HAVE_HYPOTHESIS:
    @given(n=st.integers(1, 400), q=st.integers(-140, 100), bits=st.integers(1, 24),
           seed=st.integers(0, 2**31 - 1))
    @settings(max_examples=300, deadline=None, database=None)
    def test_tree_rule_accepts_only_order_free_rows(n, q, bits, seed):
        """Products m·2^q with |m| < 2^bits (exact in float32): where the rule accepts a column,
        a reversed and a pairwise sum give the edge-order sum's bits."""
        from repro_torch.kernels.segment_agg import tree_exact

        rng = np.random.default_rng(seed)
        m = rng.integers(-(2**bits) + 1, 2**bits, (n, 3)).astype(np.float64)
        p = torch.from_numpy(np.ldexp(m, q).astype(np.float32))
        ok = tree_exact(p)
        chain = _edge_order_sum(p)
        for c in torch.nonzero(ok)[:, 0].tolist():
            col = p[:, c:c + 1]
            assert _edge_order_sum(col.flip(0)).view(torch.int32) == chain[c].view(torch.int32)
            assert _pairwise_sum(col).view(torch.int32) == chain[c].view(torch.int32)
        big = np.abs(m).max(axis=0) * n < 2.0**24  # the rule, by integers, where q is the floor
        exact_q = (m != 0).any(axis=0) & (np.gcd.reduce(m.astype(np.int64), axis=0) % 2 == 1)
        if np.isfinite(np.ldexp(m, q).astype(np.float32)).all():
            for c in np.nonzero(exact_q)[0]:
                top = np.ldexp(np.abs(m[:, c]).max() * n, q)
                assert bool(ok[c]) == bool(big[c] and top < 2.0**128)


@pytest.mark.parametrize("n,top,accepted", [(4, 2**22 - 1, True), (4, 2**22, False),
                                            (4097, 4095, True), (4097, 4096, False),
                                            (3, 2**23 - 1, False)])
def test_tree_rule_edge(n, top, accepted):
    """n·max|p| against 2^(24+q): just below is accepted, at it refused,
    at every scale q."""
    from repro_torch.kernels.segment_agg import tree_exact

    for q in (-100, -3, 0, 7, 80):
        col = np.full(n, 1.0)
        col[n // 2] = top
        p = torch.from_numpy(np.ldexp(col, q).astype(np.float32))[:, None]
        assert bool(tree_exact(p)[0]) == accepted


def test_tree_rule_refuses_non_finite_and_overflow_accepts_zeros():
    from repro_torch.kernels.segment_agg import tree_exact

    p = torch.ones(10, 5)
    p[3, 1], p[4, 2] = float("inf"), float("nan")
    p[:, 3] = -0.0
    p[:, 4] = 2.0**126  # 10·2^126 > 2^128: a partial sum would overflow
    assert tree_exact(p).tolist() == [True, False, False, True, False]
    assert _edge_order_sum(p[:, 3:4]).view(torch.int32).item() == 0  # +0.0
