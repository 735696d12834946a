"""K2's plan (``ref.assign_chunk_planned``: packed records, room pointers,
the fill of the least loaded partitions once none has room, the wrap guard,
the retract as a count) held bit for bit against the port's oracle
(``assign_chunk_oracle``), the reference's ``lax.scan``
(``repro.core.postprocess._assign_chunk``) and its Pallas kernel in
interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

from repro.core import postprocess as jpost
from repro.kernels.stream_scan import assign_scan as pallas_assign_scan
from repro_torch.kernels.stream_scan import plan
from repro_torch.kernels.stream_scan.latency import retract_bytes_bound_ms
from repro_torch.kernels.stream_scan.ref import (assign_chunk_oracle,
                                                 assign_chunk_planned,
                                                 pack_assign_records,
                                                 unpack_assign_records)

INT32_MAX = 2**31 - 1


def _edges(rng, E, k, *, n_vertices=64, pad=0, head_p=0.4):
    """E edges (some self-loops) over ``n_vertices``, random endpoint
    partitions and head flags, then ``pad`` (0, 0) entries with zero extras,
    as ``EdgeStream`` pads a chunk."""
    src = rng.integers(0, n_vertices, E).astype(np.int32)
    dst = rng.integers(0, n_vertices, E).astype(np.int32)
    pcu = rng.integers(0, k, E).astype(np.int32)
    pcv = rng.integers(0, k, E).astype(np.int32)
    head = rng.random(E) < head_p
    z = np.zeros(pad, np.int32)
    return (np.concatenate([src, z]), np.concatenate([dst, z]),
            np.concatenate([head, z.astype(bool)]), np.concatenate([pcu, z]),
            np.concatenate([pcv, z]))


def _all_four(load, edges, cap):
    """(parts, load) from the plan, the oracle, the reference's scan and its
    Pallas kernel; asserts all four equal and returns the plan's, with the
    plan's mode counts."""
    src, dst, head, pcu, pcv = edges
    t = [torch.from_numpy(x) for x in (src, dst, head, pcu, pcv)]
    load_t = torch.from_numpy(np.asarray(load, np.int32))
    stats = {}
    p_plan, l_plan = assign_chunk_planned(load_t, *t, max_load=cap, stats=stats)
    p_or, l_or = assign_chunk_oracle(load_t, *t, max_load=cap)
    k = load_t.shape[0]
    l_ref, p_ref = jpost._assign_chunk(
        jnp.asarray(load, jnp.int32), cap, jnp.asarray(src), jnp.asarray(dst),
        jnp.asarray(head), jnp.asarray(pcu), jnp.asarray(pcv),
        jnp.arange(k, dtype=jnp.int32), k=k)
    p_pl, l_pl = pallas_assign_scan(jnp.asarray(load, jnp.int32), src, dst,
                                    jnp.asarray(head), pcu, pcv, max_load=cap,
                                    interpret=True)
    for p, l in ((p_or, l_or), (p_ref, l_ref), (p_pl, l_pl)):
        np.testing.assert_array_equal(np.asarray(p), p_plan.numpy())
        np.testing.assert_array_equal(np.asarray(l), l_plan.numpy())
    return p_plan, l_plan, stats


@pytest.mark.parametrize("low", [64, 2])
@pytest.mark.parametrize("k", [1, 2, 31, 32, 33, 256, 4096])
def test_planned_matches_oracle_reference_and_pallas(k, low):
    """Loads drawn from cap - ``low`` … cap + 2 (cap - 64 … cap + 2 as the
    chip rows draw them; cap - 2 … cap + 2 runs out of room mid-chunk at
    small k); 64 padding entries at the end."""
    rng = np.random.default_rng(1000 * k + low)
    E = 700
    cap = 5000
    load = rng.integers(cap - low, cap + 3, k)
    _, l_plan, stats = _all_four(load, _edges(rng, E, k, pad=64), cap)
    assert stats["wrap"] == 0
    assert stats["room"] + stats["full"] == E + 64
    if low == 2 and k <= 33:  # the room ran out: every later edge overflows
        assert stats["full"] > 0


@pytest.mark.parametrize("profile", ["level", "spread", "lagging"])
@pytest.mark.parametrize("k", [1, 5, 32, 33, 100, 4096])
def test_planned_no_room(k, profile):
    """Every partition full from the start: each valid edge takes the least
    loaded, lowest index on ties; loads at one level, spread over four, or
    one partition far below the rest (it takes the picks level by level)."""
    rng = np.random.default_rng(k)
    cap = 300
    if profile == "level":
        load = np.full(k, cap)
    elif profile == "spread":
        load = rng.integers(cap, cap + 4, k)
    else:
        load = np.full(k, cap + 50)
        load[k // 2] = cap
    E = 400 if k == 4096 else 1500
    edges = _edges(rng, E, k, pad=32)
    _, _, stats = _all_four(load, edges, cap)
    assert stats["full"] == E + 32 and stats["room"] == 0
    assert stats["overflow"] == int((edges[0] != edges[1]).sum())


@pytest.mark.parametrize("k", [1, 3, 32, 40])
def test_planned_wrap_guard(k):
    """cap = 2^31 - 1 (S5P-B): loads within n of it wrap to INT32_MIN, which
    has room again; the chunk runs the oracle's statement order."""
    rng = np.random.default_rng(7 + k)
    E = 300
    load = INT32_MAX - rng.integers(0, 6, k)
    p, l_plan, stats = _all_four(load, _edges(rng, E, k, head_p=0.5), INT32_MAX)
    assert stats["wrap"] == E
    assert int(l_plan.min()) < 0  # something wrapped


def test_planned_just_below_the_wrap_guard():
    """Loads exactly n below 2^31 - 1 cannot wrap: the room mode runs, and
    loads reach 2^31 - 1, the cap, and fill."""
    rng = np.random.default_rng(3)
    E, k = 200, 4
    load = np.full(k, INT32_MAX - E)
    _, l_plan, stats = _all_four(load, _edges(rng, E, k), INT32_MAX)
    assert stats["wrap"] == 0 and stats["room"] == E
    assert int(l_plan.min()) >= INT32_MAX - E


def test_planned_room_to_full_at_the_last_room():
    """One partition with one unit of room: the first valid edge fills it
    and the rest of the chunk takes the least loaded partitions."""
    rng = np.random.default_rng(11)
    k, cap, E = 6, 40, 100
    load = np.array([cap + 1, cap, cap - 1, cap + 3, cap, cap + 1])
    _, _, stats = _all_four(load, _edges(rng, E, k), cap)
    assert stats["room"] >= 1 and stats["full"] >= 1


@pytest.mark.parametrize("n_valid", [0, 1, 333, 700])
@pytest.mark.parametrize("k", [1, 32, 4096])
def test_planned_retract(k, n_valid):
    """Insert a chunk, then retract its first ``n_valid`` entries: the plan's
    count equals the oracle's and the Pallas kernel's retract; parts come
    back as they were."""
    rng = np.random.default_rng(k + n_valid)
    E, cap = 700, 10**6
    load = rng.integers(-5, 50, k).astype(np.int32)
    edges = _edges(rng, E, k)
    parts, after, _ = _all_four(load, edges, cap)
    t = [torch.from_numpy(x) for x in edges]
    z = torch.zeros(E, dtype=torch.int32)
    p_plan, l_plan = assign_chunk_planned(after, t[0], t[1], z, z, z, max_load=cap,
                                          sign=-1, parts=parts, n_valid=n_valid)
    p_or, l_or = assign_chunk_oracle(after, t[0], t[1], z, z, z, max_load=cap,
                                     sign=-1, parts=parts, n_valid=n_valid)
    zj = jnp.zeros(E, jnp.int32)
    p_pl, l_pl = pallas_assign_scan(jnp.asarray(after.numpy()), edges[0], edges[1],
                                    zj, zj, zj, max_load=cap, sign=-1,
                                    parts=jnp.asarray(parts.numpy()), n_valid=n_valid,
                                    interpret=True)
    assert torch.equal(p_plan, parts) and torch.equal(p_or, parts)
    np.testing.assert_array_equal(np.asarray(p_pl), parts.numpy())
    assert torch.equal(l_plan, l_or)
    np.testing.assert_array_equal(np.asarray(l_pl), l_plan.numpy())
    if n_valid == E:
        assert torch.equal(l_plan, torch.from_numpy(load))


def test_planned_retract_wraps_in_int32():
    """A load at INT32_MIN gives back a unit and wraps to INT32_MAX, as the
    oracle's int32 arithmetic does."""
    load = torch.tensor([-2**31, 5], dtype=torch.int32)
    src = torch.tensor([1, 2, 3], dtype=torch.int32)
    dst = torch.tensor([2, 3, 3], dtype=torch.int32)
    parts = torch.tensor([0, 1, 0], dtype=torch.int32)
    z = torch.zeros(3, dtype=torch.int32)
    _, got = assign_chunk_planned(load, src, dst, z, z, z, max_load=1, sign=-1,
                                  parts=parts, n_valid=3)
    _, want = assign_chunk_oracle(load, src, dst, z, z, z, max_load=1, sign=-1,
                                  parts=parts, n_valid=3)
    assert torch.equal(got, want)
    assert got.tolist() == [INT32_MAX, 4]


def test_record_packing_round_trip_k4096():
    """Every partition id below 4,096 in either field, both flags, and the
    limit: unpacking gives back what was packed."""
    rng = np.random.default_rng(4096)
    E = 3 * 4096
    pcu = torch.from_numpy(np.concatenate([np.arange(4096), rng.integers(0, 4096, 2 * 4096)])
                           .astype(np.int32))
    pcv = torch.from_numpy(np.concatenate([rng.integers(0, 4096, 4096), np.arange(4096)[::-1],
                                           rng.integers(0, 4096, 4096)]).astype(np.int32))
    src = torch.from_numpy(rng.integers(0, 5, E).astype(np.int32))
    dst = torch.from_numpy(rng.integers(0, 5, E).astype(np.int32))
    head = torch.from_numpy(rng.random(E) < 0.5)
    limit = E - 1000
    rec = pack_assign_records(src, dst, head, pcu, pcv, limit)
    assert rec.dtype == torch.int32 and bool((rec >= 0).all())
    a, b, h, valid = unpack_assign_records(rec)
    assert torch.equal(a, pcu) and torch.equal(b, pcv) and torch.equal(h, head)
    want = (torch.arange(E) < limit) & (src != dst)
    assert torch.equal(valid, want)


def test_k2_plan_bytes_and_retract_bound():
    """K2's shared bytes at each k fit one block; the retract's bytes bound
    is 16 bytes an edge and 8 a partition at 3.35 TB/s."""
    assert plan.assign_smem_bytes(32) == 4 * (32 + 4 * plan.K2_TILE + 2 * plan.K2_GROUP + 4)
    assert plan.assign_smem_bytes(33) == 4 * (64 + 4 * plan.K2_TILE + 2 * plan.K2_GROUP + 4)
    assert plan.assign_smem_bytes(4096) <= plan.SHARED_MEM_BYTES
    assert retract_bytes_bound_ms(65536, 32) == pytest.approx(
        (16 * 65536 + 8 * 32) / 3.35e12 * 1e3)


if HAVE_HYPOTHESIS:
    @settings(max_examples=60, deadline=None, database=None)
    @given(st.integers(1, 40), st.integers(1, 120), st.integers(0, 2**32 - 1),
           st.sampled_from([2, 8, 64]), st.booleans())
    def test_planned_matches_oracle_sampled(k, E, seed, low, bounded):
        rng = np.random.default_rng(seed)
        cap = INT32_MAX if bounded else 50
        load = rng.integers(cap - low, cap + 1 if bounded else cap + 3, k)
        edges = _edges(rng, E, k, n_vertices=8, pad=int(rng.integers(0, 5)))
        t = [torch.from_numpy(x) for x in edges]
        load_t = torch.from_numpy(load.astype(np.int32))
        got = assign_chunk_planned(load_t, *t, max_load=cap)
        want = assign_chunk_oracle(load_t, *t, max_load=cap)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
