"""Port parity for the scoring scans: the Greedy, HDRF and grid oracles of
``repro_torch.kernels.stream_scan.ref`` and the plain version of K3 are
bitwise equal to the live ``repro.kernels.stream_scan`` (parts, load,
replica counts and partial degrees), insert and retract.

Inputs are made with numpy from a seed and handed to both sides; chunks of
53 edges make the last chunk padded, so its (0, 0) entries feed HDRF's
partial degrees as in the reference.  The reference's Pallas
``scoring_scan`` runs its fused rung in interpret mode (its tiled rung
does not run on JAX 0.9).
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from proptest import random_graph

from repro.core.baselines import _grid_dims
from repro.core.baselines import _grid_rowcol as j_grid_rowcol
from repro.kernels.stream_scan import kernel as jkernel
from repro.kernels.stream_scan import ref as jref
from repro_torch import interop
from repro_torch.kernels import stream_scan as tscan
from repro_torch.kernels.stream_scan import ref as tref
from repro_torch.streaming import EdgeStream

CHUNK = 53


def _chunks(src, dst, n):
    """The port's padded chunks, as (numpy src, numpy dst, torch src,
    torch dst, n_valid), fed identically to both sides."""
    st = EdgeStream(src, dst, n, chunk_size=CHUNK, device="cpu")
    return [(ch.src.numpy(), ch.dst.numpy(), ch.src, ch.dst, ch.n_valid)
            for ch in st.chunks()]


def _assert_carry(jc, tc):
    for a, b in zip(jc, tc):
        if isinstance(b, torch.Tensor):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        else:
            assert int(a) == b


def _run(kind, jc, tc, chunks, jstep, tstep):
    parts = []
    for js, jd, ts, td, nv in chunks:
        jc, jp = jstep(jc, jnp.asarray(js), jnp.asarray(jd))
        tc, tp = tstep(tc, ts, td)
        np.testing.assert_array_equal(np.asarray(jp), tp.numpy(), err_msg=kind)
        parts.append((js, jd, ts, td, nv, np.asarray(jp), tp))
    _assert_carry(jc, tc)
    return jc, tc, parts


def _retract_last_two(jc, tc, parts, jret, tret):
    """Delete the last two chunks (the padded one included) on both sides."""
    for js, jd, ts, td, nv, jp, tp in parts[-2:]:
        jc = jret(jc, jnp.asarray(js), jnp.asarray(jd), nv, jnp.asarray(jp))
        tc = tret(tc, ts, td, nv, tp)
    _assert_carry(jc, tc)


@pytest.mark.parametrize("k", [4, 8, 32])
@pytest.mark.parametrize("seed", [0, 2])
def test_greedy_oracle(seed, k):
    src, dst, n, _ = random_graph(seed)
    ch = _chunks(src, dst, n)
    jc, tc, parts = _run("greedy", jref.greedy_init(n, k), tref.greedy_init(n, k),
                         ch, jref.greedy_chunk, tref.greedy_chunk)
    _retract_last_two(jc, tc, parts, jref.greedy_retract_chunk,
                      tref.greedy_retract_chunk)


@pytest.mark.parametrize("lam", [0.5, 1.1, 4.0])
@pytest.mark.parametrize("k", [4, 8, 32])
def test_hdrf_oracle(k, lam):
    src, dst, n, _ = random_graph(2)
    ch = _chunks(src, dst, n)
    jc, tc, parts = _run("hdrf", jref.hdrf_init(n, k, lam), tref.hdrf_init(n, k, lam),
                         ch, jref.hdrf_chunk, tref.hdrf_chunk)
    _retract_last_two(jc, tc, parts, jref.hdrf_retract_chunk,
                      tref.hdrf_retract_chunk)


@pytest.mark.parametrize("k,k_active", [(8, 5), (32, 29)])
def test_hdrf_oracle_padded_multi_k(k, k_active):
    """A carry with k_active < k: inactive partitions never win."""
    src, dst, n, _ = random_graph(1)
    ch = _chunks(src, dst, n)
    jc, tc, parts = _run(
        "hdrf", jref.hdrf_init(n, k, 1.1, k_active=k_active),
        tref.hdrf_init(n, k, 1.1, k_active=k_active), ch, jref.hdrf_chunk,
        tref.hdrf_chunk)
    assert max(int(p.max()) for *_, p in parts) < k_active
    _retract_last_two(jc, tc, parts, jref.hdrf_retract_chunk,
                      tref.hdrf_retract_chunk)


@pytest.mark.parametrize("k", [4, 8, 32])
@pytest.mark.parametrize("seed", [0, 3])
def test_grid_oracle(seed, k):
    src, dst, n, _ = random_graph(seed)
    _, c = _grid_dims(k)
    row, col = (np.asarray(x) for x in j_grid_rowcol(n, k, c, seed))
    ch = _chunks(src, dst, n)
    jc, tc, parts = _run("grid", jref.grid_init(k, row, col, c),
                         tref.grid_init(k, row, col, c), ch, jref.grid_chunk,
                         tref.grid_chunk)
    _retract_last_two(jc, tc, parts, jref.grid_retract_chunk,
                      tref.grid_retract_chunk)


def test_hdrf_equal_large_loads_score_nan():
    """Equal active loads >= 2**15: ``eps + maxl`` rounds to ``maxl``, bal is
    0/0 and every active score NaN; jnp.argmax counts NaN as the maximum,
    so the first active partition wins — and the port agrees."""
    n, k = 40, 6
    rng = np.random.default_rng(3)
    jc = jref.hdrf_init(n, k, 1.1, k_active=4)
    jc = (jnp.full((k,), 40000, jnp.int32).at[4:].set(7), *jc[1:])
    tc = interop.hdrf_carry(jc, device="cpu")
    src = rng.integers(0, n, 60).astype(np.int32)
    dst = rng.integers(0, n, 60).astype(np.int32)
    jc, jp = jref.hdrf_chunk(jc, jnp.asarray(src), jnp.asarray(dst))
    tc, tp = tref.hdrf_chunk(tc, torch.from_numpy(src), torch.from_numpy(dst))
    assert int(jp[0]) == 0
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    _assert_carry(jc, tc)


def _warm_state(rng, n, k):
    rep = ((rng.random((n, k)) < 0.25) * rng.integers(1, 4, (n, k))).astype(np.int32)
    load = rng.integers(0, 60, k).astype(np.int32)
    pd = rng.integers(0, 12, n).astype(np.int32)
    return load, rep, pd


@pytest.mark.parametrize("mode", ["greedy", "hdrf"])
@pytest.mark.parametrize("k", [4, 8])
def test_plain_k3_against_reference_kernel(mode, k):
    """The plain K3 against the reference's Pallas ``scoring_scan`` (fused
    rung, interpret mode) on a warm state: V = 150, E = 300 with
    self-loops, insert then retract of the first 293 entries."""
    rng = np.random.default_rng(k)
    n, E = 150, 300
    src = rng.integers(0, n, E).astype(np.int32)
    dst = rng.integers(0, n, E).astype(np.int32)
    dst[::37] = src[::37]
    load, rep, pd = _warm_state(rng, n, k)
    hdrf = mode == "hdrf"
    lam = np.float32(1.1)
    jout = jkernel.scoring_scan(src, dst, load, rep, pd if hdrf else None, lam,
                                mode=mode, tiled=False, interpret=True)
    tout = tscan.scoring_scan(torch.from_numpy(src), torch.from_numpy(dst),
                              torch.from_numpy(load.copy()), torch.from_numpy(rep.copy()),
                              torch.from_numpy(pd.copy()) if hdrf else None,
                              float(lam), mode=mode)
    for a, b in zip(jout, tout):
        assert (a is None) == (b is None)
        if b is not None:
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    nv = E - 7
    jback = jkernel.scoring_scan(src, dst, *jout[1:3], jout[3], lam, mode=mode,
                                 sign=-1, parts=jout[0], n_valid=nv, tiled=False,
                                 interpret=True)
    tback = tscan.scoring_scan(torch.from_numpy(src), torch.from_numpy(dst),
                               *tout[1:3], tout[3], mode=mode, sign=-1,
                               parts=tout[0], n_valid=nv)
    for a, b in zip(jback, tback):
        if b is not None:
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("mode", ["greedy", "hdrf", "grid"])
def test_carries_resume_from_reference_state(mode):
    """A reference carry handed over mid-stream (``interop``) continues in
    the port's carry exactly as in the reference's."""
    src, dst, n, _ = random_graph(0)
    ch = _chunks(src, dst, n)
    k = 8
    if mode == "grid":
        _, c = _grid_dims(k)
        jc = jref.grid_init(k, *j_grid_rowcol(n, k, c, 0), c)
        jstep, conv = jref.grid_chunk, interop.grid_carry
        pc = tscan.GridCarry(k, *jc[1:3], c, device="cpu")
    elif mode == "greedy":
        jc, jstep, conv = jref.greedy_init(n, k), jref.greedy_chunk, interop.greedy_carry
        pc = tscan.GreedyCarry(n, k, device="cpu")
    else:
        jc, jstep, conv = jref.hdrf_init(n, k), jref.hdrf_chunk, interop.hdrf_carry
        pc = tscan.HdrfCarry(n, k, device="cpu")
    for js, jd, *_ in ch[:2]:
        jc, _ = jstep(jc, jnp.asarray(js), jnp.asarray(jd))
    tc = conv(jc, device="cpu")
    for js, jd, ts, td, nv in ch[2:]:
        jc, jp = jstep(jc, jnp.asarray(js), jnp.asarray(jd))
        tc, tp = pc.step_chunk(tc, ts, td, nv)
        np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    _assert_carry(jc, tc)


def test_make_chunk_fn_matches_the_oracles():
    src, dst, n, _ = random_graph(2)
    ch = _chunks(src, dst, n)
    _run("greedy", jref.greedy_init(n, 4), tref.greedy_init(n, 4), ch,
         jref.greedy_chunk, tscan.make_chunk_fn("greedy"))
    _run("hdrf", jref.hdrf_init(n, 4, 1.1, k_active=3),
         tref.hdrf_init(n, 4, 1.1, k_active=3), ch, jref.hdrf_chunk,
         tscan.make_chunk_fn("hdrf"))
    with pytest.raises(ValueError, match="unknown mode"):
        tscan.make_chunk_fn("dbh")


def test_select_path_is_global_on_the_card(caplog):
    tscan.reset_path_log()
    with caplog.at_level(logging.INFO):
        assert tscan.select_path(1 << 20, 32, 1 << 16, mode="hdrf", device="cuda") == "global"
        assert tscan.select_path(1 << 20, 32, 1 << 16, mode="hdrf", device="cuda") == "global"
        assert tscan.select_path(100, 4, 64, mode="greedy", device="cpu") == "oracle"
        assert tscan.select_path(1 << 20, 0, 1 << 16, consumer="cluster",
                                 device="cuda") == "global"
    assert sum("global path" in r.message for r in caplog.records) == 2
    assert tscan.scoring_state_bytes(1 << 20, 32, "hdrf") == (1 << 20) * 33 * 4 + 128
    assert tscan.scoring_state_bytes(100, 8, "greedy") == 100 * 8 * 4 + 32
    assert tscan.cluster_state_bytes(10) == (11 * 10 + 4) * 4
    tscan.reset_path_log()


def test_wrappers_validate():
    t = torch.zeros(4, dtype=torch.int32)
    rep = torch.zeros((3, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown mode"):
        tscan.scoring_scan(t, t, t[:2], rep, mode="grid")
    with pytest.raises(ValueError, match="sign"):
        tscan.scoring_scan(t, t, t[:2], rep, mode="greedy", sign=0)
    with pytest.raises(ValueError, match="retract needs"):
        tscan.scoring_scan(t, t, t[:2], rep, mode="greedy", sign=-1)
    with pytest.raises(ValueError, match="hdrf needs"):
        tscan.scoring_scan(t, t, t[:2], rep, mode="hdrf")
    m = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tscan.scoring_scan(m, m, m[:2], rep.to("meta"), mode="greedy")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tscan.grid_scan(m[:2], m, m, 1, m, m)


# ------------------------------------------------ K3's tile plan (staged)

def _k3_case(name, mode):
    """(src, dst, load, rep, pd, kw, tile, n_valid) of one tile-plan case."""
    rng = np.random.default_rng(23)
    n, k, E, tile = 90, 8, 240, 32
    kw = {}
    src = rng.integers(0, n, E).astype(np.int32)
    dst = rng.integers(0, n, E).astype(np.int32)
    load, rep, pd = _warm_state(rng, n, k)
    n_valid = E
    if name == "hub":  # vertex 5 is an endpoint of every edge
        src[:] = 5
        dst[dst == 5] = 6
    elif name == "all-new":
        load, rep, pd = (np.zeros_like(load), np.zeros_like(rep), np.zeros_like(pd))
    elif name == "repeat-across-tiles":  # a few vertices, many tiles
        src, dst = src % 6, dst % 6
        tile = 7
    elif name == "self-loops-padding":
        dst[::9] = src[::9]
        src[-11:] = 0
        dst[-11:] = 0
        n_valid = E - 11
    elif name == "tile-1":
        src, dst, tile = src[:80], dst[:80], 1
    elif name == "ragged-tile":
        tile = 37
    elif name == "k-active":
        kw["k_active"] = 5
    elif name == "loads-2^15":  # HDRF: equal loads, eps + maxl == maxl
        load = np.full(k, 40000, np.int32)
        load[6:] = 7
        kw["k_active"] = 6
    return src, dst, load, rep, pd, kw, tile, n_valid


K3_CASES = ["hub", "all-new", "repeat-across-tiles", "self-loops-padding", "tile-1",
            "ragged-tile", "k-active", "loads-2^15"]


@pytest.mark.parametrize("mode", ["greedy", "hdrf"])
@pytest.mark.parametrize("case", K3_CASES)
def test_scoring_staged_matches_oracle(case, mode):
    """K3's shared rung (vertex slots, staged rows and partial degrees, tile
    boundaries, rows written back whole) gives the plain scan's bits, insert
    then retract, whatever the slots' numbering."""
    src, dst, load, rep, pd, kw, tile, nv = _k3_case(case, mode)
    hdrf = mode == "hdrf"
    if not hdrf:
        kw.pop("k_active", None)
    s, d = torch.from_numpy(src), torch.from_numpy(dst)

    def fresh():
        return (torch.from_numpy(load.copy()), torch.from_numpy(rep.copy()),
                torch.from_numpy(pd.copy()) if hdrf else None)

    want = tref.scoring_chunk_oracle(s, d, *fresh(), 1.1, mode=mode, **kw)
    got = tref.scoring_chunk_staged(s, d, *fresh(), 1.1, mode=mode, tile=tile,
                                    slot_seed=len(case), **kw)
    for a, b in zip(want, got):
        assert (a is None and b is None) or torch.equal(a, b), case
    if case == "loads-2^15" and hdrf:
        assert int(want[0][0]) == 0  # every active score NaN: the first wins
    back_want = tref.scoring_chunk_oracle(s, d, *want[1:4], mode=mode, sign=-1,
                                          parts=want[0], n_valid=nv)
    back = tref.scoring_chunk_staged(s, d, *got[1:4], mode=mode, sign=-1, parts=got[0],
                                     n_valid=nv, tile=tile)
    for a, b in zip(back_want, back):
        assert (a is None and b is None) or torch.equal(a, b), f"{case} retract"


@pytest.mark.parametrize("mode", ["greedy", "hdrf"])
def test_scoring_staged_matches_reference(mode):
    """The staged plan against the reference's scan, chunk by chunk."""
    src, dst, n, _ = random_graph(2)
    ch = _chunks(src, dst, n)
    k = 8
    if mode == "greedy":
        jc, tc = jref.greedy_init(n, k), tref.greedy_init(n, k)
        jstep = jref.greedy_chunk

        def tstep(c, s, d):
            parts, *_ = tref.scoring_chunk_staged(s, d, *c, mode="greedy", tile=13)
            return c, parts
    else:
        jc, tc = jref.hdrf_init(n, k, 1.1, k_active=7), tref.hdrf_init(n, k, 1.1, k_active=7)
        jstep = jref.hdrf_chunk

        def tstep(c, s, d):
            parts, *_ = tref.scoring_chunk_staged(s, d, *c[:3], float(c[3]), mode="hdrf",
                                                  k_active=7, tile=13)
            return c, parts
    _run(mode, jc, tc, ch, jstep, tstep)


def test_scoring_plan_rule():
    """Every k up to ``_MAX_K``: the stage fits one block's shared memory;
    the rung is shared exactly while a tile holds ``K3_MIN_TILE`` edges; the
    tile is the largest that fits (at most ``K3_MAX_TILE``); the rungs do
    not interleave."""
    from repro_torch.kernels.stream_scan import plan
    from repro_torch.kernels.stream_scan.kernel import _MAX_K

    rungs = []
    for k in range(1, _MAX_K + 1):
        p = plan.scoring_plan(k)
        assert p.smem_bytes <= plan.SHARED_MEM_BYTES, k
        fits = plan.SHARED_MEM_BYTES - plan.scoring_smem_bytes(k, 0)
        largest = min(plan.K3_MAX_TILE, fits // (plan.scoring_smem_bytes(k, 1)
                                                 - plan.scoring_smem_bytes(k, 0)))
        assert plan.scoring_smem_bytes(k, largest) <= plan.SHARED_MEM_BYTES
        assert (largest == plan.K3_MAX_TILE
                or plan.scoring_smem_bytes(k, largest + 1) > plan.SHARED_MEM_BYTES)
        assert p.rung == ("shared" if largest >= plan.K3_MIN_TILE else "global"), k
        if p.rung == "shared":
            assert p.tile == largest and p.smem_bytes == plan.scoring_smem_bytes(k, p.tile)
            assert 4 * p.tile <= 1 << 16  # e_pack's 16-bit fields
        rungs.append(p.rung)
    first_global = rungs.index("global")
    assert set(rungs[first_global:]) == {"global"}
    assert plan.scoring_plan(32) == plan.ScoringPlan("shared", 744, 232_272)
    assert plan.scoring_plan(256).rung == "shared" and plan.scoring_plan(4096).rung == "global"
    assert first_global + 1 == 885  # the first k on the global rung


@pytest.mark.parametrize("chain", ["K1", "K2", "K3 greedy", "K3 hdrf", "K3 retract", "G1"])
def test_latency_bound_counts_the_chain(chain):
    """edges × (shared steps × a shared round trip + reductions × a
    reduction round trip), from the chain's step counts."""
    from repro_torch.kernels.stream_scan.latency import CHAIN_STEPS, latency_bound_ms

    rt = {"shared_ns": 14.5, "redux_ns": 23.75}
    n_shared, n_redux = CHAIN_STEPS[chain]
    assert n_shared >= 2 and (n_redux > 0) == (chain in ("K3 greedy", "K3 hdrf"))
    want = 65536 * (n_shared * 14.5 + n_redux * 23.75) / 1e6
    assert latency_bound_ms(chain, 65536, rt) == pytest.approx(want, rel=1e-12)
    assert latency_bound_ms(chain, 0, rt) == 0
