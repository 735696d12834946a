"""Port parity: ``repro_torch.incremental`` (the carry store, warm-start
deltas, the S5P bundle and the drivers) against the live
``repro.incremental``.

Mirrors ``tests/test_incremental.py`` sections 1–6 on the port:

1. *CarryStore*: save → load is bitwise for all seven carries and the S5P
   bundle, the files carry the reference's path keys, dtypes and CRCs
   (the CMS table and seeds as ``uint32``), every refusal raises (CRC,
   consumer, config, stale position, structure, carry representation),
   keep-N GC and the mid-stream fallback;
2. *warm == cold*: for the composition-exact consumers a warm replay of
   the delta equals the cold run over prefix + delta bit for bit (and the
   reference's cold run); ``grow_carry``;
3. *goldens*: an empty delta reproduces the pinned sequential goldens,
   S5P's under the non-partitionable threefry mode of
   :mod:`repro_torch.random` (``5c2abcabc60d546d``);
4. *pipeline*: ``s5p_apply_delta`` bundles and ``IncrementalResult``s equal
   the reference's, with and without refinement, CMS and exact Θ; the
   quality anchor (RF within 5 % of a cold re-run, < 25 % of its folds);
5. *cross-reading*: a store written by the reference's ``cold_start``
   resumes in the port's ``run_incremental`` with the reference's
   continuation, and the reverse, for Greedy, HDRF, grid and S5P;
6. *CLI*: ``--save-carry`` / ``--resume-carry`` / ``--delta`` /
   ``--delete`` end to end, a ``file:`` stream grown by ``--append``, the
   validation messages, and the prefix CRC refusal.

Everything runs on ``device="cpu"`` (the kernels' plain versions); each
test sets the threefry mode explicitly.
"""

import hashlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.incremental as R
from proptest import random_graph
from repro.core import S5PConfig as JConfig
from repro_torch import random as trandom
from repro_torch.core.s5p import S5PConfig
from repro_torch.incremental import (CarryMismatchError, CarryStore, DeltaStream, cold_start,
                                     grow_carry, run_incremental, run_incremental_carry,
                                     s5p_apply_delta, s5p_cold_bundle)
from repro_torch.streaming import EdgeStream, run_carry, run_parallel
from repro_torch.streaming.carry import tree_leaves
from test_torch_carry_algebra import NAMES, _chunks, _fold, _impls, _same

K = 4
CPU = "cpu"


@pytest.fixture(autouse=True)
def _threefry_partitionable():
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    with trandom.threefry_partitionable(True):
        yield
    jax.config.update("jax_threefry_partitionable", prev)


# ----------------------------------------------------------------- helpers

def _h(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(np.asarray(a)).tobytes()).hexdigest()[:16]


def same_bundle(ref: dict, port: dict, what: str = "", skip=()) -> None:
    """Every key, dtype and value of two bundles (host numpy dicts) equal."""
    assert sorted(k for k in ref if k not in skip) == sorted(k for k in port if k not in skip), what
    for key in ref:
        if key in skip:
            continue
        a, b = np.asarray(ref[key]), np.asarray(port[key])
        assert a.dtype == b.dtype, (what, key, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {key}")


def same_result(ref, port, what: str = "") -> None:
    """Every field of two ``IncrementalResult``s (or ``WindowStep``s) equal."""
    assert type(ref)._fields == type(port)._fields, what
    for f in ref._fields:
        a, b = getattr(ref, f), getattr(port, f)
        if isinstance(a, np.ndarray) or hasattr(a, "shape"):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f"{what} {f}")
        else:
            assert a == b, (what, f, a, b)
    if hasattr(ref, "replay_fraction"):
        assert ref.replay_fraction == port.replay_fraction


def manifest(store_dir, step=None) -> dict:
    steps = sorted(store_dir.glob("step_*"))
    path = steps[-1] if step is None else store_dir / f"step_{step:08d}"
    return json.loads((path / "manifest.json").read_text())


def same_files(ref_dir, port_dir) -> None:
    """The two stores' latest checkpoints: equal keys, dtypes and CRCs."""
    mr, mp = manifest(ref_dir), manifest(port_dir)
    assert mr["keys"] == mp["keys"]
    assert mr["dtypes"] == mp["dtypes"]
    assert mr["crc"] == mp["crc"]


def community(n=600, c=8, deg=6, seed=3):
    from repro_torch.graphs import community_graph

    return community_graph(n, n_communities=c, avg_degree=deg, seed=seed)


# ======================================================== 1. CarryStore

def _folded(name, seed, n=23):
    jpc, tpc, nx = _impls(name, n)
    rng = np.random.default_rng(seed)
    jc, tc = _fold(jpc, tpc, _chunks(rng, nx, n=n))
    return jpc, tpc, jc, tc


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("seed", [0, 3])
def test_store_roundtrip_bitwise(name, seed, tmp_path):
    jpc, tpc, jc, tc = _folded(name, seed)
    store = CarryStore(tmp_path / "port")
    store.save(tc, consumer=name, config={"n": 23, "k": K}, stream_pos=34)
    got, meta = store.load(like=tpc.init(), consumer=name, config={"n": 23, "k": K})
    assert meta["stream_pos"] == 34
    _same(jc, got, name)
    for a, b in zip(tree_leaves(got), tree_leaves(tc)):  # the port's dtypes back
        assert type(a) is type(b)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
    # the file is the reference's: keys, dtypes (uint32 CMS), CRCs, meta
    R.CarryStore(tmp_path / "ref").save(jc, consumer=name, config={"n": 23, "k": K},
                                        stream_pos=34)
    same_files(tmp_path / "ref", tmp_path / "port")


def test_store_roundtrip_s5p_bundle(tmp_path):
    src, dst, n, _ = random_graph(1)
    cfg = S5PConfig(k=K, chunk_size=64)
    _, b = s5p_cold_bundle(src, dst, n, cfg, device=CPU)
    store = CarryStore(tmp_path / "p")
    store.save(b, consumer="s5p", config={"k": K}, stream_pos=len(src))
    got, _ = store.load(consumer="s5p", config={"k": K})
    same_bundle(b, got)
    _, jb = R.s5p_cold_bundle(src, dst, n, JConfig(k=K, chunk_size=64))
    R.CarryStore(tmp_path / "j").save(jb, consumer="s5p", config={"k": K},
                                      stream_pos=len(src))
    same_files(tmp_path / "j", tmp_path / "p")


def test_store_rejects_corruption(tmp_path):
    _, tpc, _, tc = _folded("degree", 0, 16)
    store = CarryStore(tmp_path)
    path = store.save(tc, consumer="degree", config={}, stream_pos=34)
    with np.load(path / "arrays.npz") as z:
        arrays = {k: z[k].copy() for k in z.files}
    key = next(k for k in arrays if k != "meta")
    arrays[key].flat[0] += 1
    np.savez(path / "arrays.npz", **arrays)
    with pytest.raises(IOError, match="corruption"):
        store.load(like=tpc.init())


def test_store_rejects_mismatches(tmp_path, monkeypatch):
    _, tpc, _, tc = _folded("degree", 0, 16)
    store = CarryStore(tmp_path / "s")
    store.save(tc, consumer="degree", config={"k": 4}, stream_pos=34)
    with pytest.raises(CarryMismatchError, match="consumer"):
        store.load(like=tpc.init(), consumer="hdrf")
    with pytest.raises(CarryMismatchError, match="fingerprint"):
        store.load(like=tpc.init(), config={"k": 8})
    with pytest.raises(CarryMismatchError, match="stream position"):
        store.load(like=tpc.init(), max_stream_pos=33)
    _, other, _ = _impls("hdrf", 16)
    with pytest.raises(CarryMismatchError, match="structure"):
        store.load(like=other.init())
    got, _ = store.load(like=tpc.init(), consumer="degree", config={"k": 4},
                        max_stream_pos=34)
    assert torch.equal(got, tc)
    # a carry of another representation generation (a monotone writer)
    from repro_torch.incremental import store as store_mod

    old = CarryStore(tmp_path / "v1")
    with monkeypatch.context() as mp:
        mp.setattr(store_mod, "CARRY_REPR", 1)
        old.save(tpc.init(), consumer="degree", config={"n": 8}, stream_pos=0)
    with pytest.raises(CarryMismatchError, match="representation"):
        old.load(consumer="degree", config={"n": 8})
    # and the reference's refusal of the same file agrees
    with pytest.raises(R.CarryMismatchError, match="representation"):
        R.CarryStore(tmp_path / "v1").load(consumer="degree", config={"n": 8})


def test_store_mid_stream_fallback_and_keep_n(tmp_path):
    _, tpc, _, mid = _folded("degree", 0, 8)
    store = CarryStore(tmp_path / "a")
    store.save(mid, consumer="degree", config={}, stream_pos=10)
    _, _, _, late = _folded("degree", 1, 8)
    store.save(late, consumer="degree", config={}, stream_pos=20)
    got, meta = store.load(like=tpc.init(), max_stream_pos=15)
    assert meta["stream_pos"] == 10 and torch.equal(got, mid)
    with pytest.raises(CarryMismatchError, match="stream position"):
        store.load(like=tpc.init(), max_stream_pos=5)
    keep = CarryStore(tmp_path / "b", keep=2)
    for pos in (10, 20, 30, 40):
        keep.save(late, consumer="degree", config={}, stream_pos=pos)
    assert keep.steps() == [30, 40]
    assert keep.load(like=tpc.init())[1]["stream_pos"] == 40


# ================================================== 2. warm == cold
EXACT = ["degree", "sketch", "cluster", "greedy", "grid", "assign"]


@pytest.mark.parametrize("name", EXACT)
@pytest.mark.parametrize("graph_seed", [0, 1])
def test_warm_start_equals_cold_bitwise(name, graph_seed, tmp_path):
    from repro.streaming import EdgeStream as JStream
    from repro.streaming import run_carry as j_run_carry

    src, dst, n, _ = random_graph(graph_seed)
    E = len(src)
    E0 = int(E * 0.7)
    jpc, tpc, nx = _impls(name, n)
    extras = ()
    if nx:
        rng = np.random.default_rng(0)
        extras = (rng.integers(0, 2, E).astype(bool),
                  rng.integers(0, 8, E).astype(np.int32),
                  rng.integers(0, 8, E).astype(np.int32))
    cs = 13  # unaligned with E0: padding sits mid-stream
    pre_parts, pre = run_carry(EdgeStream(src[:E0], dst[:E0], n, chunk_size=cs, device=CPU),
                               tpc, *(e[:E0] for e in extras))
    store = CarryStore(tmp_path / name)
    store.save(pre, consumer=name, config={"n": n}, stream_pos=E0)
    restored, _ = store.load(like=tpc.init(), consumer=name, config={"n": n},
                             max_stream_pos=E)
    warm_parts, warm = run_incremental_carry(
        DeltaStream(src[E0:], dst[E0:], n, base_offset=E0, chunk_size=cs, device=CPU),
        tpc, *(e[E0:] for e in extras), carry=restored)
    cold_parts, cold = run_carry(EdgeStream(src, dst, n, chunk_size=cs, device=CPU),
                                 tpc, *extras)
    _same(tree_leaves(cold), warm, name)
    jparts, jcold = j_run_carry(JStream(src, dst, n, chunk_size=cs), jpc,
                                *(jnp.asarray(e) for e in extras))
    _same(jcold, warm, name)
    if cold_parts is not None:
        joined = torch.cat([pre_parts, warm_parts])
        assert torch.equal(joined, cold_parts)
        np.testing.assert_array_equal(joined.numpy(), np.asarray(jparts))


def test_warm_start_parallel_ingest_linear_carries():
    from repro_torch.core.clustering import DegreeCarry, compute_degrees

    src, dst, n, _ = random_graph(2)
    E0 = int(len(src) * 0.6)
    want = compute_degrees(torch.from_numpy(src), torch.from_numpy(dst), n)
    _, pre = run_carry(EdgeStream(src[:E0], dst[:E0], n, chunk_size=17, device=CPU),
                       DegreeCarry(n, device=CPU))
    for S in (1, 2, 4):
        _, warm = run_parallel(DeltaStream(src[E0:], dst[E0:], n, chunk_size=17, device=CPU),
                               DegreeCarry(n, device=CPU), num_streams=S, super_chunk=2,
                               carry=pre.clone())
        assert torch.equal(warm, want), S


def test_grow_carry_extends_by_identity():
    src, dst, n, _ = random_graph(1)
    n_big = n + 13
    for name in ("greedy", "hdrf", "cluster", "degree", "sketch", "assign"):
        _, small, _ = _impls(name, n)
        _, big, _ = _impls(name, n_big)
        _same(tree_leaves(big.init()), grow_carry(name, small.init(), n, n_big, k=K), name)
    # the grid's hashed tables: grown == built at the larger size, and the
    # reference's grown tables
    from repro.incremental import grow_carry as j_grow
    from repro.incremental.driver import _scan_carry as j_scan_carry
    from repro_torch.incremental.driver import _scan_carry

    grown = grow_carry("grid", _scan_carry("grid", n, K, 3, CPU).init(), n, n_big, k=K, seed=3)
    _same(tree_leaves(_scan_carry("grid", n_big, K, 3, CPU).init()), grown, "grid")
    jgrown = j_grow("grid", j_scan_carry("grid", n, K, 3).init(), n, n_big, k=K, seed=3)
    _same(jgrown, grown, "grid vs reference")
    with pytest.raises(ValueError, match="shrink"):
        grow_carry("degree", torch.zeros(4, dtype=torch.int32), 4, 2)


# ==================================================== 3. golden anchor
GOLDEN_EMPTY = {
    (0, "hdrf"): "b4ebed498be31d51",
    (1, "hdrf"): "dd6c23e3a17a526d",
    (0, "greedy"): "97490d30834620fa",
    (1, "greedy"): "ef351eb5d7f38e6e",
    (0, "s5p"): "5c2abcabc60d546d",
    (1, "s5p"): "173c8ab805ce8473",
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["greedy", "hdrf"])
def test_empty_delta_reproduces_goldens_scans(seed, name, tmp_path):
    src, dst, n, _ = random_graph(seed)
    cold_start(tmp_path / name, name, src, dst, n, K, device=CPU)
    res = run_incremental(tmp_path / name, name, src, dst, n, K, save=False, device=CPU)
    assert res.n_delta_edges == 0 and res.edges_replayed == 0
    assert _h(res.parts) == GOLDEN_EMPTY[(seed, name)]


@pytest.mark.parametrize("seed", [0, 1])
def test_empty_delta_reproduces_goldens_s5p(seed, tmp_path):
    """The pinned goldens hold under the non-partitionable threefry mode
    (ROADMAP Queue 3 b): the port reproduces them itself."""
    src, dst, n, _ = random_graph(seed)
    cfg = S5PConfig(k=K, use_cms=False, game_accept_prob=0.7, game_max_rounds=64, seed=0)
    with trandom.threefry_partitionable(False):
        cold_start(tmp_path / "s5p", "s5p", src, dst, n, K, s5p_config=cfg, device=CPU)
        res = run_incremental(tmp_path / "s5p", "s5p", src, dst, n, K, s5p_config=cfg,
                              save=False, device=CPU)
    assert res.n_delta_edges == 0 and not res.refined
    assert _h(res.parts) == GOLDEN_EMPTY[(seed, "s5p")]


def test_threefry_modes_equal_jax():
    """``split``, ``uniform`` and ``randint`` in both modes, and the mode
    switch restores the default on exit."""
    for flag in (False, True):
        jax.config.update("jax_threefry_partitionable", flag)
        with trandom.threefry_partitionable(flag):
            assert trandom.partitionable() is flag
            for seed in (0, 7):
                k = jax.random.PRNGKey(seed)
                kt = trandom.PRNGKey(seed)
                assert [tuple(int(x) for x in np.asarray(s)) for s in jax.random.split(k, 3)] \
                    == trandom.split(kt, 3)
                for n in (1, 2, 37):
                    np.testing.assert_array_equal(
                        np.asarray(jax.random.uniform(k, (n,))).view(np.uint32),
                        trandom.uniform(kt, (n,)).numpy().view(np.uint32))
                    np.testing.assert_array_equal(
                        np.asarray(jax.random.randint(k, (n,), 1, 2**31 - 1)),
                        trandom.randint(kt, (n,), 1, 2**31 - 1).numpy())
    assert trandom.partitionable()


# =========================================== 4. the S5P delta pipeline

@pytest.mark.parametrize("use_cms", [True, False])
@pytest.mark.parametrize("refine", ["off", "drift", "always"])
def test_apply_delta_equals_the_reference(use_cms, refine):
    src, dst, n = community()
    E = len(src)
    E0 = int(E * 0.9)
    kw = dict(k=8, use_cms=use_cms, chunk_size=512)
    if refine == "off":
        kw.update(drift_rf_threshold=float("inf"), drift_balance_threshold=float("inf"),
                  drift_churn_threshold=float("inf"))
    elif refine == "always":
        kw.update(drift_rf_threshold=0.0, refine_rounds=16)
    _, jb = R.s5p_cold_bundle(src[:E0], dst[:E0], n, JConfig(**kw))
    _, tb = s5p_cold_bundle(src[:E0], dst[:E0], n, S5PConfig(**kw), device=CPU)
    same_bundle(jb, tb, "cold")
    # the insertion names vertices past the base table: the carry grows
    grow = np.array([n, n + 1, 5], np.int32)
    fs, fd = np.concatenate([src, grow]), np.concatenate([dst, grow[::-1]])
    jb2, jr = R.s5p_apply_delta(jb, JConfig(**kw), fs, fd, E0)
    tb2, tr = s5p_apply_delta(tb, S5PConfig(**kw), fs, fd, E0, device=CPU)
    same_bundle(jb2, tb2, "delta")
    same_result(jr, tr, "delta")
    assert tr.refined == (refine == "always") or refine == "drift"
    # an empty delta, then a position mismatch
    _, jr0 = R.s5p_apply_delta(jb2, JConfig(**kw), fs, fd, len(fs))
    _, tr0 = s5p_apply_delta(tb2, S5PConfig(**kw), fs, fd, len(fs), device=CPU)
    same_result(jr0, tr0, "empty")
    with pytest.raises(ValueError, match="position"):
        s5p_apply_delta(tb2, S5PConfig(**kw), fs, fd, E0, device=CPU)


def test_incremental_s5p_quality_anchor(tmp_path):
    """10 % delta + drift-triggered refinement: RF within 5 % of the cold
    full re-run while replaying < 25 % of the folds a cold run costs."""
    from repro_torch.core.metrics import replication_factor
    from repro_torch.core.s5p import s5p_partition

    src, dst, n = community(1200, 24, 8, 5)
    E = len(src)
    E0 = int(E * 0.9)
    k = 8
    cfg = S5PConfig(k=k, use_cms=False, chunk_size=512, drift_rf_threshold=0.0,
                    refine_rounds=16)
    cold_start(tmp_path / "s5p", "s5p", src[:E0], dst[:E0], n, k, s5p_config=cfg, device=CPU)
    res = run_incremental(tmp_path / "s5p", "s5p", src, dst, n, k, s5p_config=cfg,
                          save=False, device=CPU)
    assert res.refined and res.n_delta_edges == E - E0
    p = res.parts
    valid = src != dst
    assert p.shape == src.shape
    assert np.all(p[valid] >= 0) and np.all(p[valid] < k) and np.all(p[~valid] == -1)
    cold = s5p_partition(src, dst, n, cfg, device=CPU)
    rf_cold = replication_factor(torch.from_numpy(src), torch.from_numpy(dst), cold.parts,
                                 n_vertices=n, k=k)
    assert res.rf <= rf_cold * 1.05, (res.rf, rf_cold)
    assert res.replay_fraction < 0.25, res.replay_fraction


# ================================================ 5. cross-reading stores

def _split_graph(name):
    if name == "s5p":
        src, dst, n = community(400, 6, 6, 2)
    else:
        src, dst, n, _ = random_graph(1)
    return np.asarray(src, np.int32), np.asarray(dst, np.int32), n


@pytest.mark.parametrize("name", ["greedy", "hdrf", "grid", "s5p"])
def test_reference_store_resumes_in_the_port_and_back(name, tmp_path):
    src, dst, n = _split_graph(name)
    E = len(src)
    E0 = int(E * 0.75)
    dl = np.arange(1, E, 9)
    kw = dict(chunk_size=64 if name == "s5p" else 13)
    tcfg = dict(s5p_config=S5PConfig(k=K, chunk_size=64)) if name == "s5p" else {}
    jcfg = dict(s5p_config=JConfig(k=K, chunk_size=64)) if name == "s5p" else {}
    R.cold_start(tmp_path / "ref", name, src[:E0], dst[:E0], n, K, **kw, **jcfg)
    cold_start(tmp_path / "port", name, src[:E0], dst[:E0], n, K, **kw, **tcfg, device=CPU)
    same_files(tmp_path / "ref", tmp_path / "port")
    # the reference's store resumes in the port ...
    tr = run_incremental(tmp_path / "ref", name, src, dst, n, K, delete=dl,
                         save_dir=tmp_path / "ref_port", **kw, **tcfg, device=CPU)
    # ... and the port's in the reference, each with the other's result
    jr = R.run_incremental(tmp_path / "port", name, src, dst, n, K, delete=dl,
                           save_dir=tmp_path / "port_ref", **kw, **jcfg)
    same_result(jr, tr, name)
    assert tr.n_delta_edges == E - E0 and tr.n_retracted == dl.size
    same_files(tmp_path / "port_ref", tmp_path / "ref_port")
    # the saved continuations resume again, crosswise, to an empty delta
    t2 = run_incremental(tmp_path / "port_ref", name, src, dst, n, K, save=False, **kw,
                         **tcfg, device=CPU)
    j2 = R.run_incremental(tmp_path / "ref_port", name, src, dst, n, K, save=False, **kw,
                           **jcfg)
    same_result(j2, t2, name + " resumed")
    assert t2.n_delta_edges == 0


def test_foreign_stream_rejected_by_prefix_crc(tmp_path):
    src, dst, n, _ = random_graph(0)
    cold_start(tmp_path / "c", "greedy", src, dst, n, K, device=CPU)
    other = np.array(src, np.int32)
    other[0] = (other[0] + 1) % n  # same length, different first edge
    full_src = np.concatenate([other, src[:3]])
    full_dst = np.concatenate([np.asarray(dst, np.int32), dst[:3]])
    with pytest.raises(CarryMismatchError, match="foreign"):
        run_incremental(tmp_path / "c", "greedy", full_src, full_dst, n, K, save=False,
                        device=CPU)


# ============================================================ 6. CLI e2e

def test_incremental_cli_e2e_ooc_append(tmp_path):
    from repro_torch.launch import partition as cli
    from repro_torch.streaming import ShardedEdgeStream

    g = tmp_path / "g"
    store = tmp_path / "carry"
    cli.write_shards_cli("rmat:9", str(g), 2048)
    rows = cli.run(f"file:{g}/manifest.json", K, "hdrf", chunk_size=1024,
                   save_carry=str(store), device=CPU)
    assert rows[0][0] == "hdrf"
    cli.write_shards_cli("rmat:8", str(g), 2048, append=True)
    res = cli.run(f"file:{g}/manifest.json", K, "hdrf", chunk_size=1024,
                  resume_carry=str(store), device=CPU)
    assert res.n_delta_edges > 0
    with ShardedEdgeStream(g / "manifest.json", device=CPU) as st:
        src, dst = st.arrival_arrays()
    valid = src != dst
    p = res.parts
    assert p.shape == src.shape and np.all(p[valid] >= 0) and np.all(p[valid] < K)
    # the reference CLI resumes the same grown store to an empty delta
    from repro.launch import partition as jcli

    jres = jcli.run(f"file:{g}/manifest.json", K, "hdrf", chunk_size=1024,
                    resume_carry=str(store), save_carry=str(tmp_path / "j"))
    assert jres.n_delta_edges == 0 and np.array_equal(jres.parts, res.parts)
    res2 = cli.run(f"file:{g}/manifest.json", K, "hdrf", chunk_size=1024,
                   resume_carry=str(store), device=CPU)
    assert res2.n_delta_edges == 0 and np.array_equal(res2.parts, res.parts)


def test_incremental_cli_delta_spec_and_validation(tmp_path):
    from repro.launch import partition as jcli
    from repro_torch.launch import partition as cli

    store = tmp_path / "carry"
    cli.run("toy", K, "greedy", save_carry=str(store), device=CPU)
    res = cli.run("toy", K, "greedy", resume_carry=str(store), delta="rmat:5",
                  delete="frac:0.1", save_carry=str(tmp_path / "next"), device=CPU)
    jstore = tmp_path / "jcarry"
    jcli.run("toy", K, "greedy", save_carry=str(jstore))
    jres = jcli.run("toy", K, "greedy", resume_carry=str(jstore), delta="rmat:5",
                    delete="frac:0.1")
    same_result(jres, res, "cli")
    assert res.n_delta_edges > 0 and res.n_retracted > 0
    for spec in ("first:3", "last:0.25", "frac:0.5", "frac:0"):
        np.testing.assert_array_equal(cli._parse_delete(spec, 40, 2),
                                      jcli._parse_delete(spec, 40, 2))
    with pytest.raises(ValueError, match="unknown --delete"):
        cli._parse_delete("some:3", 40, 0)
    for kw, err, match in [
            (dict(compare=True, save_carry=str(store)), ValueError, "single --partitioner"),
            (dict(delta="rmat:5"), ValueError, "resume-carry"),
            (dict(delete="first:2"), ValueError, "resume-carry"),
            (dict(ordering="shuffled", save_carry=str(store)), ValueError, "natural"),
            (dict(window_edges=64, save_carry=str(store)), ValueError, "does not combine"),
            (dict(window_edges=64), ValueError, "s5p pipeline"),
            (dict(resize_k=8), ValueError, "s5p warm bundle"),
            (dict(resize_k=8, compare=True), ValueError, "resize-k")]:
        with pytest.raises(err, match=match):
            cli.run("toy", K, "greedy", device=CPU, **kw)
    with pytest.raises(ValueError, match="incremental bundle"):
        cli.run("toy", K, "hash", save_carry=str(tmp_path / "x"), device=CPU)
    with pytest.raises(CarryMismatchError):
        cli.run("toy", 8, "greedy", resume_carry=str(store), device=CPU)


def test_cli_window_equals_the_reference():
    from repro.launch import partition as jcli
    from repro_torch.launch import partition as cli

    kw = dict(window_edges=512, window_step=256, chunk_size=256)
    hist = cli.run("community:600", K, "s5p", device=CPU, **kw)
    jhist = jcli.run("community:600", K, "s5p", **kw)
    assert len(hist) == len(jhist) >= 3
    for a, b in zip(jhist, hist):
        same_result(a, b, "window step")
