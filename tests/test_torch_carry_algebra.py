"""Port parity: the carry merge algebra (``repro_torch.streaming.carry``)
against the live ``repro.streaming.carry`` on all seven carries.

Both sides fold the same random chunks (numpy, seeded) from their
identity carries; every folded carry, merge (with and without a base,
pick-first, stacked), group operation (signed delta, negation, applied
delta) and occupancy contest must equal the reference's bit for bit.
The port's carries update in place, so every merge is also checked to
leave its inputs untouched."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.clustering import ClusterCarry as JCluster
from repro.core.clustering import DegreeCarry as JDegree
from repro.core.cms import SketchCarry as JSketch
from repro.core.postprocess import AssignCarry as JAssign
from repro.kernels.stream_scan import GreedyCarry as JGreedy
from repro.kernels.stream_scan import GridCarry as JGrid
from repro.kernels.stream_scan import HdrfCarry as JHdrf
from repro.streaming.carry import FnCarry as JFn
from repro_torch.core.clustering import ClusterCarry, DegreeCarry
from repro_torch.core.cms import SketchCarry
from repro_torch.core.postprocess import AssignCarry
from repro_torch.kernels.stream_scan import GreedyCarry, GridCarry, HdrfCarry
from repro_torch.streaming.carry import (COUNTED, REPLICATED, SUM, FnCarry,
                                         PartitionerCarry, RetractCarry,
                                         tree_flatten, tree_leaves, tree_unflatten)

K = 4
N = 23


@pytest.fixture(autouse=True)
def _threefry_partitionable():
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", prev)


def _impls(name, n=N):
    """(reference carry, port carry, number of extras) for one consumer,
    built with the same parameters (the reference's ``tests/test_carry.py``
    set)."""
    deg = np.full((n,), 5, np.int32)
    c2p = np.arange(8, dtype=np.int32) % K
    row = np.arange(n, dtype=np.int32) % 2
    cpu = "cpu"
    return {
        "greedy": lambda: (JGreedy(n, K), GreedyCarry(n, K, device=cpu), 0),
        "hdrf": lambda: (JHdrf(n, K, 1.1), HdrfCarry(n, K, 1.1, device=cpu), 0),
        "grid": lambda: (JGrid(K, jnp.asarray(row), jnp.asarray(row), 2),
                         GridCarry(K, torch.from_numpy(row), torch.from_numpy(row), 2,
                                   device=cpu), 0),
        "cluster": lambda: (JCluster(jnp.asarray(deg), n, xi=3, kappa=17),
                            ClusterCarry(torch.from_numpy(deg), n, xi=3, kappa=17), 0),
        "assign": lambda: (JAssign(K, 50, jnp.asarray(c2p)),
                           AssignCarry(K, 50, torch.from_numpy(c2p)), 3),
        "degree": lambda: (JDegree(n), DegreeCarry(n, device=cpu), 0),
        "sketch": lambda: (JSketch(32, 3, seed=1), SketchCarry(32, 3, seed=1, device=cpu), 0),
    }[name]()


NAMES = ["greedy", "hdrf", "grid", "cluster", "assign", "degree", "sketch"]


def _bits(x) -> np.ndarray:
    a = np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _same(ref, port, what=""):
    lr = jax.tree_util.tree_leaves(ref)
    lp = tree_leaves(port)
    assert len(lr) == len(lp), what
    for i, (a, b) in enumerate(zip(lr, lp)):
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=f"{what} leaf {i}")


def _snapshot(carry):
    return [x.clone() if isinstance(x, torch.Tensor) else x for x in tree_leaves(carry)]


def _unchanged(carry, snap):
    return all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
               for a, b in zip(tree_leaves(carry), snap))


def _chunks(rng, n_extras, n=N, n_chunks=2, chunk=17):
    out = []
    for _ in range(n_chunks):
        src = rng.integers(0, n, chunk).astype(np.int32)
        dst = rng.integers(0, n, chunk).astype(np.int32)
        extras = []
        if n_extras:
            extras = [rng.integers(0, 2, chunk).astype(bool),
                      rng.integers(0, 8, chunk).astype(np.int32),
                      rng.integers(0, 8, chunk).astype(np.int32)]
        out.append((src, dst, extras))
    return out


def _fold(jpc, tpc, chunks, jc=None, tc=None):
    """Fold the same chunks on both sides; returns (reference, port)."""
    jc = jpc.init() if jc is None else jc
    tc = tpc.init() if tc is None else tc
    for src, dst, extras in chunks:
        n = np.int32(src.size)
        jc, _ = jpc.step_chunk(jc, jnp.asarray(src), jnp.asarray(dst), n,
                               *[jnp.asarray(e) for e in extras])
        tc, _ = tpc.step_chunk(tc, torch.from_numpy(src), torch.from_numpy(dst),
                               int(n), *[torch.from_numpy(e) for e in extras])
    return jc, tc


def _three(name, seed):
    jpc, tpc, nx = _impls(name)
    rng = np.random.default_rng(seed)
    folds = [_fold(jpc, tpc, _chunks(rng, nx)) for _ in range(3)]
    return jpc, tpc, folds


def test_merge_ops_declared_as_the_reference():
    for name in NAMES:
        jpc, tpc, _ = _impls(name)
        assert tuple(tpc.merge_ops) == tuple(jpc.merge_ops), name
        assert tuple(tpc.pick_first) == tuple(jpc.pick_first), name
        assert tpc.retract_exact == jpc.retract_exact, name
        assert tpc.emits_parts == jpc.emits_parts, name
        assert len(tree_leaves(tpc.init())) == len(tpc.merge_ops), name


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("seed", [0, 1])
def test_merge_algebra(name, seed):
    """The folds equal the reference's; merge([c]) is c; the base is the
    merge identity; two- and three-way merges with and without a base,
    in both lane orders, and the stacked merge equal the reference's."""
    jpc, tpc, folds = _three(name, seed)
    jbase, tbase = jpc.init(), tpc.init()
    (j1, t1), (j2, t2), (j3, t3) = folds
    for i, (j, t) in enumerate(folds):
        _same(j, t, f"{name} fold {i}")
    snaps = [_snapshot(t) for t in (tbase, t1, t2, t3)]
    assert tpc.merge([t1]) is t1
    _same(j1, tpc.merge([t1, tbase], base=tbase), f"{name} c1 + base")
    _same(j1, tpc.merge([tbase, t1], base=tbase), f"{name} base + c1")
    for order in ([0, 1], [1, 0], [0, 1, 2], [2, 0, 1]):
        jm = jpc.merge([folds[i][0] for i in order], base=jbase)
        tm = tpc.merge([folds[i][1] for i in order], base=tbase)
        _same(jm, tm, f"{name} merge {order}")
    _same(jpc.merge([j1, j2, j3]), tpc.merge([t1, t2, t3]), f"{name} no base")
    jst = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), j1, j2, j3)
    flat, spec = tree_flatten(t1)
    tst = [torch.stack([tree_leaves(t)[i] for t in (t1, t2, t3)])
           if isinstance(x, torch.Tensor) else x for i, x in enumerate(flat)]
    tst = tree_unflatten(spec, tst)
    _same(jpc.merge_stacked(jst, base=jbase), tpc.merge_stacked(tst, base=tbase),
          f"{name} stacked")
    _same(jpc.merge([j1, j2, j3], base=jbase), tpc.merge_stacked(tst, base=tbase),
          f"{name} stacked = list")
    for t, snap in zip((tbase, t1, t2, t3), snaps):
        assert _unchanged(t, snap), f"{name}: a merge wrote into its input"


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("seed", [0, 1])
def test_group_laws(name, seed):
    """signed_delta, negate and apply_delta equal the reference's, and
    apply_delta(apply_delta(c, δ), negate(δ)) == c bit for bit."""
    jpc, tpc, nx = _impls(name)
    rng = np.random.default_rng(seed)
    jc, tc = _fold(jpc, tpc, _chunks(rng, nx))
    ja, ta = _fold(jpc, tpc, _chunks(rng, nx, n_chunks=3), jc=jc, tc=_clone(tc))
    jd, td = jpc.signed_delta(ja, jc), tpc.signed_delta(ta, tc)
    _same(jd, td, f"{name} delta")
    _same(jpc.negate(jd), tpc.negate(td), f"{name} negate")
    _same(ja, tpc.apply_delta(tc, td), f"{name} apply")
    _same(jc, tpc.apply_delta(tpc.apply_delta(tc, td), tpc.negate(td)), f"{name} round trip")
    _same(ja, tpc.apply_delta(tpc.apply_delta(ta, tpc.negate(td)), td), f"{name} back")
    _same(jd, tpc.negate(tpc.negate(td)), f"{name} double negation")


def _clone(carry):
    flat, spec = tree_flatten(carry)
    return tree_unflatten(spec, [x.clone() if isinstance(x, torch.Tensor) else x
                                 for x in flat])


@pytest.mark.parametrize("name", NAMES)
def test_occupancy_contest(name):
    jpc, tpc, folds = _three(name, 3)
    (j1, t1), (j2, t2), _ = folds
    jm = jpc.merge([j1, j2], base=jpc.init())
    tm = tpc.merge([t1, t2], base=tpc.init())
    assert jpc.occupancy_contest(j1, jm) == tpc.occupancy_contest(t1, tm)


def test_pick_first_under_two_writers():
    """Two lanes reassign the same vertices in one super-chunk: the merged
    v2c tables keep the lowest changed lane's id, the reference's bits."""
    jpc, tpc, _ = _impls("cluster")
    rng = np.random.default_rng(5)
    jb, tb = _fold(jpc, tpc, _chunks(rng, 0, n_chunks=1))
    shared = _chunks(rng, 0, n_chunks=1)[0]
    jx, tx = _fold(jpc, tpc, [shared, _chunks(rng, 0, n_chunks=1)[0]], jc=jb, tc=_clone(tb))
    jy, ty = _fold(jpc, tpc, [shared, _chunks(rng, 0, n_chunks=1)[0]], jc=jb, tc=_clone(tb))
    both = (np.asarray(jx.v2c_h) != np.asarray(jb.v2c_h)) & (
        np.asarray(jy.v2c_h) != np.asarray(jb.v2c_h))
    assert both.any()
    for order in ((jx, tx, jy, ty), (jy, ty, jx, tx)):
        jm = jpc.merge([order[0], order[2]], base=jb)
        tm = tpc.merge([order[1], order[3]], base=tb)
        _same(jm, tm, "pick-first")
        np.testing.assert_array_equal(tm.v2c_h.numpy()[both], _bits(order[1].v2c_h)[both])


def test_cms_table_sums_wrap_in_z2_32():
    """The port's int32 CMS table holds the reference's uint32 table: merged
    sums and deltas past 2**32 wrap to the same bits."""
    jpc, tpc, _ = _impls("sketch")
    jb, tb = jpc.init(), tpc.init()
    big = np.uint32(0xFFFF_FFF0)
    ja = jb._replace(table=jb.table + big)
    ta = tb._replace(table=tb.table + int(big.view(np.int32)))
    _same(ja, ta, "table")
    rng = np.random.default_rng(2)
    jc, tc = _fold(jpc, tpc, _chunks(rng, 0, n_chunks=3), jc=ja, tc=_clone(ta))
    _same(jc, tc, "folded past 2**32")
    _same(jpc.merge([jc, ja, jc], base=jb), tpc.merge([tc, ta, tc], base=tb), "merge wraps")
    _same(jpc.signed_delta(jb, jc), tpc.signed_delta(tb, tc), "delta wraps")


def test_merge_validates_op_declaration():
    pc = DegreeCarry(4, device="cpu")
    pc.merge_ops = (SUM, SUM)
    with pytest.raises(ValueError, match="leaves"):
        pc.merge([pc.init(), pc.init()])
    pc.merge_ops = ("nope",)
    with pytest.raises(ValueError, match="unknown merge op"):
        pc.merge([pc.init(), pc.init()])
    with pytest.raises(ValueError, match="at least one"):
        DegreeCarry(4, device="cpu").merge([])
    g = GreedyCarry(4, 2, device="cpu")
    g.merge_ops = ("or", "max")
    with pytest.raises(ValueError, match="monotone"):
        g.signed_delta(g.init(), g.init())
    d = DegreeCarry(4, device="cpu")
    with pytest.raises(ValueError, match="no process group is up"):
        d.merge_collective(d.init(), d.init(), None)


def test_monotone_ops_match_the_reference():
    """OR and MAX (external consumers' ops) merge as the reference's."""
    class Mono(PartitionerCarry):
        merge_ops = ("or", "max")

    from repro.streaming.carry import PartitionerCarry as JPC

    class JMono(JPC):
        merge_ops = ("or", "max")

    rng = np.random.default_rng(0)
    a = [(rng.random(6) < 0.5, rng.integers(-5, 5, 6).astype(np.int32)) for _ in range(3)]
    j = JMono().merge([(jnp.asarray(x), jnp.asarray(y)) for x, y in a])
    t = Mono().merge([(torch.from_numpy(x), torch.from_numpy(y)) for x, y in a])
    _same(j, t, "or/max")
    js = JMono().merge_stacked((jnp.stack([x for x, _ in a]), jnp.stack([y for _, y in a])))
    ts = Mono().merge_stacked((torch.from_numpy(np.stack([x for x, _ in a])),
                               torch.from_numpy(np.stack([y for _, y in a]))))
    _same(js, ts, "or/max stacked")


def test_fn_and_retract_adapters():
    fc = FnCarry((torch.zeros(2),), lambda c, s, d: (c, s))
    assert fc.merge_ops == () and JFn((jnp.zeros(2),), None).merge_ops == ()
    with pytest.raises(ValueError, match="leaves"):
        fc.merge([fc.init(), fc.init()])
    dc = DegreeCarry(5, device="cpu")
    rc = RetractCarry(dc, with_parts=False)
    assert rc.merge_ops == dc.merge_ops and not rc.emits_parts and rc.pick_first == ()
    deg, _ = dc.step_chunk(dc.init(), torch.tensor([0, 1]), torch.tensor([2, 3]), 2)
    back, parts = rc.step_chunk(deg.clone(), torch.tensor([0, 1]), torch.tensor([2, 3]), 2)
    assert parts is None and int(back.abs().sum()) == 0
    with pytest.raises(NotImplementedError, match="edge deletion"):
        RetractCarry(fc)
    # Alg. 1 retracts since dynamic partitioning (cluster_retract_chunk)
    from repro_torch.core.clustering import cluster_retract_chunk

    cc = ClusterCarry(torch.full((4,), 2, dtype=torch.int32), 4, xi=1, kappa=5)
    s, d = torch.tensor([0, 1]), torch.tensor([2, 3])
    st, _ = cc.step_chunk(cc.init(), s, d, 2)
    back, _ = RetractCarry(cc, with_parts=False).step_chunk(st, s, d, 2)
    want = cluster_retract_chunk(st, s, d, 2, cc.degrees, xi=1)
    assert all(torch.equal(a, b) for a, b in zip(back, want))


def test_tree_flatten_order():
    """Tuples and NamedTuples depth first, scalars are leaves, None none."""
    from repro_torch.core.clustering import init_state

    st = init_state(3, "cpu")
    leaves, spec = tree_flatten(((st, 7), None, (1.5,)))
    assert len(leaves) == 12 and leaves[10] == 7 and leaves[11] == 1.5
    assert leaves[0] is st.v2c_h and leaves[9] is st.alloc_h
    back = tree_unflatten(spec, leaves)
    assert type(back[0][0]) is type(st) and back[1] is None and back[2] == (1.5,)
    assert COUNTED in ClusterCarry.merge_ops and REPLICATED in GridCarry.merge_ops
