"""Port parity for SchNet, EGNN and DimeNet and their data pipeline.

``repro_torch.models.gnn``'s SchNet, EGNN and DimeNet, ``molecule_batch``,
``build_csr``, ``NeighborSampler`` and ``build_triplets`` against the live
reference, on the CPU (plain K5).

- The data pipeline is bit for bit the reference's: the molecule batches,
  the CSR, the sampled subgraphs (the same ``default_rng`` draws in the
  same order) and the triplet lists.
- Each segment sum, fed the reference's own messages, equals
  ``jax.ops.segment_sum`` bit for bit (K5 adds each row in edge order from
  zero, as XLA's CPU scatter does); the RBF centres equal
  ``jnp.linspace``'s bits.
- The initialisers draw within 1e-6 of the reference's (the truncated
  normal's erfinv, Queue 3 f).
- The intermediates (distances, ``rbf``, the Bessel basis, angles,
  ``sbf``) agree within 1e-6 absolute: ``exp``, ``sin``, ``cos`` and
  ``arccos`` are PyTorch's, an ulp or so from XLA's.
- The energies agree within ``ENERGY_TOL`` = 1e-5 of their largest
  magnitude, the losses within a relative 1e-4: besides the functions
  above, ``softplus`` and ``silu`` differ by an ulp, and the matrix products
  (DimeNet's bilinear form above all) sum in another order.  Read: about
  2e-7 of the largest energy at published width.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.graphs import datasets as jdatasets
from repro.graphs import sampler as jsampler
from repro.models import gnn as jgnn
from repro_torch import interop
from repro_torch import random as trandom
from repro_torch.configs import get_arch
from repro_torch.graphs import NeighborSampler, build_csr, molecule_batch, powerlaw_graph
from repro_torch.models import gnn

ENERGY_TOL = 1e-5  # of the largest |energy|
LOSS_RTOL = 1e-4
BASIS_ATOL = 1e-6
DRAW_ATOL = 1e-6
MODELS = ("schnet", "egnn", "dimenet")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """PyTorch's CPU threads wait on XLA's, which stay busy after each JAX
    call: one thread runs these small tensors ~100× faster beside JAX."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _threefry_partitionable():
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", prev)


def _jcfg(cfg):
    """The reference's config of the same fields (its float32 dtype)."""
    cls = {gnn.SchNetConfig: jgnn.SchNetConfig, gnn.EGNNConfig: jgnn.EGNNConfig,
           gnn.DimeNetConfig: jgnn.DimeNetConfig}[type(cfg)]
    fields = {k: v for k, v in dataclasses.asdict(cfg).items() if k != "dtype"}
    return cls(**fields)


_INIT = {"schnet": (jgnn.schnet_init, gnn.schnet_init),
         "egnn": (jgnn.egnn_init, gnn.egnn_init),
         "dimenet": (jgnn.dimenet_init, gnn.dimenet_init)}
_LOSS = {"schnet": (jgnn.schnet_loss, gnn.schnet_loss),
         "egnn": (jgnn.egnn_loss, gnn.egnn_loss),
         "dimenet": (jgnn.dimenet_loss, gnn.dimenet_loss)}


def _flat_batch(n_mol=3, n_atoms=8, n_edges=14, seed=0, pad_nodes=0, pad_edges=0,
                tri_factor=4):
    """``molecule_batch`` flattened as ``launch/cells.py``'s molecule batches
    are: ``graph_idx``, padded nodes and edges (edge 0 → 0) masked off,
    triplets capped at ``tri_factor``·E."""
    mb = molecule_batch(n_mol, n_atoms, n_edges, seed=seed)
    V, E = n_mol * n_atoms + pad_nodes, n_mol * n_edges + pad_edges
    off = (np.arange(n_mol) * n_atoms)[:, None]
    pos = np.zeros((V, 3), np.float32)
    pos[:n_mol * n_atoms] = mb.positions.reshape(-1, 3)
    species = np.zeros(V, np.int32)
    species[:n_mol * n_atoms] = mb.species.reshape(-1)
    es, ed = np.zeros(E, np.int32), np.zeros(E, np.int32)
    es[:n_mol * n_edges] = (mb.edge_src + off).reshape(-1)
    ed[:n_mol * n_edges] = (mb.edge_dst + off).reshape(-1)
    edge_mask = (np.arange(E) < n_mol * n_edges).astype(np.float32)
    node_mask = (np.arange(V) < n_mol * n_atoms).astype(np.float32)
    graph_idx = np.zeros(V, np.int32)
    graph_idx[:n_mol * n_atoms] = np.repeat(np.arange(n_mol), n_atoms)
    tri_kj, tri_ji, tri_mask = gnn.build_triplets(es, ed, tri_factor * E)
    return {"species": species, "positions": pos, "edge_src": es, "edge_dst": ed,
            "edge_mask": edge_mask, "node_mask": node_mask, "graph_idx": graph_idx,
            "n_graphs": n_mol, "targets": mb.energies, "tri_kj": tri_kj, "tri_ji": tri_ji,
            "tri_mask": tri_mask}


def _jbatch(batch):
    return {k: (v if isinstance(v, int) else jnp.asarray(v)) for k, v in batch.items()}


def _forward(name, params, batch, cfg, ref: bool, masked: bool, pooled: bool):
    mod = jgnn if ref else gnn
    kw = {} if ref else {"device": "cpu"}
    b = _jbatch(batch) if ref else batch
    V = int(batch["species"].shape[0])
    masks = dict(edge_mask=b["edge_mask"], node_mask=b["node_mask"]) if masked else {}
    if pooled:
        masks.update(graph_idx=b["graph_idx"], n_graphs=batch["n_graphs"])
    args = (params, b["species"], b["positions"], b["edge_src"], b["edge_dst"])
    if name == "dimenet":
        if masked:
            masks["tri_mask"] = b["tri_mask"]
        out = mod.dimenet_forward(*args, b["tri_kj"], b["tri_ji"], V, cfg, **masks, **kw)
    else:
        fwd = mod.schnet_forward if name == "schnet" else mod.egnn_forward
        out = fwd(*args, V, cfg, **masks, **kw)
    return np.asarray(out)


def _assert_energies(got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=ENERGY_TOL * scale)


# ------------------------------------------------------------ the data


@pytest.mark.parametrize("args", [(4, 30, 64, 0), (3, 7, 12, 5), (1, 2, 2, 1)])
def test_molecule_batch_is_the_references(args):
    want = jdatasets.molecule_batch(*args)
    got = molecule_batch(*args)
    assert type(got).__name__ == "MoleculeBatch" and got._fields == want._fields
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _sampler_graph(seed=3):
    """A power-law graph with isolated vertices past its last id."""
    src, dst, n = powerlaw_graph(400, avg_degree=6, rho=2.3, seed=seed)
    return src, dst, n + 7


@pytest.mark.parametrize("symmetrize", [True, False])
def test_build_csr_is_the_references(symmetrize):
    src, dst, n = _sampler_graph()
    want = jsampler.build_csr(src, dst, n, symmetrize=symmetrize)
    got = build_csr(src, dst, n, symmetrize=symmetrize, device="cpu")
    assert got.n_vertices == want.n_vertices
    for a, b in ((got.indptr, want.indptr), (got.indices, want.indices)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _same_subgraph(got, want):
    for f in want._fields:
        a, b = getattr(got, f), getattr(want, f)
        if f == "seed_count":
            assert a == b
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("seed,fanouts,batch_nodes", [(0, (15, 10), 16), (1, (3,), 40),
                                                      (7, (4, 3, 2), 8)])
def test_neighbor_sampler_is_the_references(seed, fanouts, batch_nodes):
    src, dst, n = _sampler_graph()
    jg = jsampler.build_csr(src, dst, n)
    ours = NeighborSampler(build_csr(src, dst, n, device="cpu"), fanouts, batch_nodes,
                           seed=seed)
    ref = jsampler.NeighborSampler(jg, fanouts, batch_nodes, seed=seed)
    assert (ours.max_nodes, ours.max_edges) == (ref.max_nodes, ref.max_edges)
    for _ in range(2):  # the generator's state carries over to the next batch
        _same_subgraph(ours.sample(), ref.sample())
    # seeds given: an isolated vertex (no neighbours) among them
    seeds = np.array([n - 1, 0, 5, n - 3])
    _same_subgraph(ours.sample(seeds), ref.sample(seeds))


def test_neighbor_sampler_truncates_an_overflowing_batch():
    """More seeds than ``batch_nodes`` on a complete graph: 12 edges into a
    budget of 6, truncated as the reference truncates them."""
    v = np.arange(4)
    src, dst = np.meshgrid(v, v)
    keep = src != dst
    src, dst = src[keep].astype(np.int32), dst[keep].astype(np.int32)
    ours = NeighborSampler(build_csr(src, dst, 4, symmetrize=False, device="cpu"), (3,), 2)
    ref = jsampler.NeighborSampler(jsampler.build_csr(src, dst, 4, symmetrize=False), (3,), 2)
    got, want = ours.sample(np.arange(4)), ref.sample(np.arange(4))
    assert want.edge_mask.all() and ours.max_edges == 6
    _same_subgraph(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_build_triplets_is_the_references(seed):
    rng = np.random.default_rng(seed)
    E, V = 40 + 10 * seed, 9
    src = rng.integers(0, V, E).astype(np.int32)
    dst = rng.integers(0, V, E).astype(np.int32)
    src[-12:] = dst[-12:] = 0  # padding 0 → 0, as the sampler pads
    for cap in (1, 7, 64, 10_000):  # caps that cut inside an edge's list, and none
        want = jgnn.build_triplets(src, dst, cap)
        got = gnn.build_triplets(src, dst, cap)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_build_triplets_on_molecules_and_a_sampled_subgraph():
    b = _flat_batch(n_mol=4, n_atoms=10, n_edges=20, pad_edges=8)
    want = jgnn.build_triplets(b["edge_src"], b["edge_dst"], 4 * b["edge_src"].size)
    for a, w in zip((b["tri_kj"], b["tri_ji"], b["tri_mask"]), want):
        assert np.array_equal(a, w)
    src, dst, n = _sampler_graph(5)
    sub = NeighborSampler(build_csr(src, dst, n, device="cpu"), (5, 3), 12, seed=2).sample()
    cap = 2 * sub.edge_src.size
    for a, w in zip(gnn.build_triplets(sub.edge_src, sub.edge_dst, cap),
                    jgnn.build_triplets(sub.edge_src, sub.edge_dst, cap)):
        assert np.array_equal(a, w)


# ------------------------------------------------- the sums and the bases


@pytest.mark.parametrize("d", [1, 3, 64, 128])
def test_message_sums_are_the_references_bitwise(d):
    """K5 through an identity-source layout, fed one set of messages
    (with masked zeros, repeated and padded destinations)."""
    rng = np.random.default_rng(d)
    E, n = 700, 50
    msg = (rng.standard_normal((E, d)) * 10.0 ** rng.integers(-3, 4, (E, 1))).astype(np.float32)
    msg[rng.random(E) < 0.2] = 0.0
    idx = rng.integers(0, n, E).astype(np.int32)
    idx[-100:] = 0
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(msg), jnp.asarray(idx), num_segments=n))
    lay = gnn.message_layout(idx, n, device="cpu")
    got = gnn._seg_sum(torch.from_numpy(msg), lay).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    vec = np.asarray(jax.ops.segment_sum(jnp.asarray(msg[:, 0]), jnp.asarray(idx),
                                         num_segments=n))
    assert np.array_equal(gnn._seg_sum(torch.from_numpy(msg[:, 0]), lay).numpy(), vec)


def test_rbf_centres_and_bases_match_reference():
    for stop, num in ((10.0, 300), (10.0, 16), (5.0, 50), (2.0, 8), (3.3, 1001)):
        want = np.asarray(jnp.linspace(0.0, stop, num, dtype=jnp.float32))
        assert np.array_equal(gnn._linspace_f32(stop, num, "cpu").numpy(), want)
    b = _flat_batch(n_mol=2, n_atoms=12, n_edges=30)
    pos, es, ed = b["positions"], b["edge_src"], b["edge_dst"]
    jpos = jnp.asarray(pos)
    d_want = np.asarray(jnp.linalg.norm(jpos[es] - jpos[ed] + 1e-9, axis=-1))
    tpos = torch.from_numpy(pos)
    d_got = gnn._norm(tpos[es] - tpos[ed] + 1e-9).numpy()
    np.testing.assert_allclose(d_got, d_want, rtol=0, atol=BASIS_ATOL)
    dj = torch.from_numpy(d_want)
    for n_rbf, cutoff in ((300, 10.0), (16, 2.0)):
        np.testing.assert_allclose(gnn._rbf_expand(dj, n_rbf, cutoff).numpy(),
                                   np.asarray(jgnn._rbf_expand(jnp.asarray(d_want), n_rbf,
                                                               cutoff)),
                                   rtol=0, atol=BASIS_ATOL)
    np.testing.assert_allclose(gnn._bessel_rbf(dj, 6, 5.0).numpy(),
                               np.asarray(jgnn._bessel_rbf(jnp.asarray(d_want), 6, 5.0)),
                               rtol=0, atol=BASIS_ATOL)
    x = np.linspace(-30, 30, 1001).astype(np.float32)
    np.testing.assert_allclose(gnn._ssp(torch.from_numpy(x)).numpy(),
                               np.asarray(jgnn._ssp(jnp.asarray(x))), rtol=1e-6, atol=1e-7)
    # DimeNet's triplet geometry
    kj, ji = b["tri_kj"][b["tri_mask"] > 0], b["tri_ji"][b["tri_mask"] > 0]
    vec = pos[es] - pos[ed]
    v1, v2 = vec[kj], -vec[ji]
    cos_w = jnp.sum(v1 * v2, axis=-1) / (jnp.linalg.norm(v1 + 1e-9, axis=-1)
                                         * jnp.linalg.norm(v2 + 1e-9, axis=-1))
    ang_w = np.asarray(jnp.arccos(jnp.clip(cos_w, -1.0 + 1e-6, 1.0 - 1e-6)))
    t1, t2 = torch.from_numpy(v1), torch.from_numpy(v2)
    cos_g = gnn._sum3(t1 * t2) / (gnn._norm(t1 + 1e-9) * gnn._norm(t2 + 1e-9))
    ang_g = torch.arccos(torch.clamp(cos_g, -1.0 + 1e-6, 1.0 - 1e-6)).numpy()
    np.testing.assert_allclose(ang_g, ang_w, rtol=0, atol=BASIS_ATOL)
    dk = d_want[kj]
    np.testing.assert_allclose(
        gnn._angular_sbf(torch.from_numpy(ang_w), torch.from_numpy(dk), 7, 6, 5.0).numpy(),
        np.asarray(jgnn._angular_sbf(jnp.asarray(ang_w), jnp.asarray(dk), 7, 6, 5.0)),
        rtol=0, atol=BASIS_ATOL)


# --------------------------------------------------------- the models


@pytest.fixture(scope="module")
def published_params():
    """The reference's parameters at each published config (key 0)."""
    return {name: _INIT[name][0](_jcfg(get_arch(name).config), jax.random.PRNGKey(0))
            for name in MODELS}


@pytest.mark.parametrize("name", MODELS)
def test_init_matches_reference(name, published_params):
    """The published config's tree: ``2 + 3n``, ``1 + 4n``, ``4 + 5n`` keys."""
    cfg = get_arch(name).config
    want = jax.tree.leaves(published_params[name])
    got = jax.tree_util.tree_leaves(_INIT[name][1](cfg, trandom.PRNGKey(0), device="cpu"))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=DRAW_ATOL)


@pytest.fixture(scope="module")
def padded_batch():
    return _flat_batch(n_mol=3, n_atoms=8, n_edges=14, seed=2, pad_nodes=4, pad_edges=6)


@pytest.mark.parametrize("masked,pooled", [(False, False), (True, True), (False, True)])
@pytest.mark.parametrize("name", MODELS)
def test_forward_and_loss_match_reference(name, masked, pooled, padded_batch):
    cfg = get_arch(name).smoke_config
    jcfg = _jcfg(cfg)
    jp = _INIT[name][0](jcfg, jax.random.PRNGKey(4))
    tp = interop.gnn3d_params(jp, device="cpu")
    b = padded_batch
    want = _forward(name, jp, b, jcfg, True, masked, pooled)
    got = _forward(name, tp, b, cfg, False, masked, pooled)
    assert got.shape == ((b["n_graphs"],) if pooled else (1,))
    _assert_energies(got, want)
    if masked and pooled:
        jloss, jloss_fn = _LOSS[name]
        want_loss, want_aux = jloss(jp, _jbatch(b), jcfg)
        got_loss, got_aux = jloss_fn(tp, b, cfg, device="cpu")
        assert float(got_loss) == pytest.approx(float(want_loss), rel=LOSS_RTOL)
        assert float(got_aux["mae"]) == pytest.approx(float(want_aux["mae"]), rel=LOSS_RTOL)


@pytest.mark.parametrize("name", MODELS)
def test_published_width_forward_on_molecules(name, published_params):
    """The published config on 3 molecules of ``molecule_batch``'s size."""
    cfg = get_arch(name).config
    jcfg = _jcfg(cfg)
    jp = published_params[name]
    b = _flat_batch(n_mol=3, n_atoms=30, n_edges=64, seed=0, pad_nodes=6)
    want = _forward(name, jp, b, jcfg, True, True, True)
    got = _forward(name, interop.gnn3d_params(jp, device="cpu"), b, cfg, False, True, True)
    _assert_energies(got, want)


@pytest.mark.parametrize("pooled", [True, False])
@pytest.mark.parametrize("name", MODELS)
def test_k5_launches_per_forward(name, pooled, padded_batch, monkeypatch):
    """SchNet n + 1, EGNN 1 + 2n + 1, DimeNet 2n + 1 (one fewer without
    ``graph_idx``), over one layout a destination set."""
    calls, layouts = [], []
    real_agg, real_layout = gnn.segment_agg, gnn.segment_layout
    monkeypatch.setattr(gnn, "segment_agg", lambda x, lay: calls.append(x.shape[1])
                        or real_agg(x, lay))
    monkeypatch.setattr(gnn, "segment_layout", lambda *a, **k: layouts.append(a[2])
                        or real_layout(*a, **k))
    cfg = get_arch(name).smoke_config
    params = _INIT[name][1](cfg, trandom.PRNGKey(0), device="cpu")
    _forward(name, params, padded_batch, cfg, False, True, pooled)
    V, E = padded_batch["species"].size, padded_batch["edge_src"].size
    pool = [1] if pooled else []
    if name == "schnet":
        want = [cfg.d_hidden] * cfg.n_interactions + pool
        want_layouts = [V] + ([3] if pooled else [])
    elif name == "egnn":
        want = [1] + [3, cfg.d_hidden] * cfg.n_layers + pool
        want_layouts = [V] + ([3] if pooled else [])
    else:
        want = [cfg.d_hidden, cfg.d_hidden] * cfg.n_blocks + pool
        want_layouts = [V, E] + ([3] if pooled else [])
    assert calls == want and layouts == want_layouts


def test_egnn_energy_invariance():
    """E(n) invariance: rotating + translating inputs leaves energy fixed."""
    cfg = gnn.EGNNConfig(n_layers=2, d_hidden=16)
    params = gnn.egnn_init(cfg, trandom.PRNGKey(0), device="cpu")
    rng = np.random.default_rng(0)
    V, E = 12, 30
    species = rng.integers(1, 5, V).astype(np.int32)
    pos = rng.standard_normal((V, 3)).astype(np.float32)
    es = rng.integers(0, V, E).astype(np.int32)
    ed = rng.integers(0, V, E).astype(np.int32)
    e1 = gnn.egnn_forward(params, species, pos, es, ed, V, cfg, device="cpu")
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    pos2 = (pos @ q.astype(np.float32) + np.array([1.5, -2.0, 0.3], np.float32))
    e2 = gnn.egnn_forward(params, species, pos2.astype(np.float32), es, ed, V, cfg,
                          device="cpu")
    np.testing.assert_allclose(e1.numpy(), e2.numpy(), rtol=1e-4, atol=1e-4)


def test_schnet_cutoff():
    """Edges beyond the cutoff contribute nothing."""
    cfg = gnn.SchNetConfig(n_interactions=1, d_hidden=8, n_rbf=8, cutoff=2.0)
    params = gnn.schnet_init(cfg, trandom.PRNGKey(0), device="cpu")
    species = np.array([1, 2, 3], np.int32)
    pos = np.array([[0, 0, 0], [1, 0, 0], [10, 0, 0]], np.float32)
    es, ed = np.array([0, 0], np.int32), np.array([1, 2], np.int32)
    e_with = gnn.schnet_forward(params, species, pos, es, ed, 3, cfg, device="cpu")
    e_without = gnn.schnet_forward(params, species, pos, es[:1], ed[:1], 3, cfg, device="cpu")
    np.testing.assert_allclose(e_with.numpy(), e_without.numpy(), atol=1e-5)


def test_entry_points_default_to_the_card():
    """Without ``device`` the models and ``build_csr`` run on cuda, and
    raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = get_arch("schnet").smoke_config
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gnn.schnet_init(cfg, trandom.PRNGKey(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_csr(np.zeros(1, np.int32), np.zeros(1, np.int32), 1)


# ---------------------------------------------------------- the configs


@pytest.mark.parametrize("name", MODELS)
def test_configs_registry(name):
    ours, ref = get_arch(name), jget_arch(name)
    assert (ours.name, ours.family, dict(ours.shapes), dict(ours.skips), ours.notes) == \
        (ref.name, ref.family, dict(ref.shapes), dict(ref.skips), ref.notes)
    for a, b in ((ours.config, ref.config), (ours.smoke_config, ref.smoke_config)):
        fa = {k: v for k, v in dataclasses.asdict(a).items() if k != "dtype"}
        fb = {k: v for k, v in dataclasses.asdict(b).items() if k != "dtype"}
        assert fa == fb and a.dtype == torch.float32

