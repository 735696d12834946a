"""Port parity for the GCN and the model primitives.

``repro_torch.models.gnn`` against the live ``repro.models.gnn`` on the
same weights (``interop.gcn_params``) and inputs, on the CPU (plain K5).
Tolerance rtol 1e-5, atol 1e-6 (as ``tests/test_serving.py`` holds
``query_gnn``): the aggregations are bitwise the reference's
(``test_torch_segment_agg.py``), but ``x @ W`` sums in another order in
XLA and in PyTorch, ``jax.lax.rsqrt`` and ``torch.rsqrt`` differ by an ulp
on some degrees, and XLA contracts the self-loop term ``agg + x·s²`` into
an FMA.  ``truncated_normal`` and ``normal`` (hence ``dense_init`` and
``gcn_init``) draw JAX's uniform bits exactly; ``torch.erfinv`` and XLA's
erfinv are other approximations a few ulp apart, so truncated draws on
[−2, 2] agree to 1e-6 absolute and unbounded normal draws, where erfinv is
steep near ±1, to a relative 1e-5 (plus 1e-6 absolute near 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import common as jcommon
from repro.models import gnn as jgnn
from repro_torch import interop
from repro_torch import random as trandom
from repro_torch.configs import get_arch
from repro_torch.graphs import community_graph
from repro_torch.models import common, gnn

RTOL, ATOL = 1e-5, 1e-6
DRAW_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _threefry_partitionable():
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", prev)


@pytest.mark.parametrize("seed", [0, 1, 42])
@pytest.mark.parametrize("lo,hi,shape", [(-2.0, 2.0, (100, 16)), (-1.0, 3.0, (7,)),
                                         (-0.5, 0.5, (3, 5, 4))])
def test_truncated_normal_within_tolerance(seed, lo, hi, shape):
    want = np.asarray(jax.random.truncated_normal(jax.random.PRNGKey(seed), lo, hi, shape))
    got = trandom.truncated_normal(trandom.PRNGKey(seed), lo, hi, shape).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_allclose(got, want, rtol=0, atol=DRAW_ATOL)
    assert got.min() > lo and got.max() < hi


@pytest.mark.parametrize("seed", [0, 3])
def test_normal_and_bounded_uniform(seed):
    k = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.normal(k, (64, 33)))
    got = trandom.normal(trandom.PRNGKey(seed), (64, 33)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=DRAW_ATOL)
    # the scaled uniform draw itself is bitwise (XLA's FMA form)
    want_u = np.asarray(jax.random.uniform(k, (500,), minval=-0.3, maxval=2.5))
    got_u = trandom.uniform(trandom.PRNGKey(seed), (500,), "cpu", -0.3, 2.5).numpy()
    np.testing.assert_array_equal(got_u, want_u)


@pytest.mark.parametrize("shape,scale", [((100, 16), None), ((16, 7), None),
                                         ((5,), None), ((8, 3), 0.5)])
def test_dense_init(shape, scale):
    want = np.asarray(jcommon.dense_init(jax.random.PRNGKey(2), shape, scale))
    got = common.dense_init(trandom.PRNGKey(2), shape, scale, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=DRAW_ATOL)


def test_model_primitives():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 10)).astype(np.float32)
    g = rng.standard_normal(10).astype(np.float32)
    b = rng.standard_normal(10).astype(np.float32)
    t = [torch.from_numpy(a) for a in (x, g, b)]
    pairs = [
        (jcommon.rms_norm(x, g), common.rms_norm(t[0], t[1])),
        (jcommon.layer_norm(x, g, b), common.layer_norm(*t)),
        (jcommon.swish(x), common.swish(t[0])),
        (jcommon.gelu(x), common.gelu(t[0])),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    labels = rng.integers(0, 10, 6).astype(np.int32)
    mask = (rng.random(6) < 0.5).astype(np.float32)
    for m in (None, mask):
        want = float(jcommon.softmax_xent(x, labels, m))
        got = float(common.softmax_xent(t[0], torch.from_numpy(labels),
                                        None if m is None else torch.from_numpy(m)))
        assert got == pytest.approx(want, rel=RTOL)


def _configs():
    smoke = get_arch("gcn-cora").smoke_config
    full = get_arch("gcn-cora").config
    wide = gnn.GCNConfig(n_layers=full.n_layers, d_hidden=full.d_hidden, d_feat=100,
                         n_classes=full.n_classes)
    return {"smoke": smoke, "d_feat100": wide}


def _jcfg(cfg):
    return jgnn.GCNConfig(n_layers=cfg.n_layers, d_hidden=cfg.d_hidden,
                          d_feat=cfg.d_feat, n_classes=cfg.n_classes)


@pytest.fixture(scope="module")
def graph():
    src, dst, n = community_graph(600, n_communities=6, avg_degree=8, seed=9)
    return src, dst, n


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", ["smoke", "d_feat100"])
def test_gcn_forward_and_loss_match_reference(graph, name, masked):
    src, dst, n = graph
    cfg = _configs()[name]
    jcfg = _jcfg(cfg)
    rng = np.random.default_rng(11)
    feats = rng.standard_normal((n, cfg.d_feat)).astype(np.float32)
    mask = (rng.random(src.size) < 0.8).astype(np.float32) if masked else None
    jp = jgnn.gcn_init(jcfg, jax.random.PRNGKey(3))
    tp = interop.gcn_params(jp, device="cpu")
    want = np.asarray(jgnn.gcn_forward(jp, jnp.asarray(feats), jnp.asarray(src),
                                       jnp.asarray(dst), n, jcfg,
                                       None if mask is None else jnp.asarray(mask)))
    got = gnn.gcn_forward(tp, feats, src, dst, n, cfg, mask, device="cpu")
    assert got.shape == (n, cfg.n_classes) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)

    labels = rng.integers(0, cfg.n_classes, n).astype(np.int32)
    label_mask = (rng.random(n) < 0.3).astype(np.float32)
    batch = {"feats": feats, "edge_src": src, "edge_dst": dst, "labels": labels,
             "label_mask": label_mask}
    if masked:
        batch["edge_mask"] = mask
    want_loss, _ = jgnn.gcn_loss(jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    got_loss, aux = gnn.gcn_loss(tp, batch, cfg, device="cpu")
    assert aux == {}
    assert float(got_loss) == pytest.approx(float(want_loss), rel=RTOL)


def test_gcn_init_matches_reference():
    cfg = _configs()["d_feat100"]
    jp = jgnn.gcn_init(_jcfg(cfg), jax.random.PRNGKey(0))
    tp = gnn.gcn_init(cfg, trandom.PRNGKey(0), device="cpu")
    for a, b in zip(jp["layers"], tp["layers"]):
        np.testing.assert_allclose(b["w"].numpy(), np.asarray(a["w"]), rtol=0, atol=DRAW_ATOL)


def test_gcn_norm_runs_six_aggregations_per_forward(graph, monkeypatch):
    """Degrees (2) + two layers × two directions (4), over two layouts."""
    src, dst, n = graph
    calls, layouts = [], []
    real_agg, real_layout = gnn.segment_agg, gnn.segment_layout
    monkeypatch.setattr(gnn, "segment_agg", lambda x, lay: calls.append(x.shape[1])
                        or real_agg(x, lay))
    monkeypatch.setattr(gnn, "segment_layout", lambda *a, **k: layouts.append(1)
                        or real_layout(*a, **k))
    cfg = _configs()["smoke"]
    gnn.gcn_forward(gnn.gcn_init(cfg, trandom.PRNGKey(0), device="cpu"),
                    np.ones((n, cfg.d_feat), np.float32), src, dst, n, cfg, device="cpu")
    assert calls == [1, 1, cfg.d_hidden, cfg.d_hidden, cfg.n_classes, cfg.n_classes]
    assert len(layouts) == 2


def test_configs_registry():
    ours, ref = get_arch("gcn-cora"), jget_arch("gcn-cora")
    assert (ours.name, ours.family, dict(ours.shapes)) == (ref.name, ref.family, dict(ref.shapes))
    for a, b in ((ours.config, ref.config), (ours.smoke_config, ref.smoke_config)):
        assert (a.n_layers, a.d_hidden, a.d_feat, a.n_classes) == \
            (b.n_layers, b.d_hidden, b.d_feat, b.n_classes)
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("graphsage")  # a name neither registry has
