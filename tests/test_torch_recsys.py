"""Port parity for xDeepFM (``repro_torch.models.recsys``), its config,
``interop.xdeepfm_params`` and ``launch.serve.serve_recsys``, on the CPU
against the live reference.

Tolerances:
- ``xdeepfm_init``: each leaf within 1e-6 of the reference's (the
  ``truncated_normal`` tolerance of ROADMAP Queue 3 f: ``torch.erfinv`` and
  XLA's are a few ulp apart), zero leaves equal;
- float32 logits, each CIN layer's pools, the loss and the retrieval
  scores on carried weights: rtol 1e-5, atol 1e-7 (the CIN, the MLP and
  the dot products sum in another order); the pools also within 1e-5 of
  each layer's max |want|, the limit K7 is held to;
- ids, ``embedding_bag`` of exactly representable rows, retrieval indices
  where the scores are distinct, and ``s5p_row_placement``: equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.launch import serve as jserve
from repro.models import recsys as JR
from repro_torch import interop
from repro_torch import random as trandom
from repro_torch.configs import get_arch
from repro_torch.launch import serve as tserve
from repro_torch.models import recsys as R

RTOL, ATOL = 1e-5, 1e-7
DRAW_ATOL = 1e-6
PUBLISHED = dict(n_fields=39, embed_dim=10, cin_layers=(200, 200, 200), mlp_dims=(400, 400))


@pytest.fixture(autouse=True)
def _threefry_partitionable():
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", prev)


def _cfgs(kind):
    """(reference, port) configs: the smoke config, or the published widths
    with small vocabularies."""
    if kind == "smoke":
        return jget_arch("xdeepfm").smoke_config, get_arch("xdeepfm").smoke_config
    vocabs = (64, 32) * 19 + (48,)  # few distinct shapes: JAX compiles each init
    return (JR.XDeepFMConfig(**PUBLISHED, field_vocabs=vocabs),
            R.XDeepFMConfig(**PUBLISHED, field_vocabs=vocabs))


def _carried(jcfg, seed=0):
    """The reference's parameters with non-zero linear tables (so the order
    of the ``lin`` sum is pinned), and the port's copy of them."""
    jp = JR.xdeepfm_init(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    jp["lin_tables"] = [jnp.asarray(1e-3 * rng.standard_normal(t.shape), jnp.float32)
                        for t in jp["lin_tables"]]
    jp["bias"] = jnp.asarray([2e-4], jnp.float32)
    return jp, interop.xdeepfm_params(jp, device="cpu")


def _ids(cfg, B, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, v, B) for v in cfg.vocabs()], axis=1).astype(np.int32)


def _ref_pools(jp, ids, jcfg):
    """Each CIN layer's pools by the reference's own functions."""
    x0 = jnp.stack([JR.embedding_lookup(jp["tables"][f], ids[:, f])
                    for f in range(jcfg.n_fields)], axis=1)
    xk, pools = x0, []
    for w in jp["cin"]:
        xk = JR._cin_layer(xk, x0, w)
        pools.append(np.asarray(jnp.sum(xk, axis=-1)))
    return pools


def test_config_and_vocabs_equal_the_reference():
    for attr in ("config", "smoke_config"):
        a, b = getattr(jget_arch("xdeepfm"), attr), getattr(get_arch("xdeepfm"), attr)
        for f in ("n_fields", "embed_dim", "cin_layers", "mlp_dims", "field_vocabs"):
            assert getattr(a, f) == getattr(b, f)
        assert a.vocabs() == b.vocabs()
        assert b.dtype == torch.float32
    assert get_arch("xdeepfm").family == "recsys"
    assert dict(get_arch("xdeepfm").shapes) == dict(jget_arch("xdeepfm").shapes)
    assert sum(get_arch("xdeepfm").config.vocabs()) == 4_246_528


def test_init_matches_reference():
    jcfg, cfg = _cfgs("smoke")
    jp = JR.xdeepfm_init(jcfg, jax.random.PRNGKey(0))
    tp = R.xdeepfm_init(cfg, trandom.PRNGKey(0), device="cpu")
    ref = interop.xdeepfm_params(jp, device="cpu")
    want_leaves, _ = jax.tree.flatten(ref)
    got_leaves, _ = jax.tree.flatten(tp)
    assert len(got_leaves) == len(want_leaves) == 6 + 6 + 2 + 1 + 4 + 1 + 1
    for g, w in zip(got_leaves, want_leaves):
        assert g.shape == w.shape and g.dtype == w.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=DRAW_ATOL)
        if not w.any():
            assert not g.any()


def test_carried_params_are_fresh_copies():
    jcfg, _ = _cfgs("smoke")
    jp, tp = _carried(jcfg)
    tp["cin"][0].zero_()
    assert np.asarray(jp["cin"][0]).any()
    assert [tuple(t.shape) for t in tp["tables"]] == [(v, 4) for v in jcfg.vocabs()]
    assert tuple(tp["mlp"][1]["b"].shape) == (16,)


@pytest.mark.parametrize("kind,B", [("smoke", 32), ("published", 32)])
def test_forward_and_pools_match_reference(kind, B):
    jcfg, cfg = _cfgs(kind)
    jp, tp = _carried(jcfg, seed=1)
    ids = _ids(cfg, B, seed=2)
    want = np.asarray(JR.xdeepfm_forward(jp, jnp.asarray(ids), jcfg))
    pools = []
    got = R.xdeepfm_forward(tp, torch.from_numpy(ids), cfg, pools=pools)
    assert got.shape == (B,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    want_pools = _ref_pools(jp, jnp.asarray(ids), jcfg)
    assert [p.shape for p in pools] == [(B, h) for h in cfg.cin_layers]
    for g, w in zip(pools, want_pools):
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


def test_lin_sum_order_is_pinned():
    """The non-zero linear tables reach the logits: dropping them moves
    the logits outside the tolerance."""
    jcfg, cfg = _cfgs("smoke")
    jp, tp = _carried(jcfg, seed=3)
    ids = torch.from_numpy(_ids(cfg, 16, seed=4))
    with_lin = R.xdeepfm_forward(tp, ids, cfg).numpy()
    tp["lin_tables"] = [torch.zeros_like(t) for t in tp["lin_tables"]]
    without = R.xdeepfm_forward(tp, ids, cfg).numpy()
    assert not np.allclose(with_lin, without, rtol=RTOL, atol=ATOL)


def test_loss_matches_reference():
    jcfg, cfg = _cfgs("smoke")
    jp, tp = _carried(jcfg, seed=5)
    ids = _ids(cfg, 24, seed=6)
    labels = np.random.default_rng(7).integers(0, 2, 24).astype(np.float32)
    want, jaux = JR.xdeepfm_loss(jp, {"field_ids": jnp.asarray(ids),
                                      "labels": jnp.asarray(labels)}, jcfg)
    got, aux = R.xdeepfm_loss(tp, {"field_ids": torch.from_numpy(ids),
                                   "labels": torch.from_numpy(labels)}, cfg)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL, atol=ATOL)
    assert float(aux["logloss"]) == float(got)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_matches_reference(mode):
    """Bags of 3, 0 (empty), 1 and 4 rows, and rows before the first
    offset, which belong to no bag."""
    table = np.arange(40, dtype=np.float32).reshape(10, 4) / 8
    indices = np.array([9, 1, 2, 3, 4, 5, 6, 7, 8, 0], np.int32)
    for offsets in (np.array([0, 3, 3, 4], np.int32), np.array([2, 5, 5, 6], np.int32)):
        want = np.asarray(JR.embedding_bag(jnp.asarray(table), jnp.asarray(indices),
                                           jnp.asarray(offsets), mode=mode))
        got = R.embedding_bag(torch.from_numpy(table), torch.from_numpy(indices),
                              torch.from_numpy(offsets), mode=mode).numpy()
        np.testing.assert_array_equal(got, want)
        assert not got[1].any()


def test_retrieval_scores_match_reference():
    jcfg, cfg = _cfgs("smoke")
    jp, tp = _carried(jcfg, seed=8)
    cand = np.random.default_rng(9).standard_normal((5000, 4)).astype(np.float32)
    q = _ids(cfg, 2, seed=10)
    wv, wi = JR.retrieval_scores(jp, jnp.asarray(q), jnp.asarray(cand), jcfg, top_k=100)
    gv, gi = R.retrieval_scores(tp, torch.from_numpy(q), torch.from_numpy(cand), cfg,
                                top_k=100)
    assert gv.shape == gi.shape == (2, 100) and gi.dtype == torch.int32
    wv, wi = np.asarray(wv), np.asarray(wi)
    np.testing.assert_allclose(gv.numpy(), wv, rtol=RTOL, atol=ATOL)
    assert (np.diff(gv.numpy(), axis=1) <= 0).all()
    for row in range(2):
        if np.unique(wv[row]).size == wv.shape[1]:
            assert set(gi[row].tolist()) == set(wi[row].tolist())
    assert np.unique(wv[0]).size == 100  # the check above ran


def test_s5p_row_placement_bit_for_bit():
    """tests/test_models.py's Zipf access graph."""
    rng = np.random.default_rng(0)
    n_rows, n_samples = 64, 800
    rows = (rng.zipf(1.3, n_samples * 4) % n_rows).astype(np.int64)
    samples = np.repeat(np.arange(n_samples), 4)
    want_shard, want_mat = JR.s5p_row_placement(rows, samples, n_rows, k=4)
    shard, mat = R.s5p_row_placement(rows, samples, n_rows, k=4, device="cpu")
    assert shard.dtype == np.int32 and mat.dtype == np.bool_
    np.testing.assert_array_equal(shard, want_shard)
    np.testing.assert_array_equal(mat, want_mat)


def test_serve_recsys_matches_reference(capsys):
    want = np.asarray(jserve.serve_recsys("xdeepfm", batch=48, smoke=True, seed=0))
    jcfg = jget_arch("xdeepfm").smoke_config
    key = jax.random.PRNGKey(0)
    want_ids = np.stack([np.asarray(jax.random.randint(jax.random.fold_in(key, f), (48,),
                                                       0, v, dtype=jnp.int32))
                         for f, v in enumerate(jcfg.vocabs())], axis=1)
    stats = {}
    got = tserve.serve_recsys("xdeepfm", batch=48, smoke=True, seed=0, device="cpu",
                              stats=stats)
    assert "[serve] xdeepfm: scored 48 in" in capsys.readouterr().out
    assert stats["ids"].dtype == torch.int32
    np.testing.assert_array_equal(stats["ids"].numpy(), want_ids)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert torch.equal(stats["scores"], got)
    assert [tuple(p.shape) for p in stats["pools"]] == [(48, 8), (48, 8)]
    assert stats["init_s"] > 0 and stats["forward_s"] > 0


def test_published_config_parameter_count(monkeypatch):
    """50,453,809 parameters at the published config: ``xdeepfm_init``'s
    tree with its draws replaced by empty meta tensors of the same shapes
    (nothing is allocated or drawn)."""
    monkeypatch.setattr(R, "dense_init", lambda key, shape, scale=None, dtype=None,
                        device=None: torch.empty(shape, dtype=dtype, device="meta"))
    params = R.xdeepfm_init(get_arch("xdeepfm").config, trandom.PRNGKey(0), device="meta")
    leaves, _ = jax.tree.flatten(params)
    assert sum(t.numel() for t in leaves) == 50_453_809
    assert [tuple(w.shape) for w in params["cin"]] == [(1521, 200), (7800, 200), (7800, 200)]
