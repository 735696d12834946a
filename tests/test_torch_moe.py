"""Port parity for Mixtral's MoE LM (``repro_torch.models.lm`` with
``n_experts > 0``), its configs, ``interop.lm_params`` over the MoE tree
and ``launch.serve.serve_lm`` of ``mixtral-8x7b`` and ``mixtral-8x22b``,
on the CPU against the live reference.

Routing is discrete: an ulp in a router logit can send a token to another
expert, which changes its output wholly.  So the routing (``gate_e``, the
slots, ``keep``, the drops of each row) is held bit for bit, and the values
within a tolerance.  The reference's routing is read from its own
``_moe_dispatch_group`` as it runs (its ``lax.top_k`` and its first
``jnp.where``, the slots).  Where the inputs are random, the tests assert
the least margin between each token's K-th and (K+1)-th router
probability, so that the routing they hold does not rest on an ulp.

Tolerances:
- routing: bitwise; ``out`` of a dispatch group and of the block in
  float32: rtol 1e-5 and atol 1e-5 of the output's largest magnitude
  (the smoke configs' experts are drawn with fan-in L = 2, so outputs
  reach ~3·10^3 from inputs of order 1, and an element that two products
  of that size cancel to near 0 keeps their float32 rounding); aux: rtol
  1e-5;
- ``init_params`` in bfloat16: each leaf equal to the reference's or one
  bf16 ulp apart (``torch.erfinv`` is a few float32 ulp from XLA's);
- float32 logits of ``forward``, ``prefill`` and ``decode_step`` on the
  reference's weights: atol 2e-3, rtol 1e-3 (the reference's own
  decode-against-forward tolerance);
- bfloat16 prefill logits of ``serve_lm``: atol 2e-2, rtol 2e-2;
- ``serve_lm`` tokens in float32: equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.launch import serve as jserve
from repro.models import lm as JLM
from repro_torch import interop
from repro_torch import random as trandom
from repro_torch.configs import get_arch
from repro_torch.launch import serve as tserve
from repro_torch.models import lm as LM

MIXTRAL = ["mixtral-8x7b", "mixtral-8x22b"]
ATOL, RTOL = 2e-3, 1e-3
MARGIN = 1e-5  # least K-th to (K+1)-th router-probability gap on random inputs


@pytest.fixture(autouse=True)
def _threefry_partitionable():
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", prev)


def _f32(arch, **kw):
    return (dataclasses.replace(jget_arch(arch).smoke_config, dtype=jnp.float32, **kw),
            dataclasses.replace(get_arch(arch).smoke_config, dtype=torch.float32, **kw))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _u16(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16).astype(np.int64)
    return np.asarray(x).view(np.uint16).astype(np.int64)


def _ref_group(x, mp, jcfg, monkeypatch):
    """The reference's ``_moe_dispatch_group`` on ``x`` (T, D), run eagerly,
    with the routing it computed: ``gate_w``, ``gate_e`` (its
    ``lax.top_k``), ``keep`` and ``slot`` (its first ``jnp.where``)."""
    seen = {}
    top_k, where = jax.lax.top_k, jnp.where

    def rec_top_k(a, k):
        seen["gate_w"], seen["gate_e"] = (np.asarray(v) for v in top_k(a, k))
        return top_k(a, k)

    def rec_where(*args):
        out = where(*args)
        if "slot" not in seen:
            seen["keep"], seen["slot"] = np.asarray(args[0]), np.asarray(out)
        return out

    with monkeypatch.context() as m:
        m.setattr(jax.lax, "top_k", rec_top_k)
        m.setattr(jnp, "where", rec_where)
        out, aux = JLM._moe_dispatch_group(jnp.asarray(x), mp, jcfg)
    return np.asarray(out), float(aux), seen


def _margin(x, router, k: int) -> float:
    """The least gap between a token's k-th and (k+1)-th router probability
    (float64 from the float32 inputs)."""
    logits = x.astype(np.float64) @ router.astype(np.float64)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = np.sort(p / p.sum(-1, keepdims=True), axis=-1)[:, ::-1]
    return float((p[:, k - 1] - p[:, k]).min())


def _close_to_scale(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))


def _layer0_mlp(params):
    """Layer 0's MoE leaves of a stacked parameter tree."""
    return {k: v[0] for k, v in params["layers"]["mlp"].items()}


def _moe_inputs(case, cfg, router, rng):
    """(T, D) inputs of a dispatch-group case and the router to use."""
    T = {"capacity_binds": 64, "planted_ties": 24, "t_below_8": 5, "t_is_1": 1}[case]
    x = rng.standard_normal((T, cfg.d_model)).astype(np.float32)
    if case == "capacity_binds":  # lean every token toward expert 0
        r0 = router[:, 0]
        x += (4.0 * r0 / float(r0 @ r0)).astype(np.float32)
    if case == "planted_ties":  # equal logits: experts 0 and 1 for every token
        router = np.zeros_like(router)
    return x, router


# ------------------------------------------------------------ the configs


@pytest.mark.parametrize("arch", MIXTRAL)
def test_configs_are_the_references(arch):
    ours, ref = get_arch(arch), jget_arch(arch)
    assert (ours.name, ours.family) == (ref.name, ref.family)
    for cfg, rcfg in ((ours.config, ref.config), (ours.smoke_config, ref.smoke_config)):
        a = {k: v for k, v in dataclasses.asdict(cfg).items() if k != "dtype"}
        b = {k: v for k, v in dataclasses.asdict(rcfg).items() if k != "dtype"}
        assert a == b and cfg.dtype == torch.bfloat16 and cfg.is_moe
    assert ours.shapes == ref.shapes and ours.skips == ref.skips
    assert LM.count_params(ours.config) == JLM.count_params(ref.config)
    assert LM.active_params(ours.config) == JLM.active_params(ref.config)
    for train in (True, False):
        assert LM.model_flops(ours.config, 4096, train) == JLM.model_flops(ref.config, 4096, train)


def test_mixtral_8x7b_sizes():
    cfg = get_arch("mixtral-8x7b").config
    assert LM.count_params(cfg) == 46_702_792_704
    assert LM.count_params(dataclasses.replace(cfg, n_layers=16)) == 23_482_470_400
    assert LM.active_params(cfg) == 12_879_925_248


# ---------------------------------------------------------- the parameters


@pytest.mark.parametrize("arch", MIXTRAL)
def test_init_params_matches_reference_in_bf16(arch):
    jp = JLM.init_params(jget_arch(arch).smoke_config, jax.random.PRNGKey(0))
    tp = LM.init_params(get_arch(arch).smoke_config, trandom.PRNGKey(0), device="cpu")
    jl, tl = dict(_leaves(jp)), dict(_leaves(tp))
    assert jl.keys() == tl.keys()
    assert {"router", "w_gate", "w_up", "w_down"} == set(tp["layers"]["mlp"])
    for path, want in jl.items():
        got = tl[path]
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape, path
        assert np.abs(_u16(got) - _u16(want)).max() <= 1, path


@pytest.mark.parametrize("arch", MIXTRAL)
def test_lm_params_carries_the_moe_tree(arch):
    jp = JLM.init_params(jget_arch(arch).smoke_config, jax.random.PRNGKey(2))
    tp = interop.lm_params(jp, device="cpu")
    assert dict(_leaves(jp)).keys() == dict(_leaves(tp)).keys()
    for path, want in _leaves(jp):
        got = _get(tp, path)
        assert tuple(got.shape) == want.shape, path
        assert np.array_equal(_u16(got), _u16(want)), path


# --------------------------------------------------------- the dispatch


@pytest.mark.parametrize("case", ["capacity_binds", "planted_ties", "t_below_8", "t_is_1"])
def test_dispatch_group_routing_is_the_references(case, monkeypatch):
    jcfg, cfg = _f32("mixtral-8x7b")
    jp = JLM.init_params(jcfg, jax.random.PRNGKey(0))
    jmp = _layer0_mlp(jp)
    router = np.asarray(jmp["router"])
    x, router = _moe_inputs(case, cfg, router, np.random.default_rng(7))
    jmp = {**jmp, "router": jnp.asarray(router)}
    tmp = interop.lm_params(jmp, device="cpu")
    T, E, K = x.shape[0], cfg.n_experts, cfg.top_k
    cap = max(8, min(int(cfg.capacity_factor * K * T / E), T))
    if case == "planted_ties":
        assert _margin(x, router, K) == 0.0
    else:
        assert _margin(x, router, K) > MARGIN

    want, want_aux, seen = _ref_group(x, jmp, jcfg, monkeypatch)
    route = {}
    got, aux = LM._moe_dispatch_group(torch.from_numpy(x), tmp, cfg, route=route)
    assert got.shape == (T, cfg.d_model) and aux.shape == ()
    assert np.array_equal(route["gate_e"].numpy(), seen["gate_e"])
    assert np.array_equal(route["slot"].numpy(), seen["slot"])
    assert np.array_equal(route["keep"].numpy(), seen["keep"])
    np.testing.assert_allclose(route["gate_w"].numpy(), seen["gate_w"] /
                               seen["gate_w"].sum(-1, keepdims=True), rtol=1e-6, atol=1e-7)
    _close_to_scale(got.numpy(), want)
    np.testing.assert_allclose(float(aux), want_aux, rtol=1e-5)
    load = route["load"].numpy()
    assert load.sum() == T * K and np.array_equal(load, np.bincount(seen["gate_e"].ravel(), minlength=E))
    dropped = int((~seen["keep"]).sum())
    assert dropped == int(np.maximum(load - cap, 0).sum())
    if case == "capacity_binds":
        assert dropped > 0
    if case == "planted_ties":  # every token to experts 0 and 1, each over capacity
        assert (seen["gate_e"] == np.array([0, 1])).all() and dropped == 2 * (T - cap) > 0
    if case in ("t_below_8", "t_is_1"):  # cap = 8 > T: nothing dropped
        assert cap == 8 and dropped == 0


def test_moe_block_drops_row_by_row(monkeypatch):
    """Three rows that differ, capacity binding in each: each row is its own
    dispatch group, so its drops are the reference's row for row (one
    flattened group of 3·T tokens has another capacity and drops)."""
    jcfg, cfg = _f32("mixtral-8x7b")
    jp = JLM.init_params(jcfg, jax.random.PRNGKey(0))
    jmp = _layer0_mlp(jp)
    tmp = interop.lm_params(jmp, device="cpu")
    router = np.asarray(jmp["router"])
    rng = np.random.default_rng(11)
    T, K = 48, cfg.top_k
    x = rng.standard_normal((3, T, cfg.d_model)).astype(np.float32)
    for r, (e, lean) in enumerate([(0, 4.0), (2, 3.0), (3, 6.0)]):
        x[r] += (lean * router[:, e] / float(router[:, e] @ router[:, e])).astype(np.float32)
    for r in range(3):
        assert _margin(x[r], router, K) > MARGIN

    want, want_aux = JLM._moe_block(jnp.asarray(x), jmp, jcfg)
    want_drops = [int((~_ref_group(x[r], jmp, jcfg, monkeypatch)[2]["keep"]).sum())
                  for r in range(3)]
    route = {}
    got, aux = LM._moe_block(torch.from_numpy(x), tmp, cfg, route=route)
    drops = (~route["keep"]).sum(-1).tolist()
    assert drops == want_drops and all(d > 0 for d in drops)
    assert len(set(drops)) > 1  # the rows differ
    _close_to_scale(got.numpy(), want)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    flat = {}
    LM._moe_dispatch_group(torch.from_numpy(x.reshape(3 * T, -1)), tmp, cfg, route=flat)
    assert int((~flat["keep"]).sum()) != sum(want_drops)


# ------------------------------------------------------------ the forward


@pytest.mark.parametrize("arch", MIXTRAL)
def test_forward_prefill_and_decode_match_reference_in_f32(arch):
    """Past the smoke config's 32-token window: the cache rolls."""
    jcfg, cfg = _f32(arch)
    jp = JLM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = interop.lm_params(jp, device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 44)).astype(np.int32)
    jf, jaux = JLM.forward(jp, jnp.asarray(toks), jcfg)
    tf, aux = LM.forward(tp, torch.from_numpy(toks), cfg, device="cpu")
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=ATOL, rtol=RTOL)
    assert float(aux) > 0.0
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    jl, jc = JLM.prefill(jp, jnp.asarray(toks[:, :36]), jcfg, max_seq=44)
    tl, tc = LM.prefill(tp, torch.from_numpy(toks[:, :36]), cfg, max_seq=44, device="cpu")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=RTOL)
    assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), atol=ATOL, rtol=RTOL)
    for i in range(36, 44):
        pos = np.full((2,), i, np.int32)
        jl, jc = JLM.decode_step(jp, jc, jnp.asarray(toks[:, i]), jnp.asarray(pos), jcfg)
        tl, tc = LM.decode_step(tp, tc, torch.from_numpy(toks[:, i]), torch.from_numpy(pos),
                                cfg, device="cpu")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=RTOL,
                                   err_msg=f"decode step {i}")
    assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("arch", MIXTRAL)
def test_decode_matches_forward_on_the_port(arch):
    """The reference's ``test_decode_matches_forward`` (capacity factor 8:
    nothing dropped, so a token's route does not depend on the others'),
    run on the port."""
    _, cfg = _f32(arch, capacity_factor=8.0)
    params = LM.init_params(cfg, trandom.PRNGKey(0), device="cpu")
    B, S = 2, 24
    toks = trandom.randint(trandom.PRNGKey(0), (B, S), 0, cfg.vocab)
    full, _ = LM.forward(params, toks, cfg, device="cpu")
    routes = []
    logits, cache = LM.prefill(params, toks[:, :16], cfg, max_seq=S, device="cpu",
                               routes=routes)
    assert len(routes) == cfg.n_layers and all(bool(r["keep"].all()) for r in routes)
    torch.testing.assert_close(logits, full[:, 15], atol=ATOL, rtol=RTOL)
    for i in range(16, S):
        pos = torch.full((B,), i, dtype=torch.int32)
        logits, cache = LM.decode_step(params, cache, toks[:, i], pos, cfg, device="cpu")
        torch.testing.assert_close(logits, full[:, i], atol=ATOL, rtol=RTOL)


def test_loss_fn_adds_the_aux_loss():
    jcfg, cfg = _f32("mixtral-8x7b")
    jp = JLM.init_params(jcfg, jax.random.PRNGKey(5))
    tp = interop.lm_params(jp, device="cpu")
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)}
    jloss, jparts = JLM.loss_fn(jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    loss, parts = LM.loss_fn(tp, batch, cfg, device="cpu")
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(parts["aux"]), float(jparts["aux"]), rtol=1e-5)
    torch.testing.assert_close(loss, parts["xent"] + 0.01 * parts["aux"])


# ------------------------------------------------------------ serve_lm


def _f32_registry(monkeypatch, arch):
    jcfg, cfg = _f32(arch)
    jspec = dataclasses.replace(jget_arch(arch), smoke_config=jcfg)
    spec = dataclasses.replace(get_arch(arch), smoke_config=cfg)
    monkeypatch.setattr(jserve, "get_arch", lambda name: jspec)
    monkeypatch.setattr(tserve, "get_arch", lambda name: spec)
    return cfg


@pytest.mark.parametrize("arch", MIXTRAL)
def test_serve_lm_tokens_equal_the_references_in_f32(arch, monkeypatch, capsys):
    """Prompts of 40 tokens, past the 32-token window; the stats hold each
    layer's drops and expert loads."""
    cfg = _f32_registry(monkeypatch, arch)
    want = np.asarray(jserve.serve_lm(arch, prompt_len=40, gen_tokens=6, batch=2, seed=3))
    stats = {}
    got = tserve.serve_lm(arch, prompt_len=40, gen_tokens=6, batch=2, seed=3, device="cpu",
                          stats=stats)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert capsys.readouterr().out.count(f"[serve] {arch}: 2×6 tokens in") == 2
    moe = stats["moe"]
    cap = int(cfg.capacity_factor * cfg.top_k * 40 / cfg.n_experts)
    assert len(moe) == cfg.n_layers
    for layer in moe:
        load = np.asarray(layer["load"])
        assert load.shape == (2, cfg.n_experts) and (load.sum(-1) == 40 * cfg.top_k).all()
        assert layer["dropped"] == np.maximum(load - cap, 0).sum(-1).tolist()


@pytest.mark.parametrize("arch", MIXTRAL)
def test_serve_lm_bf16_prefill_logits_match_reference(arch):
    """bfloat16 (the configs' type), each side on its own weights (a bf16
    ulp apart at most): the prefill logits within atol 2e-2, rtol 2e-2."""
    cfg, jcfg = get_arch(arch).smoke_config, jget_arch(arch).smoke_config
    key = jax.random.PRNGKey(0)
    jp = JLM.init_params(jcfg, key)
    prompts = jax.random.randint(key, (2, 16), 0, jcfg.vocab, dtype=jnp.int32)
    jl, _ = JLM.prefill(jp, prompts, jcfg, max_seq=20)
    stats = {}
    tserve.serve_lm(arch, prompt_len=16, gen_tokens=4, batch=2, seed=0, device="cpu",
                    stats=stats)
    got = stats["prefill_logits"]
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.float().numpy(), np.asarray(jl, np.float32),
                               atol=2e-2, rtol=2e-2)


def test_serve_lm_cuts_the_depth():
    stats = {}
    tserve.serve_lm("mixtral-8x7b", prompt_len=8, gen_tokens=2, batch=1, device="cpu",
                    stats=stats, n_layers=1)
    assert len(stats["moe"]) == 1


def test_cli_serves_mixtral(capsys):
    tserve.main(["--arch", "mixtral-8x7b", "--tokens", "3", "--batch", "1", "--device", "cpu"])
    tserve.main(["--arch", "mixtral-8x22b", "--tokens", "2", "--batch", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] mixtral-8x7b: 1×3 tokens in" in out
    assert "[serve] mixtral-8x22b: 1×2 tokens in" in out
