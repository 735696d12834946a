"""Port parity for the dense LM (``repro_torch.models.lm``), its configs,
the sliced draws behind ``dense_init``, ``interop.lm_params`` and
``launch.serve.serve_lm``, on the CPU against the live reference.

Tolerances:
- sliced draws: bitwise equal to the whole draw;
- ``init_params`` in bfloat16: each leaf equal to the reference's or one
  bf16 ulp apart (``torch.erfinv`` is a few float32 ulp from XLA's, which
  can move a value across a bf16 rounding boundary);
- float32 logits of ``forward``, ``prefill`` and ``decode_step`` on the
  reference's weights: atol 2e-3, rtol 1e-3, the tolerance of the
  reference's own ``test_decode_matches_forward`` (matmuls sum in another
  order; ``theta ** e``, cos, sin and rsqrt differ by ulps);
- bfloat16 prefill logits on the reference's weights: atol 2e-2, rtol
  2e-2 (a few bf16 ulps of logits of order 1: bf16 rounds at other places
  in the two frameworks);
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
from repro_torch.models import common
from repro_torch.models import lm as LM

DENSE = ["llama3-8b", "qwen2.5-14b", "qwen3-14b"]
ATOL, RTOL = 2e-3, 1e-3


@pytest.fixture(autouse=True)
def _threefry_partitionable():
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", prev)


def _f32(arch):
    return (dataclasses.replace(jget_arch(arch).smoke_config, dtype=jnp.float32),
            dataclasses.replace(get_arch(arch).smoke_config, dtype=torch.float32))


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


# ------------------------------------------------------------- sliced draws


@pytest.mark.parametrize("start,stop", [(0, 1000), (17, 4096), (3000, 3001), (4000, None)])
def test_random_bits_range_is_the_whole_draws_slice(start, stop):
    key = trandom.fold_in(trandom.PRNGKey(3), 5)
    whole = trandom.random_bits(key, (64, 64)).reshape(-1)
    part = trandom.random_bits(key, (64, 64), "cpu", start, stop)
    assert torch.equal(part, whole[start:stop])


@pytest.mark.parametrize("dtype,slice_elems", [(torch.float32, 1000), (torch.bfloat16, 777),
                                               (torch.bfloat16, 1 << 26)])
def test_truncated_normal_into_out_is_bitwise_the_whole_draw(dtype, slice_elems):
    key = trandom.PRNGKey(9)
    shape = (3, 40, 50)
    want = (trandom.truncated_normal(key, -2.0, 2.0, shape) * 0.25).to(dtype)
    out = torch.empty(shape, dtype=dtype)
    got = trandom.truncated_normal(key, -2.0, 2.0, shape, out=out, scale=0.25,
                                   slice_elems=slice_elems)
    assert got is out and torch.equal(got, want)
    with pytest.raises(ValueError, match="contiguous"):
        trandom.truncated_normal(key, -2.0, 2.0, shape, out=torch.empty(shape[::-1]).mT)


def test_dense_init_keeps_the_references_fan_in():
    """fan_in is shape[0]: L for the stacked (L, D, F) weights."""
    key = trandom.PRNGKey(1)
    w = common.dense_init(key, (4, 32, 16), dtype=torch.float32, device="cpu")
    want = trandom.truncated_normal(key, -2.0, 2.0, (4, 32, 16)) * (1.0 / 4 ** 0.5)
    assert torch.equal(w, want)
    jw = np.asarray(jax.random.truncated_normal(jax.random.PRNGKey(1), -2.0, 2.0,
                                                (4, 32, 16)) * 0.5)
    np.testing.assert_allclose(w.numpy(), jw, rtol=0, atol=1e-6)


# ------------------------------------------------------------ the configs


def test_configs_are_the_references():
    for arch in DENSE:
        ours, ref = get_arch(arch), jget_arch(arch)
        for cfg, rcfg in ((ours.config, ref.config), (ours.smoke_config, ref.smoke_config)):
            a = {k: v for k, v in dataclasses.asdict(cfg).items() if k != "dtype"}
            b = {k: v for k, v in dataclasses.asdict(rcfg).items() if k != "dtype"}
            assert a == b and cfg.dtype == torch.bfloat16
        assert ours.shapes == ref.shapes and ours.skips == ref.skips
        assert LM.count_params(ours.config) == JLM.count_params(ref.config)
        assert LM.model_flops(ours.config, 4096, False) == JLM.model_flops(ref.config, 4096, False)
    assert LM.count_params(get_arch("llama3-8b").config) == 8_030_261_248
    with pytest.raises(KeyError):
        get_arch("graphsage")  # a name neither registry has


# ---------------------------------------------------------- the parameters


@pytest.mark.parametrize("arch", DENSE)
def test_init_params_matches_reference_in_bf16(arch):
    jp = JLM.init_params(jget_arch(arch).smoke_config, jax.random.PRNGKey(0))
    tp = LM.init_params(get_arch(arch).smoke_config, trandom.PRNGKey(0), device="cpu")
    jl, tl = dict(_leaves(jp)), dict(_leaves(tp))
    assert jl.keys() == tl.keys()
    for path, want in jl.items():
        got = tl[path]
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape, path
        assert np.abs(_u16(got) - _u16(want)).max() <= 1, path


@pytest.mark.parametrize("arch", DENSE)
def test_lm_params_carries_the_reference_tree(arch):
    jp = JLM.init_params(jget_arch(arch).smoke_config, jax.random.PRNGKey(2))
    tp = interop.lm_params(jp, device="cpu")
    for path, want in _leaves(jp):
        assert np.array_equal(_u16(_get(tp, path)), _u16(want)), path


# ------------------------------------------------------------ the forward


@pytest.mark.parametrize("arch", DENSE)
def test_forward_prefill_and_decode_match_reference_in_f32(arch):
    jcfg, cfg = _f32(arch)
    jp = JLM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = interop.lm_params(jp, device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    jf, _ = JLM.forward(jp, jnp.asarray(toks), jcfg)
    tf, aux = LM.forward(tp, torch.from_numpy(toks), cfg, device="cpu")
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=ATOL, rtol=RTOL)
    assert float(aux) == 0.0
    jl, jc = JLM.prefill(jp, jnp.asarray(toks[:, :16]), jcfg, max_seq=24)
    tl, tc = LM.prefill(tp, torch.from_numpy(toks[:, :16]), cfg, max_seq=24, device="cpu")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=RTOL)
    assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), atol=ATOL, rtol=RTOL)
    for i in range(16, 24):
        pos = np.full((2,), i, np.int32)
        jl, jc = JLM.decode_step(jp, jc, jnp.asarray(toks[:, i]), jnp.asarray(pos), jcfg)
        tl, tc2 = LM.decode_step(tp, tc, torch.from_numpy(toks[:, i]), torch.from_numpy(pos),
                                 cfg, device="cpu")
        assert tc2 is tc  # the cache is updated in place
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=RTOL,
                                   err_msg=f"decode step {i}")
    assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_forward_on_the_port(arch):
    """The reference's ``test_decode_matches_forward``, run on the port."""
    _, cfg = _f32(arch)
    params = LM.init_params(cfg, trandom.PRNGKey(0), device="cpu")
    B, S = 2, 24
    toks = trandom.randint(trandom.PRNGKey(0), (B, S), 0, cfg.vocab)
    full, _ = LM.forward(params, toks, cfg, device="cpu")
    logits, cache = LM.prefill(params, toks[:, :16], cfg, max_seq=S, device="cpu")
    torch.testing.assert_close(logits, full[:, 15], atol=ATOL, rtol=RTOL)
    for i in range(16, S):
        pos = torch.full((B,), i, dtype=torch.int32)
        logits, cache = LM.decode_step(params, cache, toks[:, i], pos, cfg, device="cpu")
        torch.testing.assert_close(logits, full[:, i], atol=ATOL, rtol=RTOL)


def test_sliding_window_cache_rolls_like_the_reference():
    jcfg = JLM.LMConfig(n_layers=1, d_model=32, n_heads=2, n_kv_heads=1, d_head=16,
                        d_ff=64, vocab=64, sliding_window=8, attn_chunk=16,
                        dtype=jnp.float32)
    cfg = LM.LMConfig(n_layers=1, d_model=32, n_heads=2, n_kv_heads=1, d_head=16, d_ff=64,
                      vocab=64, sliding_window=8, attn_chunk=16, dtype=torch.float32)
    jp = JLM.init_params(jcfg, jax.random.PRNGKey(1))
    tp = interop.lm_params(jp, device="cpu")
    toks = np.random.default_rng(1).integers(0, 64, (1, 13)).astype(np.int32)
    jl, jc = JLM.prefill(jp, jnp.asarray(toks[:, :11]), jcfg, max_seq=20)
    tl, tc = LM.prefill(tp, torch.from_numpy(toks[:, :11]), cfg, max_seq=20, device="cpu")
    assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for i in (11, 12):
        pos = np.full((1,), i, np.int32)
        jl, jc = JLM.decode_step(jp, jc, jnp.asarray(toks[:, i]), jnp.asarray(pos), jcfg)
        tl, tc = LM.decode_step(tp, tc, torch.from_numpy(toks[:, i]), torch.from_numpy(pos),
                                cfg, device="cpu")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=RTOL)
    assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_logits_match_reference_in_bf16(arch):
    jcfg, cfg = jget_arch(arch).smoke_config, get_arch(arch).smoke_config
    jp = JLM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = interop.lm_params(jp, device="cpu")
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    jl, _ = JLM.prefill(jp, jnp.asarray(toks), jcfg, max_seq=48)
    tl, _ = LM.prefill(tp, torch.from_numpy(toks), cfg, max_seq=48, device="cpu")
    assert tl.dtype == torch.bfloat16
    np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32),
                               atol=2e-2, rtol=2e-2)


def test_loss_fn_matches_reference():
    jcfg, cfg = _f32("qwen3-14b")
    jp = JLM.init_params(jcfg, jax.random.PRNGKey(5))
    tp = interop.lm_params(jp, device="cpu")
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)}
    jloss, _ = JLM.loss_fn(jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    loss, parts = LM.loss_fn(tp, batch, cfg, device="cpu")
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert float(parts["aux"]) == 0.0


# ------------------------------------------------------------ serve_lm


def _f32_registry(monkeypatch, arch):
    """Both serve_lm functions read the smoke config from their registry: swap in the
    float32 copies."""
    jcfg, cfg = _f32(arch)
    jspec = dataclasses.replace(jget_arch(arch), smoke_config=jcfg)
    spec = dataclasses.replace(get_arch(arch), smoke_config=cfg)
    monkeypatch.setattr(jserve, "get_arch", lambda name: jspec)
    monkeypatch.setattr(tserve, "get_arch", lambda name: spec)


@pytest.mark.parametrize("arch", DENSE)
def test_serve_lm_tokens_equal_the_references_in_f32(arch, monkeypatch, capsys):
    _f32_registry(monkeypatch, arch)
    want = np.asarray(jserve.serve_lm(arch, prompt_len=12, gen_tokens=6, batch=2, seed=3))
    stats = {}
    got = tserve.serve_lm(arch, prompt_len=12, gen_tokens=6, batch=2, seed=3, device="cpu",
                          stats=stats)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert len(stats["decode_s"]) == 5 and stats["prefill_logits"].shape == (2, 512)
    assert capsys.readouterr().out.count(f"[serve] {arch}: 2×6 tokens in") == 2


def test_serve_lm_bf16_first_logits_match_reference():
    """bfloat16 (the configs' type): the prefill logits, on each side's own
    weights (a few bf16 ulps apart), within atol 2e-2, rtol 2e-2."""
    arch = "llama3-8b"
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


def test_cli(capsys):
    tserve.main(["--arch", "qwen3-14b", "--tokens", "3", "--batch", "1", "--device", "cpu"])
    assert "[serve] qwen3-14b: 1×3 tokens in" in capsys.readouterr().out
    with pytest.raises(ValueError, match="unknown --graph"):
        tserve.main(["--graph", "kronecker", "--device", "cpu"])
    tserve.main(["--arch", "xdeepfm", "--batch", "3", "--device", "cpu"])
    assert "[serve] xdeepfm: scored 3 in" in capsys.readouterr().out
