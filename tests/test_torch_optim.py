"""Port parity of the optimizer (``repro_torch.optim``) against the live
``repro.optim``, on the CPU.

The inputs are made with numpy from a seed and given to both packages.
Tolerances: the schedules, and AdamW's parameters, ``mu`` and ``nu``,
within rtol 1e-6 (``torch.pow``, ``torch.cos`` and the sums of the global
norm are other float32 routines than XLA's, an ulp or so apart); the step
count exactly; the top-k compression and the int8 quantisation bit for
bit (the uniforms are ``repro_torch.random``'s, JAX's bits)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro_torch import interop, optim
from repro_torch import random as trandom

RTOL = 1e-6


@pytest.fixture(autouse=True)
def _threefry_partitionable():
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", prev)


def _tree(seed: int, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"b": [rng.standard_normal((5,)).astype(dtype),
                  rng.standard_normal((3, 4)).astype(dtype)],
            "a": rng.standard_normal((7, 2)).astype(dtype) * 3}


def _leaves(tree):
    return jax.tree.leaves(tree)


@pytest.mark.parametrize("fn,args", [("linear_warmup", (10,)), ("linear_warmup", (0,)),
                                     ("cosine_schedule", (5, 40)),
                                     ("cosine_schedule", (0, 7, 0.3))])
def test_schedules(fn, args):
    steps = np.arange(0, 50, dtype=np.int32)
    want = np.asarray(getattr(jopt, fn)(*args)(jnp.asarray(steps)))
    got = getattr(optim, fn)(*args)(torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("clip,schedule", [(1.0, None), (100.0, None),
                                           (0.5, ("cosine_schedule", (2, 6)))])
def test_adamw_update_against_reference_grads(clip, schedule):
    params = _tree(0)
    jcfg = jopt.AdamWConfig(clip_norm=clip, schedule=None if schedule is None else
                            getattr(jopt, schedule[0])(*schedule[1]))
    tcfg = optim.AdamWConfig(clip_norm=clip, schedule=None if schedule is None else
                             getattr(optim, schedule[0])(*schedule[1]))
    js = jopt.init_state(jax.tree.map(jnp.asarray, params))
    ts = optim.init_state(interop.train_params(params, device="cpu"))
    for step in range(4):
        grads = _tree(10 + step)
        js = jopt.adamw_update(js, jax.tree.map(jnp.asarray, grads), jcfg)
        ts = optim.adamw_update(ts, interop.train_params(grads, device="cpu"), tcfg)
        assert int(ts.step) == int(js.step) == step + 1 and ts.step.dtype == torch.int32
        for name in ("params", "mu", "nu"):
            for w, g in zip(_leaves(getattr(js, name)), optim.adamw.tree_flatten(
                    getattr(ts, name))[0]):
                assert g.dtype == torch.float32
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=1e-9)


def test_adamw_keeps_bf16_params_and_donates():
    params = {"w": np.linspace(-2, 2, 24, dtype=np.float32).reshape(4, 6)}
    jp = {"w": jnp.asarray(params["w"], jnp.bfloat16)}
    js = jopt.init_state(jp)
    tp = {"w": torch.from_numpy(params["w"]).to(torch.bfloat16)}
    ts = optim.init_state(tp)
    grads = _tree(3)["a"].reshape(14)[:12].reshape(2, 6).repeat(2, 0)
    jg = {"w": jnp.asarray(grads, jnp.bfloat16)}
    tg = {"w": torch.from_numpy(grads).to(torch.bfloat16)}
    want = jopt.adamw_update(js, jg, jopt.AdamWConfig())
    new = optim.adamw_update(ts, tg, optim.AdamWConfig())
    assert new.params["w"] is tp["w"] and new.params["w"].dtype == torch.bfloat16
    assert new.mu["w"] is ts.mu["w"] and new.mu["w"].dtype == torch.float32
    np.testing.assert_allclose(new.params["w"].float().numpy(),
                               np.asarray(want.params["w"], np.float32), rtol=2**-8)
    np.testing.assert_allclose(new.nu["w"].numpy(), np.asarray(want.nu["w"]), rtol=RTOL)


def test_make_train_step_against_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((16, 4)).astype(np.float32)
    y = rng.standard_normal((16,)).astype(np.float32)
    params = {"w": rng.standard_normal((4,)).astype(np.float32), "b": np.float32([0.3])}

    def jloss(p, batch, cfg):
        err = batch["x"] @ p["w"] + p["b"][0] - batch["y"]
        return jnp.mean(err ** 2), {"mae": jnp.mean(jnp.abs(err))}

    def tloss(p, batch, cfg):
        err = batch["x"] @ p["w"] + p["b"][0] - batch["y"]
        return torch.mean(err ** 2), {"mae": torch.mean(torch.abs(err))}

    jstep = jopt.make_train_step(jloss, None, jopt.AdamWConfig(lr=1e-2))
    tstep = optim.make_train_step(tloss, None, optim.AdamWConfig(lr=1e-2))
    js = jopt.init_state(jax.tree.map(jnp.asarray, params))
    ts = optim.init_state(interop.train_params(params, device="cpu"))
    jb = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    tb = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    for _ in range(5):
        js, jm = jstep(js, jb)
        ts, tm = tstep(ts, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["mae"]), float(jm["mae"]), rtol=1e-5)
        assert not tm["loss"].requires_grad
    for k in params:
        np.testing.assert_allclose(ts.params[k].numpy(), np.asarray(js.params[k]),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("frac", [0.01, 0.2, 0.5])
def test_topk_compress_update_bitwise(frac):
    grads = _tree(1)
    jstate = jopt.grad_compress.init_compress_state(jax.tree.map(jnp.asarray, grads))
    tstate = optim.init_compress_state(interop.train_params(grads, device="cpu"))
    for step in range(3):
        g = _tree(20 + step)
        jsent, jstate, jwire = jopt.topk_compress_update(jax.tree.map(jnp.asarray, g),
                                                          jstate, frac)
        tsent, tstate, twire = optim.topk_compress_update(
            interop.train_params(g, device="cpu"), tstate, frac)
        assert twire == jwire
        for a, b in zip(_leaves(jsent), optim.adamw.tree_flatten(tsent)[0]):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        for a, b in zip(_leaves(jstate.residual), optim.adamw.tree_flatten(
                tstate.residual)[0]):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("seed,shape", [(0, (64, 33)), (7, (1000,)), (3, (2, 3, 5))])
def test_int8_compress_bitwise(seed, shape):
    g = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 0.01
    jq, jscale = jopt.int8_compress(jnp.asarray(g), jax.random.PRNGKey(seed + 1))
    tq, tscale = optim.int8_compress(torch.from_numpy(g), trandom.PRNGKey(seed + 1))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tscale.numpy().tobytes() == np.asarray(jscale).tobytes()
    np.testing.assert_array_equal(
        optim.int8_decompress(tq, tscale).numpy(),
        np.asarray(jopt.grad_compress.int8_decompress(jq, jscale)))
