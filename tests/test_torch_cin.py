"""K7's plain version and wrapper on the CPU (``repro_torch.kernels.cin``)
against the live reference (``repro.kernels.cin``).

Tolerances:
- float32: max |Δ| / max |want| ≤ 1e-5 against the reference's jnp
  ``cin_layer_ref`` and against the Pallas kernel in interpret mode.  All
  three form z in float32 and sum 1e2–1e4 products in float32 in their own
  orders; measured ~6e-7 at the published shapes, and a dropped term
  moves the result far beyond 1e-5;
- bfloat16: each output within one bf16 ulp of the float32 result on the
  same (bf16) inputs, plus the float32 limit (1e-5 of max |want|): the
  port, like ``_cin_kernel``, forms z and the sums in float32 and rounds
  once, so only that rounding and the float32 sums' own disagreement
  (which shows near zero, where an ulp is tiny) can differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.cin import cin_layer_kernel as jcin_kernel
from repro.kernels.cin import cin_layer_ref as jcin_ref
from repro_torch.kernels.cin import (cin_layer, cin_layer_kernel, cin_layer_ref,
                                     launch_counts, reset_launch_counts)

SHAPES = [(64, 10, 6, 8, 12), (300, 39, 39, 10, 200), (77, 10, 6, 8, 12)]
REL_F32 = 1e-5


def _inputs(B, Hk, m, D, Hn, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hk, D), np.float32),
            rng.standard_normal((B, m, D), np.float32),
            (0.1 * rng.standard_normal((Hk * m, Hn))).astype(np.float32))


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def _bf16(a: np.ndarray):
    """(jnp bf16 array, torch bf16 tensor) of one array, and its float32 values."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, torch.from_numpy(a).to(torch.bfloat16), np.asarray(j, np.float32)


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """The spacing of bfloat16 at |v| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), np.float32(2.0**-126))))
    return np.exp2(e - 7).astype(np.float32)


@pytest.mark.parametrize("B,Hk,m,D,Hn", SHAPES)
def test_plain_version_float32_matches_reference(B, Hk, m, D, Hn):
    xk, x0, w = _inputs(B, Hk, m, D, Hn, seed=B + Hk)
    got = cin_layer_ref(*(torch.from_numpy(a) for a in (xk, x0, w)))
    assert got.dtype == torch.float32 and got.shape == (B, Hn, D)
    got = got.numpy()
    want = np.asarray(jcin_ref(jnp.asarray(xk), jnp.asarray(x0), jnp.asarray(w)))
    pallas = np.asarray(jcin_kernel(jnp.asarray(xk), jnp.asarray(x0), jnp.asarray(w),
                                    batch_block=64, interpret=True))
    assert _rel(got, want) <= REL_F32
    assert _rel(got, pallas) <= REL_F32


@pytest.mark.parametrize("B,Hk,m,D,Hn", SHAPES)
def test_plain_version_bfloat16_within_one_ulp(B, Hk, m, D, Hn):
    arrays = _inputs(B, Hk, m, D, Hn, seed=B + Hk + 1)
    (jxk, txk, fxk), (jx0, tx0, fx0), (jw, tw, fw) = (_bf16(a) for a in arrays)
    got = cin_layer_ref(txk, tx0, tw)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    # the float32 result on the bf16 inputs, by the reference's jnp layer
    want = np.asarray(jcin_ref(jnp.asarray(fxk), jnp.asarray(fx0), jnp.asarray(fw)))
    pallas = np.asarray(jcin_kernel(jxk, jx0, jw, batch_block=64, interpret=True),
                        np.float32)
    limit = _bf16_ulp(want) + REL_F32 * np.abs(want).max()
    assert (np.abs(got - want) <= limit).all()
    assert (np.abs(pallas - want) <= limit).all()


def test_wrapper_on_cpu_runs_the_plain_version():
    xk, x0, w = (torch.from_numpy(a) for a in _inputs(33, 5, 4, 3, 7, seed=0))
    reset_launch_counts()
    got = cin_layer(xk, x0, w)
    assert torch.equal(got, cin_layer_ref(xk, x0, w))
    assert torch.equal(cin_layer_kernel(xk.numpy(), x0.numpy(), w.numpy(), device="cpu"),
                       got)
    # a transposed (non-contiguous) input is made contiguous by the entry point
    xt = xk.transpose(1, 2).contiguous().transpose(1, 2)
    assert torch.equal(cin_layer_kernel(xt, x0, w), got)
    assert launch_counts() == {"cin": 0}


def test_wrapper_refuses_bad_inputs():
    xk, x0, w = (torch.from_numpy(a) for a in _inputs(4, 3, 2, 5, 6, seed=1))
    with pytest.raises(ValueError, match="do not fit"):
        cin_layer(xk, x0, w[:-1])
    with pytest.raises(ValueError, match="do not fit"):
        cin_layer(xk, x0[:, :, :4], w)
    with pytest.raises(ValueError, match=r"\(B, Hk, D\)"):
        cin_layer(xk[0], x0, w)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cin_layer(xk.half(), x0.half(), w.half())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cin_layer(xk, x0.to(torch.bfloat16), w)
    with pytest.raises(ValueError, match="cuda or cpu"):
        cin_layer(xk.to("meta"), x0.to("meta"), w.to("meta"))
    with pytest.raises(ValueError, match="another input on meta"):
        cin_layer(xk, x0.to("meta"), w)


def test_plain_version_has_a_gradient_on_the_cpu():
    """On the CPU the plain version is differentiable torch; K7's gradient
    raises (tests/test_torch_kernels_gpu.py)."""
    xk, x0, w = (torch.from_numpy(a) for a in _inputs(4, 3, 2, 5, 6, seed=2))
    w.requires_grad_(True)
    cin_layer(xk, x0, w).sum().backward()
    assert w.grad is not None and torch.isfinite(w.grad).all()
