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

try:  # the container image may lack hypothesis; gate, don't require
    from hypothesis import given, settings
    from hypothesis import strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

from repro.kernels.cin import cin_layer_kernel as jcin_kernel
from repro.kernels.cin import cin_layer_ref as jcin_ref
from repro_torch.kernels.cin import (cin_layer, cin_layer_kernel, cin_layer_ref,
                                     cin_split_partials, launch_counts, plan,
                                     reset_launch_counts)
from repro_torch.kernels.cin.kernel import SMEM_LIMIT, smem_bytes
from repro_torch.kernels.cin.ref import STAGE_K, pad_fields, tf32_rna

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
    assert launch_counts() == {"cin": 0, "cin_bwd": 0}


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
    """On the CPU the layer is differentiable through the plain versions of
    K7 and K7b (the card's K7b: tests/test_torch_kernels_gpu.py)."""
    xk, x0, w = (torch.from_numpy(a) for a in _inputs(4, 3, 2, 5, 6, seed=2))
    w.requires_grad_(True)
    cin_layer(xk, x0, w).sum().backward()
    assert w.grad is not None and torch.isfinite(w.grad).all()


# --- the tensor-core kernel's arithmetic (ref.cin_split_partials) -------------

# published widths (m = 39, D = 10, H' = 200) at layer 1 (Hk = 39) and 2
# (Hk = 200) with a small B; a ragged small case; K = 7·13 = 91, a multiple
# of neither 8 nor 16 (13 fields pad to 16)
EMU_SHAPES = [(6, 39, 39, 10, 200), (4, 200, 39, 10, 200), (77, 5, 3, 4, 12),
              (33, 7, 13, 3, 41)]


def _emulated(xk, x0, w, splits):
    """The partials' sum in split order (splits capped at the K stages)."""
    k_stages = -(-xk.shape[1] * pad_fields(x0.shape[1]) // STAGE_K[xk.dtype])
    parts = cin_split_partials(xk, x0, w, splits=min(splits, k_stages))
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total.to(xk.dtype)


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("B,Hk,m,D,Hn", EMU_SHAPES)
def test_emulation_float32_matches_reference(B, Hk, m, D, Hn, splits):
    """3×TF32 (hi·lo + lo·hi + hi·hi, lo·lo dropped), summed stage by stage
    and split by split: within 1e-5 of max of the reference's jnp layer and
    its interpret-mode Pallas kernel."""
    xk, x0, w = _inputs(B, Hk, m, D, Hn, seed=B + Hk + 7)
    got = _emulated(*(torch.from_numpy(a) for a in (xk, x0, w)), splits).numpy()
    want = np.asarray(jcin_ref(jnp.asarray(xk), jnp.asarray(x0), jnp.asarray(w)))
    pallas = np.asarray(jcin_kernel(jnp.asarray(xk), jnp.asarray(x0), jnp.asarray(w),
                                    batch_block=64, interpret=True))
    assert _rel(got, want) <= REL_F32
    assert _rel(got, pallas) <= REL_F32


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("B,Hk,m,D,Hn", EMU_SHAPES)
def test_emulation_bfloat16_within_one_ulp(B, Hk, m, D, Hn, splits):
    """Two exact bf16 passes (z_lo·w, z_hi·w): the reference's products, so
    within one bf16 ulp (+ 1e-5 of max for the float32 sums' order) of the
    float32 result on the same bf16 inputs, as the plain version."""
    arrays = _inputs(B, Hk, m, D, Hn, seed=B + Hk + 8)
    (_, txk, fxk), (_, tx0, fx0), (_, tw, fw) = (_bf16(a) for a in arrays)
    got = _emulated(txk, tx0, tw, splits)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jcin_ref(jnp.asarray(fxk), jnp.asarray(fx0), jnp.asarray(fw)))
    limit = _bf16_ulp(want) + REL_F32 * np.abs(want).max()
    assert (np.abs(got.float().numpy() - want) <= limit).all()


def _bf16_from_bits(bits) -> torch.Tensor:
    return torch.tensor(np.asarray(bits, np.uint16).view(np.int16)).view(torch.bfloat16)


def _assert_bf16_split_exact(a: torch.Tensor, b: torch.Tensor) -> None:
    z = a.float() * b.float()
    hi = z.bfloat16()
    lo = (z - hi.float()).bfloat16()
    assert torch.equal(hi.float() + lo.float(), z)


def test_bf16_split_exact_for_every_mantissa_pair():
    """A product of two bf16 values has at most 16 significant bits, so
    z = z_hi + z_lo in two bf16 values exactly: every pair of the 128
    mantissas, both signs, at exponents far from the ends of the range."""
    man = np.arange(128, dtype=np.uint16)
    a_bits, b_bits = np.meshgrid(man, man, indexing="ij")
    for ea, eb, sign in [(127, 127, 0), (100, 140, 1), (90, 96, 0), (160, 120, 1)]:
        a = _bf16_from_bits((ea << 7) | a_bits.ravel())
        b = _bf16_from_bits((sign << 15) | (eb << 7) | b_bits.ravel())
        _assert_bf16_split_exact(a, b)


if HAVE_HYPOTHESIS:
    # exponents within 2^±30, so that z_lo (~2^-16 of z) stays a normal bf16
    _BF16_NORMAL = st.tuples(st.integers(0, 1), st.integers(97, 157), st.integers(0, 127))

    @settings(max_examples=200, deadline=None, database=None)
    @given(st.lists(st.tuples(_BF16_NORMAL, _BF16_NORMAL), min_size=1, max_size=64))
    def test_bf16_split_exact_sampled(pairs):
        """The same on sampled bf16 pairs (sign, exponent, mantissa)."""
        def bits(sem):
            s, e, mnt = sem
            return (s << 15) | (e << 7) | mnt

        a = _bf16_from_bits([bits(p) for p, _ in pairs])
        b = _bf16_from_bits([bits(q) for _, q in pairs])
        _assert_bf16_split_exact(a, b)


def test_tf32_rna_rounds_to_nearest_ties_away():
    """``tf32_rna`` keeps 10 mantissa bits, rounds to nearest with ties away
    from zero (``cvt.rna``), and hi + tf32(x − hi) is within 2^-21 of x."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal(4096).astype(np.float32) * np.float32(1e-3)
    bits = x.view(np.uint32)
    mag = bits & np.uint32(0x7FFFFFFF)
    want_mag = (mag + np.uint32(0x1000)) & np.uint32(0x7FFFE000)
    want = ((bits & np.uint32(0x80000000)) | want_mag).view(np.float32)
    hi = tf32_rna(torch.from_numpy(x))
    assert np.array_equal(hi.numpy(), want)
    assert not (hi.numpy().view(np.uint32) & np.uint32(0x1FFF)).any()
    ties = np.array([0x3F801000, 0xBF801000, 0x3F803000], np.uint32).view(np.float32)
    assert np.array_equal(tf32_rna(torch.from_numpy(ties)).numpy().view(np.uint32),
                          np.array([0x3F802000, 0xBF802000, 0x3F804000], np.uint32))
    lo = tf32_rna(torch.from_numpy(x) - hi)
    err = np.abs((hi + lo).double().numpy() - x.astype(np.float64))
    assert (err <= 2.0**-21 * np.abs(x)).all()


@pytest.mark.parametrize("B,Hk,dtype,splits,k_stages", [
    (512, 39, torch.float32, 3, 49),          # serve_p99, layer 1: 80 row tiles
    (512, 200, torch.float32, 3, 250),        # serve_p99, layer 2
    (512, 200, torch.bfloat16, 3, 125),
    (1000, 200, torch.float32, 4, 250),       # 157 row tiles: 5 waves of a quarter
    (262_144, 200, torch.float32, 1, 250),    # serve_bulk: no split
    (7, 1, torch.float32, 2, 2),              # 2 row tiles: capped at the 2 stages
])
def test_plan_splits_to_fill_the_card(B, Hk, dtype, splits, k_stages):
    p = plan(B, Hk, 39, 10, 200, dtype, slots=132)
    assert p["row_tiles"] == -(-B * 10 // 64) and p["col_tiles"] == 1
    assert p["k_stages"] == k_stages and p["splits"] == splits
    assert p["blocks"] == p["row_tiles"] * splits
    assert plan(B, 1, 2, 1, 8, dtype, slots=132)["splits"] == 1  # one stage


def test_plan_splits_until_xk_fits_and_refuses_wide_x0():
    """A block keeps x0 and its split's xk in shared memory beside the w
    ring: Hk = 400 at serve_bulk's batch needs 2 splits in float32 (1 in
    bf16, whose ring is half as large); x0 past 272 fields in float32 (584
    in bf16) does not fit at all."""
    f32, bf16 = torch.float32, torch.bfloat16
    assert plan(262_144, 400, 39, 10, 200, f32, slots=132)["splits"] == 2
    assert plan(262_144, 400, 39, 10, 200, bf16, slots=132)["splits"] == 1
    for dt, m_max in ((f32, 272), (bf16, 584)):
        p = plan(2, 1, m_max, 3, 5, dt, slots=132)
        assert p["smem_bytes"] <= SMEM_LIMIT
        with pytest.raises(ValueError, match="shared memory"):
            plan(2, 1, m_max + 1, 3, 5, dt, slots=132)
    p = plan(512, 200, 39, 10, 200, f32, slots=132)
    assert p["h_span"] == 68 and p["smem_bytes"] == smem_bytes(39, 68, f32) <= SMEM_LIMIT


def test_pad_fields():
    assert [pad_fields(m) for m in (1, 8, 13, 39, 40, 41)] == [8, 8, 16, 40, 40, 48]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_partials_add_up_and_a_dropped_split_is_seen(dtype):
    """The splits' partials add up to the unsplit sum (within float32
    rounding), and the sum without one split fails K7's float32 limit
    (1e-5 of max), as ``chip_smoke.py``'s planted fault must."""
    xk, x0, w = (torch.from_numpy(a).to(dtype) for a in _inputs(8, 39, 39, 10, 200, seed=4))
    one = cin_split_partials(xk, x0, w, splits=1)[0]
    parts = cin_split_partials(xk, x0, w, splits=3)
    total = parts[0] + parts[1] + parts[2]
    top = float(one.abs().max())
    assert float((total - one).abs().max()) <= 1e-6 * top
    dropped = parts[0] + parts[2]
    assert float((dropped - one).abs().max()) > 1e-2 * top
    with pytest.raises(ValueError, match="splits"):
        cin_split_partials(xk, x0, w, splits=50)


# --- the backward: cin_layer_bwd_ref (K7b's plain version) ---------------------

@pytest.mark.parametrize("B,Hk,m,D,Hn", [(64, 10, 6, 8, 12), (40, 39, 39, 10, 200),
                                         (9, 200, 39, 10, 200), (5, 3, 2, 1, 41)])
def test_cin_backward_matches_reference_vjp(B, Hk, m, D, Hn):
    """``cin_layer_bwd_ref`` (through the autograd function on CPU tensors)
    against ``jax.vjp`` of the reference's ``models.recsys._cin_layer``,
    float32: dxk, dx0 and dw within 1e-5 of their largest magnitude (the
    three contractions sum in other orders than XLA's)."""
    import jax

    from repro.models.recsys import _cin_layer

    xk, x0, w = _inputs(B, Hk, m, D, Hn, seed=B + Hk)
    g = np.random.default_rng(B).standard_normal((B, Hn, D)).astype(np.float32)
    _, vjp = jax.vjp(_cin_layer, jnp.asarray(xk), jnp.asarray(x0), jnp.asarray(w))
    want = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_() for a in (xk, x0, w)]
    cin_layer(*ts).backward(torch.from_numpy(g))
    assert launch_counts()["cin_bwd"] == 0
    for t, w_ in zip(ts, want):
        w_ = np.asarray(w_)
        assert np.abs(t.grad.numpy() - w_).max() <= REL_F32 * np.abs(w_).max()


def test_cin_backward_first_layer_adds_both_paths():
    """Layer 1 has xk = x0: autograd adds dxk and dx0 into one gradient,
    as XLA does for the reference's ``_cin_layer(x0, x0, w)``."""
    import jax

    from repro.models.recsys import _cin_layer

    _, x0, w = _inputs(16, 6, 6, 4, 8, seed=3)
    g = np.random.default_rng(0).standard_normal((16, 8, 4)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, c: _cin_layer(a, a, c), jnp.asarray(x0), jnp.asarray(w))
    want = vjp(jnp.asarray(g))
    tx, tw = torch.from_numpy(x0).requires_grad_(), torch.from_numpy(w).requires_grad_()
    cin_layer(tx, tx, tw).backward(torch.from_numpy(g))
    for t, w_ in zip((tx, tw), want):
        w_ = np.asarray(w_)
        assert np.abs(t.grad.numpy() - w_).max() <= REL_F32 * np.abs(w_).max()


def test_cin_backward_bf16_rounds_once():
    """In bf16 each gradient is the float32 gradient of the same inputs
    rounded once (within one bf16 ulp)."""
    from repro_torch.kernels.cin.ref import cin_layer_bwd_ref

    xk, x0, w = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(20, 7, 5, 6, 9, 4))
    g = torch.from_numpy(np.random.default_rng(7).standard_normal((20, 9, 6), np.float32)
                         ).to(torch.bfloat16)
    got = cin_layer_bwd_ref(xk, x0, w, g)
    want = cin_layer_bwd_ref(xk.float(), x0.float(), w.float(), g.float())
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, b.to(torch.bfloat16))


# --- K7b's arithmetic: cin_bwd_split_partials and the split rule ---------------

def _exact_bwd(xk, x0, w, g):
    """The three gradients in float64 from the same inputs."""
    xk, x0, w, g = (t.double() for t in (xk, x0, w, g))
    B, Hk, D = xk.shape
    m = x0.shape[1]
    t = torch.einsum("hjn,bnd->bhjd", w.view(Hk, m, -1), g)
    dw = torch.einsum("bhd,bjd,bnd->hjn", xk, x0, g).reshape(w.shape)
    return torch.einsum("bhjd,bjd->bhd", t, x0), torch.einsum("bhjd,bhd->bjd", t, xk), dw


def _rel64(got, want) -> float:
    return float((got.double() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("B,Hk,m,D,Hn,splits", [(6, 200, 39, 10, 200, 1),
                                                (6, 200, 39, 10, 200, 3),
                                                (13, 7, 5, 3, 41, 4)])
def test_bwd_emulation_within_1e5_of_float64(B, Hk, m, D, Hn, splits):
    """K7b's 3×TF32 stages (``cin_bwd_split_partials``: TF32 hi/lo of every
    operand, each stage summed apart and promoted to float32, the splits
    added in order) and the plain version ``cin_layer_bwd_ref``, each
    gradient within 1e-5 of its largest magnitude of the float64 gradient
    (at Hk = 200, m = 39, H' = 200: the widths of xDeepFM's layer 2).  The
    partial of a dropped split, and TF32's hi parts alone, are seen."""
    from repro_torch.kernels.cin.ref import (_staged_3xtf32, cin_bwd_split_partials,
                                             cin_layer_bwd_ref)

    xk, x0, w = (torch.from_numpy(a) for a in _inputs(B, Hk, m, D, Hn, seed=B + Hk))
    g = torch.from_numpy(np.random.default_rng(B).standard_normal((B, Hn, D), np.float32))
    exact = _exact_bwd(xk, x0, w, g)
    dxk, dx0, parts = cin_bwd_split_partials(xk, x0, w, g, splits)
    assert len(parts) == splits
    dw = parts[0]
    for p in parts[1:]:
        dw = dw + p
    for got, want in zip((dxk, dx0, dw), exact):
        assert got.dtype == torch.float32 and _rel64(got, want) <= REL_F32
    for got, want in zip(cin_layer_bwd_ref(xk, x0, w, g), exact):
        assert _rel64(got, want) <= REL_F32
    if splits > 1:
        assert _rel64(dw - parts[-1], exact[2]) > REL_F32
    # one TF32 product (hi·hi) instead of three: ~2^-11, far past the limit
    gr = g.permute(0, 2, 1).reshape(B * D, Hn)
    one = (tf32_rna(gr).double() @ tf32_rna(w.t()).double()).float()
    assert _rel64(one, gr.double() @ w.double().t()) > REL_F32
    assert _rel64(_staged_3xtf32(gr, w.t(), 32), gr.double() @ w.double().t()) <= REL_F32


def test_bwd_splits_are_a_function_of_the_shape(monkeypatch):
    """``bwd_splits`` reads nothing but the shape (no card, no state): equal
    shapes give equal splits, in [1, 32], at least 1,024 rows a split;
    ``train_batch``'s layers split 32 (layer 1) and 9 (layer 2) ways."""
    from repro_torch.kernels.cin.kernel import MAX_BWD_SPLITS, bwd_scratch_bytes, bwd_splits
    from repro_torch.kernels.cin.ref import bwd_split_row

    def no_card(*a, **k):
        raise AssertionError("bwd_splits asked the card")

    for name in ("is_available", "get_device_properties", "current_device", "device_count"):
        monkeypatch.setattr(torch.cuda, name, no_card)
    assert bwd_splits(65_536, 39, 39, 10, 200) == 32
    assert bwd_splits(65_536, 200, 39, 10, 200) == 9
    for shape in [(65_536, 200, 39, 10, 200), (5, 3, 2, 1, 41), (2048, 200, 39, 10, 200),
                  (100, 20, 40, 10, 200), (1, 1, 1, 1, 1)]:
        s = bwd_splits(*shape)
        assert s == bwd_splits(*shape) and 1 <= s <= MAX_BWD_SPLITS
        assert s == 1 or shape[0] * shape[3] // s >= 1024
        assert bwd_scratch_bytes(*shape, s) % 256 == 0
        R = shape[0] * shape[3]
        cuts = [bwd_split_row(R, i, s) for i in range(s + 1)]
        assert cuts[0] == 0 and cuts[-1] == R and cuts == sorted(cuts)
        assert all(c % 32 == 0 for c in cuts[:-1])  # a stage's TMA box starts aligned
    # w's copies (100 tiles of 80 columns x 224 n), g^T's (200 x 655,360),
    # two copies each; xk^T (200 x 655,360), x0^T (39 x 655,360); 9 partials
    # of 7,800 x 200; in bytes
    assert bwd_scratch_bytes(65_536, 200, 39, 10, 200, 9) == \
        2 * 100 * 80 * 224 * 4 + (2 * 200 + 200 + 39) * 655_360 * 4 + 9 * 7800 * 200 * 4
