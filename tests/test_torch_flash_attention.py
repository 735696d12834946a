"""Port parity for K6's plain versions (``repro_torch.kernels.flash_attention``).

The port's model-layout entry point ``ops.flash_attention`` on CPU tensors
(the wrapper runs ``flash_attention_ref``, the blocked online softmax) is
held against the reference's ``flash_attention_tpu`` in interpret mode and
against its ``attention_ref``, on the sweep of ``tests/test_kernels.py``
(GQA, MHA, ragged S, window None/64, float32/bfloat16, block 64) plus a
case with padded keys (``kv_pos < 0``) and rolled cache positions.
Tolerances as there: atol 2e-5 in float32 (sums in another order), 2e-2 in
bfloat16 (the port follows ``models/attention.py``'s rounding — q scaled
in float32, then rounded — where the Pallas kernel scales in bfloat16).
Inputs come from numpy seeds.  ``kv_tile_classes``, the rule by which K6
skips, masks or takes whole each kv tile, is held against the brute-force
mask on every pair.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as j_attention_ref
from repro.kernels.flash_attention import flash_attention_tpu
from repro_torch.kernels.flash_attention import (attention_ref, flash_attention,
                                                 flash_attention_fwd, flash_attention_ref,
                                                 launch_counts)
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.flash_attention.kernel import KEY_TILE, ROW_TILE

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(B, S, T, H, KV, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, hd), np.float32)
    k = rng.standard_normal((B, T, KV, hd), np.float32)
    v = rng.standard_normal((B, T, KV, hd), np.float32)
    tdt, jdt = DTYPES[dtype]
    return ([torch.from_numpy(x).to(tdt) for x in (q, k, v)],
            [jnp.asarray(x).astype(jdt) for x in (q, k, v)])


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else
                      np.asarray(x, np.float32))


def _grouped(q, k, v, KV):
    """Model layout → the kernel layout (torch)."""
    B, S, H, hd = q.shape
    T, G = k.shape[1], H // KV
    qk = q.reshape(B, S, KV, G, hd).permute(0, 2, 1, 3, 4).reshape(B * KV, S, G * hd)
    kk = k.permute(0, 2, 1, 3).reshape(B * KV, T, hd)
    vk = v.permute(0, 2, 1, 3).reshape(B * KV, T, hd)
    return qk.contiguous(), kk.contiguous(), vk.contiguous()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [
    (1, 128, 4, 2, 64, 64),    # small GQA
    (2, 256, 8, 8, 64, 64),    # MHA (G=1)
    (1, 200, 6, 2, 32, 64),    # ragged (padding path)
    (1, 256, 8, 2, 128, 128),  # llama's hd 128, G = 4, over K6's bf16 key tile
])
@pytest.mark.parametrize("window", [None, 64])
def test_flash_plain_matches_reference_kernel_and_oracle(shape, dtype, window):
    B, S, H, KV, hd, block_k = shape
    (q, k, v), (jq, jk, jv) = _inputs(B, S, S, H, KV, hd, dtype, seed=S + H + (window or 0))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    tp = torch.from_numpy(pos.copy())
    before = launch_counts()["flash_attention"]
    got = flash_attention(q, k, v, tp, tp, causal=True, window=window, block_k=block_k)
    assert launch_counts()["flash_attention"] == before  # the CPU never launches K6
    assert got.dtype == q.dtype and got.shape == q.shape
    want = flash_attention_tpu(jq, jk, jv, jnp.asarray(pos), jnp.asarray(pos), causal=True,
                               window=window, block_q=64, block_k=block_k)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype], rtol=0)
    # the reference's direct oracle, in the grouped layout
    G = H // KV
    jqk = jq.reshape(B, S, KV, G, hd).transpose(0, 2, 1, 3, 4).reshape(B * KV, S, G * hd)
    jkk = jk.transpose(0, 2, 1, 3).reshape(B * KV, S, hd)
    jvk = jv.transpose(0, 2, 1, 3).reshape(B * KV, S, hd)
    pp = jnp.repeat(jnp.asarray(pos), KV, axis=0)
    oracle = j_attention_ref(jqk, jkk, jvk, pp, pp, causal=True, window=window)
    qk, kk, vk = _grouped(q, k, v, KV)
    tpp = torch.repeat_interleave(tp, KV, dim=0).contiguous()
    mine = flash_attention_fwd(qk, kk, vk, tpp, tpp, causal=True, window=window)
    np.testing.assert_allclose(_np(mine), _np(oracle), atol=TOL[dtype], rtol=0)
    # the port's direct oracle against the reference's
    np.testing.assert_allclose(_np(attention_ref(qk, kk, vk, tpp, tpp, causal=True,
                                                 window=window)),
                               _np(oracle), atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 24), (False, 40)])
def test_flash_plain_padded_and_rolled_keys(dtype, causal, window):
    """kv_pos < 0 marks padding; cache slots hold positions out of order.
    Every query keeps at least one visible key (a row that sees none is
    undefined in the contract)."""
    B, S, T, H, KV, hd = 2, 40, 96, 4, 2, 32
    (q, k, v), (jq, jk, jv) = _inputs(B, S, T, H, KV, hd, dtype, seed=7)
    kv_pos = np.roll(np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)), 29, axis=1).copy()
    kv_pos[:, ::7] = -1  # padded slots
    q_pos = np.broadcast_to(np.arange(T - S, T, dtype=np.int32), (B, S)).copy()
    got = flash_attention(q, k, v, torch.from_numpy(q_pos), torch.from_numpy(kv_pos),
                          causal=causal, window=window)
    want = flash_attention_tpu(jq, jk, jv, jnp.asarray(q_pos), jnp.asarray(kv_pos),
                               causal=causal, window=window, block_q=64, block_k=64)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("block_q,block_k", [(16, 16), (64, 32), (1000, 1000)])
def test_flash_ref_blocking_does_not_change_the_function(block_q, block_k):
    B, S, T, H, KV, hd = 1, 70, 70, 6, 3, 16
    (q, k, v), _ = _inputs(B, S, T, H, KV, hd, "float32", seed=3)
    qk, kk, vk = _grouped(q, k, v, KV)
    pos = torch.arange(S, dtype=torch.int32).expand(KV, S).contiguous()
    got = flash_attention_ref(qk, kk, vk, pos, pos, causal=True, window=20,
                              block_q=block_q, block_k=block_k)
    want = attention_ref(qk, kk, vk, pos, pos, causal=True, window=20)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


def test_flash_wrapper_checks_its_inputs():
    q = torch.zeros(2, 8, 64)
    k = torch.zeros(2, 8, 32)
    pos = torch.zeros(2, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        flash_attention_fwd(q, k, k, pos.long(), pos)
    with pytest.raises(ValueError, match="positions"):
        flash_attention_fwd(q, k, k, pos[:, :4], pos)
    with pytest.raises(ValueError, match="group"):
        flash_attention_fwd(torch.zeros(2, 8, 40), k, k, pos, pos)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention_fwd(q.double(), k.double(), k.double(), pos, pos)
    meta = [t.to("meta") for t in (q, k, k, pos, pos)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention_fwd(*meta)


def _class_violations(cls, q_pos, kv_pos, G, rows, keys, causal, window) -> list[str]:
    """Every (q tile, kv tile) against the brute-force mask of its pairs: a
    SKIP tile with a visible pair, or a FULL tile with a masked one."""
    BK, S = q_pos.shape
    T = kv_pos.shape[1]
    seen = fa_ref._visible(torch.repeat_interleave(q_pos, G, dim=1), kv_pos, causal, window)
    bad = []
    for b in range(BK):
        for i in range(cls.shape[1]):
            for j in range(cls.shape[2]):
                pairs = seen[b, i * rows:min((i + 1) * rows, S * G), j * keys:(j + 1) * keys]
                whole = pairs.all() and (j + 1) * keys <= T  # keys past T are padding
                if cls[b, i, j] == fa_ref.SKIP and pairs.any():
                    bad.append(f"({b}, {i}, {j}) SKIP with a visible pair")
                if cls[b, i, j] == fa_ref.FULL and not whole:
                    bad.append(f"({b}, {i}, {j}) FULL with a masked pair")
    return bad


def _tile_case(case):
    """(q_pos, kv_pos, G, causal, window) for one named case, two kv heads' rows."""
    rng = np.random.default_rng(11)
    S, T, G, causal, window = {
        "causal prefill": (512, 512, 4, True, None),
        "window": (600, 600, 4, True, 200),
        "rolled cache": (40, 640, 4, True, None),
        "padded keys": (300, 384, 4, True, None),
        "G=5": (300, 300, 5, True, None),
        "ragged S and T": (77, 333, 3, True, 150),
        "not causal, window": (200, 300, 2, False, 90),
    }[case]
    q_pos = np.broadcast_to(np.arange(T - S, T, dtype=np.int32), (2, S)).copy()
    kv_pos = np.broadcast_to(np.arange(T, dtype=np.int32), (2, T)).copy()
    if case == "rolled cache":  # cache slots hold positions out of order
        kv_pos = np.stack([np.roll(kv_pos[0], 100), rng.permutation(T).astype(np.int32)])
    if case == "padded keys":  # the last keys of one row, scattered keys of the other
        kv_pos[0, -50:] = -(2**30)
        kv_pos[1, rng.choice(T, 30, replace=False)] = -1
    return torch.from_numpy(q_pos), torch.from_numpy(kv_pos), G, causal, window


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", ["causal prefill", "window", "rolled cache", "padded keys",
                                  "G=5", "ragged S and T", "not causal, window"])
def test_kv_tile_classes_hold_against_the_mask(case, dtype):
    """No pair of a SKIP tile is visible and every pair of a FULL tile is,
    by the brute-force mask; a causal prefill has at most two PARTIAL kv
    tiles a q tile; every class occurs where the case allows it."""
    q_pos, kv_pos, G, causal, window = _tile_case(case)
    rows, keys = ROW_TILE[dtype], KEY_TILE[dtype]
    cls = fa_ref.kv_tile_classes(q_pos, kv_pos, G, rows, keys, causal, window)
    S, T = q_pos.shape[1], kv_pos.shape[1]
    assert cls.shape == (2, -(-S * G // rows), -(-T // keys))
    assert _class_violations(cls, q_pos, kv_pos, G, rows, keys, causal, window) == []
    if case == "causal prefill":
        assert int((cls == fa_ref.PARTIAL).sum(-1).max()) <= 2
        assert {fa_ref.SKIP, fa_ref.PARTIAL, fa_ref.FULL} <= set(cls.unique().tolist())
    if case == "window":
        assert bool((cls[:, -1] == fa_ref.SKIP).any()) and bool((cls == fa_ref.FULL).any())


def test_kv_tile_classes_see_a_planted_wrong_rule():
    """FULL without its all-keys-valid condition marks tiles with padded keys
    FULL: the check above must catch it."""
    q_pos, kv_pos, G, causal, window = _tile_case("padded keys")
    rows, keys = ROW_TILE[torch.bfloat16], KEY_TILE[torch.bfloat16]
    cls = fa_ref.kv_tile_classes(q_pos, kv_pos, G, rows, keys, causal, window)
    # the planted rule: every key of the tile valid or not, largest valid key <= qmin
    kp = torch.nn.functional.pad(kv_pos.long(), (0, -kv_pos.shape[1] % keys), value=-1)
    kp = kp.view(2, -1, keys)
    kmax = torch.where(kp >= 0, kp, -(2**40)).amax(-1)
    qp = torch.repeat_interleave(q_pos.long(), G, dim=1)
    qp = torch.nn.functional.pad(qp, (0, -qp.shape[1] % rows), value=2**40)
    qmin = qp.view(2, -1, rows).amin(-1)
    wrong = cls.clone()
    wrong[(kmax[:, None] <= qmin[:, :, None]) & (cls != fa_ref.SKIP)] = fa_ref.FULL
    assert not torch.equal(wrong, cls)
    assert _class_violations(wrong, q_pos, kv_pos, G, rows, keys, causal, window)
