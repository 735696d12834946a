"""Port parity for the LM's attention (``repro_torch.models.attention``).

``flash_attention`` on the CPU (K6's plain version, blocked by
``_flash_fwd``'s ``q_chunk``/``kv_chunk``) and ``decode_attention`` against the
reference's, on the same inputs from numpy seeds: atol 2e-5 in float32
(the shapes of ``tests/test_attention.py``; sums in another order) and
2e-2 in bfloat16 (one bf16 rounding of the output apart).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jatt
from repro_torch.models import attention as att

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _qkv(B, S, T, H, KV, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s, np.float32) for s in
            ((B, S, H, hd), (B, T, KV, hd), (B, T, KV, hd))]
    return ([torch.from_numpy(a).to(dtype) for a in arrs],
            [jnp.asarray(a).astype(JDT[dtype]) for a in arrs])


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("shape,chunks", [((1, 64, 4, 2, 16), (32, 32)),
                                          ((2, 96, 6, 3, 8), (32, 32)),
                                          ((2, 50, 4, 1, 32), (16, 64))])
def test_flash_attention_matches_reference(shape, chunks, window, dtype):
    B, S, H, KV, hd = shape
    (q, k, v), (jq, jk, jv) = _qkv(B, S, S, H, KV, hd, dtype, seed=S + H)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    got = att.flash_attention(q, k, v, torch.from_numpy(pos), torch.from_numpy(pos),
                              True, window, *chunks)
    want = jatt.flash_attention(jq, jk, jv, jnp.asarray(pos), jnp.asarray(pos), True,
                                window, *chunks)
    assert got.dtype == dtype and got.shape == q.shape
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 8])
def test_decode_attention_matches_reference_on_a_rolling_cache(dtype, window):
    """Out-of-order cache positions, empty slots at −1."""
    B, T, H, KV, hd = 3, 24, 4, 2, 16
    (q, k, v), (jq, jk, jv) = _qkv(B, 1, T, H, KV, hd, dtype, seed=11)
    kv_pos = np.roll(np.arange(T, dtype=np.int32), 5)[None].repeat(B, 0)
    kv_pos[1, :4] = -1
    q_pos = np.array([[T - 1], [T + 3], [T + 10]], np.int32)
    got = att.decode_attention(q, k, v, torch.from_numpy(q_pos), torch.from_numpy(kv_pos),
                               causal=True, window=window)
    want = jatt.decode_attention(jq, jk, jv, jnp.asarray(q_pos), jnp.asarray(kv_pos),
                                 causal=True, window=window)
    _close(got, want, dtype)


def test_decode_equals_the_last_row_of_flash():
    B, S, H, KV, hd = 2, 32, 4, 2, 16
    (q, k, v), _ = _qkv(B, S, S, H, KV, hd, torch.float32, seed=2)
    pos = torch.arange(S, dtype=torch.int32).expand(B, S)
    full = att.flash_attention(q, k, v, pos, pos, True, None, 16, 16)
    dec = att.decode_attention(q[:, -1:], k, v, pos[:, -1:], pos)
    torch.testing.assert_close(dec[:, 0], full[:, -1], atol=2e-5, rtol=0)


def test_mask_matches_reference():
    rng = np.random.default_rng(0)
    qp = rng.integers(-3, 40, (2, 7)).astype(np.int32)
    kp = rng.integers(-3, 40, (2, 9)).astype(np.int32)
    for causal, window in ((True, None), (True, 5), (False, 5), (False, None)):
        got = att._mask(torch.from_numpy(qp), torch.from_numpy(kp), causal, window)
        want = jatt._mask(jnp.asarray(qp), jnp.asarray(kp), causal, window)
        assert np.array_equal(got.numpy(), np.asarray(want))
